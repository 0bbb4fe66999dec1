"""K3, K4, K5 of the port (GLV ladder, comb, affine) through their plain
versions on the CPU, held exactly against the host EC oracle (infinity and
k = 0 included), against the reference's XLA path at a batch under 128, and
once per kernel against the reference's Pallas kernel in interpret mode
(K3 and the XLA path through the reference's outputs committed in
fixtures/kernels_ec.json, K4 and K5 live)."""

import json
import os

import numpy as np
import pytest
import torch

from tpu_mpc_torch.ec import pallas_ec as tpe
from tpu_mpc_torch.ec import secp256k1 as tec
from tpu_mpc_torch.host import ec as hec

Q = hec.N
B = 8
DEV = "cpu"


def _scalars(seed, n=B, edge=()):
    rng = np.random.default_rng(seed)
    ks = [int.from_bytes(rng.bytes(32), "little") % Q for _ in range(n - len(edge))]
    return list(edge) + ks


def _points(seed, n=B, edge=()):
    rng = np.random.default_rng(seed)
    return list(edge) + [hec.mul(int.from_bytes(rng.bytes(32), "little") % Q or 1)
                         for _ in range(n - len(edge))]


def _sc(ks):
    return tec.sc_from_ints(np.asarray(ks, dtype=object), DEV)


def test_scalar_mul_matches_host_oracle():
    ks = _scalars(1, edge=(0, 1, Q - 1))
    pts = _points(2, edge=(None,))
    got = tec.points_to_host_list(tec.scalar_mul(_sc(ks), tec.points_from_host(pts, DEV)))
    assert got == [hec.mul(k, p) if p is not None else None for k, p in zip(ks, pts)]


def test_dual_mul_matches_host_oracle():
    ka, kb = _scalars(3, edge=(0,)), _scalars(4, edge=(Q - 1, 0))
    pa, pb = _points(5, edge=(None,)), [hec.BASE_POINT2] * B
    got = tec.points_to_host_list(tec.dual_mul(
        _sc(ka), tec.points_from_host(pa, DEV), _sc(kb), tec.points_from_host(pb, DEV)))
    want = [hec.add(hec.mul(a, p) if p is not None else None, hec.mul(b, q))
            for a, p, b, q in zip(ka, pa, kb, pb)]
    assert got == want


def test_comb_matches_host_oracle():
    ks = _scalars(6, edge=(0, 1, Q - 1, 255, 256))
    assert tec.points_to_host_list(tec.mul_generator(_sc(ks))) == [hec.mul(k) for k in ks]
    assert tec.points_to_host_list(tec.mul_base_point2(_sc(ks))) == \
        [hec.mul(k, hec.BASE_POINT2) for k in ks]


def test_affine_point_algebra_matches_host_oracle():
    pa, pb = _points(7, edge=(None,)), _points(8, edge=(hec.G, None))
    pa[1] = hec.G                                       # P + P
    pb[2] = hec.neg(pa[2])                              # P + (-P)
    A, Bp = tec.points_from_host(pa, DEV), tec.points_from_host(pb, DEV)
    S = tec.point_add(A, Bp)
    assert tec.points_to_host_list(S) == [hec.add(a, b) for a, b in zip(pa, pb)]
    assert tec.points_to_host_list(tec.point_double(A)) == [hec.add(a, a) for a in pa]
    x, y, inf = tec.to_affine(S)
    want = [hec.add(a, b) for a, b in zip(pa, pb)]
    assert inf.tolist() == [w is None for w in want]
    assert tec.point_eq(S, tec.points_from_host(want, DEV)).all()
    assert not tec.point_eq(A, Bp)[3]
    tot = tec.points_to_host(tec.point_sum(A, axis=0))
    acc = None
    for a in pa:
        acc = hec.add(acc, a)
    assert tot == acc
    r = tec.x_coord_mod_q(tec.Point(A.X[1:2], A.Y[1:2], A.Z[1:2]))
    assert int.from_bytes(r[0].numpy().astype("<u2").tobytes(), "little") == hec.GX % Q


def test_glv_split_recombines():
    ks = _scalars(9, edge=(0, 1, Q - 1))
    k1, n1, k2, n2 = tec._glv_split(_sc(ks))
    to_int = lambda t: [int.from_bytes(r.numpy().astype("<u2").tobytes(), "little") for r in t]
    for k, a, na, b, nb in zip(ks, to_int(k1), n1.tolist(), to_int(k2), n2.tolist()):
        assert a < 1 << 129 and b < 1 << 129
        assert ((-a if na else a) + tec.GLV_LAMBDA * (-b if nb else b) - k) % Q == 0


# ---- against the reference -------------------------------------------------

KERNELS_EC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "fixtures",
                          "kernels_ec.json")


@pytest.fixture(scope="module")
def ref_ec():
    """The reference's outputs on the inputs below (make_torch_goldens.py
    kernels_ec: its XLA path, and its K3 Pallas kernel in interpret mode)."""
    with open(KERNELS_EC) as f:
        return json.load(f)


def _ref_pts(pts):
    from tpu_mpc.ec import secp256k1 as jec

    return jec.points_from_host(pts)


def _ref_sc(ks):
    from tpu_mpc.ec import secp256k1 as jec

    return jec.sc_from_ints(np.asarray(ks, dtype=object))


def _pts_json(pts):
    return [None if p is None else [str(p[0]), str(p[1])] for p in pts]


def _check_inputs(gold, **inputs):
    """The golden was written from these seeded inputs (no drift)."""
    for name, vals in inputs.items():
        want = _pts_json(vals) if name == "pts" else [str(v) for v in vals]
        assert gold[name] == want, f"{name} drifted from the golden's inputs"


@pytest.mark.parametrize("fn", ["scalar_mul", "mul_generator", "dual_mul", "glv_split"])
def test_against_reference_xla_path(ref_ec, fn):
    """Batch 8 < 128: the reference's XLA ladders (their outputs in
    kernels_ec.json); compared in affine (the GLV split: its digits,
    exactly)."""
    gold = ref_ec["xla"]
    ks, kb = _scalars(10, edge=(0,)), _scalars(11)
    pts = _points(12, edge=(None,))
    _check_inputs(gold, ks=ks, kb=kb, pts=pts)
    mine = lambda P: _pts_json(tec.points_to_host_list(P))
    P = tec.points_from_host(pts, DEV)
    G = [hec.G] * B
    if fn == "scalar_mul":
        assert mine(tec.scalar_mul(_sc(ks), P)) == gold["scalar_mul"]
    elif fn == "mul_generator":
        assert mine(tec.mul_generator(_sc(ks))) == gold["mul_generator"]
    elif fn == "dual_mul":
        assert mine(tec.dual_mul(_sc(ks), P, _sc(kb), tec.points_from_host(G, DEV))) == \
            gold["dual_mul"]
    else:
        a = [t.numpy() for t in tec._glv_split(_sc(ks))]
        assert len(a) == len(gold["glv_split"])
        for u, v in zip(a, gold["glv_split"]):
            assert np.array_equal(u.astype(np.int64), np.asarray(v, dtype=np.int64))


def _jac_rows(P):
    return np.stack([np.asarray(c, dtype=np.int64) for c in P], axis=-2)


def test_k3_plain_equals_reference_pallas_interpret(ref_ec):
    """Same formulas in the same order: the canonical Jacobian output of the
    plain GLV ladder equals the reference kernel's (run in interpret mode
    into kernels_ec.json) bit for bit."""
    gold = ref_ec["k3_interpret"]
    ks = _scalars(13, edge=(0, 1, Q - 1))
    pts = _points(14, edge=(None,))
    _check_inputs(gold, ks=ks, pts=pts)
    want = np.asarray(gold["jac"], dtype=np.int64)
    got = torch.stack(list(tpe.glv_mul(_sc(ks), tec.points_from_host(pts, DEV))), -2)
    got = tec._from_rows(got, (B,))
    want_n = tec._from_rows(torch.as_tensor(want), (B,))
    assert all(torch.equal(g, w) for g, w in zip(got, want_n))


def test_k4_plain_equals_reference_pallas_interpret():
    from tpu_mpc.ec import pallas_ec as jpe

    ks = _scalars(15, edge=(0, 1, Q - 1))
    want = _jac_rows(jpe.comb_mul(_ref_sc(ks), hec.G))
    got = torch.stack(list(tpe.comb_mul(_sc(ks), hec.G)), -2)
    assert torch.equal(tec._from_rows(got, (B,)).X, tec._from_rows(torch.as_tensor(want), (B,)).X)
    assert torch.equal(tec._from_rows(got, (B,)).Y, tec._from_rows(torch.as_tensor(want), (B,)).Y)
    assert torch.equal(got[:, 2], torch.as_tensor(want)[:, 2])


def test_k5_plain_equals_reference_pallas_interpret():
    from tpu_mpc.ec import pallas_ec as jpe

    pts = _points(16, edge=(None,))
    P = tec.scalar_mul(_sc(_scalars(17)), tec.points_from_host(pts, DEV))   # Z != 1
    jP = type(_ref_pts(pts))(*(np.asarray(c.numpy(), np.uint32) for c in P))
    jx, jy, jinf = jpe.affine(jP)
    x, y, inf = tpe.affine(P)
    assert np.array_equal(x.numpy(), np.asarray(jx, np.int64))
    assert np.array_equal(y.numpy(), np.asarray(jy, np.int64))
    assert inf.tolist() == np.asarray(jinf).tolist()
