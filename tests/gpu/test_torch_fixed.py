"""K2 (the fixed-base window product), its tables and the randomizer tables
of the port, on the CPU through K2's plain version, held exactly (tolerance
0: integers) against python pow() and the reference package: its table
build, its XLA fixed-product path (TPU_MPC_PALLAS=0), its Pallas dispatch in
interpret mode for the gmap case (those three through their outputs on the
tests' seeded inputs, committed in fixtures/kernels_fixed.json), and its
randomizer sampling.  Small widths (256 and 768 bits) and small exponent
classes keep the file cheap."""

import hashlib
import json
import os

import numpy as np
import pytest
import torch

from tpu_mpc_torch.core import rns as trns
from tpu_mpc_torch.core.modctx import DeferredLaunch, ModCtx
from tpu_mpc_torch.core.pallas_rns import LANE_TILE
from tpu_mpc_torch.utils.ct import scrub_array
from tpu_mpc_torch.utils.rng import SessionRng
from tpu_mpc_torch.zk import range_proofs as rp

FIXTURE = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", "fixtures",
                       "gg20key_20_2_1_3_768.json")


def _rand(rng, bits):
    return int.from_bytes(rng.bytes((bits + 7) // 8), "little") % (1 << bits)


def _moduli(rng, bits, n):
    return np.asarray([_rand(rng, bits) | 1 | (1 << (bits - 1)) for _ in range(n)],
                      dtype=object)


def _pows(b, e, n):
    b, e, n = np.broadcast_arrays(*(np.asarray(a, dtype=object) for a in (b, e, n)))
    return np.vectorize(lambda x, y, m: pow(int(x), int(y), int(m)), otypes=[object])(b, e, n)


KERNELS_FIXED = os.path.join(os.path.dirname(os.path.abspath(__file__)), "fixtures",
                             "kernels_fixed.json")


@pytest.fixture(scope="module")
def ref_fixed():
    """The reference's outputs on the inputs below (make_torch_goldens.py
    kernels_fixed: its table build, its XLA fixed-product path and its
    Pallas dispatch in interpret mode)."""
    with open(KERNELS_FIXED) as f:
        return json.load(f)


def _strs(a):
    """Nested decimal strings, as make_torch_goldens.py writes arrays."""
    return np.vectorize(lambda v: str(int(v)), otypes=[object])(
        np.asarray(a, dtype=object)).tolist()


def _ints(nested):
    return np.vectorize(int, otypes=[object])(np.asarray(nested, dtype=object))


def _digest(a) -> str:
    """sha256 of an integer array's int64 little-endian bytes (the golden
    holds the reference's tables so: the 768-bit ones are 77k values)."""
    return hashlib.sha256(np.ascontiguousarray(np.asarray(a).astype("<i8")).tobytes()).hexdigest()


@pytest.mark.parametrize("bits", [256, 768])
def test_fixed_base_equals_reference(ref_fixed, monkeypatch, bits):
    """One reference table build per width (its residues and the outputs
    below committed in fixtures/kernels_fixed.json from the reference on
    these seeded inputs), then every comparison that needs it:
      * tables: 2 bases over a [1, 3] batch; both builds are plain-residue
        RNS Montgomery chains in the same order, so the residues agree;
      * ModCtx.pow_fixed_prod_rns with those 2 bases at exponent classes 16
        and 64, S = 2 sessions and G = 3 or G = 1 key groups on the
        party-slot dim, against the reference's XLA path and python pow;
      * at 256 bits, an explicit gmap routing S = 4 sessions to the G = 3
        groups with 8-bit exponents (the size of the reference's
        tests/test_pallas.py case), against its Pallas path in interpret
        mode; a group row out of range and an over-wide exponent raise."""
    gold = ref_fixed[str(bits)]
    rng = np.random.default_rng(bits + 1)
    ns3 = _moduli(rng, bits, 3).reshape(1, 3)
    bases3 = np.asarray([[[_rand(rng, bits + 8) for _ in range(3)]] for _ in range(2)],
                        dtype=object)                               # [2, 1, 3]
    # the golden was written from these seeded inputs (no drift)
    assert (_strs(ns3), _strs(bases3)) == (gold["ns3"], gold["bases3"])
    got = trns.rns_make_tables(trns.RnsCtx.from_ints(ns3, bits, "cpu"), ns3, bases3, 64, bits)
    assert len(got) == len(gold["tables"])
    for ref, T in zip(gold["tables"], got):
        assert T.dtype == torch.int32 and list(T.shape) == [16, 16, 1, 3, ref["shape"][-1]]
        assert list(T.shape) == ref["shape"] and _digest(T.numpy()) == ref["sha256"]

    S = 2
    for G, want_g in zip((3, 1), gold["groups"]):
        ns, h = ns3[:, :G], bases3[:, :, :G] % ns3[:, :G]
        e1 = np.asarray([[_rand(rng, 16) for _ in range(G)] for _ in range(S)], dtype=object)
        e2 = np.asarray([[_rand(rng, 64) for _ in range(G)] for _ in range(S)], dtype=object)
        e1[0, 0] = 0
        assert want_g["G"] == G and (_strs(e1), _strs(e2)) == (want_g["e1"], want_g["e2"])
        want = _ints(want_g["want"])
        port = ModCtx.from_ints(ns, bits, "cpu")
        got = port.pow_fixed_prod_rns(port.make_tables_rns(h, 64), [e1, e2], (16, 64))
        assert np.asarray(got).shape == (S, G)
        assert np.array_equal(np.asarray(got, dtype=object), want)
        assert (got == _pows(h[0], e1, ns) * _pows(h[1], e2, ns) % ns).all()
    if bits != 256:
        return

    nsG, g = ns3[0], bases3[0, 0] % ns3[0]
    gmap = np.asarray([0, 2, 1, 2])
    n_s = np.asarray([int(nsG[i]) for i in gmap], dtype=object)
    e = np.asarray([5, 200, 77, 255], dtype=object)
    assert gold["gmap"]["gmap"] == gmap.tolist() and gold["gmap"]["e"] == _strs(e)
    want = _ints(gold["gmap"]["want"])
    tt = trns.rns_make_tables(trns.RnsCtx.from_ints(nsG, bits, "cpu"), nsG, g[None], 8, bits)
    call = lambda ex, gm: trns.rns_fixed_prod_dispatch(
        trns.RnsCtx.from_ints(n_s, bits, "cpu"), n_s, tt, [ex], [8], bits, gmap=gm).ints()
    got = call(e, gmap)
    assert (got == want).all()
    assert (got == _pows(g[gmap], e, n_s)).all()
    # K2's window split (chunk products multiplied in order): the inputs the
    # dispatch hands K2 (lanes sorted by group), decoded after every split
    from tpu_mpc_torch.core import pallas_rns as tpr

    seen = []
    real = tpr.fixed_call
    monkeypatch.setattr(tpr, "fixed_call", lambda *a: seen.append(a) or real(*a))
    call(e, gmap)
    ew, grow, rows, T, nwins, woffs, nb = seen[-1]
    order = np.argsort(gmap, kind="stable")
    assert grow.tolist() == gmap[order].tolist() and sum(nwins) == 2
    for split in (1, 2):
        cols = tpr.fixed_plain(ew, grow, rows, T, nwins, woffs, nb, split=split)
        vals = trns.RnsLazy((cols,), (4,), n_s[order], trns.RnsParams(bits).MA).ints()
        assert (vals == want[order]).all()
    with pytest.raises(ValueError, match="group rows"):
        call(e, gmap + 1)
    with pytest.raises(ValueError, match="exceeds"):
        call(e << 8, gmap)


def _fixture_keys(n_parties=2):
    with open(FIXTURE) as f:
        d = json.load(f)
    ints = lambda k: np.vectorize(int, otypes=[object])(np.asarray(d[k], dtype=object))
    sl = slice(0, n_parties)
    return (ints("p")[0, sl], ints("q")[0, sl], ints("nt")[0, sl], ints("h1")[0, sl],
            ints("h2")[0, sl])


def test_randomizer_tables_equal_reference(monkeypatch):
    """_derive_enc_base, ensure_enc_tables and sample_unit_with_power
    (..., want_t=True) give the reference's (u, u^N mod N^2, t) for the same
    key and SessionRng seed (768 bits, randomizer tables on both sides)."""
    monkeypatch.setenv("TPU_MPC_ENC_TABLES", "1")
    monkeypatch.setenv("TPU_MPC_TORCH_ENC_TABLES", "1")
    from tpu_mpc.utils.rng import SessionRng as JRng
    from tpu_mpc.zk import range_proofs as jrp

    p, q, *_ = _fixture_keys()
    n = p * q
    assert [rp._derive_enc_base(v) for v in n] == [jrp._derive_enc_base(v) for v in n]
    tek = rp.PaillierCtxBatch.from_ints(n, 768, "cpu").attach_sk(p, q).ensure_enc_tables()
    jek = jrp.PaillierCtxBatch.from_ints(n, 768).attach_sk(p, q).ensure_enc_tables()
    assert tek.enc_tab_g is not None and jek.enc_tab_g is not None
    assert tuple(tek.enc_tab_h.shape) == (388, 16, 2, trns.RnsParams(1536).CH)
    tu, tun, tt = tek.sample_unit_with_power((3, 2), SessionRng(5), want_t=True)
    ju, jun, jt = jek.sample_unit_with_power((3, 2), JRng(5), want_t=True)
    assert np.array_equal(tt, jt)
    assert np.array_equal(np.asarray(tu, dtype=object), np.asarray(ju, dtype=object))
    tun = rp.resolve(tun)
    assert np.array_equal(np.asarray(tun, dtype=object),
                          np.asarray(rp.resolve(jun), dtype=object))
    g = np.broadcast_to(tek.enc_g, (3, 2))
    nb = np.broadcast_to(n, (3, 2))
    assert (tu == _pows(g, tt, nb)).all() and (tun == _pows(tu, nb, nb * nb)).all()
    # the deferred value dispatches on first use; the fold g^(t e + t')
    du, _, dt = tek.sample_unit_with_power((2,), SessionRng(6), defer_value=True, want_t=True)
    assert isinstance(du, DeferredLaunch) and (du.ints() == _pows(tek.enc_g, dt, n)).all()
    fold = dt * 3 + 1
    assert (rp.resolve(tek.pow_enc_base(fold, 768 + 64 + 2 + 1)) == _pows(tek.enc_g, fold, n)).all()
    # views carry the tables; without the switch nothing is built
    tk = tek.take([1], 0).expand(1)
    assert tuple(tk.enc_tab_g.shape[2:-1]) == (1, 1) and tk.tile(4).enc_tab_h is tk.enc_tab_h
    monkeypatch.setenv("TPU_MPC_TORCH_ENC_TABLES", "0")
    off = rp.PaillierCtxBatch.from_ints(n, 768, "cpu").ensure_enc_tables()
    assert off.enc_tab_g is None and off.sample_unit_with_power((2,), SessionRng(5),
                                                               want_t=True)[2] is None


def test_dlog_tables_follow_views_and_equal_pow_prod(monkeypatch):
    """pow_h1h2 from the h1/h2 tables equals the table-free pow_prod, also
    through take / expand / swapped / tile; the switch gates the build."""
    monkeypatch.setenv("TPU_MPC_TORCH_ENC_TABLES", "0")
    rng = np.random.default_rng(3)
    bits = 256
    nt = _moduli(rng, bits, 3).reshape(1, 3)
    h1 = np.asarray([[_rand(rng, bits) % int(v) for v in nt[0]]], dtype=object)
    h2 = np.asarray([[_rand(rng, bits) % int(v) for v in nt[0]]], dtype=object)
    plain = rp.DlogStatementBatch.from_ints(nt, h1, h2, bits, "cpu")
    assert plain.ensure_tables().tables_rns is None
    monkeypatch.setenv("TPU_MPC_TORCH_ENC_TABLES", "1")
    tab = rp.DlogStatementBatch.from_ints(nt, h1, h2, bits, "cpu").ensure_tables()
    assert tuple(tab.tables_rns[0].shape[:3]) == (388, 16, 1)
    peers = np.asarray([[1, 2], [0, 2], [0, 1]])
    views = lambda s: s.tile(2).take(peers, 1)                     # [2, 3, 2]
    e1 = np.asarray([[[_rand(rng, 700) for _ in range(2)] for _ in range(3)]
                     for _ in range(2)], dtype=object)
    e2 = np.asarray([[[_rand(rng, 1000) for _ in range(2)] for _ in range(3)]
                     for _ in range(2)], dtype=object)
    hints = (768, 768 + bits)
    got = views(tab).pow_h1h2(e1, e2, hints)
    assert np.array_equal(got, views(plain).pow_h1h2(e1, e2, hints))
    sw = tab.swapped().expand(0)
    assert np.array_equal(sw.pow_h1h2(e1[0, 0, :1], e2[0, 0, :1], hints),
                          plain.swapped().expand(0).pow_h1h2(e1[0, 0, :1], e2[0, 0, :1], hints))


def test_scrub_defuses_deferred_launch():
    calls = []
    d = DeferredLaunch(lambda: calls.append(1) or np.asarray([5, 6], dtype=object))
    assert list(d.ints()) == [5, 6] and list(d.ints()) == [5, 6] and calls == [1]
    cache = d._cache
    scrub_array(d)
    assert d._cache is None and d.fn is None and list(cache) == [0, 0]


def test_table_group_rows_route_compressed_tables():
    """_table_group_rows equals the reference's row map, and routes a call
    over S = 4 interleaved sessions and 2 party slots to G = 2 key groups of
    compressed [G, 2] tables (python pow as the oracle)."""
    from tpu_mpc.zk import range_proofs as jrp

    for args in ((np.asarray([0, 1, 0, 1]), (2, 2), (4, 2), (4, 2)),
                 (np.asarray([1, 0]), (2, 3, 1), (2, 3, 1), (2, 2, 3, 1)),
                 (np.asarray([0, 0, 1]), (2,), (3,), (3,))):
        assert np.array_equal(rp._table_group_rows(*args), jrp._table_group_rows(*args))
    rng = np.random.default_rng(4)
    bits, G = 256, 2
    ns = _moduli(rng, bits, 2 * G).reshape(G, 2)
    b = np.asarray([[_rand(rng, bits) % int(n) for n in row] for row in ns], dtype=object)
    tabs = ModCtx.from_ints(ns, bits, "cpu").make_tables_rns(b[None], 16)
    gmap = np.asarray([0, 1, 0, 1])
    rows = rp._table_group_rows(gmap, tabs[0].shape[2:-1], (4, 2), (4, 2))
    n_s = ns[gmap]
    e = np.asarray([[_rand(rng, 16) for _ in range(2)] for _ in range(4)], dtype=object)
    got = ModCtx.from_ints(n_s, bits, "cpu").pow_fixed_prod_rns(tabs, [e], (16,), gmap=rows)
    assert (got == _pows(b[gmap], e, n_s)).all()


def test_bob_proof_with_table_randomness(monkeypatch):
    """bob_prove with table-sampled randomness (r_is_table: beta from the
    randomizer tables too) and h1/h2 tables passes bob_verify; a tampered
    response fails."""
    from tpu_mpc_torch.mta.mta import paillier_encrypt_ints

    monkeypatch.setenv("TPU_MPC_TORCH_ENC_TABLES", "1")
    p, q, nt, h1, h2 = _fixture_keys()
    ek = rp.PaillierCtxBatch.from_ints(p * q, 768, "cpu").attach_sk(p, q).ensure_enc_tables()
    stmt = rp.DlogStatementBatch.from_ints(nt, h1, h2, 768, "cpu").ensure_tables()
    rng = SessionRng(8)
    b = rng.scalars((2,))
    beta_prim = rng.below(ek.n, (2,))
    a_enc = paillier_encrypt_ints(ek, rng.scalars((2,)), rng.below(ek.n, (2,)))
    r, rn = ek.sample_unit_with_power((2,), rng, sync=True)
    mta_enc = (_pows(a_enc, b, ek.nn) * paillier_encrypt_ints(ek, beta_prim, r, rn=rn)) % ek.nn
    proof = rp.bob_prove(b, beta_prim, a_enc, mta_enc, r, ek, stmt, rng, r_is_table=True)
    assert rp.bob_verify(proof, a_enc, mta_enc, ek, stmt).all()
    proof.s2 = proof.s2 + np.asarray([0, 1], dtype=object)
    assert rp.bob_verify(proof, a_enc, mta_enc, ek, stmt).tolist() == [True, False]


@pytest.mark.parametrize("B", [1, LANE_TILE - 1, LANE_TILE + 1])
def test_k2_lane_tile_padding_and_group_sort_keep_the_callers_order(monkeypatch, B):
    """fixed_prod_dispatch hands K2 its lanes sorted by group row (so that a
    lane tile holds one or two key groups) and returns the output in the
    caller's order; fixed_call pads to whole lane tiles with exponent 0 and
    the last lane's group row.  256 bits, G = 3, an unsorted gmap, ragged
    lane counts 1, L - 1 and L + 1, python pow as the oracle."""
    from tpu_mpc_torch.core import pallas_rns as tpr

    L = tpr.LANE_TILE
    rng = np.random.default_rng(40 + B)
    bits, G = 256, 3
    ns = _moduli(rng, bits, G)
    g = np.asarray([[_rand(rng, bits) % int(n) for n in ns]], dtype=object)
    tabs = ModCtx.from_ints(ns, bits, "cpu").make_tables_rns(g, 16)
    seen = []
    real = tpr.fixed_call
    monkeypatch.setattr(tpr, "fixed_call", lambda *a: seen.append(a) or real(*a))
    gmap = np.asarray([(5 * i + 2) % G for i in range(B)])
    n_s = ns[gmap]
    e = np.asarray([_rand(rng, 16) for _ in range(B)], dtype=object)
    got = ModCtx.from_ints(n_s, bits, "cpu").pow_fixed_prod_rns(tabs, [e], (16,), gmap=gmap)
    assert (got == _pows(g[0, gmap], e, n_s)).all()
    ew, grow, rows, T, nwins, woffs, nb = seen[-1]
    assert grow.tolist() == sorted(gmap.tolist())
    if B > 1:   # per-lane moduli travel with their lanes
        order = np.argsort(gmap, kind="stable")
        want_rows = trns.RnsCtx.from_ints(n_s[order], bits, "cpu").rows
        assert torch.equal(rows, want_rows)
    ep, gp, rp = tpr.k2_tiles(ew, grow, rows)
    assert ep.shape[0] % L == 0 and ep.shape[0] - B < L
    assert not ep[B:].any() and bool((gp[B:] == grow[-1]).all())
    assert torch.equal(tpr.fixed_plain(ep, gp, rp, T, nwins, woffs, nb)[:B],
                       tpr.fixed_plain(ew, grow, rows, T, nwins, woffs, nb))
