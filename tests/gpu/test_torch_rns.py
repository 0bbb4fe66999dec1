"""K1 (the RNS modexp) and ModCtx of the port, on the CPU through K1's plain
version, held exactly (tolerance 0: integers) against python pow() and the
reference package: its XLA RNS path (TPU_MPC_PALLAS=0) with reduce_axis0 on
and off, and once its Pallas dispatch in interpret mode (their outputs on
the tests' seeded inputs committed in fixtures/kernels_rns.json)."""

import json
import os

import numpy as np
import pytest
import torch

from tpu_mpc_torch.core import pallas_rns as tpr
from tpu_mpc_torch.core import rns as trns
from tpu_mpc_torch.core.modctx import ModCtx, ebits_class


def _rand(rng, bits):
    return int.from_bytes(rng.bytes(bits // 8), "little")


def _moduli(rng, bits, n):
    return np.asarray([_rand(rng, bits) | 1 | (1 << (bits - 1)) for _ in range(n)],
                      dtype=object)


def _pows(b, e, n):
    b, e, n = np.broadcast_arrays(*(np.asarray(a, dtype=object) for a in (b, e, n)))
    return np.vectorize(lambda x, y, m: pow(int(x), int(y), int(m)), otypes=[object])(b, e, n)


@pytest.mark.parametrize("bits,ebits", [(768, 768), (4096, 512)])
def test_k1_plain_matches_pow(bits, ebits):
    rng = np.random.default_rng(bits)
    ns = _moduli(rng, bits, 3)
    ctx = ModCtx.from_ints(ns, bits, device="cpu")
    bases = np.asarray([_rand(rng, bits + 64) for _ in range(3)], dtype=object)
    exps = np.asarray([_rand(rng, ebits) for _ in range(3)], dtype=object)
    exps[0] = 0
    assert (ctx.pow(bases, exps, ebits_hint=ebits) == _pows(bases, exps, ns)).all()


def test_k1_shared_modulus_and_reduce_axis0_trailing_moduli():
    """Moduli constant along axis 0 but different along a trailing dim: the
    reduced output keeps one modulus per trailing slot."""
    rng = np.random.default_rng(5)
    ns = _moduli(rng, 768, 2)
    ctx = ModCtx.from_ints(ns[None, :], 768, device="cpu")        # [1, 2]
    S = 5
    b = np.asarray([[_rand(rng, 768) for _ in range(2)] for _ in range(S)], dtype=object)
    e = np.asarray([[_rand(rng, 128) for _ in range(2)] for _ in range(S)], dtype=object)
    got = ctx.pow_prod_axis0(b, e, 128)
    vals = _pows(b, e, ns[None, :])
    for j in range(2):
        want = 1
        for s in range(S):
            want = want * int(vals[s, j]) % int(ns[j])
        assert int(got[0, j]) == want
    # one modulus for every lane: the kernel's shared-ctx layout
    shared = ModCtx.from_ints(np.asarray([ns[0]] * 4, dtype=object), 768, device="cpu")
    assert tpr._ctx_blocks(shared.rns_ctx(), (4,), shared.n_ints).shape[0] == 1
    assert (shared.pow(b[:4, 0], e[:4, 0], 128) == _pows(b[:4, 0], e[:4, 0], ns[0])).all()


def test_pow_prod_multibase_and_mults():
    rng = np.random.default_rng(9)
    ns = _moduli(rng, 768, 3)
    ctx = ModCtx.from_ints(ns, 768, device="cpu")
    h1 = np.asarray([_rand(rng, 760) for _ in range(3)], dtype=object)
    h2 = np.asarray([_rand(rng, 760) for _ in range(3)], dtype=object)
    e1 = np.asarray([_rand(rng, 256) for _ in range(3)], dtype=object)
    e2 = np.asarray([_rand(rng, 1024) for _ in range(3)], dtype=object)
    m = np.asarray([_rand(rng, 700) for _ in range(3)], dtype=object)
    got = ctx.pow_prod([h1, h2], [e1, e2], ebits_hints=(256, 1024), mults=[m])
    want = _pows(h1, e1, ns) * _pows(h2, e2, ns) % ns * m % ns
    assert (got == want).all()
    one = ctx.pow_prod([h1], [e1], ebits_hints=(256,), mults=[m], sync=False)
    assert (one.ints() == _pows(h1, e1, ns) * m % ns).all()


def test_pow_prod_stacks_every_base_into_one_launch(monkeypatch):
    """Multi-base pow_prod is one K1 call over the stacked bases, at the
    widest exponent class (splitting by class measured slower on the card:
    PERF.md); narrower exponents are zero-padded and the product is exact."""
    rng = np.random.default_rng(11)
    ns = _moduli(rng, 768, 2)
    ctx = ModCtx.from_ints(ns, 768, device="cpu")
    bs = [np.asarray([_rand(rng, 760) for _ in range(2)], dtype=object) for _ in range(3)]
    es = [np.asarray([_rand(rng, w) for _ in range(2)], dtype=object) for w in (128, 768, 100)]
    calls = []
    plain = tpr.exp_plain

    def spy(x, e, rows, nbits, emit_planes=True):
        calls.append((x.shape[0], e.shape[1]))
        return plain(x, e, rows, nbits, emit_planes)

    monkeypatch.setattr(tpr, "exp_plain", spy)
    got = ctx.pow_prod(bs, es, ebits_hints=(128, 768, 128))
    want = _pows(bs[0], es[0], ns) * _pows(bs[1], es[1], ns) % ns * _pows(bs[2], es[2], ns) % ns
    assert (got == want).all()
    assert calls == [(6, -(-ebits_class(768) // 32))]


def test_modctx_views_follow_the_moduli():
    rng = np.random.default_rng(11)
    ns = _moduli(rng, 256, 6).reshape(2, 3)
    ctx = ModCtx.from_ints(ns, 256, device="cpu")
    b = np.asarray([[_rand(rng, 256) for _ in range(3)] for _ in range(2)], dtype=object)
    e = np.asarray([[_rand(rng, 64) for _ in range(3)] for _ in range(2)], dtype=object)
    tk = ctx.take([2, 0], 1)
    assert (tk.pow(b[:, :2], e[:, :2], 64) == _pows(b[:, :2], e[:, :2], ns[:, [2, 0]])).all()
    peers = np.asarray([[1], [0]])
    tp = ctx.take(peers, 1)                                         # [2, 2, 1]
    assert tp.batch_shape == (2, 2, 1)
    assert tuple(tp.rns_ctx().batch_shape) == (2, 2, 1)
    ex = ctx.expand(2)                                              # [2, 3, 1]
    b2 = b[:, :, None]
    assert (ex.pow(b2, e[:, :, None], 64) == _pows(b2, e[:, :, None], ns[:, :, None])).all()
    t1 = ModCtx.from_ints(ns[:1], 256, device="cpu").tile(4)
    assert t1.batch_shape == (4, 3) and tuple(t1.rns_ctx().batch_shape) == (4, 3)
    rl = t1.reshape_lead(2, 2)
    assert rl.batch_shape == (2, 2, 3) and tuple(rl.rns_ctx().batch_shape) == (2, 2, 3)
    assert [ebits_class(b) for b in (1, 16, 17, 2049, 4096)] == [16, 16, 64, 2320, 4096]


def test_rns_params_equal_reference():
    from tpu_mpc.core.rns import RnsParams as JP

    for bits in (256, 2048, 4096):
        a, b = trns.RnsParams(bits), JP(bits)
        assert (a.K, a.Kp, a.Lout, a.Lin) == (b.K, b.Kp, b.Lout, b.Lin)
        assert a.pA == b.pA and a.pB == b.pB and a.MA == b.MA and a.MB == b.MB
        for f in ("W1", "W2", "invMAk", "invMBj", "MB_A", "invMA_B", "Wbin", "W16A", "W16B"):
            assert np.array_equal(np.asarray(getattr(a, f), np.int64),
                                  np.asarray(getattr(b, f), np.int64)), f
        assert (a.invMA_r, a.invMB_r) == (int(b.invMA_r), int(b.invMB_r))
    assert (trns.RnsParams(2048).K, trns.RnsParams(4096).K) == (130, 258)


KERNELS_RNS = os.path.join(os.path.dirname(os.path.abspath(__file__)), "fixtures",
                           "kernels_rns.json")


@pytest.fixture(scope="module")
def ref_rns():
    """The reference's outputs on the inputs below (make_torch_goldens.py
    kernels_rns: its XLA RNS path, and its Pallas dispatch in interpret
    mode)."""
    with open(KERNELS_RNS) as f:
        return json.load(f)


def _strs(a):
    """Nested decimal strings, as make_torch_goldens.py writes arrays."""
    return np.vectorize(lambda v: str(int(v)), otypes=[object])(
        np.asarray(a, dtype=object)).tolist()


def _ints(nested):
    return np.vectorize(int, otypes=[object])(np.asarray(nested, dtype=object))


@pytest.mark.parametrize("reduce_axis0", [False, True])
def test_k1_plain_matches_reference_xla(ref_rns, reduce_axis0):
    gold = ref_rns["xla"][str(reduce_axis0)]
    rng = np.random.default_rng(21)
    bits = 768
    ns = _moduli(rng, bits, 1)
    S = 4
    b = np.asarray([[_rand(rng, bits) % int(ns[0])] for _ in range(S)], dtype=object)
    e = np.asarray([[_rand(rng, 64)] for _ in range(S)], dtype=object)
    # the golden was written from these seeded inputs (no drift)
    assert (_strs(ns), _strs(b), _strs(e)) == (gold["ns"], gold["b"], gold["e"])
    want = _ints(gold["want"]).reshape(tuple(gold["shape"]))
    ctx = ModCtx.from_ints(ns, bits, device="cpu")
    got = ctx.pow_prod_axis0(b, e, 64) if reduce_axis0 else ctx.pow(b, e, 64)
    assert np.asarray(got).shape == np.asarray(want).shape
    assert (np.asarray(got, dtype=object) == np.asarray(want, dtype=object)).all()


def test_k1_plain_matches_reference_pallas_interpret(ref_rns):
    gold = ref_rns["interpret"]
    rng = np.random.default_rng(31)
    ns = _moduli(rng, 256, 3)
    b = np.asarray([_rand(rng, 256) >> 1 for _ in range(3)], dtype=object)
    e = np.asarray([_rand(rng, 16) | 1 for _ in range(3)], dtype=object)
    assert (_strs(ns), _strs(b), _strs(e)) == (gold["ns"], gold["b"], gold["e"])
    want = _ints(gold["want"])
    got = trns.rns_exp_dispatch(trns.RnsCtx.from_ints(ns, 256, "cpu"), ns, b, e, 16).ints()
    assert (got == want).all() and (got == _pows(b, e, ns)).all()


# --------------------------------------------------------------------------
# the host side of K1's and K2's tensor-core multiply (csrc/rns_field.cuh)
# --------------------------------------------------------------------------

def _unfrag_planes(buf, par):
    """Inverse of RnsParams.plane_bytes: [W1^T, W2^T, Wbin^T] as int64
    [MT*16, KT*32] matrices recombined from their lo and hi planes."""
    MT, KT = par.MT, par.KT
    rows, cols = trns._FRAG
    n_ext = KT * 2 * MT * 2 * 512
    ext = buf[:n_ext].reshape(KT, 2, MT, 2, 512).astype(np.int64)
    dec = buf[n_ext:].reshape(KT, MT, 2, 512).astype(np.int64)
    out = []
    for chunks in (ext[:, 0], ext[:, 1], dec):                         # [KT, MT, 2, 512]
        M = np.zeros((MT, KT, 16, 32), np.int64)
        v = chunks[:, :, 0] + (chunks[:, :, 1] << 8)                   # [KT, MT, 512]
        M[:, :, rows, cols] = v.transpose(1, 0, 2).reshape(MT, KT, 32, 4, 4)
        out.append(M.transpose(0, 2, 1, 3).reshape(MT * 16, KT * 32))
    return out


def _bred(x, p, m):
    """Barrett as the kernels run it: x < 2^32, m = floor(2^32 / p), the
    quotient estimate low by at most one."""
    assert bool((x >= 0).all()) and bool((x < (1 << 32)).all())
    r = x - ((x * m) >> 32) * p
    assert bool((r < 2 * p).all())
    return torch.where(r >= p, r - p, r)


def _fold(p00, pm, p11, p, m):
    """p00 + 2^8 pm + 2^16 p11 mod p in three Barrett steps."""
    h = pm + (_bred(p11, p, m) << 8)
    return _bred(p00 + (_bred(h, p, m) << 8), p, m)


def _planes(xi, M, kdim):
    """The three s32 planes of M[:, :kdim] . xi^T from u8 chunks, bounds checked."""
    M = torch.as_tensor(M[:, :kdim])
    xl, xh, ml, mh = xi & 255, xi >> 8, M & 255, M >> 8
    p00, pm, p11 = xl @ ml.T, xh @ ml.T + xl @ mh.T, xh @ mh.T
    for p in (p00, pm, p11):
        assert int(p.max()) < (1 << 26) and int(p.min()) >= 0
    return p00, pm, p11


def _tile_montmul(x, y, cp, par):
    """The kernel's montmul in int64 torch: byte-chunk planes against the
    u8 planes the card reads (recombined from the fragment-ordered buffer),
    Barrett reductions, the redundant channel from (p00 + 2^8 pm) & 0xFFFF."""
    W1T, W2T, _ = _unfrag_planes(par.plane_bytes(), par)
    K, Kp = par.K, par.Kp
    pA, pB = torch.as_tensor(par.pA_arr), torch.as_tensor(par.pB_arr)
    mA, mB = torch.as_tensor(par.mA), torch.as_tensor(par.mB)
    mul = lambda a, b, p, m: _bred(a * b, p, m)
    xA, xB, xr = x[..., :K], x[..., K:K + Kp], x[..., K + Kp]
    yA, yB, yr = y[..., :K], y[..., K:K + Kp], y[..., K + Kp]
    xi1 = mul(mul(xA, yA, pA, mA), cp["cA"], pA, mA)
    sB, sr = mul(xB, yB, pB, mB), (xr * yr) & 0xFFFF
    p00, pm, p11 = _planes(xi1, W1T, K)
    qh = _fold(p00[:, :Kp], pm[:, :Kp], p11[:, :Kp], pB, mB)
    num = sB + mul(qh, cp["N_B"], pB, mB)
    tB = mul(torch.where(num >= pB, num - pB, num), torch.as_tensor(par.invMA_B), pB, mB)
    xi2 = mul(tB, torch.as_tensor(par.invMBj), pB, mB)
    qr = (p00[:, Kp] + (pm[:, Kp] << 8)) & 0xFFFF
    tr = (((sr + qr * cp["N_r"]) & 0xFFFF) * par.invMA_r) & 0xFFFF
    p00, pm, p11 = _planes(xi2, W2T, Kp)
    tA = _fold(p00[:, :K], pm[:, :K], p11[:, :K], pA, mA)
    alpha = ((((p00[:, K] + (pm[:, K] << 8)) & 0xFFFF) - tr) & 0xFFFF) * par.invMB_r & 0xFFFF
    corr = mul(alpha[:, None], torch.as_tensor(par.MB_A), pA, mA)
    return torch.cat([torch.where(tA >= corr, tA - corr, tA + pA - corr), tB, tr[:, None]], -1)


@pytest.mark.parametrize("bits", [2048, 4096])
def test_k1_planes_recombine_to_the_extension_matrices(bits):
    par = trns.RnsParams(bits)
    buf = par.plane_bytes()
    assert buf.dtype == np.uint8
    assert buf.nbytes == 2 * par.KT * par.MT * 2 * 512 + par.KT * par.MT * 2 * 512
    W1T, W2T, WbT = _unfrag_planes(buf, par)
    for got, W in ((W1T, par.W1), (W2T, par.W2), (WbT, np.asarray(par.Wbin, np.int64))):
        assert np.array_equal(got[:W.shape[1], :W.shape[0]], W.T)
        assert not got[W.shape[1]:].any() and not got[:, W.shape[0]:].any()
    assert par.MT * 16 >= max(par.Kp + 1, par.Lout) and par.KT * 32 >= par.Kp
    assert (par.MT, par.KT) == {2048: (9, 5), 4096: (17, 9)}[bits]


@pytest.mark.parametrize("bits", [2048, 4096])
def test_k1_tile_montmul_emulation_equals_rns_montmul(bits):
    """The kernel's arithmetic (u8 chunk planes, Barrett folds), emulated in
    int64, equals rns_montmul on random residues and on the worst case,
    every channel at p - 1; the decode's chunk planes equal its dot, and the
    prologue's two-step 64-bit Barrett equals %."""
    par = trns.RnsParams(bits)
    rng = np.random.default_rng(bits)
    ns = _moduli(rng, bits, 4)
    cp = trns.ctx_parts(trns.RnsCtx.from_ints(ns, bits, "cpu").rows, par)
    cs = trns.dev_consts(par, "cpu")
    mods = np.concatenate([par.pA_arr, par.pB_arr, [1 << 16]])
    rnd = torch.as_tensor(rng.integers(0, 1 << 62, (4, par.CH)) % mods)
    worst = torch.as_tensor(np.broadcast_to(mods - 1, (4, par.CH)).copy())
    for x, y in ((rnd, rnd.flip(0)), (worst, worst)):
        want = trns.rns_montmul(x, y, cp, cs, par)
        assert torch.equal(_tile_montmul(x, y, cp, par), want)
    # decode: xi . Wbin from the chunk planes, exact in 64 bits
    xi = worst[:, :par.K]
    p00, pm, p11 = _planes(xi, _unfrag_planes(par.plane_bytes(), par)[2], par.K)
    assert torch.equal((p00 + (pm << 8) + (p11 << 16))[:, :par.Lout], trns._dot(xi, cs["Wbin"]))
    # prologue: limb sums < Lin * 2^32 < 2^40, reduced as bred(bred(lo) + hi * (2^32 mod p))
    limbs = torch.full((2, par.Lin), 0xFFFF, dtype=torch.int64)
    s = limbs @ torch.as_tensor(par.W16A)
    pA, mA = torch.as_tensor(par.pA_arr), torch.as_tensor(par.mA)
    c32 = (1 << 32) - pA * mA
    red = _bred(_bred(s & 0xFFFFFFFF, pA, mA) + (s >> 32) * c32, pA, mA)
    assert int(s.max()) < (1 << 40) and torch.equal(red, s % pA)


@pytest.mark.parametrize("B", [1, tpr.LANE_TILE - 1, tpr.LANE_TILE + 1])
def test_k1_lane_tile_padding_keeps_the_callers_lanes(B):
    """exp_call pads a batch to whole lane tiles (zero bases and exponents,
    copies of the last ctx row); the padded lanes leave the caller's lanes,
    in the caller's order, as they were."""
    L = tpr.LANE_TILE
    rng = np.random.default_rng(B)
    bits = 256
    par = trns.RnsParams(bits)
    ns = _moduli(rng, bits, B)
    rows = trns.RnsCtx.from_ints(ns, bits, "cpu").rows
    b = np.asarray([_rand(rng, bits) % int(n) for n in ns], dtype=object)
    e = np.asarray([_rand(rng, 32) for _ in range(B)], dtype=object)
    x = torch.as_tensor(trns.batch_to_limbs(b, par.Lin))
    ew = torch.as_tensor(tpr._pack_words(trns.batch_to_limbs(e, 2)))
    xp, ep, rp = tpr.k1_tiles(x, ew, rows)
    assert xp.shape[0] % L == 0 and xp.shape[0] - B < L
    assert rp.shape[0] == (xp.shape[0] if B > 1 else 1)     # one row: shared by every lane
    got = tpr.exp_plain(xp, ep, rp, bits)[:B]
    assert torch.equal(got, tpr.exp_plain(x, ew, rows, bits))
    lz = trns.RnsLazy((got,), (B,), ns, par.MA)
    assert (lz.ints() == _pows(b, e, ns)).all()
