"""K1 (the RNS modexp) and ModCtx of the port, on the CPU through K1's plain
version, held exactly (tolerance 0: integers) against python pow() and the
reference package: its XLA RNS path (TPU_MPC_PALLAS=0) with reduce_axis0 on
and off, and once its Pallas dispatch in interpret mode."""

import numpy as np
import pytest

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


@pytest.mark.parametrize("reduce_axis0", [False, True])
def test_k1_plain_matches_reference_xla(monkeypatch, reduce_axis0):
    monkeypatch.setenv("TPU_MPC_PALLAS", "0")
    from tpu_mpc.core import rns as jrns

    rng = np.random.default_rng(21)
    bits = 768
    ns = _moduli(rng, bits, 1)
    S = 4
    b = np.asarray([[_rand(rng, bits) % int(ns[0])] for _ in range(S)], dtype=object)
    e = np.asarray([[_rand(rng, 64)] for _ in range(S)], dtype=object)
    jctx = jrns.RnsCtx.from_ints(ns, bits)
    want = jrns.rns_exp_dispatch(jctx, ns, b, e, 64, reduce_axis0=reduce_axis0).ints()
    ctx = ModCtx.from_ints(ns, bits, device="cpu")
    got = ctx.pow_prod_axis0(b, e, 64) if reduce_axis0 else ctx.pow(b, e, 64)
    assert np.asarray(got).shape == np.asarray(want).shape
    assert (np.asarray(got, dtype=object) == np.asarray(want, dtype=object)).all()


def test_k1_plain_matches_reference_pallas_interpret(monkeypatch):
    monkeypatch.setenv("TPU_MPC_PALLAS", "1")
    from tpu_mpc.core import rns as jrns

    rng = np.random.default_rng(31)
    ns = _moduli(rng, 256, 3)
    b = np.asarray([_rand(rng, 256) >> 1 for _ in range(3)], dtype=object)
    e = np.asarray([_rand(rng, 16) | 1 for _ in range(3)], dtype=object)
    want = jrns.rns_exp_dispatch(jrns.RnsCtx.from_ints(ns, 256), ns, b, e, 16).ints()
    got = trns.rns_exp_dispatch(trns.RnsCtx.from_ints(ns, 256, "cpu"), ns, b, e, 16).ints()
    assert (got == want).all() and (got == _pows(b, e, ns)).all()
