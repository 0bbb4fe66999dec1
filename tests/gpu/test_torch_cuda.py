"""The hand-written kernels against their plain versions on the card
(exact, tolerance 0).  Marked `cuda`: without a CUDA device each test skips.
Run on a machine with the card: python -m pytest tests/gpu -m cuda -q"""

import random

import numpy as np
import pytest
import torch

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the CUDA kernels have no CPU mode")
    return torch.device("cuda", 0)


@pytest.mark.parametrize("bits", [256, 2048])
def test_k1_equals_plain_and_pow(dev, bits):
    from tpu_mpc_torch import kernels
    from tpu_mpc_torch.core.modctx import ModCtx

    rnd = random.Random(bits)
    ns = np.asarray([rnd.getrandbits(bits) | 1 | (1 << (bits - 1)) for _ in range(3)],
                    dtype=object)
    b = np.asarray([rnd.getrandbits(bits) for _ in range(3)], dtype=object)
    e = np.asarray([rnd.getrandbits(256) for _ in range(3)], dtype=object)
    n0 = kernels.LAUNCHES["K1"]
    got = ModCtx.from_ints(ns, bits, dev).pow(b, e, 256)
    assert kernels.LAUNCHES["K1"] == n0 + 1
    want = ModCtx.from_ints(ns, bits, "cpu").pow(b, e, 256)
    assert (got == want).all()
    assert all(int(g) == pow(int(x), int(y), int(n)) for g, x, y, n in zip(got, b, e, ns))


def test_k2_equals_plain_and_pow(dev):
    """K2 over two bases of different exponent classes and G = 3 key groups,
    against fixed_plain on the same CUDA inputs and python pow()."""
    from tpu_mpc_torch import kernels
    from tpu_mpc_torch.core import pallas_rns as pr
    from tpu_mpc_torch.core.modctx import ModCtx

    rnd = random.Random(2)
    bits, G, S = 768, 3, 4
    ns = np.asarray([[rnd.getrandbits(bits) | 1 | (1 << (bits - 1)) for _ in range(G)]],
                    dtype=object)
    h = np.asarray([[[rnd.getrandbits(bits) % int(n) for n in ns[0]]] for _ in range(2)],
                   dtype=object)
    e1 = np.asarray([[rnd.getrandbits(64) for _ in range(G)] for _ in range(S)], dtype=object)
    e2 = np.asarray([[rnd.getrandbits(256) for _ in range(G)] for _ in range(S)], dtype=object)
    mc = ModCtx.from_ints(ns, bits, dev)
    tabs = mc.make_tables_rns(h, 256)
    cap = {}
    real = pr.fixed_call
    pr.fixed_call = lambda *a: cap.setdefault("a", a) and real(*a)
    try:
        n0 = kernels.LAUNCHES["K2"]
        got = mc.pow_fixed_prod_rns(tabs, [e1, e2], (64, 256))
        assert kernels.LAUNCHES["K2"] == n0 + 1
    finally:
        pr.fixed_call = real
    e, grow, rows, T, nwins, woffs, nbits = cap["a"]
    assert torch.equal(real(e, grow, rows, T, nwins, woffs, nbits),
                       pr.fixed_plain(e, grow, rows, T, nwins, woffs, nbits))
    for s in range(S):
        for g in range(G):
            m = int(ns[0, g])
            want = pow(int(h[0, 0, g]), int(e1[s, g]), m) * pow(int(h[1, 0, g]), int(e2[s, g]), m)
            assert int(got[s, g]) == want % m


def test_ec_kernels_equal_plain(dev):
    from tpu_mpc_torch.ec import pallas_ec as pe
    from tpu_mpc_torch.ec import secp256k1 as ec
    from tpu_mpc_torch.host import ec as hec

    rnd = random.Random(3)
    ks = np.asarray([rnd.randrange(hec.N) for _ in range(5)] + [0], dtype=object)
    pts = [hec.mul(rnd.randrange(1, hec.N)) for _ in range(5)] + [None]
    for d in (dev, torch.device("cpu")):
        k, P = ec.sc_from_ints(ks, d), ec.points_from_host(pts, d)
        r3 = ec.points_to_host_list(ec.scalar_mul(k, P))
        r3d = ec.points_to_host_list(ec.dual_mul(k, P, k, ec.generator((6,), d)))
        r4 = ec.points_to_host_list(ec.mul_generator(k))
        if d.type == "cuda":
            got = (r3, r3d, r4)
        else:
            assert got == (r3, r3d, r4)
    P = ec.points_from_host(pts, dev)
    DG, NEG = pe._glv_prep(ec.sc_from_ints(ks, dev))
    rows = torch.stack([P.X, P.Y, P.Z], 1)[:, None]
    assert torch.equal(pe.ladder_call(rows, DG, NEG), pe.ladder_plain(rows, DG, NEG))
    assert torch.equal(pe.affine_call(rows[:, 0]), pe.affine_plain(rows[:, 0]))
