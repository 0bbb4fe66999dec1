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


def test_k1_ragged_lanes_and_per_lane_moduli(dev):
    """Lane counts that are not a multiple of the lane tile, one modulus per
    lane inside a tile, both emit modes: kernel == plain, and python pow."""
    from tpu_mpc_torch.core import pallas_rns as pr
    from tpu_mpc_torch.core.limbs import batch_to_limbs
    from tpu_mpc_torch.core.rns import RnsCtx, RnsLazy, RnsParams

    L = pr.LANE_TILE
    rnd = random.Random(L)
    bits = 768
    par = RnsParams(bits)
    for B in (1, L - 1, L + 1):
        ns = np.asarray([rnd.getrandbits(bits) | 1 | (1 << (bits - 1)) for _ in range(B)],
                        dtype=object)
        b = np.asarray([rnd.getrandbits(bits) % int(n) for n in ns], dtype=object)
        e = np.asarray([rnd.getrandbits(128) for _ in range(B)], dtype=object)
        x = torch.as_tensor(batch_to_limbs(b, par.Lin), device=dev)
        ew = torch.as_tensor(pr._pack_words(batch_to_limbs(e, 8)), device=dev)
        rows = RnsCtx.from_ints(ns, bits, dev).rows
        for emit in (True, False):
            assert torch.equal(pr.exp_call(x, ew, rows, bits, emit),
                               pr.exp_plain(x, ew, rows, bits, emit))
        got = RnsLazy((pr.exp_call(x, ew, rows, bits),), (B,), ns, par.MA).ints()
        assert all(int(g) == pow(int(v), int(k), int(n)) for g, v, k, n in zip(got, b, e, ns))


def test_k1_4096_bits_512_lanes_256_bit_exponents(dev):
    """The K1 shape GG20 blame adds: c_A^gamma mod N^2 over [S, tp, tp] =
    512 lanes at S = 128, 4096-bit moduli, 256-bit exponents; one modulus
    per lane, both emit modes: kernel == plain, and python pow on a sample."""
    import math

    from tpu_mpc_torch import kernels
    from tpu_mpc_torch.core import pallas_rns as pr
    from tpu_mpc_torch.core.limbs import batch_to_limbs, nlimbs
    from tpu_mpc_torch.core.rns import RnsCtx, RnsLazy, RnsParams

    rnd = random.Random(4096)
    bits, B = 4096, 512
    par = RnsParams(bits)
    ns = []
    while len(ns) < B:
        v = rnd.getrandbits(bits) | 1 | (1 << (bits - 1))
        if math.gcd(v, par.MA * par.MB) == 1:
            ns.append(v)
    ns = np.asarray(ns, dtype=object)
    b = np.asarray([rnd.getrandbits(bits) % int(n) for n in ns], dtype=object)
    e = np.asarray([rnd.getrandbits(256) for _ in range(B)], dtype=object)
    e[0] = 0
    x = torch.as_tensor(batch_to_limbs(b, par.Lin), device=dev)
    ew = torch.as_tensor(pr._pack_words(batch_to_limbs(e, nlimbs(256))), device=dev)
    rows = RnsCtx.from_ints(ns, bits, dev).rows
    for emit in (True, False):
        assert torch.equal(pr.exp_call(x, ew, rows, bits, emit),
                           pr.exp_plain(x, ew, rows, bits, emit))
    n0 = kernels.LAUNCHES["K1"]
    got = RnsLazy((pr.exp_call(x, ew, rows, bits),), (B,), ns, par.MA).ints()
    assert kernels.LAUNCHES["K1"] == n0 + 1
    for i in (0, 1, 7, 8, 255, 256, 510, 511):
        assert int(got[i]) == pow(int(b[i]), int(e[i]), int(ns[i]))


def test_k2_mixed_groups_in_a_tile(dev, monkeypatch):
    """K2 with lanes of three key groups interleaved inside each tile (the
    staged groups and the L2 path for a third), ragged lane counts, and the
    same lanes through fixed_prod_dispatch, which sorts them by group."""
    from tpu_mpc_torch.core import pallas_rns as pr
    from tpu_mpc_torch.core.modctx import ModCtx

    L = pr.LANE_TILE
    rnd = random.Random(20 + L)
    bits, G = 768, 3
    ns = np.asarray([rnd.getrandbits(bits) | 1 | (1 << (bits - 1)) for _ in range(G)],
                    dtype=object)
    g = np.asarray([[rnd.getrandbits(bits) % int(n) for n in ns]], dtype=object)
    tabs = ModCtx.from_ints(ns, bits, dev).make_tables_rns(g, 64)
    cap = {}
    real = pr.fixed_call
    monkeypatch.setattr(pr, "fixed_call", lambda *a: cap.setdefault("a", a) and real(*a))
    for B in (L - 1, L + 1, 3 * L + 1):
        gmap = np.asarray([(i * 7 + i // 3) % G for i in range(B)])
        e = np.asarray([rnd.getrandbits(64) for _ in range(B)], dtype=object)
        cap.clear()
        got = ModCtx.from_ints(ns[gmap], bits, dev).pow_fixed_prod_rns(tabs, [e], (64,),
                                                                       gmap=gmap)
        assert all(int(v) == pow(int(g[0, gi]), int(k), int(ns[gi]))
                   for v, gi, k in zip(got, gmap, e))
        ew, grow, rows, T, nwins, woffs, nb = cap["a"]
        assert torch.equal(real(ew, grow, rows, T, nwins, woffs, nb),
                           pr.fixed_plain(ew, grow, rows, T, nwins, woffs, nb))
        # unsorted: every tile mixes the three groups
        perm = torch.as_tensor(np.argsort(np.argsort(gmap, kind="stable")), device=dev)
        args = (ew[perm], grow[perm], rows[perm], T, nwins, woffs, nb)
        assert torch.equal(real(*args), pr.fixed_plain(*args))


def test_k2_multitenant_24_groups(dev, monkeypatch):
    """K2 over 24 flattened key groups (8 key sets x 3 parties, the
    multi-tenant phase of chip_smoke.py) at 2048 bits, sessions interleaved
    over the groups: kernel == fixed_plain on the same inputs, and python
    pow for every lane."""
    from tpu_mpc_torch import kernels
    from tpu_mpc_torch.core import pallas_rns as pr
    from tpu_mpc_torch.core.modctx import ModCtx

    rnd = random.Random(24)
    bits, G, lanes = 2048, 24, 24 * 11
    ns = np.asarray([rnd.getrandbits(bits) | 1 | (1 << (bits - 1)) for _ in range(G)],
                    dtype=object)
    g = np.asarray([[rnd.getrandbits(bits) % int(n) for n in ns]], dtype=object)
    tabs = ModCtx.from_ints(ns.reshape(8, 3), bits, dev).make_tables_rns(g.reshape(1, 8, 3), 256)
    gmap = np.arange(lanes) % G
    e = np.asarray([rnd.getrandbits(256) for _ in range(lanes)], dtype=object)
    cap = {}
    real = pr.fixed_call
    monkeypatch.setattr(pr, "fixed_call", lambda *a: cap.setdefault("a", a) and real(*a))
    n0 = kernels.LAUNCHES["K2"]
    got = ModCtx.from_ints(ns[gmap], bits, dev).pow_fixed_prod_rns(tabs, [e], (256,), gmap=gmap)
    assert kernels.LAUNCHES["K2"] == n0 + 1
    assert all(int(v) == pow(int(g[0, gi]), int(k), int(ns[gi]))
               for v, gi, k in zip(got, gmap, e))
    ew, grow, rows, T, nwins, woffs, nb = cap["a"]
    assert T[0].shape[2] == G
    assert torch.equal(real(ew, grow, rows, T, nwins, woffs, nb),
                       pr.fixed_plain(ew, grow, rows, T, nwins, woffs, nb))


RAGGED_EC = (1, 7, 9, 33, 257)
MAIN_EC = (256, 512)            # lane counts of the main path that the card tests run


def _comb_points(dev, rnd, n):
    """n canonical Jacobian points with Z != 1 (the plain comb on the card)."""
    from tpu_mpc_torch.ec import pallas_ec as pe
    from tpu_mpc_torch.ec import secp256k1 as ec
    from tpu_mpc_torch.host import ec as hec

    ks = np.asarray([rnd.randrange(1, hec.N) for _ in range(n)], dtype=object)
    tab = pe._comb8_for(hec.G, dev)[0]
    return pe.comb_plain(pe._comb_digits(ec.sc_from_ints(ks, dev)), tab)


@pytest.mark.parametrize("ns", [2, 4])
def test_k3_ragged_lanes_equal_plain(dev, ns):
    """K3 at lane counts off its 8-lane block and at 256 and 512, lane 0
    an infinity base and lane 1 (where present) k = 0: kernel == plain,
    exactly."""
    from tpu_mpc_torch import kernels
    from tpu_mpc_torch.ec import pallas_ec as pe
    from tpu_mpc_torch.ec import secp256k1 as ec

    rnd = random.Random(40 + ns)
    for n in RAGGED_EC + MAIN_EC:
        pts = _comb_points(dev, rnd, n * ns // 2)
        pts[0] = 0
        pts[0, 0, 0] = pts[0, 1, 0] = 1
        ks = [rnd.randrange(ec.Q_INT) for _ in range(n * ns // 2)]
        ks[min(1, n - 1)] = 0
        DG, NEG = pe._glv_prep(ec.sc_from_ints(np.asarray(ks, dtype=object), dev))
        if ns == 2:
            P = pts[:, None]
        else:
            P = torch.stack([pts[:n], pts[n:]], 1)
            DG, NEG = torch.cat([DG[:n], DG[n:]], 1), torch.cat([NEG[:n], NEG[n:]], 1)
        n0 = kernels.LAUNCHES["K3"]
        got = pe.ladder_call(P, DG, NEG)
        assert kernels.LAUNCHES["K3"] == n0 + 1
        assert torch.equal(got, pe.ladder_plain(P, DG, NEG)), n


@pytest.mark.parametrize("base", ["G", "BASE_POINT2"])
def test_k4_ragged_lanes_equal_plain(dev, base):
    """K4 at lane counts off its 16-lane block and at the main path's, lane 0
    k = 0 (all digits 0, the identity), lane 1 k = 1, and digits 0 and 255
    in two windows of every other lane: kernel == plain, exactly; without
    its planes the wrapper raises."""
    from tpu_mpc_torch import kernels
    from tpu_mpc_torch.ec import pallas_ec as pe
    from tpu_mpc_torch.host import ec as hec

    bxy = hec.G if base == "G" else hec.BASE_POINT2
    rnd = random.Random(50)
    tab, planes = pe._comb8_for(bxy, dev)
    for n in RAGGED_EC + MAIN_EC:
        dg = torch.as_tensor([[rnd.randrange(256) for _ in range(32)] for _ in range(n)],
                             device=dev)
        dg[:2] = 0
        dg[1:2, 0] = 1
        lane = torch.arange(min(2, n), n, device=dev)
        dg[lane, lane % 32] = 0
        dg[lane, (lane + 11) % 32] = 255
        n0 = kernels.LAUNCHES["K4"]
        got = pe.comb_call(dg, tab, planes)
        assert kernels.LAUNCHES["K4"] == n0 + 1
        assert torch.equal(got, pe.comb_plain(dg, tab)), n
    with pytest.raises(ValueError, match="K4: bad planes"):
        pe.comb_call(dg, tab)


def test_k5_ragged_lanes_equal_plain(dev):
    """K5 at lane counts off its 32-lane block and at 256 and 512 lanes, lane 0
    Z = 0, lanes 1.. the edge Z values (pallas_ec.Z_EDGE, with X, Y of real
    points): kernel == plain, exactly, and the edge lanes against python pow.
    The main path's other K5 shapes (128 to 1792 lanes) are held against the
    plain version in chip_smoke.py's first warm-up pass."""
    from tpu_mpc_torch import kernels
    from tpu_mpc_torch.ec import pallas_ec as pe

    rnd = random.Random(60)
    limbs = lambda v: torch.as_tensor([(v >> (16 * i)) & 0xFFFF for i in range(16)],
                                      device=dev)
    val = lambda t: sum(int(v) << (16 * i) for i, v in enumerate(t.tolist()))
    for n in RAGGED_EC + MAIN_EC:
        pts = _comb_points(dev, rnd, n)
        pts[0, 2] = 0
        for j, z in enumerate(pe.Z_EDGE[:n - 1]):
            pts[1 + j, 2] = limbs(z)
        n0 = kernels.LAUNCHES["K5"]
        got = pe.affine_call(pts)
        assert kernels.LAUNCHES["K5"] == n0 + 1
        assert torch.equal(got, pe.affine_plain(pts)), n
        for j in range(min(n, 1 + len(pe.Z_EDGE))):
            zi = pow(val(pts[j, 2]) or 1, -1, pe.P_INT)
            assert val(got[j, 0]) == val(pts[j, 0]) * zi * zi % pe.P_INT
            assert val(got[j, 1]) == val(pts[j, 1]) * zi ** 3 % pe.P_INT
