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



@pytest.mark.parametrize("G", [5, 8])
def test_k2_five_and_eight_groups_in_the_callers_lane_order(dev, G):
    """K2 with the key groups of an n = 5 or n = 8 key in one call at 2048
    bits, the lanes in the caller's order (a tile of 8 lanes holds up to 8
    groups: two staged, the others read from L2), at ragged lane counts:
    kernel == fixed_plain on the same inputs, and python pow on every lane."""
    from tpu_mpc_torch import kernels
    from tpu_mpc_torch.core import pallas_rns as pr
    from tpu_mpc_torch.core.limbs import batch_to_limbs, nlimbs
    from tpu_mpc_torch.core.modctx import ModCtx
    from tpu_mpc_torch.core.rns import RnsCtx, RnsLazy, RnsParams

    L = pr.LANE_TILE
    rnd = random.Random(50 + G)
    bits, ebits = 2048, 64
    ns = np.asarray([rnd.getrandbits(bits) | 1 | (1 << (bits - 1)) for _ in range(G)],
                    dtype=object)
    g = np.asarray([[rnd.getrandbits(bits) % int(n) for n in ns]], dtype=object)
    T = ModCtx.from_ints(ns, bits, dev).make_tables_rns(g, ebits)[0]
    for B in (L - 1, L + 1, G * L + 3):
        gmap = np.asarray([(3 * i + i // G) % G for i in range(B)])
        if B >= L:
            assert len(set(gmap[:L].tolist())) == min(G, L)
        e = np.asarray([rnd.getrandbits(ebits) for _ in range(B)], dtype=object)
        args = (torch.as_tensor(pr._pack_words(batch_to_limbs(e, nlimbs(ebits))), device=dev),
                torch.as_tensor(gmap, device=dev), RnsCtx.from_ints(ns[gmap], bits, dev).rows,
                [T], [ebits // 4], [0], bits)
        n0 = kernels.LAUNCHES["K2"]
        out = pr.fixed_call(*args)
        assert kernels.LAUNCHES["K2"] == n0 + 1
        assert torch.equal(out, pr.fixed_plain(*args))
        got = RnsLazy((out,), (B,), ns[gmap], RnsParams(bits).MA).ints()
        assert all(int(v) == pow(int(g[0, gi]), int(k), int(ns[gi]))
                   for v, gi, k in zip(got, gmap, e))

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


def _two_party_run(device) -> dict:
    """Lindell'17 keygen(2) and sign at 1024 bits, then one interactive PDL
    round under the keygen's Paillier keys, from SessionRng(0x17): every
    output as plain ints, bools and host points."""
    from tpu_mpc_torch.ec import secp256k1 as ec
    from tpu_mpc_torch.host import ec as hec
    from tpu_mpc_torch.mta.mta import paillier_encrypt_ints
    from tpu_mpc_torch.protocols.lindell17 import batch as l17
    from tpu_mpc_torch.utils.rng import SessionRng
    from tpu_mpc_torch.zk import pdl

    ints = lambda a: [int(v) for v in np.asarray(a, dtype=object).reshape(-1)]
    bools = lambda a: [bool(v) for v in np.asarray(a).reshape(-1)]
    rng = SessionRng(0x17)
    kg = l17.keygen(2, rng, 1024, device=device)
    sig = l17.sign(kg, 0xABCDEF, rng)
    out = {"x1": ints(kg.p1.x1), "x2": ints(kg.p2.x2), "p": ints(kg.p1.p), "q": ints(kg.p1.q),
           "c_key": ints(kg.p1.c_key), "pubkey": ec.points_to_host_list(kg.p1.pubkey),
           "ok": bools(kg.ok), "r": ints(sig.r), "s": ints(sig.s), "recid": ints(sig.recid),
           "sig_ok": bools(sig.ok), "sig_valid": bools(sig.sig_valid)}
    ek, dk = kg.p1.ek, kg.p1.dk
    x = rng.below(hec.N // 3, (2,))
    r = rng.units_below(ek.n, (2,))
    c = paillier_encrypt_ints(ek, x, r)
    stmt = pdl.PDLStatementBatch(ciphertext=c, ek=ek,
                                 Q_pt=ec.mul_generator(ec.sc_from_ints(x, device)))
    wit = pdl.PDLWitnessBatch(x=x, r=r, dk=dk)
    v1, vs = pdl.verifier_message1(stmt, rng)
    p1, ps = pdl.prover_message1(wit, stmt, v1, rng)
    v2, range_ok = pdl.verifier_message2(p1, stmt, vs)
    p2, prover_ok = pdl.prover_message2(v1, v2, wit, ps)
    out.update(c_tag=ints(v1.c_tag), alpha=ints(ps.alpha), c_hat=ints(p1.c_hat),
               rp_c1=ints(p1.range_proof.c1), rp_z=ints(p1.range_proof.z),
               range_ok=bools(range_ok), prover_ok=bools(prover_ok),
               final=bools(pdl.verifier_finalize(p1, p2, vs)))
    return out


def test_lindell17_and_pdl_on_the_card_equal_the_cpu(dev):
    """Lindell'17 keygen(2) + sign at 1024 bits and one PDL round (the range
    proof's stacked encryptions included) on the card: every field equal to
    the same seed's CPU run (plain versions); K1, K3, K4, K5 launched."""
    from tpu_mpc_torch import kernels

    kernels.reset_launches()
    got = _two_party_run(dev)
    launches = dict(kernels.LAUNCHES)
    assert all(launches[k] > 0 for k in ("K1", "K3", "K4", "K5")) and launches["K2"] == 0
    want = _two_party_run("cpu")
    assert got == want
    assert all(got["ok"] + got["sig_ok"] + got["sig_valid"] + got["range_ok"]
               + got["prover_ok"] + got["final"])


def test_sharded_launches_equal_the_unsharded_launch(dev):
    """Under a mesh of 4 entries on one card (sessions_mesh(devices=
    ["cuda:0"] * 4)): K1 at 512 lanes (2048 bits, one modulus per lane, and
    one shared modulus) and K3 (ns = 2 and 4), K4 and K5 at 256 lanes each
    launch 4 pieces, and the gathered output equals the unsharded launch
    exactly."""
    from tpu_mpc_torch import kernels, sharding
    from tpu_mpc_torch.core import pallas_rns as pr
    from tpu_mpc_torch.core.limbs import batch_to_limbs
    from tpu_mpc_torch.core.rns import RnsCtx, RnsParams
    from tpu_mpc_torch.ec import pallas_ec as pe
    from tpu_mpc_torch.ec import secp256k1 as ec
    from tpu_mpc_torch.host import ec as hec

    import math

    mesh = sharding.sessions_mesh(devices=[dev] * 4)
    rnd = random.Random(10)
    bits, B = 2048, 512
    par = RnsParams(bits)
    ns = []
    while len(ns) < B:
        v = rnd.getrandbits(bits) | 1 | (1 << (bits - 1))
        if math.gcd(v, par.MA * par.MB) == 1:
            ns.append(v)
    ns = np.asarray(ns, dtype=object)
    b = np.asarray([rnd.getrandbits(bits) % int(n) for n in ns], dtype=object)
    e = np.asarray([rnd.getrandbits(bits) for _ in range(B)], dtype=object)
    x = torch.as_tensor(batch_to_limbs(b, par.Lin), device=dev)
    ew = torch.as_tensor(pr._pack_words(batch_to_limbs(e, bits // 16)), device=dev)
    rows = RnsCtx.from_ints(ns, bits, dev).rows
    x0 = torch.as_tensor(batch_to_limbs(
        np.asarray([int(v) % int(ns[0]) for v in b], dtype=object), par.Lin), device=dev)
    pts = _comb_points(dev, rnd, 512)
    ks = ec.sc_from_ints(np.asarray([rnd.randrange(hec.N) for _ in range(512)], dtype=object),
                         dev)
    DG, NEG = pe._glv_prep(ks)
    tab, planes = pe._comb8_for(hec.G, dev)
    dg = pe._comb_digits(ks[:256])
    cases = {
        "K1": [(pr.exp_call, (x, ew, rows, bits, emit)) for emit in (True, False)]
        + [(pr.exp_call, (x0, ew, rows[:1], bits, True))],
        "K3": [(pe.ladder_call, (pts[:256, None], DG[:256], NEG[:256])),
               (pe.ladder_call, (torch.stack([pts[:256], pts[256:]], 1),
                                 torch.cat([DG[:256], DG[256:]], 1),
                                 torch.cat([NEG[:256], NEG[256:]], 1)))],
        "K4": [(pe.comb_call, (dg, tab, planes))],
        "K5": [(pe.affine_call, (pts[:256],))],
    }
    for k, runs in cases.items():
        for fn, args in runs:
            want = fn(*args)
            n0 = kernels.LAUNCHES[k]
            with sharding.use_mesh(mesh):
                got = fn(*args)
            assert kernels.LAUNCHES[k] == n0 + 4, k
            assert got.device == want.device and torch.equal(got, want), k


def test_sharded_launches_copy_shared_operands_to_the_card(dev):
    """Operands on the CPU under meshes of card entries: 2 x cuda:0 (every
    piece is a kernel launch) and cuda:0 + cpu (one kernel piece, one plain
    piece).  K1 with a shared modulus row, K2 with its tables and K4 with
    its table and u8 planes: the shared operands are copied once per base
    tensor and card (the second call finds them cached), the pieces'
    outputs come back to the CPU, and each equals the unsharded launch on
    the card exactly."""
    import math

    from tpu_mpc_torch import kernels, sharding
    from tpu_mpc_torch.core import pallas_rns as pr
    from tpu_mpc_torch.core.limbs import batch_to_limbs
    from tpu_mpc_torch.core.modctx import ModCtx
    from tpu_mpc_torch.core.rns import RnsCtx, RnsParams
    from tpu_mpc_torch.ec import pallas_ec as pe
    from tpu_mpc_torch.ec import secp256k1 as ec
    from tpu_mpc_torch.host import ec as hec
    from tpu_mpc_torch.sharding import mesh as shm

    cpu = torch.device("cpu")
    rnd = random.Random(11)
    bits, B = 2048, 64
    par = RnsParams(bits)
    n0 = rnd.getrandbits(bits) | 1 | (1 << (bits - 1))
    while math.gcd(n0, par.MA * par.MB) != 1:
        n0 = rnd.getrandbits(bits) | 1 | (1 << (bits - 1))
    ns = np.asarray([n0] * B, dtype=object)
    b = np.asarray([rnd.getrandbits(bits) % n0 for _ in range(B)], dtype=object)
    e = np.asarray([rnd.getrandbits(bits) for _ in range(B)], dtype=object)
    rows = RnsCtx.from_ints(ns, bits, cpu).rows
    k1 = (torch.as_tensor(batch_to_limbs(b, par.Lin)),
          torch.as_tensor(pr._pack_words(batch_to_limbs(e, bits // 16))), rows[:1], bits, True)

    kb, G, S = 768, 3, 8
    kns = np.asarray([[rnd.getrandbits(kb) | 1 | (1 << (kb - 1)) for _ in range(G)]],
                     dtype=object)
    h = np.asarray([[[rnd.getrandbits(kb) % int(n) for n in kns[0]]] for _ in range(2)],
                   dtype=object)
    e1 = np.asarray([[rnd.getrandbits(64) for _ in range(G)] for _ in range(S)], dtype=object)
    e2 = np.asarray([[rnd.getrandbits(256) for _ in range(G)] for _ in range(S)], dtype=object)
    mc = ModCtx.from_ints(kns, kb, cpu)
    cap = {}
    real = pr.fixed_call
    pr.fixed_call = lambda *a: cap.setdefault("a", a) and real(*a)
    try:
        mc.pow_fixed_prod_rns(mc.make_tables_rns(h, 256), [e1, e2], (64, 256))
    finally:
        pr.fixed_call = real
    k2 = cap["a"]

    ks = ec.sc_from_ints(np.asarray([rnd.randrange(hec.N) for _ in range(256)], dtype=object),
                         cpu)
    tab, planes = pe._comb8_for(hec.G, cpu)
    k4 = (pe._comb_digits(ks), tab, planes)

    def on_card(v):
        if isinstance(v, (list, tuple)):
            return type(v)(on_card(u) for u in v)
        return v.to(dev) if isinstance(v, torch.Tensor) else v

    cases = {"K1": (pr.exp_call, k1, [rows]), "K2": (pr.fixed_call, k2, k2[3]),
             "K4": (pe.comb_call, k4, [tab, planes])}
    for k, (fn, args, shared) in cases.items():
        want = fn(*on_card(args)).cpu()
        for entries, kernel_pieces in (([dev, dev], 2), ([dev, "cpu"], 1)):
            mesh = sharding.sessions_mesh(devices=entries)
            for _ in range(2):
                before = kernels.LAUNCHES[k]
                with sharding.use_mesh(mesh):
                    got = fn(*args)
                assert kernels.LAUNCHES[k] == before + kernel_pieces, (k, entries)
                assert got.device == cpu and torch.equal(got, want), (k, entries)
                bases = {id(t if t._base is None else t._base) for t in shared}
                assert len([key for key in shm._REPLICAS if key[0] in bases]) == len(bases)
                assert all((i, dev) in shm._REPLICAS for i in bases), k
