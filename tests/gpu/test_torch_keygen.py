"""GG20 keygen of the port on the CPU, held against the reference package.

The reference's keygen takes its primes from its native helper
(tpu_mpc/native/primegen.cpp); the port draws the same primes with its own
copy of it (tpu_mpc_torch/native/primegen.cpp), whose plain python version
(tpu_mpc_torch/host/primes.py) is held here against the reference's
helper.  With the same draws from SessionRng, the
port's keygen reproduces the reference's committed 768-bit keys
(tests/fixtures/gg20key_*.json) field for field, with no JAX run.  Every
case here takes seconds: none runs the reference's keygen or
offline_stage."""

import json
import os
import random

import numpy as np
import pytest

HERE = os.path.dirname(os.path.abspath(__file__))
FIXTURES = os.path.join(HERE, "..", "fixtures")
BITS = 768


def _ints(v):
    return np.vectorize(int, otypes=[object])(np.asarray(v, dtype=object))


def _tuplify(v):
    if v is None:
        return None
    if isinstance(v, list) and len(v) == 2 and isinstance(v[0], str):
        return (int(v[0]), int(v[1]))
    return [_tuplify(e) for e in v]


@pytest.fixture(scope="module")
def kg20():
    """keygen(2, 1, 3) under SessionRng(0x20), the seed of the committed
    gg20key_20_2_1_3_768.json, on the CPU."""
    from tpu_mpc_torch.protocols.gg20 import batch as tg
    from tpu_mpc_torch.utils.rng import SessionRng

    rng = SessionRng(0x20)
    return tg.keygen(2, 1, 3, rng, BITS, device="cpu"), rng


@pytest.mark.parametrize("bits,seeds", [(384, (1, 2, 3, 12345)), (1024, (1, 12345))])
def test_prime_draw_equals_native_helper(bits, seeds):
    from tpu_mpc.native import primegen
    from tpu_mpc_torch.host import primes

    for seed in seeds:
        assert primes._helper_gen_prime(bits, seed) == primegen.gen_prime(bits, seed)
    rng_a, rng_b = random.Random(bits), random.Random(bits)
    want = [primegen.gen_prime(bits, rng_b.getrandbits(64)) for _ in range(3)]
    assert primes.gen_primes_parallel(bits, 3, rng_a, workers=2) == want


def test_safe_prime_draw_equals_native_helper():
    from tpu_mpc.native import primegen
    from tpu_mpc_torch.host import primes

    for seed in (1, 2, 7):
        p = primes._helper_gen_safe_prime(256, seed)
        assert p == primegen.gen_safe_prime(256, seed)
        assert p.bit_length() == 256 and primes.is_probable_prime((p - 1) // 2)
    rng_a, rng_b = random.Random(3), random.Random(3)
    assert primes.gen_safe_primes_parallel(256, 2, rng_a, workers=1) == \
        [primegen.gen_safe_prime(256, rng_b.getrandbits(64)) for _ in range(2)]


def test_python_fallback_equals_reference_where_the_helper_refuses():
    """Widths the helper refuses (not a multiple of 64) take the reference's
    python search, after the same seed draw."""
    from tpu_mpc.host import primes as rp
    from tpu_mpc_torch.host import primes as tp

    for bits in (200, 130):
        assert tp.gen_prime(bits, random.Random(5)) == rp.gen_prime(bits, random.Random(5))
        assert tp.gen_primes_parallel(bits, 3, random.Random(6), workers=2) == \
            rp.gen_primes_parallel(bits, 3, random.Random(6))
    assert tp.gen_safe_prime(130, random.Random(9)) == rp.gen_safe_prime(130, random.Random(9))
    for n in (2, 97, 7919, 10007 * 10009, (1 << 127) - 1):
        assert tp.is_probable_prime(n, rng=random.Random(1)) == \
            rp.is_probable_prime(n, rng=random.Random(1))


@pytest.mark.parametrize("fixture", ["gg20key_20_2_1_3_768.json", "gg20key_51_1_1_2_768.json",
                                     "gg20key_52_1_2_5_768.json"])
def test_keygen_reproduces_reference_key(fixture, kg20):
    """keygen under the fixture's seed gives the reference's key, every field
    (t = 2, n = 5 runs Feldman at degree 2), and every check passes."""
    from tpu_mpc_torch.ec import secp256k1 as tec
    from tpu_mpc_torch.protocols.gg20 import batch as tg
    from tpu_mpc_torch.utils.rng import SessionRng

    with open(os.path.join(FIXTURES, fixture)) as f:
        d = json.load(f)
    S, t, n, bits, seed = (int(d[k]) for k in ("S", "t", "n", "bits", "seed"))
    if seed == 0x20:
        res = kg20[0]
    else:
        res = tg.keygen(S, t, n, SessionRng(seed), bits, device="cpu")
    assert res.ok.all() and not res.bad_actors.any()
    k = res.key
    assert (k.S, k.t, k.n, k.paillier_bits) == (S, t, n, bits)
    got = {"p": k.p, "q": k.q, "nt": k.dlog_stmt.ctx.n_ints, "h1": k.dlog_stmt.h1,
           "h2": k.dlog_stmt.h2, "u": k.u, "x": k.x}
    for name, v in got.items():
        assert np.array_equal(_ints(v), _ints(d[name])), name
    assert tec.points_to_host_list(k.y_i) == _tuplify(d["y_i"])
    assert tec.points_to_host_list(k.vss.commitments) == _tuplify(d["vss"])
    assert np.array_equal(_ints(k.ek.n), _ints(d["p"]) * _ints(d["q"]))


def test_paillier_proofs_verify_and_reject_tampering(kg20):
    """Correct-key and composite-dlog proofs of the keygen's keys verify; a
    tampered or out-of-range sigma and a wrong or oversized y fail without
    raising.  The challenges equal the reference's, sigma equals python
    pow."""
    from tpu_mpc.zk import paillier_zk as jz
    from tpu_mpc_torch.protocols.gg20 import batch as tg
    from tpu_mpc_torch.utils.rng import SessionRng
    from tpu_mpc_torch.zk import paillier_zk as tz

    key = kg20[0].key
    n_ctx = key.ek.n_ctx
    phi = (key.p - 1) * (key.q - 1)
    for n in n_ctx.n_ints.reshape(-1)[:2]:
        assert tz.correct_key_challenges(int(n)) == jz.correct_key_challenges(int(n))
    assert tz.ALPHA_PRIMORIAL == jz.ALPHA_PRIMORIAL
    proof = tz.correct_key_prove(n_ctx, phi)
    assert proof.sigma.shape == (2, 3, tz.CORRECT_KEY_K)
    n0, ph0 = int(n_ctx.n_ints[0, 0]), int(phi[0, 0])
    rho = tz.correct_key_challenges(n0)
    assert [int(v) for v in proof.sigma[0, 0]] == \
        [pow(r, pow(n0, -1, ph0), n0) for r in rho]
    assert tz.correct_key_verify(proof, n_ctx).all()
    bad = proof.sigma.copy()
    bad[0, 1, 3] = (int(bad[0, 1, 3]) + 1) % int(n_ctx.n_ints[0, 1])
    bad[1, 2, 0] = int(n_ctx.n_ints[1, 2])            # sigma >= N
    ok = tz.correct_key_verify(tz.CorrectKeyProofBatch(sigma=bad), n_ctx)
    assert ok.tolist() == [[True, False, True], [True, True, False]]

    rng = SessionRng(0xCD)
    ctx, h1, h2, xhi, xhi_inv, _ = tg.generate_h1_h2_n_tilde_batch(1, 2, BITS, rng, "cpu")
    for g, ni, w in ((h1, h2, xhi), (h2, h1, xhi_inv)):
        stmt = tz.CompositeDLogStatementBatch(ctx=ctx, g=g, ni=ni)
        pr = tz.composite_dlog_prove(stmt, w, rng)
        assert tz.composite_dlog_verify(pr, stmt).all()
        y = pr.y.copy()
        y[0, 0] = int(y[0, 0]) + 1
        y[0, 1] = 1 << (tz._R_BITS + 300)                 # oversized: clamped, fails
        assert tz.composite_dlog_verify(tz.CompositeDLogProofBatch(u=pr.u, y=y),
                                        stmt).tolist() == [[False, False]]
        y[0, 1] = -1
        assert not tz.composite_dlog_verify(tz.CompositeDLogProofBatch(u=pr.u, y=y),
                                            stmt).any()


def test_small_paillier_flags_only_that_party():
    """A party presenting a half-width Paillier modulus passes its own proofs
    and is flagged by the bit-length policy alone (the reference's
    tests/test_gg20_adversarial.py:98-107, same seed)."""
    from tpu_mpc_torch.protocols.gg20 import batch as tg
    from tpu_mpc_torch.utils.rng import SessionRng

    res = tg.keygen(1, 1, 2, SessionRng(0x54), BITS, corrupt={"small_paillier": [1]},
                    device="cpu")
    assert not res.ok.any()
    assert res.bad_actors[:, 1].all()
    assert not res.bad_actors[:, 0].any()
    assert int(res.key.ek.n[0, 1]).bit_length() <= BITS // 2


def test_refresh_keeps_y_and_update_moves_shares(kg20):
    """refresh with zero-sum factors keeps y and draws fresh Paillier and
    ring-Pedersen setups; update moves u and x; a quorum still signs after
    refresh + a VSS-dealt x update."""
    from tpu_mpc_torch.ec import secp256k1 as tec
    from tpu_mpc_torch.host import ec as hec
    from tpu_mpc_torch.protocols.gg20 import batch as tg
    from tpu_mpc_torch.utils.rng import SessionRng
    from tpu_mpc_torch.vss import feldman

    key = kg20[0].key
    S, n, Q = key.S, key.n, hec.N
    rng = SessionRng(0xF5)
    f = np.asarray(rng.scalars((S, n)), dtype=object)
    f[:, n - 1] = np.vectorize(lambda tot: (-int(tot)) % Q, otypes=[object])(
        np.sum(f[:, : n - 1], axis=1))
    key2 = tg.refresh_private_key(key, f, rng)
    assert tec.points_to_host_list(key2.y) == tec.points_to_host_list(key.y)
    assert np.array_equal(key2.u, np.mod(key.u + f, Q))
    assert (key2.p != key.p).all() and (key2.dlog_stmt.ctx.n_ints != key.dlog_stmt.ctx.n_ints).all()
    assert np.array_equal(key2.ek.n, key2.p * key2.q)
    _, shares_f = feldman.share(key.t, n, f, rng, "cpu")
    factor_x = np.mod(np.sum(shares_f, axis=1), Q)
    fu = np.asarray(rng.scalars((S, n)), dtype=object)
    key3 = tg.update_private_key(key2, fu, factor_x)
    assert np.array_equal(key3.u, np.mod(key2.u + fu, Q))
    assert np.array_equal(key3.x, np.mod(key2.x + factor_x, Q))
    assert tec.points_to_host_list(key3.y_i) == \
        [[hec.mul(int(v)) for v in row] for row in key3.u]
    key4 = tg.update_private_key(key2, np.zeros((S, n), dtype=object), factor_x)
    off = tg.offline_stage(key4, [0, 2], rng)
    assert off.ok.all()
    sig = tg.sign_online(off, 0xD00D5EED)
    assert sig.sig_valid.all()


def test_any_two_of_three_reconstruct_sum_u(kg20):
    """The Feldman shares of the keygen: x over any 2 of 3 parties
    reconstructs sum(u), whose point is y; validate_share rejects a wrong
    share."""
    from tpu_mpc_torch.ec import secp256k1 as tec
    from tpu_mpc_torch.host import ec as hec
    from tpu_mpc_torch.utils.rng import SessionRng
    from tpu_mpc_torch.vss import feldman

    key = kg20[0].key
    y = tec.points_to_host_list(key.y)
    for s in range(key.S):
        secret = sum(int(v) for v in key.u[s]) % hec.N
        assert hec.mul(secret) == y[s]
        for quorum in ([0, 1], [0, 2], [1, 2]):
            assert feldman.reconstruct(quorum, [int(key.x[s, j]) for j in quorum]) == secret
    secrets_ = np.asarray([[11, 22, 33]], dtype=object)
    vss, shares = feldman.share(2, 4, secrets_, SessionRng(3), "cpu")
    assert shares.shape == (1, 3, 4)
    for j in range(4):
        assert feldman.validate_share(vss, shares[:, :, j], j).all()
    wrong = shares[:, :, 1].copy()
    wrong[0, 2] = (int(wrong[0, 2]) + 1) % hec.N
    assert feldman.validate_share(vss, wrong, 1).tolist() == [[True, True, False]]
    assert feldman.reconstruct([0, 2, 3], [int(shares[0, 1, j]) for j in (0, 2, 3)]) == 22
