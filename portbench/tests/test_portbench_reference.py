"""The reference ECDSA accepts good signatures and rejects a changed s, a
changed r, a wrong recid and a wrong key; its arithmetic agrees with
OpenSSL (through `cryptography`) and with the curve's known points."""

import random

import pytest

from portbench.reference import judge, secp256k1 as ec

TWO_G = (0xC6047F9441ED7D6D3045406E95C07CD85C778E4B8CEF3CA7ABAC09B95C709EE5,
         0x1AE168FEA63DC339A3C58419466CEAEEF7F632653266D0E1236431A950CFE52A)


def test_points():
    comb = ec.g_comb()
    assert ec.on_curve(ec.G) and ec.mul(2) == TWO_G == comb.mul(2)
    assert comb.mul(ec.N - 1) == (ec.G[0], ec.P - ec.G[1]) and comb.mul(ec.N) is None
    rnd = random.Random(5)
    for _ in range(20):
        k = rnd.randrange(1, ec.N)
        assert comb.mul(k) == ec.mul(k)
        Q = ec.mul(rnd.randrange(1, ec.N))
        assert ec.FixedBase(Q).mul(k) == ec.mul(k, Q)


def test_accepts_good_and_rejects_changed_signatures():
    rnd = random.Random(7)
    d = rnd.randrange(1, ec.N)
    ver = ec.Verifier(ec.mul(d))
    other = ec.Verifier(ec.mul(d + 1))
    for _ in range(30):
        z = rnd.getrandbits(256)
        r, s, rec = ec.sign(d, z % ec.N, rnd.randrange(1, ec.N))
        assert s <= ec.HALF_N and ver.check(z, r, s, rec)
        assert not ver.check(z, r, (s + 1) % ec.N, rec)
        assert not ver.check(z, (r + 1) % ec.N, s, rec)
        assert not ver.check(z, r, s, rec ^ 1)
        assert not ver.check(z ^ 1, r, s, rec)
        assert not other.check(z, r, s, rec)
        assert not ver.check(z, 0, s, rec) and not ver.check(z, r, ec.N, rec)
    assert not ec.Verifier((ec.G[0], ec.G[1] + 1)).check(1, 1, 1, 0)


def test_agrees_with_openssl():
    pytest.importorskip("cryptography")
    from cryptography.exceptions import InvalidSignature
    from cryptography.hazmat.primitives.asymmetric import ec as cec
    from cryptography.hazmat.primitives.asymmetric.utils import Prehashed, encode_dss_signature
    from cryptography.hazmat.primitives import hashes

    rnd = random.Random(9)
    d = rnd.randrange(1, ec.N)
    pub = cec.derive_private_key(d, cec.SECP256K1()).public_key()
    assert (pub.public_numbers().x, pub.public_numbers().y) == ec.mul(d)
    ver = ec.Verifier(ec.mul(d))
    for i in range(20):
        z = rnd.getrandbits(256)
        r, s, rec = ec.sign(d, z % ec.N, rnd.randrange(1, ec.N), low_s=bool(i % 2))
        if i % 3 == 0:
            s = (s + 1) % ec.N
        try:
            pub.verify(encode_dss_signature(r, s), z.to_bytes(32, "big"),
                       cec.ECDSA(Prehashed(hashes.SHA256())))
            ossl = True
        except InvalidSignature:
            ossl = False
        R = ver.recover_point(z % ec.N, r, s)
        assert ossl == (R is not None and R[0] % ec.N == r)


def test_judge_counts():
    rnd = random.Random(3)
    mat = {"u": [[rnd.randrange(1, ec.N) for _ in range(3)]]}
    d = judge.secret_key(mat)
    y = judge.public_key(mat)
    m = [rnd.getrandbits(256) for _ in range(4)]
    sigs = [ec.sign(d, z % ec.N, rnd.randrange(1, ec.N)) for z in m]
    good = {"m": m, "r": [v[0] for v in sigs], "s": [v[1] for v in sigs],
            "recid": [v[2] for v in sigs], "ok": [True] * 4, "sig_valid": [True] * 4}
    checks = judge.judge(mat, y, [good], 4)
    assert judge.passed(checks) and set(checks) == set(judge.LIMITS)
    assert judge.judge(mat, ec.mul(d + 1), [good], 4)["key_wrong"] == 1
    assert judge.judge(mat, y, [good, good], 4)["r_repeats"] == 4
    bad = dict(good, s=[ec.N - s for s in good["s"]], sig_valid=[True, False, True, True])
    c = judge.judge(mat, y, [bad], 4)
    assert c["high_s"] == 4 and c["sig_bad"] == 4 and c["mask_wrong"] == 4
    assert judge.judge(mat, y, [dict(good, r=good["r"][:3])], 4)["missing"] == 1
