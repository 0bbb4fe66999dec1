"""The port's batched ECDSA verifiers on the CPU: ecdsa_verify_batch
(OpenSSL's libcrypto through ctypes, host/ec.py) and its plain python
version ecdsa_verify_batch_plain, each held case for case against the
reference's OpenSSL verifier (tpu_mpc.host.ec.ecdsa_verify_batch and
ecdsa_verify_openssl, through `cryptography`, run live) and against the
port's single-signature oracle ecdsa_verify: honest signatures over three
keys, tampered ones (r = 0, a negative r, r + N, s = N, a high s), keys that
are None, off the curve, negative, or coordinate aliases mod p; the port's
ecdsa_verify_openssl against the reference's; then _finish_signatures, the
signature finish of the port's batched GG20, GG18 and Lindell'17 signing,
on a batch whose y holds a key off the curve."""

import numpy as np
import pytest

N_SIGS = 24
# a key off the curve and a signature the affine formulas accept for it
OFF_CURVE = (5, 123456789)
OFF_T = 0x1234567


@pytest.fixture(scope="module")
def cases():
    """[(label, pubkey, m, r, s)]: 24 honest signatures made from a numpy
    seed over 3 keys, then the tampered and bad-key cases."""
    from tpu_mpc_torch.host import ec as hec

    N, P = hec.N, hec.P
    rs = np.random.default_rng(0x5EC)
    draw = lambda: int.from_bytes(rs.bytes(32), "big") % (N - 1) + 1
    privs = [draw() for _ in range(3)]
    keys = [hec.mul(d) for d in privs]
    out = []
    for i in range(N_SIGS):
        k, m = i % 3, int.from_bytes(rs.bytes(32), "big")
        r, s = hec.ecdsa_sign(privs[k], m, draw())
        out.append((f"honest {i}", keys[k], m, r, s))
    _, Y, m, r, s = out[0]
    x, y = Y
    out += [
        ("s + 1", Y, m, r, s + 1), ("r = 0", Y, m, 0, s), ("s = N", Y, m, r, N),
        ("m + 1", Y, m + 1, r, s), ("m + N", Y, m + N, r, s), ("high s", Y, m, r, N - s),
        ("None key", None, m, r, s), ("(x + P, y)", (x + P, y), m, r, s),
        ("(x, y + P)", (x, y + P), m, r, s), ("(x, y + 1)", (x, y + 1), m, r, s),
        ("-r", Y, m, -r, s), ("r + N", Y, m, r + N, s), ("(-x, y)", (-x, y), m, r, s),
        ("(x + 5P, y)", (x + 5 * P, y), m, r, s),
    ]
    T = hec.mul(OFF_T, OFF_CURVE)
    r_off = T[0] % N
    out.append(("off curve", OFF_CURVE, 0, r_off, r_off * pow(OFF_T, -1, N) % N))
    return out


VERIFIERS = ("ecdsa_verify_batch", "ecdsa_verify_batch_plain")


@pytest.mark.parametrize("verifier", VERIFIERS)
def test_batch_verifier_gives_openssl_answers(cases, verifier):
    from tpu_mpc.host import ec as ref
    from tpu_mpc_torch.host import ec as hec

    _, pubs, ms, rs, ss = zip(*cases)
    got = getattr(hec, verifier)(pubs, ms, rs, ss)
    assert got == ref.ecdsa_verify_batch(pubs, ms, rs, ss)
    assert got == [pub is not None and ref.ecdsa_verify_openssl(pub, m, r, s)
                   for _, pub, m, r, s in cases]
    want = {"s + 1": False, "r = 0": False, "s = N": False, "m + 1": False, "m + N": True,
            "high s": True, "None key": False, "(x + P, y)": True, "(x, y + P)": True,
            "(x, y + 1)": False, "-r": False, "r + N": False, "(-x, y)": False,
            "(x + 5P, y)": True, "off curve": False}
    by_label = dict(zip((c[0] for c in cases), got))
    assert all(by_label[f"honest {i}"] for i in range(N_SIGS))
    assert {k: by_label[k] for k in want} == want


@pytest.mark.parametrize("verifier", VERIFIERS)
def test_batch_verifier_agrees_with_ecdsa_verify_on_the_curve(cases, verifier):
    """ecdsa_verify never uses b = 7: it accepts the off-curve signature,
    which OpenSSL and the batch verifiers reject; on every other case the
    verifiers agree."""
    from tpu_mpc_torch.host import ec as hec

    for label, pub, m, r, s in cases:
        batch = getattr(hec, verifier)([pub], [m], [r], [s])[0]
        if label == "off curve":
            assert hec.ecdsa_verify(pub, m, r, s) and not batch
        elif pub is not None and label != "(x, y + 1)":
            assert batch == hec.ecdsa_verify(pub, m % hec.N, r, s), label


def test_ecdsa_verify_openssl_equals_reference(cases):
    """The single-signature OpenSSL check, case for case against the
    reference's (which raises on a None key: the port's says False)."""
    from tpu_mpc.host import ec as ref
    from tpu_mpc_torch.host import ec as hec

    for label, pub, m, r, s in cases:
        want = pub is not None and ref.ecdsa_verify_openssl(pub, m, r, s)
        assert hec.ecdsa_verify_openssl(pub, m, r, s) == want, label


def test_finish_signatures_rejects_an_off_curve_key(cases):
    """Three sessions, the middle one signed under the off-curve key: only
    it fails sig_valid, and s comes back low with its recovery id."""
    from tpu_mpc_torch.ec import secp256k1 as dec
    from tpu_mpc_torch.host import ec as hec
    from tpu_mpc_torch.protocols.gg18.batch import _finish_signatures

    N = hec.N
    rnd = np.random.default_rng(0xF1)
    sess, Rs = [], []
    for label in ("honest", "off curve", "honest"):
        d, k = (int.from_bytes(rnd.bytes(32), "big") % (N - 1) + 1 for _ in range(2))
        m = int.from_bytes(rnd.bytes(32), "big")
        if label == "honest":
            y, R = hec.mul(d), hec.mul(k)
            r = R[0] % N
            s = pow(k, -1, N) * (m + r * d) % N
        else:
            y, R, m = OFF_CURVE, hec.mul(OFF_T, OFF_CURVE), 0
            r = R[0] % N
            s = r * pow(OFF_T, -1, N) % N
        sess.append((y, m, r, s))
        Rs.append(R)
    ys, ms, r_x, s_sum = zip(*sess)
    obj = lambda v: np.asarray(v, dtype=object)
    ms, r_x, s_sum = obj(ms), obj(r_x), obj(s_sum)
    s_fin, recid, valid = _finish_signatures(
        dec.points_from_host(Rs, device="cpu"), s_sum, r_x,
        dec.points_from_host(list(ys), device="cpu"), ms)
    assert valid.tolist() == [True, False, True]
    assert hec.ecdsa_verify(OFF_CURVE, 0, int(r_x[1]), int(s_fin[1]))
    for b in range(3):
        assert int(s_fin[b]) == min(int(s_sum[b]), N - int(s_sum[b]))
        assert int(recid[b]) == (Rs[b][1] % N & 1) ^ (int(s_sum[b]) > N // 2)
