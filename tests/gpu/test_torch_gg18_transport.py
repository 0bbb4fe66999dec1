"""The port's GG18 transport on the CPU: its pure-python AES-256-GCM held
byte for byte against the cryptography package's AESGCM, envelopes that
cross-decrypt with the JAX package's gg18_common, and the GG18 keygen and
sign clients over the port's KV relay at 768-bit Paillier, in threads.
Signup order and AES nonces are not deterministic, so the clients are held
by the protocol's invariants: one y, the sum of the y_i; any two x shares
reconstruct sum u; both signers' (r, s) equal, valid under y, low s."""

import hashlib
import threading

import numpy as np
import pytest

from tpu_mpc_torch.host import ec as hec
from tpu_mpc_torch.runtime import gg18_common as g
from tpu_mpc_torch.runtime import kv_server
from tpu_mpc_torch.runtime.gg18_keygen_client import keygen_run
from tpu_mpc_torch.runtime.gg18_sign_client import sign_run
from tpu_mpc_torch.utils.rng import SessionRng
from tpu_mpc_torch.vss import feldman

BITS = 768
DEV = "cpu"
LENGTHS = list(range(101)) + [1024]


def _flip(b: bytes, bit: int) -> bytes:
    out = bytearray(b)
    out[bit // 8] ^= 1 << (bit % 8)
    return bytes(out)


def test_aes_gcm_equals_cryptography():
    from cryptography.hazmat.primitives.ciphers.aead import AESGCM

    rng = np.random.default_rng(0xAE5)
    for n in LENGTHS:
        key, nonce, pt = rng.bytes(32), rng.bytes(12), rng.bytes(n)
        want = AESGCM(key).encrypt(nonce, pt, None)
        got = g.aes_gcm_encrypt(key, nonce, pt)
        assert got == want, n
        assert g.aes_gcm_decrypt(key, nonce, want) == pt
        # a flipped tag bit, and a flipped ciphertext bit, must not decrypt
        with pytest.raises(g.InvalidTag):
            g.aes_gcm_decrypt(key, nonce, _flip(want, 8 * len(want) - 1 - int(rng.integers(128))))
        if n:
            with pytest.raises(g.InvalidTag):
                g.aes_gcm_decrypt(key, nonce, _flip(want, int(rng.integers(8 * n))))
        with pytest.raises(g.InvalidTag):
            g.aes_gcm_decrypt(_flip(key, 0), nonce, want)


def test_envelopes_cross_decrypt_with_reference_and_ecdh_agrees():
    from tpu_mpc.runtime import gg18_common as jg

    k1, k2 = 123456789, 987654321
    y1, y2 = hec.mul(k1), hec.mul(k2)
    key = g.ecdh_aes_key(k1, y2)
    assert key == g.ecdh_aes_key(k2, y1) == jg.ecdh_aes_key(k1, y2)
    share = (hec.N - 12345).to_bytes(32, "big")
    mine, theirs = g.aes_encrypt(key, share), jg.aes_encrypt(key, share)
    assert sorted(mine) == sorted(theirs) == ["ciphertext", "nonce"]
    assert len(bytes.fromhex(mine["nonce"])) == 12 and len(bytes.fromhex(mine["ciphertext"])) == 48
    assert jg.aes_decrypt(key, mine) == share
    assert g.aes_decrypt(key, theirs) == share
    with pytest.raises(g.InvalidTag):
        g.aes_decrypt(g.ecdh_aes_key(k1, y1), theirs)       # wrong key


@pytest.fixture(scope="module")
def gg18_keys():
    server = kv_server.serve(port=0, parties=3, threshold=1)
    addr = f"http://127.0.0.1:{server.server_address[1]}"
    try:
        results, errs = [None, None, None], []

        def run(slot):
            try:
                results[slot] = keygen_run(addr, 3, 1, SessionRng(500 + slot),
                                           paillier_bits=BITS, device=DEV)
            except Exception as e:  # surface thread failures
                errs.append(e)

        th = [threading.Thread(target=run, args=(i,)) for i in range(3)]
        [t.start() for t in th]
        [t.join(timeout=600) for t in th]
        assert not errs, errs
        assert all(r is not None for r in results)
        yield addr, results
    finally:
        server.shutdown()


def test_gg18_keygen_clients(gg18_keys):
    _, keys = gg18_keys
    by_party = {k["party_num"]: k for k in keys}
    assert sorted(by_party) == [1, 2, 3]
    y = keys[0]["y"]
    assert all(k["y"] == y and k["y_vec"] == keys[0]["y_vec"] for k in keys)
    acc = None
    for pt in keys[0]["y_vec"]:
        acc = pt if acc is None else hec.add(acc, pt)
    assert acc == y
    total = sum(k["u_i"] for k in keys) % hec.N
    assert hec.mul(total) == y
    for a, b in ((1, 2), (2, 3), (1, 3)):
        assert feldman.reconstruct([a - 1, b - 1], [by_party[a]["x_i"], by_party[b]["x_i"]]) \
            == total


def test_gg18_sign_clients(gg18_keys):
    addr, keys = gg18_keys
    by_party = {k["party_num"]: k for k in keys}
    digest = int.from_bytes(hashlib.sha256(b"gg18 transport message").digest(), "big")
    results, errs = [None, None], []

    def run(slot, key, seed):
        try:
            results[slot] = sign_run(addr, key, digest, SessionRng(seed), device=DEV)
        except Exception as e:
            errs.append(e)

    th = [threading.Thread(target=run, args=(0, by_party[1], 601)),
          threading.Thread(target=run, args=(1, by_party[3], 602))]
    [t.start() for t in th]
    [t.join(timeout=600) for t in th]
    assert not errs, errs
    assert results[0] == results[1]
    sig = results[0]
    assert sig["valid"] and sig["s"] <= hec.N // 2
    assert hec.ecdsa_verify(keys[0]["y"], digest % hec.N, sig["r"], sig["s"])
