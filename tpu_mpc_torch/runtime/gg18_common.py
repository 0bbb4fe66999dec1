"""GG18 client transport helpers — broadcast / sendp2p / poll + AES-GCM
(port of tpu_mpc/runtime/gg18_common.py).

Behavioral equivalent of the reference's examples/common.rs:53-190:
  * broadcast(party, round, data)      key = "{party}-{round}-{uuid}"
  * sendp2p(from, to, round, data)     key = "{from}-{to}-{round}-{uuid}"
  * poll_for_broadcasts / poll_for_p2p spin on /get until all peers posted
  * aes_encrypt / aes_decrypt          AES-256-GCM for P2P VSS shares under
    pairwise ECDH-derived keys (common.rs:53-79); unlike the reference we
    carry a random 96-bit nonce in the envelope instead of a fixed one.

AES-256 (FIPS-197) and GCM (NIST SP 800-38D: a 96-bit nonce, a 128-bit tag,
no additional data) are written out here in plain python, so the port needs
no cryptography package; the envelope is the JAX package's,
{"nonce": hex, "ciphertext": hex(ct || tag)}, and the two cross-decrypt.
Speed does not matter: one envelope holds one 32-byte share.  The cipher
runs table lookups indexed by key and data bytes, so it is not hardened
against cache-timing observers on the same host; the tag compare is
constant-time (utils/ct.ct_eq_bytes).

Payloads are JSON strings produced with wire.encode_value (ints as hex,
points as SEC1-compressed hex), stored as KV values on the GG18 relay
(kv_server.py).
"""

from __future__ import annotations

import json
import os
import time
import urllib.request

from ..utils.ct import ct_eq_bytes
from .wire import decode_value, encode_value


class KvClient:
    def __init__(self, address: str):
        self.base = address.rstrip("/")

    def _post(self, path: str, body: dict) -> dict:
        req = urllib.request.Request(
            self.base + "/" + path,
            data=json.dumps(body).encode(),
            method="POST",
            headers={"Content-Type": "application/json"},
        )
        with urllib.request.urlopen(req, timeout=60) as resp:
            return json.loads(resp.read())

    def signup_keygen(self) -> tuple[int, str]:
        out = self._post("signupkeygen", {})["Ok"]
        return out["number"], out["uuid"]

    def signup_sign(self) -> tuple[int, str]:
        out = self._post("signupsign", {})["Ok"]
        return out["number"], out["uuid"]

    def set(self, key: str, value: str) -> None:
        self._post("set", {"key": key, "value": value})

    def get(self, key: str):
        out = self._post("get", {"key": key})
        return out["Ok"]["value"] if out.get("Ok") else None


def broadcast(client: KvClient, party_num: int, round_name: str, data: dict,
              uuid: str) -> None:
    """common.rs:104-116 — broadcast entry under {party}-{round}-{uuid}."""
    client.set(f"{party_num}-{round_name}-{uuid}", json.dumps(encode_value(data)))


def sendp2p(client: KvClient, party_from: int, party_to: int, round_name: str,
            data: dict, uuid: str) -> None:
    """common.rs:118-132 — P2P entry under {from}-{to}-{round}-{uuid}."""
    client.set(f"{party_from}-{party_to}-{round_name}-{uuid}", json.dumps(encode_value(data)))


def poll_for_broadcasts(client: KvClient, party_num: int, n: int, round_name: str,
                        uuid: str, delay: float = 0.05, timeout: float = 600.0) -> dict:
    """common.rs:134-161 — wait for every *other* party's broadcast.
    Returns {party_j: payload} for j != party_num."""
    out = {}
    deadline = time.time() + timeout
    for j in range(1, n + 1):
        if j == party_num:
            continue
        key = f"{j}-{round_name}-{uuid}"
        while True:
            v = client.get(key)
            if v is not None:
                out[j] = decode_value(json.loads(v))
                break
            if time.time() > deadline:
                raise TimeoutError(f"poll_for_broadcasts: {key}")
            time.sleep(delay)
    return out


def poll_for_p2p(client: KvClient, party_num: int, n: int, round_name: str,
                 uuid: str, delay: float = 0.05, timeout: float = 600.0) -> dict:
    """common.rs:163-190 — wait for every other party's P2P message to us."""
    out = {}
    deadline = time.time() + timeout
    for j in range(1, n + 1):
        if j == party_num:
            continue
        key = f"{j}-{party_num}-{round_name}-{uuid}"
        while True:
            v = client.get(key)
            if v is not None:
                out[j] = decode_value(json.loads(v))
                break
            if time.time() > deadline:
                raise TimeoutError(f"poll_for_p2p: {key}")
            time.sleep(delay)
    return out


def ecdh_aes_key(scalar: int, peer_point) -> bytes:
    """Pairwise AES key = x-coordinate of scalar * peer_y
    (gg18_keygen_client.rs:114-123 uses the same DH construction)."""
    from ..host import ec as hec

    shared = hec.mul(scalar % hec.N, peer_point)
    return (shared[0] % (1 << 256)).to_bytes(32, "big")


# ---- AES-256 (FIPS-197) ---------------------------------------------------

def _xtime(a: int) -> int:
    a <<= 1
    return (a ^ 0x11B) if a & 0x100 else a


def _make_sbox() -> list:
    """S-box from its definition: the inverse in GF(2^8) (0 -> 0), then
    the affine map b ^ rot1(b) ^ rot2(b) ^ rot3(b) ^ rot4(b) ^ 0x63."""
    exp, log = [0] * 255, [0] * 256
    x = 1
    for i in range(255):                # 3 generates GF(2^8)*
        exp[i], log[x] = x, i
        x ^= _xtime(x)
    box = []
    for a in range(256):
        b = exp[(255 - log[a]) % 255] if a else 0
        s = b
        for _ in range(4):
            b = ((b << 1) | (b >> 7)) & 0xFF
            s ^= b
        box.append(s ^ 0x63)
    return box


_SBOX = _make_sbox()
_X2 = [_xtime(a) for a in range(256)]
_RCON = (0x01, 0x02, 0x04, 0x08, 0x10, 0x20, 0x40)
_NR = 14                                # AES-256 rounds


def _expand_key(key: bytes) -> list:
    """FIPS-197 5.2 for Nk = 8: 15 round keys of 16 bytes."""
    if len(key) != 32:
        raise ValueError("AES-256 needs a 32-byte key")
    w = [list(key[4 * i:4 * i + 4]) for i in range(8)]
    for i in range(8, 4 * (_NR + 1)):
        t = list(w[i - 1])
        if i % 8 == 0:
            t = [_SBOX[b] for b in t[1:] + t[:1]]
            t[0] ^= _RCON[i // 8 - 1]
        elif i % 8 == 4:
            t = [_SBOX[b] for b in t]
        w.append([a ^ b for a, b in zip(w[i - 8], t)])
    return [sum(w[4 * r:4 * r + 4], []) for r in range(_NR + 1)]


def _encrypt_block(rk: list, block: bytes) -> bytes:
    """One 16-byte block; the state is column-major, s[r + 4 c]."""
    s = [a ^ b for a, b in zip(block, rk[0])]
    for rnd in range(1, _NR + 1):
        s = [_SBOX[b] for b in s]
        s = [s[(r + 4 * (c + r)) % 16] for c in range(4) for r in range(4)]   # ShiftRows
        if rnd != _NR:                                                      # MixColumns
            m = []
            for c in range(0, 16, 4):
                a0, a1, a2, a3 = s[c:c + 4]
                t = a0 ^ a1 ^ a2 ^ a3
                m += [a0 ^ t ^ _X2[a0 ^ a1], a1 ^ t ^ _X2[a1 ^ a2],
                      a2 ^ t ^ _X2[a2 ^ a3], a3 ^ t ^ _X2[a3 ^ a0]]
            s = m
        s = [a ^ b for a, b in zip(s, rk[rnd])]
    return bytes(s)


# ---- GCM (SP 800-38D), 96-bit nonce, 128-bit tag, no AAD ------------------

_GCM_R = 0xE1 << 120


def _gf_mult(x: int, y: int) -> int:
    """The GHASH product in GF(2^128), bits numbered from the left
    (SP 800-38D algorithm 1)."""
    z, v = 0, y
    for i in range(127, -1, -1):
        if (x >> i) & 1:
            z ^= v
        v = (v >> 1) ^ _GCM_R if v & 1 else v >> 1
    return z


def _ghash(h: int, data: bytes) -> int:
    y = 0
    for i in range(0, len(data), 16):
        y = _gf_mult(y ^ int.from_bytes(data[i:i + 16], "big"), h)
    return y


def _gctr(rk: list, icb: bytes, data: bytes) -> bytes:
    """Counter mode from icb, the counter in the low 32 bits (inc32)."""
    out = bytearray()
    ctr = int.from_bytes(icb[12:], "big")
    for i in range(0, len(data), 16):
        ks = _encrypt_block(rk, icb[:12] + ctr.to_bytes(4, "big"))
        out += bytes(a ^ b for a, b in zip(data[i:i + 16], ks))
        ctr = (ctr + 1) & 0xFFFFFFFF
    return bytes(out)


def _gcm_tag(rk: list, j0: bytes, ct: bytes) -> bytes:
    h = int.from_bytes(_encrypt_block(rk, bytes(16)), "big")
    pad = (-len(ct)) % 16
    lens = (0).to_bytes(8, "big") + (8 * len(ct)).to_bytes(8, "big")
    s = _ghash(h, ct + bytes(pad) + lens)
    return (s ^ int.from_bytes(_encrypt_block(rk, j0), "big")).to_bytes(16, "big")


class InvalidTag(ValueError):
    """The envelope's tag does not authenticate its ciphertext under the key."""


def aes_gcm_encrypt(key: bytes, nonce: bytes, plaintext: bytes) -> bytes:
    """AES-256-GCM -> ciphertext || 16-byte tag."""
    if len(nonce) != 12:
        raise ValueError("AES-GCM here takes a 96-bit nonce")
    rk = _expand_key(key)
    j0 = nonce + b"\x00\x00\x00\x01"
    ct = _gctr(rk, nonce + b"\x00\x00\x00\x02", plaintext)
    return ct + _gcm_tag(rk, j0, ct)


def aes_gcm_decrypt(key: bytes, nonce: bytes, data: bytes) -> bytes:
    """Inverse of aes_gcm_encrypt; raises InvalidTag on a bad tag."""
    if len(nonce) != 12:
        raise ValueError("AES-GCM here takes a 96-bit nonce")
    if len(data) < 16:
        raise InvalidTag("AES-GCM ciphertext shorter than its tag")
    rk = _expand_key(key)
    ct, tag = data[:-16], data[-16:]
    if not ct_eq_bytes(_gcm_tag(rk, nonce + b"\x00\x00\x00\x01", ct), tag):
        raise InvalidTag("AES-GCM tag mismatch")
    return _gctr(rk, nonce + b"\x00\x00\x00\x02", ct)


def aes_encrypt(key: bytes, plaintext: bytes) -> dict:
    """AES-256-GCM; envelope carries nonce + ciphertext||tag (common.rs:53-66)."""
    nonce = os.urandom(12)
    return {"nonce": nonce.hex(), "ciphertext": aes_gcm_encrypt(key, nonce, plaintext).hex()}


def aes_decrypt(key: bytes, env: dict) -> bytes:
    return aes_gcm_decrypt(key, bytes.fromhex(env["nonce"]), bytes.fromhex(env["ciphertext"]))
