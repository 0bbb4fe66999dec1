"""secp256k1 on the host — golden oracle and host-side EC (port of tpu_mpc/host/ec.py).

`ecdsa_verify_batch` is the batched signature check of GG20, GG18 and
Lindell'17 signing (protocols/gg18/batch.py:_finish_signatures).  As in the
reference, it runs through OpenSSL, a check independent of the repo's EC
code: the reference reaches OpenSSL through `cryptography`, which the port
does not import; the port calls libcrypto through ctypes (native.openssl),
with the same answers case for case.  `ecdsa_verify_openssl` is the
single-signature form.  `ecdsa_verify_batch_plain` (Jacobian coordinates,
Shamir's trick, window tables; standard-library python) gives the same
answers too: it is the plain version that the tests and chip_smoke.py hold
the OpenSSL verifier against.  `ecdsa_verify` stays the single-signature
oracle of the runtime and of CCLST'19, as in the reference.

Mirrors the behavior of curv's secp256k1 `Point`/`Scalar` (used throughout
ZenGo-X/multi-party-ecdsa, e.g. src/protocols/multi_party_ecdsa/gg_2020/party_i.rs:627-633).
Affine coordinates; None represents the point at infinity.
"""

from __future__ import annotations

import functools
import hashlib
from typing import Optional, Tuple

from .. import native

# secp256k1 domain parameters
P = 2**256 - 2**32 - 977
N = 0xFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFEBAAEDCE6AF48A03BBFD25E8CD0364141  # group order
GX = 0x79BE667EF9DCBBAC55A06295CE870B07029BFCDB2DCE28D959F2815B16F81798
GY = 0x483ADA7726A3C4655DA4FBFC0E1108A8FD17B448A68554199C47D08FFB10D4B8
G = (GX, GY)

Point = Optional[Tuple[int, int]]  # None = infinity


def is_on_curve(pt: Point) -> bool:
    if pt is None:
        return True
    x, y = pt
    return (y * y - x * x * x - 7) % P == 0


def add(a: Point, b: Point) -> Point:
    if a is None:
        return b
    if b is None:
        return a
    x1, y1 = a
    x2, y2 = b
    if x1 == x2:
        if (y1 + y2) % P == 0:
            return None
        lam = (3 * x1 * x1) * pow(2 * y1, -1, P) % P
    else:
        lam = (y2 - y1) * pow(x2 - x1, -1, P) % P
    x3 = (lam * lam - x1 - x2) % P
    y3 = (lam * (x1 - x3) - y1) % P
    return (x3, y3)


def neg(a: Point) -> Point:
    if a is None:
        return None
    return (a[0], (-a[1]) % P)


def mul(k: int, pt: Point = G) -> Point:
    k %= N
    result: Point = None
    addend = pt
    while k:
        if k & 1:
            result = add(result, addend)
        addend = add(addend, addend)
        k >>= 1
    return result


def lift_x(x: int, odd: bool) -> Point:
    """Recover the point with given x and y-parity; None if x not on curve."""
    y2 = (x * x * x + 7) % P
    y = pow(y2, (P + 1) // 4, P)
    if y * y % P != y2:
        return None
    if (y & 1) != odd:
        y = P - y
    return (x, y)


def compress(pt: Point) -> bytes:
    """SEC1 compressed, 33 bytes (curv's serialization of points)."""
    if pt is None:
        raise ValueError("cannot serialize the identity point")
    x, y = pt
    return bytes([2 + (y & 1)]) + x.to_bytes(32, "big")


def decompress(b: bytes) -> Point:
    if len(b) != 33 or b[0] not in (2, 3):
        raise ValueError("bad compressed point")
    pt = lift_x(int.from_bytes(b[1:], "big"), odd=(b[0] == 3))
    if pt is None:
        raise ValueError("x not on curve")
    return pt


def _derive_base_point2() -> Point:
    """Secondary NUMS generator (curv `base_point2` analog).

    Derivation: iterate h = SHA256(h) starting from SHA256(compressed G),
    interpreting each digest as an x-coordinate with even y, until on-curve.
    Nothing-up-my-sleeve: nobody knows its discrete log w.r.t. G.
    """
    h = hashlib.sha256(compress(G)).digest()
    while True:
        pt = lift_x(int.from_bytes(h, "big"), odd=False)
        if pt is not None and pt[0] < P:
            return pt
        h = hashlib.sha256(h).digest()


BASE_POINT2: Point = _derive_base_point2()


# --- ECDSA (host oracle; the device path reproduces these exactly) ---

def ecdsa_verify(pubkey: Point, msg_hash: int, r: int, s: int) -> bool:
    """Standard ECDSA verification — independent signature oracle
    (role of libsecp in the reference, gg_2020/test.rs:711-748)."""
    if not (1 <= r < N and 1 <= s < N):
        return False
    w = pow(s, -1, N)
    u1 = (msg_hash * w) % N
    u2 = (r * w) % N
    pt = add(mul(u1, G), mul(u2, pubkey))
    if pt is None:
        return False
    return pt[0] % N == r


# --- batched verification (the reference's ecdsa_verify_batch answers) ---
#
# Jacobian points (X, Y, Z) of python ints, x = X/Z^2, y = Y/Z^3; Z = 0 is
# infinity.  u1 G + u2 Y by Shamir's trick: one chain of 256 doublings, a
# 4-bit window of the key Y (table of 1..15 Y, affine, built once per
# distinct key of a batch) and an 8-bit window of G (table of 1..255 G,
# affine, built once per process).

_INF = (1, 1, 0)


def _jac_double(X: int, Y: int, Z: int):
    """2 (X, Y, Z) on y^2 = x^3 + 7 (dbl-2009-l; a point with Y = 0 or Z = 0
    goes to Z = 0, infinity)."""
    A = X * X % P
    B = Y * Y % P
    C = B * B % P
    D = 2 * ((X + B) ** 2 - A - C) % P
    E = 3 * A
    X3 = (E * E - 2 * D) % P
    return X3, (E * (D - X3) - 8 * C) % P, 2 * Y * Z % P


def _jac_add_affine(X1: int, Y1: int, Z1: int, x2: int, y2: int):
    """(X1, Y1, Z1) + (x2, y2) for an affine point that is not infinity:
    complete, doubling where the two points are equal and infinity where
    they are opposite."""
    if Z1 == 0:
        return x2, y2, 1
    Z1Z1 = Z1 * Z1 % P
    H = (x2 * Z1Z1 - X1) % P
    R = (y2 * Z1 * Z1Z1 - Y1) % P
    if H == 0:
        return _jac_double(X1, Y1, Z1) if R == 0 else _INF
    HH = H * H % P
    HHH = H * HH % P
    V = X1 * HH % P
    X3 = (R * R - HHH - 2 * V) % P
    return X3, (R * (V - X3) - Y1 * HHH) % P, Z1 * H % P


def _multiples(pt: Point, n: int) -> list:
    """[None, pt, 2 pt, ..., n pt] in affine coordinates."""
    out = [None, pt]
    for _ in range(n - 1):
        out.append(add(out[-1], pt))
    return out


@functools.lru_cache(maxsize=1)
def _g_table() -> list:
    return _multiples(G, 255)


def _key_table(pub, tables: dict):
    """The 4-bit window table of a public key, or None where OpenSSL refuses
    the key: a negative coordinate, or a point off the curve once both
    coordinates are reduced mod p (OpenSSL reduces them: (x + p, y) and
    (x, y + p) are the key (x, y))."""
    tab = tables.get(pub, False)
    if tab is False:
        x, y = int(pub[0]), int(pub[1])
        tab = None
        if x >= 0 and y >= 0 and is_on_curve((x % P, y % P)):
            tab = _multiples((x % P, y % P), 15)
        tables[pub] = tab
    return tab


def _verify_one(tab_y: list, m: int, r: int, s: int) -> bool:
    if not (1 <= r < N and 1 <= s < N):
        return False
    tab_g = _g_table()
    w = pow(s, -1, N)
    u1 = m % N * w % N
    u2 = r * w % N
    X, Y, Z = _INF
    for shift in range(248, -8, -8):
        for nib in (shift + 4, shift):
            for _ in range(4):
                X, Y, Z = _jac_double(X, Y, Z)
            d = (u2 >> nib) & 15
            if d:
                X, Y, Z = _jac_add_affine(X, Y, Z, *tab_y[d])
        b = (u1 >> shift) & 255
        if b:
            X, Y, Z = _jac_add_affine(X, Y, Z, *tab_g[b])
    if Z == 0:
        return False
    zi = pow(Z, -1, P)
    return X * zi * zi % P % N == r


def ecdsa_verify_batch_plain(pubkeys, msg_hashes, rs, ss) -> list:
    """The plain version of ecdsa_verify_batch, in python, with the answers
    of the reference's OpenSSL verifier (tpu_mpc/host/ec.py:
    ecdsa_verify_batch): False for a None key, a key OpenSSL refuses (see
    _key_table), r or s outside [1, N), or u1 G + u2 Y at infinity; the
    message is taken mod N and a high s is accepted.  One window table per
    distinct key (one signer group signing many messages pays for it
    once).  Only the tests and chip_smoke.py call it."""
    tables: dict = {}
    out = []
    for pub, m, r, s in zip(pubkeys, msg_hashes, rs, ss):
        tab = None if pub is None else _key_table(pub, tables)
        out.append(tab is not None and _verify_one(tab, int(m), int(r), int(s)))
    return out


# --- OpenSSL (the reference's ecdsa_verify_openssl / ecdsa_verify_batch) ---

def ecdsa_verify_batch(pubkeys, msg_hashes, rs, ss) -> list:
    """ECDSA verification over a batch through OpenSSL's libcrypto -> list
    of bools (tpu_mpc/host/ec.py:ecdsa_verify_batch).  False for a None
    key, a negative coordinate, a point OpenSSL refuses (off the curve once
    x and y are reduced mod p, as (x + p, y) is not), a negative r or s,
    and whatever ECDSA_do_verify does not accept on (m mod N) as 32
    big-endian bytes.  One EC_KEY per distinct key of the batch."""
    keys: dict = {}
    out = []
    with native.openssl.verifier() as v:
        for pub, m, r, s in zip(pubkeys, msg_hashes, rs, ss):
            if pub is None:  # the point at infinity is never a valid public key
                out.append(False)
                continue
            key = keys.get(pub, False)
            if key is False:
                key = keys[pub] = v.key(int(pub[0]), int(pub[1]))
            out.append(key is not None
                       and v.verify(key, (int(m) % N).to_bytes(32, "big"), int(r), int(s)))
    return out


def ecdsa_verify_openssl(pubkey: Point, msg_hash: int, r: int, s: int) -> bool:
    """One signature through OpenSSL (tpu_mpc/host/ec.py:ecdsa_verify_openssl):
    ecdsa_verify_batch of one."""
    return ecdsa_verify_batch([pubkey], [msg_hash], [r], [s])[0]


def ecdsa_sign(priv: int, msg_hash: int, k: int) -> Tuple[int, int]:
    """Plain (non-threshold) ECDSA with explicit nonce — test vectors only."""
    R = mul(k, G)
    r = R[0] % N
    s = pow(k, -1, N) * (msg_hash + r * priv) % N
    if s > N // 2:
        s = N - s
    return r, s
