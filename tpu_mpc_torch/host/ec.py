"""Pure-python secp256k1 — golden oracle and host-side EC (port of tpu_mpc/host/ec.py).

The OpenSSL-backed batch verifier of the reference is not carried over:
the port verifies signatures with the pure-python `ecdsa_verify` below.

Mirrors the behavior of curv's secp256k1 `Point`/`Scalar` (used throughout
ZenGo-X/multi-party-ecdsa, e.g. src/protocols/multi_party_ecdsa/gg_2020/party_i.rs:627-633).
Affine coordinates; None represents the point at infinity.
"""

from __future__ import annotations

import hashlib
from typing import Optional, Tuple

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


def ecdsa_sign(priv: int, msg_hash: int, k: int) -> Tuple[int, int]:
    """Plain (non-threshold) ECDSA with explicit nonce — test vectors only."""
    R = mul(k, G)
    r = R[0] % N
    s = pow(k, -1, N) * (msg_hash + r * priv) % N
    if s > N // 2:
        s = N - s
    return r, s
