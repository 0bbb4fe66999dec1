"""secp256k1 and ECDSA in plain python: the benchmark's reference.

Standard library only; nothing of the program under test is imported here,
and nothing the program made is read.  Affine points are (x, y) tuples and
None is the point at infinity; Jacobian points are (X, Y, Z) with Z = 0 at
infinity.

`FixedBase` holds a comb of 8-bit windows for one base point (32 windows x
255 multiples, affine), so that k * B is 32 mixed additions and no
doubling.  Every signature of a run is under the key set's one public key,
so `Verifier` keeps one comb for G and one for the key: a check is 64 mixed
additions and two inversions.
"""

from __future__ import annotations

P = 2**256 - 2**32 - 977
N = 0xFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFEBAAEDCE6AF48A03BBFD25E8CD0364141
G = (0x79BE667EF9DCBBAC55A06295CE870B07029BFCDB2DCE28D959F2815B16F81798,
     0x483ADA7726A3C4655DA4FBFC0E1108A8FD17B448A68554199C47D08FFB10D4B8)
HALF_N = N // 2

_INF = (1, 1, 0)


def on_curve(pt) -> bool:
    if pt is None:
        return False
    x, y = pt
    return 0 <= x < P and 0 <= y < P and (y * y - x * x * x - 7) % P == 0


def _dbl(X, Y, Z):
    if Z == 0 or Y == 0:
        return _INF
    YY = Y * Y % P
    S = 4 * X * YY % P
    M = 3 * X * X % P
    X3 = (M * M - 2 * S) % P
    return X3, (M * (S - X3) - 8 * YY * YY) % P, 2 * Y * Z % P


def _add_aff(X1, Y1, Z1, x2, y2):
    """Jacobian + affine (neither at infinity on the affine side)."""
    if Z1 == 0:
        return x2, y2, 1
    ZZ = Z1 * Z1 % P
    H = (x2 * ZZ - X1) % P
    R = (y2 * Z1 * ZZ - Y1) % P
    if H == 0:
        return _dbl(X1, Y1, Z1) if R == 0 else _INF
    HH = H * H % P
    HHH = H * HH % P
    V = X1 * HH % P
    X3 = (R * R - HHH - 2 * V) % P
    return X3, (R * (V - X3) - Y1 * HHH) % P, Z1 * H % P


def _add(X1, Y1, Z1, X2, Y2, Z2):
    """Jacobian + Jacobian."""
    if Z1 == 0:
        return X2, Y2, Z2
    if Z2 == 0:
        return X1, Y1, Z1
    Z1Z1, Z2Z2 = Z1 * Z1 % P, Z2 * Z2 % P
    U1, U2 = X1 * Z2Z2 % P, X2 * Z1Z1 % P
    S1, S2 = Y1 * Z2 * Z2Z2 % P, Y2 * Z1 * Z1Z1 % P
    H, R = (U2 - U1) % P, (S2 - S1) % P
    if H == 0:
        return _dbl(X1, Y1, Z1) if R == 0 else _INF
    HH = H * H % P
    HHH = H * HH % P
    V = U1 * HH % P
    X3 = (R * R - HHH - 2 * V) % P
    return X3, (R * (V - X3) - S1 * HHH) % P, Z1 * Z2 * H % P


def to_affine(J):
    X, Y, Z = J
    if Z == 0:
        return None
    zi = pow(Z, -1, P)
    zi2 = zi * zi % P
    return X * zi2 % P, Y * zi2 * zi % P


def _batch_affine(js: list) -> list:
    """Many Jacobian points (none at infinity) to affine, one inversion."""
    pref, acc = [], 1
    for _, _, Z in js:
        pref.append(acc)
        acc = acc * Z % P
    inv = pow(acc, -1, P)
    out = [None] * len(js)
    for i in range(len(js) - 1, -1, -1):
        X, Y, Z = js[i]
        zi = inv * pref[i] % P
        inv = inv * Z % P
        zi2 = zi * zi % P
        out[i] = (X * zi2 % P, Y * zi2 * zi % P)
    return out


def mul(k: int, pt=G):
    """k * pt by double-and-add (any base; for one-off products)."""
    k %= N
    if pt is None or k == 0:
        return None
    acc = _INF
    for bit in bin(k)[2:]:
        acc = _dbl(*acc)
        if bit == "1":
            acc = _add_aff(*acc, *pt)
    return to_affine(acc)


def add(a, b):
    if a is None:
        return b
    if b is None:
        return a
    return to_affine(_add_aff(a[0], a[1], 1, *b))


class FixedBase:
    """k * B for one base B through an 8-bit comb."""

    def __init__(self, base):
        if not on_curve(base):
            raise ValueError("FixedBase: the base is not a point of the curve")
        rows, col = [], (base[0], base[1], 1)
        for _ in range(32):
            js = [col]
            for _ in range(254):
                js.append(_add(*js[-1], *col))
            rows.append(js)
            col = _add(*js[-1], *col)   # 256 * col: the next window's base
        flat = _batch_affine([j for r in rows for j in r])
        self.table = [flat[255 * w:255 * (w + 1)] for w in range(32)]

    def acc(self, k: int, J=_INF):
        """J + k * B, Jacobian (k reduced mod N)."""
        k %= N
        X, Y, Z = J
        for w in range(32):
            d = (k >> (8 * w)) & 255
            if d:
                X, Y, Z = _add_aff(X, Y, Z, *self.table[w][d - 1])
        return X, Y, Z

    def mul(self, k: int):
        return to_affine(self.acc(k))


_G_COMB = None


def g_comb() -> FixedBase:
    global _G_COMB
    if _G_COMB is None:
        _G_COMB = FixedBase(G)
    return _G_COMB


class Verifier:
    """ECDSA over secp256k1 under one public key y."""

    def __init__(self, y):
        self.y = y
        self.g = g_comb()
        self.k = FixedBase(y) if on_curve(y) else None

    def recover_point(self, z: int, r: int, s: int):
        """The point s^-1 (z G + r y), or None where (r, s) is out of range,
        the key is not on the curve, or the point is at infinity."""
        if self.k is None or not (0 < r < N and 0 < s < N):
            return None
        w = pow(s, -1, N)
        return to_affine(self.k.acc(r * w % N, self.g.acc(z * w % N)))

    def check(self, z: int, r: int, s: int, recid: int) -> bool:
        """(r, s, recid) is a valid signature of the hash z: the recovery
        point's x is r mod N and its y has the parity recid."""
        R = self.recover_point(z % N, r, s)
        return R is not None and R[0] % N == r and (R[1] & 1) == recid


def sign(d: int, z: int, k: int, low_s: bool = True):
    """(r, s, recid) of the hash z under the secret d with the nonce k;
    low_s folds s into [1, N/2] and flips recid with it."""
    R = g_comb().mul(k)
    r = R[0] % N
    s = pow(k, -1, N) * (z + r * d) % N
    recid = R[1] & 1
    if low_s and s > HALF_N:
        s, recid = N - s, recid ^ 1
    return r, s, recid
