"""HSM-CL encryption over imaginary quadratic class groups, host-side
(port of tpu_mpc/host/class_group.py).

The capability surface of the `class_group` crate used by CCLST'19
(two_party_ecdsa/cclst_2019/party_one.rs:250-277, party_two.rs:227-251):
CL group setup from a seed, keygen, (verifiable) encryption of secp256k1
scalars, homomorphic eval_scal / eval_sum, decryption via the order-q
subgroup F where discrete logs are easy (Castagnos-Laguillaumie).

Host-side by design, as in the reference: form reduction is branch-heavy
and low-QPS; the batched protocol path maps over sessions.  Pure python;
nothing here runs on a device.

Construction (all discriminants odd, = 1 mod 4):
  * dK = -q*r, r prime with q*r = 3 mod 4 and (q/r) = -1  -> dK = 1 mod 4
  * dq = dK * q^2
  * f = (q^2, k q, .) with k odd: generator of F, ord(f) = q; since
    q^2 < sqrt(|dq|/3), these forms are reduced, making log_f a lookup
  * g_q = (prime form)^(2q): generator of (a subgroup of) the q-th powers
  * Encrypt(m; rho) = (g_q^rho, pk^rho * f^m)

Group law: ideal multiplication + HNF basis (Z-basis {1, (1+sqrt d)/2}),
then classical form reduction (exact; NUCOMP would be faster).  The
reference documents its construction as an equivalent of the crate (same
API and security argument), not a byte-exact port; this module equals the
reference form for form.
"""

from __future__ import annotations

import dataclasses
import hashlib
import math

from . import ec as hec
from . import primes

Q = hec.N


@dataclasses.dataclass(frozen=True)
class Form:
    """Primitive positive-definite binary quadratic form (a, b, c), b^2-4ac=d."""

    a: int
    b: int
    c: int

    def disc(self) -> int:
        return self.b * self.b - 4 * self.a * self.c


def reduce_form(f: Form) -> Form:
    a, b, c = f.a, f.b, f.c
    d = b * b - 4 * a * c
    while True:
        # normalize: b into (-a, a]  (a - ((a-b) mod 2a) lands exactly there;
        # the naive ((b+a) mod 2a) - a yields [-a, a) and loops at b = -a)
        if b > a or b <= -a:
            b = a - ((a - b) % (2 * a))
            c = (b * b - d) // (4 * a)
        if a > c:
            a, b, c = c, -b, a
            continue
        if a == c and b < 0:
            b = -b
        return Form(a, b, c)


def _xgcd(a: int, b: int):
    old_r, r = a, b
    old_s, s = 1, 0
    old_t, t = 0, 1
    while r:
        qt = old_r // r
        old_r, r = r, old_r - qt * r
        old_s, s = s, old_s - qt * s
        old_t, t = t, old_t - qt * t
    return old_r, old_s, old_t


def _ideal_to_form(A0: int, x0: int, g: int, d: int) -> Form:
    """Module A0*Z + (x0 + g*w)*Z (w = (1+sqrt d)/2), g | A0, -> form."""
    a = A0 // g
    b = -(2 * (x0 // g) + 1)
    b = ((b + a) % (2 * a)) - a  # normalize early to keep numbers small
    c = (b * b - d) // (4 * a)
    return reduce_form(Form(a, b, c))


def compose(f1: Form, f2: Form) -> Form:
    """Gauss composition via ideal multiplication + HNF (exact, unoptimized)."""
    d = f1.disc()
    a1, b1 = f1.a, f1.b
    a2, b2 = f2.a, f2.b
    # generators of I1*I2 in basis {1, w}, w = (1+sqrt d)/2; elements are
    # written x + y*w.  (p + q*sqrt d)/2  ==  (p - q)/2 + q*w.
    rows = []
    rows.append((a1 * a2, 0))
    rows.append(((-a1 * b2 - a1) // 2, a1))
    rows.append(((-a2 * b1 - a2) // 2, a2))
    p4 = (b1 * b2 + d) // 2
    q4 = -(b1 + b2) // 2
    rows.append(((p4 - q4) // 2, q4))
    # HNF: first find (xv, g) with g = gcd of y-coords (g > 0)
    g, xv = 0, 0
    for x, y in rows:
        if y == 0:
            continue
        new_g, u, v = _xgcd(g, y)
        xv = u * xv + v * x
        g = new_g
    if g < 0:
        g, xv = -g, -xv
    # eliminate y-coords; A0 = gcd of resulting x-coords
    A0 = 0
    for x, y in rows:
        A0 = math.gcd(A0, x - (y // g) * xv)
    x0 = xv % A0
    return _ideal_to_form(A0, x0, g, d)


def square(f: Form) -> Form:
    return compose(f, f)


def identity(d: int) -> Form:
    return Form(1, 1, (1 - d) // 4)


def inverse(f: Form) -> Form:
    return reduce_form(Form(f.a, -f.b, f.c))


def pow_form(f: Form, e: int) -> Form:
    d = f.disc()
    if e < 0:
        return pow_form(inverse(f), -e)
    acc = identity(d)
    base = f
    while e:
        if e & 1:
            acc = compose(acc, base)
        base = compose(base, base)
        e >>= 1
    return acc


def _kronecker(a: int, n: int) -> int:
    """Kronecker symbol (a/n)."""
    if n == 0:
        return 1 if abs(a) == 1 else 0
    if n < 0:
        return (-1 if a < 0 else 1) * _kronecker(a, -n)
    t = 1
    while n % 2 == 0:
        n //= 2
        if a % 2 == 0:
            return 0
        if a % 8 in (3, 5):
            t = -t
    a %= n
    while a:
        while a % 2 == 0:
            a //= 2
            if n % 8 in (3, 5):
                t = -t
        a, n = n, a
        if a % 4 == 3 and n % 4 == 3:
            t = -t
        a %= n
    return t if n == 1 else 0


def prime_form(d: int, p: int) -> Form:
    """Reduced form above prime p (requires (d/p) = 1, p odd)."""
    bp = pow(d, (p + 1) // 4, p) if p % 4 == 3 else _sqrt_mod(d % p, p)
    if (bp - d) % 2 != 0:
        bp = p - bp if (p - bp - d) % 2 == 0 else bp + p
    b = bp % (2 * p)
    if (b * b - d) % (4 * p) != 0:
        b = 2 * p - b
    return reduce_form(Form(p, b, (b * b - d) // (4 * p)))


def _sqrt_mod(a: int, p: int) -> int:
    """Tonelli-Shanks."""
    if p % 4 == 3:
        return pow(a, (p + 1) // 4, p)
    # general case
    s, q = 0, p - 1
    while q % 2 == 0:
        q //= 2
        s += 1
    z = 2
    while _kronecker(z, p) != -1:
        z += 1
    m, c, t, r = s, pow(z, q, p), pow(a, q, p), pow(a, (q + 1) // 2, p)
    while t != 1:
        i, tt = 0, t
        while tt != 1:
            tt = tt * tt % p
            i += 1
        b = pow(c, 1 << (m - i - 1), p)
        m, c, t, r = i, b * b % p, t * b * b % p, r * b % p
    return r


# --------------------------------------------------------------------------
# CL group + HSM-CL encryption
# --------------------------------------------------------------------------

@dataclasses.dataclass
class CLGroup:
    dk: int          # fundamental discriminant -q*r
    dq: int          # dk * q^2
    gq: Form         # generator of the q-th power subgroup
    stilde: int      # exponent bound ~ sqrt(|dq|)
    q: int = Q

    @classmethod
    def from_seed(cls, seed: bytes, disc_bits: int = 1348) -> "CLGroup":
        """Deterministic setup (class_group CLGroup::new_from_setup analog):
        derive r from the seed until -q*r is a valid fundamental disc."""
        r_bits = disc_bits - Q.bit_length()
        ctr = 0
        while True:
            h = hashlib.sha256(seed + ctr.to_bytes(4, "big")).digest()
            cand = int.from_bytes(
                hashlib.sha256(h).digest() * ((r_bits + 255) // 256), "big"
            ) >> max(0, ((r_bits + 255) // 256) * 256 - r_bits)
            cand |= (1 << (r_bits - 1)) | 1
            ctr += 1
            if not primes.is_probable_prime(cand):
                continue
            if (Q * cand) % 4 != 3:
                continue
            if _kronecker(Q, cand) != -1:
                continue
            r = cand
            break
        dk = -Q * r
        dq = dk * Q * Q
        # prime form above the smallest suitable odd prime
        p = 3
        while _kronecker(dq, p) != 1:
            p = primes._small_primes()[primes._small_primes().index(p) + 1]
        gq = pow_form(prime_form(dq, p), 2 * Q)
        stilde = _isqrt(-dq) + 1
        return cls(dk=dk, dq=dq, gq=gq, stilde=stilde)

    # F-subgroup helpers -----------------------------------------------------
    def exp_f(self, m: int) -> Form:
        """f^m, f = (q^2, ~q, .); trivial dlog subgroup (CL'15 Solve)."""
        m %= self.q
        if m == 0:
            return identity(self.dq)
        k = pow(m, -1, self.q)
        if k % 2 == 0:
            k -= self.q  # make k odd, |k| < q
        b = k * self.q
        return reduce_form(Form(self.q * self.q, b, (b * b - self.dq) // (4 * self.q * self.q)))

    def log_f(self, fm: Form) -> int:
        if fm.a == 1:
            return 0
        assert fm.a == self.q * self.q, "element not in F"
        k = fm.b // self.q
        return pow(k % self.q, -1, self.q)

    # HSM-CL API -------------------------------------------------------------
    def keygen(self, rng) -> tuple[int, Form]:
        sk = rng._r.randrange(self.stilde * (1 << 40))
        return sk, pow_form(self.gq, sk)

    def encrypt(self, pk: Form, m: int, rng) -> tuple["CLCiphertext", int]:
        rho = rng._r.randrange(self.stilde * (1 << 40))
        c1 = pow_form(self.gq, rho)
        c2 = compose(pow_form(pk, rho), self.exp_f(m))
        return CLCiphertext(c1, c2), rho

    def decrypt(self, sk: int, ct: "CLCiphertext") -> int:
        fm = compose(ct.c2, inverse(pow_form(ct.c1, sk)))
        return self.log_f(fm)

    def eval_scal(self, ct: "CLCiphertext", k: int) -> "CLCiphertext":
        return CLCiphertext(pow_form(ct.c1, k), pow_form(ct.c2, k))

    def eval_sum(self, a: "CLCiphertext", b: "CLCiphertext") -> "CLCiphertext":
        return CLCiphertext(compose(a.c1, b.c1), compose(a.c2, b.c2))


def _isqrt(n: int) -> int:
    return math.isqrt(n)


@dataclasses.dataclass
class CLCiphertext:
    c1: Form
    c2: Form


# --- CL-DL proof: (c1, c2) encrypts the dlog of X = m*G ---------------------

@dataclasses.dataclass
class CLDLProof:
    t1: Form
    t2: Form
    T: tuple      # EC point
    u_r: int
    u_m: int


def _cldl_challenge(group: CLGroup, pk: Form, ct: CLCiphertext, X, t1: Form, t2: Form, T) -> int:
    h = hashlib.sha256()
    for f in (pk, ct.c1, ct.c2, t1, t2):
        h.update(repr((f.a, f.b, f.c)).encode())
    h.update(hec.compress(X))
    h.update(hec.compress(T))
    return int.from_bytes(h.digest(), "big") >> (256 - 128)  # 128-bit challenge


def cldl_prove(group: CLGroup, pk: Form, ct: CLCiphertext, X, m: int, rho: int, rng) -> CLDLProof:
    B = group.stilde * (1 << 40)
    s_r = rng._r.randrange(B << 168)      # statistically hides e*rho
    s_m = rng._r.randrange(group.q)
    t1 = pow_form(group.gq, s_r)
    t2 = compose(pow_form(pk, s_r), group.exp_f(s_m))
    T = hec.mul(s_m)
    e = _cldl_challenge(group, pk, ct, X, t1, t2, T)
    u_r = s_r + e * rho
    u_m = (s_m + e * m) % group.q
    return CLDLProof(t1=t1, t2=t2, T=T, u_r=u_r, u_m=u_m)


def cldl_verify(group: CLGroup, pk: Form, ct: CLCiphertext, X, proof: CLDLProof) -> bool:
    e = _cldl_challenge(group, pk, ct, X, proof.t1, proof.t2, proof.T)
    lhs1 = pow_form(group.gq, proof.u_r)
    rhs1 = compose(proof.t1, pow_form(ct.c1, e))
    if lhs1 != rhs1:
        return False
    lhs2 = compose(pow_form(pk, proof.u_r), group.exp_f(proof.u_m))
    rhs2 = compose(proof.t2, pow_form(ct.c2, e))
    if lhs2 != rhs2:
        return False
    lhs3 = hec.mul(proof.u_m)
    rhs3 = hec.add(proof.T, hec.mul(e % Q, X))
    return lhs3 == rhs3
