"""Host (python-int) Paillier cryptosystem (port of tpu_mpc/host/paillier.py).

kzen-paillier's API surface as ZenGo-X/multi-party-ecdsa uses it (MtA,
src/utilities/mta/mod.rs; GG20 blame, gg_2020/blame.rs:252-256): keypair /
encrypt / decrypt / open (randomness recovery) / add / mul.  Pure python:
the golden oracle of the batched device path, and the Paillier `open` of
phase-6 blame (protocols/gg20/blame.py).  Primes come from the port's
host/primes.py, so a seeded keypair equals the reference's.
"""

from __future__ import annotations

import dataclasses
import math
import random
import secrets

from . import primes


@dataclasses.dataclass(frozen=True)
class EncryptionKey:
    n: int

    @property
    def nn(self) -> int:
        return self.n * self.n


@dataclasses.dataclass(frozen=True)
class DecryptionKey:
    p: int
    q: int

    @property
    def n(self) -> int:
        return self.p * self.q

    @property
    def nn(self) -> int:
        return self.n * self.n

    @property
    def lam(self) -> int:  # lcm(p-1, q-1)
        return (self.p - 1) * (self.q - 1) // math.gcd(self.p - 1, self.q - 1)


def keypair(bits: int = 2048, rng: random.Random | None = None, safe: bool = False):
    """Paillier keypair with n of ~`bits` bits (two bits/2 primes; random
    primes by default, as GG20's Keys::create)."""
    gen = primes.gen_safe_prime if safe else primes.gen_prime
    while True:
        p = gen(bits // 2, rng)
        q = gen(bits // 2, rng)
        if p != q:
            break
    dk = DecryptionKey(p, q)
    return EncryptionKey(dk.n), dk


def sample_randomness(ek: EncryptionKey, rng: random.Random | None = None) -> int:
    """Uniform r in [1, n) (the gcd check is omitted: failure ~ 2^-1020)."""
    rand = rng.randrange if rng else (lambda a, b: secrets.randbelow(b - a) + a)
    return rand(1, ek.n)


def encrypt(ek: EncryptionKey, m: int, r: int) -> int:
    """E(m; r) = (1 + m n) r^n mod n^2   (g = n + 1)."""
    n, nn = ek.n, ek.nn
    return (1 + m * n) % nn * pow(r, n, nn) % nn


def decrypt(dk: DecryptionKey, c: int) -> int:
    """m = L(c^lambda mod n^2) * lambda^-1 mod n."""
    n, lam = dk.n, dk.lam
    u = pow(c, lam, dk.nn)
    return (u - 1) // n * pow(lam, -1, n) % n


def add(ek: EncryptionKey, c1: int, c2: int) -> int:
    return c1 * c2 % ek.nn


def add_plain(ek: EncryptionKey, c: int, m: int) -> int:
    return c * (1 + m * ek.n) % ek.nn


def mul_plain(ek: EncryptionKey, c: int, k: int) -> int:
    return pow(c, k, ek.nn)


def open(dk: DecryptionKey, c: int) -> tuple[int, int]:
    """Recover (m, r) from a ciphertext (Paillier::open):
    r = (c * g^-m)^(n^-1 mod lambda) mod n."""
    m = decrypt(dk, c)
    n = dk.n
    c_r = c * pow(1 + n, -m, dk.nn) % dk.nn  # strip the message part
    r = pow(c_r, pow(n, -1, dk.lam), n)
    return m, r
