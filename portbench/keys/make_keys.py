"""Write the benchmark's GG20 key sets: one file per configuration.

    python3 portbench/keys/make_keys.py [--bits 2048] [name ...]

A key set is deployment state: it is made once, from a fixed seed, and
committed.  Each file holds the fields that
tpu_mpc_torch/protocols/gg20/batch.py:key_from_material reads, with one
key set (S = 1):

    t, n, bits     threshold, parties, Paillier and N~ width
    p, q           [1][n] Paillier primes, N = p q of exactly `bits` bits
    nt, h1, h2     [1][n] ring-Pedersen setup: N~ = P~ Q~ of two safe primes,
                   h1 a square mod N~, h2 = h1^xhi mod N~
    u              [1][n] additive secret shares
    x              [1][n] Shamir shares of sum(u): x_j = sum_i f_i(j + 1)
    y_i            [1][n] u_i G
    vss            [1][n][t + 1] Feldman commitments of each f_i

and, for the tests, nt_p and nt_q (the safe primes of N~) and the seed.
Standard library only: nothing of the program is imported.  The numbers are
public benchmark data and no secret.
"""

from __future__ import annotations

import argparse
import json
import os
import random
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.dirname(os.path.dirname(HERE)))

from portbench.reference import secp256k1 as ec  # noqa: E402

# configuration -> (t, n, seed)
KEY_SETS = {
    "gg20-2of3-tables": (1, 3, 0x2013),
    "gg20-2of5q4-tables": (2, 5, 0x2505),
}
MR_ROUNDS = 40
SIEVE_LIMIT = 1 << 16
SIEVE_SPAN = 1 << 18
_SMALL = None


def small_primes() -> list:
    global _SMALL
    if _SMALL is None:
        flags = bytearray([1]) * SIEVE_LIMIT
        flags[0:2] = b"\0\0"
        for i in range(2, int(SIEVE_LIMIT ** 0.5) + 1):
            if flags[i]:
                flags[i * i::i] = bytes(len(range(i * i, SIEVE_LIMIT, i)))
        _SMALL = [i for i in range(3, SIEVE_LIMIT) if flags[i]]
    return _SMALL


def is_probable_prime(n: int, rnd: random.Random, rounds: int = MR_ROUNDS) -> bool:
    """Miller-Rabin with `rounds` witnesses drawn from rnd."""
    if n < 2:
        return False
    for sp in (2, 3, 5, 7, 11, 13, 17, 19, 23, 29, 31, 37):
        if n % sp == 0:
            return n == sp
    d, r = n - 1, 0
    while d % 2 == 0:
        d //= 2
        r += 1
    for _ in range(rounds):
        a = rnd.randrange(2, n - 1)
        x = pow(a, d, n)
        if x in (1, n - 1):
            continue
        for _ in range(r - 1):
            x = x * x % n
            if x == n - 1:
                break
        else:
            return False
    return True


def _start(bits: int, rnd: random.Random) -> int:
    """A random odd number of exactly `bits` bits with its top two bits set."""
    return rnd.getrandbits(bits) | (3 << (bits - 2)) | 1


def gen_prime(bits: int, rnd: random.Random) -> int:
    """A prime of exactly `bits` bits, top two bits set: a sieved scan up
    from a random odd start."""
    while True:
        base = _start(bits, rnd)
        alive = bytearray([1]) * SIEVE_SPAN          # candidate base + 2k
        for sp in small_primes():
            k0 = (-base * pow(2, -1, sp)) % sp
            alive[k0::sp] = bytes(len(range(k0, SIEVE_SPAN, sp)))
        for k in range(SIEVE_SPAN):
            c = base + 2 * k
            if alive[k] and c.bit_length() == bits and pow(2, c - 1, c) == 1 \
                    and is_probable_prime(c, rnd):
                return c


def gen_safe_prime(bits: int, rnd: random.Random) -> int:
    """A safe prime p = 2 p' + 1 of exactly `bits` bits, top two bits set:
    p' and p sieved together."""
    while True:
        base = _start(bits - 1, rnd)                  # p' = base + 2k
        alive = bytearray([1]) * SIEVE_SPAN
        for sp in small_primes():
            k0 = (-base * pow(2, -1, sp)) % sp        # sp | p'
            alive[k0::sp] = bytes(len(range(k0, SIEVE_SPAN, sp)))
            k1 = (-(2 * base + 1) * pow(4, -1, sp)) % sp   # sp | 2 p' + 1
            alive[k1::sp] = bytes(len(range(k1, SIEVE_SPAN, sp)))
        for k in range(SIEVE_SPAN):
            if not alive[k]:
                continue
            q = base + 2 * k
            p = 2 * q + 1
            if p.bit_length() != bits or pow(2, q - 1, q) != 1 or pow(2, p - 1, p) != 1:
                continue
            if is_probable_prime(q, rnd) and is_probable_prime(p, rnd):
                return p


def make_material(t: int, n: int, bits: int, seed: int) -> dict:
    """One GG20 key set, every number drawn from random.Random(seed)."""
    if not 1 <= t < n:
        raise ValueError(f"make_material: need 1 <= t < n, got t = {t}, n = {n}")
    rnd = random.Random(seed)
    half = bits // 2
    p, q, ntp, ntq, nt, h1, h2 = ([] for _ in range(7))
    for _ in range(n):
        while True:
            a, b = gen_prime(half, rnd), gen_prime(half, rnd)
            if a != b and (a * b).bit_length() == bits:
                break
        p.append(a)
        q.append(b)
        while True:
            sa, sb = gen_safe_prime(half, rnd), gen_safe_prime(half, rnd)
            if sa != sb and (sa * sb).bit_length() == bits:
                break
        ntp.append(sa)
        ntq.append(sb)
        m = sa * sb
        order = (sa - 1) // 2 * ((sb - 1) // 2)       # of the squares mod N~
        g = pow(rnd.randrange(2, m - 1), 2, m)
        nt.append(m)
        h1.append(g)
        h2.append(pow(g, rnd.randrange(1, order), m))
    coeffs = [[rnd.randrange(1, ec.N) for _ in range(t + 1)] for _ in range(n)]
    u = [c[0] for c in coeffs]
    x = [sum(sum(c[k] * pow(j + 1, k, ec.N) for k in range(t + 1)) for c in coeffs) % ec.N
         for j in range(n)]
    vss = [[list(ec.mul(a)) for a in c] for c in coeffs]
    return {
        "note": "benchmark key set, made by portbench/keys/make_keys.py from the seed "
                "below: public data, not a secret",
        "seed": seed, "t": t, "n": n, "bits": bits,
        "p": [p], "q": [q], "nt": [nt], "h1": [h1], "h2": [h2],
        "u": [u], "x": [x], "y_i": [[v[0] for v in vss]], "vss": [vss],
        "nt_p": [ntp], "nt_q": [ntq],
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("names", nargs="*", default=sorted(KEY_SETS))
    ap.add_argument("--bits", type=int, default=2048)
    args = ap.parse_args(argv)
    for name in args.names:
        t, n, seed = KEY_SETS[name]
        mat = make_material(t, n, args.bits, seed)
        path = os.path.join(HERE, f"{name}.json")
        with open(path, "w") as fh:
            json.dump(mat, fh)
            fh.write("\n")
        print(f"{name}: t = {t}, n = {n}, {args.bits} bits -> {path}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
