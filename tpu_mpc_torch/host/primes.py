"""Prime generation on the host (port of tpu_mpc/host/primes.py).

The reference takes its primes from its native helper whenever the helper
accepts the width (64 | bits, 128 <= bits <= 4096), and from a python
Miller-Rabin search over random.Random otherwise.  The port does the same
through its own copy of the helper (native/primegen.cpp), so that a keygen
under a pinned seed reproduces the reference's keys.  The helper's draw,
which _helper_gen_prime and _helper_gen_safe_prime write out in python as
the plain versions that the tests and chip_smoke.py hold it against:

  * the candidates and the Miller-Rabin witnesses come from ONE splitmix64
    stream, seeded with seed ^ 0xA5A5A5A5DEADBEEF (random primes) or
    seed ^ 0x5AFE5AFE5AFE5AFE (safe primes);
  * a candidate is bits/64 words of that stream, low word first, with its
    top bit and its low bit set;
  * trial division by the 167 odd primes 3 ... 997, then 28 Miller-Rabin
    rounds; a witness is bits/64 words of the stream with the top word
    zeroed and 2 or-ed into the low word, and the rounds stop at the first
    witness that proves the candidate composite (primegen.cpp:160-197);
  * safe primes p = 2q + 1: q has its top two bits 01 and its low bit set,
    q and 2q + 1 are sieved by the same primes, then Miller-Rabin rounds
    2 (q), 2 (p), 26 (q), 26 (p) (primegen.cpp:safe_pair).

That draw is kept for seeded runs only: a prime drawn from a 64-bit seed is
one of at most 2^64 values, so a modulus made of two of them can be
factored with about 2^64 work.  An unseeded draw (no rng, or the OS's
random.SystemRandom, which an unseeded SessionRng holds) takes every
candidate's bits from the OS (secrets) and never goes through a 64-bit
state.  Where the helper accepts the width it tests the candidate there
with the helper's rounds (tpu_mpc_is_prime: 28; tpu_mpc_is_safe_prime: the
double sieve, then 2, 2, 26, 26), witnesses from 64 fresh OS bits a call.
Such witnesses do not weaken the prime: its secrecy rests on the
candidate's bits alone, and the witnesses are fixed after the candidate,
independently of it, and then thrown away, so no one can choose a
composite that they pass, and a random composite passes a round with
probability far below 1/4.  At other widths the python test runs with OS
witnesses (is_probable_prime).

Prime search is a rejection loop, the one part of keygen that cannot be
constant-shape: it stays on the host.  The parallel variants draw one
64-bit seed per prime from a seeded rng in order (the reference's seed
order) and search the seeds in worker processes, so the output does not
depend on the number of workers; unseeded, each worker draws its own
candidates from the OS.
"""

from __future__ import annotations

import contextlib
import os
import random
import secrets
import sys

from .. import native

_M64 = (1 << 64) - 1
_SEED_PRIME = 0xA5A5A5A5DEADBEEF
_SEED_SAFE = 0x5AFE5AFE5AFE5AFE
_NATIVE_MR_ROUNDS = 28
_NATIVE_MAX_BITS = 4096

# the helper's trial-division primes: the odd primes below 1000
_HELPER_PRIMES = tuple(p for p in range(3, 1000, 2)
                       if all(p % d for d in range(3, int(p ** 0.5) + 1, 2)))

_SMALL_PRIMES: list[int] = []


def _small_primes(limit: int = 10000) -> list[int]:
    global _SMALL_PRIMES
    if not _SMALL_PRIMES:
        sieve = bytearray([1]) * limit
        sieve[0:2] = b"\x00\x00"
        for i in range(2, int(limit ** 0.5) + 1):
            if sieve[i]:
                sieve[i * i :: i] = b"\x00" * len(sieve[i * i :: i])
        _SMALL_PRIMES = [i for i in range(limit) if sieve[i]]
    return _SMALL_PRIMES


def is_probable_prime(n: int, rounds: int = 32, rng: random.Random | None = None) -> bool:
    """Trial division by the primes below 10000, then `rounds` Miller-Rabin
    rounds with witnesses from `rng` (the reference's python test)."""
    if n < 2:
        return False
    for p in _small_primes():
        if n % p == 0:
            return n == p
    d = n - 1
    r = 0
    while d % 2 == 0:
        d //= 2
        r += 1
    rand = rng.randrange if rng else (lambda a, b: secrets.randbelow(b - a) + a)
    for _ in range(rounds):
        a = rand(2, n - 1)
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


# --------------------------------------------------------------------------
# the helper's draw (primegen.cpp), in python: its plain version
# --------------------------------------------------------------------------

class _SplitMix64:
    """primegen.cpp:splitmix64, one state shared by candidates and witnesses."""

    def __init__(self, state: int):
        self.s = state & _M64

    def next(self) -> int:
        self.s = (self.s + 0x9E3779B97F4A7C15) & _M64
        z = self.s
        z = ((z ^ (z >> 30)) * 0xBF58476D1CE4E5B9) & _M64
        z = ((z ^ (z >> 27)) * 0x94D049BB133111EB) & _M64
        return z ^ (z >> 31)

    def words(self, n: int) -> list[int]:
        return [self.next() for _ in range(n)]


def _from_words(w) -> int:
    return sum(v << (64 * i) for i, v in enumerate(w))


def _helper_mr(num: int, limbs: int, rounds: int, st: _SplitMix64) -> bool:
    """primegen.cpp:miller_rabin: witnesses of `limbs` stream words, top word
    zeroed, low word | 2; stops at the first witness of compositeness."""
    nm1 = num - 1
    d, r = nm1, 0
    while not d & 1:
        d >>= 1
        r += 1
    for _ in range(rounds):
        w = st.words(limbs)
        w[-1] = 0
        w[0] |= 2
        x = pow(_from_words(w), d, num)
        if x == 1 or x == nm1:
            continue
        witness = True
        for _ in range(r - 1):
            x = x * x % num
            if x == nm1:
                witness = False
                break
            if x == 1:
                break
        if witness:
            return False
    return True


def _helper_accepts(bits: int) -> bool:
    return bits % 64 == 0 and 128 <= bits <= _NATIVE_MAX_BITS


def _helper_gen_prime(bits: int, seed: int) -> int:
    """The plain version of primegen.cpp:tpu_mpc_gen_prime (bits accepted by
    _helper_accepts); only the tests and chip_smoke.py call it."""
    limbs = bits // 64
    st = _SplitMix64(seed ^ _SEED_PRIME)
    top = 1 << (bits - 1)
    while True:
        cand = _from_words(st.words(limbs)) | top | 1
        if any(cand % p == 0 for p in _HELPER_PRIMES):
            continue
        if _helper_mr(cand, limbs, _NATIVE_MR_ROUNDS, st):
            return cand


def _helper_gen_safe_prime(bits: int, seed: int) -> int:
    """The plain version of primegen.cpp:tpu_mpc_gen_safe_prime (bits accepted
    by _helper_accepts); only the tests and chip_smoke.py call it."""
    limbs = bits // 64
    st = _SplitMix64(seed ^ _SEED_SAFE)
    top2, low = 1 << (bits - 2), (1 << (bits - 1)) - 1
    while True:
        q = ((_from_words(st.words(limbs)) | top2) & low) | 1
        if any(q % sp == 0 or (2 * (q % sp) + 1) % sp == 0 for sp in _HELPER_PRIMES):
            continue
        p = 2 * q + 1
        if (_helper_mr(q, limbs, 2, st) and _helper_mr(p, limbs, 2, st)
                and _helper_mr(q, limbs, 26, st) and _helper_mr(p, limbs, 26, st)):
            return p


# --------------------------------------------------------------------------
# the reference's API
# --------------------------------------------------------------------------

def _unseeded(rng) -> bool:
    """True for a draw with no reproducible stream behind it: no rng, or the
    OS's (random.SystemRandom, as an unseeded SessionRng holds)."""
    return rng is None or isinstance(rng, random.SystemRandom)


def _os_gen_prime(bits: int) -> int:
    """A prime of exactly `bits` bits from OS candidates, held to the
    helper's 28 Miller-Rabin rounds: the helper's test where it accepts the
    width, with 64 fresh OS bits of witness seed; else is_probable_prime
    (OS witnesses, after trial division by the primes below 10000)."""
    top = 1 << (bits - 1)
    native_test = _helper_accepts(bits)
    while True:
        cand = secrets.randbits(bits) | top | 1
        if (native.primegen.is_prime(cand, secrets.randbits(64)) if native_test
                else is_probable_prime(cand, _NATIVE_MR_ROUNDS)):
            return cand


def _os_gen_safe_prime(bits: int) -> int:
    """A safe prime p = 2q + 1 of exactly `bits` bits from OS candidates: q
    with its top two bits 01, the helper's double sieve, then its rounds
    2 (q), 2 (p), 26 (q), 26 (p): in the helper where it accepts the width
    (64 fresh OS bits of witness seed), else in python (is_probable_prime,
    OS witnesses)."""
    top2, low = 1 << (bits - 2), (1 << (bits - 1)) - 1
    native_test = _helper_accepts(bits)
    while True:
        q = ((secrets.randbits(bits) | top2) & low) | 1
        if native_test:
            if native.primegen.is_safe_prime(q, secrets.randbits(64)):
                return 2 * q + 1
            continue
        p = 2 * q + 1
        if any(q % sp == 0 or p % sp == 0 for sp in _HELPER_PRIMES if sp < q):
            continue
        if all(is_probable_prime(v, r) for v, r in ((q, 2), (p, 2), (q, 26), (p, 26))):
            return p


def gen_prime(bits: int, rng: random.Random | None = None) -> int:
    """Random prime of exactly `bits` bits.  Seeded: draws one 64-bit seed
    from rng for the helper's draw; where the helper refuses the width,
    searches with rng itself (the reference's fallback, after the same seed
    draw).  Unseeded: OS candidates (_os_gen_prime)."""
    if _unseeded(rng):
        return _os_gen_prime(bits)
    seed = rng.getrandbits(64)
    if _helper_accepts(bits):
        return native.primegen.gen_prime(bits, seed)
    while True:
        cand = rng.getrandbits(bits) | (1 << (bits - 1)) | 1
        if is_probable_prime(cand, rng=rng):
            return cand


def gen_safe_prime(bits: int, rng: random.Random | None = None) -> int:
    """Safe prime p = 2q + 1 of exactly `bits` bits (Paillier's
    keypair_safe_primes role).  Seeded: the helper's double-sieved draw, or
    the reference's python fallback where the helper refuses the width.
    Unseeded: OS candidates (_os_gen_safe_prime)."""
    if _unseeded(rng):
        return _os_gen_safe_prime(bits)
    seed = rng.getrandbits(64)
    if _helper_accepts(bits):
        return native.primegen.gen_safe_prime(bits, seed)
    while True:
        q = gen_prime(bits - 1, rng)
        p = 2 * q + 1
        if is_probable_prime(p, rng=rng):
            return p


def _one_prime(job) -> int:
    bits, seed = job
    if seed is None:
        return _os_gen_prime(bits)
    if _helper_accepts(bits):
        return native.primegen.gen_prime(bits, seed)
    r2 = random.Random(seed)  # per-seed fallback keeps parallel determinism
    while True:
        cand = r2.getrandbits(bits) | (1 << (bits - 1)) | 1
        if is_probable_prime(cand, rng=r2):
            return cand


def _one_safe_prime(job) -> int:
    bits, seed = job
    if seed is None:
        return _os_gen_safe_prime(bits)
    if _helper_accepts(bits):
        return native.primegen.gen_safe_prime(bits, seed)
    r2 = random.Random(seed)
    while True:
        q = gen_prime(bits - 1, r2)
        cand = 2 * q + 1
        if is_probable_prime(cand, rng=r2):
            return cand


# below this width a prime costs milliseconds, less than starting a worker
_POOL_MIN_BITS = 1024


def _fan_out(fn, bits: int, count: int, rng, workers):
    # a job carries its seed, or None: unseeded, the worker draws from the OS
    seeds = [None] * count if _unseeded(rng) else [rng.getrandbits(64) for _ in range(count)]
    jobs = [(bits, s) for s in seeds]
    if workers is None:
        workers = (os.cpu_count() or 1) if bits >= _POOL_MIN_BITS else 1
    workers = min(count, workers)
    if _helper_accepts(bits):
        native.lib("primegen")  # built here once, not by each worker
    if workers <= 1:
        return [fn(j) for j in jobs]
    import multiprocessing
    from concurrent.futures import ProcessPoolExecutor

    # worker processes search one seed each.  They are spawned, not forked,
    # since the caller may run threads (torch, CUDA) that a forked child
    # would inherit half-locked; a spawned worker imports this module and
    # the native layer (standard library only), nothing else of the package.
    with _bare_main(), ProcessPoolExecutor(
            workers, mp_context=multiprocessing.get_context("spawn")) as ex:
        return list(ex.map(fn, jobs))


@contextlib.contextmanager
def _bare_main():
    """A spawned worker first runs the parent's __main__ module again, found
    by its __spec__ or __file__: for a party process started with `python -m
    tpu_mpc_torch.runtime.cli` that is the package and torch, seconds a
    worker.  The jobs need only this module and the native layer, so both
    are hidden while the workers start (they start inside the pool's
    block)."""
    main = sys.modules["__main__"]
    saved = {k: main.__dict__[k] for k in ("__spec__", "__file__") if k in main.__dict__}
    main.__spec__ = None
    main.__dict__.pop("__file__", None)
    try:
        yield
    finally:
        main.__dict__.pop("__spec__", None)
        main.__dict__.update(saved)


def gen_primes_parallel(bits: int, count: int, rng: random.Random | None = None,
                        workers: int | None = None) -> list[int]:
    """`count` primes of `bits` bits.  Seeded: one 64-bit seed per prime is
    drawn from rng in order (the draw order of repeated gen_prime calls).
    Unseeded: each search draws from the OS.  The searches run in `workers`
    processes (default: one per core from 1024 bits up, else none)."""
    return _fan_out(_one_prime, bits, count, rng, workers)


def gen_safe_primes_parallel(bits: int, count: int, rng: random.Random | None = None,
                             workers: int | None = None) -> list[int]:
    """`count` safe primes (see gen_primes_parallel for the seed order)."""
    return _fan_out(_one_safe_prime, bits, count, rng, workers)
