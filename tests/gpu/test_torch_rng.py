"""The port's host randomness against the reference package, on the CPU.

Seeded draws are the reference's, value for value: SessionRng(seed) is its
random.Random stream, and a prime drawn under random.Random(seed) is the
reference's (its native helper's draw from one 64-bit seed), so that the
committed key files and goldens still hold.

Unseeded draws are the port's own: SessionRng() draws from the OS
(random.SystemRandom), and an unseeded prime search takes its candidates
(and its witnesses, or their seeds) from the OS, never from the helper's
64-bit splitmix64 state (tpu_mpc_torch/host/primes.py:_SplitMix64), which
is patched here to raise.
"""

import random

import numpy as np
import pytest

SEEDS = (0, 1, 0xC41B, 2 ** 100 + 7)


def _draws(rng):
    """One draw of every SessionRng method, as python ints."""
    ints = lambda a: [int(v) for v in np.asarray(a, dtype=object).reshape(-1)]
    bound = np.asarray([[1000003, 2 ** 127 - 1], [97, 2 ** 64 + 13]], dtype=object)
    return (ints(rng.scalars((3, 2))), ints(rng.scalars()), ints(rng.bits(200, (4,))),
            ints(rng.below(2 ** 90, (2, 3))), ints(rng.below(bound, (2, 2))),
            ints(rng.units_below(2 ** 61 - 1, (3,))), ints(rng.units_below(bound, (2, 2))),
            ints(rng.units_below(91)))


@pytest.mark.parametrize("seed", SEEDS)
def test_seeded_session_rng_equals_reference(seed):
    from tpu_mpc.utils.rng import SessionRng as RefRng
    from tpu_mpc_torch.utils.rng import SessionRng

    a, b = SessionRng(seed), RefRng(seed)
    assert type(a._r) is random.Random
    for _ in range(3):
        assert _draws(a) == _draws(b)


def test_seeded_primes_equal_reference():
    from tpu_mpc.host import primes as rp
    from tpu_mpc_torch.host import primes as tp

    for seed in (3, 0x2017):
        assert tp.gen_prime(256, random.Random(seed)) == rp.gen_prime(256, random.Random(seed))
        assert tp.gen_safe_prime(256, random.Random(seed)) == \
            rp.gen_safe_prime(256, random.Random(seed))
    assert tp.gen_primes_parallel(256, 3, random.Random(9), workers=1) == \
        rp.gen_primes_parallel(256, 3, random.Random(9))
    assert tp.gen_safe_primes_parallel(256, 2, random.Random(10), workers=1) == \
        rp.gen_safe_primes_parallel(256, 2, random.Random(10))


def test_unseeded_session_rng_draws_from_the_os():
    from tpu_mpc_torch.utils.rng import SessionRng

    rng = SessionRng()
    assert isinstance(rng._r, random.SystemRandom)
    k = rng.scalars((4,))
    assert len({int(v) for v in k}) == 4 and all(0 < int(v) for v in k)
    assert _draws(SessionRng()) != _draws(SessionRng())


@pytest.fixture
def no_splitmix(monkeypatch):
    from tpu_mpc_torch.host import primes

    def refuse(*a, **kw):
        raise AssertionError("an unseeded prime draw reached the 64-bit splitmix64 state")

    monkeypatch.setattr(primes, "_SplitMix64", refuse)
    return primes


def _is_safe(p: int, bits: int, primes) -> bool:
    return p.bit_length() == bits and primes.is_probable_prime(p) \
        and primes.is_probable_prime((p - 1) // 2)


def test_unseeded_primes_never_reach_splitmix(no_splitmix):
    from tpu_mpc_torch.host import paillier as hp
    from tpu_mpc_torch.utils.rng import SessionRng

    primes = no_splitmix
    got = [primes.gen_prime(256), primes.gen_prime(256, random.SystemRandom()),
           primes.gen_prime(256, SessionRng()._r), primes.gen_prime(200)]
    got += primes.gen_primes_parallel(256, 2, workers=1)
    got += primes.gen_primes_parallel(256, 2, random.SystemRandom(), workers=1)
    for p, bits in zip(got, (256, 256, 256, 200, 256, 256, 256, 256)):
        assert p.bit_length() == bits and primes.is_probable_prime(p)
    assert len(set(got)) == len(got)
    safe = [primes.gen_safe_prime(256), primes.gen_safe_prime(256, random.SystemRandom())]
    safe += primes.gen_safe_primes_parallel(256, 2, workers=1)
    safe += primes.gen_safe_primes_parallel(256, 1, SessionRng()._r, workers=1)
    assert all(_is_safe(p, 256, primes) for p in safe) and len(set(safe)) == len(safe)
    # a Paillier keypair with no rng goes the same way
    ek, dk = hp.keypair(512)
    assert ek.n == dk.p * dk.q and dk.p.bit_length() == dk.q.bit_length() == 256
