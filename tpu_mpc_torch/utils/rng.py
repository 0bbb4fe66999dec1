"""Host-side randomness (port of tpu_mpc/utils/rng.py).

All protocol randomness is pre-generated on host (python ints) and injected
into kernels explicitly.  This mirrors the reference's fixed-randomness seams
(a_with_predefined_randomness, mta/mod.rs:62,111) and is what makes runs
reproducible and kernels constant-shape (no on-device rejection sampling).

A seeded SessionRng is the reference's stream, draw for draw (random.Random,
a Mersenne Twister), so that pinned runs reproduce its goldens and key
files.  An unseeded one draws from the OS (random.SystemRandom): one stream
gives both the secret nonces and published values such as the decommit
blinds, and 624 published 32-bit words of a Mersenne Twister would give
away its whole state, forward and backward.
"""

from __future__ import annotations

import math
import random

import numpy as np

from ..host import ec as hec


class SessionRng:
    """RNG producing object ndarrays of python ints: random.Random(seed)
    when seeded, the OS's random.SystemRandom when not."""

    def __init__(self, seed: int | None = None):
        self._r = random.SystemRandom() if seed is None else random.Random(seed)

    def _fill(self, shape, fn):
        n = int(np.prod(shape)) if shape else 1
        out = np.empty(n, dtype=object)
        for i in range(n):
            out[i] = fn()
        return out.reshape(shape) if shape else out[0]

    def scalars(self, shape=()):
        """Uniform in [1, q) (curv Scalar::random never returns 0)."""
        return self._fill(shape, lambda: self._r.randrange(1, hec.N))

    def bits(self, k: int, shape=()):
        """Uniform k-bit (BigInt::sample(k))."""
        return self._fill(shape, lambda: self._r.getrandbits(k))

    def below(self, bound, shape=()):
        """Uniform below a bound; bound may be an int or an object ndarray
        broadcastable to `shape` (BigInt::sample_below)."""
        b = np.asarray(bound, dtype=object)
        if b.shape == ():
            v = int(b[()])
            return self._fill(shape, lambda: self._r.randrange(v))
        b = np.broadcast_to(b, shape)
        flat = b.reshape(-1)
        out = np.empty(flat.shape, dtype=object)
        for i in range(flat.shape[0]):
            out[i] = self._r.randrange(int(flat[i]))
        return out.reshape(shape)

    def units_below(self, bound, shape=()):
        """Uniform unit mod bound (gcd = 1), the from_modulo rejection loop
        (range_proofs.rs:543-552)."""
        b = np.asarray(bound, dtype=object)
        b = np.broadcast_to(b, shape) if shape else b

        def draw(v):
            while True:
                r = self._r.randrange(int(v))
                if math.gcd(r, int(v)) == 1:
                    return r

        if b.shape == ():
            return draw(int(b[()]))
        flat = b.reshape(-1)
        out = np.empty(flat.shape, dtype=object)
        for i in range(flat.shape[0]):
            out[i] = draw(flat[i])
        return out.reshape(b.shape)
