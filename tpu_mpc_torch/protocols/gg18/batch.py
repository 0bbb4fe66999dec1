"""The GG18 helpers the GG20 path imports (port of the parts of
tpu_mpc/protocols/gg18/batch.py it needs: _sc, _dk_take and
gen_paillier_batch)."""

from __future__ import annotations

import numpy as np

from ...ec import secp256k1 as dec
from ...host import primes
from ...paillier import paillier as dp
from ...utils.rng import SessionRng


def _sc(x, device):
    return dec.sc_from_ints(np.asarray(x, dtype=object), device)


def _dk_take(dk: dp.BatchDecryptionKey, indices, axis: int) -> dp.BatchDecryptionKey:
    return dk.map(lambda a: np.take(a, indices, axis=axis))


def gen_paillier_batch(S: int, n: int, bits: int, rng: SessionRng, safe: bool = False):
    """Paillier prime factors (p, q), each [S, n], for every (session, party)
    slot: 2*S*n primes of bits/2 bits, one seed per prime drawn from rng in
    the reference's order (p and q alternate), searched across host
    processes (host/primes.py).  safe=True draws safe primes p = 2p' + 1."""
    gen = primes.gen_safe_primes_parallel if safe else primes.gen_primes_parallel
    flat = gen(bits // 2, 2 * S * n, rng._r)
    ps = np.asarray(flat[0::2], dtype=object).reshape(S, n)
    qs = np.asarray(flat[1::2], dtype=object).reshape(S, n)
    return ps, qs
