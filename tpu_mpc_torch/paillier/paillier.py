"""Batched Paillier (port of tpu_mpc/paillier/paillier.py's public API).

  encrypt   c = (1 + m n) r^n mod n^2          (g = n + 1)
  decrypt   CRT: c^{p-1} mod p^2 and c^{q-1} mod q^2 in one stacked K1
            launch, then the L-functions and the recombination on host ints
  add       c1 c2 mod n^2
  add_plain c (1 + m n) mod n^2
  mul_plain c^k mod n^2

Every session/party slot carries its own modulus.  The reference runs its
modexps on the CIOS limb path (tpu_mpc/core/montgomery.py:mont_exp) over
limb arrays; the port takes and returns object-int arrays and routes every
modexp through ModCtx, i.e. kernel K1 (the CUDA kernel on the card, its
plain PyTorch version on the CPU): the same integers.  The two products
(add, add_plain) are host multiplies, as everywhere in the port's hybrid
split (core/modctx.py).  Key generation (prime search) is host-side:
host/paillier.py, protocols/gg18/batch.py:gen_paillier_batch.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from ..core.modctx import ModCtx, host_mulmod, resolve
from ..zk.range_proofs import PaillierCtxBatch, crt_decrypt, crt_h

# The public key batch: n and the device ctxs for n and n^2
# (PaillierCtxBatch.from_ints(ns, bits, device)); the MtA and the proofs
# take the same object.
BatchEncryptionKey = PaillierCtxBatch


@dataclasses.dataclass
class BatchDecryptionKey:
    """Secret keys for a batch: the CRT factors p, q as object ints.

    The decryption material (the ctx of the moduli (p^2, q^2) on `device`,
    default "cuda", and the CRT multipliers) is built on the first decrypt
    and cached; views made by `map` rebuild it."""

    p: np.ndarray
    q: np.ndarray
    bits: int = 2048
    device: object = None
    _crt: tuple | None = dataclasses.field(default=None, repr=False, compare=False)

    @classmethod
    def from_ints(cls, ps, qs, bits: int = 2048, device=None) -> "BatchDecryptionKey":
        return cls(p=np.asarray(ps, dtype=object), q=np.asarray(qs, dtype=object), bits=bits,
                   device=device)

    def map(self, fn) -> "BatchDecryptionKey":
        return BatchDecryptionKey(p=fn(self.p), q=fn(self.q), bits=self.bits, device=self.device)

    def crt(self) -> tuple:
        """(ctx over (p^2, q^2) [2, ...batch], hp, hq, p^{-1} mod q)."""
        if self._crt is None:
            vec = lambda f, *a: np.vectorize(f, otypes=[object])(*a)
            n = self.p * self.q
            self._crt = (
                ModCtx.from_ints(np.stack([self.p * self.p, self.q * self.q]), self.bits,
                                 self.device),
                vec(crt_h, n, self.p), vec(crt_h, n, self.q),
                vec(lambda a, b: pow(int(a), -1, int(b)), self.p, self.q),
            )
        return self._crt


def encrypt(ek: BatchEncryptionKey, m, r, rn=None) -> np.ndarray:
    """E(m; r) = (1 + m n) r^n mod n^2 (m < n, r < n): r^n on the key
    owner's CRT half-width path when the sk is attached, else one K1 launch
    at the width of n^2.  rn: r^n already computed (randomizer-table
    sampling, PaillierCtxBatch.sample_unit_with_power); r is then not read
    (it may be a DeferredLaunch, whose np.shape is ())."""
    m = np.asarray(m, dtype=object)
    shape = np.broadcast_shapes(m.shape, np.shape(r), ek.n_ctx.batch_shape)
    n = np.broadcast_to(ek.n, shape)
    if rn is not None:
        rn = resolve(rn)
    elif ek.sk_ctx is not None:
        rn = ek.pow_n_sk(r)
    else:
        rn = ek.nn_ctx.pow(r, n, ebits_hint=ek.n_ctx.bits)
    return host_mulmod(np.broadcast_to(m, shape) * n + 1, rn, np.broadcast_to(ek.nn, shape))


def decrypt(dk: BatchDecryptionKey, c, sync: bool = True):
    """CRT Paillier decryption of c (object ints < n^2, batch broadcastable
    against the key's) -> m < n; sync=False returns a lazy handle."""
    ctx, hp, hq, pinv_q = dk.crt()
    return crt_decrypt(ctx, dk.p, dk.q, hp, hq, pinv_q, c, dk.bits, np.shape(dk.p), sync=sync)


def ciphertext_add(ek: BatchEncryptionKey, c1, c2) -> np.ndarray:
    """E(m1) (+) E(m2) = c1 c2 mod n^2."""
    return host_mulmod(c1, c2, ek.nn)


def ciphertext_add_plain(ek: BatchEncryptionKey, c, m) -> np.ndarray:
    """E(m1) (+) m = c (1 + m n) mod n^2."""
    m = np.asarray(m, dtype=object)
    return host_mulmod(c, m * ek.n + 1, ek.nn)


def ciphertext_mul_plain(ek: BatchEncryptionKey, c, k, ebits: int = 256) -> np.ndarray:
    """E(m) (*) k = c^k mod n^2 (k < 2^ebits): one K1 launch."""
    return ek.nn_ctx.pow(c, k, ebits_hint=ebits)
