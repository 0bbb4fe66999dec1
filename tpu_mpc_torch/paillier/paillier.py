"""Paillier key material for the signing path (port of the parts of
tpu_mpc/paillier/paillier.py the port needs).

Decryption runs through zk/range_proofs.py:PaillierCtxBatch.decrypt_sk on
the ModCtx path (kernel K1), as the reference does whenever RNS is on
(tpu_mpc/mta/mta.py:244-256), so the decryption key only carries the
prime factors as host ints.
"""

from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass
class BatchDecryptionKey:
    """Secret keys for a batch (the CRT factors p, q as object ints)."""

    p: np.ndarray
    q: np.ndarray

    @classmethod
    def from_ints(cls, ps, qs, bits: int = 2048) -> "BatchDecryptionKey":
        return cls(p=np.asarray(ps, dtype=object), q=np.asarray(qs, dtype=object))

    def map(self, fn) -> "BatchDecryptionKey":
        return BatchDecryptionKey(p=fn(self.p), q=fn(self.q))
