"""The GG18 helpers the GG20 signing path imports (port of the parts of
tpu_mpc/protocols/gg18/batch.py it needs)."""

from __future__ import annotations

import numpy as np

from ...ec import secp256k1 as dec
from ...paillier import paillier as dp


def _sc(x, device):
    return dec.sc_from_ints(np.asarray(x, dtype=object), device)


def _dk_take(dk: dp.BatchDecryptionKey, indices, axis: int) -> dp.BatchDecryptionKey:
    return dk.map(lambda a: np.take(a, indices, axis=axis))
