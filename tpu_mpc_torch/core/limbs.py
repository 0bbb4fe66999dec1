"""Limb representation of big integers (port of tpu_mpc/core/limbs.py).

A W-bit unsigned integer is stored little-endian as L = W/16 limbs of 16
bits.  This module is the host-side bridge: python int <-> numpy limb
arrays; torch tensors are accepted wherever an array is read.
"""

from __future__ import annotations

import time

import numpy as np

from . import modctx as _m

LIMB_BITS = 16
LIMB_MASK = (1 << LIMB_BITS) - 1


def nlimbs(bits: int) -> int:
    """Number of 16-bit limbs for a width of `bits` bits."""
    return (bits + LIMB_BITS - 1) // LIMB_BITS


def _as_np(a):
    from ..device import to_numpy

    return to_numpy(a)


def from_limbs(a) -> int:
    """Decode a 1-D little-endian limb array into a python int (entries may
    exceed 16 bits: each is weighted by 2^(16 i))."""
    a = _as_np(a)
    if a.ndim == 1 and bool(np.all((a >= 0) & (a <= LIMB_MASK))):
        return int.from_bytes(a.astype("<u2").tobytes(), "little")
    x = 0
    for i in reversed(range(a.shape[-1])):
        x = (x << LIMB_BITS) + int(a[..., i])
    return x


def batch_to_limbs(xs, L: int) -> np.ndarray:
    """Encode a (nested) array of python ints into an [..., L] int64 array."""
    t0 = time.perf_counter() if _m.PROFILE else 0.0
    arr = np.asarray(xs, dtype=object)
    flat = arr.reshape(-1)
    buf = b"".join(int(v).to_bytes(2 * L, "little") for v in flat.tolist())
    out = np.frombuffer(buf, dtype="<u2").astype(np.int64)
    if _m.PROFILE:
        _m.PROFILE_LOG.append(("host:to_limbs", flat.shape[0], L * 16, "-",
                               time.perf_counter() - t0))
    return out.reshape(arr.shape + (L,))


def batch_from_limbs(a) -> np.ndarray:
    """Decode an [..., L] limb array (numpy or tensor) into object ints."""
    t0 = time.perf_counter() if _m.PROFILE else 0.0
    a = _as_np(a)
    lead = a.shape[:-1]
    flat = a.reshape(-1, a.shape[-1])
    out = np.empty(flat.shape[0], dtype=object)
    if bool(np.all((flat >= 0) & (flat <= LIMB_MASK))):
        buf = flat.astype("<u2").tobytes()
        k = 2 * flat.shape[1]
        for i in range(flat.shape[0]):
            out[i] = int.from_bytes(buf[i * k:(i + 1) * k], "little")
    else:
        for i in range(flat.shape[0]):
            out[i] = from_limbs(flat[i])
    if _m.PROFILE:
        _m.PROFILE_LOG.append(("host:from_limbs", flat.shape[0], flat.shape[1] * 16, "-",
                               time.perf_counter() - t0))
    return out.reshape(lead) if lead else out[0]
