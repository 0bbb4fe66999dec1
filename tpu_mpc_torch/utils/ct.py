"""Constant-time comparison + secret scrubbing (port of tpu_mpc/utils/ct.py).

The reference uses `subtle::ConstantTimeEq` for the Lindell'17 signature
r-check (party_one.rs:585) and `zeroize` to scrub MtA ZKP round-1 secrets on
drop (range_proofs.rs:26-27,197-198).  Python has no exact equivalents:

* equality — `hmac.compare_digest` over fixed-width encodings gives the
  constant-time contract the stdlib maintains for secrets;
* scrubbing — python ints are immutable, so `scrub_array` zeroes mutable
  buffers (uint limb arrays) in place and drops object references; freed
  CPython int digits may survive in the allocator.  This weaker guarantee is
  documented in THREAT_MODEL.md §2.
"""

from __future__ import annotations

import hmac

import numpy as np


def ct_eq_bytes(a: bytes, b: bytes) -> bool:
    """Constant-time byte-string equality (stdlib compare_digest contract)."""
    return hmac.compare_digest(a, b)


def ct_eq_int(a: int, b: int, width_bits: int = 256) -> bool:
    """Constant-time equality of two non-negative ints, compared at a fixed
    width so the comparison time does not depend on where they differ."""
    nbytes = (width_bits + 7) // 8
    try:
        return hmac.compare_digest(a.to_bytes(nbytes, "big"), b.to_bytes(nbytes, "big"))
    except OverflowError:  # wider than the fixed width -> plainly unequal
        return False


def ct_eq_int_batch(a, b, width_bits: int = 256) -> np.ndarray:
    """Element-wise ct_eq_int over object ndarrays -> bool ndarray."""
    a = np.asarray(a, dtype=object)
    b = np.asarray(b, dtype=object)
    shape = np.broadcast_shapes(a.shape, b.shape)
    af = np.broadcast_to(a, shape).reshape(-1)
    bf = np.broadcast_to(b, shape).reshape(-1)
    out = np.empty(af.shape[0], dtype=bool)
    for i in range(af.shape[0]):
        out[i] = ct_eq_int(int(af[i]), int(bf[i]), width_bits)
    return out.reshape(shape)


def scrub_array(*arrays) -> None:
    """Best-effort zeroize: mutable numeric ndarrays are zeroed in place;
    object ndarrays have their int references replaced with 0.  Lazy launch
    handles (LazyInts/RnsLazy/LazyMap/DeferredLaunch, anything exposing
    .ints()) are recognised: their resolved caches are scrubbed and the
    handle is defused so a later .ints() cannot re-materialize the secret
    (ADVICE r4: np.asarray on a handle used to wrap it in a 0-d object
    array, silently skipping it)."""
    for a in arrays:
        if a is None:
            continue
        if hasattr(a, "ints"):        # lazy handle, not an ndarray
            cache = getattr(a, "_cache", None)
            if cache is not None:
                scrub_array(cache)
                a._cache = None
            src = getattr(a, "src", None)
            if src is not None:
                scrub_array(src)
            for attr in ("dev", "parts", "fn"):
                if hasattr(a, attr):
                    try:
                        setattr(a, attr, None)   # defuse re-materialization
                    except Exception:
                        pass
            continue
        arr = np.asarray(a)
        if arr.dtype == object:
            flat = arr.reshape(-1)
            for i in range(flat.shape[0]):
                if hasattr(flat[i], "ints"):
                    scrub_array(flat[i])
                flat[i] = 0
        elif arr.flags.writeable:
            arr.fill(0)
