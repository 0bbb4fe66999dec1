"""Batched Fiat-Shamir hashing (port of tpu_mpc/hashes/fiat_shamir.py).

The curv convention: each value is appended as its minimal big-endian byte
string; EC points as 33-byte SEC1 compressed, equivalent to chaining the
int ((2 + y parity) << 256) | x.  Digests are byte-identical to the
reference's.
"""

from __future__ import annotations

import hashlib
import time

import numpy as np
import torch

from ..core import modctx as _m
from ..device import to_numpy
from ..ec import secp256k1 as ec
from ..host import ec as hec
from ..host.serde import bigint_to_bytes

Q = hec.N


def point_hash_ints(P: ec.Point) -> np.ndarray:
    """Device point batch -> object array of ints (compressed-bytes-as-int)."""
    return point_hash_ints_many(P)[0]


def point_hash_ints_many(*Ps: ec.Point) -> list:
    """Compressed-int encodings of several point batches in ONE to_affine
    launch and one host read."""
    batch = tuple(torch.broadcast_shapes(*(p.X.shape[:-1] for p in Ps)))
    Lc = Ps[0].X.shape[-1]
    stacked = ec.Point(*(
        torch.stack([getattr(p, c).expand(batch + (Lc,)) for p in Ps])
        for c in ("X", "Y", "Z")
    ))
    n = len(Ps) * (int(np.prod(batch, dtype=np.int64)) if batch else 1)
    x, y, inf = _m.prof_call("ec:hashpts", n, 256, lambda: ec.to_affine(stacked))
    xs = to_numpy(x)
    parity = to_numpy(y[..., 0] & 1)
    infs = to_numpy(inf)
    outs = []
    for i in range(len(Ps)):
        fx = xs[i].reshape(-1, Lc)
        fp = parity[i].reshape(-1)
        fi = infs[i].reshape(-1)
        o = np.empty(fx.shape[0], dtype=object)
        for b in range(fx.shape[0]):
            if fi[b]:
                raise ValueError("cannot serialize the identity point")
            xb = int.from_bytes(fx[b].astype("<u2").tobytes(), "little")
            o[b] = ((2 + int(fp[b])) << 256) | xb
        outs.append(o.reshape(batch) if batch else o[0])
    return outs


def digest_rows(*columns, reduce_mod=None) -> np.ndarray:
    """SHA-256 over rows of chained big-endian-encoded ints; columns
    broadcast to a common batch shape."""
    t0 = time.perf_counter() if _m.PROFILE else 0.0
    cols = [np.asarray(c, dtype=object) for c in columns]
    shape = np.broadcast_shapes(*(c.shape for c in cols))
    flat = [np.broadcast_to(c, shape).reshape(-1) for c in cols]
    n = flat[0].shape[0] if shape else 1
    out = np.empty(n, dtype=object)
    for i in range(n):
        h = hashlib.sha256()
        for c in flat:
            h.update(bigint_to_bytes(int(c[i])))
        v = int.from_bytes(h.digest(), "big")
        out[i] = v % reduce_mod if reduce_mod else v
    if _m.PROFILE:
        _m.PROFILE_LOG.append(("host:digest", n * len(flat), 0, "-",
                               time.perf_counter() - t0))
    return out.reshape(shape) if shape else out[0]


def commit_rows(msg_ints, blind_ints) -> np.ndarray:
    """Batched curv HashCommitment: H(message || blinding)."""
    return digest_rows(msg_ints, blind_ints)
