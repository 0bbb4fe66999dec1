"""Montgomery multiplication in PyTorch ops (port of tpu_mpc/core/montgomery.py).

Used at 256 bits only, for the secp256k1 scalar field: the Paillier-width
modexps of the port all run through RNS (core/rns.py, kernel K1).  One
shared modulus per context; R = 2^(16 L).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from . import bigint as bi
from .limbs import batch_to_limbs


@dataclasses.dataclass
class MontCtx:
    """n, n' = -n^{-1} mod R, R^2 mod n: [L] limb tensors on one device."""

    n: torch.Tensor
    nprime: torch.Tensor
    r2: torch.Tensor

    @property
    def L(self) -> int:
        return self.n.shape[-1]

    @classmethod
    def from_int(cls, n: int, L: int, device) -> "MontCtx":
        R = 1 << (16 * L)
        t = lambda v: torch.as_tensor(batch_to_limbs(np.asarray(v, dtype=object), L),
                                      device=device)
        return cls(n=t(n), nprime=t((-pow(n, -1, R)) % R), r2=t(R * R % n))


def mont_mul(a, b, ctx: MontCtx):
    """a*b*R^{-1} mod n for a, b < n (REDC on full products)."""
    L = ctx.L
    T = bi.mul(a, b)                                   # [..., 2L]
    m = bi.mul(T[..., :L], ctx.nprime)[..., :L]        # T*n' mod R
    U = bi.add(T, bi.mul(m, ctx.n))                    # [..., 2L+1], R | U
    return bi.cond_sub(U[..., L:], ctx.n)[..., :L]


def to_mont(a, ctx: MontCtx):
    return mont_mul(a, ctx.r2.expand(a.shape), ctx)


def mod_mul(a, b, ctx: MontCtx):
    """a*b mod n."""
    return mont_mul(to_mont(a, ctx), b, ctx)
