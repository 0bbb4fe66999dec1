"""Limbed big-integer primitives in PyTorch ops (port of tpu_mpc/core/bigint.py).

Used at 256 bits only: the secp256k1 scalar field (ec/secp256k1.py) and the
GLV split.  Values are [..., L] int64 tensors of canonical 16-bit limbs,
little-endian; column forms (before carry) hold wider non-negative limbs.
"""

from __future__ import annotations

import torch

LIMB_MASK = 0xFFFF


def pad_to(a, L: int):
    """Zero-pad (or keep) the limb axis to length L."""
    n = a.shape[-1]
    if n >= L:
        return a
    return torch.nn.functional.pad(a, (0, L - n))


_IDX: dict = {}


def mul_cols(a, b):
    """Schoolbook product columns [..., La+Lb-1] (no carries)."""
    La, Lb = a.shape[-1], b.shape[-1]
    key = (La, Lb, str(a.device))
    idx = _IDX.get(key)
    if idx is None:
        idx = (torch.arange(La, device=a.device)[:, None]
               + torch.arange(Lb, device=a.device)[None, :]).reshape(-1)
        _IDX[key] = idx
    prod = a[..., :, None] * b[..., None, :]
    shape = torch.broadcast_shapes(a.shape[:-1], b.shape[:-1])
    out = torch.zeros(shape + (La + Lb - 1,), dtype=torch.int64, device=a.device)
    return out.index_add_(-1, idx, prod.reshape(shape + (La * Lb,)))


def carry_canon(cols):
    """Column form -> canonical 16-bit limbs of the same length (the carry
    out of the last limb is dropped; callers size the columns)."""
    out = []
    c = torch.zeros_like(cols[..., 0])
    for i in range(cols.shape[-1]):
        v = cols[..., i] + c
        out.append(v & LIMB_MASK)
        c = v >> 16
    return torch.stack(out, dim=-1)


def mul(a, b):
    """Full product, canonical limbs [..., La+Lb]."""
    return carry_canon(pad_to(mul_cols(a, b), a.shape[-1] + b.shape[-1]))


def add(a, b):
    """(a + b) with one extra limb for the carry."""
    L = max(a.shape[-1], b.shape[-1]) + 1
    return carry_canon(pad_to(a, L) + pad_to(b, L))


def sub(a, b):
    """(a - b mod 2^(16L), borrow) for equal-length canonical limbs."""
    out = []
    bw = torch.zeros_like(a[..., 0])
    for i in range(a.shape[-1]):
        v = a[..., i] - b[..., i] - bw
        out.append(v & LIMB_MASK)
        bw = (v < 0).to(torch.int64)
    return torch.stack(out, dim=-1), bw


def is_zero(a):
    return (a == 0).all(dim=-1)


def eq(a, b):
    return (a == b).all(dim=-1)


def select(mask, a, b):
    """mask [...] bool: a where mask else b (limb axis broadcast)."""
    return torch.where(mask[..., None], a, b)


def cond_sub(a, n):
    """a - n if a >= n else a (a may carry one extra limb)."""
    L = a.shape[-1]
    d, bw = sub(a, pad_to(n.expand(a.shape[:-1] + n.shape[-1:]), L))
    return select(bw == 0, d, a)


def mod_add(a, b, n):
    """(a + b) mod n for a, b < n."""
    L = a.shape[-1]
    return cond_sub(add(a, b), n)[..., :L]


def mod_sub(a, b, n):
    """(a - b) mod n for a, b < n."""
    d, bw = sub(a, b)
    wrapped = add(d, n.expand(d.shape))[..., :d.shape[-1]]
    return select(bw == 1, wrapped, d)


def mod_neg(a, n):
    """(-a) mod n for a < n (0 stays 0)."""
    d, _ = sub(n.expand(a.shape), a)
    return select(is_zero(a), a, d)
