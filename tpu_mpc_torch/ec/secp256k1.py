"""Batched secp256k1: scalar field, Jacobian point batches and the routing to
the kernels (port of tpu_mpc/ec/secp256k1.py).

A point batch is Point(X, Y, Z) of [..., 16] int64 tensors of canonical
16-bit limbs (Jacobian: x = X/Z^2, y = Y/Z^3; Z == 0 marks infinity, stored
as (1, 1, 0)).  Scalars are [..., 16] canonical limbs < q.

Routing: scalar_mul, dual_mul -> K3; mul_generator, mul_base_point2 -> K4;
to_affine -> K5.  On the card every batch takes the kernels (they mask the
ragged edge themselves, so the reference's B % 128 rule falls away); on the
CPU the wrappers take the plain versions.  The reference's Jacobian XLA
ladders compute the same functions and are not ported.  point_add and
point_double run the same complete formulas as the kernels, in PyTorch ops.
"""

from __future__ import annotations

from typing import Any, NamedTuple

import numpy as np
import torch

from ..core import bigint as bi
from ..core.limbs import batch_from_limbs, batch_to_limbs, nlimbs
from ..core.modctx import prof_call
from ..core.montgomery import MontCtx, mod_mul
from ..device import device_key, resolve_device, to_numpy
from ..host import ec as hec
from . import pallas_ec as pe

L = nlimbs(256)  # 16 limbs

P_INT = hec.P
Q_INT = hec.N

_CONST: dict = {}


def _c(device) -> dict:
    key = device_key(device)
    c = _CONST.get(key)
    if c is None:
        t = lambda v, n=L: torch.as_tensor(
            batch_to_limbs(np.asarray(v, dtype=object), n), device=device)
        c = {
            "P": t(P_INT), "Q": t(Q_INT), "Q_CTX": MontCtx.from_int(Q_INT, L, device),
            "GX": t(hec.GX), "GY": t(hec.GY),
            "BP2X": t(hec.BASE_POINT2[0]), "BP2Y": t(hec.BASE_POINT2[1]),
            "LAM": t(GLV_LAMBDA), "NB1": t(_GLV_NB1), "NB2": t(Q_INT - _GLV_B2),
            "G1": t(_GLV_G1), "G2": t(_GLV_G2), "ONE": t(1),
        }
        _CONST[key] = c
    return c


# --------------------------------------------------------------------------
# scalar field (mod q)
# --------------------------------------------------------------------------

def sc_mul(a, b):
    return mod_mul(*torch.broadcast_tensors(a, b), _c(a.device)["Q_CTX"])


def sc_add(a, b):
    a, b = torch.broadcast_tensors(a, b)
    return bi.mod_add(a, b, _c(a.device)["Q"])


def sc_sub(a, b):
    a, b = torch.broadcast_tensors(a, b)
    return bi.mod_sub(a, b, _c(a.device)["Q"])


def sc_neg(a):
    return bi.mod_neg(a, _c(a.device)["Q"])


def sc_from_ints(xs, device=None):
    """Object ints -> [..., 16] scalar limbs (reduced mod q) on `device`."""
    xs = np.asarray(xs, dtype=object)
    red = np.vectorize(lambda v: int(v) % Q_INT, otypes=[object])(xs) if xs.size else xs
    return torch.as_tensor(batch_to_limbs(red, L), device=resolve_device(device))


# --------------------------------------------------------------------------
# points
# --------------------------------------------------------------------------

class Point(NamedTuple):
    """Jacobian point batch: x = X/Z^2, y = Y/Z^3; Z == 0 marks infinity."""

    X: Any
    Y: Any
    Z: Any


def point_infinity(batch_shape=(), device=None):
    dev = resolve_device(device)
    one = torch.zeros(tuple(batch_shape) + (L,), dtype=torch.int64, device=dev)
    one[..., 0] = 1
    return Point(one, one.clone(), torch.zeros_like(one))


def point_from_affine(x, y):
    one = torch.zeros_like(x)
    one[..., 0] = 1
    return Point(x, y, one)


def generator(batch_shape=(), device=None):
    c = _c(resolve_device(device))
    b = lambda a: a.expand(tuple(batch_shape) + (L,))
    return point_from_affine(b(c["GX"]), b(c["GY"]))


def base_point2(batch_shape=(), device=None):
    c = _c(resolve_device(device))
    b = lambda a: a.expand(tuple(batch_shape) + (L,))
    return point_from_affine(b(c["BP2X"]), b(c["BP2Y"]))


def _norm_inf(X, Y, Z) -> Point:
    """Store infinity as (1, 1, 0), the representation every routine reads."""
    inf = (Z == 0).all(-1, keepdim=True)
    one = _c(Z.device)["ONE"]
    return Point(torch.where(inf, one, X), torch.where(inf, one, Y), Z)


def _from_rows(out, batch) -> Point:
    rs = lambda a: a.reshape(tuple(batch) + (L,))
    return _norm_inf(rs(out[..., 0, :]), rs(out[..., 1, :]), rs(out[..., 2, :]))


def _batch(*tensors):
    return tuple(torch.broadcast_shapes(*(t.shape[:-1] for t in tensors)))


def point_add(p: Point, q: Point) -> Point:
    """Complete addition (handles infinity, P + P and P + (-P))."""
    batch = _batch(*p, *q)
    e = lambda t: t.expand(batch + (L,))
    h1 = pe.jac_in(*(e(c) for c in p))
    h2 = pe.jac_in(*(e(c) for c in q))
    return _from_rows(pe.jac_out(pe.rcb_add(h1, h2)), batch)


def point_double(p: Point) -> Point:
    batch = _batch(*p)
    h = pe.jac_in(*(c.expand(batch + (L,)) for c in p))
    return _from_rows(pe.jac_out(pe.rcb_dbl(h)), batch)


def point_neg(p: Point) -> Point:
    return Point(p.X, bi.mod_neg(p.Y, _c(p.Y.device)["P"]), p.Z)


def point_eq(p: Point, q: Point):
    """Equality in Jacobian coordinates (cross-multiplied) -> bool tensor."""
    batch = _batch(*p, *q)
    e = lambda t: t.expand(batch + (L,))
    X1, Y1, Z1 = (e(c) for c in p)
    X2, Y2, Z2 = (e(c) for c in q)
    z1z1, z2z2 = pe.fe_sq(Z1), pe.fe_sq(Z2)
    cn = pe.fe_canon
    x_eq = bi.eq(cn(pe.fe_mul(X1, z2z2)), cn(pe.fe_mul(X2, z1z1)))
    y_eq = bi.eq(cn(pe.fe_mul(pe.fe_mul(Y1, Z2), z2z2)),
                 cn(pe.fe_mul(pe.fe_mul(Y2, Z1), z1z1)))
    p_inf, q_inf = bi.is_zero(Z1), bi.is_zero(Z2)
    return (p_inf & q_inf) | (~p_inf & ~q_inf & x_eq & y_eq)


# ---- GLV endomorphism (j-invariant 0) -------------------------------------
GLV_LAMBDA = 0x5363AD4CC05C30E0A5261C028812645A122E22EA20816678DF02967C1B23BD72
GLV_BETA = pe.GLV_BETA
_GLV_NB1 = 0xE4437ED6010E88286F547FA90ABFE4C3       # -b1 (b1 < 0)
_GLV_B2 = 0x3086D221A7D46BCDE86C90E49284EB15        # = a1
_GLV_SHIFT = 384  # rounding division: c_i = (k * g_i + 2^383) >> 384
_GLV_G1 = ((_GLV_B2 << _GLV_SHIFT) + Q_INT // 2) // Q_INT
_GLV_G2 = ((_GLV_NB1 << _GLV_SHIFT) + Q_INT // 2) // Q_INT
GLV_WINDOWS = 33


def _glv_split(k):
    """Canonical k < q -> (|k1|, neg1, |k2|, neg2) with
    k = (-1)^neg1 |k1| + lambda (-1)^neg2 |k2| mod q and |k_i| < 2^129."""
    c = _c(k.device)

    def c_of(gl):
        cols = bi.pad_to(bi.mul_cols(k, gl.expand(k.shape)), 32)
        cols[..., 23] += 1 << 15                         # + 2^383 rounding
        return bi.pad_to(bi.carry_canon(cols)[..., 24:], L)  # >> 384

    c1 = c_of(c["G1"])
    c2 = c_of(c["G2"])
    k2 = sc_add(sc_mul(c1, c["NB1"]), sc_mul(c2, c["NB2"]))
    k1 = sc_sub(k, sc_mul(k2, c["LAM"]))

    def short(x):
        # valid shorts are < 2^129; the other branch is q - short > 2^255
        neg = ~bi.is_zero(x[..., 9:])
        return bi.select(neg, sc_neg(x), x), neg

    k1s, n1 = short(k1)
    k2s, n2 = short(k2)
    return k1s, n1, k2s, n2


def _flat(t, batch):
    n = int(np.prod(batch, dtype=np.int64)) if batch else 1
    return t.expand(tuple(batch) + (L,)).reshape(n, L)


def scalar_mul(k, p: Point) -> Point:
    """k * P, batched (K3 GLV ladder, ns = 2)."""
    batch = _batch(k, *p)
    kf, pf = _flat(k, batch), Point(*(_flat(c, batch) for c in p))
    out = prof_call("ec:smul", kf.shape[0], 256, lambda: pe.glv_mul(kf, pf))
    return _from_rows(torch.stack(list(out), -2), batch)


def mul_fixed_base(k, base_xy, label="ec:mulFB") -> Point:
    """k * B for a public fixed base (K4 8-bit comb); `label` is the launch
    log's kind."""
    batch = tuple(k.shape[:-1])
    kf = _flat(k, batch)
    out = prof_call(label, kf.shape[0], 256, lambda: pe.comb_mul(kf, base_xy))
    return _from_rows(torch.stack(list(out), -2), batch)


def mul_generator(k):
    return mul_fixed_base(k, hec.G, "ec:mulG")


def mul_base_point2(k):
    return mul_fixed_base(k, hec.BASE_POINT2, "ec:mulH2")


def dual_mul(ka, pa: Point, kb, pb: Point) -> Point:
    """ka * PA + kb * PB in one 4-stream GLV ladder (K3, ns = 4)."""
    batch = _batch(ka, kb, *pa, *pb)
    f = lambda t: _flat(t, batch)
    kaf, paf, kbf, pbf = f(ka), Point(*(f(c) for c in pa)), f(kb), Point(*(f(c) for c in pb))
    out = prof_call("ec:dmul", kaf.shape[0], 256, lambda: pe.dual_mul(kaf, paf, kbf, pbf))
    return _from_rows(torch.stack(list(out), -2), batch)


def to_affine(p: Point):
    """-> (x, y, is_inf); x, y are zero at infinity (K5)."""
    batch = _batch(*p)
    x, y, inf = pe.affine(Point(*(_flat(c, batch) for c in p)))
    rs = lambda a: a.reshape(tuple(batch) + (L,))
    return rs(x), rs(y), inf.reshape(tuple(batch))


def x_coord_mod_q(p: Point):
    """r = x(P) mod q — the ECDSA r extraction."""
    x, _, _ = to_affine(p)
    return bi.cond_sub(x, _c(x.device)["Q"])[..., :L]


# ---- point-batch utilities ------------------------------------------------

def _idx(indices, device):
    return torch.as_tensor(np.asarray(indices), dtype=torch.int64, device=device)


def point_take(p: Point, indices, axis: int) -> Point:
    """np.take semantics along a batch axis (indices may be an array)."""
    idx = np.asarray(indices)
    ax = axis % (p.X.dim() - 1)

    def tk(c):
        t = torch.index_select(c, ax, _idx(idx.reshape(-1), c.device))
        return t.reshape(c.shape[:ax] + idx.shape + c.shape[ax + 1:])

    return Point(*(tk(c) for c in p))


def point_index_axis(p: Point, k: int, axis: int) -> Point:
    return Point(*(c.select(axis, k) for c in p))


def point_expand(p: Point, axis: int) -> Point:
    return Point(*(c.unsqueeze(axis) for c in p))


def point_sum(p: Point, axis: int) -> Point:
    """Sum along a batch axis — pairwise tree reduction."""
    ax = axis % p.X.dim()
    while p.X.shape[ax] > 1:
        n = p.X.shape[ax]
        h = n // 2
        pair = point_add(Point(*(c.narrow(ax, 0, h) for c in p)),
                         Point(*(c.narrow(ax, n - h, h) for c in p)))
        if n % 2:
            pair = Point(*(torch.cat([a, c.narrow(ax, h, 1)], dim=ax)
                           for a, c in zip(pair, p)))
        p = pair
    return point_index_axis(p, 0, ax)


# ---- host bridges ---------------------------------------------------------

def points_to_host(p: Point):
    """Device point batch -> nested python affine tuples (None = infinity)."""
    n = int(np.prod(p.X.shape[:-1], dtype=np.int64)) if p.X.dim() > 1 else 1
    x, y, inf = prof_call("ec:affine", n, 256, lambda: to_affine(p))
    xs = np.asarray(batch_from_limbs(x), dtype=object)
    ys = np.asarray(batch_from_limbs(y), dtype=object)
    infs = to_numpy(inf)
    fx, fy, fi = xs.reshape(-1), ys.reshape(-1), infs.reshape(-1)
    out = np.empty(fx.shape[0], dtype=object)
    for i in range(fx.shape[0]):
        out[i] = None if fi[i] else (int(fx[i]), int(fy[i]))
    return out.reshape(infs.shape) if infs.shape else out[0]


def _is_point_leaf(p):
    return p is None or (isinstance(p, tuple) and len(p) == 2 and isinstance(p[0], int))


def _flatten_pts(pts):
    if _is_point_leaf(pts):
        return [pts], ()
    subs = [_flatten_pts(p) for p in pts]
    inner = subs[0][1]
    return [leaf for s, _ in subs for leaf in s], (len(subs),) + inner


def points_from_host(pts, device=None) -> Point:
    """Nested python affine tuples (None = infinity) -> device point batch."""
    flat, shape = _flatten_pts(pts)
    X = np.zeros((len(flat), L), np.int64)
    Y = np.zeros((len(flat), L), np.int64)
    Z = np.zeros((len(flat), L), np.int64)
    for i, pt in enumerate(flat):
        if pt is None:
            X[i, 0] = Y[i, 0] = 1
        else:
            X[i] = batch_to_limbs(pt[0], L)
            Y[i] = batch_to_limbs(pt[1], L)
            Z[i, 0] = 1
    dev = resolve_device(device)
    rs = lambda a: torch.as_tensor(a.reshape(shape + (L,)) if shape else a[0], device=dev)
    return Point(rs(X), rs(Y), rs(Z))


def points_to_host_list(p: Point):
    out = points_to_host(p)
    return out.tolist() if isinstance(out, np.ndarray) else out
