"""K3, K4, K5 — the secp256k1 kernels: wrappers, plain versions and the
relaxed-limb field they share (port of tpu_mpc/ec/pallas_ec.py).

  K3 glv_mul / dual_mul  replaces pallas_ec.py:_ladder_kernel  (csrc/ec_kernels.cu)
  K4 comb_mul            replaces pallas_ec.py:_comb_kernel    (csrc/ec_kernels.cu)
  K5 affine              replaces pallas_ec.py:_affine_kernel  (csrc/ec_kernels.cu)

K4 reads each base's comb table as u8 planes in tensor-core fragment order
(comb_planes, cached per base and device); comb_plain reads the int32 table.
ladder_call, comb_call and affine_call split their lanes over the active
sessions mesh (sharding/mesh.py:launch; no mesh, one piece); *_launch
launches a piece.

Point algebra is the Renes-Costello-Batina complete projective formulas
(a = 0, b3 = 21): no exception branches, identity (0:1:0).  Jacobian inputs
enter as homogeneous (XZ, Y, Z^3) and leave as canonical Jacobian
(UW, VW^2, W), Z = 0 for infinity.  Because every step is exact arithmetic
mod p, the kernels (8 x 32-bit limbs, fully reduced) and the plain versions
here (16 relaxed 16-bit limbs in int64) give the same canonical outputs bit
for bit when they run the same formulas in the same order.

Relaxed field (plain side): [..., 16] int64 limbs, each < 2^17 between
operations; value = sum l_i 2^(16 i), congruent to the element mod p.  A
product accumulates 31 columns (< 2^38), folds 2^256 = 2^32 + 977 (< 2^49),
then four vectorized carry passes bring every limb back under 2^17 (three
suffice from 2^49: the bound is worked through in _renorm).  Canonical
limbs are produced only where a value leaves the algebra.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from .. import kernels
from ..device import device_key
from ..host import ec as hec
from ..sharding import mesh as sharding

L = 16               # 16-bit limbs per field element
NENT = 16            # 4-bit window entries (GLV ladders)
GLV_WINDOWS = 33     # ceil(129/4): covers the GLV split bound
COMB_W = 8           # fixed-base comb window bits
COMB_NW = 256 // COMB_W
COMB_NENT = 1 << COMB_W

P_INT = hec.P
B3 = 21              # 3*b for b = 7
GLV_BETA = 0x7AE96A2B657C07106E64479EAC3434E99CF0497512F58995C1396C28719501EE


def _limbs16(v: int) -> np.ndarray:
    return np.asarray([(v >> (16 * i)) & 0xFFFF for i in range(L)], np.int64)


def _msub_limbs() -> np.ndarray:
    """3p as 16 limbs each in [2^17, 2^18): a + MSUB - b stays non-negative
    for any relaxed b (limbs < 2^17)."""
    V = 3 * P_INT
    limbs = []
    for _ in range(L - 1):
        lj = (V & 0xFFFF) + (1 << 17)
        limbs.append(lj)
        V = (V - lj) >> 16
    assert (1 << 17) <= V < (1 << 18)
    limbs.append(V)
    assert sum(v << (16 * i) for i, v in enumerate(limbs)) == 3 * P_INT
    return np.asarray(limbs, np.int64)


_CONSTS: dict = {}


def _consts(device) -> dict:
    key = device_key(device)
    c = _CONSTS.get(key)
    if c is None:
        t = lambda a: torch.as_tensor(np.asarray(a, np.int64), device=device)
        fold = np.zeros(L, np.int64)
        fold[0], fold[2] = 977, 1
        idx = (np.arange(L)[:, None] + np.arange(L)[None, :]).reshape(-1)
        c = {
            "p": t(_limbs16(P_INT)), "msub": t(_msub_limbs()),
            "beta": t(_limbs16(GLV_BETA)), "fold": t(fold),
            "one": t(_limbs16(1)), "idx": t(idx),
            "pm2_digits": [((P_INT - 2) >> (4 * i)) & 0xF for i in range(64)],
        }
        _CONSTS[key] = c
    return c


# --------------------------------------------------------------------------
# relaxed-limb field arithmetic (plain side)
# --------------------------------------------------------------------------

def _renorm(x, passes: int):
    """One carry pass per iteration, fully vectorized: limb i keeps its low
    16 bits plus limb i-1's high part; the top limb's high part folds back as
    977 at limb 0 and 1 at limb 2 (2^256 = 2^32 + 977 mod p).  From limbs
    < 2^49: after pass 1 limb 0 < 2^43 and the rest < 2^34; after pass 2
    limb 0 < 2^28, limb 1 < 2^28, the rest < 2^19; after pass 3 every limb
    is < 2^17."""
    fold = _consts(x.device)["fold"]
    for _ in range(passes):
        hi = x >> 16
        x = (x & 0xFFFF) + torch.nn.functional.pad(hi[..., :-1], (1, 0)) \
            + hi[..., -1:] * fold
    return x


def fe_add(a, b):
    return _renorm(a + b, 1)          # < 2^18 in: one pass suffices


def fe_sub(a, b):
    return _renorm(a + _consts(a.device)["msub"] - b, 1)   # < 2^19 in


def fe_neg(b):
    return _renorm(_consts(b.device)["msub"] - b, 1)


def fe_muli(a, c: int):
    return _renorm(a * c, 2)          # c <= 24: < 2^22 in


def fe_mul(a, b):
    """Relaxed product mod p; a, b broadcast over leading dims."""
    c = _consts(a.device)
    a, b = torch.broadcast_tensors(a, b)
    shape = a.shape[:-1]
    prod = (a[..., :, None] * b[..., None, :]).reshape(shape + (L * L,))
    cols = torch.zeros(shape + (2 * L,), dtype=torch.int64, device=a.device)
    cols.index_add_(-1, c["idx"], prod)              # 31 used columns < 2^38
    lo, hi = cols[..., :L], cols[..., L:]            # hi: columns 16..31
    # hi_j * 2^(16 (j+16)) = hi_j 2^(16 j) (977 + 2^32)
    x = lo + hi * 977 + torch.nn.functional.pad(hi[..., :L - 2], (2, 0))
    x = x + hi[..., L - 2:L - 1] * c["fold"]         # column 30 -> limb 16 -> fold
    # hi[..., 15] (column 31) is always zero
    return _renorm(x, 4)


def fe_sq(a):
    return fe_mul(a, a)


def fe_canon(x):
    """Relaxed (limbs < 2^17) -> canonical limbs (< p)."""
    p = _consts(x.device)["p"]

    def carry(v):
        out = []
        cr = torch.zeros_like(v[..., 0])
        for i in range(L):
            t = v[..., i] + cr
            out.append(t & 0xFFFF)
            cr = t >> 16
        return torch.stack(out, -1), cr

    y, cr = carry(x)
    fold = _consts(x.device)["fold"]
    for _ in range(2):
        y, cr = carry(y + cr[..., None] * fold)
    # y < 2^256 < 2p: one conditional subtract
    out = []
    bw = torch.zeros_like(y[..., 0])
    for i in range(L):
        t = y[..., i] - p[i] - bw
        out.append(t & 0xFFFF)
        bw = (t < 0).to(torch.int64)
    d = torch.stack(out, -1)
    return torch.where((bw == 0)[..., None], d, y)


# --------------------------------------------------------------------------
# complete projective point algebra (RCB 2015, a = 0, b3 = 21)
# --------------------------------------------------------------------------

def _stack_mul(pairs):
    a = torch.stack(torch.broadcast_tensors(*[p[0] for p in pairs]))
    b = torch.stack(torch.broadcast_tensors(*[p[1] for p in pairs]))
    a, b = torch.broadcast_tensors(a, b)
    out = fe_mul(a, b)
    return [out[i] for i in range(len(pairs))]


def rcb_add(P1, P2):
    """Complete addition (alg. 7): 12 mul + 2 small-constant mul."""
    X1, Y1, Z1 = P1
    X2, Y2, Z2 = P2
    t0, t1, t2, t3, t4, t5 = _stack_mul([
        (X1, X2), (Y1, Y2), (Z1, Z2),
        (fe_add(X1, Y1), fe_add(X2, Y2)),
        (fe_add(Y1, Z1), fe_add(Y2, Z2)),
        (fe_add(X1, Z1), fe_add(X2, Z2)),
    ])
    t3 = fe_sub(fe_sub(t3, t0), t1)            # X1Y2 + X2Y1
    t4 = fe_sub(fe_sub(t4, t1), t2)            # Y1Z2 + Y2Z1
    t5 = fe_sub(fe_sub(t5, t0), t2)            # X1Z2 + X2Z1
    t0_3 = fe_add(fe_add(t0, t0), t0)          # 3 X1X2
    t2b = fe_muli(t2, B3)                      # b3 Z1Z2
    zt = fe_add(t1, t2b)
    t1m = fe_sub(t1, t2b)
    yb = fe_muli(t5, B3)                       # b3 (X1Z2 + X2Z1)
    m0, m1, m2, m3, m4, m5 = _stack_mul([
        (t3, t1m), (t4, yb), (t1m, zt), (yb, t0_3), (zt, t4), (t0_3, t3),
    ])
    return fe_sub(m0, m1), fe_add(m2, m3), fe_add(m4, m5)


def rcb_dbl(P):
    """Complete doubling (alg. 9): 8 mul + 1 small-constant mul."""
    X, Y, Z = P
    t0, t1, zz, xy = _stack_mul([(Y, Y), (Y, Z), (Z, Z), (X, Y)])
    z3 = fe_add(t0, t0)
    z3 = fe_add(z3, z3)
    z3 = fe_add(z3, z3)                        # 8 Y^2
    t2 = fe_muli(zz, B3)                       # b3 Z^2
    y3 = fe_add(t0, t2)
    t1b = fe_add(t2, t2)
    t2b = fe_add(t1b, t2)
    t0b = fe_sub(t0, t2b)
    x3, z3n, ty, tx = _stack_mul([(t2, z3), (t1, z3), (t0b, y3), (t0b, xy)])
    y3 = fe_add(x3, ty)
    return fe_add(tx, tx), y3, z3n


def identity(shape, device):
    z = torch.zeros(tuple(shape) + (L,), dtype=torch.int64, device=device)
    one = z.clone()
    one[..., 0] = 1
    return z, one, z.clone()


def jac_in(X, Y, Z):
    """Jacobian (X, Y, Z) -> homogeneous (XZ, Y, Z^3)."""
    xz, zz = _stack_mul([(X, Z), (Z, Z)])
    return xz, Y, fe_mul(zz, Z)


def jac_out(P):
    """Homogeneous (U, V, W) -> canonical Jacobian [..., 3, 16]
    (UW, VW^2, W); the identity (W = 0) maps to Z = 0."""
    U, V, W = P
    xo, ww = _stack_mul([(U, W), (W, W)])
    yo = fe_mul(V, ww)
    return torch.stack([fe_canon(xo), fe_canon(yo), fe_canon(W)], dim=-2)


# --------------------------------------------------------------------------
# K3: GLV window ladder (ns = 2 or 4 digit streams)
# --------------------------------------------------------------------------

def ladder_plain(pts, dg, neg):
    """pts [B, ns/2, 3, 16] canonical Jacobian bases; dg [B, ns, 33] 4-bit
    window digits (LSB-first); neg [B, ns] GLV signs.  -> [B, 3, 16]
    canonical Jacobian of sum_s (+-)phi^(s%2)(k_s P_(s//2))."""
    B, nb = pts.shape[0], pts.shape[1]
    ns = 2 * nb
    c = _consts(pts.device)
    ar = torch.arange(B, device=pts.device)
    tabs = []
    for m in range(nb):
        base = jac_in(pts[:, m, 0], pts[:, m, 1], pts[:, m, 2])
        ent = [identity((B,), pts.device), base]
        for _ in range(2, NENT):
            ent.append(rcb_add(ent[-1], base))
        tabs.append(tuple(torch.stack([e[i] for e in ent]) for i in range(3)))
    acc = identity((B,), pts.device)
    for j in range(GLV_WINDOWS):
        wj = GLV_WINDOWS - 1 - j
        for _ in range(4):
            acc = rcb_dbl(acc)
        for s in range(ns):
            m, phi = divmod(s, 2)
            d = dg[:, s, wj]
            X, Y, W = (t[d, ar] for t in tabs[m])
            if phi:
                X = fe_mul(X, c["beta"])
            Y = torch.where(neg[:, s, None] != 0, fe_neg(Y), Y)
            acc = rcb_add(acc, (X, Y, W))
    return jac_out(acc)


def _pt_i32(t):
    return t.to(torch.int32).contiguous()


def ladder_call(pts, dg, neg):
    """K3 over the active sessions mesh, one ladder_launch a piece (every
    operand per lane)."""
    return sharding.launch(ladder_launch, (pts, dg, neg), (0, 1, 2))


def ladder_launch(pts, dg, neg):
    """K3 on CUDA tensors; the plain version on CPU tensors."""
    if pts.device.type == "cpu":
        return ladder_plain(pts, dg, neg)
    B, nb = pts.shape[0], pts.shape[1]
    if pts.device.type != "cuda" or pts.shape[2:] != (3, L) or nb not in (1, 2) \
            or dg.shape != (B, 2 * nb, GLV_WINDOWS) or neg.shape != (B, 2 * nb) \
            or dg.device != pts.device or neg.device != pts.device:
        raise ValueError("K3: bad inputs")
    out = torch.empty((B, 3, L), dtype=torch.int32, device=pts.device)
    # the int32 copies stay referenced until the launch is enqueued
    p32, d32, n32 = _pt_i32(pts), _pt_i32(dg), _pt_i32(neg)
    if B:
        rc = kernels.lib("ec").k3_glv_ladder(
            p32.data_ptr(), d32.data_ptr(), n32.data_ptr(),
            B, 2 * nb, out.data_ptr(), kernels.stream_handle(pts.device))
        kernels.check(rc, "K3 k3_glv_ladder")
        kernels.count("K3")
    return out.to(torch.int64)


# --------------------------------------------------------------------------
# K4: 8-bit fixed-base comb
# --------------------------------------------------------------------------

def comb_plain(dg, tab):
    """dg [B, 32] 8-bit window digits (LSB-first); tab [32, 256, 2, 16]
    int32 affine entries d * 2^(8 w) * Base (entry 0: (0, 1) = identity with
    W=0).  -> [B, 3, 16] canonical Jacobian."""
    B = dg.shape[0]
    acc = identity((B,), dg.device)
    for w in range(COMB_NW):
        d = dg[:, w]
        e = tab[w, d].to(torch.int64)                   # [B, 2, 16]
        W = torch.zeros_like(e[:, 0])
        W[:, 0] = (d != 0).to(torch.int64)
        acc = rcb_add(acc, (e[:, 0], e[:, 1], W))
    return jac_out(acc)


def comb_planes(tab):
    """[32, 256, 2, 16] int32 comb table -> [32, 16384] uint8, K4's B operand.

    Each window's 256 entries as 64 bytes (x then y, 16-bit limbs
    little-endian), laid out as mma.sync.m16n8k32 u8 reads its B fragments
    with the entries as K and the bytes as N: [k-step kk 8][n-tile j 8]
    [thread 4 g + t][register r 2][byte i 4] holds byte 8 j + g of entry
    32 kk + 16 r + 4 t + i."""
    t = tab.to(torch.int64)
    b = torch.stack([t & 0xFF, (t >> 8) & 0xFF], -1).reshape(COMB_NW, COMB_NENT, 64)
    b = b.reshape(COMB_NW, 8, 2, 4, 4, 8, 8).permute(0, 1, 5, 6, 3, 2, 4)
    return b.reshape(COMB_NW, COMB_NENT * 64).to(torch.uint8).contiguous()


def comb_call(dg, tab, planes=None):
    """K4 over the active sessions mesh, one comb_launch a piece: dg is per
    lane; the table and its planes are shared, copied once to each device of
    the mesh."""
    return sharding.launch(comb_launch, (dg, tab, planes), (0,))


def comb_launch(dg, tab, planes=None):
    """K4 on CUDA tensors, which need `planes` = comb_planes(tab) (cached
    with the table by _comb8_for); the plain version on CPU tensors."""
    if dg.device.type == "cpu":
        return comb_plain(dg, tab)
    B = dg.shape[0]
    if dg.device.type != "cuda" or dg.shape != (B, COMB_NW) or tab.device != dg.device \
            or tab.shape != (COMB_NW, COMB_NENT, 2, L) or tab.dtype != torch.int32 \
            or not tab.is_contiguous():
        raise ValueError("K4: bad inputs")
    if planes is None or planes.device != dg.device \
            or planes.shape != (COMB_NW, COMB_NENT * 64) \
            or planes.dtype != torch.uint8 or not planes.is_contiguous():
        raise ValueError("K4: bad planes")
    out = torch.empty((B, 3, L), dtype=torch.int32, device=dg.device)
    d32 = _pt_i32(dg)
    if B:
        rc = kernels.lib("ec").k4_comb(
            d32.data_ptr(), planes.data_ptr(), B, out.data_ptr(),
            kernels.stream_handle(dg.device))
        kernels.check(rc, "K4 k4_comb")
        kernels.count("K4")
    return out.to(torch.int64)


# --------------------------------------------------------------------------
# K5: to_affine (Fermat inversion + projection)
# --------------------------------------------------------------------------

# Z values at the edges of K5's inversion: next to 0 and to p, powers of two
# at and around the 16-, 30- and 32-bit limb boundaries, long runs of 0 or 1
# bits.  K5's checks and tests put these in lanes of their inputs.
Z_EDGE = (1, 2, 3, P_INT - 1, P_INT - 2, 2**32 - 1, 2**32, 2**32 + 977, 2**255,
          2**256 % P_INT, 2**255 - 1, 2**128 - 1, 2**128, 2**30, 2**30 - 1, 2**240,
          2**240 - 1, (2**256 - 1) % P_INT, P_INT - 2**32, P_INT - 2**128,
          int("F0" * 32, 16) % P_INT, int("0F" * 32, 16),
          sum(1 << i for i in range(0, 256, 30)),
          sum(0x3FFFFFFF << (60 * i) for i in range(5)) % P_INT)


def affine_plain(pts):
    """pts [B, 3, 16] canonical Jacobian -> [B, 2, 16] canonical affine
    (x, y) = (X/Z^2, Y/Z^3).  Z = 0 lanes invert a dummy 1 (the caller masks
    infinity)."""
    c = _consts(pts.device)
    X, Y, Z = pts[:, 0], pts[:, 1], pts[:, 2]
    z = Z.clone()
    z[:, 0] += (Z == 0).all(-1).to(torch.int64)
    tab = [c["one"].expand_as(z), z]
    for _ in range(2, NENT):
        tab.append(fe_mul(tab[-1], z))
    acc = c["one"].expand_as(z)
    for j in range(64):
        for _ in range(4):
            acc = fe_sq(acc)
        acc = fe_mul(acc, tab[c["pm2_digits"][63 - j]])
    zi2 = fe_sq(acc)
    x, zi3 = _stack_mul([(X, zi2), (zi2, acc)])
    y = fe_mul(Y, zi3)
    return torch.stack([fe_canon(x), fe_canon(y)], dim=-2)


def affine_call(pts):
    """K5 over the active sessions mesh, one affine_launch a piece."""
    return sharding.launch(affine_launch, (pts,), (0,))


def affine_launch(pts):
    """K5 on CUDA tensors; the plain version on CPU tensors."""
    if pts.device.type == "cpu":
        return affine_plain(pts)
    B = pts.shape[0]
    if pts.device.type != "cuda" or pts.shape != (B, 3, L):
        raise ValueError("K5: bad inputs")
    out = torch.empty((B, 2, L), dtype=torch.int32, device=pts.device)
    p32 = _pt_i32(pts)
    if B:
        rc = kernels.lib("ec").k5_affine(
            p32.data_ptr(), B, out.data_ptr(), kernels.stream_handle(pts.device))
        kernels.check(rc, "K5 k5_affine")
        kernels.count("K5")
    return out.to(torch.int64)


# --------------------------------------------------------------------------
# dispatch helpers (flat [B, 16] limb batches)
# --------------------------------------------------------------------------

def _digits33(ks):
    """[B, 16] scalar limbs -> [B, 33] 4-bit window digits (LSB-first)."""
    B = ks.shape[0]
    d = torch.stack([(ks >> s) & 0xF for s in (0, 4, 8, 12)], dim=-1)
    return d.reshape(B, 64)[:, :GLV_WINDOWS]


def _glv_prep(k):
    """Scalar batch -> (digits [B, 2, 33], signs [B, 2]) via the GLV split."""
    from .secp256k1 import _glv_split

    k1s, n1, k2s, n2 = _glv_split(k)
    DG = torch.stack([_digits33(k1s), _digits33(k2s)], dim=1)
    NEG = torch.stack([n1, n2], dim=1).to(torch.int64)
    return DG, NEG


def _pack_point(P):
    return torch.stack([P.X, P.Y, P.Z], dim=-2)


def glv_mul(k, p):
    """k * P for flat [B, 16] inputs -> Point ([B, 16] x3, canonical)."""
    from .secp256k1 import Point

    DG, NEG = _glv_prep(k)
    out = ladder_call(_pack_point(p)[:, None], DG, NEG)
    return Point(out[:, 0], out[:, 1], out[:, 2])


def dual_mul(ka, pa, kb, pb):
    """ka * PA + kb * PB in one 4-stream ladder."""
    from .secp256k1 import Point

    DGa, NEGa = _glv_prep(ka)
    DGb, NEGb = _glv_prep(kb)
    pts = torch.stack([_pack_point(pa), _pack_point(pb)], dim=1)
    out = ladder_call(pts, torch.cat([DGa, DGb], 1), torch.cat([NEGa, NEGb], 1))
    return Point(out[:, 0], out[:, 1], out[:, 2])


_COMB8_CACHE: dict = {}


@functools.lru_cache(maxsize=None)
def _comb8_host(base_xy) -> np.ndarray:
    """[32, 256, 2, 16] int32 affine entries d * 2^(8 w) * base (host, once)."""
    tab = np.zeros((COMB_NW, COMB_NENT, 2, L), np.int32)
    base = base_xy
    for j in range(COMB_NW):
        acc = None
        for d in range(1, COMB_NENT):
            acc = hec.add(acc, base)
            tab[j, d, 0] = _limbs16(acc[0])
            tab[j, d, 1] = _limbs16(acc[1])
        tab[j, 0, 1, 0] = 1            # d = 0: (0, 1) with W = 0 -> identity
        for _ in range(COMB_W):
            base = hec.add(base, base)
    return tab


def _comb8_for(base_xy, device):
    """(table, planes) of a base on a device, built once: the int32 table
    for comb_plain and its u8 planes for K4."""
    key = (base_xy, device_key(device))
    if key not in _COMB8_CACHE:
        tab = torch.as_tensor(_comb8_host(base_xy))
        _COMB8_CACHE[key] = (tab.to(device), comb_planes(tab).to(device))
    return _COMB8_CACHE[key]


def _comb_digits(k):
    """[B, 16] limbs -> [B, 32] 8-bit window digits (LSB-first)."""
    B = k.shape[0]
    return torch.stack([k & 0xFF, k >> 8], dim=-1).reshape(B, 2 * L)


def comb_mul(k, base_xy):
    """k * Base for a public fixed base via the 8-bit comb (K4)."""
    from .secp256k1 import Point

    tab, planes = _comb8_for(base_xy, k.device)
    out = comb_call(_comb_digits(k), tab, planes)
    return Point(out[:, 0], out[:, 1], out[:, 2])


def affine(p):
    """to_affine for flat [B, 16] Jacobian batches: (x, y, inf)."""
    out = affine_call(_pack_point(p))
    inf = (p.Z == 0).all(-1)
    zero = torch.zeros_like(out[:, 0])
    x = torch.where(inf[:, None], zero, out[:, 0])
    y = torch.where(inf[:, None], zero, out[:, 1])
    return x, y, inf
