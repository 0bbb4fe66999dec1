"""K1 and K2, the fused RNS kernels: wrappers, plain versions and dispatch
(port of tpu_mpc/core/pallas_rns.py).

K1 (variable-base modexp) replaces tpu_mpc/core/pallas_rns.py:_exp_kernel;
its CUDA source is csrc/rns_exp.cu.  K2 (fixed-base window product, zero
squarings) replaces _fixed_kernel; its source is csrc/rns_fixed.cu.  Both
run the one Montgomery multiply of csrc/rns_field.cuh on a tile of
LANE_TILE = 8 lanes per thread block, its base extensions as exact u8 chunk
products on the tensor cores; the source notes say what bounds them on the
H100 and how the design answers.  exp_call and fixed_call split their lanes
over the active sessions mesh (sharding/mesh.py:launch; no mesh, one
piece), and exp_launch and fixed_launch launch a piece: the kernel for CUDA
tensors (padding the batch to whole lane tiles); for CPU tensors
exp_plain and fixed_plain, the same functions in PyTorch ops, which are
also what chip_smoke.py holds the kernels against, bit for bit.

The reference's dispatch glue maps as follows: _pack_words is kept;
_unpack_residues and _prep_x (binary -> residues, channel-major padding)
are K1's prologue, which reads the base's 16-bit limbs directly; _prep_ctx
and _ctx_blocks become RnsCtx rows and _ctx_blocks below; _planes_out is
the kernels' exact column-sum output; _finish_reduce is below.  The TPU
kernels' bf16 chunk constants become the u8 planes of core/rns.py:
RnsParams.plane_bytes.  K2's _prep_tables (per-call concatenation into
channel-Montgomery bf16 chunks, cached by table identity) has no
counterpart: the tables already lie on the device in the layout K2 reads,
one pointer per base, and each lane reads its key group's row through
`grow` (the TPU kernel's gofs / 16); fixed_prod_dispatch sorts the lanes by
group row so that a lane tile stages one or two groups.  The TPU's
G * 16 <= 512 cap was a VMEM limit and is gone: the tables stay in global
memory.

K1 I/O (lanes B, widths from core/rns.py:RnsParams):
  x     [B, Lin]   16-bit limbs of the base, already reduced mod N
  e     [B, ne2]   packed 32-bit exponent words (limb 2j in the low half)
  rows  [C, 3*CH]  RnsCtx rows, C = 1 (one modulus for all lanes) or B
  out   [B, Lout]  exact binary column sums (emit_planes) or
        [B, CH]    big-Montgomery residues (for the axis-0 product)

K2 I/O:
  e       [B, ne2]   every base's packed e-words, base after base
  grow    [B]        the lane's key-group row g (0 <= g < G)
  rows    [C, 3*CH]  as for K1
  tables  per base [nw, 16, G, CH] int32 (core/rns.py:rns_make_tables)
  nwins, woffs       per base: windows run, first e-word
  out     [B, Lout]  exact binary column sums
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from .. import kernels
from ..sharding import mesh as sharding
from .limbs import batch_to_limbs, nlimbs
from .rns import (
    WINDOW, RnsLazy, RnsParams, ctx_parts, dev_consts, rns_from_limbs, rns_from_mont_cols,
    rns_montmul,
)

_NENT = 16
# lanes per thread block of K1 and K2 (csrc/rns_field.cuh:LANES, the N of
# one mma): the wrappers pad a batch to whole tiles
LANE_TILE = 8
_SHIFTS_MSB = (28, 24, 20, 16, 12, 8, 4, 0)   # window shifts in one e-word


def _pack_words(e_limbs: np.ndarray) -> np.ndarray:
    """[B, Le] 16-bit limbs -> [B, ceil(Le/2)] packed 32-bit e-words."""
    B, Le = e_limbs.shape
    if Le % 2:
        e_limbs = np.concatenate([e_limbs, np.zeros((B, 1), e_limbs.dtype)], axis=1)
    return np.ascontiguousarray(e_limbs[:, 0::2] | (e_limbs[:, 1::2] << 16))


def exp_plain(x, e, rows, nbits: int, emit_planes: bool = True):
    """The function K1 computes, in PyTorch ops (same values, any device)."""
    par = RnsParams(nbits)
    cs = dev_consts(par, x.device)
    cp = ctx_parts(rows, par)
    B = x.shape[0]
    xv = rns_from_limbs(x, cs)
    mm = lambda a, b: rns_montmul(a, b, cp, cs, par)
    one = cp["mon"].expand(B, par.CH)
    xm = mm(xv, cp["r2"].expand(B, par.CH))
    tab = [one, xm]
    for _ in range(_NENT - 2):
        tab.append(mm(tab[-1], xm))
    T = torch.stack(tab, 0)                               # [16, B, CH]
    ar = torch.arange(B, device=x.device)
    acc = one
    ne2 = e.shape[1]
    for j in range(ne2):
        word = e[:, ne2 - 1 - j]
        for s in _SHIFTS_MSB:
            d = (word >> s) & (_NENT - 1)
            for _ in range(4):
                acc = mm(acc, acc)
            acc = mm(acc, T[d, ar])
    if not emit_planes:
        return acc
    return rns_from_mont_cols(acc, cp, cs, par)


def _i32(t):
    """int64 tensor holding u32 values -> int32 tensor with the same bits."""
    return torch.where(t >= (1 << 31), t - (1 << 32), t).to(torch.int32).contiguous()


def _pad_lanes(t, n: int, last: bool = False):
    """t [B, ...] -> [B + n, ...]: n more rows of zeros, or copies of the
    last row (ctx rows and group rows, so that padding lanes compute on a
    valid modulus and group)."""
    if n == 0:
        return t
    tail = tuple(t.shape[1:])
    fill = t[-1:].expand((n,) + tail) if last else t.new_zeros((n,) + tail)
    return torch.cat([t, fill])


def k1_tiles(x, e, rows):
    """K1's inputs padded to whole lane tiles: (x, e, rows)."""
    pad = -x.shape[0] % LANE_TILE
    rows = _pad_lanes(rows, pad, last=True) if rows.shape[0] != 1 else rows
    return _pad_lanes(x, pad), _pad_lanes(e, pad), rows


def exp_call(x, e, rows, nbits: int, emit_planes: bool = True):
    """K1 over the active sessions mesh (sharding/mesh.py:launch), one
    exp_launch a piece: x and e are per lane, rows too when it has a row a
    lane ([B, W]); a [1, W] row is shared."""
    lanes = (0, 1) if rows.shape[0] == 1 else (0, 1, 2)
    return sharding.launch(exp_launch, (x, e, rows, nbits, emit_planes), lanes)


def exp_launch(x, e, rows, nbits: int, emit_planes: bool = True):
    """K1 on CUDA tensors; the plain version on CPU tensors."""
    if x.device.type == "cpu":
        return exp_plain(x, e, rows, nbits, emit_planes)
    if x.device.type != "cuda" or e.device != x.device or rows.device != x.device:
        raise ValueError("K1: x, e and rows must lie on one CUDA device")
    par = RnsParams(nbits)
    B = x.shape[0]
    if x.shape != (B, par.Lin) or e.shape[0] != B or rows.shape[-1] != 3 * par.CH \
            or rows.shape[0] not in (1, B):
        raise ValueError(f"K1: bad shapes x{tuple(x.shape)} e{tuple(e.shape)} "
                         f"rows{tuple(rows.shape)} at {nbits} bits")
    if B == 0:
        return torch.empty((0, par.Lout) if emit_planes else (0, par.CH),
                           dtype=torch.int64, device=x.device)
    lib = kernels.lib("rns")
    cs = dev_consts(par, x.device)
    # every converted input stays referenced until the launch is enqueued
    xp, ep, rp = k1_tiles(x, e, rows)
    Bp = xp.shape[0]
    x32, e32, r32 = _i32(xp), _i32(ep), _i32(rp)
    # the window table's global home, where it does not fit in shared memory
    ntab = lib.k1_tab_words(Bp, par.K, par.Kp, par.Lin, par.Lout, par.MT, par.KT)
    if ntab < 0:
        raise ValueError(f"K1: {B} lanes at {nbits} bits: the window table's words "
                         "exceed an int; split the launch")
    tab = torch.empty(max(ntab, 1), dtype=torch.int32, device=x.device)
    cols = torch.empty((Bp, par.Lout) if emit_planes else (1,), dtype=torch.int64,
                       device=x.device)
    res = torch.empty((1,) if emit_planes else (Bp, par.CH), dtype=torch.int32,
                      device=x.device)
    rc = lib.k1_exp(
        x32.data_ptr(), e32.data_ptr(), r32.data_ptr(), int(rows.shape[0] != 1),
        cs["flat32"].data_ptr(), cs["planes"].data_ptr(), Bp, par.K, par.Kp, par.Lin,
        par.Lout, par.MT, par.KT, e.shape[1], par.invMA_r, par.invMB_r, int(emit_planes),
        tab.data_ptr(), cols.data_ptr(), res.data_ptr(), kernels.stream_handle(x.device),
    )
    kernels.check(rc, "K1 k1_exp")
    kernels.count("K1")
    return cols[:B] if emit_planes else res[:B].to(torch.int64)


def _values_shared(n_b: np.ndarray) -> bool:
    """True iff every modulus in the (broadcast) batch is the same value."""
    flat = n_b.reshape(-1)
    if flat.shape[0] <= 1:
        return True
    first = flat[0]
    return all((v is first) or (v == first) for v in flat.tolist())


def _ctx_blocks(ctx, shape, n_b) -> torch.Tensor:
    """RnsCtx rows for a call of batch `shape`: [1, W] when every lane shares
    one modulus (the tiled-key serving pattern), else [lead, W]."""
    W = ctx.rows.shape[-1]
    nc = int(np.prod(ctx.batch_shape, dtype=np.int64))
    if nc == 1 or _values_shared(n_b):
        return ctx.rows.reshape(-1, W)[:1].contiguous()
    lead = int(np.prod(shape, dtype=np.int64)) if shape else 1
    return torch.broadcast_to(ctx.rows, tuple(shape) + (W,)).reshape(lead, W).contiguous()


def _finish_reduce(res, rows, nbits: int, lead: int, S: int):
    """Big-Montgomery residues [lead, CH] -> tree product over the leading S
    axis -> decode columns [lead // S, Lout].  The reduced output keeps ONE
    modulus per trailing slot: moduli are constant along axis 0 (the
    caller's precondition) but may vary along the trailing dims."""
    par = RnsParams(nbits)
    cs = dev_consts(par, res.device)
    rest = lead // S
    cp = ctx_parts(rows[:rest] if rows.shape[0] > 1 else rows, par)
    acc = res.reshape(S, rest, par.CH)
    while acc.shape[0] > 1:
        n = acc.shape[0]
        h = n // 2
        pair = rns_montmul(acc[:h], acc[n - h:], cp, cs, par)
        if n % 2:
            pair = torch.cat([pair, acc[h:h + 1]], dim=0)
        acc = pair
    return rns_from_mont_cols(acc[0], cp, cs, par)


def _obj_mod(a, m) -> np.ndarray:
    return np.vectorize(lambda v, w: int(v) % int(w), otypes=[object])(a, m)


def exp_dispatch(ctx, n_ints, base_ints, exp_ints, ebits: int,
                 reduce_axis0: bool = False) -> RnsLazy:
    """x^e mod n over a broadcast batch -> RnsLazy.  reduce_axis0: the
    product over the leading axis is folded on the device before decode
    (moduli must be constant along axis 0)."""
    nbits = ctx.params_nbits
    par = RnsParams(nbits)
    base = np.asarray(base_ints, dtype=object)
    expv = np.asarray(exp_ints, dtype=object)
    n_arr = np.asarray(n_ints, dtype=object)
    shape = np.broadcast_shapes(base.shape, expv.shape, n_arr.shape)
    n_b = np.broadcast_to(n_arr, shape)
    lead = int(np.prod(shape, dtype=np.int64)) if shape else 1
    dev = ctx.rows.device
    xb = _obj_mod(np.broadcast_to(base, shape), n_b)
    x = torch.as_tensor(batch_to_limbs(xb, par.Lin).reshape(lead, par.Lin), device=dev)
    Le = nlimbs(max(ebits, 1))
    ew = _pack_words(batch_to_limbs(np.broadcast_to(expv, shape), Le).reshape(lead, Le))
    e = torch.as_tensor(ew, device=dev)
    rows = _ctx_blocks(ctx, shape, n_b)
    if reduce_axis0:
        res = exp_call(x, e, rows, nbits, emit_planes=False)
        cols = _finish_reduce(res, rows, nbits, lead, shape[0])
        return RnsLazy(parts=(cols,), shape=(1,) + tuple(shape[1:]), n_b=n_b[:1],
                       MA=par.MA)
    cols = exp_call(x, e, rows, nbits, emit_planes=True)
    return RnsLazy(parts=(cols,), shape=tuple(shape), n_b=n_b, MA=par.MA)


# --------------------------------------------------------------------------
# K2: fixed-base window product (zero squarings)
# --------------------------------------------------------------------------

_K2_MAX_BASES = 4   # csrc/rns_fixed.cu:MAX_BASES


def k2_split(B: int, nw: int) -> int:
    """Chunks K2 splits a product of nw windows into: a block per chunk and
    lane tile, enough to fill ~128 SMs, with at least 16 windows a chunk and
    at most 8 chunks."""
    nblk = max(1, -(-B // LANE_TILE))
    return max(1, min(8, -(-128 // nblk), nw // 16))


def fixed_plain(e, grow, rows, tables, nwins, woffs, nbits: int, split=None):
    """The function K2 computes, in PyTorch ops (same values, any device):
    the windows of all bases in one sequence (base after base, windows
    j = 0 .. nwin-1 LSB-first), split into `split` chunks of equal length
    (default: k2_split, as fixed_call); each chunk is a chain of Montgomery
    multiplies by T[j][digit][grow] from the Montgomery one, the chunk
    products are multiplied in order, then the decode epilogue."""
    par = RnsParams(nbits)
    cs = dev_consts(par, e.device)
    cp = ctx_parts(rows, par)
    one = cp["mon"].expand(e.shape[0], par.CH)
    g = grow.long()
    seq = [(T, woff, j) for T, nwin, woff in zip(tables, nwins, woffs) for j in range(nwin)]
    if split is None:
        split = k2_split(e.shape[0], len(seq))
    chunk = -(-len(seq) // split)
    acc = None
    for p in range(split):
        part = one
        for T, woff, j in seq[p * chunk:(p + 1) * chunk]:
            d = (e[:, woff + j // 8] >> (WINDOW * (j % 8))) & (_NENT - 1)
            part = rns_montmul(part, T[j, d, g].long(), cp, cs, par)
        acc = part if acc is None else rns_montmul(acc, part, cp, cs, par)
    return rns_from_mont_cols(acc, cp, cs, par)


def k2_tiles(e, grow, rows):
    """K2's inputs padded to whole lane tiles: (e, grow, rows).  Padding
    lanes take exponent 0 and the last lane's group row, so that they add no
    key group to the last tile."""
    pad = -e.shape[0] % LANE_TILE
    rows = _pad_lanes(rows, pad, last=True) if rows.shape[0] != 1 else rows
    return _pad_lanes(e, pad), _pad_lanes(grow, pad, last=True), rows


def fixed_call(e, grow, rows, tables, nwins, woffs, nbits: int):
    """K2 over the active sessions mesh (sharding/mesh.py:launch), one
    fixed_launch a piece: e and grow are per lane, rows too when it has a row
    a lane; the tables are shared, copied once to each device of the mesh."""
    lanes = (0, 1) if rows.shape[0] == 1 else (0, 1, 2)
    return sharding.launch(fixed_launch, (e, grow, rows, tables, nwins, woffs, nbits), lanes)


def fixed_launch(e, grow, rows, tables, nwins, woffs, nbits: int):
    """K2 on CUDA tensors; the plain version on CPU tensors."""
    if e.device.type == "cpu":
        return fixed_plain(e, grow, rows, tables, nwins, woffs, nbits)
    if e.device.type != "cuda" or any(t.device != e.device for t in (grow, rows, *tables)):
        raise ValueError("K2: e, grow, rows and tables must lie on one CUDA device")
    par = RnsParams(nbits)
    B, ne2 = e.shape
    G = tables[0].shape[2] if tables else 0
    ok = (tuple(grow.shape) == (B,) and rows.shape[-1] == 3 * par.CH
          and rows.shape[0] in (1, B) and 1 <= len(tables) <= _K2_MAX_BASES
          and len(nwins) == len(woffs) == len(tables))
    for T, nwin, woff in zip(tables, nwins, woffs):
        ok = ok and (T.dtype == torch.int32 and T.dim() == 4
                     and tuple(T.shape[1:]) == (_NENT, G, par.CH)
                     and 0 <= nwin <= T.shape[0] and woff >= 0
                     and woff + -(-nwin // 8) <= ne2)
    if not ok:
        raise ValueError(f"K2: bad shapes e{tuple(e.shape)} grow{tuple(grow.shape)} "
                         f"rows{tuple(rows.shape)} tables{[tuple(t.shape) for t in tables]} "
                         f"nwins{list(nwins)} woffs{list(woffs)} at {nbits} bits")
    if B == 0:
        return torch.empty((0, par.Lout), dtype=torch.int64, device=e.device)
    lib = kernels.lib("rns_fixed")
    cs = dev_consts(par, e.device)
    # every converted input stays referenced until the launch is enqueued
    ep, gp, rp = k2_tiles(e, grow, rows)
    Bp = ep.shape[0]
    e32, g32, r32 = _i32(ep), _i32(gp), _i32(rp)
    # the kernel stages table rows by their 16-byte lines
    tabs = [T if T.is_contiguous() and T.data_ptr() % 16 == 0 else T.clone()
            for T in tables]
    n = len(tabs)
    ptrs = (ctypes.c_uint64 * n)(*(T.data_ptr() for T in tabs))
    # the window chunks and where their products meet (csrc/rns_fixed.cu)
    split = k2_split(B, sum(nwins))
    partial = torch.empty(Bp * split * par.CH if split > 1 else 1, dtype=torch.int32,
                          device=e.device)
    ticket = torch.zeros(Bp // LANE_TILE, dtype=torch.int32, device=e.device)
    cols = torch.empty((Bp, par.Lout), dtype=torch.int64, device=e.device)
    rc = lib.k2_fixed(
        e32.data_ptr(), ne2, g32.data_ptr(), r32.data_ptr(), int(rows.shape[0] != 1),
        cs["flat32"].data_ptr(), cs["planes"].data_ptr(), Bp, par.K, par.Kp, par.Lin,
        par.Lout, par.MT, par.KT, par.invMA_r, par.invMB_r, n, ptrs,
        (ctypes.c_int * n)(*nwins), (ctypes.c_int * n)(*woffs), G, split,
        partial.data_ptr(), ticket.data_ptr(), cols.data_ptr(),
        kernels.stream_handle(e.device),
    )
    kernels.check(rc, "K2 k2_fixed")
    kernels.count("K2")
    return cols[:B]


def fixed_prod_dispatch(ctx, n_ints, tables, exps, ebits_list, nbits: int,
                        gmap=None) -> RnsLazy:
    """prod_i base_i^exps[i] mod n over a broadcast batch from fixed-base
    tables (core/rns.py:rns_make_tables) -> RnsLazy.

    Every base's table has the same flattened key-group count G.  Without
    `gmap` the table batch dims broadcast (right-aligned) against the call
    batch and each lane reads its own group's row; `gmap` maps each call
    element to a flattened group row explicitly (group-compressed tables,
    G groups serving more sessions).  Base i runs ceil(ebits_list[i] / 4)
    windows, so its exponents must be below 2^ebits_list[i]."""
    par = RnsParams(nbits)
    exps = [np.asarray(e, dtype=object) for e in exps]
    n_arr = np.asarray(n_ints, dtype=object)
    shape = tuple(np.broadcast_shapes(n_arr.shape, *(e.shape for e in exps)))
    n_b = np.broadcast_to(n_arr, shape)
    lead = int(np.prod(shape, dtype=np.int64)) if shape else 1
    bdims = tuple(tables[0].shape[2:-1])
    G = int(np.prod(bdims, dtype=np.int64))
    if any(int(np.prod(t.shape[2:-1], dtype=np.int64)) != G for t in tables):
        raise ValueError("fixed_prod_dispatch: every base's table needs the same group count")
    rows_g = np.asarray(gmap, dtype=np.int64) if gmap is not None else \
        np.arange(G, dtype=np.int64).reshape(bdims)
    gm = np.broadcast_to(rows_g, shape).reshape(lead)
    if lead and (int(gm.min()) < 0 or int(gm.max()) >= G):
        raise ValueError(f"fixed_prod_dispatch: group rows outside [0, {G})")
    ews, nwins, woffs, off = [], [], [], 0
    for e, eb in zip(exps, ebits_list):
        eb_arr = np.broadcast_to(e, shape)
        if max((int(v).bit_length() for v in eb_arr.reshape(-1).tolist()), default=0) > eb:
            raise ValueError(f"fixed_prod_dispatch: an exponent exceeds {eb} bits")
        Le = nlimbs(eb)
        ews.append(_pack_words(batch_to_limbs(eb_arr, Le).reshape(lead, Le)))
        nwins.append(-(-eb // WINDOW))
        woffs.append(off)
        off += ews[-1].shape[1]
    dev = ctx.rows.device
    ew = np.concatenate(ews, axis=1)
    rows = _ctx_blocks(ctx, shape, n_b)
    # lanes sorted by group row (public), so that a lane tile of K2 holds one
    # or two key groups; the output returns to the caller's order
    order = np.argsort(gm, kind="stable")
    perm = lead > 1 and bool((order != np.arange(lead)).any())
    if perm:
        ew, gm = ew[order], gm[order]
        if rows.shape[0] > 1:
            rows = rows[torch.as_tensor(order, device=dev)]
    e = torch.as_tensor(ew, device=dev)
    grow = torch.as_tensor(np.array(gm), device=dev)
    tabs = [t.reshape(t.shape[0], _NENT, G, t.shape[-1]) for t in tables]
    cols = fixed_call(e, grow, rows, tabs, nwins, woffs, nbits)
    if perm:
        inv = np.empty_like(order)
        inv[order] = np.arange(lead)
        cols = cols[torch.as_tensor(inv, device=dev)]
    return RnsLazy(parts=(cols,), shape=shape, n_b=n_b, MA=par.MA)
