"""RNS (residue number system) Montgomery arithmetic (port of tpu_mpc/core/rns.py).

A big integer is carried as its residues modulo K 16-bit primes (base A),
Kp = K + 1 further primes (base B) and a redundant 2^16 channel r.  One
Montgomery multiply x*y*MA^{-1} mod N is a per-channel product plus two base
extensions, each an exact integer dot product over the channels:

    approximate A -> B extension:  q_hat = sum_k xi_k * (MA/p_k)  (= q + alpha*MA)
    exact B -> A extension (Shenoy-Kumaresan, through the r channel)

This is the Bajard-Imbert scheme of the reference module, kept value for
value: every channel value is canonical (< p), so the plain PyTorch
functions here and the CUDA kernel K1 (core/pallas_rns.py) produce the same
residues bit for bit.  Invariant: inputs/outputs < lam*N, lam = 2(K+2).

Port notes:
  * u32 channel values are carried in int64 tensors (torch on the CPU has no
    uint32 `+`, `>>` or `>=`).
  * The extension dots of the plain functions are float64 matrix products:
    every term is < 2^32 and every sum < K * 2^32 < 2^53, so float64 is
    exact on both the CPU and the card (no int64 matmul exists on CUDA).
    The kernels compute the same sums from u8 chunk planes on the tensor
    cores (RnsParams.plane_bytes, csrc/rns_field.cuh) and reduce with
    Barrett constants (RnsParams.mA, mB) instead of a division.
  * RnsCtx holds one row of per-modulus constants in the layout K1 and K2
    read.
  * Fixed-base tables (rns_make_tables) are int32 tensors [nw, 16, ...batch,
    CH] of canonical residues, the layout K2 reads; the TPU kernel's
    channel-Montgomery bf16 byte halves are not carried over.
"""

from __future__ import annotations

import dataclasses
import functools

import numpy as np
import torch

from ..device import device_key
from .limbs import batch_to_limbs, nlimbs

WINDOW = 4
P_R = 1 << 16  # redundant Shenoy-Kumaresan channel modulus


# --------------------------------------------------------------------------
# host-side parameter machinery
# --------------------------------------------------------------------------

def _is_prime(m: int) -> bool:
    """Deterministic Miller-Rabin (exact below 3.3e24 with this base set)."""
    if m < 2 or m % 2 == 0:
        return m == 2
    d, s = m - 1, 0
    while d % 2 == 0:
        d //= 2
        s += 1
    for a in (2, 3, 5, 7, 11, 13, 17, 19, 23, 29, 31, 37):
        x = pow(a, d, m)
        if x in (1, m - 1):
            continue
        for _ in range(s - 1):
            x = x * x % m
            if x == m - 1:
                break
        else:
            return False
    return True


@functools.lru_cache(maxsize=None)
def _primes_16bit(count: int) -> tuple:
    """`count` largest primes below 2^16, descending."""
    out = []
    n = (1 << 16) - 1
    while len(out) < count and n > (1 << 15):
        if _is_prime(n):
            out.append(n)
        n -= 2
    if len(out) < count:
        raise ValueError("16-bit prime supply exhausted")
    return tuple(out)


@functools.lru_cache(maxsize=None)
class RnsParams:
    """Modulus-independent RNS bases + extension matrices for one operand
    width (cached per nbits).  Same constants as the reference."""

    def __init__(self, nbits: int):
        K = nlimbs(nbits) + 2   # MA > 4(K+2) * 2^nbits
        Kp = K + 1              # MB > MA
        ps = _primes_16bit(K + Kp)
        self.nbits, self.K, self.Kp = nbits, K, Kp
        self.CH = K + Kp + 1    # channels of one value: A | B | r
        self.pA, self.pB = ps[:K], ps[K:]
        self.MA = functools.reduce(lambda a, b: a * b, self.pA, 1)
        self.MB = functools.reduce(lambda a, b: a * b, self.pB, 1)
        lam = 2 * (K + 2)
        assert self.MA > 4 * (K + 2) << nbits, "MA margin too small"
        assert self.MB > lam << nbits, "MB margin too small"
        self.lam = lam

        self.pA_arr = np.asarray(self.pA, dtype=np.int64)
        self.pB_arr = np.asarray(self.pB, dtype=np.int64)
        MAk = [self.MA // p for p in self.pA]
        MBj = [self.MB // p for p in self.pB]
        self.invMAk = np.asarray(
            [pow(m % p, -1, p) for m, p in zip(MAk, self.pA)], dtype=np.int64)
        self.invMBj = np.asarray(
            [pow(m % p, -1, p) for m, p in zip(MBj, self.pB)], dtype=np.int64)
        # extension matrices; last column is the redundant 2^16 channel
        self.W1 = np.asarray(
            [[m % p for p in self.pB] + [m % P_R] for m in MAk], dtype=np.int64
        )  # [K, Kp+1]
        self.W2 = np.asarray(
            [[m % p for p in self.pA] + [m % P_R] for m in MBj], dtype=np.int64
        )  # [Kp, K+1]
        self.MB_A = np.asarray([self.MB % p for p in self.pA], dtype=np.int64)
        self.invMB_r = int(pow(self.MB % P_R, -1, P_R))
        self.invMA_B = np.asarray(
            [pow(self.MA % p, -1, p) for p in self.pB], dtype=np.int64)
        self.invMA_r = int(pow(self.MA % P_R, -1, P_R))
        # binary reconstruction: 16-bit limbs of MA/p_k  [K, Lout]
        self.Lout = K + 1  # sum_k xi_k*(MA/p_k) < K*MA < 2^(16(K+1))
        self.Wbin = batch_to_limbs(np.asarray(MAk, dtype=object), self.Lout)
        # binary -> residue: W16[l, k] = 2^(16 l) mod p_k
        L = nlimbs(nbits)
        self.Lin = L
        self.W16A = np.asarray(
            [[pow(2, 16 * l, p) for p in self.pA] for l in range(L)], dtype=np.int64)
        self.W16B = np.asarray(
            [[pow(2, 16 * l, p) for p in self.pB] for l in range(L)], dtype=np.int64)
        # Barrett constants floor(2^32 / p) of every channel (csrc/rns_field.cuh:bred)
        self.mA = (1 << 32) // self.pA_arr
        self.mB = (1 << 32) // self.pB_arr
        # tensor-core tiles of the extension and decode dots (csrc/rns_field.cuh):
        # MT m-tiles of 16 output channels, KT k-tiles of 32 summed channels
        self.MT = max(-(-(Kp + 1) // 16), -(-(K + 1) // 16))
        self.KT = max(-(-K // 32), -(-Kp // 32))

    def const_vector(self) -> np.ndarray:
        """Every per-channel constant in the one flat u32 layout K1 and K2
        read: pA, pB, mA, mB, invMAk, invMA_B, invMBj, MB_A, W16A, W16B."""
        parts = [self.pA_arr, self.pB_arr, self.mA, self.mB, self.invMAk, self.invMA_B,
                 self.invMBj, self.MB_A, self.W16A, self.W16B]
        return np.concatenate([np.asarray(p, np.int64).reshape(-1) for p in parts])

    def plane_matrices(self) -> list:
        """The three matrices the kernels multiply on the tensor cores, each
        transposed to [output channel, summed channel] and zero-padded to
        [MT*16, KT*32]: W1^T (A -> B|r), W2^T (B -> A|r), Wbin^T (decode)."""
        out = []
        for W in (self.W1, self.W2, np.asarray(self.Wbin, np.int64)):
            M = np.zeros((self.MT * 16, self.KT * 32), np.int64)
            M[:W.shape[1], :W.shape[0]] = W.T
            out.append(M)
        return out

    def plane_bytes(self) -> np.ndarray:
        """The u8 planes (lo and hi byte of every entry) of plane_matrices()
        in mma.sync fragment order, one flat uint8 buffer: first the
        extension chunks [KT, 2 (W1^T, W2^T), MT, 2 (lo, hi), 512], ordered by
        k-tile so that a prefix of whole k-tiles can stay in shared memory,
        then the decode chunks [KT, MT, 2, 512].  A 512-byte chunk is one
        16 x 32 tile as the 32 threads of a warp hold it (see _FRAG)."""
        W1T, W2T, WbT = (_frag_tiles(M, self.MT, self.KT) for M in self.plane_matrices())
        ext = np.stack([W1T, W2T], axis=0).transpose(3, 0, 2, 1, 4)   # [KT, 2, MT, 2, 512]
        dec = WbT.transpose(2, 1, 0, 3)                                # [KT, MT, 2, 512]
        return np.concatenate([ext.reshape(-1), dec.reshape(-1)]).astype(np.uint8)

    def to_residues(self, xs) -> np.ndarray:
        """object ints [...] -> [..., CH] residues (A | B | r)."""
        xs = np.asarray(xs, dtype=object)
        flat = xs.reshape(-1).tolist()
        mods = list(self.pA) + list(self.pB) + [P_R]
        out = np.asarray([[int(v) % m for m in mods] for v in flat], dtype=np.int64)
        return out.reshape(xs.shape + (self.CH,))


def _frag_index():
    """(row, col) of byte b of register q of thread l in a 16 x 32 u8 tile
    held as the A operand of mma.sync.m16n8k32 (PTX ISA, fragment layout of
    .u8 A): row = l/4 + 8 (q & 1), col = 4 (l % 4) + b + 16 (q >> 1)."""
    lane, q, b = np.meshgrid(np.arange(32), np.arange(4), np.arange(4), indexing="ij")
    return lane // 4 + 8 * (q & 1), 4 * (lane % 4) + b + 16 * (q >> 1)


_FRAG = _frag_index()


def _frag_tiles(M: np.ndarray, MT: int, KT: int) -> np.ndarray:
    """[MT*16, KT*32] entries < 2^16 -> [2 (lo, hi), MT, KT, 512] bytes in
    fragment order (thread l's 16 bytes at offset 16 l)."""
    tiles = M.reshape(MT, 16, KT, 32).transpose(0, 2, 1, 3)          # [MT, KT, 16, 32]
    frag = tiles[:, :, _FRAG[0], _FRAG[1]].reshape(MT, KT, 512)
    return np.stack([frag & 0xFF, frag >> 8])


_DEV_CACHE: dict = {}


def dev_consts(par: RnsParams, device) -> dict:
    """Device copies of a width's constants (uploaded once per device)."""
    key = (par.nbits, device_key(device))
    hit = _DEV_CACHE.get(key)
    if hit is None:
        t = lambda a: torch.as_tensor(np.asarray(a, np.int64), device=device)
        f = lambda a: torch.as_tensor(np.asarray(a, np.float64), device=device)
        hit = {
            "pA": t(par.pA_arr), "pB": t(par.pB_arr),
            "invMAk": t(par.invMAk), "invMA_B": t(par.invMA_B),
            "invMBj": t(par.invMBj), "MB_A": t(par.MB_A),
            "W1": f(par.W1), "W2": f(par.W2), "W16A": f(par.W16A),
            "W16B": f(par.W16B), "Wbin": f(par.Wbin),
            # what the CUDA kernels read: the flat u32 per-channel constants
            # and the u8 tensor-core planes of W1^T, W2^T and Wbin^T
            "flat32": torch.as_tensor(par.const_vector().astype(np.int32), device=device),
            "planes": torch.as_tensor(par.plane_bytes(), device=device),
        }
        _DEV_CACHE[key] = hit
    return hit


@dataclasses.dataclass
class RnsCtx:
    """Per-modulus constants for a batch of moduli: one int64 row per
    modulus, batch dims leading, in the layout K1 reads:

        [cA (K) | N_B (Kp) | N_r] [monA | monB | mon_r] [r2A | r2B | r2_r]

    cA = (-N^{-1}) * invMAk mod pA (the two first-step factors folded),
    mon = MA mod N (the Montgomery one), r2 = MA^2 mod N."""

    params_nbits: int
    rows: torch.Tensor            # [..., 3*CH] int64

    @property
    def batch_shape(self):
        return tuple(self.rows.shape[:-1])

    def map_batch(self, fn) -> "RnsCtx":
        """Apply a batch-axis transform (take/tile/expand/reshape)."""
        return RnsCtx(self.params_nbits, fn(self.rows))

    @classmethod
    def from_ints(cls, ns, nbits: int, device=None) -> "RnsCtx":
        from ..device import resolve_device

        device = resolve_device(device)
        par = RnsParams(nbits)
        ns = np.asarray(ns, dtype=object)
        flat = ns.reshape(-1).tolist()
        rows = np.empty((len(flat), 3 * par.CH), dtype=np.int64)
        for i, nv in enumerate(flat):
            nv = int(nv)
            cA = [(-pow(nv, -1, p)) % p * int(ik) % p
                  for p, ik in zip(par.pA, par.invMAk)]
            N_B = [nv % p for p in par.pB]
            rows[i, :par.CH] = cA + N_B + [nv % P_R]
            rows[i, par.CH:2 * par.CH] = par.to_residues(par.MA % nv)
            rows[i, 2 * par.CH:] = par.to_residues((par.MA * par.MA) % nv)
        rows = rows.reshape(ns.shape + (3 * par.CH,))
        return cls(nbits, torch.as_tensor(rows, device=device))


def split_value(v, par: RnsParams):
    """[..., CH] residues -> (A [..., K], B [..., Kp], r [...])."""
    K, Kp = par.K, par.Kp
    return v[..., :K], v[..., K:K + Kp], v[..., K + Kp]


def ctx_parts(rows, par: RnsParams) -> dict:
    CH, K, Kp = par.CH, par.K, par.Kp
    blk = lambda i: rows[..., i * CH:(i + 1) * CH]
    c = blk(0)
    return {
        "cA": c[..., :K], "N_B": c[..., K:K + Kp], "N_r": c[..., K + Kp],
        "mon": blk(1), "r2": blk(2),
    }


def _dot(xi, W):
    """Exact sum_k xi[..., k] * W[k, j] (float64: terms < 2^32, sums < 2^53)."""
    return torch.matmul(xi.to(torch.float64), W).to(torch.int64)


def rns_montmul(x, y, cp: dict, cs: dict, par: RnsParams):
    """x*y*MA^{-1} mod N on [..., CH] residue tensors (result < lam*N,
    canonical channels).  cp: ctx_parts of the moduli; cs: dev_consts."""
    xA, xB, xr = split_value(x, par)
    yA, yB, yr = split_value(y, par)
    pA, pB = cs["pA"], cs["pB"]
    # q = -s N^{-1} mod MA, folded with invMAk: xi = s * cA
    xi = (xA * yA % pA) * cp["cA"] % pA
    sB = xB * yB % pB
    sr = (xr * yr) & 0xFFFF
    # approximate extension A -> B | r
    ext = _dot(xi, cs["W1"])
    qhB = ext[..., :par.Kp] % pB
    qh_r = ext[..., par.Kp] & 0xFFFF
    # t = (s + q_hat N) / MA in base B and channel r
    num = (sB + qhB * cp["N_B"] % pB) % pB
    tB = num * cs["invMA_B"] % pB
    t_r = ((((sr + qh_r * cp["N_r"]) & 0xFFFF) * par.invMA_r) & 0xFFFF)
    # exact extension B -> A via channel r
    xi2 = tB * cs["invMBj"] % pB
    ext2 = _dot(xi2, cs["W2"])
    sum_r = ext2[..., par.K] & 0xFFFF
    alpha = (((sum_r - t_r) & 0xFFFF) * par.invMB_r) & 0xFFFF
    tA_raw = ext2[..., :par.K] % pA
    corr = alpha[..., None] * cs["MB_A"] % pA
    tA = (tA_raw - corr) % pA
    return torch.cat([tA, tB, t_r[..., None]], dim=-1)


def rns_from_mont_cols(acc, cp: dict, cs: dict, par: RnsParams):
    """Montgomery-form residues -> exact binary column sums [..., Lout]:
    strip MA (montmul by the integer 1), then v = sum_k xi_k (MA/p_k)."""
    one = torch.ones_like(acc)
    res = rns_montmul(acc, one, cp, cs, par)
    xi = res[..., :par.K] * cs["invMAk"] % cs["pA"]
    return _dot(xi, cs["Wbin"])


def rns_from_limbs(x, cs: dict):
    """16-bit limbs [..., Lin] -> canonical residues [..., CH] (A | B | r);
    the limb sums are < Lin * 2^32, exact in float64."""
    xd = x.double()
    return torch.cat([
        torch.matmul(xd, cs["W16A"]).long() % cs["pA"],
        torch.matmul(xd, cs["W16B"]).long() % cs["pB"],
        x[..., :1] & 0xFFFF,
    ], dim=-1)


def _serial_chain(step, x0, n: int):
    """[x0, step(x0), step(step(x0)), ...] (n values) stacked on a new axis 0.

    On a CUDA device one step is captured once as a CUDA graph and replayed:
    the step is a few hundred small torch launches, and launching them one
    by one from the host would take most of a table build.  The graph runs
    the same operations on the same values, so the output is identical."""
    out = torch.empty((n,) + tuple(x0.shape), dtype=x0.dtype, device=x0.device)
    out[0] = x0
    if n == 1:
        return out
    if x0.device.type != "cuda":
        for j in range(1, n):
            out[j] = step(out[j - 1])
        return out
    cur = x0.clone()
    side = torch.cuda.Stream(x0.device)
    side.wait_stream(torch.cuda.current_stream(x0.device))
    with torch.cuda.stream(side):           # warm-up outside the capture
        step(cur)
    torch.cuda.current_stream(x0.device).wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        nxt = step(cur)
    for j in range(1, n):
        graph.replay()
        out[j] = nxt
        cur.copy_(nxt)
    return out


def _rns_make_fixed_table(xv, cp: dict, cs: dict, par: RnsParams, nw: int):
    """Fixed-base window tables in RNS-Montgomery form, T[j][d] = x^(d*16^j)
    (port of rns.py:_rns_make_fixed_table, the same multiplies in the same
    order).  xv: [..., CH] canonical residues of the bases; -> [nw, 16, ...,
    CH] int64.  Entry 0 of every window is the Montgomery one.

    Phase 1 is the only serial dependency, the window bases W[j] = x^(16^j)
    (four squarings each); phase 2 computes E[d] = E[d-1] * W batched over
    the whole window axis, so the serial depth is 4 * (nw - 1) + 15."""
    mm = lambda a, b: rns_montmul(a, b, cp, cs, par)

    def step(b):
        for _ in range(WINDOW):
            b = mm(b, b)
        return b

    xm = mm(xv, cp["r2"])
    W = _serial_chain(step, xm, nw)
    ents = [cp["mon"].expand(W.shape), W]
    for _ in range(14):
        ents.append(mm(ents[-1], W))
    return torch.stack(ents, dim=1)


def rns_make_tables(ctx: RnsCtx, n_ints, bases, max_ebits: int, nbits: int) -> list:
    """bases [k, ...batch] object ints -> k fixed-base tables, each an int32
    tensor [nw, 16, ...batch, CH] (nw = ceil(max_ebits / 4)) on the ctx's
    device, in the layout K2 reads (core/pallas_rns.py:fixed_call).  One
    build over every base: the k axis rides as a leading batch dim."""
    b = np.asarray(bases, dtype=object)
    n_b = np.broadcast_to(np.asarray(n_ints, dtype=object), b.shape)
    par = RnsParams(nbits)
    dev = ctx.rows.device
    cs = dev_consts(par, dev)
    x = torch.as_tensor(batch_to_limbs(np.mod(b, n_b), par.Lin), device=dev)
    nw = -(-max_ebits // WINDOW)
    T = _rns_make_fixed_table(rns_from_limbs(x, cs), ctx_parts(ctx.rows, par), cs, par,
                              nw).to(torch.int32)
    return [T[:, :, i].contiguous() for i in range(b.shape[0])]


def rns_fixed_prod_dispatch(ctx: RnsCtx, n_ints, tables, exps, ebits_list, nbits: int,
                            gmap=None) -> RnsLazy:
    """Launch the squaring-free product prod_i base_i^exps[i] from the
    tables of rns_make_tables; returns an RnsLazy handle.  The product is K2
    (core/pallas_rns.py) on the card and its plain version, fixed_plain (the
    reference's _rns_fixed_prod_kernel), on the CPU.  gmap: optional
    flattened table-group row per call element (see fixed_prod_dispatch)."""
    from . import pallas_rns

    return pallas_rns.fixed_prod_dispatch(ctx, n_ints, tables, exps, ebits_list, nbits,
                                          gmap=gmap)


@dataclasses.dataclass
class RnsLazy:
    """A dispatched-but-undecoded modexp: `parts` holds the device column
    sums [lead, Lout]; ints() runs the exact host decode.  `mults` are plain
    factors folded into the decode loop."""

    parts: tuple
    shape: tuple
    n_b: np.ndarray
    MA: int
    mults: tuple = ()

    def ints(self) -> np.ndarray:
        return _rns_decode(self.parts, self.shape, self.n_b, self.MA, self.mults)


def rns_exp_dispatch(ctx: RnsCtx, n_ints, base_ints, exp_ints, ebits: int,
                     reduce_axis0: bool = False) -> RnsLazy:
    """Launch x^e mod n via RNS Montgomery; returns an RnsLazy handle.
    The exponentiation is K1 (core/pallas_rns.py) on the card and its plain
    version on the CPU."""
    from . import pallas_rns

    return pallas_rns.exp_dispatch(ctx, n_ints, base_ints, exp_ints, ebits,
                                   reduce_axis0=reduce_axis0)


def _rns_decode(parts, shape, n_b, MA, mults=()) -> np.ndarray:
    """Column sums (< K*2^32 each) -> object ints (v mod MA) mod n."""
    from ..device import to_numpy
    from .limbs import batch_from_limbs

    cols = to_numpy(parts[0]).astype(np.int64)
    Lout = cols.shape[-1]
    flat = cols.reshape(-1, Lout)
    canon = np.zeros((flat.shape[0], Lout + 3), dtype=np.int64)
    carry = np.zeros(flat.shape[0], dtype=np.int64)
    for c in range(Lout):
        v = flat[:, c] + carry
        canon[:, c] = v & 0xFFFF
        carry = v >> 16
    for c in range(Lout, Lout + 3):
        canon[:, c] = carry & 0xFFFF
        carry >>= 16
    v_ints = batch_from_limbs(canon)
    out = np.empty(flat.shape[0], dtype=object)
    flat_n = np.asarray(n_b, dtype=object).reshape(-1)
    fl_m = [np.broadcast_to(np.asarray(m, dtype=object), shape).reshape(-1)
            for m in mults]
    for i in range(flat.shape[0]):
        nv = int(flat_n[i])
        v = (int(v_ints[i]) % MA) % nv
        for fm in fl_m:
            v = v * int(fm[i]) % nv
        out[i] = v
    return out.reshape(shape) if shape else out[0]
