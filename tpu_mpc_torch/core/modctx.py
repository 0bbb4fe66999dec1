"""ModCtx: host ints + device RNS constants for a batch of moduli
(port of tpu_mpc/core/modctx.py).

The ZK layer works in a hybrid split: modexps run batched on the device,
multiplies, inversions and hashes run on host ints.  ModCtx owns one batch
of moduli in both forms and rounds exponent widths up to a fixed ladder of
classes.

Two decisions of the port:

* RNS is always on.  Every modexp is K1 (core/pallas_rns.py): the CUDA
  kernel on the card, its plain PyTorch version on the CPU.  The
  reference's CIOS limb path (montgomery.mont_exp*) is not carried over at
  Paillier widths.
* Fixed-base products (make_tables_rns / pow_fixed_prod_rns) are K2, from
  window tables built once per long-lived base; the reference's CIOS table
  path (make_tables / pow_fixed_prod) is not carried over.
* Multi-base pow_prod stacks its bases on a new leading axis, runs ONE K1
  launch over them, and folds the product and the `mults` on the host with
  host_mulmod.  The integers equal mont_exp_prod's.  (The reference runs a
  CIOS Straus loop compiled by XLA there; written in eager torch at 4096
  bits that loop would take millions of launches per call.)

The launch log (TPU_MPC_TORCH_PROFILE=1, the reference's TPU_MPC_PROFILE):
one row (kind, batch, bits, ebits, seconds) per modexp, EC, decrypt and
host-arithmetic call, with the reference's kind names (PROFILE_KINDS), so
that a pass's host time splits by call; profile_summary() prints it.
"""

from __future__ import annotations

import dataclasses
import os
import time

import numpy as np
import torch

from .. import native
from ..device import resolve_device

# The launch log.  Call sites read PROFILE when they are called, so it can
# be switched at run time.  On, every ModCtx call resolves its launch (a
# host read, which waits for the card) and prof_call synchronises with the
# card, so a row covers its own launches; off, a call pays one branch.
# Host rows may nest inside device rows (a decode's host:from_limbs inside
# its pow_rns), as in the reference.
PROFILE = bool(int(os.environ.get("TPU_MPC_TORCH_PROFILE", "0")))
PROFILE_LOG: list[tuple] = []  # (kind, batch, mod_bits, ebits, seconds)
# the kinds the port logs, each one of the reference's names
PROFILE_KINDS = (
    "pow_rns", "pow_red0", "powfix_rns", "pow_prod", "decrypt",
    "ec:smul", "ec:mulG", "ec:mulH2", "ec:mulFB", "ec:dmul", "ec:affine", "ec:hashpts",
    "host:mulmod", "host:prodax0", "host:invmod", "host:digest", "host:to_limbs",
    "host:from_limbs",
)


def _sync(out) -> None:
    """torch.cuda.synchronize on the device of the first card tensor in
    `out` (a tensor, or tuples and lists of them)."""
    todo = [out]
    while todo:
        a = todo.pop()
        if isinstance(a, torch.Tensor):
            if a.is_cuda:
                torch.cuda.synchronize(a.device)
                return
        elif isinstance(a, (tuple, list)):
            todo.extend(a)


def prof_call(kind: str, batch: int, bits: int, fn):
    """fn(); with PROFILE on, timed up to the end of its launches on the
    card, and logged as one row."""
    if not PROFILE:
        return fn()
    t0 = time.perf_counter()
    out = fn()
    _sync(out)
    PROFILE_LOG.append((kind, batch, bits, "-", time.perf_counter() - t0))
    return out


def _log_resolved(kind: str, shape, bits: int, ebits, t0: float, lz):
    """PROFILE: resolve a ModCtx launch and log its row."""
    res = resolve(lz)
    PROFILE_LOG.append((kind, int(np.prod(shape, dtype=np.int64)) if shape else 1, bits,
                        ebits, time.perf_counter() - t0))
    return res


# Peaks of the card the port is measured on, an NVIDIA H100 SXM (NVIDIA H100
# 80GB HBM3 at 700 W in PERF.md).  HBM: 3.35 TB/s (NVIDIA's data sheet).  The
# kernels' arithmetic is 32x32-bit integer multiply-adds (IMAD, one each,
# widening or not): 132 SMs x 64 INT32 lanes per clock x 1.98 GHz (the boost
# clock behind the data sheet's 67 TFLOP/s float32 = 132 x 128 x 2 x 1.98
# GHz).  A widening IMAD counted as one instruction keeps a bound a lower
# bound.  K1 and K2 run their extension and decode dots as u8 products on
# the tensor cores: 1979 T int8 operations/s dense = 989.5 T MAC/s.
PEAK_BYTES = 3.35e12
PEAK_IMAD = 132 * 64 * 1.98e9
PEAK_U8_MAC = 1979e12 / 2


def k1_montmuls(ne2: int) -> int:
    """RNS Montgomery multiplies of one K1 lane with `ne2` 32-bit exponent
    words: x*R^2, 14 table entries, 8 windows of 4 squarings + 1 multiply a
    word, the decode's *1."""
    return 1 + 14 + ne2 * 8 * 5 + 1


def k2_montmuls(nwins) -> int:
    """RNS Montgomery multiplies of one K2 lane: one a window of every base,
    the decode's *1."""
    return sum(nwins) + 1


def rns_work(par, mm: int, lanes: int, prologue: bool):
    """(u8 MACs, IMADs, IMAD-only count) of `mm` RNS Montgomery multiplies
    plus the decode (and K1's prologue) on `lanes` lanes (par: rns.RnsParams).
    A multiply is two extension products, K (Kp+1) + Kp (K+1) entries, each
    4 u8 chunk products on the tensor cores; the decode is K Lout entries.
    Channel work: 3 products on each A-channel, 4 on each B-channel and 3 on
    the r channel, each one multiply-add plus a Barrett reduction (2), and
    the three-reduction fold of every extension output (6 per channel).  The
    IMAD-only count runs the dots as IMADs beside 7 CH channel products, as
    the one-lane-per-block kernels did."""
    K, Kp, CH = par.K, par.Kp, par.CH
    ext = K * (Kp + 1) + Kp * (K + 1)
    u8 = lanes * 4 * (mm * ext + K * par.Lout)
    chan = 3 * (3 * K + 4 * Kp + 3) + 6 * (K + Kp)
    imad = lanes * (mm * chan + (par.Lin * (K + Kp) + 4 * (K + Kp) if prologue else 0)
                    + 3 * K)
    old = lanes * (mm * (ext + 7 * CH) + (par.Lin * (K + Kp) if prologue else 0)
                   + K * par.Lout)
    return u8, imad, old


def _rns_rates(kind: str, bits: int, ebs, items: int, tot: float):
    """(u8 MAC/s, IMAD/s) achieved by a class of K1 / K2 rows, by rns_work."""
    from .rns import WINDOW, RnsParams

    if kind == "powfix_rns":
        mm, prologue = k2_montmuls([-(-eb // WINDOW) for eb in ebs]), False
    else:
        mm, prologue = k1_montmuls(-(-ebs // 32)), True
    u8, imad, _ = rns_work(RnsParams(bits), mm, items, prologue)
    return u8 / tot, imad / tot


def profile_summary(reset: bool = True) -> str:
    """The launch log as a table, one line a (kind, bits, ebits) class by
    total time, with achieved-against-peak columns for the K1 / K2 classes
    (tensor-core u8 MAC/s and IMAD/s against the H100's peaks), then the
    TOTAL line.  Rows that its own work model logs (the first RnsParams of a
    width encodes limbs) are dropped."""
    n_log = len(PROFILE_LOG)
    rows = {}
    for kind, b, bits, ebs, dt in PROFILE_LOG:
        key = (kind, bits, ebs)
        n, tot, items = rows.get(key, (0, 0.0, 0))
        rows[key] = (n + 1, tot + dt, items + b)
    lines = []
    for (kind, bits, ebs), (n, tot, items) in sorted(rows.items(), key=lambda kv: -kv[1][1]):
        line = (f"{kind:11s} mod={bits:5d} ebits={str(ebs):18s} "
                f"calls={n:4d} total={tot:8.2f}s")
        if kind in ("pow_rns", "pow_red0", "powfix_rns") and tot > 0:
            tc, imad = _rns_rates(kind, bits, ebs, items, tot)
            line += (f"  tc={tc / 1e12:6.2f}TMAC/s ({100 * tc / PEAK_U8_MAC:4.1f}% H100)"
                     f" imad={imad / 1e12:5.2f}T/s ({100 * imad / PEAK_IMAD:4.1f}% H100)")
        lines.append(line)
    del PROFILE_LOG[n_log:]
    total = sum(dt for *_, dt in PROFILE_LOG)
    lines.append(f"TOTAL modexp launches: {len(PROFILE_LOG)}  {total:.2f}s")
    if reset:
        PROFILE_LOG.clear()
    return "\n".join(lines)


# exponent-width ladder (bits): exponents are zero-padded up to the next class
EBITS_CLASSES = (
    16, 64, 128, 256, 384, 512, 776, 1024, 1552, 2048, 2320, 2576, 2832, 3104,
    4096
)


def ebits_class(bits: int) -> int:
    for c in EBITS_CLASSES:
        if bits <= c:
            return c
    raise ValueError(f"exponent too wide: {bits} bits")


def _max_bits(a) -> int:
    return max((int(v).bit_length() for v in np.asarray(a, dtype=object).reshape(-1).tolist()),
               default=1)


# from this many products on, host_mulmod and host_prod_axis0 run on GMP
# (native/hostmul.cpp), the reference's routing (tpu_mpc/core/modctx.py)
NATIVE_MIN_LANES = 32


def _ints(a) -> list:
    return [int(v) for v in np.asarray(a, dtype=object).reshape(-1).tolist()]


def _width_for(cols: list) -> int:
    """Bytes per value for the GMP helper: the widest value of the int
    lists `cols`, rounded up to whole 64-bit words."""
    bits = max(v.bit_length() for c in cols for v in c)
    return max(1, (bits + 63) // 64) * 8


def _native_width(cols: list, mods: list, lanes: int):
    """_width_for(cols + [mods]) where the GMP helper gives the python
    loop's values, else None: fewer than NATIVE_MIN_LANES products, no
    operand, a negative operand (python's % gives the non-negative result)
    or a modulus below 1 (the loop raises on 0)."""
    if lanes < NATIVE_MIN_LANES or not cols or min(mods) < 1 or any(min(c) < 0 for c in cols):
        return None
    return _width_for(cols + [mods])


def _pack_ints(vals: list, W: int) -> bytes:
    """Python ints -> W-byte little-endian values, back to back."""
    return b"".join(v.to_bytes(W, "little") for v in vals)


def _unpack_ints(raw: bytes, n: int, W: int) -> np.ndarray:
    """n W-byte little-endian values -> an object-int array."""
    mv = memoryview(raw)
    out = np.empty(n, dtype=object)
    for i in range(n):
        out[i] = int.from_bytes(mv[i * W:(i + 1) * W], "little")
    return out


def host_mulmod(*arrays_then_mod) -> np.ndarray:
    """Elementwise product of object-int arrays modulo the last argument.
    From NATIVE_MIN_LANES products on it runs on GMP (native.hostmul), as
    in the reference, where the input allows (_native_width); else a python
    loop.  Both give the same values."""
    t0 = time.perf_counter() if PROFILE else 0.0
    *arrays, mod = arrays_then_mod
    arrays = [np.asarray(a, dtype=object) for a in arrays]
    mod = np.asarray(mod, dtype=object)
    shape = np.broadcast_shapes(*(a.shape for a in arrays), mod.shape)
    cols = [_ints(np.broadcast_to(a, shape)) for a in arrays]
    mods = _ints(np.broadcast_to(mod, shape))
    B = len(mods)
    W = _native_width(cols, mods, B)
    if W is not None:
        raw = native.hostmul.mulmod_batch([_pack_ints(c, W) for c in cols],
                                          _pack_ints(mods, W), B, W)
        out = _unpack_ints(raw, B, W)
    else:
        out = np.empty(B, dtype=object)
        for b in range(B):
            acc = 1
            m = mods[b]
            for c in cols:
                acc = acc * c[b] % m
            out[b] = acc
    if PROFILE:
        PROFILE_LOG.append(("host:mulmod", B * len(cols), 0, "-", time.perf_counter() - t0))
    return out.reshape(shape)


def host_invmod(a, mod) -> np.ndarray:
    """Elementwise a^{-1} mod `mod` on object ints; 0 where a is not
    invertible, so that a check built on it fails (the reference's
    zk/range_proofs.py:_invmod)."""
    t0 = time.perf_counter() if PROFILE else 0.0
    a = np.asarray(a, dtype=object)
    mod = np.asarray(mod, dtype=object)
    shape = np.broadcast_shapes(a.shape, mod.shape)
    fa = np.broadcast_to(a, shape).reshape(-1)
    fm = np.broadcast_to(mod, shape).reshape(-1)
    out = np.empty(fa.shape[0], dtype=object)
    for b in range(fa.shape[0]):
        try:
            out[b] = pow(int(fa[b]), -1, int(fm[b]))
        except ValueError:
            out[b] = 0
    if PROFILE:
        PROFILE_LOG.append(("host:invmod", fa.shape[0], 0, "-", time.perf_counter() - t0))
    return out.reshape(shape)


def host_prod_axis0(vals, mod) -> np.ndarray:
    """prod over the leading axis of object-int `vals` modulo `mod`.  From
    NATIVE_MIN_LANES values (S * J) on it runs on GMP, as host_mulmod."""
    t0 = time.perf_counter() if PROFILE else 0.0
    vals = np.asarray(vals, dtype=object)
    S, rest = vals.shape[0], vals.shape[1:]
    mods = _ints(np.broadcast_to(np.asarray(mod, dtype=object), (1,) + rest))
    flat = _ints(vals)
    J = len(mods)
    W = _native_width([flat], mods, S * J)
    if W is not None:
        raw = native.hostmul.prodmod_axis0(_pack_ints(flat, W), S, _pack_ints(mods, W), J, W)
        out = _unpack_ints(raw, J, W)
    else:
        out = np.empty(J, dtype=object)
        for j in range(J):
            m = mods[j]
            acc = 1
            for s in range(S):
                acc = acc * flat[s * J + j] % m
            out[j] = acc
    if PROFILE:
        PROFILE_LOG.append(("host:prodax0", S * J, 0, "-", time.perf_counter() - t0))
    return out.reshape((1,) + rest)


def resolve(x):
    """Lazy handle (anything with .ints()) -> object ints; else pass-through."""
    return x.ints() if hasattr(x, "ints") else x


@dataclasses.dataclass
class LazyMap:
    """Deferred host post-processing of a lazy modexp result."""

    src: object
    fn: object

    def ints(self):
        return self.fn(resolve(self.src))


@dataclasses.dataclass
class DeferredLaunch:
    """A launch that has NOT been dispatched: .ints() dispatches on first
    use and caches.  Holds values only rare paths need (e.g. the MtA
    responder's encryption randomness r = g^t, revealed only on blame): the
    honest path never pays the launch."""

    fn: object
    _cache: object = None

    def ints(self):
        if self._cache is None:
            self._cache = resolve(self.fn())
        return self._cache


def _take_t(t, indices, axis: int):
    """np.take along a leading batch axis of a tensor (array indices)."""
    idx = np.asarray(indices)
    sel = torch.index_select(
        t, axis, torch.as_tensor(idx.reshape(-1), dtype=torch.int64, device=t.device))
    return sel.reshape(t.shape[:axis] + idx.shape + t.shape[axis + 1:])


@dataclasses.dataclass
class ModCtx:
    """A batch of moduli: host ints [...] + the RNS constants on a device."""

    n_ints: np.ndarray
    bits: int
    _rns: object            # core.rns.RnsCtx, rows [..., 3*CH]

    @property
    def device(self):
        return self._rns.rows.device

    def rns_ctx(self):
        return self._rns

    @classmethod
    def from_ints(cls, ns, bits: int, device=None) -> "ModCtx":
        from .rns import RnsCtx

        ns = np.asarray(ns, dtype=object)
        return cls(n_ints=ns, bits=bits,
                   _rns=RnsCtx.from_ints(ns, bits, resolve_device(device)))

    @property
    def batch_shape(self):
        return self.n_ints.shape

    def _view(self, fn_np, fn_t) -> "ModCtx":
        return ModCtx(n_ints=fn_np(self.n_ints), bits=self.bits,
                      _rns=self._rns.map_batch(fn_t))

    def take(self, indices, axis: int) -> "ModCtx":
        """Select a sub-batch along a batch axis (e.g. the signer subset)."""
        return self._view(lambda a: np.take(a, indices, axis=axis),
                          lambda t: _take_t(t, indices, axis))

    def tile(self, S: int) -> "ModCtx":
        """Broadcast a leading batch axis of size 1 to size S."""
        return self._view(lambda a: np.broadcast_to(a, (S,) + a.shape[1:]).copy(),
                          lambda t: t.expand((S,) + tuple(t.shape[1:])))

    def expand(self, axis: int) -> "ModCtx":
        """Insert a broadcast batch axis (for pair-matrix layouts)."""
        return self._view(lambda a: np.expand_dims(a, axis),
                          lambda t: t.unsqueeze(axis))

    def repeat_lead(self, R: int, axis: int = 0) -> "ModCtx":
        """Tile a batch axis R times, interleaved (new index i -> old i % B)."""
        def rep(a, nd):
            reps = [1] * nd
            reps[axis] = R
            return reps

        return self._view(lambda a: np.tile(a, rep(a, a.ndim)),
                          lambda t: t.repeat(*rep(t, t.dim())))

    def reshape_lead(self, R: int, G: int) -> "ModCtx":
        """View the leading batch axis S = R*G as (R, G)."""
        return self._view(lambda a: a.reshape((R, G) + a.shape[1:]),
                          lambda t: t.reshape((R, G) + tuple(t.shape[1:])))

    def pow_prod_axis0(self, base_ints, exp_ints, ebits_hint: int, sync: bool = True):
        """prod_s base_s^{exp_s} over the LEADING batch axis, folded on the
        device before decode (precondition: moduli constant along axis 0).
        Returns shape (1,) + batch[1:]."""
        from . import rns

        base = np.asarray(base_ints, dtype=object)
        expv = np.asarray(exp_ints, dtype=object)
        shape = np.broadcast_shapes(base.shape, expv.shape, self.batch_shape)
        eb = ebits_class(max(ebits_hint, 1))
        if len(shape) >= 1 and shape[0] > 1:
            t0 = time.perf_counter() if PROFILE else 0.0
            ctx0 = self._rns.map_batch(lambda t: t[:1])
            lz = rns.rns_exp_dispatch(
                ctx0, self.n_ints[:1], np.broadcast_to(base, shape),
                np.broadcast_to(expv, shape), eb, reduce_axis0=True)
            if PROFILE:
                return _log_resolved("pow_red0", shape, self.bits, eb, t0, lz)
            return resolve(lz) if sync else lz
        vals = self.pow(base, expv, ebits_hint=ebits_hint, sync=True)
        return host_prod_axis0(np.broadcast_to(np.asarray(vals, dtype=object), shape),
                               np.broadcast_to(self.n_ints, shape)[:1])

    def pow(self, base_ints, exp_ints, ebits_hint: int | None = None, sync: bool = True):
        """(base ** exp) mod n, batched on the device.  Exponents must be
        non-negative and < 2^ebits_hint (default: measured).  sync=False
        returns a lazy handle."""
        from . import rns

        base = np.asarray(base_ints, dtype=object)
        expv = np.asarray(exp_ints, dtype=object)
        shape = np.broadcast_shapes(base.shape, expv.shape, self.batch_shape)
        if ebits_hint is None:
            ebits_hint = _max_bits(expv)
        eb = ebits_class(max(ebits_hint, 1))
        t0 = time.perf_counter() if PROFILE else 0.0
        lz = rns.rns_exp_dispatch(self._rns, self.n_ints, np.broadcast_to(base, shape),
                                  np.broadcast_to(expv, shape), eb)
        if PROFILE:
            return _log_resolved("pow_rns", shape, self.bits, eb, t0, lz)
        return resolve(lz) if sync else lz

    def pow_prod(self, bases, exps, ebits_hints=None, mults=(), sync: bool = True):
        """prod_i bases[i]**exps[i] * prod_j mults[j] mod n.  All bases ride
        one K1 launch (stacked on a new leading axis); the product and the
        mults fold on the host."""
        from . import rns

        bases = [np.asarray(b, dtype=object) for b in bases]
        exps = [np.asarray(e, dtype=object) for e in exps]
        mults = [np.asarray(m, dtype=object) for m in mults]
        shape = np.broadcast_shapes(
            self.batch_shape, *(b.shape for b in bases), *(e.shape for e in exps),
            *(m.shape for m in mults))
        ebs = []
        for k, e in enumerate(exps):
            hint = None if ebits_hints is None else ebits_hints[k]
            if hint is None:
                hint = _max_bits(np.broadcast_to(e, shape))
            ebs.append(ebits_class(max(hint, 1)))
        n_b = np.broadcast_to(self.n_ints, shape)
        t0 = time.perf_counter() if PROFILE else 0.0
        if len(bases) == 1:
            lz = rns.rns_exp_dispatch(self._rns, self.n_ints,
                                      np.broadcast_to(bases[0], shape),
                                      np.broadcast_to(exps[0], shape), ebs[0])
            if mults:
                lz.mults = tuple(mults)
            if PROFILE:
                return _log_resolved("pow_rns", shape, self.bits, ebs[0], t0, lz)
            return resolve(lz) if sync else lz
        kb = len(bases)
        stk = lambda arrs: np.stack([np.broadcast_to(a, shape) for a in arrs])
        lz = rns.rns_exp_dispatch(self._rns, self.n_ints, stk(bases), stk(exps), max(ebs))
        ms = list(mults)
        out = LazyMap(lz, lambda v: host_mulmod(*(v[i] for i in range(kb)), *ms, n_b))
        if PROFILE:
            # the reference's kind for a multi-base product (its CIOS Straus launch)
            return _log_resolved("pow_prod", shape, self.bits, tuple(ebs), t0, out)
        return resolve(out) if sync else out

    def make_tables_rns(self, bases, max_ebits: int) -> list:
        """Fixed-base window tables of `bases` [k, ...batch] (core/rns.py:
        rns_make_tables), wide enough for exponents below the class of
        max_ebits: one int32 tensor [nw, 16, ...batch, CH] per base."""
        from . import rns

        return rns.rns_make_tables(self._rns, self.n_ints, np.asarray(bases, dtype=object),
                                   ebits_class(max_ebits), self.bits)

    def pow_fixed_prod_rns(self, tables, exps, ebits_hints, sync: bool = True, gmap=None):
        """prod_i base_i^exps[i] mod n from make_tables_rns tables: zero
        squarings, one K2 launch.  Exponent widths round up to their class.
        gmap (optional): the flattened table-group row of each call element
        (core/pallas_rns.py:fixed_prod_dispatch)."""
        from . import rns

        ebs = [ebits_class(max(h, 1)) for h in ebits_hints]
        t0 = time.perf_counter() if PROFILE else 0.0
        lz = rns.rns_fixed_prod_dispatch(self._rns, self.n_ints, tables, exps, ebs, self.bits,
                                         gmap=gmap)
        if PROFILE:
            return _log_resolved("powfix_rns", lz.shape, self.bits, tuple(ebs), t0, lz)
        return resolve(lz) if sync else lz
