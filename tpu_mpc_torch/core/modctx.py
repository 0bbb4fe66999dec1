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
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..device import resolve_device

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


def host_mulmod(*arrays_then_mod) -> np.ndarray:
    """Elementwise product of object-int arrays modulo the last argument."""
    *arrays, mod = arrays_then_mod
    arrays = [np.asarray(a, dtype=object) for a in arrays]
    mod = np.asarray(mod, dtype=object)
    shape = np.broadcast_shapes(*(a.shape for a in arrays), mod.shape)
    flat = [np.broadcast_to(a, shape).reshape(-1) for a in arrays]
    fm = np.broadcast_to(mod, shape).reshape(-1)
    out = np.empty(fm.shape[0], dtype=object)
    for b in range(fm.shape[0]):
        acc = 1
        m = int(fm[b])
        for a in flat:
            acc = acc * int(a[b]) % m
        out[b] = acc
    return out.reshape(shape)


def host_invmod(a, mod) -> np.ndarray:
    """Elementwise a^{-1} mod `mod` on object ints; 0 where a is not
    invertible, so that a check built on it fails (the reference's
    zk/range_proofs.py:_invmod)."""
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
    return out.reshape(shape)


def host_prod_axis0(vals, mod) -> np.ndarray:
    """prod over the leading axis of object-int `vals` modulo `mod`."""
    vals = np.asarray(vals, dtype=object)
    S, rest = vals.shape[0], vals.shape[1:]
    fm = np.broadcast_to(np.asarray(mod, dtype=object), (1,) + rest).reshape(-1)
    flat = vals.reshape(S, -1)
    out = np.empty(flat.shape[1], dtype=object)
    for j in range(flat.shape[1]):
        m = int(fm[j])
        acc = 1
        for s in range(S):
            acc = acc * int(flat[s, j]) % m
        out[j] = acc
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
            ctx0 = self._rns.map_batch(lambda t: t[:1])
            lz = rns.rns_exp_dispatch(
                ctx0, self.n_ints[:1], np.broadcast_to(base, shape),
                np.broadcast_to(expv, shape), eb, reduce_axis0=True)
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
        lz = rns.rns_exp_dispatch(self._rns, self.n_ints, np.broadcast_to(base, shape),
                                  np.broadcast_to(expv, shape), eb)
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
        if len(bases) == 1:
            lz = rns.rns_exp_dispatch(self._rns, self.n_ints,
                                      np.broadcast_to(bases[0], shape),
                                      np.broadcast_to(exps[0], shape), ebs[0])
            if mults:
                lz.mults = tuple(mults)
            return resolve(lz) if sync else lz
        kb = len(bases)
        stk = lambda arrs: np.stack([np.broadcast_to(a, shape) for a in arrs])
        lz = rns.rns_exp_dispatch(self._rns, self.n_ints, stk(bases), stk(exps), max(ebs))
        ms = list(mults)
        out = LazyMap(lz, lambda v: host_mulmod(*(v[i] for i in range(kb)), *ms, n_b))
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
        lz = rns.rns_fixed_prod_dispatch(self._rns, self.n_ints, tables, exps, ebs, self.bits,
                                         gmap=gmap)
        return resolve(lz) if sync else lz
