"""Batched MtA range proofs (GG19 Appendix A) — port of tpu_mpc/zk/range_proofs.py.

All modexps run batched on the device (ModCtx: kernel K1); multiplies,
inverses and SHA-256 run on host ints.  Proof shapes and checks are the
reference's:

  AliceProof(z, e, s, s1, s2) proves Enc plaintext a < q^3;
  BobProof(t, z, e, s, s1, s2, t1, t2) (+ u point for the "wc" variant).

Verifiers check the inverse-free products (the sigma commitments ride on
the wire and the hash binds them).

Two configurations, selected by TPU_MPC_TORCH_ENC_TABLES (enc_tables_enabled):

  tables (on; the default on the card, the reference's default off the
    CPU): h1/h2 window tables per statement (DlogStatementBatch.ensure_tables)
    and randomizer tables for g mod N and h = g^N mod N^2 per Paillier key
    (PaillierCtxBatch.ensure_enc_tables), built once per key set before
    tiling.  Every ring-Pedersen commitment, every r^N and every folded
    response s = g^(r_t e + t_beta) is then a fixed-base product with zero
    squarings (ModCtx.pow_fixed_prod_rns: kernel K2).
  uniform (off; the default on the CPU): no tables; h1^a h2^b is
    ModCtx.pow_prod (K1) and encryption randomizers are uniform units, the
    reference's reference-exact randomizer mode (TPU_MPC_ENC_TABLES=0).

The port lets the one switch gate both table sets, so "off" is the whole
slice-1 configuration; the reference gates only the randomizer tables by
its switch and builds h1/h2 tables whenever its RNS path is on.  Both give
the same integers: the tables change which kernel computes a power, and
the randomizer tables change how r is sampled (uniform in <g> instead of
Z_N^*, THREAT_MODEL.md section 7), exactly as in the reference.
"""

from __future__ import annotations

import dataclasses
import hashlib
import math
import os

import numpy as np

from ..core.modctx import DeferredLaunch, LazyMap, ModCtx, host_mulmod as _mulmod, resolve
from ..device import to_numpy
from ..hashes.fiat_shamir import digest_rows
from ..host import ec as hec

Q = hec.N
Q3 = Q**3
E_BITS = 256  # Fiat-Shamir challenge width (SHA-256)


def enc_tables_enabled(device) -> bool:
    """The tables configuration (module docstring): TPU_MPC_TORCH_ENC_TABLES
    "1" on, "0" off, unset = on when the key lives on a CUDA device and off
    on the CPU (the reference's auto rule: on for accelerators).  Read per
    call, not at import: it is a security-relevant opt-out and must work
    regardless of import order."""
    env = os.environ.get("TPU_MPC_TORCH_ENC_TABLES")
    if env is not None:
        return env == "1"
    return getattr(device, "type", str(device)) == "cuda"


def _table_group_rows(gmap, bdims, batch_shape, shape):
    """Flattened table-group row per call element, for group-compressed
    tables (G groups serving S sessions; the `gmap` of
    ModCtx.pow_fixed_prod_rns).

    gmap: [S] session -> group.  bdims: the table batch dims (G,) + rest,
    where rest right-aligns with batch_shape[1:] (party slots etc.).  shape:
    the call batch shape, possibly with extra leading stacked axes.
    Row-major flattened row = g * prod(rest) + sub(rest)."""
    S = int(batch_shape[0])
    extra = len(shape) - len(batch_shape)
    gm = np.asarray(gmap, dtype=np.int64).reshape(
        (1,) * extra + (S,) + (1,) * (len(batch_shape) - 1))
    rest = tuple(int(d) for d in bdims[1:])
    pr = int(np.prod(rest, dtype=np.int64)) if rest else 1
    rows = gm * pr
    if pr > 1:
        rows = rows + np.arange(pr, dtype=np.int64).reshape((1,) * (len(shape) - len(rest))
                                                             + rest)
    return np.broadcast_to(rows, shape)


def _gmap_rows(gmap, T, batch_shape, shape):
    """The flattened table-group rows of a call of batch `shape` into the
    tables T compressed behind gmap (None without gmap)."""
    return None if gmap is None else _table_group_rows(gmap, T.shape[2:-1], batch_shape, shape)


def _take_gmap(gmap, indices, axis: int):
    """The gmap of a take: sliced by a sessions-axis take, else unchanged."""
    return np.take(gmap, indices, axis=0) if axis == 0 and gmap is not None else gmap


def _rep_lead(a, R: int, lead: int = 0):
    """np.tile of axis `lead` R times (interleaved: new index i -> old i % B)."""
    if a is None:
        return None
    return np.tile(a, (1,) * lead + (R,) + (1,) * (a.ndim - lead - 1))


def _grow_tables(T, extra: int):
    """Insert `extra` size-1 table batch dims after the [nw, 16] axes, so
    that a call with extra leading batch dims (e.g. the stacked gamma/w path
    axis) right-aligns against the tables' batch."""
    return T.reshape(tuple(T.shape[:2]) + (1,) * extra + tuple(T.shape[2:]))


@dataclasses.dataclass
class DlogStatementBatch:
    """(N_tilde, h1, h2) batch — the ring-Pedersen setup of each party.

    tables_rns optionally holds the h1/h2 fixed-base window tables (two
    int32 tensors [nw, 16, ...batch, CH], ModCtx.make_tables_rns): h1/h2 are
    fixed for the life of a key, so every ring-Pedersen commitment can run
    with zero squarings (K2).  Build once on the small root statement
    (ensure_tables) before tile/take/expand; derived views carry the tables
    along their batch dims.

    Multi-tenant serving (repeat_interleaved): G distinct key groups serve
    S = G*R sessions, session s using group s % G.  The tables stay
    compressed at G rows on their sessions axis; `gmap` [S] maps each
    session to its group row and routes every K2 product through it, and
    n_groups = G tells the grouped batch verification (zk/batch_verify.py)
    which layout to verify.  The reference falls back to pow_prod off the
    TPU for compressed tables; the port keeps the table path on the CPU too,
    since K2's plain version takes gmap (same integers either way)."""

    ctx: ModCtx               # N_tilde moduli
    h1: np.ndarray
    h2: np.ndarray
    tables_rns: tuple | None = None   # (T1, T2), batch dims at positions 2..-2
    gmap: np.ndarray | None = None    # [S] session -> key group (compressed tables)
    n_groups: int = 1

    _TABLE_MAX_BASES = 64  # tables cost ~26 MB per statement at 2048 bits (int32)
    # widest per-session ring-Pedersen exponent is < Q^3 * N_tilde * 2^16;
    # the cross-session batched RHS (zk/batch_verify.py) sums gamma-weighted
    # responses, adding GAMMA_BITS + log2(S) <= 160 bits on top
    _BATCH_SUM_SLACK = 160

    @classmethod
    def from_ints(cls, n_tildes, h1s, h2s, bits: int = 2048, device=None):
        return cls(
            ctx=ModCtx.from_ints(n_tildes, bits, device),
            h1=np.asarray(h1s, dtype=object),
            h2=np.asarray(h2s, dtype=object),
        )

    def ensure_tables(self) -> "DlogStatementBatch":
        """Build the h1/h2 tables (idempotent; in the tables configuration
        only).  max_ebits covers the widest ring-Pedersen exponent plus the
        batch-verify sum slack.  A no-op for batches of more than 64
        statements: the tables are for a small set of long-lived setups (one
        signer group's [1, n] statements serving many sessions)."""
        if self.tables_rns is not None or not enc_tables_enabled(self.ctx.device):
            return self
        nstat = int(np.prod(self.ctx.batch_shape)) if self.ctx.batch_shape else 1
        if nstat > self._TABLE_MAX_BASES:
            return self
        stacked = np.stack([np.broadcast_to(self.h1, self.ctx.batch_shape),
                            np.broadcast_to(self.h2, self.ctx.batch_shape)])
        self.tables_rns = tuple(self.ctx.make_tables_rns(
            stacked, max_ebits=768 + self.ctx.bits + 16 + self._BATCH_SUM_SLACK))
        return self

    def pow_h1h2(self, e1, e2, hints, sync: bool = True):
        """h1^e1 * h2^e2 mod N_tilde: K2 from the tables when they exist,
        else ModCtx.pow_prod (K1).  hints (required) are exponent widths
        from the sampling domain or the clamped field width."""
        if self.tables_rns is not None:
            shape = np.broadcast_shapes(np.shape(e1), np.shape(e2), self.ctx.batch_shape)
            gmap = _gmap_rows(self.gmap, self.tables_rns[0], self.ctx.batch_shape, shape)
            return self.ctx.pow_fixed_prod_rns(self.tables_rns, [e1, e2], hints, sync=sync,
                                               gmap=gmap)
        return self.ctx.pow_prod([self.h1, self.h2], [e1, e2], ebits_hints=hints, sync=sync)

    def _tabs(self, fn):
        return None if self.tables_rns is None else tuple(fn(T) for T in self.tables_rns)

    def take(self, indices, axis: int) -> "DlogStatementBatch":
        from ..core.modctx import _take_t

        # group-compressed tables index G groups, not S sessions, on their
        # sessions axis: a sessions-axis take slices gmap, never the tables
        take_tabs = axis > 0 or self.gmap is None
        return DlogStatementBatch(
            ctx=self.ctx.take(indices, axis),
            h1=np.take(self.h1, indices, axis=axis),
            h2=np.take(self.h2, indices, axis=axis),
            tables_rns=self._tabs(lambda T: _take_t(T, indices, 2 + axis)) if take_tabs
            else self.tables_rns,
            gmap=_take_gmap(self.gmap, indices, axis),
            n_groups=self.n_groups,
        )

    def expand(self, axis: int) -> "DlogStatementBatch":
        return DlogStatementBatch(
            ctx=self.ctx.expand(axis),
            h1=np.expand_dims(self.h1, axis),
            h2=np.expand_dims(self.h2, axis),
            tables_rns=self._tabs(lambda T: T.unsqueeze(2 + axis)),
            gmap=self.gmap,
            n_groups=self.n_groups,
        )

    def swapped(self) -> "DlogStatementBatch":
        """(N, g=h2, ni=h1): the base_h2 statement of GG20 keygen."""
        return DlogStatementBatch(
            ctx=self.ctx, h1=self.h2, h2=self.h1,
            tables_rns=None if self.tables_rns is None
            else (self.tables_rns[1], self.tables_rns[0]),
            gmap=self.gmap,
            n_groups=self.n_groups,
        )

    def tile(self, S: int) -> "DlogStatementBatch":
        # the tables keep their size-1 sessions axis: every session's lanes
        # read the same rows, and S copies are never materialized
        tile_np = lambda a: np.broadcast_to(a, (S,) + a.shape[1:]).copy()
        return DlogStatementBatch(ctx=self.ctx.tile(S), h1=tile_np(self.h1),
                                  h2=tile_np(self.h2), tables_rns=self.tables_rns,
                                  gmap=self.gmap, n_groups=self.n_groups)

    def repeat_interleaved(self, R: int) -> "DlogStatementBatch":
        """G-group batch -> S = G*R sessions, interleaved (session s uses
        group s % G).  The tables stay compressed at G rows behind gmap."""
        G = int(self.ctx.batch_shape[0])
        return DlogStatementBatch(
            ctx=self.ctx.repeat_lead(R), h1=_rep_lead(self.h1, R), h2=_rep_lead(self.h2, R),
            tables_rns=self.tables_rns, gmap=np.tile(np.arange(G, dtype=np.int64), R),
            n_groups=G,
        )


def _jacobi(a: int, n: int) -> int:
    """Jacobi symbol (n odd > 0), host helper for the enc-base derivation."""
    a %= n
    result = 1
    while a:
        while a % 2 == 0:
            a //= 2
            if n % 8 in (3, 5):
                result = -result
        a, n = n, a
        if a % 4 == 3 and n % 4 == 3:
            result = -result
        a %= n
    return result if n == 1 else 0


def _derive_enc_base(n) -> int:
    """Deterministic public randomizer base for modulus n (the reference's
    derivation, byte for byte): hash-counter stream mod n, the first unit
    with Jacobi(g|n) = -1, so that g^t covers both Jacobi classes."""
    n = int(n)
    nb = (n.bit_length() + 7) // 8
    nbytes = nb + 16
    ctr = 0
    while True:
        buf = b""
        i = 0
        while len(buf) < nbytes:
            buf += hashlib.sha256(
                b"tpu-mpc enc-base|" + n.to_bytes(nb, "big")
                + b"|" + ctr.to_bytes(4, "big") + b"|" + i.to_bytes(4, "big")
            ).digest()
            i += 1
        g = int.from_bytes(buf[:nbytes], "big") % n
        if g > 1 and math.gcd(g, n) == 1 and _jacobi(g, n) == -1:
            return g
        ctr += 1


def crt_decrypt(sk_ctx: ModCtx, p, q, hp, hq, pinv_q, c_ints, bits: int, key_shape,
                sync: bool = True):
    """CRT Paillier decrypt of c under the keys (p, q) of batch shape B =
    key_shape (p and q broadcast to it): the two half-width c^{x-1} mod x^2
    modexps run as ONE stacked K1 launch over sk_ctx, the ctx of the moduli
    (p^2, q^2) with batch [2, *B]; the L-function divisions, the multipliers
    hp, hq (crt_h) and the CRT recombination (pinv_q = p^{-1} mod q) are a
    lazy host map (kzen decrypt_crt shape).  bits: the width of n = p q."""
    c = np.asarray(c_ints, dtype=object)
    shape = np.broadcast_shapes(c.shape, tuple(key_shape))
    exps = np.stack([np.broadcast_to(p, shape) - 1, np.broadcast_to(q, shape) - 1])
    # extra leading batch dims of c must not right-align against the sk
    # ctx's own (p^2, q^2) axis: insert broadcast axes after it
    for _ in range(max(0, len(shape) - len(key_shape))):
        sk_ctx = sk_ctx.expand(1)
    u_l = sk_ctx.pow(c[None], exps, ebits_hint=bits // 2, sync=False)
    flat = lambda a: np.broadcast_to(a, shape).reshape(-1)
    pb, qb, hpb, hqb, crb = flat(p), flat(q), flat(hp), flat(hq), flat(pinv_q)

    def combine(u):
        up = np.broadcast_to(u[0], shape).reshape(-1)
        uq = np.broadcast_to(u[1], shape).reshape(-1)
        out = np.empty(up.shape[0], dtype=object)
        for i in range(up.shape[0]):
            p_, q_ = int(pb[i]), int(qb[i])
            mp = (int(up[i]) - 1) // p_ * int(hpb[i]) % p_
            mq = (int(uq[i]) - 1) // q_ * int(hqb[i]) % q_
            out[i] = mp + p_ * ((mq - mp) * int(crb[i]) % q_)
        return out.reshape(shape)

    lz = LazyMap(u_l, combine)
    return resolve(lz) if sync else lz


def crt_h(n, x) -> int:
    """L_x((1 + n)^{x-1} mod x^2)^{-1} mod x, the CRT decryption multiplier
    of the factor x of n."""
    n, x = int(n), int(x)
    u = pow(1 + n, x - 1, x * x)
    return pow((u - 1) // x, -1, x)


@dataclasses.dataclass
class PaillierCtxBatch:
    """Alice's Paillier public key batch with device ctxs for N and N^2.

    attach_sk installs the owner's CRT fast path: x^N mod N^2 runs as two
    half-width modexps (mod p^2, q^2) in one launch plus a host CRT
    recombination, and decrypt_sk decrypts the same way.

    Randomizer tables (ensure_enc_tables, the tables configuration): with a
    public base g derived from N and h = g^N mod N^2, Paillier randomness is
    sampled as r = g^t (t < N * 2^64), and r^N = h^t mod N^2 exactly, since
    (a + kN)^N = a^N mod N^2.  Every r^N then is a zero-squaring K2 product
    from the h table, and a prover's response s = r^e beta folds into one
    g^(t_r e + t_beta) from the g table.  Wire format, proofs and blame
    replays are unchanged.

    Multi-tenant serving (repeat_interleaved): the randomizer tables stay
    compressed at G key groups behind `gmap`, as in DlogStatementBatch.  The
    reference samples uniform units instead off the TPU when its tables are
    compressed; the port keeps the table path on the CPU too (K2's plain
    version takes gmap), so a CPU run draws r = g^t there."""

    n_ctx: ModCtx
    nn_ctx: ModCtx
    sk_ctx: ModCtx | None = None     # [2, ...batch] ctx over (p^2, q^2)
    sk_e: np.ndarray | None = None   # [2, ...batch] N mod p(p-1) / q(q-1)
    sk_pp: np.ndarray | None = None  # p^2
    sk_cr: np.ndarray | None = None  # (p^2)^{-1} mod q^2
    sk_p: np.ndarray | None = None
    sk_q: np.ndarray | None = None
    sk_hp: np.ndarray | None = None  # L_p((1+n)^{p-1} mod p^2)^{-1} mod p
    sk_hq: np.ndarray | None = None
    sk_pinv_q: np.ndarray | None = None  # p^{-1} mod q
    enc_g: np.ndarray | None = None      # [...batch] the derived base g
    enc_tab_g: object = None             # table of g mod N   [nw, 16, ...batch, CH]
    enc_tab_h: object = None             # table of h mod N^2 [nw, 16, ...batch, CH]
    gmap: np.ndarray | None = None       # [S] session -> key group (compressed tables)
    n_groups: int = 1

    _ENC_EBITS = 64                      # t < N * 2^_ENC_EBITS

    @classmethod
    def from_ints(cls, ns, bits: int = 2048, device=None):
        ns = np.asarray(ns, dtype=object)
        return cls(
            n_ctx=ModCtx.from_ints(ns, bits, device),
            nn_ctx=ModCtx.from_ints(ns * ns, 2 * bits, device),
        )

    def attach_sk(self, ps, qs) -> "PaillierCtxBatch":
        """Install the owner's CRT fast path (ps*qs must equal n)."""
        p = np.asarray(ps, dtype=object)
        q = np.asarray(qs, dtype=object)
        pp, qq = p * p, q * q
        self.sk_ctx = ModCtx.from_ints(np.stack([pp, qq]), self.n_ctx.bits,
                                       self.n_ctx.device)
        n = self.n
        vec = lambda f, *a: np.vectorize(f, otypes=[object])(*a)
        self.sk_e = np.stack([
            vec(lambda nv, pv: int(nv) % (int(pv) * (int(pv) - 1)), n, p),
            vec(lambda nv, qv: int(nv) % (int(qv) * (int(qv) - 1)), n, q),
        ])
        self.sk_pp = pp
        self.sk_cr = vec(lambda a, b: pow(int(a), -1, int(b)), pp, qq)
        self.sk_p, self.sk_q = p, q

        self.sk_hp = vec(crt_h, n, p)
        self.sk_hq = vec(crt_h, n, q)
        self.sk_pinv_q = vec(lambda a, b: pow(int(a), -1, int(b)), p, q)
        return self

    @classmethod
    def enc_table_max_ebits(cls, bits: int) -> int:
        # widest table exponent: t*e + t' < 2^(bits + _ENC_EBITS + E_BITS + 8)
        # (the folded proof response s = g^(t_r e + t_beta), see alice_prove)
        return bits + cls._ENC_EBITS + E_BITS + 8

    def ensure_enc_tables(self) -> "PaillierCtxBatch":
        """Build the (g, h) randomizer tables (idempotent; in the tables
        configuration only; call on the small pre-tile key batch, like
        DlogStatementBatch.ensure_tables)."""
        if self.enc_tab_g is not None or not enc_tables_enabled(self.n_ctx.device):
            return self
        nstat = int(np.prod(self.n_ctx.batch_shape)) if self.n_ctx.batch_shape else 1
        if nstat > 64:
            return self
        g = np.vectorize(_derive_enc_base, otypes=[object])(self.n)
        h = resolve(self.pow_n_sk(g) if self.sk_ctx is not None
                    else self.nn_ctx.pow(g, self.n, ebits_hint=self.n_ctx.bits))
        max_eb = self.enc_table_max_ebits(self.n_ctx.bits)
        self.enc_g = g
        self.enc_tab_g = self.n_ctx.make_tables_rns(g[None], max_ebits=max_eb)[0]
        self.enc_tab_h = self.nn_ctx.make_tables_rns(
            np.asarray(h, dtype=object)[None], max_ebits=max_eb)[0]
        return self

    def _extra_dims(self, shape) -> int:
        return max(0, len(shape) - len(self.n_ctx.batch_shape))

    def sample_unit_with_power(self, shape, rng, sync: bool = False,
                               defer_value: bool = False, want_t: bool = False):
        """-> (u, u^N mod N^2 lazy[, t]): a unit with its N-th power.

        With the randomizer tables, u = g^t and u^N = h^t, both K2 products;
        otherwise u is a uniform unit and u^N takes the owner's CRT path or
        the full-width K1 pow.  defer_value=True (tables): u is a
        DeferredLaunch, not dispatched until resolved (callers that reveal
        u only on blame).  want_t=True: also return t (None without tables),
        so that provers can fold g^t powers."""
        n_b = np.broadcast_to(self.n, shape)
        if self.enc_tab_g is not None:
            t = rng.below(n_b << self._ENC_EBITS, shape)
            eb = (self.n_ctx.bits + self._ENC_EBITS,)
            extra = self._extra_dims(shape)
            gmap = _gmap_rows(self.gmap, self.enc_tab_g, self.n_ctx.batch_shape, shape)
            tab_g = _grow_tables(self.enc_tab_g, extra)
            tab_h = _grow_tables(self.enc_tab_h, extra)
            u_fn = lambda: self.n_ctx.pow_fixed_prod_rns((tab_g,), [t], eb, sync=False,
                                                         gmap=gmap)
            un_l = self.nn_ctx.pow_fixed_prod_rns((tab_h,), [t], eb, sync=sync, gmap=gmap)
            u = DeferredLaunch(u_fn) if defer_value else resolve(u_fn())
            return (u, un_l, t) if want_t else (u, un_l)
        u = rng.units_below(n_b, shape)
        if self.sk_ctx is not None:
            un_l = self.pow_n_sk(u, sync=sync)
        else:
            un_l = self.nn_ctx.pow(u, n_b, ebits_hint=self.n_ctx.bits, sync=sync)
        return (u, un_l, None) if want_t else (u, un_l)

    def pow_enc_base(self, exps, ebits_hint: int, sync: bool = False):
        """g^e mod N from the randomizer table (e < 2^enc_table_max_ebits):
        the fold of proof responses s = r^e beta = g^(t_r e + t_beta)."""
        exps = np.asarray(exps, dtype=object)
        shape = np.broadcast_shapes(exps.shape, self.n_ctx.batch_shape)
        T = _grow_tables(self.enc_tab_g, self._extra_dims(shape))
        gmap = _gmap_rows(self.gmap, self.enc_tab_g, self.n_ctx.batch_shape, shape)
        return self.n_ctx.pow_fixed_prod_rns((T,), [exps], (ebits_hint,), sync=sync, gmap=gmap)

    def decrypt_sk(self, c_ints, sync: bool = True):
        """CRT Paillier decrypt through the attached sk (crt_decrypt)."""
        return crt_decrypt(self.sk_ctx, self.sk_p, self.sk_q, self.sk_hp, self.sk_hq,
                           self.sk_pinv_q, c_ints, self.n_ctx.bits, self.n_ctx.batch_shape,
                           sync=sync)

    def pow_n_sk(self, base, sync: bool = True):
        """base^N mod N^2 via the attached sk (two half-width modexps + CRT)."""
        base = np.asarray(base, dtype=object)
        shape = np.broadcast_shapes(base.shape, self.n_ctx.batch_shape)
        halves_l = self.sk_ctx.pow(base[None], self.sk_e, ebits_hint=self.n_ctx.bits,
                                   sync=False)
        pp = np.broadcast_to(self.sk_pp, shape).reshape(-1)
        cr = np.broadcast_to(self.sk_cr, shape).reshape(-1)
        qq = np.broadcast_to(self.sk_ctx.n_ints[1], shape).reshape(-1)

        def combine(halves):
            rp = np.broadcast_to(halves[0], shape).reshape(-1)
            rq = np.broadcast_to(halves[1], shape).reshape(-1)
            out = np.empty(rp.shape[0], dtype=object)
            for i in range(rp.shape[0]):
                d = (int(rq[i]) - int(rp[i])) * int(cr[i]) % int(qq[i])
                out[i] = int(rp[i]) + int(pp[i]) * d
            return out.reshape(shape)

        lz = LazyMap(halves_l, combine)
        return resolve(lz) if sync else lz

    @property
    def n(self):
        return self.n_ctx.n_ints

    @property
    def nn(self):
        return self.nn_ctx.n_ints

    def _map(self, fn_mod, fn_np, fn_tab) -> "PaillierCtxBatch":
        np0 = lambda a: None if a is None else fn_np(a, lead=0)
        tab = lambda T: None if T is None else fn_tab(T)
        return PaillierCtxBatch(
            n_ctx=fn_mod(self.n_ctx),
            nn_ctx=fn_mod(self.nn_ctx),
            sk_ctx=None if self.sk_ctx is None else fn_mod(self.sk_ctx, lead=1),
            sk_e=None if self.sk_e is None else fn_np(self.sk_e, lead=1),
            sk_pp=np0(self.sk_pp), sk_cr=np0(self.sk_cr),
            sk_p=np0(self.sk_p), sk_q=np0(self.sk_q),
            sk_hp=np0(self.sk_hp), sk_hq=np0(self.sk_hq),
            sk_pinv_q=np0(self.sk_pinv_q),
            enc_g=np0(self.enc_g),
            enc_tab_g=tab(self.enc_tab_g), enc_tab_h=tab(self.enc_tab_h),
            gmap=self.gmap, n_groups=self.n_groups,
        )

    def take(self, indices, axis: int) -> "PaillierCtxBatch":
        from ..core.modctx import _take_t

        # group-compressed tables: a sessions-axis take slices gmap instead
        take_tabs = axis > 0 or self.gmap is None
        out = self._map(
            lambda c, lead=0: c.take(indices, axis + lead),
            lambda a, lead=0: np.take(a, indices, axis=axis + lead),
            (lambda T: _take_t(T, indices, 2 + axis)) if take_tabs else (lambda T: T),
        )
        out.gmap = _take_gmap(self.gmap, indices, axis)
        return out

    def expand(self, axis: int) -> "PaillierCtxBatch":
        return self._map(
            lambda c, lead=0: c.expand(axis + lead),
            lambda a, lead=0: np.expand_dims(a, axis + lead),
            lambda T: T.unsqueeze(2 + axis),
        )

    def tile(self, S: int) -> "PaillierCtxBatch":
        # sk leaves and the randomizer tables keep their size-1 sessions axis
        return dataclasses.replace(self, n_ctx=self.n_ctx.tile(S),
                                   nn_ctx=self.nn_ctx.tile(S))

    def repeat_interleaved(self, R: int) -> "PaillierCtxBatch":
        """G-group batch -> S = G*R sessions, interleaved (session s uses
        group s % G); the randomizer tables stay compressed behind gmap."""
        G = int(self.n_ctx.batch_shape[0])
        rep = lambda a: _rep_lead(a, R)
        return dataclasses.replace(
            self,
            n_ctx=self.n_ctx.repeat_lead(R), nn_ctx=self.nn_ctx.repeat_lead(R),
            sk_ctx=None if self.sk_ctx is None else self.sk_ctx.repeat_lead(R, axis=1),
            sk_e=_rep_lead(self.sk_e, R, lead=1),
            sk_pp=rep(self.sk_pp), sk_cr=rep(self.sk_cr), sk_p=rep(self.sk_p),
            sk_q=rep(self.sk_q), sk_hp=rep(self.sk_hp), sk_hq=rep(self.sk_hq),
            sk_pinv_q=rep(self.sk_pinv_q), enc_g=rep(self.enc_g),
            gmap=np.tile(np.arange(G, dtype=np.int64), R), n_groups=G,
        )


def pts_from_xy(xs, ys, device=None):
    """Affine coordinate object-arrays -> device Point batch of same shape."""
    from ..ec import secp256k1 as dec

    xs = np.asarray(xs, dtype=object)
    ys = np.asarray(ys, dtype=object)
    shape = np.broadcast_shapes(xs.shape, ys.shape)
    fx = np.broadcast_to(xs, shape).reshape(-1)
    fy = np.broadcast_to(ys, shape).reshape(-1)
    P = dec.points_from_host([(int(a), int(b)) for a, b in zip(fx, fy)], device)
    rs = lambda c: c.reshape(tuple(shape) + (c.shape[-1],))
    return dec.Point(rs(P.X), rs(P.Y), rs(P.Z))


def _clamp_exponents(shape, *pairs):
    """Police attacker-controlled proof fields before any device call:
    negative or over-wide fields are zeroed and their rows marked failed."""
    ok = np.ones(shape, dtype=bool)
    ok_flat = ok.reshape(-1)
    outs = []
    for arr, mb in pairs:
        a = np.broadcast_to(np.asarray(arr, dtype=object), shape).copy()
        flat = a.reshape(-1)
        for i, v in enumerate(flat.tolist()):
            v = int(v)
            if v < 0 or v.bit_length() > mb:
                flat[i] = 0
                ok_flat[i] = False
        outs.append(a)
    return outs, ok


@dataclasses.dataclass
class AliceProofBatch:
    """(z, e, s, s1, s2) plus the sigma commitments (u, w) on the wire."""

    z: np.ndarray
    e: np.ndarray
    s: np.ndarray
    s1: np.ndarray
    s2: np.ndarray
    u: np.ndarray = None
    w: np.ndarray = None


def alice_prove(a_ints, cipher, ek: PaillierCtxBatch, stmt: DlogStatementBatch, r_ints,
                rng, r_t=None) -> AliceProofBatch:
    """a: plaintexts (< q); cipher: Enc(a); r: encryption randomness.

    r_t: the table exponent of r (r = g^r_t, randomizer-table sampling).
    When given, the response s = r^e beta folds into ONE fixed-base power
    g^(r_t e + t_beta), and neither r nor beta is materialized on the
    honest path."""
    a = np.asarray(a_ints, dtype=object)
    shape = np.broadcast_shapes(a.shape, stmt.ctx.batch_shape, ek.n_ctx.batch_shape)
    n_t = np.broadcast_to(stmt.ctx.n_ints, shape)
    alpha = rng.below(Q3, shape)
    beta_n_l = beta_t = None
    use_fold = ek.enc_tab_g is not None and r_t is not None
    # beta is sampled like r: a table-sampled beta beside a uniform r would
    # make s = r^e beta reveal the coset of r^e
    if use_fold:
        _, beta_n_l, beta_t = ek.sample_unit_with_power(
            shape, rng, sync=False, defer_value=True, want_t=True)
    else:
        beta = rng.units_below(np.broadcast_to(ek.n, shape), shape)
    gamma = rng.below(Q3 * n_t, shape)
    rho = rng.below(Q * n_t, shape)

    tb = stmt.ctx.bits
    a_bits = max(E_BITS, max((int(v).bit_length() for v in a.reshape(-1).tolist()),
                             default=1))
    z_l = stmt.pow_h1h2(a, rho, hints=(a_bits, E_BITS + tb), sync=False)
    if beta_n_l is None:
        if ek.sk_ctx is not None:
            beta_n_l = ek.pow_n_sk(beta, sync=False)
        else:
            beta_n_l = ek.nn_ctx.pow(beta, np.broadcast_to(ek.n, shape),
                                     ebits_hint=ek.n_ctx.bits, sync=False)
    w_l = stmt.pow_h1h2(alpha, gamma, hints=(768, 768 + tb), sync=False)
    u = _mulmod(alpha * np.broadcast_to(ek.n, shape) + 1, resolve(beta_n_l),
                np.broadcast_to(ek.nn, shape))
    z, w = resolve(z_l), resolve(w_l)

    gen = np.broadcast_to(ek.n, shape) + 1
    e = digest_rows(np.broadcast_to(ek.n, shape), gen, cipher, z, u, w)
    if use_fold:
        s = resolve(ek.pow_enc_base(np.asarray(r_t, dtype=object) * e + beta_t,
                                    ebits_hint=ek.enc_table_max_ebits(ek.n_ctx.bits)))
    else:
        s = _mulmod(ek.n_ctx.pow(r_ints, e, ebits_hint=E_BITS), beta,
                    np.broadcast_to(ek.n, shape))
    s1 = e * a + alpha
    s2 = e * rho + gamma
    return AliceProofBatch(z=z, e=e, s=s, s1=s1, s2=s2, u=u, w=w)


def _alice_host_checks(proof: AliceProofBatch, cipher, ek, stmt, shape):
    """Per-session host checks shared with the cross-session verifier:
    s1 range, exponent-width clamping, Fiat-Shamir recomputation.
    -> (cheap_ok mask, clamped (e, s1, s2))."""
    n = np.broadcast_to(ek.n, shape)
    range_ok = np.vectorize(lambda v: int(v) <= Q3, otypes=[bool])(
        np.broadcast_to(np.asarray(proof.s1, dtype=object), shape))
    tb = stmt.ctx.bits
    (e, s1, s2), width_ok = _clamp_exponents(
        shape, (proof.e, E_BITS), (proof.s1, 776), (proof.s2, 768 + tb + 16))
    e_check = digest_rows(n, n + 1, cipher, proof.z, proof.u, proof.w)
    hash_ok = e_check == np.broadcast_to(np.asarray(proof.e, dtype=object), shape)
    return range_ok & width_ok & hash_ok, (e, s1, s2)


def alice_verify(proof: AliceProofBatch, cipher, ek: PaillierCtxBatch,
                 stmt: DlogStatementBatch) -> np.ndarray:
    """w z^e == h1^s1 h2^s2 (mod N~) and u c^e == (s1 N + 1) s^N (mod N^2)."""
    shape = np.broadcast_shapes(np.shape(proof.z), stmt.ctx.batch_shape,
                                ek.n_ctx.batch_shape, np.shape(cipher))
    n = np.broadcast_to(ek.n, shape)
    tb = stmt.ctx.bits
    cheap_ok, (e, s1, s2) = _alice_host_checks(proof, cipher, ek, stmt, shape)
    lhs_w = stmt.ctx.pow_prod([proof.z], [e], ebits_hints=(E_BITS,), mults=[proof.w],
                              sync=False)
    rhs_w = stmt.pow_h1h2(s1, s2, hints=(776, 768 + tb + 16), sync=False)
    lhs_u = ek.nn_ctx.pow_prod([cipher], [e], ebits_hints=(E_BITS,), mults=[proof.u],
                               sync=False)
    rhs_u = ek.nn_ctx.pow_prod([proof.s], [n], ebits_hints=(ek.n_ctx.bits,),
                               mults=[s1 * n + 1], sync=False)
    return cheap_ok & (resolve(lhs_w) == resolve(rhs_w)) & (resolve(lhs_u) == resolve(rhs_u))


@dataclasses.dataclass
class BobProofBatch:
    """(t, z, e, s, s1, s2, t1, t2) plus the sigma commitments (z_prim, v, w):
      z_prim * z^e == h1^s1 h2^s2,  w * t^e == h1^t1 h2^t2   (mod N~)
      v * c^e == c_a^s1 s^N (t1 N + 1)                       (mod N^2)"""

    t: np.ndarray
    z: np.ndarray
    e: np.ndarray
    s: np.ndarray
    s1: np.ndarray
    s2: np.ndarray
    t1: np.ndarray
    t2: np.ndarray
    z_prim: np.ndarray = None
    v: np.ndarray = None
    w: np.ndarray = None
    u_x: np.ndarray | None = None   # wc variant: u = alpha G (affine)
    u_y: np.ndarray | None = None


def bob_prove(b_ints, beta_prim, a_enc, mta_enc, r_ints, ek: PaillierCtxBatch,
              stmt: DlogStatementBatch, rng, check: bool = False,
              X_pts=None, r_is_table: bool = False) -> BobProofBatch:
    """r_is_table: r_ints was table-sampled (r = g^t); beta is then sampled
    from the randomizer tables too (see alice_prove)."""
    b_arr = np.asarray(b_ints, dtype=object)
    shape = np.broadcast_shapes(b_arr.shape, stmt.ctx.batch_shape, ek.n_ctx.batch_shape)
    n_t = np.broadcast_to(stmt.ctx.n_ints, shape)
    n = np.broadcast_to(ek.n, shape)

    alpha = rng.below(Q3, shape)
    beta_n_l = None
    if ek.enc_tab_g is not None and r_is_table:
        beta, beta_n_l = ek.sample_unit_with_power(shape, rng, sync=False)
    else:
        beta = rng.units_below(n, shape)
    gamma = rng.below(Q * Q * n, shape)
    rho = rng.below(Q * n_t, shape)
    rho_prim = rng.below(Q3 * n_t, shape)
    sigma = rng.below(Q * n_t, shape)
    tau = rng.below(Q3 * n_t, shape)

    tb = stmt.ctx.bits
    pb = ek.n_ctx.bits
    z_l = stmt.pow_h1h2(b_arr, rho, hints=(E_BITS, E_BITS + tb), sync=False)
    zp_l = stmt.pow_h1h2(alpha, rho_prim, hints=(768, 768 + tb), sync=False)
    t_l = stmt.pow_h1h2(beta_prim, sigma, hints=(pb, E_BITS + tb), sync=False)
    w_l = stmt.pow_h1h2(gamma, tau, hints=(512 + pb, 768 + tb), sync=False)
    if beta_n_l is not None:
        v_l = ek.nn_ctx.pow_prod([a_enc], [alpha], ebits_hints=(768,),
                                 mults=[resolve(beta_n_l), gamma * n + 1], sync=False)
    else:
        v_l = ek.nn_ctx.pow_prod([a_enc, beta], [alpha, n], ebits_hints=(768, pb),
                                 mults=[gamma * n + 1], sync=False)
    z, z_prim, t, w = resolve(z_l), resolve(zp_l), resolve(t_l), resolve(w_l)
    v = resolve(v_l)

    hash_cols = [n, n + 1, a_enc, mta_enc, z, z_prim, t, v, w]
    u_x = u_y = None
    if check:
        from ..core.limbs import batch_from_limbs
        from ..ec import secp256k1 as dec

        alpha_pts = dec.mul_generator(dec.sc_from_ints(np.mod(alpha, Q), stmt.ctx.device))
        ux_l, uy_l, _ = dec.to_affine(alpha_pts)
        u_x = batch_from_limbs(ux_l)
        u_y = batch_from_limbs(uy_l)
        X_x, X_y = X_pts
        hash_cols += [np.broadcast_to(np.asarray(X_x, dtype=object), shape),
                      np.broadcast_to(np.asarray(X_y, dtype=object), shape), u_x, u_y]
    e = digest_rows(*hash_cols)

    s = _mulmod(ek.n_ctx.pow(r_ints, e, ebits_hint=E_BITS), beta, n)
    s1 = e * b_arr + alpha
    s2 = e * rho + rho_prim
    t1 = e * np.broadcast_to(np.asarray(beta_prim, dtype=object), shape) + gamma
    t2 = e * sigma + tau
    return BobProofBatch(t=t, z=z, e=e, s=s, s1=s1, s2=s2, t1=t1, t2=t2,
                         z_prim=z_prim, v=v, w=w, u_x=u_x, u_y=u_y)


def bob_verify(proof: BobProofBatch, a_enc, mta_enc, ek: PaillierCtxBatch,
               stmt: DlogStatementBatch, X_pts=None) -> np.ndarray:
    shape = np.broadcast_shapes(np.shape(proof.z), stmt.ctx.batch_shape,
                                ek.n_ctx.batch_shape)
    n = np.broadcast_to(ek.n, shape)
    range_ok = np.vectorize(lambda v: int(v) <= Q3, otypes=[bool])(
        np.broadcast_to(np.asarray(proof.s1, dtype=object), shape))
    tb = stmt.ctx.bits
    pb = ek.n_ctx.bits
    (e, s1, s2, t1, t2), width_ok = _clamp_exponents(
        shape, (proof.e, E_BITS), (proof.s1, 776), (proof.s2, 768 + tb + 16),
        (proof.t1, 512 + pb + 16), (proof.t2, 768 + tb + 16))
    lhs_zt_l = stmt.ctx.pow_prod(
        [np.stack([np.broadcast_to(proof.z, shape), np.broadcast_to(proof.t, shape)])],
        [np.broadcast_to(e, (2,) + shape)], ebits_hints=(E_BITS,),
        mults=[np.stack([np.broadcast_to(proof.z_prim, shape),
                         np.broadcast_to(proof.w, shape)])],
        sync=False)
    rhs_z_l = stmt.pow_h1h2(s1, s2, hints=(776, 768 + tb + 16), sync=False)
    rhs_t_l = stmt.pow_h1h2(t1, t2, hints=(512 + pb + 16, 768 + tb + 16), sync=False)
    lhs_v_l = ek.nn_ctx.pow_prod([mta_enc], [e], ebits_hints=(E_BITS,), mults=[proof.v],
                                 sync=False)
    rhs_v_l = ek.nn_ctx.pow_prod([a_enc, proof.s], [s1, n], ebits_hints=(776, pb),
                                 mults=[t1 * n + 1], sync=False)
    hash_cols = [n, n + 1, a_enc, mta_enc, proof.z, proof.z_prim, proof.t, proof.v, proof.w]
    wc_ok = np.ones(shape, dtype=bool)
    if X_pts is not None:
        from ..ec import secp256k1 as dec

        dev = stmt.ctx.device
        X_x, X_y = (np.broadcast_to(np.asarray(c, dtype=object), shape) for c in X_pts)
        u_x = np.broadcast_to(np.asarray(proof.u_x, dtype=object), shape)
        u_y = np.broadcast_to(np.asarray(proof.u_y, dtype=object), shape)
        hash_cols += [X_x, X_y, u_x, u_y]
        # EC check: s1 G == e X + u
        s1_pts = dec.mul_generator(dec.sc_from_ints(
            np.mod(np.broadcast_to(np.asarray(proof.s1, dtype=object), shape), Q), dev))
        e_mod = np.mod(np.broadcast_to(np.asarray(proof.e, dtype=object), shape), Q)
        rhs = dec.point_add(dec.scalar_mul(dec.sc_from_ints(e_mod, dev),
                                           pts_from_xy(X_x, X_y, dev)),
                            pts_from_xy(u_x, u_y, dev))
        wc_ok = to_numpy(dec.point_eq(s1_pts, rhs))
    e_check = digest_rows(*hash_cols)
    lhs_zt = resolve(lhs_zt_l)
    eq_ok = ((lhs_zt[0] == resolve(rhs_z_l)) & (lhs_zt[1] == resolve(rhs_t_l))
             & (resolve(lhs_v_l) == resolve(rhs_v_l)))
    return (range_ok & width_ok & wc_ok & eq_ok
            & (e_check == np.broadcast_to(np.asarray(proof.e, dtype=object), shape)))


def obj_mod(x, m) -> np.ndarray:
    """x mod m keeping object dtype at any shape, incl. 0-d."""
    return np.vectorize(lambda v: int(v) % m, otypes=[object])(np.asarray(x, dtype=object))
