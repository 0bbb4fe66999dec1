"""Batched MtA range proofs (GG19 Appendix A) — port of tpu_mpc/zk/range_proofs.py.

All modexps run batched on the device (ModCtx: kernel K1); multiplies,
inverses and SHA-256 run on host ints.  Proof shapes and checks are the
reference's:

  AliceProof(z, e, s, s1, s2) proves Enc plaintext a < q^3;
  BobProof(t, z, e, s, s1, s2, t1, t2) (+ u point for the "wc" variant).

Verifiers check the inverse-free products (the sigma commitments ride on
the wire and the hash binds them).

This slice runs without fixed-base tables: ring-Pedersen h1^a h2^b is
ModCtx.pow_prod, and encryption randomizers are drawn uniformly — the
reference's "reference-exact" randomizer mode (TPU_MPC_ENC_TABLES=0).
"""

from __future__ import annotations

import dataclasses

import numpy as np

from ..core.modctx import LazyMap, ModCtx, host_mulmod as _mulmod, resolve
from ..device import to_numpy
from ..hashes.fiat_shamir import digest_rows
from ..host import ec as hec

Q = hec.N
Q3 = Q**3
E_BITS = 256  # Fiat-Shamir challenge width (SHA-256)


@dataclasses.dataclass
class DlogStatementBatch:
    """(N_tilde, h1, h2) batch — the ring-Pedersen setup of each party."""

    ctx: ModCtx               # N_tilde moduli
    h1: np.ndarray
    h2: np.ndarray
    n_groups: int = 1

    @classmethod
    def from_ints(cls, n_tildes, h1s, h2s, bits: int = 2048, device=None):
        return cls(
            ctx=ModCtx.from_ints(n_tildes, bits, device),
            h1=np.asarray(h1s, dtype=object),
            h2=np.asarray(h2s, dtype=object),
        )

    def pow_h1h2(self, e1, e2, hints, sync: bool = True):
        """h1^e1 * h2^e2 mod N_tilde.  hints (required) are exponent widths
        from the sampling domain or the clamped field width."""
        return self.ctx.pow_prod([self.h1, self.h2], [e1, e2], ebits_hints=hints, sync=sync)

    def take(self, indices, axis: int) -> "DlogStatementBatch":
        return DlogStatementBatch(
            ctx=self.ctx.take(indices, axis),
            h1=np.take(self.h1, indices, axis=axis),
            h2=np.take(self.h2, indices, axis=axis),
            n_groups=self.n_groups,
        )

    def expand(self, axis: int) -> "DlogStatementBatch":
        return DlogStatementBatch(
            ctx=self.ctx.expand(axis),
            h1=np.expand_dims(self.h1, axis),
            h2=np.expand_dims(self.h2, axis),
            n_groups=self.n_groups,
        )

    def tile(self, S: int) -> "DlogStatementBatch":
        tile_np = lambda a: np.broadcast_to(a, (S,) + a.shape[1:]).copy()
        return DlogStatementBatch(ctx=self.ctx.tile(S), h1=tile_np(self.h1),
                                  h2=tile_np(self.h2))


@dataclasses.dataclass
class PaillierCtxBatch:
    """Alice's Paillier public key batch with device ctxs for N and N^2.

    attach_sk installs the owner's CRT fast path: x^N mod N^2 runs as two
    half-width modexps (mod p^2, q^2) in one launch plus a host CRT
    recombination, and decrypt_sk decrypts the same way."""

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
    n_groups: int = 1

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

        def hx(nv, xv):
            u = pow(1 + int(nv), int(xv) - 1, int(xv) * int(xv))
            return pow((u - 1) // int(xv), -1, int(xv))

        self.sk_hp = vec(hx, n, p)
        self.sk_hq = vec(hx, n, q)
        self.sk_pinv_q = vec(lambda a, b: pow(int(a), -1, int(b)), p, q)
        return self

    def sample_unit_with_power(self, shape, rng, sync: bool = False):
        """-> (u, u^N mod N^2 lazy): a uniform unit with its N-th power
        (owner-CRT path when the sk is attached)."""
        n_b = np.broadcast_to(self.n, shape)
        u = rng.units_below(n_b, shape)
        if self.sk_ctx is not None:
            return u, self.pow_n_sk(u, sync=sync)
        return u, self.nn_ctx.pow(u, n_b, ebits_hint=self.n_ctx.bits, sync=sync)

    def decrypt_sk(self, c_ints, sync: bool = True):
        """CRT Paillier decrypt: the two half-width c^{x-1} mod x^2 modexps
        run as ONE stacked launch; the L-function divisions, h multipliers
        and CRT recombination are a lazy host map (kzen decrypt_crt shape)."""
        c = np.asarray(c_ints, dtype=object)
        shape = np.broadcast_shapes(c.shape, self.n_ctx.batch_shape)
        exps = np.stack([
            np.broadcast_to(self.sk_p, shape) - 1,
            np.broadcast_to(self.sk_q, shape) - 1,
        ])
        # extra leading batch dims of c must not right-align against the sk
        # ctx's own (p^2, q^2) axis: insert broadcast axes after it
        sk_ctx = self.sk_ctx
        for _ in range(max(0, len(shape) - len(self.n_ctx.batch_shape))):
            sk_ctx = sk_ctx.expand(1)
        u_l = sk_ctx.pow(c[None], exps, ebits_hint=self.n_ctx.bits // 2, sync=False)
        flat = lambda a: np.broadcast_to(a, shape).reshape(-1)
        pb, qb = flat(self.sk_p), flat(self.sk_q)
        hpb, hqb, crb = flat(self.sk_hp), flat(self.sk_hq), flat(self.sk_pinv_q)

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

    def _map(self, fn_mod, fn_np) -> "PaillierCtxBatch":
        np0 = lambda a: None if a is None else fn_np(a, lead=0)
        return PaillierCtxBatch(
            n_ctx=fn_mod(self.n_ctx),
            nn_ctx=fn_mod(self.nn_ctx),
            sk_ctx=None if self.sk_ctx is None else fn_mod(self.sk_ctx, lead=1),
            sk_e=None if self.sk_e is None else fn_np(self.sk_e, lead=1),
            sk_pp=np0(self.sk_pp), sk_cr=np0(self.sk_cr),
            sk_p=np0(self.sk_p), sk_q=np0(self.sk_q),
            sk_hp=np0(self.sk_hp), sk_hq=np0(self.sk_hq),
            sk_pinv_q=np0(self.sk_pinv_q),
            n_groups=self.n_groups,
        )

    def take(self, indices, axis: int) -> "PaillierCtxBatch":
        return self._map(
            lambda c, lead=0: c.take(indices, axis + lead),
            lambda a, lead=0: np.take(a, indices, axis=axis + lead),
        )

    def expand(self, axis: int) -> "PaillierCtxBatch":
        return self._map(
            lambda c, lead=0: c.expand(axis + lead),
            lambda a, lead=0: np.expand_dims(a, axis + lead),
        )

    def tile(self, S: int) -> "PaillierCtxBatch":
        # sk leaves keep their size-1 sessions axis and broadcast in K1
        return dataclasses.replace(self, n_ctx=self.n_ctx.tile(S),
                                   nn_ctx=self.nn_ctx.tile(S))


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
                rng) -> AliceProofBatch:
    """a: plaintexts (< q); cipher: Enc(a); r: encryption randomness."""
    a = np.asarray(a_ints, dtype=object)
    shape = np.broadcast_shapes(a.shape, stmt.ctx.batch_shape, ek.n_ctx.batch_shape)
    n_t = np.broadcast_to(stmt.ctx.n_ints, shape)
    alpha = rng.below(Q3, shape)
    beta = rng.units_below(np.broadcast_to(ek.n, shape), shape)
    gamma = rng.below(Q3 * n_t, shape)
    rho = rng.below(Q * n_t, shape)

    tb = stmt.ctx.bits
    a_bits = max(E_BITS, max((int(v).bit_length() for v in a.reshape(-1).tolist()),
                             default=1))
    z_l = stmt.pow_h1h2(a, rho, hints=(a_bits, E_BITS + tb), sync=False)
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
              X_pts=None) -> BobProofBatch:
    b_arr = np.asarray(b_ints, dtype=object)
    shape = np.broadcast_shapes(b_arr.shape, stmt.ctx.batch_shape, ek.n_ctx.batch_shape)
    n_t = np.broadcast_to(stmt.ctx.n_ints, shape)
    n = np.broadcast_to(ek.n, shape)

    alpha = rng.below(Q3, shape)
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
