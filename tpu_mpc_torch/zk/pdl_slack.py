"""Batched non-interactive PDL-with-slack proof (port of tpu_mpc/zk/pdl_slack.py).

Proves a Paillier ciphertext decrypts to the dlog of Q w.r.t. base G, with
range slack [-q^3, q^3].  Hash order H(G, Q, c, z, u1, u2, u3) with points
as compressed-bytes-ints.  The verifier checks u2 c^e == (s1 N + 1) s2^N
and u3 z^e == h1^s1 h2^s3, inverse-free.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from ..core.limbs import batch_from_limbs
from ..core.modctx import resolve
from ..device import to_numpy
from ..ec import secp256k1 as dec
from ..hashes.fiat_shamir import digest_rows, point_hash_ints_many
from ..host import ec as hec
from .range_proofs import (
    E_BITS,
    DlogStatementBatch,
    PaillierCtxBatch,
    _clamp_exponents,
    _mulmod,
    obj_mod,
    pts_from_xy,
)

Q = hec.N
Q3 = Q**3


@dataclasses.dataclass
class PDLwSlackStatementBatch:
    ciphertext: np.ndarray       # object ints
    ek: PaillierCtxBatch
    Q_pt: dec.Point              # device point batch (the claimed x*G)
    G_pt: dec.Point              # base point batch
    dlog: DlogStatementBatch     # verifier's (h1, h2, N_tilde)


@dataclasses.dataclass
class PDLwSlackProofBatch:
    z: np.ndarray
    u1_x: np.ndarray             # u1 as affine ints (point on wire)
    u1_y: np.ndarray
    u2: np.ndarray
    u3: np.ndarray
    s1: np.ndarray
    s2: np.ndarray
    s3: np.ndarray


def pdl_slack_prove(x_ints, r_ints, stmt: PDLwSlackStatementBatch, rng,
                    r_t=None) -> PDLwSlackProofBatch:
    """x: dlog witness (< q); r: Paillier randomness of the ciphertext.
    r_t: the table exponent of r (see range_proofs.alice_prove): folds
    s2 = r^e beta into one fixed-base power."""
    x = np.asarray(x_ints, dtype=object)
    shape = np.broadcast_shapes(x.shape, stmt.dlog.ctx.batch_shape, stmt.ek.n_ctx.batch_shape)
    n_t = np.broadcast_to(stmt.dlog.ctx.n_ints, shape)
    n = np.broadcast_to(stmt.ek.n, shape)
    nn = np.broadcast_to(stmt.ek.nn, shape)

    alpha = rng.below(Q3, shape)
    u2_l = beta_t = None
    use_fold = stmt.ek.enc_tab_g is not None and r_t is not None
    # beta is sampled like r (see alice_prove)
    if use_fold:
        _, u2_l, beta_t = stmt.ek.sample_unit_with_power(
            shape, rng, sync=False, defer_value=True, want_t=True)
    else:
        one = np.ones(shape, dtype=object) if shape else 1
        beta = rng.below(n - 1, shape) + one      # sample_range(1, n-1)
    rho = rng.below(Q * n_t, shape)
    gamma = rng.below(Q3 * n_t, shape)

    tb = stmt.dlog.ctx.bits
    z_l = stmt.dlog.pow_h1h2(x, rho, hints=(E_BITS, E_BITS + tb), sync=False)
    # (N+1)^alpha mod N^2 == 1 + alpha*N; beta^N from the randomizer tables
    # (sampled above) or on the owner's CRT path
    if u2_l is None:
        if stmt.ek.sk_ctx is not None:
            u2_l = stmt.ek.pow_n_sk(beta, sync=False)
        else:
            u2_l = stmt.ek.nn_ctx.pow(beta, n, ebits_hint=stmt.ek.n_ctx.bits, sync=False)
    u3_l = stmt.dlog.pow_h1h2(alpha, gamma, hints=(768, 768 + tb), sync=False)
    u1_pt = dec.scalar_mul(dec.sc_from_ints(obj_mod(alpha, Q), stmt.G_pt.X.device), stmt.G_pt)
    u1x_l, u1y_l, _ = dec.to_affine(u1_pt)
    u1_x = np.asarray(batch_from_limbs(u1x_l), dtype=object)
    u1_y = np.asarray(batch_from_limbs(u1y_l), dtype=object)
    z = resolve(z_l)
    u2 = _mulmod(alpha * n + 1, resolve(u2_l), nn)
    u3 = resolve(u3_l)

    gi, qi, u1i = point_hash_ints_many(stmt.G_pt, stmt.Q_pt, u1_pt)
    e = digest_rows(gi, qi, stmt.ciphertext, z, u1i, u2, u3)
    s1 = e * x + alpha
    if use_fold:
        s2 = resolve(stmt.ek.pow_enc_base(
            np.asarray(r_t, dtype=object) * e + beta_t,
            ebits_hint=stmt.ek.enc_table_max_ebits(stmt.ek.n_ctx.bits)))
    else:
        s2 = _mulmod(stmt.ek.n_ctx.pow(r_ints, e, ebits_hint=E_BITS), beta, n)
    s3 = e * rho + gamma
    return PDLwSlackProofBatch(z=z, u1_x=u1_x, u1_y=u1_y, u2=u2, u3=u3, s1=s1, s2=s2, s3=s3)


def _pdl_host_ec_checks(proof: PDLwSlackProofBatch, stmt: PDLwSlackStatementBatch, shape):
    """Per-session parts shared with the cross-session verifier: challenge
    recomputation, width clamping and the EC identity s1 G + (q - e) Q == u1.
    -> (e, clamped s1, clamped s3, width_ok & u1_ok)."""
    dev = stmt.G_pt.X.device
    u1_dev = pts_from_xy(proof.u1_x, proof.u1_y, dev)
    gi, qi, u1i = point_hash_ints_many(stmt.G_pt, stmt.Q_pt, u1_dev)
    e = digest_rows(gi, qi, stmt.ciphertext, proof.z, u1i, proof.u2, proof.u3)
    tb = stmt.dlog.ctx.bits
    (s1, s3), width_ok = _clamp_exponents(shape, (proof.s1, 776), (proof.s3, 768 + tb + 16))
    s1_mod = obj_mod(proof.s1, Q)
    e_neg = np.vectorize(lambda v: (Q - int(v) % Q) % Q, otypes=[object])(
        np.asarray(e, dtype=object))
    u1_test = dec.dual_mul(
        dec.sc_from_ints(np.broadcast_to(s1_mod, shape), dev), stmt.G_pt,
        dec.sc_from_ints(np.broadcast_to(e_neg, shape), dev), stmt.Q_pt,
    )
    u1_ok = to_numpy(dec.point_eq(u1_test, u1_dev))
    return e, s1, s3, width_ok & u1_ok


def pdl_slack_verify(proof: PDLwSlackProofBatch, stmt: PDLwSlackStatementBatch) -> np.ndarray:
    shape = np.broadcast_shapes(np.shape(proof.z), stmt.dlog.ctx.batch_shape,
                                stmt.ek.n_ctx.batch_shape)
    n = np.broadcast_to(stmt.ek.n, shape)
    tb = stmt.dlog.ctx.bits
    e, s1, s3, cheap_ok = _pdl_host_ec_checks(proof, stmt, shape)
    lhs_u2 = stmt.ek.nn_ctx.pow_prod([stmt.ciphertext], [e], ebits_hints=(E_BITS,),
                                     mults=[proof.u2], sync=False)
    rhs_u2 = stmt.ek.nn_ctx.pow_prod([proof.s2], [n], ebits_hints=(stmt.ek.n_ctx.bits,),
                                     mults=[s1 * n + 1], sync=False)
    lhs_u3 = stmt.dlog.ctx.pow_prod([proof.z], [e], ebits_hints=(E_BITS,),
                                    mults=[proof.u3], sync=False)
    rhs_u3 = stmt.dlog.pow_h1h2(s1, s3, hints=(776, 768 + tb + 16), sync=False)
    return (cheap_ok & (resolve(lhs_u2) == resolve(rhs_u2))
            & (resolve(lhs_u3) == resolve(rhs_u3)))
