"""Batched interactive PDL proof, Lindell'17 protocol 6.1 (port of
tpu_mpc/zk/pdl.py).

Proves that a Paillier ciphertext c under ek decrypts to the discrete log x
of Q = xG, via a 2-round commit/decommit exchange plus a RangeProofNi
(sound only for x < q/3, zk_pdl/mod.rs:20-21).

Flow (zk_pdl/mod.rs:110-242):
  V.message1  a <- Z_q, b <- Z_{q^2}; c' = a (*) c (+) Enc(b);
              c'' = Com(a + b << a.bitlen, blind_v); Q' = aQ + bG
  P.message1  alpha = Dec(c'); Q^ = alpha G;
              c^ = Com(Q^_bytes, blind_p); range proof for x
  V.message2  verify range proof; decommit (a, b, blind_v)
  P.message2  check c'' and alpha == a x + b (over Z); decommit (Q^, blind_p)
  V.finalize  check c^ and Q^ == Q'

Paillier modexps are K1 launches on the key's device (Enc(b)'s r^n, c^a
with 256-bit exponents, the CRT decryption, the range proof's stacked
encryptions); the points are K3-K5 launches; the scalar bookkeeping is host
ints (interactive low-QPS path).
"""

from __future__ import annotations

import dataclasses

import numpy as np

from ..core.modctx import host_mulmod as _mulmod
from ..device import to_numpy
from ..ec import secp256k1 as dec
from ..hashes.fiat_shamir import commit_rows, point_hash_ints
from ..host import ec as hec
from ..mta.mta import paillier_decrypt_ints, paillier_encrypt_ints
from ..paillier import paillier as dp
from . import range_proof_ni
from .range_proofs import PaillierCtxBatch

Q = hec.N


@dataclasses.dataclass
class PDLStatementBatch:
    """(c, ek, Q, G) per slot (zk_pdl/mod.rs:49-54)."""

    ciphertext: np.ndarray
    ek: PaillierCtxBatch
    Q_pt: dec.Point


@dataclasses.dataclass
class PDLWitnessBatch:
    x: np.ndarray
    r: np.ndarray
    dk: dp.BatchDecryptionKey


@dataclasses.dataclass
class VerifierState:
    a: np.ndarray
    b: np.ndarray
    blindness: np.ndarray
    q_tag: dec.Point
    c_tag: np.ndarray
    c_tag_tag: np.ndarray


@dataclasses.dataclass
class VerifierMsg1:
    c_tag: np.ndarray
    c_tag_tag: np.ndarray


@dataclasses.dataclass
class ProverState:
    alpha: np.ndarray
    q_hat: dec.Point
    blindness: np.ndarray


@dataclasses.dataclass
class ProverMsg1:
    c_hat: np.ndarray
    range_proof: range_proof_ni.RangeProofNiBatch


@dataclasses.dataclass
class VerifierMsg2:
    a: np.ndarray
    b: np.ndarray
    blindness: np.ndarray


@dataclasses.dataclass
class ProverMsg2:
    q_hat: dec.Point
    blindness: np.ndarray


def _ab_concat(a, b) -> np.ndarray:
    """a + (b << a.bitlen), the committed encoding of (a, b)."""
    return np.vectorize(lambda av, bv: int(av) + (int(bv) << int(av).bit_length()),
                        otypes=[object])(a, b)


def verifier_message1(stmt: PDLStatementBatch, rng) -> tuple[VerifierMsg1, VerifierState]:
    shape = np.broadcast_shapes(np.shape(stmt.ciphertext), stmt.ek.n_ctx.batch_shape)
    dev = stmt.ek.n_ctx.device
    a = rng.scalars(shape)
    b = rng.below(Q * Q, shape)
    r_enc = rng.units_below(np.broadcast_to(stmt.ek.n, shape), shape)
    b_enc = paillier_encrypt_ints(stmt.ek, b, r_enc)
    ac = stmt.ek.nn_ctx.pow(stmt.ciphertext, a, ebits_hint=256)
    c_tag = _mulmod(ac, b_enc, np.broadcast_to(stmt.ek.nn, shape))
    blindness = rng.below(Q, shape)
    c_tag_tag = commit_rows(_ab_concat(a, b), blindness)
    a_sc = dec.sc_from_ints(a, dev)
    b_sc = dec.sc_from_ints(np.mod(b, Q), dev)
    q_tag = dec.point_add(dec.scalar_mul(a_sc, stmt.Q_pt), dec.mul_generator(b_sc))
    return (
        VerifierMsg1(c_tag=c_tag, c_tag_tag=c_tag_tag),
        VerifierState(a=a, b=b, blindness=blindness, q_tag=q_tag, c_tag=c_tag,
                      c_tag_tag=c_tag_tag),
    )


def prover_message1(witness: PDLWitnessBatch, stmt: PDLStatementBatch, v_msg1: VerifierMsg1,
                    rng) -> tuple[ProverMsg1, ProverState]:
    shape = np.broadcast_shapes(np.shape(v_msg1.c_tag), stmt.ek.n_ctx.batch_shape)
    alpha = paillier_decrypt_ints(witness.dk, v_msg1.c_tag, shape, bits=stmt.ek.n_ctx.bits)
    q_hat = dec.mul_generator(dec.sc_from_ints(np.mod(alpha, Q), stmt.ek.n_ctx.device))
    blindness = rng.below(Q, shape)
    c_hat = commit_rows(point_hash_ints(q_hat), blindness)
    rp = range_proof_ni.prove(stmt.ek, stmt.ciphertext, witness.x, witness.r, rng)
    return (
        ProverMsg1(c_hat=c_hat, range_proof=rp),
        ProverState(alpha=alpha, q_hat=q_hat, blindness=blindness),
    )


def verifier_message2(p_msg1: ProverMsg1, stmt: PDLStatementBatch,
                      state: VerifierState) -> tuple[VerifierMsg2, np.ndarray]:
    """-> (decommit msg, range_ok mask).  The reference errors out on a bad
    range proof (zk_pdl/mod.rs:160-168); batched, the mask is returned."""
    range_ok = range_proof_ni.verify(p_msg1.range_proof, stmt.ek, stmt.ciphertext)
    return VerifierMsg2(a=state.a, b=state.b, blindness=state.blindness), range_ok


def prover_message2(v_msg1: VerifierMsg1, v_msg2: VerifierMsg2, witness: PDLWitnessBatch,
                    state: ProverState) -> tuple[ProverMsg2, np.ndarray]:
    """Check the verifier's decommitment and alpha == a x + b over Z."""
    com_ok = commit_rows(_ab_concat(v_msg2.a, v_msg2.b), v_msg2.blindness) == v_msg1.c_tag_tag
    alpha_test = (np.asarray(v_msg2.a, dtype=object) * np.asarray(witness.x, dtype=object)
                  + v_msg2.b)
    alpha_ok = np.vectorize(lambda u, v: int(u) == int(v), otypes=[bool])(
        alpha_test, state.alpha)
    return ProverMsg2(q_hat=state.q_hat, blindness=state.blindness), com_ok & alpha_ok


def verifier_finalize(p_msg1: ProverMsg1, p_msg2: ProverMsg2, state: VerifierState) -> np.ndarray:
    com_ok = commit_rows(point_hash_ints(p_msg2.q_hat), p_msg2.blindness) == p_msg1.c_hat
    return com_ok & to_numpy(dec.point_eq(p_msg2.q_hat, state.q_tag))
