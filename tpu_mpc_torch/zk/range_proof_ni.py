"""Batched non-interactive Paillier range proof (zk-paillier's RangeProofNi;
port of tpu_mpc/zk/range_proof_ni.py).

Proves that a Paillier ciphertext under ek encrypts a plaintext x < q/3
(soundness bound: x in (-q/3, 2q/3)), per Lindell'17 (eprint 2017/552)
Appendix A, the cut-and-choose protocol of the zk-paillier crate.

Protocol (REPS parallel repetitions, challenge bits via Fiat-Shamir):
  commit   for each rep: w1 uniform in [q/3, 2q/3), w2 = w1 - q/3,
           randomly swapped; c1 = Enc(w1; r1), c2 = Enc(w2; r2).
  e        = SHA-256(ek.n, cipher, c1..., c2...) -> REPS bits.
  respond  e_i = 0: open both pairs (w1, r1, w2, r2).
           e_i = 1: pick the j with x + wj in [q/3, 2q/3); send
           z = x + wj and masked randomness r * rj mod n.
  verify   opened pairs re-encrypt and have the {w, w - q/3} structure
           with max in [q/3, 2q/3); masked reps satisfy
           Enc(z; r_masked) == cipher * cj mod n^2 and z in [q/3, 2q/3).

The encryptions of a proof ride a trailing repetition axis: the prover's
2 x REPS encryptions of a slot (c1 and c2 stacked) are ONE K1 launch of
S x 2 x REPS lanes at the width of n^2, and so are the verifier's
re-encryptions of the opened pairs; the masked re-encryptions are a second
launch of S x REPS lanes.  (The reference launches c1 and c2 apart: the
same integers.)  Host ints handle the data-dependent j selection (the
prover's secret logic, not the hot path).
"""

from __future__ import annotations

import dataclasses

import numpy as np

from ..core.modctx import host_mulmod as _mulmod
from ..hashes.fiat_shamir import digest_rows
from ..host import ec as hec
from .range_proofs import PaillierCtxBatch

Q = hec.N
REPS = 40  # zk-paillier STATISTICAL_ERROR_FACTOR


def _encrypt(ek: PaillierCtxBatch, m, r, shape):
    """(1 + m n) r^n mod n^2 with an extra trailing repetition axis: one K1
    launch over every element of `shape` = key batch + (k,)."""
    n = np.broadcast_to(ek.n[..., None], shape)
    nn = np.broadcast_to(ek.nn[..., None], shape)
    rn = ek.nn_ctx.expand(ek.n_ctx.n_ints.ndim).pow(r, n, ebits_hint=ek.n_ctx.bits)
    return _mulmod(np.broadcast_to(m, shape) * n + 1, rn, nn)


def _encrypt_pairs(ek: PaillierCtxBatch, m1, r1, m2, r2, shape):
    """(_encrypt(m1, r1), _encrypt(m2, r2)) as ONE launch: the two [..., REPS]
    halves stacked on the repetition axis."""
    cat = lambda a, b: np.concatenate([np.broadcast_to(np.asarray(a, dtype=object), shape),
                                       np.broadcast_to(np.asarray(b, dtype=object), shape)],
                                      axis=-1)
    c = _encrypt(ek, cat(m1, m2), cat(r1, r2), shape[:-1] + (2 * REPS,))
    return c[..., :REPS], c[..., REPS:]


@dataclasses.dataclass
class RangeProofNiBatch:
    """Pairs + responses; batch shape [..., REPS] on the rep leaves."""

    c1: np.ndarray
    c2: np.ndarray
    e: np.ndarray            # [...] challenge ints (REPS low bits used)
    # open responses (valid where the challenge bit is 0, else 0)
    w1: np.ndarray
    r1: np.ndarray
    w2: np.ndarray
    r2: np.ndarray
    # masked responses (valid where the challenge bit is 1, else 0)
    z: np.ndarray
    r_masked: np.ndarray


def _challenge_bits(e, shape):
    """[..., REPS] boolean matrix from the packed challenge ints."""
    bits = np.zeros(shape, dtype=bool)
    flat_e = np.broadcast_to(np.asarray(e, dtype=object), shape[:-1]).reshape(-1)
    fb = bits.reshape(-1, REPS)
    for i, ev in enumerate(flat_e):
        v = int(ev)
        for k in range(REPS):
            fb[i, k] = (v >> k) & 1
    return fb.reshape(shape)


def _digest(ek: PaillierCtxBatch, cipher, c1, c2, base):
    return digest_rows(*([np.broadcast_to(ek.n, base),
                          np.broadcast_to(np.asarray(cipher, dtype=object), base)]
                         + [c1[..., k] for k in range(REPS)]
                         + [c2[..., k] for k in range(REPS)]))


def _rep(a, shape):
    """A [...] (or scalar) object array broadcast over the repetition axis."""
    a = np.asarray(a, dtype=object)
    return np.broadcast_to(a[..., None] if a.shape else a, shape)


def _in_range(v, q3) -> np.ndarray:
    return np.vectorize(lambda x: q3 <= int(x) < 2 * q3, otypes=[bool])(v)


def prove(ek: PaillierCtxBatch, cipher, x_ints, r_ints, rng) -> RangeProofNiBatch:
    """x < q/3 (prover side invariant); cipher = Enc_ek(x; r)."""
    x = np.asarray(x_ints, dtype=object)
    base = np.broadcast_shapes(x.shape, ek.n_ctx.batch_shape, np.shape(cipher))
    shape = base + (REPS,)
    q3 = Q // 3
    n_rep = np.broadcast_to(ek.n[..., None], shape)

    w_hi = rng.below(q3, shape) + q3          # in [q/3, 2q/3)
    w_lo = w_hi - q3
    swap = rng.bits(1, shape).astype(bool)
    w1 = np.where(swap, w_lo, w_hi)
    w2 = np.where(swap, w_hi, w_lo)
    r1 = rng.units_below(n_rep, shape)
    r2 = rng.units_below(n_rep, shape)
    c1, c2 = _encrypt_pairs(ek, w1, r1, w2, r2, shape)

    e = _digest(ek, cipher, c1, c2, base)
    bits = _challenge_bits(e, shape)

    # masked responses where bit = 1: choose the pair member that keeps
    # x + w in [q/3, 2q/3)
    xb = _rep(x, shape)
    sum1 = np.asarray(xb + w1, dtype=object)
    in_range1 = _in_range(sum1, q3)
    z = np.where(in_range1, sum1, xb + w2)
    rj = np.where(in_range1, r1, r2)
    r_masked = _mulmod(_rep(r_ints, shape), rj, n_rep)

    zero = np.zeros(shape, dtype=object)
    return RangeProofNiBatch(
        c1=c1, c2=c2, e=e,
        w1=np.where(bits, zero, w1), r1=np.where(bits, zero, r1),
        w2=np.where(bits, zero, w2), r2=np.where(bits, zero, r2),
        z=np.where(bits, z, zero), r_masked=np.where(bits, r_masked, zero),
    )


def verify(proof: RangeProofNiBatch, ek: PaillierCtxBatch, cipher) -> np.ndarray:
    """-> ok mask of the base batch shape."""
    base = np.broadcast_shapes(
        np.shape(proof.c1)[:-1], ek.n_ctx.batch_shape, np.shape(cipher)
    )
    shape = base + (REPS,)
    q3 = Q // 3
    nn_rep = np.broadcast_to(ek.nn[..., None], shape)

    e_check = _digest(ek, cipher, proof.c1, proof.c2, base)
    e_ok = e_check == np.broadcast_to(np.asarray(proof.e, dtype=object), base)
    bits = _challenge_bits(proof.e, shape)

    # opened reps: re-encrypt both, check pair structure
    c1_re, c2_re = _encrypt_pairs(ek, proof.w1, np.where(bits, 1, proof.r1),
                                  proof.w2, np.where(bits, 1, proof.r2), shape)
    struct_ok = np.vectorize(
        lambda a, b: (q3 <= int(a) < 2 * q3 and int(a) - int(b) == q3)
        or (q3 <= int(b) < 2 * q3 and int(b) - int(a) == q3),
        otypes=[bool],
    )(proof.w1, proof.w2)
    open_ok = (c1_re == proof.c1) & (c2_re == proof.c2) & struct_ok

    # masked reps: Enc(z; r_masked) == cipher * cj, z in range, for j in {1,2}
    z_re = _encrypt(ek, proof.z, np.where(bits, proof.r_masked, 1), shape)
    cb = _rep(cipher, shape)
    prod1 = _mulmod(cb, proof.c1, nn_rep)
    prod2 = _mulmod(cb, proof.c2, nn_rep)
    mask_ok = ((z_re == prod1) | (z_re == prod2)) & _in_range(proof.z, q3)

    per_rep = np.where(bits, mask_ok, open_ok)
    return e_ok & per_rep.all(axis=-1)
