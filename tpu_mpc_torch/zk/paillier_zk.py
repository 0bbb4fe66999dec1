"""Paillier-related ZK proofs: correct key and composite discrete log
(port of tpu_mpc/zk/paillier_zk.py).

Re-implementations of the zk-paillier crate's NiCorrectKeyProof and
CompositeDLogProof, batch-first: the modexps of every proof run as one K1
launch over all sessions and parties (ModCtx.pow); hashes, inverses and the
final products run on host ints.  Values are the reference's, bit for bit.

  NiCorrectKeyProof (non-interactive RSA-modulus certification):
    seed_i  = SHA256(bytes(N) || bytes("KZen") || bytes(i)),  i < K = 11
    rho_i   = mask_generation(|N|, seed_i) mod N
    proof   sigma_i = rho_i^(N^-1 mod phi(N)) mod N
    verify  sigma_i^N == rho_i mod N for every i, and
            gcd(N, primorial of the primes below 6370) == 1.
  The proof's exponentiations run over a trailing challenge axis of K = 11.

  CompositeDLogProof (Girault identification, order-free):
    statement (N, g, ni) with ni = g^-x mod N;
    prove   r < 2^(2048 + 256 + 64), u = g^r, e = H(N, g, ni, u), y = r + e x;
    verify  g^y ni^e == u mod N.
  prove raises g to r (exponent class 2576); verify raises g to y (class
  2832, the clamp width) and ni to e (256 bits).
"""

from __future__ import annotations

import dataclasses
import hashlib
import math

import numpy as np

from ..core.modctx import ModCtx
from ..hashes.fiat_shamir import digest_rows
from ..host.serde import bigint_to_bytes

SALT_STRING = b"KZen"  # zk_paillier::zkproofs::SALT_STRING
_SALT_BN = int.from_bytes(SALT_STRING, "big")
CORRECT_KEY_K = 11     # rounds: soundness 128 / log2(alpha = 6370)
_DIGEST_SIZE = 256     # SHA-256 output bits (mask_generation chunk stride)
_ALPHA = 6370          # verifier requires gcd(N, primorial(< alpha)) == 1


def _sha256_bigints(*xs: int) -> int:
    """Sha256 chain_bigint(..).result_bigint() (curv DigestExt)."""
    h = hashlib.sha256()
    for x in xs:
        h.update(bigint_to_bytes(x))
    return int.from_bytes(h.digest(), "big")


def mask_generation(out_bits: int, seed: int) -> int:
    """zk-paillier mask_generation: SHA-256(seed || j) chunks, chunk j
    shifted left by 256 j (low chunk first), j <= out_bits // 256."""
    acc = 0
    for j in range(out_bits // _DIGEST_SIZE + 1):
        acc += _sha256_bigints(seed, j) << (_DIGEST_SIZE * j)
    return acc


def _primorial(bound: int) -> int:
    sieve = bytearray([1]) * bound
    sieve[:2] = b"\x00\x00"
    for p in range(2, int(bound ** 0.5) + 1):
        if sieve[p]:
            sieve[p * p :: p] = b"\x00" * len(sieve[p * p :: p])
    return math.prod(p for p in range(bound) if sieve[p])


ALPHA_PRIMORIAL = _primorial(_ALPHA)  # ~9.1k-bit constant, computed once


def correct_key_challenges(n: int) -> list[int]:
    """rho_i for i < K (zk-paillier correct_key_ni.rs proof()/verify())."""
    key_length = n.bit_length()
    return [mask_generation(key_length, _sha256_bigints(n, _SALT_BN, i)) % n
            for i in range(CORRECT_KEY_K)]


def _challenges(n_ctx: ModCtx) -> np.ndarray:
    """[..., K] object array of every modulus's rho_i."""
    shape = n_ctx.batch_shape
    rho = np.empty(shape + (CORRECT_KEY_K,), dtype=object)
    fr = rho.reshape(-1, CORRECT_KEY_K)
    for b, n in enumerate(n_ctx.n_ints.reshape(-1).tolist()):
        fr[b, :] = correct_key_challenges(int(n))
    return rho


@dataclasses.dataclass
class CorrectKeyProofBatch:
    """sigma values, object ndarray [..., K]."""

    sigma: np.ndarray


def correct_key_prove(n_ctx: ModCtx, phis) -> CorrectKeyProofBatch:
    """phis: object ndarray [...] of phi(N) (secret).  One K1 launch over
    the batch times the K challenges."""
    shape = n_ctx.batch_shape
    phis = np.broadcast_to(np.asarray(phis, dtype=object), shape)
    rho = _challenges(n_ctx)
    minv = np.empty(shape, dtype=object)
    fm = minv.reshape(-1)
    for b, (n, ph) in enumerate(zip(n_ctx.n_ints.reshape(-1).tolist(),
                                    phis.reshape(-1).tolist())):
        fm[b] = pow(int(n), -1, int(ph))
    m_exp = np.broadcast_to(minv[..., None], shape + (CORRECT_KEY_K,))
    # the challenge axis K broadcasts against the ctx batch as a trailing axis
    sigma = n_ctx.expand(n_ctx.n_ints.ndim).pow(rho, m_exp, ebits_hint=n_ctx.bits)
    return CorrectKeyProofBatch(sigma=sigma)


def correct_key_verify(proof: CorrectKeyProofBatch, n_ctx: ModCtx) -> np.ndarray:
    """-> bool ndarray [...]: every sigma_i^N == rho_i and gcd(N,
    primorial(< 6370)) == 1.  sigma values outside [0, N) (attacker-
    controlled) fail the row instead of raising."""
    shape = n_ctx.batch_shape
    rho = _challenges(n_ctx)
    n_flat = n_ctx.n_ints.reshape(-1).tolist()
    small_ok = np.asarray([math.gcd(int(n), ALPHA_PRIMORIAL) == 1 for n in n_flat],
                          dtype=bool).reshape(shape)
    sigma = np.array(proof.sigma, dtype=object).reshape(shape + (CORRECT_KEY_K,))
    width_ok = np.ones(shape, dtype=bool)
    n_b = np.broadcast_to(n_ctx.n_ints, shape)
    for idx in np.ndindex(*shape):
        nv = int(n_b[idx])
        for i in range(CORRECT_KEY_K):
            s = int(sigma[idx + (i,)])
            if s < 0 or s >= nv:
                width_ok[idx] = False
                sigma[idx + (i,)] = 0
    exps = np.broadcast_to(n_ctx.n_ints[..., None], shape + (CORRECT_KEY_K,))
    back = n_ctx.expand(n_ctx.n_ints.ndim).pow(sigma, exps, ebits_hint=n_ctx.bits)
    return np.all(back == rho, axis=-1) & small_ok & width_ok


@dataclasses.dataclass
class CompositeDLogStatementBatch:
    """(N_tilde, g, ni) batches; the modulus carried as a shared ModCtx."""

    ctx: ModCtx          # N_tilde
    g: np.ndarray        # object ndarray [...]
    ni: np.ndarray


@dataclasses.dataclass
class CompositeDLogProofBatch:
    u: np.ndarray
    y: np.ndarray        # integer response (no modular reduction)


_R_BITS = 2048 + 256 + 64  # statistically hides e*x for x < phi < 2^2048


def _cdlog_challenge(stmt: CompositeDLogStatementBatch, u) -> np.ndarray:
    return digest_rows(stmt.ctx.n_ints, stmt.g, stmt.ni, u)


def composite_dlog_prove(stmt: CompositeDLogStatementBatch, xs, rng) -> CompositeDLogProofBatch:
    shape = np.broadcast_shapes(stmt.ctx.batch_shape, np.shape(xs))
    xs = np.broadcast_to(np.asarray(xs, dtype=object), shape)
    r = rng.bits(_R_BITS, shape)
    u = stmt.ctx.pow(stmt.g, r, ebits_hint=_R_BITS)
    e = _cdlog_challenge(stmt, u)
    return CompositeDLogProofBatch(u=u, y=e * xs + r)


def composite_dlog_verify(proof: CompositeDLogProofBatch,
                          stmt: CompositeDLogStatementBatch) -> np.ndarray:
    """-> bool ndarray.  y is an attacker-controlled field: a negative or
    over-wide y fails its row before any device call, never raises."""
    y = np.array(proof.y, dtype=object)
    yf = y.reshape(-1)
    y_ok = np.asarray([0 <= int(v) < (1 << (_R_BITS + 300)) for v in yf.tolist()],
                      dtype=bool).reshape(y.shape)
    yf[~y_ok.reshape(-1)] = 0
    e = _cdlog_challenge(stmt, proof.u)
    g_y = stmt.ctx.pow(stmt.g, y, ebits_hint=_R_BITS + 300)
    ni_e = stmt.ctx.pow(stmt.ni, e, ebits_hint=256)
    n = np.broadcast_to(stmt.ctx.n_ints, g_y.shape)
    flat = [np.broadcast_to(np.asarray(a, dtype=object), g_y.shape).reshape(-1)
            for a in (g_y, ni_e, n, proof.u)]
    out = np.asarray([int(a) * int(b) % int(m) == int(u) for a, b, m, u in zip(*flat)],
                     dtype=bool)
    return out.reshape(g_y.shape) & np.broadcast_to(y_ok, g_y.shape)
