"""Batched EC sigma protocols, Fiat-Shamir (port of tpu_mpc/zk/sigma.py:
the DLog, HomoElGamal, Pedersen and ECDDH proofs).

  DLogProof        PoK of x: Q = x G
  HomoElGamalProof PoK of (x, r): D = x H + r Y and E = r G
  PedersenProof    PoK of (m, r): T = m G + r H2, H2 = base_point2
  ECDDHProof       PoK of x: h1 = x g1 and h2 = x g2 (Chaum-Pedersen; GG20
                   phase-6 blame, gg_2020/blame.rs:258-271)

Challenge convention: e = SHA256(compressed points chained) mod q;
responses z = nonce + e * witness mod q.  Nonces come from the caller's
SessionRng.  Verify returns a boolean ndarray per slot.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np

from ..device import to_numpy
from ..ec import secp256k1 as ec
from ..hashes.fiat_shamir import digest_rows, point_hash_ints_many
from ..host import ec as hec

Q = hec.N


def _sc(xs, device) -> Any:
    return ec.sc_from_ints(xs, device)


@dataclasses.dataclass
class DLogProof:
    pk: ec.Point        # Q = x G
    commitment: ec.Point  # R = r G
    z: Any              # r + e x mod q, [..., 16]

    @property
    def batch_shape(self):
        return tuple(self.z.shape[:-1])


def dlog_prove(x_limbs, rng, base: ec.Point | None = None) -> DLogProof:
    """PoK of x for Q = x*Base (Base defaults to G)."""
    dev = x_limbs.device
    shape = tuple(x_limbs.shape[:-1])
    r_limbs = _sc(rng.scalars(shape), dev)
    if base is None:
        R = ec.mul_generator(r_limbs)
        Qp = ec.mul_generator(x_limbs)
        base = ec.generator(shape, dev)
    else:
        R = ec.scalar_mul(r_limbs, base)
        Qp = ec.scalar_mul(x_limbs, base)
    e = digest_rows(*point_hash_ints_many(R, base, Qp), reduce_mod=Q)
    z = ec.sc_add(r_limbs, ec.sc_mul(_sc(e, dev), x_limbs))
    return DLogProof(pk=Qp, commitment=R, z=z)


def dlog_verify(proof: DLogProof, base: ec.Point | None = None) -> np.ndarray:
    dev = proof.z.device
    shape = proof.batch_shape
    fixed_g = base is None
    base = base if base is not None else ec.generator(shape, dev)
    e = digest_rows(*point_hash_ints_many(proof.commitment, base, proof.pk), reduce_mod=Q)
    lhs = ec.mul_generator(proof.z) if fixed_g else ec.scalar_mul(proof.z, base)
    rhs = ec.point_add(proof.commitment, ec.scalar_mul(_sc(e, dev), proof.pk))
    return to_numpy(ec.point_eq(lhs, rhs))


@dataclasses.dataclass
class HomoElGamalProof:
    """Statement (G, H, Y, D, E): D = x H + r Y, E = r G; witness (x, r)."""

    T1: ec.Point
    T2: ec.Point
    z1: Any
    z2: Any


def _heg_challenge(G, H, Y, D, E, T1, T2):
    return digest_rows(*point_hash_ints_many(G, H, Y, D, E, T1, T2), reduce_mod=Q)


def homo_elgamal_prove(x_limbs, r_limbs, G, H, Y, D, E, rng) -> HomoElGamalProof:
    dev = x_limbs.device
    shape = tuple(x_limbs.shape[:-1])
    s1 = _sc(rng.scalars(shape), dev)
    s2 = _sc(rng.scalars(shape), dev)
    T1 = ec.dual_mul(s1, H, s2, Y)
    T2 = ec.scalar_mul(s2, G)
    e = _sc(_heg_challenge(G, H, Y, D, E, T1, T2), dev)
    z1 = ec.sc_add(s1, ec.sc_mul(e, x_limbs))
    z2 = ec.sc_add(s2, ec.sc_mul(e, r_limbs))
    return HomoElGamalProof(T1=T1, T2=T2, z1=z1, z2=z2)


def homo_elgamal_verify(proof: HomoElGamalProof, G, H, Y, D, E) -> np.ndarray:
    dev = proof.z1.device
    e = _sc(_heg_challenge(G, H, Y, D, E, proof.T1, proof.T2), dev)
    lhs1 = ec.dual_mul(proof.z1, H, proof.z2, Y)
    rhs1 = ec.point_add(proof.T1, ec.scalar_mul(e, D))
    lhs2 = ec.scalar_mul(proof.z2, G)
    rhs2 = ec.point_add(proof.T2, ec.scalar_mul(e, E))
    return to_numpy(ec.point_eq(lhs1, rhs1) & ec.point_eq(lhs2, rhs2))


@dataclasses.dataclass
class PedersenProof:
    """PoK of (m, r) for T = m G + r H2, H2 = base_point2."""

    T: ec.Point
    A: ec.Point
    z1: Any
    z2: Any


def pedersen_prove(m_limbs, r_limbs, rng) -> PedersenProof:
    dev = m_limbs.device
    shape = tuple(m_limbs.shape[:-1])
    T = ec.point_add(ec.mul_generator(m_limbs), ec.mul_base_point2(r_limbs))
    s1 = _sc(rng.scalars(shape), dev)
    s2 = _sc(rng.scalars(shape), dev)
    A = ec.point_add(ec.mul_generator(s1), ec.mul_base_point2(s2))
    e = _sc(digest_rows(*point_hash_ints_many(A, T), reduce_mod=Q), dev)
    z1 = ec.sc_add(s1, ec.sc_mul(e, m_limbs))
    z2 = ec.sc_add(s2, ec.sc_mul(e, r_limbs))
    return PedersenProof(T=T, A=A, z1=z1, z2=z2)


def pedersen_verify(proof: PedersenProof) -> np.ndarray:
    dev = proof.z1.device
    e = _sc(digest_rows(*point_hash_ints_many(proof.A, proof.T), reduce_mod=Q), dev)
    lhs = ec.point_add(ec.mul_generator(proof.z1), ec.mul_base_point2(proof.z2))
    rhs = ec.point_add(proof.A, ec.scalar_mul(e, proof.T))
    return to_numpy(ec.point_eq(lhs, rhs))


@dataclasses.dataclass
class ECDDHProof:
    """PoK of x: h1 = x g1, h2 = x g2 (Chaum-Pedersen DDH tuple)."""

    a1: ec.Point
    a2: ec.Point
    z: Any


def _ecddh_challenge(g1, h1, g2, h2, a1, a2):
    return digest_rows(*point_hash_ints_many(g1, h1, g2, h2, a1, a2), reduce_mod=Q)


def ecddh_prove(x_limbs, g1, g2, rng) -> ECDDHProof:
    dev = x_limbs.device
    shape = tuple(x_limbs.shape[:-1])
    s = _sc(rng.scalars(shape), dev)
    a1 = ec.scalar_mul(s, g1)
    a2 = ec.scalar_mul(s, g2)
    h1 = ec.scalar_mul(x_limbs, g1)
    h2 = ec.scalar_mul(x_limbs, g2)
    e = _sc(_ecddh_challenge(g1, h1, g2, h2, a1, a2), dev)
    z = ec.sc_add(s, ec.sc_mul(e, x_limbs))
    return ECDDHProof(a1=a1, a2=a2, z=z)


def ecddh_verify(proof: ECDDHProof, g1, h1, g2, h2) -> np.ndarray:
    e = _sc(_ecddh_challenge(g1, h1, g2, h2, proof.a1, proof.a2), proof.z.device)
    lhs1 = ec.scalar_mul(proof.z, g1)
    rhs1 = ec.point_add(proof.a1, ec.scalar_mul(e, h1))
    lhs2 = ec.scalar_mul(proof.z, g2)
    rhs2 = ec.point_add(proof.a2, ec.scalar_mul(e, h2))
    return to_numpy(ec.point_eq(lhs1, rhs1) & ec.point_eq(lhs2, rhs2))
