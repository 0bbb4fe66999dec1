"""Batched Feldman verifiable secret sharing (port of tpu_mpc/vss/feldman.py).

Conventions (matching curv):
  * a degree-t polynomial p(X) = secret + a1 X + ... + at X^t over Z_q;
  * party with 0-based index i holds share p(i+1);
  * commitments C_k = a_k G, C_0 = secret G (K4, the comb for G);
  * share validation: share * G == sum_k (i+1)^k C_k;
  * Lagrange coefficients and the share polynomial are host-side int math.

Device work: the commitments and share checks (K4) and the commitment
evaluation, a Horner loop over points with small public multipliers
(point_add / point_double).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..device import to_numpy
from ..ec import secp256k1 as ec
from ..host import ec as hec

Q = hec.N


@dataclasses.dataclass
class VssSchemeBatch:
    """t, n plus commitment points [..., t+1] (Point of [..., t+1, 16])."""

    t: int
    n: int
    commitments: ec.Point


def _stack_points(pts):
    """list of Point batches -> Point with a new axis before the limb axis."""
    return ec.Point(*(torch.stack([getattr(p, c) for p in pts], dim=-2)
                      for c in ("X", "Y", "Z")))


def point_index(P: ec.Point, k: int) -> ec.Point:
    return ec.Point(P.X[..., k, :], P.Y[..., k, :], P.Z[..., k, :])


def scalar_mul_int(k: int, P: ec.Point) -> ec.Point:
    """k*P for a small public non-negative int (double-and-add)."""
    if k == 0:
        return ec.point_infinity(P.X.shape[:-1], P.X.device)
    acc = None
    base = P
    kk = k
    while kk:
        if kk & 1:
            acc = base if acc is None else ec.point_add(acc, base)
        kk >>= 1
        if kk:
            base = ec.point_double(base)
    return acc


def share(t: int, n: int, secret_ints, rng, device=None):
    """Share a batch of secrets -> (VssSchemeBatch, shares [..., n] ints).

    secret_ints: object ndarray [...] of ints < q.  The t coefficients are
    drawn from rng after the secrets (the reference's order).  Returns the
    shares as an object ndarray [..., n] (party j holds [..., j])."""
    secret = np.asarray(secret_ints, dtype=object)
    shape = secret.shape
    coeffs = [secret] + [rng.scalars(shape) for _ in range(t)]
    comms = _stack_points([ec.mul_generator(ec.sc_from_ints(c, device)) for c in coeffs])
    shares = np.empty(shape + (n,), dtype=object)
    flat_coeffs = [np.asarray(c, dtype=object).reshape(-1) for c in coeffs]
    flat_shares = shares.reshape(-1, n)
    for b in range(flat_shares.shape[0]):
        cs = [int(c[b]) for c in flat_coeffs]
        for j in range(1, n + 1):
            acc = 0
            for c in reversed(cs):
                acc = (acc * j + c) % Q
            flat_shares[b, j - 1] = acc
    return VssSchemeBatch(t=t, n=n, commitments=comms), shares


def commitment_eval(scheme: VssSchemeBatch, index0: int) -> ec.Point:
    """sum_k (index0+1)^k C_k — the public value of party index0's share."""
    x = index0 + 1
    acc = point_index(scheme.commitments, scheme.t)
    for k in range(scheme.t - 1, -1, -1):
        acc = ec.point_add(scalar_mul_int(x, acc), point_index(scheme.commitments, k))
    return acc


def validate_share(scheme: VssSchemeBatch, share_ints, index0: int) -> np.ndarray:
    """share * G == sum_k (index0+1)^k C_k, batched -> bool ndarray."""
    lhs = ec.mul_generator(ec.sc_from_ints(share_ints, scheme.commitments.X.device))
    return to_numpy(ec.point_eq(lhs, commitment_eval(scheme, index0)))


def lagrange_coeff(index0: int, s: list[int]) -> int:
    """Lagrange basis at 0 for party `index0` over signer subset s
    (0-based indices) — map_share_to_new_params."""
    xi = index0 + 1
    num, den = 1, 1
    for j in s:
        if j == index0:
            continue
        xj = j + 1
        num = num * xj % Q
        den = den * ((xj - xi) % Q) % Q
    return num * pow(den, -1, Q) % Q


def reconstruct(s: list[int], shares: list[int]) -> int:
    """Host-side Lagrange reconstruction at 0 (test and recovery path)."""
    acc = 0
    for idx, sh in zip(s, shares):
        acc = (acc + lagrange_coeff(idx, s) * sh) % Q
    return acc
