"""Batched Feldman VSS — the parts the signing path needs
(port of tpu_mpc/vss/feldman.py).

Conventions (matching curv): party with 0-based index i holds share p(i+1);
commitments C_k = a_k G; Lagrange coefficients are host-side int math.
"""

from __future__ import annotations

import dataclasses

from ..ec import secp256k1 as ec
from ..host import ec as hec

Q = hec.N


@dataclasses.dataclass
class VssSchemeBatch:
    """t, n plus commitment points [..., t+1] (Point of [..., t+1, 16])."""

    t: int
    n: int
    commitments: ec.Point


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
