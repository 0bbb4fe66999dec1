"""Verifiable share backup: ElGamal-in-the-exponent segment encryption
(port of tpu_mpc/host/backup.py).

The centipede crate's `Msegmentation` API that ZenGo-X/multi-party-ecdsa
exposes on every protocol's private key (gg_2018/party_i.rs:360-369,
gg_2020/party_i.rs:502-511):

  to_encrypted_segments(secret, segment_size, num_segments, Y)
    -> (Witness{segments, randomness}, Helgamalsegmented{(D_i, E_i)})
  with  D_i = k_i G + r_i Y,  E_i = r_i G  for each `segment_size`-bit
  segment k_i of the secret scalar.

Recovery holds the backup key y (Y = y G): k_i G = D_i - y E_i, then a
baby-step/giant-step small dlog per segment reassembles the secret.
Host-side python ints: backup and recovery are an offline, low-rate path.
The draws (rng._r.randrange(1, N), one per segment) follow the reference's,
so a seeded backup equals the reference's point for point.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np

from . import ec as hec

N = hec.N


@dataclasses.dataclass
class Witness:
    """Plaintext segments + encryption randomness (centipede Witness)."""

    x_vec: list[int]
    r_vec: list[int]


@dataclasses.dataclass
class Helgamalsegmented:
    """One ElGamal-in-the-exponent pair per segment."""

    D: list[hec.Point]   # k_i G + r_i Y
    E: list[hec.Point]   # r_i G


def segment_secret(secret: int, segment_size: int, num_segments: int) -> list[int]:
    """Little-endian `segment_size`-bit chunks (centipede get_segment_k)."""
    mask = (1 << segment_size) - 1
    return [(secret >> (i * segment_size)) & mask for i in range(num_segments)]


def assemble_segments(segments: list[int], segment_size: int) -> int:
    acc = 0
    for i, k in enumerate(segments):
        acc |= int(k) << (i * segment_size)
    return acc


def to_encrypted_segments(secret: int, segment_size: int, num_segments: int,
                          pub_y: hec.Point, rng) -> tuple[Witness, Helgamalsegmented]:
    """Encrypt each segment under the backup public key Y.
    rng: SessionRng (anything with ._r.randrange)."""
    if num_segments * segment_size < 256:
        raise ValueError("segments must cover the 256-bit scalar")
    segs = segment_secret(secret % N, segment_size, num_segments)
    r_vec = [rng._r.randrange(1, N) for _ in segs]
    D, E = [], []
    for k, r in zip(segs, r_vec):
        rY = hec.mul(r, pub_y)
        D.append(hec.add(hec.mul(k), rY) if k else rY)
        E.append(hec.mul(r))
    return Witness(x_vec=segs, r_vec=r_vec), Helgamalsegmented(D=D, E=E)


def _bsgs(target: hec.Point, max_exp: int) -> int | None:
    """Solve k G == target for 0 <= k < max_exp (baby-step/giant-step)."""
    if target is None:
        return 0
    m = math.isqrt(max_exp) + 1
    table = {}
    cur = None
    for j in range(m):
        table.setdefault(cur, j)
        cur = hec.add(cur, hec.G)
    mG_neg = hec.neg(hec.mul(m))
    gamma = target
    for i in range(m + 1):
        j = table.get(gamma)
        if j is not None:
            k = i * m + j
            return k if k < max_exp else None
        gamma = hec.add(gamma, mG_neg)
    return None


def decrypt_segments(enc: Helgamalsegmented, backup_sk: int, segment_size: int) -> int | None:
    """Recover the secret with the backup decryption key y (Y = y G);
    None where a segment has no dlog below 2^segment_size (a wrong key)."""
    segs = []
    for Dp, Ep in zip(enc.D, enc.E):
        yE = hec.mul(backup_sk % N, Ep) if Ep is not None else None
        kG = hec.add(Dp, hec.neg(yE)) if yE is not None else Dp
        k = _bsgs(kG, 1 << segment_size)
        if k is None:
            return None
        segs.append(k)
    return assemble_segments(segs, segment_size) % N


def backup_batch(secrets, segment_size: int, num_segments: int, pub_y: hec.Point, rng):
    """Object ndarray of secrets -> (Witness list, Helgamalsegmented list),
    flattened row-major."""
    flat = np.asarray(secrets, dtype=object).reshape(-1)
    pairs = [to_encrypted_segments(int(s), segment_size, num_segments, pub_y, rng)
             for s in flat]
    return [p[0] for p in pairs], [p[1] for p in pairs]


def recover_batch(encs, backup_sk: int, segment_size: int) -> np.ndarray:
    return np.asarray([decrypt_segments(e, backup_sk, segment_size) for e in encs],
                      dtype=object)
