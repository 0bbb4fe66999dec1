"""Serialization + hashing, the curv `DigestExt` analog (port of
tpu_mpc/host/serde.py).

Byte encodings (curv-kzen 0.9 conventions, used for every Fiat-Shamir
challenge and hash commitment):
  * BigInt  -> minimal big-endian bytes (no leading zeros; 0 -> empty string)
  * Point   -> SEC1 compressed, 33 bytes
  * digest-to-BigInt -> big-endian interpretation of the 32-byte SHA-256 output

`Digest` mirrors `Sha256::new().chain_bigint(..).chain_points(..).result_bigint()`.
"""

from __future__ import annotations

import hashlib

from . import ec


def bigint_to_bytes(x: int) -> bytes:
    """Minimal big-endian encoding; 0 encodes as b'' (curv BigInt convention)."""
    if x < 0:
        raise ValueError("negative BigInt serialization not supported on wire")
    if x == 0:
        return b""
    return x.to_bytes((x.bit_length() + 7) // 8, "big")


def bytes_to_bigint(b: bytes) -> int:
    return int.from_bytes(b, "big")


def point_to_bytes(pt) -> bytes:
    return ec.compress(pt)


def bytes_to_point(b: bytes):
    return ec.decompress(b)


class Digest:
    """SHA-256 chained over bigints/points, result as BigInt (curv DigestExt)."""

    def __init__(self):
        self._h = hashlib.sha256()

    def chain_bigint(self, *xs: int) -> "Digest":
        for x in xs:
            self._h.update(bigint_to_bytes(x))
        return self

    def chain_point(self, *pts) -> "Digest":
        for p in pts:
            self._h.update(point_to_bytes(p))
        return self

    def chain_bytes(self, *bs: bytes) -> "Digest":
        for b in bs:
            self._h.update(b)
        return self

    def result_bigint(self) -> int:
        return int.from_bytes(self._h.digest(), "big")

    def result_scalar(self) -> int:
        """Digest reduced into the secp256k1 scalar field (curv result_scalar)."""
        return self.result_bigint() % ec.N


def hash_sha256_bigints(*xs: int) -> int:
    return Digest().chain_bigint(*xs).result_bigint()


# --- hash commitments (curv HashCommitment<Sha256>) -------------------------

SECURITY_BITS = 256  # blinding length, gg_2020/party_i.rs:48


def create_commitment_with_user_defined_randomness(message: int, blinding: int) -> int:
    """com = H(message || blinding)  (curv HashCommitment semantics)."""
    return Digest().chain_bigint(message, blinding).result_bigint()


def commit_point(pt, blinding: int) -> int:
    """Commitment to an EC point: H(compressed(pt) || blinding)."""
    return Digest().chain_point(pt).chain_bigint(blinding).result_bigint()
