"""Serialization for hashing (port of tpu_mpc/host/serde.py, the part the
Fiat-Shamir layer needs): the curv BigInt byte convention."""

from __future__ import annotations


def bigint_to_bytes(x: int) -> bytes:
    """Minimal big-endian encoding; 0 encodes as b'' (curv BigInt convention)."""
    if x < 0:
        raise ValueError("negative BigInt serialization not supported on wire")
    if x == 0:
        return b""
    return x.to_bytes((x.bit_length() + 7) // 8, "big")
