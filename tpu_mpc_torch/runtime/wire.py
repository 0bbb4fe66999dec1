"""JSON wire format for protocol messages (port of tpu_mpc/runtime/wire.py:
the same strings for the same bodies).

Mirrors the reference's serde conventions (every message type is
Serialize/Deserialize, relayed as JSON by the sm_manager examples):
  * BigInt -> lowercase hex string (curv BigInt serde)
  * Point  -> 33-byte SEC1 compressed, hex
  * Msg { sender, receiver (null = broadcast), body }
    (round_based::Msg, state_machine/keygen.rs:417-426 hides the round enum
     behind a {round, payload} envelope for wire stability)
"""

from __future__ import annotations

import json
from typing import Any, Optional

from ..host import ec as hec


def int_to_wire(x: int) -> str:
    return format(x, "x") if x else "00"


def int_from_wire(s: str) -> int:
    return int(s, 16)


def point_to_wire(pt) -> Optional[str]:
    if pt is None:
        return None
    return hec.compress(pt).hex()


def point_from_wire(s: Optional[str]):
    if s is None:
        return None
    return hec.decompress(bytes.fromhex(s))


def encode_value(v) -> Any:
    """Recursively encode ints/points/lists/dicts into JSON-safe values."""
    if isinstance(v, bool) or v is None:
        return v
    if isinstance(v, int):
        return {"i": int_to_wire(v)}
    if isinstance(v, tuple) and len(v) == 2 and all(isinstance(c, int) for c in v):
        return {"p": point_to_wire(v)}
    if isinstance(v, (list,)):
        return [encode_value(x) for x in v]
    if isinstance(v, dict):
        return {k: encode_value(x) for k, x in v.items()}
    if isinstance(v, str):
        return v
    raise TypeError(f"cannot encode {type(v)} on the wire")


def decode_value(v) -> Any:
    if isinstance(v, dict):
        if set(v.keys()) == {"i"}:
            return int_from_wire(v["i"])
        if set(v.keys()) == {"p"}:
            return point_from_wire(v["p"])
        return {k: decode_value(x) for k, x in v.items()}
    if isinstance(v, list):
        return [decode_value(x) for x in v]
    return v


class Msg:
    """round_based::Msg — sender/receiver are 1-based party indices;
    receiver None means broadcast."""

    def __init__(self, sender: int, receiver: Optional[int], body: dict):
        self.sender = sender
        self.receiver = receiver
        self.body = body

    def to_json(self) -> str:
        return json.dumps(
            {"sender": self.sender, "receiver": self.receiver, "body": encode_value(self.body)}
        )

    @classmethod
    def from_json(cls, s: str) -> "Msg":
        d = json.loads(s)
        return cls(d["sender"], d["receiver"], decode_value(d["body"]))

    def is_broadcast(self) -> bool:
        return self.receiver is None
