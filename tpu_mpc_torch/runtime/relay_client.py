"""Relay client — join_computation (examples/gg20_sm_client.rs:10-53; port of
tpu_mpc/runtime/relay_client.py).

Returns (party_index, incoming-iterator, outgoing-sink) over the HTTP relay;
self-echo is filtered client-side like the reference.
"""

from __future__ import annotations

import json
import threading
import urllib.request
from typing import Callable, Iterator

from .state_machine import StateMachine
from .wire import Msg


class SmClient:
    def __init__(self, address: str, room: str):
        self.base = address.rstrip("/") + "/rooms/" + room
        self._cursor = 0

    def _post(self, path: str, body: bytes = b"") -> dict:
        req = urllib.request.Request(self.base + path, data=body, method="POST")
        with urllib.request.urlopen(req, timeout=60) as resp:
            return json.loads(resp.read())

    def _get(self, path: str) -> dict:
        with urllib.request.urlopen(self.base + path, timeout=60) as resp:
            return json.loads(resp.read())

    def issue_index(self) -> int:
        return self._post("/issue_unique_idx")["unique_idx"]

    def broadcast(self, message: str) -> None:
        self._post("/broadcast", message.encode())

    def poll(self) -> list[str]:
        out = self._get(f"/messages?since={self._cursor}")
        self._cursor = out["next"]
        return out["messages"]


def join_computation(address: str, room: str):
    """-> (index, recv(), send(msg)) — the reference's (i, Stream, Sink)."""
    client = SmClient(address, room)
    index = client.issue_index()

    def recv() -> Iterator[Msg]:
        while True:
            for raw in client.poll():
                msg = Msg.from_json(raw)
                if msg.sender == index:
                    continue  # self-echo filter
                yield msg

    def send(msg: Msg) -> None:
        client.broadcast(msg.to_json())

    return index, recv(), send


def run_protocol(sm: StateMachine, address: str, room: str) -> dict:
    """AsyncProtocol::run analog (examples/gg20_keygen.rs:47-51): pump the
    state machine against the relay until it finishes."""
    client = SmClient(address, room)

    def flush():
        outgoing, sm.message_queue = sm.message_queue, []
        for m in outgoing:
            client.broadcast(m.to_json())

    while not sm.is_finished():
        if sm.wants_to_proceed():
            sm.proceed()
            flush()
            continue
        for raw in client.poll():
            msg = Msg.from_json(raw)
            if msg.sender == sm.party_i:
                continue
            if msg.receiver in (None, sm.party_i):
                sm.handle_incoming(msg)
        if sm.wants_to_proceed():
            sm.proceed()
            flush()
    return sm.pick_output()
