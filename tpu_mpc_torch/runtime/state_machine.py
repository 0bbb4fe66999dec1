"""Round-orchestration state machine (round_based::StateMachine semantics;
port of tpu_mpc/runtime/state_machine.py, device-free).

Re-implements the L3 layer of the reference (gg_2020/state_machine/): typed
per-round message stores with out-of-order buffering, the cheap
`wants_to_proceed` / expensive `proceed` split, a message queue of outgoing
Msg's, and RoundBlame ("who hasn't sent round-r yet",
state_machine/traits.rs:1-6).
"""

from __future__ import annotations

import abc
from typing import Optional

from .wire import Msg


class MsgStore:
    """Per-round store: collects one message per other party
    (round_based Store/BroadcastMsgs/P2PMsgs)."""

    def __init__(self, i: int, n: int):
        self.i = i
        self.n = n
        self.msgs: dict[int, Msg] = {}

    def push(self, msg: Msg) -> None:
        if msg.sender == self.i:
            return  # self-echo filtered (gg20_sm_client.rs:36-41)
        if msg.sender in self.msgs:
            return  # duplicate
        self.msgs[msg.sender] = msg

    def is_full(self) -> bool:
        return len(self.msgs) == self.n - 1

    def blame(self) -> list[int]:
        """1-based indices of parties whose message is missing."""
        return [j for j in range(1, self.n + 1) if j != self.i and j not in self.msgs]

    def bodies_by_party(self) -> dict[int, dict]:
        return {j: m.body for j, m in self.msgs.items()}


class ProtocolError(Exception):
    def __init__(self, error_type: str, bad_actors: list[int]):
        super().__init__(f"{error_type}: bad actors {bad_actors}")
        self.error_type = error_type
        self.bad_actors = bad_actors


class StateMachine(abc.ABC):
    """Subclasses implement _round_names and _proceed_round_k methods.

    Usage: feed incoming messages with handle_incoming(); when
    wants_to_proceed() is true, call proceed(); collect outgoing messages
    from message_queue; poll is_finished()/pick_output().
    """

    def __init__(self, i: int, n: int, num_rounds: int):
        self.party_i = i
        self.party_n = n
        self.num_rounds = num_rounds
        self.current_round = 0
        self.message_queue: list[Msg] = []
        self.stores: dict[int, MsgStore] = {
            r: MsgStore(i, n) for r in range(1, num_rounds + 1)
        }
        self.output = None
        self.started = False

    # -- round_based::StateMachine interface --------------------------------
    def handle_incoming(self, msg: Msg) -> None:
        rnd = msg.body.get("round")
        if rnd is None or not (1 <= rnd <= self.num_rounds):
            raise ProtocolError("unknown round", [msg.sender])
        if rnd < self.current_round:
            return  # late duplicate from a slow-but-honest party: drop it
            # (round_based stores silently ignore completed rounds; raising
            # here would let one stale relay replay kill a live session)
        self.stores[rnd].push(msg)

    def wants_to_proceed(self) -> bool:
        if self.is_finished():
            return False
        if not self.started:
            return True
        return self.stores[self.current_round].is_full()

    def proceed(self) -> None:
        if self.is_finished():
            return
        if not self.started:
            self.started = True
            self._proceed(0, {})
            self.current_round = 1
            return
        store = self.stores[self.current_round]
        if not store.is_full():
            return
        self._proceed(self.current_round, store.bodies_by_party())
        self.current_round += 1

    def is_finished(self) -> bool:
        return self.output is not None

    def pick_output(self):
        return self.output

    def round_blame(self) -> tuple[int, list[int]]:
        """(# of missing messages, 1-based culprits) for the current round."""
        if self.is_finished() or not self.started:
            return (0, [])
        blame = self.stores[self.current_round].blame()
        return (len(blame), blame)

    def round_timeout(self) -> Optional[float]:
        return None  # matches the reference (keygen.rs:291-297)

    # subclasses override to label each round's message kind, matching
    # OfflineStageProgress's from_broadcast/from_p2p cells (fmt.rs:40-45)
    ROUND_KINDS: dict[int, str] = {}

    def __repr__(self) -> str:
        """Human-readable round progress (OfflineStageProgress,
        state_machine/sign/fmt.rs:11-126): one `[bc|p2p k/n-1]` cell per
        round store — `*` marks the current round, `[-]` a not-yet-reached
        one — plus the outgoing-queue length (fmt.rs:46-48)."""
        cells = []
        for r in range(1, self.num_rounds + 1):
            got = len(self.stores[r].msgs)
            kind = self.ROUND_KINDS.get(r, "bc")
            mark = "*" if r == self.current_round else ""
            cells.append(
                f"[{kind} {got}/{self.party_n - 1}]{mark}" if r <= self.current_round or got
                else "[-]"
            )
        state = "finished" if self.is_finished() else f"round {self.current_round}"
        return (
            f"<{type(self).__name__} party {self.party_i}/{self.party_n} "
            f"{state} {' '.join(cells)} queue={len(self.message_queue)}>"
        )

    # -- helpers -------------------------------------------------------------
    def _broadcast(self, round_no: int, payload: dict) -> None:
        self.message_queue.append(
            Msg(self.party_i, None, {"round": round_no, **payload})
        )

    def _p2p(self, round_no: int, to: int, payload: dict) -> None:
        self.message_queue.append(Msg(self.party_i, to, {"round": round_no, **payload}))

    @abc.abstractmethod
    def _proceed(self, completed_round: int, bodies: dict[int, dict]) -> None:
        """Run the transition out of `completed_round` (0 = initial)."""


def run_simulation(machines: list[StateMachine], max_steps: int = 10000,
                   benchmarks: dict | None = None, tamper=None):
    """In-process multi-party execution (round_based::dev::Simulation,
    state_machine/keygen.rs:493-527): pump messages until all finish.

    Pass a dict as `benchmarks` to collect per-round proceed() wall times
    (Simulation::enable_benchmarks, keygen.rs:499-510): it is filled with
    {round_no: [seconds, ...]} across all machines.

    `tamper(msg) -> msg` intercepts every wire message (adversarial tests:
    corrupt a proof field in transit and assert the receiver's
    ProtocolError blames the sender).
    """
    import time as _time

    steps = 0
    while not all(m.is_finished() for m in machines):
        steps += 1
        if steps > max_steps:
            raise RuntimeError(
                f"simulation stalled; round blame: {[m.round_blame() for m in machines]}"
            )
        progressed = False
        for m in machines:
            if m.wants_to_proceed():
                rnd = m.current_round if m.started else 0
                t0 = _time.perf_counter()
                m.proceed()
                if benchmarks is not None:
                    benchmarks.setdefault(rnd, []).append(_time.perf_counter() - t0)
                progressed = True
        # deliver all queued messages
        for m in machines:
            outgoing, m.message_queue = m.message_queue, []
            for msg in outgoing:
                wire_msg = Msg.from_json(msg.to_json())  # exercise the wire
                if tamper is not None:
                    wire_msg = tamper(wire_msg)
                for other in machines:
                    if other is m:
                        continue
                    if wire_msg.receiver in (None, other.party_i):
                        other.handle_incoming(wire_msg)
        if not progressed and all(not m.wants_to_proceed() for m in machines) and not all(
            m.is_finished() for m in machines
        ):
            raise RuntimeError(
                f"deadlock; round blame: {[m.round_blame() for m in machines]}"
            )
    return [m.pick_output() for m in machines]
