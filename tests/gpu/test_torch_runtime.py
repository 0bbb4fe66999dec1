"""The port's runtime (tpu_mpc_torch.runtime) on the CPU: the GG20 keygen and
signing state machines held message for message against the JAX package's
transcript tests/gpu/fixtures/runtime_768.json (make_torch_goldens.py
runtime_768: the seeds of tests/test_runtime.py at 768-bit Paillier), the
LocalKey file format, wire-level blame, and the wire codec and HTTP relay
against the JAX package's pure-python modules, live, in both directions.
Tolerance 0 throughout: every value is an integer, a point or a string."""

import json
import os
import random

import pytest

from tpu_mpc_torch.host import ec as hec
from tpu_mpc_torch.runtime import relay_client, relay_server
from tpu_mpc_torch.runtime.cli import load_local_key, save_local_key
from tpu_mpc_torch.runtime.gg20_keygen_sm import Gg20Keygen
from tpu_mpc_torch.runtime.gg20_sign_sm import (
    Gg20OfflineStage,
    partial_sig_local,
    scrub_offline,
    sign_manual,
)
from tpu_mpc_torch.runtime.state_machine import ProtocolError, run_simulation
from tpu_mpc_torch.runtime.wire import Msg, decode_value, encode_value, int_to_wire
from tpu_mpc_torch.utils.rng import SessionRng

DEV = "cpu"
GOLDEN = os.path.join(os.path.dirname(os.path.abspath(__file__)), "fixtures",
                      "runtime_768.json")


@pytest.fixture(scope="module")
def gold():
    with open(GOLDEN) as f:
        return json.load(f)


def _keys(gold):
    return [decode_value(o) for o in gold["keygen_outputs"]]


def _recorder(log):
    def rec(msg):
        log.append(msg.to_json())
        return msg
    return rec


def _offline_machines(gold, signer_keys, seeds=None, s_l=None):
    """One Gg20OfflineStage per signer: signer_keys[k] is local party k + 1's key."""
    s_l = s_l or gold["s_l"]
    seeds = seeds or gold["offline_seeds"]
    return [Gg20OfflineStage(li, s_l, key, SessionRng(seed), device=DEV)
            for li, (key, seed) in enumerate(zip(signer_keys, seeds), 1)]


def test_keygen_simulation_equals_reference_transcript(gold):
    msgs, bench = [], {}
    machines = [Gg20Keygen(i, gold["t"], gold["n"], SessionRng(seed),
                           paillier_bits=gold["bits"], device=DEV)
                for i, seed in enumerate(gold["keygen_seeds"], 1)]
    outs = run_simulation(machines, benchmarks=bench, tamper=_recorder(msgs))
    assert msgs == gold["keygen_msgs"]
    assert [encode_value(o) for o in outs] == gold["keygen_outputs"]
    assert sorted(bench) == [0, 1, 2, 3, 4] and all(len(v) == 3 for v in bench.values())
    assert "finished" in repr(machines[0])


def test_offline_and_online_signing_equal_reference_transcript(gold):
    msgs = []
    keys = _keys(gold)
    sms = _offline_machines(gold, [keys[g] for g in gold["s_l"]])
    off = run_simulation(sms, tamper=_recorder(msgs))
    assert msgs == gold["offline_msgs"]
    assert [encode_value(o) for o in off] == gold["offline_outputs"]
    m = int(gold["m"])
    partials = [partial_sig_local(o, m) for o in off]
    assert [str(p) for p in partials] == gold["partials"]
    sig = sign_manual(off[0], m, [partials[1]])
    assert sig == decode_value(gold["sig"]) and sig["valid"]
    assert sign_manual(off[1], m, [partials[0]]) == sig
    scrub_offline(off[0])
    assert off[0]["k"] == 0 and off[0]["sigma_i"] == 0


def test_reference_key_file_loads_and_saves_byte_for_byte(gold, tmp_path):
    src = tmp_path / "local1.json"
    src.write_text(gold["local_key_1"])
    key = load_local_key(str(src))
    assert key == _keys(gold)[0]
    out = tmp_path / "again.json"
    save_local_key(str(out), key)
    assert out.read_text() == gold["local_key_1"]


def test_relay_offline_stage_signs_with_the_reference_key_file(gold, tmp_path):
    """run_protocol over the port's relay: party 1 runs its offline stage
    from the key file the JAX package's CLI wrote, against party 2's
    messages of the golden transcript posted to the room; party 1's own
    messages equal its golden ones, in order, and its output and the
    signature are the golden's."""
    src = tmp_path / "local1.json"
    src.write_text(gold["local_key_1"])
    sm = _offline_machines(gold, [load_local_key(str(src))])[0]
    sender = lambda raw: json.loads(raw)["sender"]
    theirs = [raw for raw in gold["offline_msgs"] if sender(raw) == 2]
    server = relay_server.serve(port=0)
    addr = f"http://127.0.0.1:{server.server_address[1]}"
    try:
        peer = relay_client.SmClient(addr, "t-offline")
        for raw in theirs:
            peer.broadcast(raw)
        out = relay_client.run_protocol(sm, addr, "t-offline")
        room = relay_client.SmClient(addr, "t-offline").poll()
    finally:
        server.shutdown()
    assert room[:len(theirs)] == theirs
    assert room[len(theirs):] == [raw for raw in gold["offline_msgs"] if sender(raw) == 1]
    assert encode_value(out) == gold["offline_outputs"][0]
    m = int(gold["m"])
    sig = sign_manual(out, m, [int(gold["partials"][1])])
    assert sig == decode_value(gold["sig"]) and sig["valid"]


def test_wire_level_blame_tampered_alice_proof(gold):
    """Party 2's round-1 Alice range proof corrupted in transit: the
    receiving machine aborts with a ProtocolError blaming [2]."""
    keys = _keys(gold)
    sms = _offline_machines(gold, keys[:2], seeds=[501, 502], s_l=[0, 1])

    def tamper(msg):
        if msg.sender == 2 and msg.body.get("round") == 1 and "alice_proofs" in msg.body:
            for pr in msg.body["alice_proofs"].values():
                pr["z"] = int(pr["z"]) ^ 1  # flip one bit of the commitment
        return msg

    with pytest.raises(ProtocolError) as exc:
        run_simulation(sms, tamper=tamper)
    assert exc.value.bad_actors == [2]


def test_round_blame_reports_missing():
    sm = Gg20Keygen(1, 1, 3, SessionRng(400), paillier_bits=768, device=DEV)
    assert sm.wants_to_proceed()
    assert "round 0" in repr(sm)
    sm.proceed()  # round 0 -> broadcasts M1, now waiting
    count, blamed = sm.round_blame()
    assert count == 2 and blamed == [2, 3]
    assert "[bc 0/2]*" in repr(sm)


# ---- against the JAX package's pure-python wire and relay, live -----------

def _random_body(rnd: random.Random, depth: int = 0):
    body = {"round": rnd.randrange(1, 7)}
    for k in range(rnd.randrange(1, 6)):
        kind = rnd.randrange(6 if depth < 2 else 4)
        v = (rnd.getrandbits(rnd.choice((0, 1, 8, 256, 2048, 4096))) if kind == 0
             else hec.mul(rnd.randrange(1, hec.N)) if kind == 1
             else rnd.choice((True, False, None)) if kind == 2
             else f"s{rnd.getrandbits(32):x}" if kind == 3
             else [rnd.getrandbits(300), hec.mul(rnd.randrange(1, hec.N)), "x"] if kind == 4
             else _random_body(rnd, depth + 1))
        body[f"f{k}"] = v
    return body


def test_wire_equals_reference_on_random_bodies():
    from tpu_mpc.runtime import wire as jwire

    rnd = random.Random(0x3173)
    assert int_to_wire(0) == jwire.int_to_wire(0) == "00"
    for _ in range(60):
        body = _random_body(rnd)
        sender, receiver = rnd.randrange(1, 4), rnd.choice((None, 1, 2, 3))
        mine = Msg(sender, receiver, body).to_json()
        theirs = jwire.Msg(sender, receiver, body).to_json()
        assert mine == theirs
        back = Msg.from_json(theirs)
        assert (back.sender, back.receiver, back.body) == (sender, receiver, body)
        assert jwire.Msg.from_json(mine).body == body


@pytest.mark.parametrize("server_side", ["port", "reference"])
def test_relay_server_and_client_interoperate(server_side):
    """The port's relay with the JAX package's SmClient, and the reverse:
    unique indices, broadcast and poll."""
    from tpu_mpc.runtime import relay_client as jclient
    from tpu_mpc.runtime import relay_server as jserver

    srv_mod, cli_mod = (relay_server, jclient) if server_side == "port" else (jserver,
                                                                               relay_client)
    server = srv_mod.serve(port=0)
    addr = f"http://127.0.0.1:{server.server_address[1]}"
    try:
        a, b = cli_mod.SmClient(addr, "room"), cli_mod.SmClient(addr, "room")
        assert (a.issue_index(), b.issue_index()) == (1, 2)
        msgs = [Msg(1, None, {"round": 1, "x": 5}).to_json(),
                Msg(2, 1, {"round": 2, "pt": hec.mul(3)}).to_json()]
        a.broadcast(msgs[0])
        b.broadcast(msgs[1])
        assert a.poll() == msgs and b.poll() == msgs
        a.broadcast(msgs[0])
        assert a.poll() == [msgs[0]]
    finally:
        server.shutdown()
