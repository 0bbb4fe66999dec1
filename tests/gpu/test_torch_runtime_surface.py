"""The port's runtime surface on the CPU, piece by piece: the wire codec's
edge values, the round-orchestration state machine, the GG20 relay's and
the GG18 KV relay's endpoints, the GG18 KV transport, AES-256-GCM on the
published known answers, and the CLI's flags.  Each piece is held against
the JAX package's pure-python module on the same inputs, live; AES-GCM
against FIPS-197 appendix C.3 and the GCM specification's AES-256 test
cases 13-15.  Tolerance 0 throughout: every value is an integer, a point,
a byte string or a string."""

import http.client
import json
import sys
import urllib.error
import urllib.request

import pytest

from tpu_mpc_torch.host import ec as hec
from tpu_mpc_torch.runtime import cli, kv_server, relay_server
from tpu_mpc_torch.runtime import gg18_common as g
from tpu_mpc_torch.runtime import state_machine as sm
from tpu_mpc_torch.runtime.wire import (
    Msg,
    decode_value,
    encode_value,
    int_from_wire,
    int_to_wire,
    point_from_wire,
    point_to_wire,
)


# ---- wire codec ------------------------------------------------------------

@pytest.mark.parametrize("x", [0, 1, 0xF, 0x10, 2**256 - 1, hec.N - 1, 2**4096 + 1],
                         ids=["0", "1", "15", "16", "2^256-1", "N-1", "2^4096+1"])
def test_int_wire_equals_reference(x):
    from tpu_mpc.runtime import wire as jwire

    s = int_to_wire(x)
    assert s == jwire.int_to_wire(x)
    assert s == s.lower() and (s == "00" or not s.startswith("0"))
    assert int_from_wire(s) == jwire.int_from_wire(s) == x
    body = {"round": 1, "x": x}
    assert Msg(1, None, body).to_json() == jwire.Msg(1, None, body).to_json()


@pytest.mark.parametrize("pt", [hec.G, hec.mul(2), hec.neg(hec.mul(2)), None],
                         ids=["G", "2G", "-2G", "infinity"])
def test_point_wire_equals_reference(pt):
    from tpu_mpc.runtime import wire as jwire

    s = point_to_wire(pt)
    assert s == jwire.point_to_wire(pt)
    if pt is not None:
        assert len(s) == 66 and s[:2] == ("03" if pt[1] & 1 else "02")
    assert point_from_wire(s) == jwire.point_from_wire(s) == pt
    assert encode_value({"p": pt}) == jwire.encode_value({"p": pt})


@pytest.mark.parametrize("v", [1.5, b"ab", {1, 2}, (1, 2, 3), (1, "a")],
                         ids=["float", "bytes", "set", "3-tuple", "mixed-tuple"])
def test_unencodable_values_raise_like_reference(v):
    from tpu_mpc.runtime import wire as jwire

    with pytest.raises(TypeError):
        jwire.encode_value({"round": 1, "v": v})
    with pytest.raises(TypeError):
        encode_value({"round": 1, "v": v})


def test_decode_keeps_plain_dicts_and_literals_like_reference():
    from tpu_mpc.runtime import wire as jwire

    for raw in ({"i": "0f", "j": 1}, {"p": None, "q": "x"}, {"i": "ff"}, {"p": None},
                [True, None, "s", {"i": "00"}], {"a": [{"b": {"i": "10"}}]}):
        assert decode_value(raw) == jwire.decode_value(raw)
    assert decode_value({"i": "0f", "j": 1}) == {"i": "0f", "j": 1}
    assert Msg(2, None, {}).is_broadcast() and not Msg(2, 3, {}).is_broadcast()


# ---- state machine ---------------------------------------------------------

def _toy(base):
    """A two-round protocol on `base`: round 1 broadcasts, round 2 sends
    one p2p message to each peer; the output records what arrived."""

    class Toy(base):
        ROUND_KINDS = {1: "bc", 2: "p2p"}

        def __init__(self, i, n):
            super().__init__(i, n, 2)

        def _proceed(self, rnd, bodies):
            if rnd == 0:
                self._broadcast(1, {"v": 1000 * self.party_i + 7, "pt": hec.mul(self.party_i)})
            elif rnd == 1:
                self.seen = {j: (b["v"], b["pt"]) for j, b in sorted(bodies.items())}
                for j in range(1, self.party_n + 1):
                    if j != self.party_i:
                        self._p2p(2, j, {"share": self.party_i * j})
            else:
                self.output = {"i": self.party_i, "bc": self.seen,
                               "p2p": {j: b["share"] for j, b in sorted(bodies.items())}}

    return Toy


class _Silent(sm.StateMachine):
    """Starts, sends nothing, and so waits forever for round 1."""

    def __init__(self, i, n):
        super().__init__(i, n, 1)

    def _proceed(self, rnd, bodies):
        pass


def _run_toy(mod, n):
    log, reprs = [], []
    machines = [_toy(mod.StateMachine)(i, n) for i in range(1, n + 1)]
    reprs.append([repr(m) for m in machines])

    def rec(msg):
        log.append(msg.to_json())
        reprs.append([repr(m) for m in machines])
        return msg

    bench = {}
    outs = mod.run_simulation(machines, benchmarks=bench, tamper=rec)
    reprs.append([repr(m) for m in machines])
    return outs, log, reprs, sorted((k, len(v)) for k, v in bench.items())


@pytest.mark.parametrize("n", [2, 3, 5])
def test_toy_protocol_runs_like_reference(n):
    from tpu_mpc.runtime import state_machine as jsm

    outs, log, reprs, bench = _run_toy(sm, n)
    assert (outs, log, reprs, bench) == _run_toy(jsm, n)
    assert len(log) == n + n * (n - 1)
    assert bench == [(0, n), (1, n), (2, n)]
    for o in outs:
        i = o["i"]
        assert o["bc"] == {j: (1000 * j + 7, hec.mul(j)) for j in range(1, n + 1) if j != i}
        assert o["p2p"] == {j: i * j for j in range(1, n + 1) if j != i}


@pytest.mark.parametrize("body", [{"x": 1}, {"round": 0}, {"round": 3}],
                         ids=["no-round", "round-0", "round-past-last"])
def test_unknown_round_blames_its_sender_like_reference(body):
    from tpu_mpc.runtime import state_machine as jsm
    from tpu_mpc.runtime import wire as jwire

    mine, theirs = _toy(sm.StateMachine)(1, 3), _toy(jsm.StateMachine)(1, 3)
    with pytest.raises(sm.ProtocolError) as exc:
        mine.handle_incoming(Msg(2, None, body))
    with pytest.raises(jsm.ProtocolError) as ref:
        theirs.handle_incoming(jwire.Msg(2, None, body))
    assert exc.value.bad_actors == ref.value.bad_actors == [2]
    assert str(exc.value) == str(ref.value) == "unknown round: bad actors [2]"


def test_store_drops_self_echo_duplicates_and_late_messages():
    m = _toy(sm.StateMachine)(1, 3)
    assert m.round_blame() == (0, [])                  # not started
    m.proceed()
    m.handle_incoming(Msg(1, None, {"round": 1, "v": 0, "pt": None}))   # self-echo
    m.handle_incoming(Msg(2, None, {"round": 1, "v": 2, "pt": None}))
    m.handle_incoming(Msg(2, None, {"round": 1, "v": 99, "pt": None}))  # duplicate
    assert m.round_blame() == (1, [3]) and not m.wants_to_proceed()
    assert m.stores[1].msgs[2].body["v"] == 2
    m.handle_incoming(Msg(3, None, {"round": 1, "v": 3, "pt": None}))
    m.proceed()
    assert m.current_round == 2 and m.round_blame() == (2, [2, 3])
    m.handle_incoming(Msg(2, None, {"round": 1, "v": 5, "pt": None}))  # late: dropped
    assert m.stores[1].msgs[2].body["v"] == 2
    for j in (2, 3):
        m.handle_incoming(Msg(j, 1, {"round": 2, "share": j}))
    m.proceed()
    assert m.is_finished() and m.round_blame() == (0, []) and not m.wants_to_proceed()
    assert m.pick_output()["p2p"] == {2: 2, 3: 3}


def test_simulation_reports_deadlock_with_round_blame_like_reference():
    from tpu_mpc.runtime import state_machine as jsm

    class JSilent(jsm.StateMachine):
        def __init__(self, i, n):
            super().__init__(i, n, 1)

        def _proceed(self, rnd, bodies):
            pass

    with pytest.raises(RuntimeError) as exc:
        sm.run_simulation([_Silent(1, 2), _Silent(2, 2)])
    with pytest.raises(RuntimeError) as ref:
        jsm.run_simulation([JSilent(1, 2), JSilent(2, 2)])
    assert str(exc.value) == str(ref.value) == "deadlock; round blame: [(1, [2]), (1, [1])]"


# ---- the GG20 relay's and the GG18 KV relay's endpoints ---------------------

def _http(addr, method, path, body=None):
    """(status, JSON body) of one request; error statuses included."""
    req = urllib.request.Request(addr + path, data=body, method=method)
    try:
        with urllib.request.urlopen(req, timeout=10) as resp:
            return resp.status, json.loads(resp.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def _sse(addr, path, events):
    """The first `events` (id, data) pairs of an SSE stream."""
    host, port = addr.rsplit("/", 1)[1].split(":")
    conn = http.client.HTTPConnection(host, int(port), timeout=10)
    try:
        conn.request("GET", path)
        resp = conn.getresponse()
        out, ev = [], {}
        while len(out) < events:
            line = resp.fp.readline().decode().rstrip("\n")
            if not line:
                out.append((int(ev["id"]), ev["data"]))
                ev = {}
            else:
                k, v = line.split(": ", 1)
                ev[k] = v
        return resp.status, resp.getheader("Content-Type"), out
    finally:
        conn.close()


def _relay_unknown_paths(addr):
    return [_http(addr, "POST", "/rooms/r/nope", b""), _http(addr, "GET", "/rooms/r/nope"),
            _http(addr, "POST", "/foo", b""), _http(addr, "GET", "/rooms/r")]


def _relay_indices_per_room(addr):
    return [_http(addr, "POST", f"/rooms/{r}/issue_unique_idx", b"")
            for r in ("a", "a", "b", "a", "b")]


def _relay_messages_since(addr):
    out = [_http(addr, "POST", "/rooms/m/broadcast", f"msg {k}".encode()) for k in range(3)]
    return out + [_http(addr, "GET", f"/rooms/m/messages?since={k}") for k in (0, 1, 2)]


def _relay_subscribe_resumes(addr):
    for k in range(3):
        _http(addr, "POST", "/rooms/s/broadcast", json.dumps({"k": k}).encode())
    return [_sse(addr, "/rooms/s/subscribe?last_event_id=1", 2),
            _sse(addr, "/rooms/s/subscribe", 3)]


@pytest.mark.parametrize("scenario", [_relay_unknown_paths, _relay_indices_per_room,
                                      _relay_messages_since, _relay_subscribe_resumes],
                         ids=["unknown-paths", "indices-per-room", "messages-since",
                              "subscribe-resumes"])
def test_relay_endpoints_answer_like_reference(scenario):
    from tpu_mpc.runtime import relay_server as jserver

    answers = []
    for mod in (relay_server, jserver):
        server = mod.serve(port=0)
        try:
            answers.append(scenario(f"http://127.0.0.1:{server.server_address[1]}"))
        finally:
            server.shutdown()
    assert answers[0] == answers[1]


def test_two_relays_in_one_process_keep_their_rooms_apart():
    servers = [relay_server.serve(port=0) for _ in range(2)]
    try:
        a, b = (f"http://127.0.0.1:{s.server_address[1]}" for s in servers)
        _http(a, "POST", "/rooms/x/broadcast", b"only on a")
        assert _http(a, "POST", "/rooms/x/issue_unique_idx", b"")[1] == {"unique_idx": 1}
        assert _http(b, "POST", "/rooms/x/issue_unique_idx", b"")[1] == {"unique_idx": 1}
        _http(b, "POST", "/rooms/x/broadcast", b"only on b")
        assert _http(a, "GET", "/rooms/x/messages?since=0")[1] == {"messages": ["only on a"],
                                                                   "next": 1}
        assert _http(b, "GET", "/rooms/x/messages?since=0")[1] == {"messages": ["only on b"],
                                                                   "next": 1}
    finally:
        for s in servers:
            s.shutdown()


def _kv(addr, path, body):
    raw = body if isinstance(body, bytes) else json.dumps(body).encode()
    return _http(addr, "POST", "/" + path, raw)


def _kv_write_once(addr):
    return [_kv(addr, "get", {"key": "k"}), _kv(addr, "set", {"key": "k", "value": "v1"}),
            _kv(addr, "get", {"key": "k"}), _kv(addr, "set", {"key": "k", "value": "v2"}),
            _kv(addr, "get", {"key": "k"}), _kv(addr, "get", {"key": "other"})]


def _kv_bad_requests(addr):
    return [_kv(addr, "get", b"{not json"), _kv(addr, "nope", {}), _kv(addr, "get", b"")]


def _signups(addr, path, count):
    """Signup numbers, and for each the index of its first uuid (uuids are random)."""
    got = [_kv(addr, path, {}) for _ in range(count)]
    uuids = [a[1]["Ok"]["uuid"] for a in got]
    return [(a[0], a[1]["Ok"]["number"], uuids.index(u)) for a, u in zip(got, uuids)]


def _kv_signup_keygen(addr):
    return _signups(addr, "signupkeygen", 7)


def _kv_signup_sign(addr):
    return _signups(addr, "signupsign", 7)


@pytest.mark.parametrize("scenario", [_kv_write_once, _kv_bad_requests, _kv_signup_keygen,
                                      _kv_signup_sign],
                         ids=["write-once", "bad-requests", "signup-keygen", "signup-sign"])
def test_kv_relay_endpoints_answer_like_reference(scenario):
    from tpu_mpc.runtime import kv_server as jkv

    answers = []
    for mod in (kv_server, jkv):
        server = mod.serve(port=0, parties=3, threshold=2)
        try:
            answers.append(scenario(f"http://127.0.0.1:{server.server_address[1]}"))
        finally:
            server.shutdown()
    assert answers[0] == answers[1]
    if scenario is _kv_signup_keygen:       # 3 parties: 1 2 3, then a new ceremony
        assert [a[1:] for a in answers[0]] == [(1, 0), (2, 0), (3, 0), (1, 3), (2, 3),
                                               (3, 3), (1, 6)]
    if scenario is _kv_signup_sign:         # threshold 2: 3 signers a ceremony
        assert [a[1] for a in answers[0]] == [1, 2, 3, 1, 2, 3, 1]


@pytest.mark.parametrize("writer", ["port", "reference"])
def test_gg18_kv_transport_interoperates(writer):
    """Broadcast and p2p entries written by one side's gg18_common are
    polled by the other's, over the port's KV relay."""
    from tpu_mpc.runtime import gg18_common as jg

    put, take = (g, jg) if writer == "port" else (jg, g)
    server = kv_server.serve(port=0)
    addr = f"http://127.0.0.1:{server.server_address[1]}"
    data = {"y": hec.mul(5), "x": 2**300 + 1, "l": [1, hec.mul(6)], "f": True}
    try:
        wc, rc = put.KvClient(addr), take.KvClient(addr)
        for j in (2, 3):
            put.broadcast(wc, j, "round1", {**data, "from": j}, "u")
            put.sendp2p(wc, j, 1, "round2", {**data, "to": 1}, "u")
        assert take.poll_for_broadcasts(rc, 1, 3, "round1", "u") == \
            {2: {**data, "from": 2}, 3: {**data, "from": 3}}
        assert take.poll_for_p2p(rc, 1, 3, "round2", "u") == {2: {**data, "to": 1},
                                                              3: {**data, "to": 1}}
        assert rc.get("2-round1-u") == wc.get("2-round1-u") is not None
        assert rc.get("2-1-round2-u") is not None and rc.get("1-2-round2-u") is None
    finally:
        server.shutdown()


def test_gg18_poll_times_out_naming_the_missing_key():
    server = kv_server.serve(port=0)
    addr = f"http://127.0.0.1:{server.server_address[1]}"
    try:
        c = g.KvClient(addr)
        g.broadcast(c, 2, "r", {"v": 1}, "u")
        with pytest.raises(TimeoutError, match="3-r-u"):
            g.poll_for_broadcasts(c, 1, 3, "r", "u", delay=0.01, timeout=0.2)
        with pytest.raises(TimeoutError, match="2-1-r-u"):
            g.poll_for_p2p(c, 1, 3, "r", "u", delay=0.01, timeout=0.2)
    finally:
        server.shutdown()


# ---- AES-256-GCM known answers ---------------------------------------------

def test_aes256_block_equals_fips197_appendix_c3():
    rk = g._expand_key(bytes(range(32)))
    assert len(rk) == 15 and all(len(k) == 16 for k in rk)
    ct = g._encrypt_block(rk, bytes.fromhex("00112233445566778899aabbccddeeff"))
    assert ct.hex() == "8ea2b7ca516745bfeafc49904b496089"


def test_sbox_is_the_fips197_sbox():
    assert sorted(g._SBOX) == list(range(256))
    assert [g._SBOX[a] for a in (0x00, 0x01, 0x53, 0x7F, 0xFF)] == [0x63, 0x7C, 0xED, 0xD2, 0x16]


_K15 = bytes.fromhex("feffe9928665731c6d6a8f9467308308" * 2)
_P15 = bytes.fromhex(
    "d9313225f88406e5a55909c5aff5269a86a7a9531534f7da2e4c303d8a318a72"
    "1c3c0c95956809532fcf0e2449a6b525b16aedf5aa0de657ba637b391aafd255")


@pytest.mark.parametrize("key,nonce,pt,want", [
    (bytes(32), bytes(12), b"", "530f8afbc74536b9a963b4f1c4cb738b"),
    (bytes(32), bytes(12), bytes(16),
     "cea7403d4d606b6e074ec5d3baf39d18" "d0d1c8a799996bf0265b98b5d48ab919"),
    (_K15, bytes.fromhex("cafebabefacedbaddecaf888"), _P15,
     "522dc1f099567d07f47f37a32a84427d643a8cdcbfe5c0c97598a2bd2555d1aa"
     "8cb08e48590dbb3da7b08b1056828838c5f61e6393ba7a0abcc9f662898015ad"
     "b094dac5d93471bdec1a502270e3cc6c"),
], ids=["case13", "case14", "case15"])
def test_aes_gcm_equals_gcm_spec_test_cases(key, nonce, pt, want):
    assert g.aes_gcm_encrypt(key, nonce, pt).hex() == want
    assert g.aes_gcm_decrypt(key, nonce, bytes.fromhex(want)) == pt


@pytest.mark.parametrize("call,err", [
    (lambda: g.aes_gcm_encrypt(bytes(32), bytes(8), b"x"), ValueError),
    (lambda: g.aes_gcm_decrypt(bytes(32), bytes(16), bytes(32)), ValueError),
    (lambda: g.aes_gcm_decrypt(bytes(32), bytes(12), bytes(15)), g.InvalidTag),
    (lambda: g.aes_gcm_encrypt(bytes(16), bytes(12), b"x"), ValueError),
    (lambda: g.aes_gcm_encrypt(bytes(33), bytes(12), b"x"), ValueError),
], ids=["nonce-8", "nonce-16", "shorter-than-tag", "key-16", "key-33"])
def test_aes_gcm_rejects_malformed_inputs(call, err):
    with pytest.raises(err):
        call()


# ---- the CLI ---------------------------------------------------------------

def _options(main, cmd, monkeypatch, capsys):
    """The option strings of a subcommand's --help (both mains read sys.argv)."""
    monkeypatch.setattr(sys, "argv", ["tpu-mpc", cmd, "-h"])
    with pytest.raises(SystemExit) as exc:
        main()
    assert exc.value.code == 0
    words = capsys.readouterr().out
    for c in ",[]":
        words = words.replace(c, " ")
    return {w for w in words.split() if w.startswith("-")}


@pytest.mark.parametrize("cmd", ["keygen", "sign"])
def test_cli_flags_are_the_references_plus_device(cmd, monkeypatch, capsys):
    from tpu_mpc.runtime import cli as jcli

    mine = _options(cli.main, cmd, monkeypatch, capsys)
    theirs = _options(jcli.main, cmd, monkeypatch, capsys)
    assert mine == theirs | {"--device"}
    assert "-h" in mine and ("--paillier-bits" in mine) == (cmd == "keygen")
    with pytest.raises(SystemExit) as exc:                # a required flag missing
        cli.main([cmd])
    assert exc.value.code == 2
