"""GG18 relay server — the key-value "SM manager" with signup endpoints
(port of tpu_mpc/runtime/kv_server.py, the same endpoints).

Behavioral equivalent of the reference's examples/gg18_sm_manager.rs:12-99:
a write-once KV store plus keygen/sign signup counters.  Unlike the GG20
relay (relay_server.py, append-only room log + SSE), the GG18 hub is a
polled store: clients `set` under deterministic keys and `poll` with `get`
until a key appears (examples/common.rs:134-190).

Endpoints (all POST, JSON bodies):
  /get          {"key": k}              -> {"Ok": {"key": k, "value": v}} | {"Err": null}
  /set          {"key": k, "value": v}  -> {"Ok": null}
  /signupkeygen {}                      -> {"Ok": {"number": N, "uuid": U}}
  /signupsign   {}                      -> {"Ok": {"number": N, "uuid": U}}

Signup semantics (gg18_sm_manager.rs:46-79): a shared (number, uuid) cell per
kind; `number` increments until `parties` (keygen) / `threshold+1` (sign),
then a fresh uuid starts the next ceremony.  Party counts come from
params.json {"parties": "...", "threshold": "..."} like the reference
(gg18_sm_manager.rs:41-44).  Port 0 binds a free port (server_address
holds it; the __main__ entry prints it).
"""

from __future__ import annotations

import json
import threading
import time
import uuid as uuidlib
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer


class _Signup:
    def __init__(self, cap: int):
        self.cap = cap
        self.number = 0
        self.uuid = str(uuidlib.uuid4())

    def next(self) -> dict:
        if self.number >= self.cap:
            self.number = 0
            self.uuid = str(uuidlib.uuid4())
        self.number += 1
        return {"number": self.number, "uuid": self.uuid}


class KvHandler(BaseHTTPRequestHandler):
    store: dict = None        # set by serve()
    lock: threading.Lock = None
    signup_keygen: _Signup = None
    signup_sign: _Signup = None

    def log_message(self, fmt, *args):
        pass

    def _json(self, obj, code=200):
        body = json.dumps(obj).encode()
        self.send_response(code)
        self.send_header("Content-Type", "application/json")
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def do_POST(self):
        path = self.path.strip("/")
        n = int(self.headers.get("Content-Length", 0))
        raw = self.rfile.read(n) if n else b"{}"
        try:
            body = json.loads(raw) if raw.strip() else {}
        except json.JSONDecodeError:
            return self._json({"Err": "bad json"}, 400)
        with self.lock:
            if path == "get":
                key = body.get("key")
                if key in self.store:
                    return self._json({"Ok": {"key": key, "value": self.store[key]}})
                return self._json({"Err": None})
            if path == "set":
                # write-once: first writer wins (the reference's hashmap
                # insert just overwrites, but honest parties never collide)
                self.store.setdefault(body["key"], body["value"])
                return self._json({"Ok": None})
            if path == "signupkeygen":
                return self._json({"Ok": self.signup_keygen.next()})
            if path == "signupsign":
                return self._json({"Ok": self.signup_sign.next()})
        self._json({"Err": "not found"}, 404)


def serve(port: int = 8001, host: str = "127.0.0.1", parties: int = 3,
          threshold: int = 1) -> ThreadingHTTPServer:
    """Start the GG18 KV relay (returns server; .shutdown() to stop)."""
    cls = type("KvHandlerBound", (KvHandler,), {})
    cls.store = {}
    cls.lock = threading.Lock()
    cls.signup_keygen = _Signup(parties)
    cls.signup_sign = _Signup(threshold + 1)
    httpd = ThreadingHTTPServer((host, port), cls)
    threading.Thread(target=httpd.serve_forever, daemon=True).start()
    return httpd


if __name__ == "__main__":
    import argparse

    ap = argparse.ArgumentParser(description="tpu-mpc GG18 KV relay (sm_manager)")
    ap.add_argument("--port", type=int, default=8001)
    ap.add_argument("--host", default="127.0.0.1")
    ap.add_argument("--params", default="params.json",
                    help='{"parties": "3", "threshold": "1"}')
    args = ap.parse_args()
    try:
        with open(args.params) as f:
            p = json.load(f)
        parties, threshold = int(p["parties"]), int(p["threshold"])
    except FileNotFoundError:
        parties, threshold = 3, 1
    server = serve(args.port, args.host, parties, threshold)
    print(f"gg18 relay on {args.host}:{server.server_address[1]} "
          f"(parties={parties}, threshold={threshold})", flush=True)
    try:
        while True:
            time.sleep(3600)
    except KeyboardInterrupt:
        server.shutdown()
