"""HTTP relay server — the GG20 "SM manager" (examples/gg20_sm_manager.rs;
port of tpu_mpc/runtime/relay_server.py, the same endpoints).

Stateless hub semantics: per-room append-only message log, unique index
issuance, and subscription with Last-Event-ID style resume.  Broadcast =
append to the log; P2P = receiver-side filtering (the reference's model,
gg20_sm_client.rs:36-41).  No authentication or transport encryption, like
the reference (README.md:64-66 warns the same).

Port 0 binds a free port: serve() returns the server, whose
server_address holds the port chosen, and `python -m
tpu_mpc_torch.runtime.relay_server --port 0` prints it.

Endpoints:
  POST /rooms/<room>/issue_unique_idx          -> {"unique_idx": N}
  POST /rooms/<room>/broadcast   (body: text)  -> {"id": K}
  GET  /rooms/<room>/messages?since=K          -> {"messages": [...], "next": K'}
  GET  /rooms/<room>/subscribe?last_event_id=K -> SSE stream (resume supported)
"""

from __future__ import annotations

import json
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from urllib.parse import parse_qs, urlparse


class _Room:
    def __init__(self):
        self.lock = threading.Condition()
        self.log: list[str] = []
        self.next_idx = 0

    def issue_idx(self) -> int:
        with self.lock:
            self.next_idx += 1
            return self.next_idx

    def append(self, msg: str) -> int:
        with self.lock:
            self.log.append(msg)
            self.lock.notify_all()
            return len(self.log)

    def since(self, k: int) -> tuple[list[str], int]:
        with self.lock:
            return self.log[k:], len(self.log)

    def wait_since(self, k: int, timeout: float = 25.0) -> tuple[list[str], int]:
        deadline = time.time() + timeout
        with self.lock:
            while len(self.log) <= k and time.time() < deadline:
                self.lock.wait(deadline - time.time())
            return self.log[k:], len(self.log)


class _Db:
    def __init__(self):
        self.lock = threading.Lock()
        self.rooms: dict[str, _Room] = {}

    def room(self, name: str) -> _Room:
        with self.lock:
            return self.rooms.setdefault(name, _Room())


class RelayHandler(BaseHTTPRequestHandler):
    db: _Db = None  # set by serve()

    def log_message(self, fmt, *args):  # silence access log
        pass

    def _json(self, obj, code=200):
        body = json.dumps(obj).encode()
        self.send_response(code)
        self.send_header("Content-Type", "application/json")
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def do_POST(self):
        parts = urlparse(self.path)
        seg = parts.path.strip("/").split("/")
        if len(seg) == 3 and seg[0] == "rooms":
            room = self.db.room(seg[1])
            if seg[2] == "issue_unique_idx":
                return self._json({"unique_idx": room.issue_idx()})
            if seg[2] == "broadcast":
                n = int(self.headers.get("Content-Length", 0))
                msg = self.rfile.read(n).decode()
                return self._json({"id": room.append(msg)})
        self._json({"error": "not found"}, 404)

    def do_GET(self):
        parts = urlparse(self.path)
        seg = parts.path.strip("/").split("/")
        qs = parse_qs(parts.query)
        if len(seg) == 3 and seg[0] == "rooms":
            room = self.db.room(seg[1])
            if seg[2] == "messages":
                since = int(qs.get("since", ["0"])[0])
                msgs, nxt = room.wait_since(since, timeout=20.0)
                return self._json({"messages": msgs, "next": nxt})
            if seg[2] == "subscribe":
                last = int(qs.get("last_event_id", ["0"])[0])
                self.send_response(200)
                self.send_header("Content-Type", "text/event-stream")
                self.send_header("Cache-Control", "no-cache")
                self.end_headers()
                k = last
                try:
                    while True:
                        msgs, nxt = room.wait_since(k, timeout=15.0)
                        for i, m in enumerate(msgs):
                            ev = f"id: {k + i + 1}\ndata: {m}\n\n"
                            self.wfile.write(ev.encode())
                        self.wfile.flush()
                        k = nxt
                except (BrokenPipeError, ConnectionResetError):
                    return
        self._json({"error": "not found"}, 404)


def serve(port: int = 8000, host: str = "127.0.0.1") -> ThreadingHTTPServer:
    """Start the relay (returns the server; call .shutdown() to stop)."""
    # a handler class per server: two relays in one process keep their rooms apart
    cls = type("RelayHandlerBound", (RelayHandler,), {"db": _Db()})
    httpd = ThreadingHTTPServer((host, port), cls)
    thread = threading.Thread(target=httpd.serve_forever, daemon=True)
    thread.start()
    return httpd


if __name__ == "__main__":
    import argparse

    ap = argparse.ArgumentParser(description="tpu-mpc relay server (sm_manager)")
    ap.add_argument("--port", type=int, default=8000)
    ap.add_argument("--host", default="127.0.0.1")
    args = ap.parse_args()
    server = serve(args.port, args.host)
    print(f"relay listening on {args.host}:{server.server_address[1]}", flush=True)
    try:
        while True:
            time.sleep(3600)
    except KeyboardInterrupt:
        server.shutdown()
