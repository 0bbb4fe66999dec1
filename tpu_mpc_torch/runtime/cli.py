"""CLI entry points — gg20_keygen / gg20_signing (port of tpu_mpc/runtime/cli.py;
examples/gg20_keygen.rs:29-58, examples/gg20_signing.rs:34-90).

  python -m tpu_mpc_torch.runtime.cli keygen -t 1 -n 3 -i 1 --output local1.json
  python -m tpu_mpc_torch.runtime.cli sign   -p 1,2 -d hello --local-share local1.json

The flags are the JAX package's, plus `--device` (default "cuda"): without
a card the default fails with resolve_device's message, and `--device cpu`
runs the kernels' plain versions.  Before it exits, each command writes one
line to stderr, `device: {"device": ..., "launches": {"K1": ..., ...}}`,
the kernel launches of its run.

LocalKey is serialized to JSON (the reference's serde checkpoint,
gg20_keygen.rs:52-55) in the JAX package's format: a key file written by
either CLI loads in the other.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import sys

from .. import kernels
from ..device import resolve_device
from .gg20_keygen_sm import Gg20Keygen
from .gg20_sign_sm import Gg20OfflineStage, partial_sig_local, scrub_offline, sign_manual
from .relay_client import SmClient, run_protocol
from .wire import Msg, decode_value, encode_value


def save_local_key(path: str, key: dict) -> None:
    with open(path, "w") as f:
        json.dump(encode_value(key), f)


def load_local_key(path: str) -> dict:
    with open(path) as f:
        return decode_value(json.load(f))


def report_device(device) -> None:
    """The device line: where this process ran and its kernel launches."""
    print("device: " + json.dumps({"device": str(device), "launches": dict(kernels.LAUNCHES)}),
          file=sys.stderr, flush=True)


def cmd_keygen(args, device) -> None:
    sm = Gg20Keygen(args.index, args.threshold, args.number_of_parties,
                    paillier_bits=args.paillier_bits, device=device)
    out = run_protocol(sm, args.address, args.room)
    save_local_key(args.output, out)
    print(f"party {args.index}: keygen complete -> {args.output}", flush=True)


def cmd_sign(args, device) -> None:
    key = load_local_key(args.local_share)
    parties = [int(p) for p in args.parties.split(",")]
    s_l = [p - 1 for p in parties]  # 0-based global indices
    local_i = parties.index(key["i"]) + 1
    digest = int.from_bytes(hashlib.sha256(args.data_to_sign.encode()).digest(), "big")

    sm = Gg20OfflineStage(local_i, s_l, key, device=device)
    off = run_protocol(sm, args.address, args.room + "-offline")

    # one-round online: broadcast partial sig, collect others
    client = SmClient(args.address, args.room + "-online")
    my_partial = partial_sig_local(off, digest)
    client.broadcast(Msg(local_i, None, {"round": 1, "s_i": my_partial}).to_json())
    partials = {}
    while len(partials) < len(parties) - 1:
        for raw in client.poll():
            m = Msg.from_json(raw)
            if m.sender != local_i:
                partials[m.sender] = m.body["s_i"]
    sig = sign_manual(off, digest, list(partials.values()))
    print(json.dumps({"r": format(sig["r"], "x"), "s": format(sig["s"], "x"),
                      "recid": sig["recid"], "valid": sig["valid"]}), flush=True)
    if not sig["valid"]:
        report_device(device)
        sys.exit(1)
    scrub_offline(off)  # signature done: drop the one-time secrets


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(prog="tpu-mpc", description="GG20 threshold ECDSA CLI")
    sub = ap.add_subparsers(dest="cmd", required=True)

    kg = sub.add_parser("keygen")
    kg.add_argument("-a", "--address", default="http://127.0.0.1:8000")
    kg.add_argument("-r", "--room", default="keygen")
    kg.add_argument("-i", "--index", type=int, required=True)
    kg.add_argument("-t", "--threshold", type=int, required=True)
    kg.add_argument("-n", "--number-of-parties", type=int, required=True)
    kg.add_argument("-o", "--output", required=True)
    kg.add_argument("--paillier-bits", type=int, default=2048)
    kg.set_defaults(func=cmd_keygen)

    sg = sub.add_parser("sign")
    sg.add_argument("-a", "--address", default="http://127.0.0.1:8000")
    sg.add_argument("-r", "--room", default="sign")
    sg.add_argument("-p", "--parties", required=True, help="e.g. 1,2")
    sg.add_argument("-d", "--data-to-sign", required=True)
    sg.add_argument("-l", "--local-share", required=True)
    sg.set_defaults(func=cmd_sign)

    for p in (kg, sg):
        p.add_argument("--device", default="cuda", help='"cuda" (default) or "cpu"')

    args = ap.parse_args(argv)
    try:
        device = resolve_device(args.device)
    except RuntimeError as e:
        sys.exit(f"tpu-mpc: {e}")
    args.func(args, device)
    report_device(device)


if __name__ == "__main__":
    main()
