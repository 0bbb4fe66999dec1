#!/usr/bin/env python3
"""Time K1-K5 of one or more checkouts of this repository on one card, in turns.

    python3 kernel_ab.py [--checks k1,k2,ec] TREE [TREE ...]   (e.g. old new new old)

Each TREE is the root of a checkout (its chip_smoke.py and tpu_mpc_torch/).
The trees run one after another, each in a process of its own, in the order
given.  The process builds the tree's kernels (printing what ptxas reports)
and runs the tree's own chip_smoke.check_k1, check_k2 and check_ec (all three
unless --checks names fewer): they hold the kernels exactly against the
tree's plain versions at the slice's shapes and time them with CUDA events.
It prints one JSON line with the kernel ms of every shape those checks time
(the wrapper call, int32/int64 copies included).  With the ec checks it also
times K5's C entry alone (k5_affine on int32 buffers, 50 launches back to
back, no wrapper) in every tree at the lane counts of this checkout's
chip_smoke.K5_TIMED, after holding its output against the tree's plain
version.  Only K5 is timed so: its kernel is short enough that the
wrapper's copies and the host's launch time weigh on the wrapper's time,
which spread by 2x within one call.
Each check draws its inputs from a fresh random.Random(SEED), so trees whose
checks draw alike see the same numbers.
Needs one CUDA card; imports nothing of jax or of tpu_mpc.
"""

from __future__ import annotations

import json
import os
import random
import re
import subprocess
import sys
import time

SEED = 20261017
# the checks' log lines of a timed shape: "<shape>: exact...; kernel <ms> ms"
_TIMED = re.compile(r"(K[1-5][^:]*): exact.*?; kernel ([0-9.]+) ms")
CHECKS = ("k1", "k2", "ec")


def k5_alone(dev, lanes) -> dict:
    """ms per launch of K5's C entry alone at each lane count of `lanes`, on
    real points of the tree's own chip_smoke._rand_points."""
    import torch

    import chip_smoke
    from tpu_mpc_torch import kernels
    from tpu_mpc_torch.ec import pallas_ec as pe

    pts, _ = chip_smoke._rand_points(dev, random.Random(SEED), max(lanes))
    times = {}
    for n in lanes:
        p32 = pts[:n].to(torch.int32).contiguous()
        o32 = torch.empty((n, 2, 16), dtype=torch.int32, device=dev)
        launch = lambda: kernels.check(kernels.lib("ec").k5_affine(
            p32.data_ptr(), n, o32.data_ptr(), kernels.stream_handle(dev)), "K5")
        launch()
        chip_smoke.require(torch.equal(o32.long(), pe.affine_plain(pts[:n])),
                           f"K5 alone lanes={n}: kernel != plain")
        times[f"K5 lanes={n} alone"] = round(chip_smoke._events_ms(launch, 50), 5)
    return times


def worker(tree: str, checks, k5_lanes) -> int:
    import torch

    sys.path.insert(0, os.path.abspath(tree))
    import chip_smoke
    from tpu_mpc_torch import kernels

    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    t0 = time.perf_counter()
    built = kernels.build_all()
    res = {"tree": tree, "build_s": round(time.perf_counter() - t0, 1), "ptxas": [],
           "times": {}}
    for name in ("rns", "rns_fixed", "ec"):
        for line in built.get(name, (0, ""))[1].splitlines():
            if "registers" in line or "spill" in line or "Compiling entry" in line:
                res["ptxas"].append(f"{name}: {line.strip()}")
    lines = []
    chip_smoke.log = lines.append
    rc = 0
    try:
        for c in checks:
            getattr(chip_smoke, f"check_{c}")(dev, random.Random(SEED))
        if "ec" in checks:
            res["times"].update(k5_alone(dev, k5_lanes))
    except Exception as exc:   # a failed check: report it with what was timed
        res["error"] = f"{type(exc).__name__}: {exc}"
        rc = 1
    for line in lines:
        m = _TIMED.match(line)
        if m:
            res["times"][m.group(1)] = float(m.group(2))
    print(json.dumps(res), flush=True)
    return rc


def main() -> int:
    args = sys.argv[1:]
    checks = CHECKS
    if args[:1] == ["--checks"]:
        checks = tuple(args[1].split(","))
        args = args[2:]
    if args[:1] == ["--worker"]:
        return worker(args[1], checks, tuple(map(int, args[3].split(","))))
    if not args or not set(checks) <= set(CHECKS):
        print(__doc__, file=sys.stderr)
        return 2
    import torch

    from chip_smoke import K5_TIMED

    if not torch.cuda.is_available():
        print("kernel_ab: no CUDA device", file=sys.stderr)
        return 1
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True)
    print(f"card: {smi.stdout.strip()}", flush=True)
    rc = 0
    for tree in args:
        rc = max(rc, subprocess.run([sys.executable, os.path.abspath(__file__), "--checks",
                                     ",".join(checks), "--worker", tree,
                                     "--k5-lanes", ",".join(map(str, K5_TIMED))]).returncode)
    return rc


if __name__ == "__main__":
    sys.exit(main())
