"""Faults planted in the program's timed path, to show that the comparison
that decides `correct` catches them.

    python3 portbench/faults.py --workload <cell> --seed <n>

Each fault wraps an entry point of tpu_mpc_torch/protocols/gg20/batch.py
for the life of a `with` block:

    stale     offline_stage returns its first state on every call (the
              warm-up's): the window signs with nonces already used
    half      sign_online returns the first half of the sessions only
    altered   sign_online's s of session 1 is replaced by N - s, still in
              range, so that only the reference can tell

(An exchange between chips left out has no place in a cell on one chip.)
The command runs the cell at its own size with each fault in turn, two
passes each, and prints the judge's readings;
portbench/tests/test_portbench_run.py does the same on the CPU at a tiny
size.
"""

from __future__ import annotations

import argparse
import contextlib
import itertools
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from portbench.reference import secp256k1 as ec  # noqa: E402

FAULTS = ("stale", "half", "altered")


@contextlib.contextmanager
def plant(name: str):
    import numpy as np

    from tpu_mpc_torch.protocols.gg20 import batch

    attr = "offline_stage" if name == "stale" else "sign_online"
    real = getattr(batch, attr)
    kept = []

    def stale(*a, **kw):
        if not kept:
            kept.append(real(*a, **kw))
        return kept[0]

    def half(off, m, **kw):
        res = real(off, m, **kw)
        h = len(res.r) // 2
        for f in ("r", "s", "recid", "ok", "sig_valid"):
            setattr(res, f, getattr(res, f)[:h])
        return res

    def altered(off, m, **kw):
        res = real(off, m, **kw)
        res.s = np.array(res.s, dtype=object)
        res.s[1] = ec.N - res.s[1]
        return res

    setattr(batch, attr, {"stale": stale, "half": half, "altered": altered}[name])
    try:
        yield
    finally:
        setattr(batch, attr, real)


def run_with(spec: dict, seed: int, name: str, device: str = "cuda", passes: int = 2):
    """One run of the cell with fault `name` planted: exactly `passes`
    passes (a window clock that counts them).  -> (result, checks)."""
    from portbench import harness

    with plant(name):
        return harness.run_cell(spec, seed, passes - 0.5, trace=0, device=device,
                                clock=itertools.count().__next__)


def main(argv=None) -> int:
    from portbench import harness

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    args = ap.parse_args(argv)
    spec = harness.cell_spec(args.workload)
    for name in FAULTS:
        result, checks = run_with(spec, args.seed, name)
        print(json.dumps({"workload": args.workload, "seed": args.seed, "fault": name,
                          "correct": result["correct"], "checks": checks}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
