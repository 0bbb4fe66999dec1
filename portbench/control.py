"""The control of the comparison that decides `correct`: the reference put
in the program's place, with one guarantee of the configuration broken.

    python3 portbench/control.py --workload <cell> --seed <n> [--passes 2]

The control signs every session of a pass with the plain ECDSA of
reference/secp256k1.py under the key set's whole secret (the sum of the
u_i), each nonce drawn from the seed, and leaves out the low-s form, the
step a faster signer would be tempted to drop: about half of its
signatures then have s above N / 2.  It runs the cell's own traffic at the
cell's size through the harness's window and judge, and prints the judge's
readings; `correct` has to come out false.  It needs no card and imports
nothing of the program.
"""

from __future__ import annotations

import argparse
import itertools
import json
import os
import random
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from portbench import harness  # noqa: E402
from portbench.reference import judge, secp256k1 as ec  # noqa: E402


class Program:
    """The reference signer, in the interface of portbench/programs/."""

    GATE = None

    def __init__(self, config: dict, material: dict, sessions: int, device, seed: int):
        self.d = judge.secret_key(material)
        self.rnd = random.Random(f"portbench control nonces {seed}")

    def public_key(self):
        return ec.g_comb().mul(self.d)

    def warm(self, seed: int, m: list) -> None:
        pass

    def sign_pass(self, m: list, stage) -> dict:
        with stage("online"):
            sigs = [ec.sign(self.d, z % ec.N, self.rnd.randrange(1, ec.N), low_s=False)
                    for z in m]
        return {"r": [v[0] for v in sigs], "s": [v[1] for v in sigs],
                "recid": [v[2] for v in sigs], "ok": [True] * len(m),
                "sig_valid": [True] * len(m)}

    def close(self) -> None:
        pass


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--passes", type=int, default=2)
    args = ap.parse_args(argv)
    spec = harness.cell_spec(args.workload)
    # a clock that counts passes: exactly `passes` passes in the window
    result, checks = harness.run_cell(
        spec, args.seed, args.passes - 0.5, trace=0, device="cpu",
        clock=itertools.count().__next__, program_cls=Program)
    print(json.dumps({"workload": args.workload, "seed": args.seed,
                      "passes": args.passes, "correct": result["correct"],
                      "checks": checks}))
    return 0


if __name__ == "__main__":
    t = time.perf_counter()
    rc = main()
    print(f"control: {time.perf_counter() - t:.1f} s", file=sys.stderr)
    sys.exit(rc)
