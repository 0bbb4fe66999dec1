"""The port's benchmark: one run of one cell of BENCHMARK.json.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Run from the root of a checkout, on a machine with the card the cell asks
for.  Prints progress and the compared numbers on standard error, and one
JSON object as the last line of standard output (harness.py says what it
holds).  Exits 2 without the cards the cell asks for, 3 if JAX or the JAX
package was loaded, and prints no result then.
"""

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from portbench import harness  # noqa: E402


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description="one run of one cell of the port's benchmark")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    spec = harness.cell_spec(args.workload)

    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < spec["chips"]:
        harness.log(f"{args.workload} needs {spec['chips']} CUDA device(s); "
                    f"torch sees {torch.cuda.device_count() if torch.cuda.is_available() else 0}")
        return 2
    result, _ = harness.run_cell(spec, args.seed, args.seconds, args.trace, t0=T0)
    bad = harness.forbidden_modules()
    if bad:
        harness.log(f"loaded in this process: {bad}; the port's runs load no JAX")
        return 3
    for k, v in result["checks"].items():
        harness.log(f"check {k} = {v['value']} (limit {v['limit']})")
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
