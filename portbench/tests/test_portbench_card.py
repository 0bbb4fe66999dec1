"""On the card: one short traced run of each cell through the benchmark's
command, correct, with every per-layer metric read and each roofline
share in (0, 100].

    python -m pytest portbench/tests -m cuda -q -p no:cacheprovider
"""

import json
import os
import subprocess
import sys

import pytest

from .conftest import ROOT, bench_json


@pytest.mark.cuda
@pytest.mark.parametrize("cell", [w["name"] for w in bench_json()["workloads"]])
def test_a_short_traced_run_is_correct(cell):
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels run only on the card")
    out = subprocess.run(
        [sys.executable, os.path.join("portbench", "run.py"), "--workload", cell,
         "--seed", "4294967311", "--seconds", "1", "--trace", "1"],
        cwd=ROOT, capture_output=True, text=True, timeout=360)
    assert out.returncode == 0, out.stderr[-4000:]
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert res["correct"] and res["failed"] == 0, res["checks"]
    want = {m["name"] for m in bench_json()["per_layer"]}
    assert set(res["metrics"]) == want
    for k in ("k1_roofline", "k2_roofline"):
        assert 0 < res["metrics"][k]["value"] <= 100
    assert 0 < res["device"]["busy_s"] <= res["device"]["window_s"]
