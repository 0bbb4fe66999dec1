"""The benchmark's own tests: CPU runs by default; the `cuda` marker tags
the tests that need an NVIDIA card and skip without one.

    python -m pytest portbench/tests -q -p no:cacheprovider
"""

import copy
import json
import os

import pytest

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(os.path.dirname(HERE))
TINY_BITS = 768          # the narrowest Paillier width the protocol is sound at


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs a CUDA device (runs the hand-written kernels)")
    import torch

    # one intra-op thread: the port's plain versions are many small torch
    # ops, and concurrent test processes' thread pools would spin against
    # each other
    torch.set_num_threads(1)


@pytest.fixture(scope="session")
def tiny_material():
    """A 2-of-3 key set at 768 bits, made by the benchmark's generator."""
    from portbench.keys import make_keys

    return make_keys.make_material(1, 3, TINY_BITS, 0x7E57)


@pytest.fixture
def tiny_spec(tiny_material, tmp_path):
    """A 2-of-3 cell at a size a CPU test holds, found by name as a later
    PR's cell would be: a checkout whose BENCHMARK.json adds the cell
    gg20-2of3-tiny.S4 (the 2-of-3 configuration's file, a traffic mix of
    4 sessions a pass), run on the 768-bit key set."""
    import shutil

    from portbench import harness

    shutil.copytree(os.path.join(ROOT, "portbench"), tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    (tmp_path / "portbench" / "traffic" / "S4.json").write_text(json.dumps({"sessions": 4}))
    b = bench_json()
    b["configs"].append({"name": "gg20-2of3-tiny", "source": "test",
                         "file": "portbench/configs/gg20-2of3-tables.json",
                         "reduced": [], "why": "test"})
    b["workloads"].append({"name": "gg20-2of3-tiny.S4", "config": "gg20-2of3-tiny",
                           "traffic": "S4", "chips": 1, "why": "test"})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(b))
    spec = harness.cell_spec("gg20-2of3-tiny.S4", str(tmp_path))
    return dict(spec, material=copy.deepcopy(tiny_material))


def bench_json():
    with open(os.path.join(ROOT, "BENCHMARK.json")) as fh:
        return json.load(fh)
