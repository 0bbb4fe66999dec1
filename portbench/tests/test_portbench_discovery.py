"""The harness finds configurations, traffic mixes and per-layer metrics by
name, from files of their own: a file added to a folder, and an entry added
to BENCHMARK.json, are picked up with no edit of the code.  Also the
committed BENCHMARK.json against the benchmark's contract."""

import json
import os
import re
import shutil

import pytest

from portbench import harness

from .conftest import ROOT, bench_json

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


@pytest.fixture
def copy_root(tmp_path):
    """A copy of the benchmark's files in a new checkout."""
    shutil.copytree(harness.BENCH_DIR, tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), tmp_path)
    return tmp_path


def test_folders_are_listed(copy_root):
    root = str(copy_root)
    b = bench_json()
    assert set(harness.configs(root)) >= {c["name"] for c in b["configs"]}
    assert set(harness.traffics(root)) >= {w["traffic"] for w in b["workloads"]}
    assert set(harness.metric_readers(root)) >= {m["name"] for m in b["per_layer"]}


def test_a_file_added_is_picked_up(copy_root):
    root = str(copy_root)
    pb = copy_root / "portbench"
    (pb / "traffic" / "S64.json").write_text(json.dumps({"sessions": 64}))
    (pb / "metrics" / "passes.seen.py").write_text("def read(rec):\n    return rec['passes']\n")
    cfg = json.loads((pb / "configs" / "gg20-2of3-tables.json").read_text())
    (pb / "configs" / "gg20-2of3-copy.json").write_text(json.dumps(dict(cfg, name="gg20-2of3-copy")))
    assert "S64" in harness.traffics(root) and "passes.seen" in harness.metric_readers(root)
    assert "gg20-2of3-copy" in harness.configs(root)
    b = json.loads((copy_root / "BENCHMARK.json").read_text())
    b["configs"].append(dict(b["configs"][0], name="gg20-2of3-copy",
                             file="portbench/configs/gg20-2of3-copy.json"))
    b["workloads"].append({"name": "gg20-2of3-copy.S64", "config": "gg20-2of3-copy",
                           "traffic": "S64", "chips": 1, "why": "added"})
    b["per_layer"].append({"name": "passes.seen", "unit": "passes", "better": "higher",
                           "source": "program_counter", "layer": "protocol rounds",
                           "moves": "sig_per_s"})
    (copy_root / "BENCHMARK.json").write_text(json.dumps(b))
    spec = harness.cell_spec("gg20-2of3-copy.S64", root)
    assert spec["traffic"]["sessions"] == 64 and spec["config"]["name"] == "gg20-2of3-copy"
    assert spec["material"]["n"] == 3
    read = {m["name"]: m["read"] for m in spec["per_layer"]}
    assert read["passes.seen"]({"passes": 3}) == 3
    # every cell reports every metric: the cells that were there pick it up
    other = harness.cell_spec(b["workloads"][0]["name"], root)
    assert "passes.seen" in {m["name"] for m in other["per_layer"]}
    assert [m["name"] for m in other["end_to_end"]] == [m["name"] for m in b["end_to_end"]]


def test_benchmark_json_keeps_the_contract():
    b = bench_json()
    assert set(b) == {"command", "paths", "run_seconds", "configs", "workloads",
                      "end_to_end", "per_layer"}
    assert b["paths"] == ["portbench"] and b["command"] == ["python3", "portbench/run.py"]
    assert 1 <= b["run_seconds"] <= 51
    used = {w["config"] for w in b["workloads"]}
    e2e = {m["name"] for m in b["end_to_end"]}
    assert "setup_s" in e2e
    names = [x["name"] for k in ("configs", "workloads", "end_to_end", "per_layer")
             for x in b[k]]
    assert len(names) == len(set(names)) and all(NAME.match(n) for n in names)
    for c in b["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"} and c["name"] in used
        assert c["file"].startswith("portbench/") and os.path.exists(os.path.join(ROOT, c["file"]))
        assert c["reduced"] == json.load(open(os.path.join(ROOT, c["file"])))["reduced"]
    for w in b["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"} and w["chips"] == 1
        assert len(w["why"]) <= 200 and w["traffic"] in harness.traffics()
    for m in b["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound", "source"}
        assert UNIT.match(m["unit"]) and m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in b["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source", "layer", "moves"}
        assert UNIT.match(m["unit"]) and m["moves"] in e2e
        assert m["name"] in harness.metric_readers()
    assert all(m["better"] in ("lower", "higher") for m in b["end_to_end"] + b["per_layer"])
