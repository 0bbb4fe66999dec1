"""One run of one cell of the port's benchmark (BENCHMARK.json).

Everything that belongs to one configuration, traffic mix or per-layer
metric is a file of its own, found by its name:

    BENCHMARK.json                the cells; each configuration's file
    portbench/configs/<c>.json    a configuration: the deployment, its key
                                  set, the program's mode, its guarantees
    portbench/keys/<c>.json       its key set (keys/make_keys.py)
    portbench/traffic/<t>.json    a traffic mix: sessions a pass
    portbench/programs/<p>.py     the program's entry points for a protocol
    portbench/metrics/<m>.py      a per-layer metric: read(rec) -> value or None

A run: set-up (the mode's environment, the kernels' build, the key set
loaded and tiled, one warm-up pass), then the window: a closed loop of one
caller, passes back to back until `seconds` have elapsed, each pass
signing S sessions with fresh message hashes drawn from the seed; then the
judge (reference/judge.py) holds every session the window signed against
the reference.  With trace 0 the result carries the end-to-end metrics,
with trace 1 the per-layer ones, read from what the traced window
recorded (instrument.py).
"""

from __future__ import annotations

import contextlib
import importlib
import importlib.util
import json
import os
import random
import sys
import time

from . import instrument
from .reference import judge

BENCH_DIR = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(BENCH_DIR)
WARM_SEED = 0x5EED
# top-level modules that no run may load: JAX and the JAX package
FORBIDDEN = ("jax", "jaxlib", "flax", "tpu_mpc")
GIB = 1 << 30


def log(msg: str) -> None:
    print(f"portbench: {msg}", file=sys.stderr, flush=True)


def _load(path: str) -> dict:
    with open(path) as fh:
        return json.load(fh)


def names(folder: str, suffix: str) -> list:
    """The names of the files in `folder` that end in `suffix`."""
    return sorted(f[:-len(suffix)] for f in os.listdir(folder)
                  if f.endswith(suffix) and not f.startswith("_"))


def configs(root: str = ROOT) -> list:
    return names(os.path.join(root, "portbench", "configs"), ".json")


def traffics(root: str = ROOT) -> list:
    return names(os.path.join(root, "portbench", "traffic"), ".json")


def metric_readers(root: str = ROOT) -> list:
    return names(os.path.join(root, "portbench", "metrics"), ".py")


def reader(name: str, root: str = ROOT):
    """The module portbench/metrics/<name>.py (loaded by path: a name may
    hold dots)."""
    path = os.path.join(root, "portbench", "metrics", f"{name}.py")
    spec = importlib.util.spec_from_file_location(f"portbench_metric_{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def cell_spec(workload: str, root: str = ROOT) -> dict:
    """Everything a run of `workload` needs, found by name from
    BENCHMARK.json: its configuration, traffic, key material, and the
    metrics it reports (every cell reports every metric; a per-layer
    reader that finds nothing to read leaves its metric out)."""
    bench = _load(os.path.join(root, "BENCHMARK.json"))
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise SystemExit(f"portbench: no workload {workload!r} in BENCHMARK.json "
                         f"(have {sorted(cells)})")
    cell = cells[workload]
    entry = {c["name"]: c for c in bench["configs"]}[cell["config"]]
    config = _load(os.path.join(root, entry["file"]))
    per_layer = bench["per_layer"]
    for kind, want, have in (("traffic mix", [cell["traffic"]], traffics(root)),
                             ("metric reader", [m["name"] for m in per_layer],
                              metric_readers(root))):
        if set(want) - set(have):
            raise SystemExit(f"portbench: {workload} needs the {kind} "
                             f"{sorted(set(want) - set(have))}; there are {have}")
    return {
        "name": workload, "chips": cell["chips"], "config": config,
        "traffic": _load(os.path.join(root, "portbench", "traffic", f"{cell['traffic']}.json")),
        "material": _load(os.path.join(root, config["keys"])),
        "end_to_end": bench["end_to_end"],
        "per_layer": [dict(m, read=reader(m["name"], root).read) for m in per_layer],
    }


class Messages:
    """The sessions' message hashes: 256-bit, distinct over the run, drawn
    from the seed in order."""

    def __init__(self, seed):
        self.rnd = random.Random(f"portbench messages {seed}")
        self.seen = set()

    def draw(self, S: int) -> list:
        out = []
        while len(out) < S:
            m = self.rnd.getrandbits(256)
            if m not in self.seen:
                self.seen.add(m)
                out.append(m)
        return out


def run_window(do_pass, seconds: float, clock=time.perf_counter) -> tuple:
    """A closed loop: do_pass(i) back to back, the next one started only
    while fewer than `seconds` have elapsed since the first one started;
    no pass is cut.  -> (outputs, start, end of the last pass)."""
    outs = []
    t0 = clock()
    while True:
        outs.append(do_pass(len(outs)))
        t1 = clock()
        if t1 - t0 >= seconds:
            return outs, t0, t1


def forbidden_modules() -> list:
    """The forbidden top-level modules loaded in this process (compared
    by the whole top-level name: tpu_mpc_torch is not tpu_mpc)."""
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def card_info() -> dict:
    """The card's name and power limit, read by nvidia-smi."""
    import subprocess

    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30).stdout.strip().splitlines()
    except (OSError, subprocess.SubprocessError):
        out = []
    return {"nvidia_smi": out[0] if out else "not read"}


def _program_cls(config: dict):
    return importlib.import_module(f"portbench.programs.{config['program']}").Program


def run_cell(spec: dict, seed: int, seconds: float, trace: int, *, device: str = "cuda",
             t0: float | None = None, clock=time.perf_counter, program_cls=None) -> tuple:
    """One run.  t0: the process's start on time.perf_counter (set-up is
    counted from it); clock: the window's clock.  -> (result line dict,
    {check: value})."""
    import torch

    t0 = time.perf_counter() if t0 is None else t0
    cuda = device == "cuda"
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    config, traffic, material = spec["config"], spec["traffic"], spec["material"]
    S = int(traffic["sessions"])
    os.environ.update(config["env"])
    steps, built = {}, {}
    t = time.perf_counter()
    if cuda:
        from tpu_mpc_torch import kernels

        # the first run of a checkout builds the kernels (nvcc): counted in
        # setup_s, and named in the result's "built" so the run stands apart
        built = kernels.build_all()
        steps["build"] = time.perf_counter() - t
        if built:
            log(f"built {sorted(built)} in {steps['build']:.1f} s")
    t = time.perf_counter()
    prog = (program_cls or _program_cls(config))(config, material, S, device, seed)
    sync()
    steps["key"] = time.perf_counter() - t
    t = time.perf_counter()
    prog.warm(WARM_SEED, Messages("warm-up").draw(S))
    sync()
    steps["warm"] = time.perf_counter() - t
    log("set-up (s) " + json.dumps({k: round(v, 3) for k, v in steps.items()}))

    msgs = Messages(seed)
    secs = {"offline": [], "online": []}     # host seconds of each stage, a pass
    host_ns = []                             # (label, start, end) in time.time_ns()

    @contextlib.contextmanager
    def stage(name):
        ts, a_ns = time.perf_counter(), time.time_ns()
        yield
        sync()
        secs[name].append(time.perf_counter() - ts)
        host_ns.append((name, a_ns, time.time_ns()))

    pass_cpu = []                            # this process's CPU seconds, a pass

    def do_pass(i):
        m = msgs.draw(S)
        c = time.process_time()
        out = prog.sign_pass(m, stage)
        pass_cpu.append(time.process_time() - c)
        out["m"] = m
        log(f"pass {i}: " + ", ".join(f"{k} {v[-1]:.3f} s" for k, v in secs.items() if v)
            + f", cpu {pass_cpu[-1]:.3f} s")
        return out

    # the program's launch counters, where the program was loaded
    kernels = sys.modules.get("tpu_mpc_torch.kernels")
    gate = prog.GATE
    with contextlib.ExitStack() as st:
        inst = prof = timed = None
        if trace and cuda:
            inst = st.enter_context(instrument.Instrument())
            prof = st.enter_context(instrument.Profile())
        if trace and gate:
            timed = st.enter_context(instrument.Timed(importlib.import_module(gate[0]),
                                                      gate[1], "gate", host_ns))
        if kernels:
            kernels.reset_launches()
        t_setup = time.perf_counter() - t0
        win_ns, cpu = [time.time_ns()], time.process_time()
        passes, w0, w1 = run_window(do_pass, seconds, clock)
        sync()
        win_ns.append(time.time_ns())
        # this process's CPU seconds (all its threads) in the window and in
        # each pass: where they follow the wall, the host ran the process's
        # own work slower or faster, and nothing waited
        host = {"cpu_s": time.process_time() - cpu, "threads": torch.get_num_threads(),
                "pass_cpu_s": [round(c, 4) for c in pass_cpu]}
        launches = dict(kernels.LAUNCHES) if kernels else {}
    window_s = w1 - w0
    n = len(passes)
    peak = torch.cuda.max_memory_allocated() if cuda else 0
    program_y = prog.public_key()
    prog.close()
    prog = None
    if cuda:
        torch.cuda.empty_cache()

    attempted = n * S
    failed = sum(not ok for p in passes for ok in p["ok"][:S]) + sum(
        max(0, S - len(p["ok"])) for p in passes)
    t = time.perf_counter()
    checks = judge.judge(material, program_y, passes, S)
    log(f"judge: {attempted} sessions in {time.perf_counter() - t:.1f} s")

    dev = {"platform": "gpu" if cuda else "cpu",
           "kind": torch.cuda.get_device_name(0) if cuda else "cpu",
           "count": 1, "memory_peak_bytes": int(peak)}
    result = {"correct": judge.passed(checks), "attempted": attempted, "failed": failed}
    if not trace:
        values = {"sig_per_s": attempted / window_s, "peak_mem_gib": peak / GIB,
                  "setup_s": t_setup}
        metrics = {m["name"]: {"value": values[m["name"]], "unit": m["unit"]}
                   for m in spec["end_to_end"]}
    else:
        rec = {"sessions": S, "passes": n, "window_s": window_s, "spans": secs,
               "gate_s": timed.secs if timed else None, "launches": launches,
               "kernels": inst.timed() if inst else [], "busy_s": None}
        breakdown = _read_trace(rec, prof, host_ns, *win_ns) if inst else None
        metrics = {}
        for m in spec["per_layer"]:
            v = m["read"](rec)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
        if rec["busy_s"] is not None:
            dev.update(busy_s=rec["busy_s"], window_s=rec["window_s"],
                       busy_source=rec["busy_source"])
        if breakdown:
            result["breakdown"] = breakdown
    if cuda:
        dev.update(card_info())
    log(f"window {window_s:.3f} s, {n} passes; host " + json.dumps(host))
    result.update(metrics=metrics, device=dev, host=host, setup_steps=steps, built=sorted(built),
                  passes=n, window_s=window_s,
                  pass_s=[round(sum(v), 4) for v in zip(*(x for x in secs.values() if x))])
    result["checks"] = {k: {"value": v, "limit": judge.LIMITS[k]} for k, v in checks.items()}
    return result, checks


def _read_trace(rec: dict, prof, host_ns: list, lo: int, hi: int) -> dict:
    """Busy time of the window [lo, hi] (time.time_ns()) and the breakdown:
    the launch shapes that took most device time, and the longest idle
    gaps, each labelled by the benchmark's span in progress.  Busy time is
    the union of the profiler's device activity; where it shows none, the
    sum of the kernel launches' CUDA-event spans."""
    by_shape = {}
    for k, s, ms in rec["kernels"]:
        lb = instrument.shape_label(k, s)
        by_shape[lb] = by_shape.get(lb, 0.0) + ms / 1e3
    ops = [[k, v] for k, v in sorted(by_shape.items(), key=lambda kv: -kv[1])[:10]]
    busy = instrument.clip(instrument.union(prof.device_intervals()), lo, hi)
    rec["window_s"] = (hi - lo) / 1e9
    if busy:
        rec["busy_s"] = sum(b - a for a, b in busy) / 1e9
        rec["busy_source"] = "profiler"
        idle = sorted(instrument.gaps(busy, lo, hi), key=lambda g: g[0] - g[1])[:10]
        return {"device_ops": ops,
                "idle_gaps": [[instrument.label_at((a + b) // 2, host_ns), (b - a) / 1e9]
                              for a, b in idle]}
    rec["busy_s"] = sum(ms for _, _, ms in rec["kernels"]) / 1e3
    rec["busy_source"] = "cuda_events"
    log("the profiler showed no device activity: busy time from the kernels' CUDA events")
    return {"device_ops": ops, "idle_gaps": []}
