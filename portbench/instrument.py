"""What a traced run records: CUDA events around each kernel launch, host
seconds of a patched function, and torch.profiler's device activity.

Instrument and Timed are the benchmark's own copies of the measurement
pieces that chip_smoke.py uses (its Instrument without the holds and
samples, and its _Timed), so that a change to that script cannot move the
yardstick.  Nothing here imports the program when the module is imported.
"""

from __future__ import annotations

import time
import warnings

# kernel -> (module under tpu_mpc_torch, function that launches one piece)
LAUNCHERS = {
    "K1": ("tpu_mpc_torch.core.pallas_rns", "exp_launch"),
    "K2": ("tpu_mpc_torch.core.pallas_rns", "fixed_launch"),
    "K3": ("tpu_mpc_torch.ec.pallas_ec", "ladder_launch"),
    "K4": ("tpu_mpc_torch.ec.pallas_ec", "comb_launch"),
    "K5": ("tpu_mpc_torch.ec.pallas_ec", "affine_launch"),
}


def launch_shape(name: str, a: tuple) -> dict:
    """The numbers of a launch's inputs that its work count needs: lanes,
    modulus bits, exponent bits or windows, moduli, key groups."""
    if name == "K1":            # x, e, rows, nbits
        return {"lanes": int(a[0].shape[0]), "mod_bits": int(a[3]),
                "exp_bits": 32 * int(a[1].shape[1]), "moduli": int(a[2].shape[0])}
    if name == "K2":            # e, grow, rows, tables, nwins, woffs, nbits
        return {"lanes": int(a[0].shape[0]), "mod_bits": int(a[6]),
                "windows": int(sum(a[4])), "moduli": int(a[2].shape[0]),
                "groups": int(a[3][0].shape[2]) if a[3] else 0}
    if name == "K3":
        return {"lanes": int(a[0].shape[0]), "ns": 2 * int(a[0].shape[1])}
    return {"lanes": int(a[0].shape[0])}


def shape_label(name: str, shape: dict) -> str:
    return name + " " + " ".join(f"{k}={v}" for k, v in shape.items())


class Instrument:
    """Patches the kernels' piece launchers for the life of a `with` block
    and times every call by CUDA events on the current stream around it,
    with no extra synchronisation.  The span covers the wrapper's own
    device work (padding, casts) and any host stall inside it, so it
    overstates the kernel's time a little."""

    def __init__(self):
        self.launches = []          # (kernel, shape dict, start event, end event)

    def _wrap(self, name, fn):
        import torch

        def run(*a, **kw):
            ev = (torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
            ev[0].record()
            out = fn(*a, **kw)
            ev[1].record()
            self.launches.append((name, launch_shape(name, a), *ev))
            return out
        return run

    def __enter__(self):
        import importlib

        self.saved = []
        for name, (modname, attr) in LAUNCHERS.items():
            mod = importlib.import_module(modname)
            fn = getattr(mod, attr)
            self.saved.append((mod, attr, fn))
            setattr(mod, attr, self._wrap(name, fn))
        return self

    def __exit__(self, *exc):
        for mod, attr, fn in self.saved:
            setattr(mod, attr, fn)
        return False

    def timed(self) -> list:
        """[(kernel, shape, ms)] of every launch; call after a sync."""
        return [(k, s, a.elapsed_time(b)) for k, s, a, b in self.launches]


class Timed:
    """Patches mod.attr for the life of a `with` block and adds up its
    calls' host seconds; `spans` gets each call's (label, start, end) in
    time.time_ns(), the profiler's clock."""

    def __init__(self, mod, attr: str, label: str, spans: list):
        self.mod, self.attr, self.fn = mod, attr, getattr(mod, attr)
        self.label, self.spans = label, spans
        self.secs, self.calls = 0.0, 0

    def __enter__(self):
        def run(*a, **kw):
            t, a_ns = time.perf_counter(), time.time_ns()
            try:
                return self.fn(*a, **kw)
            finally:
                self.secs += time.perf_counter() - t
                self.calls += 1
                self.spans.append((self.label, a_ns, time.time_ns()))
        setattr(self.mod, self.attr, run)
        return self

    def __exit__(self, *exc):
        setattr(self.mod, self.attr, self.fn)
        return False


class Profile:
    """torch.profiler over the window, CUDA activity only (recording every
    host-side op would slow the host-bound passes).  Its timestamps are
    time.time_ns()'s, so the benchmark's host spans line up with them."""

    def __enter__(self):
        import torch
        from torch.profiler import ProfilerActivity

        self.prof = torch.profiler.profile(activities=[ProfilerActivity.CUDA])
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            self.prof.__enter__()
        return self

    def __exit__(self, *exc):
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            self.prof.__exit__(*exc)
        return False

    def device_intervals(self) -> list:
        """[(start_ns, end_ns)] of every operation that ran on the device,
        sorted; a profiler range mirrored onto the device is none."""
        from torch.autograd import DeviceType

        out = []
        for ev in self.prof.profiler.kineto_results.events():
            if ev.device_type() != DeviceType.CUDA or ev.duration_ns() <= 0:
                continue
            if getattr(ev, "is_user_annotation", lambda: False)():
                continue
            out.append((ev.start_ns(), ev.start_ns() + ev.duration_ns()))
        out.sort()
        return out


def union(intervals: list) -> list:
    """Sorted intervals -> their union, as disjoint sorted intervals."""
    out = []
    for a, b in intervals:
        if out and a <= out[-1][1]:
            if b > out[-1][1]:
                out[-1][1] = b
        else:
            out.append([a, b])
    return [tuple(x) for x in out]


def clip(intervals: list, lo, hi) -> list:
    return [(max(a, lo), min(b, hi)) for a, b in intervals if b > lo and a < hi]


def gaps(busy: list, lo, hi) -> list:
    """The idle intervals of [lo, hi] between disjoint sorted busy ones."""
    out, t = [], lo
    for a, b in busy:
        if a > t:
            out.append((t, a))
        t = max(t, b)
    if hi > t:
        out.append((t, hi))
    return out


def label_at(t, spans: list) -> str:
    """The label of the innermost (shortest) span (label, start, end) that
    holds t."""
    held = [(b - a, lb) for lb, a, b in spans if a <= t <= b]
    return min(held)[1] if held else "between"
