"""Port tests (tpu_mpc_torch): CPU runs by default; the `cuda` marker tags
the tests that need an NVIDIA card and skip without one.  Registers
JitMapGuard for the whole session."""

import gc
import sys

# the largest single compilation seen maps ~2.4k areas
# (tests/test_gg20_adversarial.py's _dual_mul_jit); 0.85 of 65530 leaves
# ~9.8k for the one being compiled
SHARE = 0.85


def _map_limit():
    """The kernel's limit on this process's mapped areas, or None where
    /proc does not say."""
    try:
        with open("/proc/sys/vm/max_map_count") as f:
            return int(f.read())
    except (OSError, ValueError):
        return None


def _mapped_areas():
    with open("/proc/self/maps", "rb") as f:
        return f.read().count(b"\n")


class JitMapGuard:
    """Drops jax's compiled programs before a compilation once the process
    holds more than `share` of the kernel's mapped-area limit.

    XLA's CPU backend maps three areas (code, read-only data, data) for
    every kernel of every program it compiles and keeps them while the
    executable is cached: the 85 programs that
    tests/test_lindell17.py::test_keygen_and_sign compiles map ~15k areas,
    and one protocol test adds up to ~44k.  A pytest-xdist worker that runs
    two of them passes `vm.max_map_count` (65530 by default) and dies inside
    jaxlib's `backend_compile_and_load` (segmentation fault or abort),
    failing whatever test it was running.  `jax.clear_caches()` unmaps
    them, and a program needed again is compiled again; dropping after
    every large test instead costs each of them a cold start, which
    pushes the suite past its time limit.  So the check runs where a
    program is about to be compiled (jax's `pxla._cached_compilation`, the
    one entry of jit's compilations, outside its cache) and drops only
    when the rest of the limit might not hold that one program.  Installed
    for the whole session wherever jax is loaded: the JAX package's tests
    and the port's share the workers."""

    def __init__(self, share=SHARE):
        self.share = share
        self.limit = _map_limit()
        self.drops = 0
        self._real = None

    def check(self):
        if self.limit is not None and _mapped_areas() >= self.share * self.limit:
            import jax

            jax.clear_caches()
            gc.collect()
            self.drops += 1

    def install(self):
        from jax._src.interpreters import pxla

        real = self._real = pxla._cached_compilation

        def guarded(*args, **kwargs):
            self.check()
            return real(*args, **kwargs)

        pxla._cached_compilation = guarded

    def uninstall(self):
        if self._real is not None:
            from jax._src.interpreters import pxla

            pxla._cached_compilation = self._real


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs a CUDA device (runs the hand-written kernels)")
    guard = JitMapGuard()
    if "jax" in sys.modules:        # tests/conftest.py imports it; the card's runs do not
        guard.install()
    config.pluginmanager.register(guard, "jit-map-guard")
    # one intra-op torch thread per process: the plain versions are many
    # small torch ops, and with pytest-xdist's worker processes on the same
    # cores their OpenMP pools spin against each other (a 768-bit keygen
    # took 570 s in each of two concurrent processes at the default thread
    # count, 2.1 s in each of six with one thread)
    import torch

    torch.set_num_threads(1)


def pytest_unconfigure(config):
    guard = config.pluginmanager.get_plugin("jit-map-guard")
    if guard is not None:
        guard.uninstall()
