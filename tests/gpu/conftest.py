"""Port tests (tpu_mpc_torch): CPU runs by default; the `cuda` marker tags
the tests that need an NVIDIA card and skip without one."""


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs a CUDA device (runs the hand-written kernels)")
