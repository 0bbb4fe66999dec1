"""Port tests (tpu_mpc_torch): CPU runs by default; the `cuda` marker tags
the tests that need an NVIDIA card and skip without one."""


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs a CUDA device (runs the hand-written kernels)")
    # one intra-op torch thread per process: the plain versions are many
    # small torch ops, and with pytest-xdist's worker processes on the same
    # cores their OpenMP pools spin against each other (a 768-bit keygen
    # took 570 s in each of two concurrent processes at the default thread
    # count, 2.1 s in each of six with one thread)
    import torch

    torch.set_num_threads(1)
