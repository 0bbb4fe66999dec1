"""k2_roofline: K2's share of its roofline over the window, in %: the sum
of the least times of its launches (portbench/roofline: k2_work, bound_ms)
over the sum of their CUDA-event times."""

from portbench import roofline


def read(rec):
    runs = [(s, ms) for k, s, ms in rec["kernels"] if k == "K2"]
    spent = sum(ms for _, ms in runs)
    if not runs or spent <= 0:
        return None
    least = sum(roofline.bound_ms(*roofline.k2_work(**s)) for s, _ in runs)
    return 100.0 * least / spent
