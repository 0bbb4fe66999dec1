"""k1_roofline: K1's share of its roofline over the window, in %: the sum
of the least times of its launches (portbench/roofline: k1_work, bound_ms)
over the sum of their CUDA-event times."""

from portbench import roofline


def read(rec):
    runs = [(s, ms) for k, s, ms in rec["kernels"] if k == "K1"]
    spent = sum(ms for _, ms in runs)
    if not runs or spent <= 0:
        return None
    least = sum(roofline.bound_ms(*roofline.k1_work(**s)) for s, _ in runs)
    return 100.0 * least / spent
