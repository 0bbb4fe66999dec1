"""launches_per_pass: kernel launches of the window (the change in the
program's kernels.LAUNCHES, K1-K5 together) over its passes."""


def read(rec):
    if not rec["launches"] or not rec["passes"]:
        return None
    return sum(rec["launches"].values()) / rec["passes"]
