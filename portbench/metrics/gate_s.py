"""gate_s: host seconds a pass in the signature gate, over the window (the
module in portbench/programs/ names it: host/ec.py:ecdsa_verify_batch for
GG20)."""


def read(rec):
    if rec["gate_s"] is None or not rec["passes"]:
        return None
    return rec["gate_s"] / rec["passes"]
