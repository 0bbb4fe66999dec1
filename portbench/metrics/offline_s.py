"""offline_s: mean host seconds of offline_stage a pass over the window
(host clock around the call, ending in torch.cuda.synchronize())."""

import statistics


def read(rec):
    xs = rec["spans"].get("offline")
    return statistics.fmean(xs) if xs else None
