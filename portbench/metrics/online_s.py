"""online_s: mean host seconds of sign_online a pass over the window
(host clock around the call, ending in torch.cuda.synchronize())."""

import statistics


def read(rec):
    xs = rec["spans"].get("online")
    return statistics.fmean(xs) if xs else None
