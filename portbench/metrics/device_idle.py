"""device_idle: the share of the window, in %, in which no operation ran on
the device: 1 - busy / window.  Busy time is the union of the device
activity in torch.profiler's trace, or, where the trace shows none, the
sum of the kernel launches' CUDA-event spans (the run's device.busy_source
says which)."""


def read(rec):
    if rec["busy_s"] is None or rec["window_s"] <= 0:
        return None
    return 100.0 * (1.0 - rec["busy_s"] / rec["window_s"])
