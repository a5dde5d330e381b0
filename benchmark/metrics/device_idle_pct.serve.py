"""The share of the profiled stretch's wall time in which nothing ran on
the device, in percent (torch.profiler's kernels, copies and sets)."""


def read(rec):
    tr = rec.trace
    if tr is None or tr.window_s <= 0:
        return None
    return 100.0 * (1.0 - tr.busy_s() / tr.window_s)
