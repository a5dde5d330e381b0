"""The device's busy time in the profiled stretch over the requests
completed in it, in milliseconds."""


def read(rec):
    tr, n = rec.trace, rec.counters.get("profiled_requests")
    if tr is None or not n:
        return None
    return 1e3 * tr.busy_s() / n
