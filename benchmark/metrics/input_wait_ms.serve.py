"""The serving loop's wait on the port's ``Prefetcher`` queue a request,
in milliseconds, over the window (``Prefetcher.wait_s / n_yielded``)."""


def read(rec):
    n = rec.counters.get("batches")
    if not n:
        return None
    return 1e3 * rec.counters["input_wait_s"] / n
