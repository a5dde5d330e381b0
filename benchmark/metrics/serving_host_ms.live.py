"""The median host time of the port's ``Serving.__call__`` a request, in
milliseconds: the program's ``serve`` spans (``vsta_tpu_torch.utils.tracing``:
the copies into the graph's buffers, the replay's launch, the clones of
the outputs), every call the store holds. The store records with or
without a profiler, so most of them are the window's untraced calls; the
profiled stretch's few (under a tenth) read about 3 ms, the profiler's
cost on the replay's launch. None where the program keeps no such spans."""

import statistics


def read(rec):
    try:
        from vsta_tpu_torch.utils import tracing
    except ImportError:
        return None
    times = [end - start for name, _, start, end in tracing.spans() if name == "serve"]
    if not times:
        return None
    return statistics.median(times) / 1e6
