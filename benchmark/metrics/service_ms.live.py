"""The median time of a request from its dequeue to its detections in
host memory, in milliseconds (queueing left out): the benchmark's own
``serve`` and ``d2h`` spans, and the copy in, of each request."""

import statistics


def read(rec):
    times = rec.extra.get("service_s")
    if not times:
        return None
    return 1e3 * statistics.median(times)
