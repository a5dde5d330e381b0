"""The 95th percentile of every request's latency in the window, in
milliseconds: from its due time to its detections in host memory, a
request still open at the close counting at its age then (the live cell's
own arithmetic, ``drivers/open_poisson.latencies``)."""

import numpy as np


def read(rec):
    lat = rec.extra.get("latency_s")
    if lat is None or len(lat) == 0:
        return None
    return 1e3 * float(np.percentile(np.asarray(lat, dtype=np.float64), 95))
