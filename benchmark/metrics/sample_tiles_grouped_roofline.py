"""``sample_tiles_grouped`` (``csrc/grouped_taps.cu``, named
``sample_kernel`` on the device) against its roofline over its two
launches a request of the deformable fusion (the query warp and the
sampler): the least time of the launches in the profiled stretch (each
input read once, each output written once, at one request's live taps
and distinct rows) over their device time, in percent."""

from benchmark.counts.kernels import deform_request

KERNEL = "sample_kernel"
LAUNCHES_A_REQUEST = 2


def read(rec):
    tr, batch = rec.trace, rec.extra.get("batch")
    if tr is None or batch is None:
        return None
    secs, n = tr.kernel_s(KERNEL)
    if n == 0 or secs <= 0 or n % LAUNCHES_A_REQUEST:
        return None
    bound = deform_request(rec.reference, rec.cfg, rec.extra["weights"], batch, rec.extra["device"])
    return 100.0 * (n // LAUNCHES_A_REQUEST) * bound.seconds / secs
