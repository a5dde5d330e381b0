"""``sample_tiles_grouped`` (``csrc/grouped_taps.cu``, named
``sample_kernel`` on the device) against its roofline over its one launch
a request of the concat fusion under ``WARP_IMPL: fused``: the views'
projected maps with every frame's BEV_PROJ_CH channels side by side (one
group a view, K = batch * channels) at the static cameras' taps. The least
time of the launches in the profiled stretch (each input read once, each
output written once, at the live taps and distinct rows) over their device
time, in percent."""

from benchmark.counts.kernels import concat_grouped_request

KERNEL = "sample_kernel"


def read(rec):
    tr, batch = rec.trace, rec.extra.get("batch")
    if tr is None or batch is None:
        return None
    secs, n = tr.kernel_s(KERNEL)
    if n == 0 or secs <= 0:
        return None
    bound = concat_grouped_request(rec.reference, rec.cfg, batch["K"][0], batch["Rt"][0], rec.extra["B"])
    return 100.0 * n * bound.seconds / secs
