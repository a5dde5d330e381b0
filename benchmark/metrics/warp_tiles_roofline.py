"""``warp_tiles`` (``csrc/warp_tiles.cu``, the tile body of
``csrc/warp_mma.cuh``, named ``tile_kernel`` on the device) against its
roofline: the least time of its launches in the profiled stretch (each
input read once, each output written once, at the data's live taps and
distinct rows) over their device time, in percent."""

from benchmark.counts.kernels import concat_request

KERNEL = "tile_kernel"


def read(rec):
    tr, batch = rec.trace, rec.extra.get("batch")
    if tr is None or batch is None:
        return None
    secs, n = tr.kernel_s(KERNEL)
    if n == 0 or secs <= 0:
        return None
    bound = concat_request(rec.reference, rec.cfg, batch["K"][0], batch["Rt"][0], rec.extra["B"])
    return 100.0 * n * bound.seconds / secs
