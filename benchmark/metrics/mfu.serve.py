"""The model's operations a frame set (counted from the benchmark's
reference, forward and decode) times the frame sets completed in the
profiled stretch over its length, over the H100's dense bf16 peak, in percent."""

from benchmark.counts.peaks import PEAK_FLOPS_PER_S


def read(rec):
    flops, items, tr = rec.counts.get("model_flops_per_item"), rec.counters.get("profiled_items"), rec.trace
    if not flops or not items or tr is None or tr.window_s <= 0:
        return None
    return 100.0 * flops * items / tr.window_s / PEAK_FLOPS_PER_S["bfloat16"]
