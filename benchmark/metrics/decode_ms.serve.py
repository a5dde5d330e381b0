"""The device time of the ``decode`` stage of a request (the decode: peaks, suppression and boxes),
in milliseconds: the operations from the program's ``vsta_stage_decode``
mark to its ``vsta_stage_end`` mark, summed over the complete replays
in the profiled stretch, over their count (``harness/stages.py``)."""

from benchmark.harness.stages import stage_ms


def read(rec):
    return stage_ms(rec.trace, "decode")
