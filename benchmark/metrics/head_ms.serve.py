"""The device time of the ``head`` stage of a request (the detector head and the feature map's cast),
in milliseconds: the operations from the program's ``vsta_stage_head``
mark to its ``vsta_stage_decode`` mark, summed over the complete replays
in the profiled stretch, over their count (``harness/stages.py``)."""

from benchmark.harness.stages import stage_ms


def read(rec):
    return stage_ms(rec.trace, "head")
