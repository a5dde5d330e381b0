"""The device time of the ``fusion`` stage of a request (the geometry, the warp or the deformable fusion and the positional channels),
in milliseconds: the operations from the program's ``vsta_stage_fusion``
mark to its ``vsta_stage_head`` mark, summed over the complete replays
in the profiled stretch, over their count (``harness/stages.py``)."""

from benchmark.harness.stages import stage_ms


def read(rec):
    return stage_ms(rec.trace, "fusion")
