"""The device time of the ``encoder`` stage of a request (the uint8 normalization and the encoder),
in milliseconds: the operations from the program's ``vsta_stage_encoder``
mark to its ``vsta_stage_fusion`` mark, summed over the complete replays
in the profiled stretch, over their count (``harness/stages.py``)."""

from benchmark.harness.stages import stage_ms


def read(rec):
    return stage_ms(rec.trace, "encoder")
