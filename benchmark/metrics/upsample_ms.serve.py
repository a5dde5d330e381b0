"""The device time of the bilinear upsample of a request (MVDet's resize of
every view's map before the warp: the operations whose name holds
``upsample_bilinear2d``), in milliseconds: summed over the complete replays
in the profiled stretch (those whose ``vsta_stage_encoder`` and
``vsta_stage_end`` marks both fall inside it, as ``harness/stages.py``
counts them), over their count. None without a trace, marks or such an
operation in a complete replay."""

MARK = "vsta_stage_"
OP = "upsample_bilinear2d"


def read(rec):
    tr = rec.trace
    if tr is None:
        return None
    total, replays, cur = 0.0, 0, None  # cur: the open replay's upsample seconds
    for name, a, b in sorted(tr.ops, key=lambda o: o[1]):
        if name == MARK + "encoder":
            cur = 0.0
        elif name == MARK + "end":
            if cur is not None:
                total, replays, cur = total + cur, replays + 1, None
        elif cur is not None and OP in name:
            cur += (b - a) / 1e6
    if not replays or total <= 0:
        return None
    return 1e3 * total / replays
