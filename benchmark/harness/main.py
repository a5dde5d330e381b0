"""One run of one cell: set-up, the measured window, the comparison, the
metrics and the result line."""

from __future__ import annotations

import argparse
import json
import math
import sys
from pathlib import Path
from typing import Dict, List, Optional

from . import cell as cells
from .judge import verdict

FORBIDDEN = ("jax", "jaxlib", "flax", "vsta_tpu")


def loaded_forbidden() -> List[str]:
    """Top-level names of loaded modules that are JAX's or the JAX package's,
    each compared whole (``vsta_tpu_torch`` is not ``vsta_tpu``)."""
    tops = {m.split(".")[0] for m in list(sys.modules)}
    return sorted(tops.intersection(FORBIDDEN))


def parse(argv: List[str]) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description="Run one cell of BENCHMARK.json.")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def device_ready(chips: int) -> Optional[str]:
    """None when enough CUDA devices are present, else why not."""
    import torch

    if not torch.cuda.is_available():
        return "no CUDA device is available"
    if torch.cuda.device_count() < chips:
        return f"the cell needs {chips} CUDA devices, {torch.cuda.device_count()} present"
    return None


def result_line(cell: cells.Cell, outcome, trace: bool, checks, correct: bool) -> Dict:
    import torch

    metrics: Dict[str, Dict] = {}
    if not trace:
        for m in cell.end_to_end:
            metrics[m["name"]] = {"value": outcome.end_to_end[m["name"]], "unit": m["unit"]}
    else:
        read = cells.read_metrics(cell, outcome.records)
        units = {m["name"]: m["unit"] for m in cell.per_layer}
        for name, v in read.items():
            if v is not None and math.isfinite(v):
                metrics[name] = {"value": v, "unit": units[name]}
    device = {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": cell.chips,
              "memory_peak_bytes": int(outcome.memory_peak_bytes)}
    line = {"correct": bool(correct), "attempted": int(outcome.attempted), "failed": int(outcome.failed),
            "metrics": metrics, "device": device}
    if trace:
        tr = outcome.records.trace
        device["busy_s"] = tr.busy_s() if tr is not None else 0.0
        device["window_s"] = tr.window_s if tr is not None else 0.0
        if tr is not None:
            line["breakdown"] = tr.breakdown()
    line["checks"] = checks
    return line


def main(argv: List[str], t0: float) -> int:
    args = parse(argv)
    root = Path(__file__).resolve().parent.parent
    bench_path = root.parent / "BENCHMARK.json"
    if not bench_path.exists():
        print(f"benchmark: {bench_path} not found: run from a checkout of the repository", file=sys.stderr)
        return 2
    bench = json.loads(bench_path.read_text())
    cell = cells.find(bench, args.workload, root)
    why_not = device_ready(cell.chips)
    if why_not:
        print(f"benchmark: {why_not}; no result", file=sys.stderr)
        return 3
    driver = cells.driver(cell)
    outcome = driver.run(cell, seed=args.seed, seconds=args.seconds, trace=bool(args.trace), t0=t0)
    found = loaded_forbidden()
    if found:
        print(f"benchmark: modules of JAX or of the JAX package were loaded: {found}; no result", file=sys.stderr)
        return 4
    correct, checks = verdict(outcome.numbers, cell.limits)
    line = result_line(cell, outcome, bool(args.trace), checks, correct)
    for k, v in outcome.numbers.items():
        if k not in checks:
            print(f"[reading] {k} = {v}", file=sys.stderr)
    for name, c in checks.items():
        print(f"[check] {name} = {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    print(json.dumps(line), flush=True)
    return 0
