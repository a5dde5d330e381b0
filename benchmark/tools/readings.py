"""The readings the limits of ``limits/<cell>.json`` are set from, on the
chip: for each seed, one run of the cell's driver (a short window at the
cell's own load and sizes) whose comparison also reads the control, the
reference computed in the precision below the configuration's (fp8 for
bfloat16) put in the program's place. The benchmark's own runs never run
it. One process for all the seeds:

    python3 benchmark/tools/readings.py --workload <cell> --seeds 12 [--seconds 2] [--first-seed N]

Prints one JSON line a seed, then a summary: for every number the most
the program read and the least the control read.
"""

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT))

from benchmark.harness import cell as cells  # noqa: E402
from benchmark.harness.main import device_ready  # noqa: E402

# the precision below the configuration's: fp8 (e4m3 operands, e5m2
# gradients) for bfloat16 serving; int8 for bfloat16 training, where fp8's
# gradient norms do not stand three times off the program's (PERF.md)
CONTROL = {("bfloat16", "serve"): "fp8", ("bfloat16", "train"): "int8", ("float32", "serve"): "bf16",
           ("float32", "train"): "bf16"}


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, default=12)
    ap.add_argument("--first-seed", type=int, default=3_000_000_001)
    ap.add_argument("--seconds", type=float, default=2.0)
    ap.add_argument("--out", type=str, default="")
    ap.add_argument("--fault", type=str, default="", help="plant this fault of tools/faults.py in the program")
    ap.add_argument("--control", type=str, default="", help="the control's precision (default: fp8 below bfloat16)")
    args = ap.parse_args()
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    cell = cells.find(bench, args.workload)
    why_not = device_ready(cell.chips)
    if why_not:
        print(why_not, file=sys.stderr)
        return 3
    dtype = "bfloat16" if cell.cfg["RUNTIME"].get("USE_AMP") else "float32"
    control = args.control or CONTROL[dtype, "train" if cell.traffic["driver"] == "train" else "serve"]
    driver = cells.driver(cell)
    fault = None
    if args.fault:
        from benchmark.tools import faults

        fault = (faults.TRAINING if cell.traffic["driver"] == "train" else faults.SERVING)[args.fault]
    rows = []
    for k in range(args.seeds):
        seed = args.first_seed + k
        t0 = time.perf_counter()
        out = driver.run(cell, seed=seed, seconds=args.seconds, trace=False, t0=t0, control=control, fault=fault)
        row = {"seed": seed, "control": control, "fault": args.fault, **{k2: v for k2, v in out.numbers.items()},
               **out.end_to_end, "memory_peak_bytes": out.memory_peak_bytes}
        rows.append(row)
        print(json.dumps(row), flush=True)
    summary = {}
    names = [k for k in rows[0] if f"control.{k}" in rows[0] and isinstance(rows[0][k], (int, float))]
    for name in names:
        prog = [r[name] for r in rows]
        ctrl = [r[f"control.{name}"] for r in rows]
        summary[name] = {"program_max": max(prog), "program": prog, "control_min": min(ctrl), "control": ctrl}
    print(json.dumps({"summary": summary}), flush=True)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text("\n".join(json.dumps(r) for r in rows) + "\n" + json.dumps({"summary": summary}) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
