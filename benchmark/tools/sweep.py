"""The sweep that found an open-loop cell's rate, on the chip: the cell's
driver at each offered rate in turn, one process, printing a JSON line a
rate (p50, p95, requests still open when the window closed, the mean
service time). The highest rate whose p95 stays under ``--limit-ms`` with
no growing backlog is the capacity; the cell's traffic file takes a
fixed share of it. The benchmark's own runs never run it.

    python3 benchmark/tools/sweep.py --workload <cell> --rates 60,90,120 [--seconds 10]
"""

import argparse
import copy
import json
import statistics
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT))

from benchmark.harness import cell as cells  # noqa: E402
from benchmark.harness.main import device_ready  # noqa: E402


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--rates", required=True)
    ap.add_argument("--seconds", type=float, default=10.0)
    ap.add_argument("--seed", type=int, default=3_100_000_001)
    ap.add_argument("--limit-ms", type=float, default=100.0)
    args = ap.parse_args()
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    base = cells.find(bench, args.workload)
    why_not = device_ready(base.chips)
    if why_not:
        print(why_not, file=sys.stderr)
        return 3
    driver = cells.driver(base)
    for rate in (float(r) for r in args.rates.split(",")):
        c = copy.deepcopy(base)
        c.traffic["rate"] = rate
        c.traffic["sample_requests"] = 4
        out = driver.run(c, seed=args.seed, seconds=args.seconds, trace=False, t0=time.perf_counter())
        service = out.records.extra.get("service_s") or [float("nan")]
        row = {"rate": rate, **out.end_to_end, "open_at_close": out.numbers.get("requests_open_at_close"),
               "served": out.records.requests, "offered": out.attempted,
               "service_ms_median": 1e3 * statistics.median(service),
               "meets_limit": out.end_to_end["latency_p95_ms"] < args.limit_ms}
        print(json.dumps(row), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
