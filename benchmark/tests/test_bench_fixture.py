"""A cell and a per-layer metric added by files alone: a configuration
file, a traffic file, a limits file and a reader in a tree of their own,
with an entry each, run by the harness unchanged."""

import json
import shutil
import time
from pathlib import Path

import pytest

from benchmark.harness import cell as cells
from benchmark.harness.judge import verdict

from .conftest import tiny

BENCH = Path(__file__).resolve().parents[1]


FEEDS = {"pinned": {}, "prefetcher": {"requests_per_pass": 2, "workers": 1, "prefetch": 2}}


@pytest.mark.parametrize("feed", sorted(FEEDS))
def test_fixture_cell_and_metric_from_files(tmp_path, feed):
    root = tmp_path / "benchmark"
    shutil.copytree(BENCH / "drivers", root / "drivers")  # driver modules as they are
    cfg = json.loads((BENCH / "configs" / "wildtrack.json").read_text())
    (root / "configs").mkdir()
    (root / "configs" / "fixture_cfg.json").write_text(json.dumps(dict(cfg, config=tiny(cfg["config"]))))
    (root / "traffic").mkdir()
    (root / "traffic" / "fixture_mix.json").write_text(json.dumps({
        "driver": "closed_loop", "feed": feed, "batch": 1, "frame_sets": 3,
        "warmup_requests": 1, "sample_requests": 1, "profile_after_s": 0.0, "profile_s": 0.2, **FEEDS[feed]}))
    (root / "limits").mkdir()
    (root / "limits" / "fixture_cfg.fixture_mix.json").write_text(json.dumps({"heatmap_gap": 1.0}))
    (root / "metrics").mkdir()
    (root / "metrics" / "fixture_requests.py").write_text(
        "def read(rec):\n    return float(rec.requests) if rec.requests else None\n")
    bench = {
        "configs": [{"name": "fixture_cfg", "source": "x", "file": "benchmark/configs/fixture_cfg.json", "reduced": []}],
        "workloads": [{"name": "fixture_cfg.fixture_mix", "config": "fixture_cfg", "traffic": "fixture_mix", "chips": 1}],
        "end_to_end": [{"name": "frames_per_s", "unit": "frames/s"}, {"name": "setup_s", "unit": "s"}],
        "per_layer": [{"name": "fixture_requests", "unit": "requests", "moves": "frames_per_s"}],
    }
    c = cells.find(bench, "fixture_cfg.fixture_mix", root)
    out = cells.driver(c).run(c, seed=2**31 + 9, seconds=4.0, trace=True, t0=time.perf_counter(), device="cpu")
    assert out.end_to_end["frames_per_s"] > 0
    assert verdict(out.numbers, c.limits)[0]
    got = cells.read_metrics(c, out.records)
    assert got["fixture_requests"] == out.records.requests > 0
