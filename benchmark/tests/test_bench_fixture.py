"""A cell and a per-layer metric added by files alone: a configuration
file, a traffic file, a limits file and a reader in a tree of their own,
with an entry each, run by the harness unchanged; and a configuration
whose file names a reference module of that tree."""

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


def fixture_tree(tmp_path, feed, reference=None):
    """A benchmark tree with one cell, ``fixture_cfg.fixture_mix``, and one
    per-layer metric; its configuration names ``reference`` (by default
    the flagship's, from a copy of the package's reference modules)."""
    root = tmp_path / "benchmark"
    shutil.copytree(BENCH / "drivers", root / "drivers")  # driver modules as they are
    cfg = json.loads((BENCH / "configs" / "wildtrack.json").read_text())
    if reference is None:
        shutil.copytree(BENCH / "reference", root / "reference")
    else:
        (root / "reference").mkdir()
        (root / "reference" / f"{reference[0]}.py").write_text(reference[1])
        cfg["reference"] = reference[0]
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
    return cells.find(bench, "fixture_cfg.fixture_mix", root)


def run_fixture(c):
    out = cells.driver(c).run(c, seed=2**31 + 9, seconds=4.0, trace=True, t0=time.perf_counter(), device="cpu")
    assert out.end_to_end["frames_per_s"] > 0
    assert verdict(out.numbers, c.limits)[0]
    got = cells.read_metrics(c, out.records)
    assert got["fixture_requests"] == out.records.requests > 0
    return out


@pytest.mark.parametrize("feed", sorted(FEEDS))
def test_fixture_cell_and_metric_from_files(tmp_path, feed):
    run_fixture(fixture_tree(tmp_path, feed))


OWN_REFERENCE = '''"""The flagship's detector under a reference of the fixture's own, which
counts the forward passes it is asked for."""

from .model import Reference as Detector
from .model import param_specs, project_cells, normalise, tf32_off  # noqa: F401

CALLS = []


class Reference(Detector):
    def forward(self, *args, **kwargs):
        CALLS.append(len(args[0]))
        return super().forward(*args, **kwargs)

    __call__ = forward
'''


def test_fixture_config_names_its_own_reference(tmp_path):
    """A configuration that names a reference module of the fixture's tree
    (building on the package's ``model.py`` by import) is run on it by the
    harness unchanged: weights, calibration and the comparison come from
    that module."""
    c = fixture_tree(tmp_path, "pinned", ("fixture_ref", OWN_REFERENCE))
    assert c.reference.__file__ == str(tmp_path / "benchmark" / "reference" / "fixture_ref.py")
    out = run_fixture(c)
    assert out.numbers["sampled_requests"] > 0
    # calibration's forward on one frame set, the comparison's on each
    # sampled request, the operations' count (a traced run) on ``meta``
    assert len(c.reference.CALLS) == 1 + out.numbers["sampled_requests"] + 1
