"""The run's last line: its keys, and no result without a CUDA device."""

import json
import math
import shutil
import types
from pathlib import Path

import pytest

from benchmark.harness import cell as cells
from benchmark.harness import main as harness_main
from benchmark.harness.cell import Records
from benchmark.harness.judge import verdict


def fake_outcome():
    return types.SimpleNamespace(attempted=10, failed=0, end_to_end={"frames_per_s": 300.5, "setup_s": 12.5},
                                 records=Records(cfg={}, traffic={}), memory_peak_bytes=123, numbers={})


def test_line_keys(bench, monkeypatch):
    c = cells.find(bench, "wildtrack.offline_b16")
    monkeypatch.setattr("torch.cuda.get_device_name", lambda *a: "NVIDIA H100 80GB HBM3")
    ok, checks = verdict({"heatmap_gap": 0.0, "det_gap": 0.0, "missed_gap": 0.0}, c.limits)
    line = harness_main.result_line(c, fake_outcome(), False, checks, ok)
    assert list(line) == ["correct", "attempted", "failed", "metrics", "device", "checks"]
    assert set(line["metrics"]) == {"frames_per_s", "setup_s"}
    assert line["device"] == {"platform": "gpu", "kind": "NVIDIA H100 80GB HBM3", "count": 1, "memory_peak_bytes": 123}
    assert all(set(v) == {"value", "limit"} for v in line["checks"].values())
    json.dumps(line)


def test_not_finite_is_not_correct():
    assert not verdict({"a": math.nan}, {"a": 1.0})[0]
    assert not verdict({}, {"a": 1.0})[0]
    assert verdict({"a": 1.0}, {"a": 1.0})[0]


def test_no_card_no_result(capsys, monkeypatch):
    monkeypatch.setattr("torch.cuda.is_available", lambda: False)
    rc = harness_main.main(["--workload", "wildtrack.offline_b16", "--seed", "1", "--seconds", "1"], 0.0)
    out = capsys.readouterr()
    assert rc != 0 and out.out == "" and "CUDA" in out.err


def test_unknown_workload_raises(bench):
    with pytest.raises(KeyError):
        cells.find(bench, "no.such_cell")


@pytest.mark.parametrize("named", [None, "no_such_module", "../reference/model", "precision"])
def test_config_without_its_reference_fails_in_find(bench, tmp_path, named):
    """A configuration file with no ``reference`` key, or one that names
    no module of the tree's ``reference/``, or a module that lacks part of
    the contract, fails in ``cell.find`` with the configuration's name."""
    here = Path(cells.HERE)
    root = tmp_path / "benchmark"
    for sub in ("traffic", "limits", "reference"):
        shutil.copytree(here / sub, root / sub)
    cfile = json.loads((here / "configs" / "wildtrack.json").read_text())
    del cfile["reference"]
    if named is not None:
        cfile["reference"] = named
    (root / "configs").mkdir()
    (root / "configs" / "wildtrack.json").write_text(json.dumps(cfile))
    with pytest.raises(KeyError, match=r"configuration \W*wildtrack\W"):
        cells.find(bench, "wildtrack.offline_b16", root)
    cfile["reference"] = "model"  # the same tree with the key in place runs
    (root / "configs" / "wildtrack.json").write_text(json.dumps(cfile))
    assert cells.find(bench, "wildtrack.offline_b16", root).reference.Reference

