"""``BENCHMARK.json`` keeps to the benchmark's contract: its keys, the
characters of every name and unit, the files each entry needs, and that
every cell reports set-up, another end-to-end metric and a per-layer one."""

import json
import re
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
LINE = re.compile(r"^[^\t\n\r]{1,200}$")
PATH = re.compile(r"^[A-Za-z0-9_./\-]{1,200}$")


def test_top_level_keys(bench):
    assert set(bench) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}
    assert 1 <= bench["run_seconds"] <= 51 and isinstance(bench["run_seconds"], int)
    assert len(bench["command"]) <= 32 and all(LINE.match(w) for w in bench["command"])
    assert 1 <= len(bench["paths"]) <= 16 and all(PATH.match(p) and ".." not in p for p in bench["paths"])
    assert (ROOT / "BENCHMARK.json").stat().st_size <= 64 * 1024


def test_names_and_units(bench):
    names = []
    for c in bench["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and LINE.match(c["source"]) and LINE.match(c["why"]) and len(c["reduced"]) <= 16
        assert all(NAME.match(k) for k in c["reduced"])
        assert any(c["file"].startswith(p + "/") for p in bench["paths"]) and (ROOT / c["file"]).exists()
        names.append(("config", c["name"]))
    for w in bench["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and NAME.match(w["config"]) and NAME.match(w["traffic"])
        assert w["chips"] in (1, 4) and LINE.match(w["why"])
        names.append(("cell", w["name"]))
    for m in bench["end_to_end"] + bench["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        names.append(("metric", m["name"]))
    for m in bench["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound", "source"}
        assert m["source"] in ("host_clock", "device_trace") and 0.01 <= m["bound"] <= 0.25
    for m in bench["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source", "layer", "moves"}
        assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
        assert LINE.match(m["layer"])
        if m["name"].endswith("_roofline") or "roofline" in m["name"] or "mfu" in m["name"]:
            assert m["unit"] == "%"
    assert len(names) == len(set(names))


def test_every_cell_has_its_files_and_metrics(bench):
    root = ROOT / "benchmark"
    e2e = {m["name"]: m for m in bench["end_to_end"]}
    configs = {c["name"] for c in bench["configs"]}
    used = set()
    for w in bench["workloads"]:
        assert w["config"] in configs
        used.add(w["config"])
        traffic = json.loads((root / "traffic" / f"{w['traffic']}.json").read_text())
        assert (root / "drivers" / f"{traffic['driver']}.py").exists()
        assert json.loads((root / "limits" / f"{w['name']}.json").read_text())
        mine = [m for m in e2e.values() if "workloads" not in m or w["name"] in m["workloads"]]
        assert "setup_s" in {m["name"] for m in mine} and len(mine) >= 2
        layer = [m for m in bench["per_layer"] if "workloads" not in m or w["name"] in m["workloads"]]
        assert layer, w["name"]
        for m in layer:
            moved = e2e[m["moves"]]
            assert "workloads" not in moved or w["name"] in moved["workloads"], (m["name"], w["name"])
    assert used == configs
    for m in bench["per_layer"]:
        assert (root / "metrics" / f"{m['name']}.py").exists()


def test_layers_are_named_alike(bench):
    text = (ROOT / "PERF.md").read_text()
    for layer in {m["layer"] for m in bench["per_layer"]}:
        assert layer in text, layer


def test_every_configuration_names_its_reference(bench):
    """Every configuration file names an existing module of
    ``reference/`` that exports the contract, as ``cell.find`` resolves it."""
    from benchmark.harness.cell import reference
    from benchmark.reference import CONTRACT

    for c in bench["configs"]:
        cfile = json.loads((ROOT / c["file"]).read_text())
        assert (ROOT / "benchmark" / "reference" / f"{cfile['reference']}.py").is_file(), c["name"]
        mod = reference(c["name"], cfile)
        assert all(hasattr(mod, k) for k in CONTRACT), c["name"]
