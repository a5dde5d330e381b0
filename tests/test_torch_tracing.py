"""The port's tracing (vsta_tpu_torch/utils/tracing.py) on the CPU: spans
in the store always and as profiler ranges under a profiler, marks that
never touch the marker library off the card, and the order of the marks
on the serving and training paths. The marker kernels themselves run on
the card (the benchmark's stage metrics read them in every serving
cell)."""

import re
from pathlib import Path

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from vsta_tpu_torch import config as tcfg
from vsta_tpu_torch import export as texport
from vsta_tpu_torch import kernels
from vsta_tpu_torch.convert import init_state_dict
from vsta_tpu_torch.data.synthetic import make_ring_camera
from vsta_tpu_torch.training.state import create_state, make_train_step
from vsta_tpu_torch.utils import tracing

B, V, HW = 2, 3, (48, 64)


def tiny(fusion):
    model = {"BACKBONE": "simple", "FEAT_DIM": 8, "OUT_INDEX": 2, "BEV_SIZE": [32, 16, 32],
             "BEV_BOUNDS": [-8.0, 8.0, -4.0, 4.0], "BEV_PROJ_CH": 12, "WARP_IMPL": "fused", "FUSION": fusion}
    if fusion == "deform_attn":
        model.update({"ATTN_HEADS": 2, "ATTN_POINTS": 2, "ATTN_STRIDE": 2})
    return tcfg.from_dict({
        "DATA": {"BATCH_SIZE": B, "IMG_SIZE": [3, *HW], "VIEWS": V, "DATA_ROOT": "", "DEVICE_NORMALIZE": True},
        "MODEL": model,
        "TRAIN": {"EPOCHS": 1, "LR": 1e-3, "ACCUM_STEPS": 1},
        "LOSS": {"MAX_OBJECTS": 8},
        "RUNTIME": {"USE_AMP": False, "DEVICE": "cpu"},
        "EVAL": {"CONF_THRESH": 0.05, "MAX_DETS": 16},
    })


def batch(seed=0):
    rng = np.random.default_rng(seed)
    Ks, Rts = zip(*(make_ring_camera(v, V, radius=10.0, height=4.0, img_hw=HW) for v in range(V)))
    boxes = np.zeros((B, 8, 4), np.float32)
    boxes[:, :3] = [[0.0, 0.0, 0.6, 0.6], [2.0, -1.0, 0.6, 0.6], [-3.0, 2.0, 0.6, 0.6]]
    return {
        "images": rng.integers(0, 256, (B, V, *HW, 3)).astype(np.uint8),
        "K": np.broadcast_to(np.stack(Ks), (B, V, 3, 3)).astype(np.float32),
        "Rt": np.broadcast_to(np.stack(Rts), (B, V, 4, 4)).astype(np.float32),
        "boxes_world": boxes,
        "num_boxes": np.array([3, 2], np.int32),
    }


@pytest.fixture
def marks(monkeypatch):
    """Every mark's stage, in call order (the marks still run: on the CPU
    they do nothing)."""
    seen, real = [], tracing.mark

    def record(stage, like):
        seen.append(stage)
        real(stage, like)

    monkeypatch.setattr(tracing, "mark", record)
    return seen


@pytest.fixture(autouse=True)
def empty_store():
    tracing.clear()
    yield
    tracing.clear()


def test_span_outside_a_profiler_opens_no_range(monkeypatch):
    """With no profiler running a span opens no ``vsta.`` range; its store
    still records it, in order, inner spans closing first."""
    def no_range(*a, **k):
        raise AssertionError("a profiler range was opened with no profiler running")

    monkeypatch.setattr(torch._C._profiler, "_RecordFunctionFast", no_range)
    assert not torch.autograd._profiler_enabled()
    with tracing.span("serve", 0):
        with tracing.span("inner"):
            torch.ones(3).add_(1)
    got = tracing.spans()
    assert [s[:2] for s in got] == [("inner", None), ("serve", 0)]
    assert got[1][2] <= got[0][2] <= got[0][3] <= got[1][3]


def test_the_store_keeps_the_newest(monkeypatch):
    monkeypatch.setattr(tracing, "_spans", type(tracing._spans)(maxlen=3))
    for r in range(5):
        with tracing.span("serve", r):
            pass
    assert [s[1] for s in tracing.spans()] == [2, 3, 4]


def test_nested_spans_under_a_profiler():
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        for r in range(3):
            with tracing.span("serve", r):
                with tracing.span("inner"):
                    torch.ones(3).add_(1)
    names = [e.name for e in prof.events()]
    assert names.count("vsta.serve") == 3 and names.count("vsta.inner") == 3
    inner = [e for e in prof.events() if e.name == "vsta.inner"]
    assert all(e.cpu_parent is not None and e.cpu_parent.name == "vsta.serve" for e in inner)
    got = tracing.spans()
    assert [s[:2] for s in got if s[0] == "serve"] == [("serve", 0), ("serve", 1), ("serve", 2)]
    assert all(start <= end for _, _, start, end in got)
    outer = [s for s in got if s[0] == "serve"]
    assert all(a[3] <= b[2] for a, b in zip(outer, outer[1:]))
    tracing.clear()
    assert tracing.spans() == []


def test_mark_on_the_cpu_never_loads_the_library(monkeypatch):
    def refuse(name):
        raise AssertionError(f"kernels.load({name!r}) on the CPU")

    monkeypatch.setattr(kernels, "load", refuse)
    for stage in tracing.STAGES:
        tracing.mark(stage, torch.zeros(2))


def test_every_stage_has_its_marker_kernel():
    src = (Path(kernels.__file__).resolve().parent / "csrc" / "stage_marks.cu").read_text()
    launched = re.findall(r"case (\d+): (vsta_stage_\w+)<<<", src)
    assert launched == [(str(i), f"vsta_stage_{s}") for i, s in enumerate(tracing.STAGES)]
    for s in tracing.STAGES:
        assert f"__global__ void vsta_stage_{s}()" in src
    assert "stage_marks" not in {f.__name__ for f in kernels.wrappers()}


@pytest.mark.parametrize("fusion", ["concat", "deform_attn"])
def test_serving_marks_its_stages_in_order(tmp_path, marks, fusion):
    cfg = tiny(fusion)
    path = tmp_path / "m.pt"
    texport.save_exported(texport.export_serving(cfg, init_state_dict(cfg, seed=1), batch_size=B,
                                                 platforms=["cpu"]), path)
    serve = texport.load_serving(path, device="cpu")
    b = batch()
    with profile(activities=[ProfilerActivity.CPU]):
        serve(b["images"], b["K"], b["Rt"])
        serve(b["images"], b["K"], b["Rt"])
    assert marks == list(tracing.STAGES) * 2
    assert [s[:2] for s in tracing.spans()] == [("serve", 0), ("serve", 1)]
    assert serve.requests == 2


def test_train_step_marks_its_stages_and_spans(marks):
    cfg = tiny("concat")
    state = create_state(cfg, seed=0, device="cpu", steps_per_epoch=1)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        make_train_step(cfg)(state, batch())
    assert marks == ["encoder", "fusion", "head", "end"]
    assert [s[:2] for s in tracing.spans()] == [("train.loss", 0), ("train.backward", 0), ("train.optimizer", 0)]
    names = {e.name for e in prof.events()}
    assert {"vsta.train.loss", "vsta.train.backward", "vsta.train.optimizer"} <= names
