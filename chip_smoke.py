#!/usr/bin/env python3
"""The port's correctness suite on one NVIDIA GPU: every CUDA kernel of
vsta_tpu_torch against its plain version, and every model path with the
kernels against the same path on the plain versions.

    python3 chip_smoke.py
    python3 chip_smoke.py --baseline DIR   # kernel rows 1, 2, 4, 5, 7 of the checkout in DIR beside these
    python3 chip_smoke.py --bn-act         # the one-pass eval BatchNorm kernel alone
    python3 chip_smoke.py --gn-act         # the head's one-pass GroupNorm kernel alone
    python3 chip_smoke.py --mvdet          # MVDet's serving path and its kernels' shapes alone

Phases, each of which raises on failure (exit code != 0): build (every
``csrc/*.cu``, one nvcc a source, all at once); the kernels at the shapes
the model paths give them, each against its plain version and timed at
its main shapes against the least time the card could take
(kernel_phase, grouped_phase, perframe_kernel_phase, ablation_phase,
bn_act_phase, gn_act_phase); serving (serving_phase over :data:`SERVE_CASES`, then
mvdet_phase); export (export_phase: replays bit-equal to eager serving,
int8); training (training_cases over :data:`TRAIN_CASES`); the training
loop and the CLIs (loop_phase); determinism; the mesh
(multidevice_phase); [tf32]; [timing] (utils.timing's chained step);
[overfit]; [e2e] (the recorded-accuracy harnesses as subprocesses).

It times kernels, not requests: ``benchmark/run.py`` owns latency,
frames/s and memory. Prints the kernels JSON line (the eight TPU kernels'
rows, then bn_act's and gn_act's), the nvidia-smi line, then as the last line
``{"ok": true, "device": {...}}``. Exits non-zero without a CUDA device,
and outside a checkout of the repository.
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import math
import os
import re
import subprocess
import sys
import time
from pathlib import Path
from typing import Callable, NamedTuple, Optional

import numpy as np
import torch

from benchmark.counts.peaks import HBM_BYTES_PER_S, PEAK_FLOPS_PER_S  # by dtype name: bf16 on the tensor cores

ROOT = Path(__file__).resolve().parent
FLAGSHIP = ROOT / "configs" / "wildtrack.yaml"
DEFORM = ROOT / "configs" / "wildtrack_deform.yaml"
WARP_TPU = "vsta_tpu/ops/warp_pallas.py"
WARP_SRC = "vsta_tpu_torch/csrc/warp_tiles.cu"
WARP_K = 16 * 128  # flagship batch 16 x BEV_PROJ_CH 128
TRAIN_K = 2 * 128  # the training forward: batch 2 x BEV_PROJ_CH 128
GROUPED_SRC = "vsta_tpu_torch/csrc/grouped_taps.cu"
VIEWS_SRC = "vsta_tpu_torch/csrc/warp_views_sum.cu"
# the training backward's grouped sampler: 7 maps of the padded 35 x 61
# stride-8 map, batch 2 x (40 + 1) raw channels
GROUPED_G, GROUPED_HW, GROUPED_K = 7, (34, 60), 2 * 41
BEV_HW = (120, 360)
# the device kernels behind rows 4 and 5's wrappers, as the profiler names them
KERNEL_NAMES = {"sample_tiles_grouped": "sample_kernel", "taps_dot_grouped": "taps_dot_kernel"}


def log(msg: str) -> None:
    print(msg, flush=True)


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise AssertionError(msg)


def smi() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True,
    ).stdout.strip().splitlines()[0]


def flagship_lut(dev, B=None):
    """Feature-pixel coordinates of the flagship BEV grid on its stride-8
    map: [7, N, 2] under one ring of cameras, or [B, 7, N, 2] under
    :func:`perframe_cameras` (another calibration in every frame)."""
    from vsta_tpu_torch.data.synthetic import make_ring_camera
    from vsta_tpu_torch.geometry import bev_sample_coords_with_depth, ground_grid

    if B is None:
        K, Rt = (np.stack(a) for a in zip(*(make_ring_camera(v, 7, img_hw=(270, 480)) for v in range(7))))
    else:
        K, Rt = perframe_cameras(B, 7, (270, 480))
    K, Rt = (torch.as_tensor(a, dtype=torch.float32, device=dev) for a in (K, Rt))
    grid = ground_grid(*BEV_HW, (-24.0, 24.0, -7.2, 7.2), device=dev)
    coords, _ = bev_sample_coords_with_depth(K, Rt, (270, 480), (34, 60), grid)
    return coords.reshape(*K.shape[:-2], -1, 2)


def perframe_cameras(B, V, img_hw, seed=11, radius=(17.0, 23.0), height=(5.0, 7.0)):
    """K [B, V, 3, 3] and Rt [B, V, 4, 4] float32: a ring of cameras a
    frame, its radius and height drawn from a numpy seed within the given
    ranges, so that every frame has another calibration."""
    from vsta_tpu_torch.data.synthetic import make_ring_camera

    rng = np.random.default_rng(seed)
    Ks, Rts = [], []
    for _ in range(B):
        r, h = rng.uniform(*radius), rng.uniform(*height)
        k, rt = zip(*(make_ring_camera(v, V, radius=r, height=h, img_hw=img_hw) for v in range(V)))
        Ks.append(np.stack(k))
        Rts.append(np.stack(rt))
    return np.stack(Ks).astype(np.float32), np.stack(Rts).astype(np.float32)


def bf16_ulp(x: torch.Tensor) -> torch.Tensor:
    """Spacing of bf16 numbers at |x| (8 significant bits)."""
    e = torch.floor(torch.log2(x.abs().float().clamp_min(2.0**-126)))
    return torch.exp2(e - 7)


def f32_ulp(x: torch.Tensor) -> torch.Tensor:
    """Spacing of float32 numbers at |x| (24 significant bits)."""
    e = torch.floor(torch.log2(x.abs().float().clamp_min(2.0**-126)))
    return torch.exp2(e - 23)


def hold(name: str, got: torch.Tensor, ref: torch.Tensor, rule: str) -> float:
    """Check a kernel's output against its plain version by ``rule``; log
    and return the max abs error."""
    diff = (got.float() - ref.float()).abs()
    if rule == "bf16":  # 1 bf16 ulp of |ref| (+1e-6 max|ref| where sums cancel)
        tol = bf16_ulp(ref) + 1e-6 * ref.float().abs().max()
        ok = bool((diff <= tol).all())
        rule_s = "<= 1 bf16 ulp of |ref| + 1e-6*max|ref|"
    elif rule == "zero":
        ok = bool((got == 0).all())
        rule_s = "exactly 0"
    elif rule == "exact":
        ok = got.dtype == ref.dtype and torch.equal(got, ref)
        rule_s = "bit-equal"
    else:
        tol = 1e-5 * float(ref.float().abs().max())
        ok = float(diff.max()) <= tol
        rule_s = f"<= 1e-5*max|ref| = {tol:.3e}"
    err = float(diff.max())
    log(f"[kernel] {name}: max_abs_err={err:.3e} ({rule_s}) {'ok' if ok else 'FAIL'}")
    check(ok, f"kernel case {name} disagrees with the plain version")
    return err


def random_taps(dev, lead, N, P, seed):
    """idx/wts [*lead, N, 4] with every tap on a random row and a random
    weight (a fifth of them 0): every tile touches hundreds of distinct
    rows, more than one piece of the kernels' weight tile holds."""
    g = torch.Generator(device=dev).manual_seed(seed)
    idx = torch.randint(0, P, (*lead, N, 4), generator=g, device=dev, dtype=torch.int32)
    wts = torch.rand((*lead, N, 4), generator=g, device=dev)
    return idx, torch.where(wts < 0.2, torch.zeros_like(wts), wts)


# the kernels line's two entries of warp_tiles, by the warp's output dtype
WARP_ENTRY = {
    torch.bfloat16: "warp_tiles (resident dispatch: compute-dtype out)",
    torch.float32: "warp_tiles (windowed dispatch: f32 out)",
}


def warp_bound(dev, feats, idx, wts, out_dtype):
    """A dense warp's least time by bytes and operations, ms; what it counts."""
    *lead, P, Kf = feats.shape
    frames, N = (1 if len(lead) == 1 else lead[0]), idx.shape[-2]
    nz = wts != 0
    nnz = int(nz.sum())
    rows = torch.unique((torch.arange(math.prod(lead), device=dev).reshape(*lead, 1, 1) * P + idx)[nz]).numel()
    in_size, out_size = feats.element_size(), torch.empty((), dtype=out_dtype).element_size()
    nbytes = rows * Kf * in_size + frames * N * Kf * out_size + idx.numel() * 8  # an int32 index, an f32 weight a tap
    flops = 2 * nnz * Kf
    t_ops = flops / PEAK_FLOPS_PER_S[str(feats.dtype).removeprefix("torch.")] * 1e3
    return nbytes / HBM_BYTES_PER_S * 1e3, t_ops, nbytes, flops, rows, nnz


def warp_reading(dev, name, feats, idx, wts, out_dtype, grid_w, max_abs_err):
    """warp_tiles (maps [V, P, K], taps [V, N, 4]) or warp_views_sum (maps
    [B, V, P, C], taps [B, V, N, 4], f32 out) at one shape: its time and
    the bound from these inputs; ``max_abs_err`` is the case's error
    against the plain version."""
    from vsta_tpu_torch.ops.warp_cuda import warp_tiles
    from vsta_tpu_torch.ops.warp_views_cuda import warp_views_sum
    from vsta_tpu_torch.utils.timing import cuda_ms

    *lead, P, Kf = feats.shape
    N = idx.shape[-2]
    if len(lead) == 1:
        ms = cuda_ms(warp_tiles, feats, idx, wts, out_dtype=out_dtype, grid_w=grid_w, warmup=5, iters=50)
    else:
        ms = cuda_ms(warp_views_sum, feats, idx, wts, grid_w=grid_w, warmup=3, iters=20)
    t_bytes, t_ops, nbytes, flops, rows, nnz = warp_bound(dev, feats, idx, wts, out_dtype)
    dims = "".join(f"{k}={v} " for k, v in zip(("B", "V")[2 - len(lead):], lead))
    reading = {
        "shape": f"{dims}P={P} N={N} K={Kf} {str(feats.dtype).split('.')[-1]}->{str(out_dtype).split('.')[-1]}",
        "max_abs_err": max_abs_err, "ms": ms,
        "bound_ms": max(t_bytes, t_ops), "bound_by": "bytes" if t_bytes >= t_ops else "operations",
    }
    log(
        f"[kernel] {name} {reading['shape']}: ms={ms:.4f} bound_ms={reading['bound_ms']:.4f} "
        f"({reading['bound_by']}: {nbytes / 1e6:.1f} MB = {rows} source rows read once + out + LUT; "
        f"{flops / 1e9:.2f} GFLOP over {nnz} live taps of {wts.numel()}) roofline_share={reading['bound_ms'] / ms:.3f}"
    )
    return reading


def kernel_phase(dev):
    from vsta_tpu_torch.ops.warp import precompute_warp_lut
    from vsta_tpu_torch.ops.warp_cuda import warp_tiles, warp_tiles_ref

    V, P, K = 7, 34 * 60, WARP_K
    Wb = BEV_HW[1]
    coords = flagship_lut(dev)
    N = coords.shape[1]
    idx, wts = precompute_warp_lut(coords, (34, 60))
    g = torch.Generator(device=dev).manual_seed(0)
    f32 = torch.randn((V, P, K), generator=g, device=dev)
    bf = f32.to(torch.bfloat16)
    errs = {}

    def compare(name, feats, i, w, out_dtype, rule, grid_w=Wb):
        got = warp_tiles(feats, i, w, out_dtype=out_dtype, grid_w=grid_w)
        torch.cuda.synchronize()
        ref = warp_tiles_ref(feats, i, w, out_dtype=out_dtype)
        check(got.dtype == out_dtype and got.shape == ref.shape, f"{name}: shape/dtype")
        errs[name] = hold(name, got, ref, rule)
        again = torch.equal(got, warp_tiles(feats, i, w, out_dtype=out_dtype, grid_w=grid_w))
        check(again, f"{name}: two launches differ")

    compare(f"bf16->bf16 K={K}", bf, idx, wts, torch.bfloat16, "bf16")
    compare(f"f32->f32 K={K}", f32, idx, wts, torch.float32, "f32")
    compare(f"bf16->f32 K={K}", bf, idx, wts, torch.float32, "f32")
    blind = torch.zeros_like(wts)
    compare("all views blind, poisoned, bf16", torch.full_like(bf, 1e6), idx, blind, torch.bfloat16, "zero")
    compare("all views blind, poisoned, f32", torch.full_like(f32, 1e6), idx, blind, torch.float32, "zero")
    bad = coords.clone()
    bad[:, ::97, 0] = float("nan")
    bad[:, 5::89, 1] = float("inf")
    bad[:, 7::101] = -float("inf")
    bidx, bwts = precompute_warp_lut(bad, (34, 60))
    compare("non-finite coords f32", f32, bidx, bwts, torch.float32, "f32")
    # batch 1's shape on the main path: K = 128, the vectorised path with
    # 64 cells a block
    compare("bf16->bf16 K=128 (batch 1)", bf[..., :128].contiguous(), idx, wts, torch.bfloat16, "bf16")
    for Kr in (100, 13):
        compare(f"ragged K={Kr} bf16", bf[..., :Kr].contiguous(), idx, wts, torch.bfloat16, "bf16")
        compare(f"ragged K={Kr} f32", f32[..., :Kr].contiguous(), idx, wts, torch.float32, "f32")
    # the training forward's shape: batch 2 x 128 channels, resident dispatch
    bf_train = bf[..., :TRAIN_K].contiguous()
    compare(f"bf16->bf16 K={TRAIN_K} (training forward)", bf_train, idx, wts, torch.bfloat16, "bf16")
    # without the grid's width: runs of 64 cells, up to 236 rows a tile,
    # three pieces of the weight tile
    compare(f"bf16->bf16 K={K}, runs of 64 cells", bf, idx, wts, torch.bfloat16, "bf16", grid_w=None)
    compare(f"f32->f32 K={TRAIN_K}, runs of 64 cells", f32[..., :TRAIN_K].contiguous(), idx, wts, torch.float32,
            "f32", grid_w=None)
    # random taps: hundreds of rows a tile, the weight tile in many pieces
    ridx, rwts = random_taps(dev, (V,), N, P, seed=8)
    compare(f"random taps bf16->bf16 K={TRAIN_K}", bf_train, ridx, rwts, torch.bfloat16, "bf16")
    compare("random taps f32->f32 K=128", f32[..., :128].contiguous(), ridx, rwts, torch.float32, "f32")
    compare("random taps ragged K=100 bf16->f32", bf[..., :100].contiguous(), ridx, rwts, torch.float32, "f32")
    log("[kernel] warp_tiles: every case above launched twice, bit-equal")

    # timing at the main path's shapes
    entries = []
    for feats, out_dtype, replaces in ((bf, torch.bfloat16, f"{WARP_TPU}:162"), (f32, torch.float32, f"{WARP_TPU}:353")):
        name = WARP_ENTRY[out_dtype]
        err = errs[f"bf16->bf16 K={K}" if out_dtype == torch.bfloat16 else f"f32->f32 K={K}"]
        entries.append({"name": name, "route": "cuda", "source": WARP_SRC, "replaces": replaces, "launches": None,
                        **warp_reading(dev, name, feats, idx, wts, out_dtype, Wb, err), "other_shapes": []})
    return entries


def perframe_kernel_phase(dev):
    """The dense per-frame warp against its plain version at the shapes the
    per-frame concat path gives it (B = 16 serving, 2 training; V = 7,
    P = 34 * 60, N = 120 * 360, C = 128), and its times against the bound.
    Returns the kernel's entry."""
    from vsta_tpu_torch.ops.warp import precompute_warp_lut
    from vsta_tpu_torch.ops.warp_views_cuda import warp_views_sum, warp_views_sum_ref

    B, V, P, C = 16, 7, 34 * 60, 128
    coords = flagship_lut(dev, B)
    N = coords.shape[2]
    idx, wts = precompute_warp_lut(coords, (34, 60))
    check(float((coords[0] - coords[1]).abs().max()) > 0.5, "the frames share a calibration")
    g = torch.Generator(device=dev).manual_seed(4)
    f32 = torch.randn((B, V, P, C), generator=g, device=dev)
    bf = f32.to(torch.bfloat16)
    errs = {}

    Wb = BEV_HW[1]

    def compare(name, feats, i, w, rule="f32", blind=None):
        got = warp_views_sum(feats, i, w, grid_w=Wb)
        torch.cuda.synchronize()
        ref = warp_views_sum_ref(feats, i, w)
        check(got.dtype == torch.float32 and got.shape == ref.shape == (feats.shape[0], N, feats.shape[-1]),
              f"{name}: shape/dtype")
        if blind is not None:
            hold(f"{name}, the blind frame", got[blind], ref[blind], "zero")
        errs[name] = hold(name, got, ref, rule)
        check(torch.equal(got, warp_views_sum(feats, i, w, grid_w=Wb)), f"{name}: two launches differ")

    compare("warp_views_sum bf16 B=16 C=128", bf, idx, wts)
    compare("warp_views_sum f32 B=16 C=128", f32, idx, wts)
    compare("warp_views_sum bf16 B=2 C=128 (training)", bf[:2].contiguous(), idx[:2].contiguous(), wts[:2].contiguous())
    compare("warp_views_sum f32 B=2 C=128", f32[:2].contiguous(), idx[:2].contiguous(), wts[:2].contiguous())
    compare("warp_views_sum bf16 B=1 C=128 (batch 1)", bf[:1].contiguous(), idx[:1].contiguous(), wts[:1].contiguous())
    for Cr in (100, 13):
        compare(f"warp_views_sum ragged C={Cr} bf16", bf[:2, ..., :Cr].contiguous(), idx[:2].contiguous(), wts[:2].contiguous())
        compare(f"warp_views_sum ragged C={Cr} f32", f32[:2, ..., :Cr].contiguous(), idx[:2].contiguous(), wts[:2].contiguous())
    # a frame none of whose views sees a cell, its maps poisoned: exact zeros
    blind_w = wts[:4].clone()
    blind_w[1] = 0.0
    poisoned = bf[:4].clone()
    poisoned[1] = 1e6
    compare("warp_views_sum frame 1 blind and poisoned, bf16", poisoned, idx[:4].contiguous(), blind_w, blind=1)
    compare("warp_views_sum frame 1 blind and poisoned, f32", poisoned.float(), idx[:4].contiguous(), blind_w, blind=1)
    bad = coords[:2].clone()
    bad[:, :, ::97, 0] = float("nan")
    bad[:, :, 5::89, 1] = float("inf")
    bad[:, :, 7::101] = -float("inf")
    bidx, bwts = precompute_warp_lut(bad, (34, 60))
    compare("warp_views_sum non-finite coords f32", f32[:2].contiguous(), bidx, bwts)
    compare("warp_views_sum non-finite coords bf16", bf[:2].contiguous(), bidx, bwts)
    ridx, rwts = random_taps(dev, (2, V), N, P, seed=9)
    compare("warp_views_sum random taps bf16 B=2", bf[:2].contiguous(), ridx, rwts)
    compare("warp_views_sum random taps f32 B=2", f32[:2].contiguous(), ridx, rwts)
    log("[perframe-kernel] warp_views_sum: every case above launched twice, bit-equal")

    readings = [warp_reading(dev, "warp_views_sum", *inputs, torch.float32, Wb, errs[key]) for key, inputs in (
        ("warp_views_sum bf16 B=16 C=128", (bf, idx, wts)),
        ("warp_views_sum bf16 B=2 C=128 (training)", tuple(t[:2].contiguous() for t in (bf, idx, wts))),
        ("warp_views_sum bf16 B=1 C=128 (batch 1)", tuple(t[:1].contiguous() for t in (bf, idx, wts))),
        ("warp_views_sum f32 B=16 C=128", (f32, idx, wts)))]
    return {"name": "warp_views_sum", "route": "cuda", "source": VIEWS_SRC, "replaces": f"{WARP_TPU}:1391",
            "launches": None, **readings[0], "other_shapes": readings[1:]}


def ablation_phase(dev):
    """The ablation variants of the warp kernel at the flagship serving
    shape (K = 2,048), bf16 and f32: each against its plain version, 'full'
    bit-equal to warp_tiles, then the four times side by side (the
    attribution run, whose launches are the entry's count). Returns the
    entry of the TPU script's _resident_variant."""
    from vsta_tpu_torch.ops.warp import precompute_warp_lut
    from vsta_tpu_torch.ops import warp_cuda as wc
    from vsta_tpu_torch.utils.timing import cuda_ms

    V, P, K = 7, 34 * 60, WARP_K
    Wb = BEV_HW[1]
    coords = flagship_lut(dev)
    N = coords.shape[1]
    idx, wts = precompute_warp_lut(coords, (34, 60))
    g = torch.Generator(device=dev).manual_seed(0)
    f32 = torch.randn((V, P, K), generator=g, device=dev)
    bf = f32.to(torch.bfloat16)
    worst = 0.0
    for feats, out_dtype, rule in ((bf, torch.bfloat16, "bf16"), (f32, torch.float32, "f32")):
        tag = str(out_dtype).split(".")[-1]
        for variant in wc.VARIANTS:
            got = wc.warp_tiles_variant(feats, idx, wts, variant, out_dtype=out_dtype, grid_w=Wb)
            torch.cuda.synchronize()
            ref = wc.warp_tiles_variant_ref(feats, idx, wts, variant, out_dtype=out_dtype)
            check(got.shape == ref.shape == (N, K) and got.dtype == out_dtype, f"{variant}: shape/dtype")
            worst = max(worst, hold(f"warp_tiles_variant {variant} {tag} K={K}", got, ref, rule))
        same = torch.equal(wc.warp_tiles_variant(feats, idx, wts, "full", out_dtype=out_dtype, grid_w=Wb),
                           wc.warp_tiles(feats, idx, wts, out_dtype=out_dtype, grid_w=Wb))
        log(f"[ablation] 'full' {tag} bit-equal to warp_tiles: {same}")
        check(same, f"the 'full' variant differs from warp_tiles ({tag})")
    try:
        wc.warp_tiles_variant(bf, idx, wts, "no_sbuild", out_dtype=torch.bfloat16)
        check(False, "an unknown variant was not refused")
    except ValueError:
        pass

    # the attribution run: its launches are what the entry counts
    wc.warp_tiles_variant.launches = 0
    times = {}
    for feats, out_dtype in ((bf, torch.bfloat16), (f32, torch.float32)):
        tag = str(out_dtype).split(".")[-1]
        times[tag] = {v: cuda_ms(wc.warp_tiles_variant, feats, idx, wts, v, out_dtype=out_dtype, grid_w=Wb,
                                 warmup=3, iters=30) for v in wc.VARIANTS}
        times[tag]["warp_tiles"] = cuda_ms(wc.warp_tiles, feats, idx, wts, out_dtype=out_dtype, grid_w=Wb,
                                           warmup=3, iters=30)
    launches = wc.warp_tiles_variant.launches
    check(launches == 2 * len(wc.VARIANTS) * 33, f"ablation launches {launches}")
    live, taps = int((wts != 0).sum()), wts.numel()
    for tag, t in times.items():
        log(f"[ablation] K={K} {tag}, ms a launch: " + json.dumps({k: round(v, 4) for k, v in t.items()})
            + f" ({live} live taps of {taps}: const_weights stages every tap's row; row0 loads the taps and applies "
              f"the weights but stages one row a view; no_gather reads no map)")
    t_bytes, t_ops = warp_bound(dev, bf, idx, wts, torch.bfloat16)[:2]
    return {
        "name": "warp_tiles_variant", "route": "cuda", "source": WARP_SRC, "replaces": "scripts/roofline_warp.py:190",
        "launches": launches, "max_abs_err": worst, "ms": times["bfloat16"]["full"],
        # ms and bound_ms are the 'full' variant's, bf16: the function warp_tiles computes
        "bound_ms": max(t_bytes, t_ops), "bound_by": "bytes" if t_bytes >= t_ops else "operations",
        "variants_ms": times, "other_shapes": [],
    }


# -- the eval BatchNorm and its activation in one pass (csrc/bn_act.cu) ----

BN_ACT_SRC = "vsta_tpu_torch/csrc/bn_act.cu"
BN_ACT_BATCHES = (112, 7)  # the flagship's images a request at batch 16 and 1
RESNET50_WIDE = (2048, 9, 15)  # ResNet-50's last stage at 270x480: C = 2,048, a plane of 135 (not 8-aligned)
# eval BatchNorms a bf16 request runs, each one bn_act launch (B0 to stride 8:
# the stem, stage 0's two, stages 1 and 2's six; ResNet-50 and -18 to their
# OUT_INDEX); wildtrack_sanity is f32 and an int8 encoder folds its norms
# MVDet's ResNet-18 to C5: the stem's, layer1's four, five in each later
# layer, the residual projections' included
BN_ACT_A_REQUEST = {"flagship": 15, "flagship per-frame": 15, "deform": 15, "sanity": 0, "resnet50": 24,
                    "ms_max": 10, "mvdet": 20}
COLD_BYTES = 200e6  # inputs cycled through per timed launch: four times the 50 MB L2


@contextlib.contextmanager
def batchnorms_seen(seen):
    """Every BatchNorm call in the block, in order, appended to ``seen`` as
    (input shape, act, layout, eps): a forward hook on every module."""
    from torch.nn.modules.module import register_module_forward_hook

    from vsta_tpu_torch.models.encoders.norm import BatchNorm
    from vsta_tpu_torch.ops.bn_act_cuda import layout

    def hook(n, a, kw, out):
        if isinstance(n, BatchNorm):
            seen.append((tuple(a[0].shape), kw.get("act"), layout(a[0]), n.eps))

    handle = register_module_forward_hook(hook, with_kwargs=True)
    try:
        yield seen
    finally:
        handle.remove()


def bn_act_shapes(dev):
    """(C, H, W, act, layout) of every eval BatchNorm of the flagship's
    trunk in one request, in order: the B0 trunk (to OUT_INDEX 2, bf16)
    over 7 channels-last 270x480 images, as ``ViewEncoder`` hands them."""
    from vsta_tpu_torch.models.encoders.efficientnet import EfficientNetFeatures

    trunk = EfficientNetFeatures(torch.bfloat16).to(dev).eval()
    with batchnorms_seen([]) as seen, torch.no_grad():
        trunk(torch.zeros(7, 270, 480, 3, device=dev).permute(0, 3, 1, 2), 3)
    return [(*shape[1:], act, lay) for shape, act, lay, _ in seen]


def bn_act_inputs(dev, N, C, H, W, layout, seed, offset=0):
    """x [N, C, H, W] bf16 in ``layout`` (``offset`` elements into its
    buffer) drawn around per-channel running statistics, and the four
    float32 vectors: the map normalises to about N(bias, weight^2)."""
    g = torch.Generator(device=dev).manual_seed(seed)
    mean = 2.0 * torch.randn(C, generator=g, device=dev)
    var = 4.0 * torch.rand(C, generator=g, device=dev) + 0.05
    weight = 1.0 + 0.5 * torch.randn(C, generator=g, device=dev)
    bias = 0.5 * torch.randn(C, generator=g, device=dev)
    z = torch.randn(N * C * H * W, generator=g, device=dev)
    buf = torch.empty(offset + z.numel(), dtype=torch.bfloat16, device=dev)
    if layout == "nhwc":
        x = buf[offset:].view(N, H, W, C).permute(0, 3, 1, 2)
        x.copy_((z.view(N, H, W, C) * var.sqrt() + mean).permute(0, 3, 1, 2))
    else:
        x = buf[offset:].view(N, C, H, W)
        x.copy_(z.view(N, C, H, W) * var.sqrt()[:, None, None] + mean[:, None, None])
    return x, mean, var, weight, bias


def bf16_ulps_apart(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """|a - b| in steps of the bf16 number line, elementwise (+0 and -0
    the same point)."""
    def order(t):
        i = t.contiguous().view(torch.int16).int()
        return torch.where(i < 0, -(i & 0x7FFF), i)

    return (order(a) - order(b)).abs()


def flax_order_ref(x, mean, var, weight, bias, eps, act):
    """The kernel's own arithmetic in PyTorch ops, each rounded on its own:
    (x - mean) * (weight / sqrt(var + eps)) + bias in f32, bf16, SiLU."""
    import torch.nn.functional as F

    mul = (1.0 / torch.sqrt(var + eps)) * weight
    y = ((x.float() - mean[:, None, None]) * mul[:, None, None] + bias[:, None, None]).to(torch.bfloat16)
    return F.silu(y) if act == "silu" else y


def bn_act_case(label, x, mean, var, weight, bias, eps, act):
    """One case: two launches bit-equal; bit-equal to :func:`flax_order_ref`,
    the kernel's arithmetic in PyTorch's own ops; against the plain version
    (``F.batch_norm`` in f32: cuDNN's x * scale + shift on the card) at
    least 99.9 % of elements bit-equal: where (x - mean) * mul + bias nears
    0, the plain form cancels terms as large as |mean * mul| in f32 and
    loses more than a bf16 ulp of the small result. Returns the largest
    distance in ulps."""
    from vsta_tpu_torch.ops.bn_act_cuda import bn_act, bn_act_ref

    got = bn_act(x, mean, var, weight, bias, eps, act)
    again = bn_act(x, mean, var, weight, bias, eps, act)
    check(got.stride() == x.stride(), f"[bn_act] {label}: output strides {got.stride()} != input's {x.stride()}")
    check(torch.equal(got, again), f"[bn_act] {label}: two launches differ")
    ref = bn_act_ref(x, mean, var, weight, bias, eps, act)
    ulps = bf16_ulps_apart(got, ref)
    # shares from whole counts: a float32 mean of 1.7e9 ones need not be 1
    worst, same = int(ulps.max()), 1.0 - int((ulps != 0).sum()) / ulps.numel()
    apart = bf16_ulps_apart(got, flax_order_ref(x, mean, var, weight, bias, eps, act)) != 0
    flax_same = 1.0 - int(apart.sum()) / apart.numel()
    ok = flax_same == 1.0 and same >= 0.999
    log(f"[bn_act] {label}: {x.numel()} elements, {100 * flax_same:.4f} % bit-equal to the Flax-order ops; "
        f"against the plain version {100 * same:.4f} % bit-equal, max {worst} bf16 ulp; two launches bit-equal "
        f"{'ok' if ok else 'FAIL'}")
    check(ok, f"[bn_act] {label}: {100 * flax_same:.4f} % bit-equal to the Flax-order ops, "
              f"{100 * same:.4f} % to the plain version")
    return worst


def pass_times(dev, launch, x, bytes_per_element, reps=20):
    """(kernel ms, bound ms) of ``launch(x)``, a one-pass kernel over the
    bf16 map x, device time: ``reps`` launches in one CUDA graph (no host
    overhead between them, as in a replayed request), x cycled through
    enough copies (COLD_BYTES) that each launch reads it from device
    memory; the bound ``bytes_per_element`` over the HBM's bandwidth."""
    from vsta_tpu_torch.utils.timing import cuda_ms

    nbytes = 2 * x.numel()
    copies = [x] + [x.clone() for _ in range(max(0, math.ceil(COLD_BYTES / nbytes) - 1))]
    side = torch.cuda.Stream(dev)
    side.wait_stream(torch.cuda.current_stream(dev))
    with torch.cuda.stream(side):
        launch(x)
    torch.cuda.current_stream(dev).wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for r in range(reps):
            launch(copies[r % len(copies)])
    ms = cuda_ms(graph.replay, warmup=2, iters=5) / reps
    del graph
    return ms, x.numel() * bytes_per_element / HBM_BYTES_PER_S * 1e3


def bn_act_times(dev, x, mean, var, weight, bias, eps, act):
    """:func:`pass_times` of bn_act: x read once and written once, 4
    bytes an element."""
    from vsta_tpu_torch.ops.bn_act_cuda import bn_act

    return pass_times(dev, lambda t: bn_act(t, mean, var, weight, bias, eps, act), x, 4)


def bn_act_phase(dev):
    """csrc/bn_act.cu against its plain version (``F.batch_norm`` in f32,
    the cast, ``F.silu``) at the flagship's 15 eval BatchNorms (their
    shapes from the trunk's hooks) at 112 images (batch 16) and 7 (batch
    1), each in both layouts, with and without SiLU; at ResNet-50's 2,048
    channels in both layouts (NCHW: the element-wise kernel, a plane of
    135); channels-last at an odd element offset (the element-wise kernel
    again), each held by :func:`bn_act_case`. Then each of the 15 as the
    model runs it (channels-last, its own activation) timed at 112 and 7
    images. Returns the kernels-line entry (ms, bound_ms: the 15 of a
    batch-16 request summed)."""
    from vsta_tpu_torch.ops.bn_act_cuda import bn_act

    shapes = bn_act_shapes(dev)
    acts = [s[3] for s in shapes]
    log(f"[bn_act] the flagship trunk's eval BatchNorms (C, H, W, act, layout): {shapes}")
    check(len(shapes) == BN_ACT_A_REQUEST["flagship"] and acts.count("silu") == 10,
          f"[bn_act] {len(shapes)} eval BatchNorms, {acts.count('silu')} with SiLU: expected 15 and 10")
    check(all(s[4] == "nhwc" for s in shapes), "[bn_act] the trunk hands a BatchNorm a map that is not channels-last")
    eps = 1e-3
    worst, launches0 = 0, bn_act.launches
    for i, (C, H, W, _, _) in enumerate(shapes):
        for N in BN_ACT_BATCHES:
            for lay in ("nhwc", "nchw"):
                args = bn_act_inputs(dev, N, C, H, W, lay, seed=1000 + i)
                for act in (None, "silu"):
                    worst = max(worst, bn_act_case(f"#{i} N={N} C={C} {H}x{W} {lay} {act}", *args, eps, act))
                del args
    C, H, W = RESNET50_WIDE
    for lay in ("nhwc", "nchw"):
        args = bn_act_inputs(dev, 112, C, H, W, lay, seed=7)
        for act in (None, "silu"):
            worst = max(worst, bn_act_case(f"ResNet-50 N=112 C={C} {H}x{W} {lay} {act}", *args, 1e-5, act))
    args = bn_act_inputs(dev, 112, 24, 68, 120, "nhwc", seed=8, offset=1)
    worst = max(worst, bn_act_case("N=112 C=24 68x120 nhwc at an odd element offset", *args, eps, "silu"))
    del args

    totals = {}
    for N in BN_ACT_BATCHES:
        rows = []
        for i, (C, H, W, act, _) in enumerate(shapes):
            args = bn_act_inputs(dev, N, C, H, W, "nhwc", seed=2000 + i)
            ms, bound_ms = bn_act_times(dev, *args, eps, act)
            rows.append({"C": C, "HxW": f"{H}x{W}", "act": act, "ms": round(ms, 4), "bound_ms": round(bound_ms, 4),
                         "share": round(bound_ms / ms, 3)})
            del args
        totals[N] = {k: sum(r[k] for r in rows) for k in ("ms", "bound_ms")}
        log(f"[bn_act] N={N}, the 15 as the model runs them (channels-last), ms a launch: {json.dumps(rows)}")
        log(f"[bn_act] N={N}, a request's 15: kernel {totals[N]['ms']:.4f} ms, bound {totals[N]['bound_ms']:.4f} ms "
            f"(share {totals[N]['bound_ms'] / totals[N]['ms']:.3f})")
    t = totals[BN_ACT_BATCHES[0]]
    return {"name": "bn_act", "route": "cuda", "source": BN_ACT_SRC, "replaces": None,
            "launches": bn_act.launches - launches0, "max_ulps": worst, "ms": t["ms"], "bound_ms": t["bound_ms"],
            "bound_by": "bytes", "batch1": totals[BN_ACT_BATCHES[1]], "other_shapes": []}


# -- the CenterNet head's GroupNorm and its ReLU in one pass (csrc/gn_act.cu) --

GN_ACT_SRC = "vsta_tpu_torch/csrc/gn_act.cu"
GN_ACT_CHANNELS = (512, 128, 128)  # the head's three GroupNorms (mid1, mid2, mid2) on the 120 x 360 BEV
GN_ACT_BATCHES = (16, 1)  # the offline cells' request and the live cell's
# GroupNorms a bf16 request runs through gn_act: the CenterNet head's three
# (wildtrack_sanity is f32, MVDet's head has none, an int8 head runs its own)
GN_ACT_A_REQUEST = {"flagship": 3, "flagship per-frame": 3, "deform": 3, "sanity": 0, "resnet50": 3, "ms_max": 3,
                    "mvdet": 0}
# the device kernels of one gn_act launch, and the moments pass of PyTorch's own GroupNorm
GN_ACT_KERNELS = ("gn_act_stats_kernel", "gn_act_coeffs_kernel", "gn_act_apply_kernel")
GN_MOMENTS = "RowwiseMomentsCUDAKernel"


def gn_act_inputs(dev, N, C, H, W, seed):
    """x [N, C, H, W] bf16 channels-last, every channel about a mean and
    spread of its own (as a convolution's output), and GroupNorm's weight
    and bias [C] float32."""
    g = torch.Generator(device=dev).manual_seed(seed)
    mean = torch.randn(C, generator=g, device=dev)
    std = 0.3 + 1.7 * torch.rand(C, generator=g, device=dev)
    weight = 1.0 + 0.5 * torch.randn(C, generator=g, device=dev)
    bias = 0.5 * torch.randn(C, generator=g, device=dev)
    x = (torch.randn((N, H, W, C), generator=g, device=dev) * std + mean).to(torch.bfloat16)
    return x.permute(0, 3, 1, 2), weight, bias


def gn_act_case(label, x, weight, bias, act):
    """One case: two launches bit-equal; the output channels-last; against
    the plain version (``F.group_norm`` in f32 over an NCHW copy, the cast,
    ``F.relu``) at least 99.9 % of elements bit-equal, and every element
    within 1 bf16 ulp of |ref| + 1e-6 max|ref| (``hold``'s bf16 rule): the
    two take the same f32 form a * x + b (PyTorch's affine pass contracts to
    one fused multiply-add) from statistics summed in two orders (Welford's
    running update; shifted sums and pairwise merges), a few f32 units
    apart, so an element lies one bf16 step off where its f32 value sits on
    a rounding boundary, and further only where a * x + b cancels to near 0
    (the second term). Returns the largest distance in bf16 ulps."""
    from vsta_tpu_torch.models.heads import GN_EPS, GN_GROUPS
    from vsta_tpu_torch.ops.gn_act_cuda import gn_act, gn_act_ref

    got = gn_act(x, weight, bias, GN_GROUPS, GN_EPS, act)
    again = gn_act(x, weight, bias, GN_GROUPS, GN_EPS, act)
    check(got.stride() == x.stride(), f"[gn_act] {label}: output strides {got.stride()} != input's {x.stride()}")
    check(torch.equal(got.view(torch.int16), again.view(torch.int16)), f"[gn_act] {label}: two launches differ")
    ref = gn_act_ref(x, weight, bias, GN_GROUPS, GN_EPS, act)
    ulps = bf16_ulps_apart(got, ref)
    worst, same = int(ulps.max()), 1.0 - int((ulps != 0).sum()) / ulps.numel()
    err = hold(f"gn_act {label}", got, ref, "bf16")
    log(f"[gn_act] {label}: {x.numel()} elements, against the plain version {100 * same:.4f} % bit-equal, max "
        f"{worst} bf16 ulp (max abs {err:.3e}); two launches bit-equal {'ok' if same >= 0.999 else 'FAIL'}")
    check(same >= 0.999, f"[gn_act] {label}: {100 * same:.4f} % bit-equal to the plain version")
    return worst


def gn_act_replay(dev):
    """The flagship's batch-16 artifact as one CUDA graph: gn_act's
    launches at the load (3 a request), then one profiled replay runs each
    of its three kernels 3 times and no moments pass of PyTorch's
    GroupNorm. Returns the three GroupNorms' device ms in that replay."""
    import shutil
    import tempfile

    from torch.profiler import ProfilerActivity, profile

    from vsta_tpu_torch.export import WARMUP_REQUESTS, export_serving, load_serving, save_exported
    from vsta_tpu_torch.ops.gn_act_cuda import gn_act

    B, per_request = 16, GN_ACT_A_REQUEST["flagship"]
    cfg, state, inputs = export_config("flagship")
    args = tuple(torch.as_tensor(a[:B], device=dev) for a in inputs)
    tmp = tempfile.mkdtemp(prefix="vsta_gn_act_")
    try:
        path = Path(tmp) / f"flagship_b{B}.pt"
        save_exported(export_serving(cfg, state, batch_size=B, platforms=(dev.type,)), path)
        n = gn_act.launches
        served = load_serving(path, device=dev)
        at_load = gn_act.launches - n
        check(at_load == per_request * (WARMUP_REQUESTS + 2), f"[gn_act] {at_load} launches at the load")
        check_served(cfg, served(*args), B)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            served(*args)
            torch.cuda.synchronize()
        names = (*GN_ACT_KERNELS, GN_MOMENTS)
        events = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
        per_replay = {name: sum(is_kernel(e.name, name) for e in events) for name in names}
        us = sum(e.time_range.elapsed_us() for e in events if any(is_kernel(e.name, k) for k in GN_ACT_KERNELS))
        log(f"[gn_act] flagship B={B} artifact: {at_load} launches at the load; one profiled replay: "
            f"{len(events)} device operations, {json.dumps(per_replay)}, the GroupNorms' kernels {us / 1e3:.4f} ms")
        check(per_replay == {**dict.fromkeys(GN_ACT_KERNELS, per_request), GN_MOMENTS: 0},
              f"[gn_act] one replay's kernels {per_replay}")
        del served
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    del state, args
    torch.cuda.empty_cache()
    return us / 1e3


def gn_act_phase(dev):
    """csrc/gn_act.cu against its plain version at the CenterNet head's
    three GroupNorms (C = 512, 128, 128 over 120 x 360 cells) at batch 16
    and 1, channels-last, with the ReLU and without, each held by
    :func:`gn_act_case`; a CUDA f32 map refused. Then each as the head runs
    it timed against its bound, and one profiled replay of the flagship's
    batch-16 artifact (:func:`gn_act_replay`). Returns the kernels-line
    entry (ms, bound_ms: the three of a batch-16 request summed)."""
    from vsta_tpu_torch.models.heads import GN_EPS, GN_GROUPS
    from vsta_tpu_torch.ops.gn_act_cuda import gn_act

    Hb, Wb = BEV_HW
    worst, launches0 = 0, gn_act.launches
    for B in GN_ACT_BATCHES:
        for i, C in enumerate(dict.fromkeys(GN_ACT_CHANNELS)):
            x, weight, bias = gn_act_inputs(dev, B, C, Hb, Wb, seed=4000 + 10 * B + i)
            for act in ("relu", None):
                worst = max(worst, gn_act_case(f"N={B} C={C} {Hb}x{Wb} nhwc {act}", x, weight, bias, act))
            del x
    x, weight, bias = gn_act_inputs(dev, 1, 128, Hb, Wb, seed=4100)
    try:
        gn_act(x.float(), weight, bias, GN_GROUPS, GN_EPS, "relu")
        check(False, "[gn_act] a CUDA f32 map did not raise")
    except ValueError:
        pass
    del x
    torch.cuda.empty_cache()

    totals = {}
    for B in GN_ACT_BATCHES:
        rows = []
        for i, C in enumerate(GN_ACT_CHANNELS):
            x, weight, bias = gn_act_inputs(dev, B, C, Hb, Wb, seed=4200 + 10 * B + i)
            # 6 bytes an element: read for the statistics, read again and written by the normalisation
            ms, bound_ms = pass_times(dev, lambda t: gn_act(t, weight, bias, GN_GROUPS, GN_EPS, "relu"), x, 6)
            rows.append({"C": C, "HxW": f"{Hb}x{Wb}", "ms": round(ms, 4), "bound_ms": round(bound_ms, 4),
                         "share": round(bound_ms / ms, 3)})
            del x
            torch.cuda.empty_cache()
        totals[B] = {k: sum(r[k] for r in rows) for k in ("ms", "bound_ms")}
        log(f"[gn_act] N={B}, the head's three as it runs them (channels-last, ReLU), ms a launch: {json.dumps(rows)}")
        log(f"[gn_act] N={B}, a request's three: kernel {totals[B]['ms']:.4f} ms, bound {totals[B]['bound_ms']:.4f} "
            f"ms (share {totals[B]['bound_ms'] / totals[B]['ms']:.3f}); each input read once: "
            f"{totals[B]['bound_ms'] * 2 / 3:.4f} ms")
    replay_ms = gn_act_replay(dev)
    t = totals[GN_ACT_BATCHES[0]]
    return {"name": "gn_act", "route": "cuda", "source": GN_ACT_SRC, "replaces": None,
            "launches": gn_act.launches - launches0, "max_ulps": worst, "ms": t["ms"], "bound_ms": t["bound_ms"],
            "bound_by": "bytes", "batch1": totals[GN_ACT_BATCHES[1]], "replay_ms": replay_ms, "other_shapes": []}


def deform_taps(dev, B, stride, seed=2):
    """Taps of the deformable fusion's sampler at the flagship shapes: G =
    B * 7 views * 4 heads groups, N = ceil(120 / stride) * ceil(360 /
    stride) cells * 4 points. Locations are the cameras' reference points
    plus the ring offsets plus noise of a pixel; the per-sample scale is a
    softmax over (view, point) in which the views that do not see the cell
    weigh exactly 0, as in the model."""
    from vsta_tpu_torch.models.fusion import ring_offsets
    from vsta_tpu_torch.ops.warp import anchored_taps, flat_taps

    V, M, Pts, (Hf, Wf) = 7, 4, 4, GROUPED_HW
    g = torch.Generator(device=dev).manual_seed(seed)
    base = flagship_lut(dev).reshape(V, *BEV_HW, 2)[:, ::stride, ::stride]  # [V, Hq, Wq, 2]
    Hq, Wq = base.shape[1:3]
    ring = ring_offsets(M, Pts).to(dev)  # [M, Pts, 2]
    noise = torch.randn((B, V, M, Hq, Wq, Pts, 2), generator=g, device=dev)
    loc = base[None, :, None, :, :, None, :] + ring[None, None, :, None, None, :, :] + noise
    finite = torch.isfinite(base).all(-1)
    valid = finite & (base[..., 0] >= -1) & (base[..., 0] <= Wf) & (base[..., 1] >= -1) & (base[..., 1] <= Hf)
    logits = torch.randn((B, Hq, Wq, M, V, Pts), generator=g, device=dev)
    logits = torch.where(valid.permute(1, 2, 0)[None, :, :, None, :, None], logits, torch.full_like(logits, -1e9))
    attn = torch.softmax(logits.reshape(B, Hq, Wq, M, V * Pts), -1).reshape(B, Hq, Wq, M, V, Pts)
    scale = attn.permute(0, 4, 3, 1, 2, 5).to(torch.bfloat16).float()  # [B, V, M, Hq, Wq, Pts]
    G, N = B * V * M, Hq * Wq * Pts
    anchors, wts = anchored_taps(loc.reshape(G, N, 2), (Hf, Wf))
    wts = (wts * scale.reshape(G, N, 1)).contiguous()
    return flat_taps(anchors, Wf + 1), wts


def sync_free_backward(inputs):
    """One backward of each route of GroupedSample (maps alone, weights
    alone, both fused, both split) under torch.cuda.set_sync_debug_mode
    ("error"): the LUT reads nothing back to the host."""
    from vsta_tpu_torch.ops import grouped_cuda as gc

    maps, gout, idx, wts = inputs
    fits = gc.fused_backward_fits
    routes = {"maps alone": (True, False, None, {"scatter_taps_grouped": 1}),
              "weights alone": (False, True, None, {"taps_dot_grouped": 1}),
              "both, fused": (True, True, True, {"scatter_tapdot_grouped": 1}),
              "both, split": (True, True, False, {"scatter_taps_grouped": 1, "taps_dot_grouped": 1})}
    for label, (need_maps, need_wts, fused, want) in routes.items():
        m, w = maps.clone().requires_grad_(need_maps), wts.clone().requires_grad_(need_wts)
        out = gc.GroupedSample.apply(m, idx, w, gc.KERNELS)
        torch.cuda.synchronize()
        before = {c.__name__: c.launches for c in all_counters()}
        if fused is not None:
            gc.fused_backward_fits = lambda *a, f=fused: f
        torch.cuda.set_sync_debug_mode("error")
        try:
            out.backward(gout)
        finally:
            torch.cuda.set_sync_debug_mode(0)
            gc.fused_backward_fits = fits
        torch.cuda.synchronize()
        launched = {c.__name__: c.launches - before[c.__name__] for c in all_counters()}
        check({k: v for k, v in launched.items() if v} == want, f"sync-free backward, {label}: launched {launched}")
        grads = [t.grad for t in (m, w) if t.grad is not None]
        check(all(bool(torch.isfinite(g).all()) for g in grads), f"sync-free backward, {label}: non-finite")
    log(f"[grouped] one backward of each route ({', '.join(routes)}) at G=56 N=10800 K=32 bf16 under "
        f"torch.cuda.set_sync_debug_mode('error'): no host sync")


def at_odd_offset(x):
    """A copy of x as a contiguous view one element into its buffer: its
    address is aligned to no load wider than one element."""
    buf = torch.empty(x.numel() + 1, dtype=x.dtype, device=x.device)
    view = buf[1:].view(x.shape)
    view.copy_(x)
    return view


def partition_cases(dev, idx, wts, P):
    """Rows 4 and 5 at each branch of their work partition: ragged and
    small K (1, 2, 13, 26, 41, 82) and wide K (32, 128, 1,280), bf16 and
    f32, maps and gout aligned and at an odd element offset (one channel a
    load), on the flagship's taps cut to N = 43,197 samples: no multiple
    of a block's cells, so each group's last block is short and every
    group's output run after the first starts off 16 bytes (the flat
    store's head and tail). Row 4 bit-equal to its plain version, row 5
    within 1e-5 max|ref|; each launched twice, bit-equal; the partition
    the library reports equal to grouped_cuda's mirror of its rules."""
    from vsta_tpu_torch.ops import grouped_cuda as gc

    G, N = idx.shape[0], idx.shape[1] - 3
    i, w = idx[:, :N].contiguous(), wts[:, :N].contiguous()
    gen = torch.Generator(device=dev).manual_seed(8)
    for K in (1, 2, 13, 26, 41, 82, 32, 128, 1280):
        maps32 = torch.randn((G, P, K), generator=gen, device=dev)
        gout32 = torch.randn((G, N, K), generator=gen, device=dev)
        for dtype in (torch.bfloat16, torch.float32):
            for odd in (False, True):
                maps, gout = maps32.to(dtype), gout32.to(dtype)
                if odd:
                    maps, gout = at_odd_offset(maps), at_odd_offset(gout)
                name = f"K={K} {str(dtype).split('.')[-1]} {'odd offset' if odd else 'aligned'} G={G} N={N}"
                out, dw = gc.sample_tiles_grouped(maps, i, w), gc.taps_dot_grouped(maps, gout, i)
                check(torch.equal(out, gc.sample_tiles_grouped(maps, i, w))
                      and torch.equal(dw, gc.taps_dot_grouped(maps, gout, i)),
                      f"partition {name}: two launches of row 4 or row 5 differ")
                hold(f"sample_tiles_grouped {name}", out, gc.sample_tiles_grouped_ref(maps, i, w), "exact")
                hold(f"taps_dot_grouped {name}", dw, gc.taps_dot_grouped_ref(maps, gout, i), "f32")
                size = maps.element_size()
                for kernel, mirror, other in (
                        ("sample_tiles_grouped", gc.sample_partition(K, size, maps.data_ptr(), out.data_ptr()), out),
                        ("taps_dot_grouped", gc.taps_dot_partition(K, size, maps.data_ptr(), gout.data_ptr()), gout)):
                    lib = gc.library_partition(kernel, K, dtype, maps, other)
                    check(lib == mirror, f"partition {name}: {kernel} takes {lib}, grouped_cuda's mirror says {mirror}")
                    check(not odd or lib.vec == 1, f"partition {name}: {kernel} takes {lib.vec} channels a load")
                del out, dw, maps, gout
        del maps32, gout32
    log("[partition] rows 4 and 5, each case twice and bit-equal, the library's partition equal to grouped_cuda's "
        "mirror")


def measure(dev, kind, maps, gout, i, w, max_abs_err):
    """One grouped kernel at one shape: its time and the bound from these
    inputs; ``max_abs_err`` is the case's error against the plain version."""
    from vsta_tpu_torch.ops import grouped_cuda as gc
    from vsta_tpu_torch.utils.timing import cuda_ms

    Gm, Pm, Km = maps.shape
    Nm, T = i.shape[1:]
    itemsize = maps.element_size()
    live = w != 0
    n_live, n_taps = int(live.sum()), w.numel()
    rows_g = torch.arange(Gm, device=dev)[:, None, None] * Pm + i
    rows_read = torch.unique(rows_g).numel()
    idx_bytes, wts_bytes = Gm * Nm * T * 4, Gm * Nm * T * 4
    map_bytes, gout_bytes = rows_read * Km * itemsize, Gm * Nm * Km * itemsize
    fn, args = {
        "sample_tiles_grouped": (gc.sample_tiles_grouped, (maps, i, w)),
        "scatter_tapdot_grouped": (gc.scatter_tapdot_grouped, (maps, gout, i, w)),
        "scatter_taps_grouped": (gc.scatter_taps_grouped, (gout, i, w, Pm)),
        "taps_dot_grouped": (gc.taps_dot_grouped, (maps, gout, i)),
    }[kind]
    ms = cuda_ms(fn, *args, warmup=2, iters=10)
    more = {}
    if kind in ("scatter_taps_grouped", "scatter_tapdot_grouped"):
        # the two parts of the wrapper's time: the sort, and the walk
        # with its carries over a LUT built beforehand
        lut = gc.tap_lut(i, w, Pm)
        more["lut_ms"] = cuda_ms(gc.tap_lut, i, w, Pm, warmup=2, iters=10)
        more["kernel_ms"] = cuda_ms(fn, *args, lut, warmup=2, iters=10)
        del lut
    if kind == "sample_tiles_grouped":
        nbytes = map_bytes + gout_bytes + idx_bytes + wts_bytes  # out has gout's size
        flops = 2 * n_live * Km
    elif kind == "scatter_taps_grouped":
        nbytes = gout_bytes + idx_bytes + wts_bytes + Gm * Pm * Km * 4
        flops = 2 * n_live * Km
    elif kind == "taps_dot_grouped":
        nbytes = map_bytes + gout_bytes + idx_bytes + Gm * Nm * 4 * 4  # it reads no weights
        flops = 2 * n_taps * Km
    else:
        nbytes = map_bytes + gout_bytes + idx_bytes + wts_bytes + Gm * Pm * Km * 4 + Gm * Nm * 4 * 4
        flops = 2 * n_live * Km + 2 * n_taps * Km
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S * 1e3, flops / PEAK_FLOPS_PER_S[str(maps.dtype).removeprefix("torch.")] * 1e3
    shape = f"G={Gm} P={Pm} N={Nm} K={Km} {str(maps.dtype).split('.')[-1]}"
    reading = {
        "shape": shape, "max_abs_err": max_abs_err, "ms": ms,
        "bound_ms": max(t_bytes, t_ops), "bound_by": "bytes" if t_bytes >= t_ops else "operations", **more,
    }
    split_s = (f" (lut_ms={more['lut_ms']:.4f} + kernel_ms={more['kernel_ms']:.4f})" if "lut_ms" in more else "")
    if kind in ("sample_tiles_grouped", "taps_dot_grouped"):
        reading["device_ms"] = kernel_device_ms(fn, args, KERNEL_NAMES[kind])
        split_s += f" (device_ms={reading['device_ms']})"
    log(f"[grouped] {kind} {shape}: ms={ms:.4f}{split_s} "
        f"bound_ms={reading['bound_ms']:.4f} ({reading['bound_by']}: {nbytes / 1e6:.1f} MB; "
        f"{flops / 1e9:.3f} GFLOP over {n_live} live taps of {n_taps}, {rows_read} map rows touched) "
        f"roofline_share={reading['bound_ms'] / ms:.3f}")
    return reading


def grouped_phase(dev):
    """The grouped sampler's four kernels against their plain versions at
    the shapes the training paths give them, and their times: the
    calibrated warps' backward (G = 7 maps, N = 43,200, K = 82 flagship
    and 128 deformable query) and the deformable fusion's sampler (G = 56
    and 448, N = 10,800 at ATTN_STRIDE 4 and 172,800 at 1, K = 32)."""
    from vsta_tpu_torch.ops import grouped_cuda as gc
    from vsta_tpu_torch.ops.warp import anchored_taps, flat_taps

    G, (Hf, Wf), K = GROUPED_G, GROUPED_HW, GROUPED_K
    P = (Hf + 1) * (Wf + 1)
    coords = flagship_lut(dev)
    N = coords.shape[1]
    anchors, wts = anchored_taps(coords, (Hf, Wf))
    idx = flat_taps(anchors, Wf + 1)
    wts = wts.contiguous()
    gen = torch.Generator(device=dev).manual_seed(1)
    maps32 = torch.randn((G, P, 128), generator=gen, device=dev)
    gout32 = torch.randn((G, N, 128), generator=gen, device=dev)
    errs = {}
    bf = torch.bfloat16

    def cases(name, maps, gout, i, w, rule, one_sided=False):
        """All four kernels on one set of inputs against their plain
        versions; scatter_taps_grouped's dmaps against the fused kernel's
        bit for bit. ``one_sided``: sample_tiles_grouped and
        scatter_taps_grouped alone (a shape only they are given, whose
        plain d_wts would not fit beside it)."""
        maps, gout = maps.contiguous(), gout.contiguous()
        Pm = maps.shape[1]
        lut, lut_ref = gc.tap_lut(i, w, Pm), gc.tap_lut_ref(i, w, Pm)
        check(torch.equal(lut.rows, lut_ref.rows) and torch.equal(lut.order, lut_ref.order),
              f"{name}: tap_lut differs from its plain version")
        del lut, lut_ref
        out = gc.sample_tiles_grouped(maps, i, w)
        check(torch.equal(out, gc.sample_tiles_grouped(maps, i, w)), f"{name}: two launches of row 4 differ")
        if one_sided:
            dm3 = gc.scatter_taps_grouped(gout, i, w, Pm)
            check(torch.equal(dm3, gc.scatter_taps_grouped(gout, i, w, Pm)), f"{name}: two launches of row 3 differ")
            torch.cuda.synchronize()
            ref_out = gc.sample_tiles_grouped_ref(maps, i, w)
            check(out.dtype == maps.dtype and out.shape == ref_out.shape, f"{name}: sample shape/dtype")
            errs[f"sample {name}"] = hold(f"sample_tiles_grouped {name}", out, ref_out, "exact")
            del out, ref_out
            ref_dm = gc.scatter_taps_grouped_ref(gout, i, w, maps.shape[1])
            check(dm3.shape == ref_dm.shape and dm3.dtype == torch.float32, f"{name}: dmaps shape/dtype")
            errs[f"dmaps3 {name}"] = hold(f"scatter_taps_grouped {name}", dm3, ref_dm, "f32")
            return
        dm, dw = gc.scatter_tapdot_grouped(maps, gout, i, w)
        dm3 = gc.scatter_taps_grouped(gout, i, w, maps.shape[1])
        dw5 = gc.taps_dot_grouped(maps, gout, i)
        torch.cuda.synchronize()
        ref_out = gc.sample_tiles_grouped_ref(maps, i, w)
        ref_dm = gc.scatter_taps_grouped_ref(gout, i, w, maps.shape[1])
        ref_dw = gc.taps_dot_grouped_ref(maps, gout, i)
        check(out.dtype == maps.dtype and out.shape == ref_out.shape, f"{name}: sample shape/dtype")
        check(dm.shape == dm3.shape == ref_dm.shape and dw.shape == dw5.shape == ref_dw.shape, f"{name}: shapes")
        check(dm3.dtype == dw5.dtype == torch.float32, f"{name}: gradient dtypes")
        dm_rule = "zero" if rule == "zero" else "f32"
        errs[f"sample {name}"] = hold(f"sample_tiles_grouped {name}", out, ref_out, "exact")
        errs[f"dmaps {name}"] = hold(f"scatter_tapdot_grouped dmaps {name}", dm, ref_dm, dm_rule)
        errs[f"d_wts {name}"] = hold(f"scatter_tapdot_grouped d_wts {name}", dw, ref_dw, "f32")
        errs[f"dmaps3 {name}"] = hold(f"scatter_taps_grouped {name}", dm3, ref_dm, dm_rule)
        errs[f"d_wts5 {name}"] = hold(f"taps_dot_grouped {name}", dw5, ref_dw, "f32")
        same = torch.equal(dm3, dm)
        dm_b, dw_b = gc.scatter_tapdot_grouped(maps, gout, i, w)
        again = torch.equal(dm_b, dm) and torch.equal(dw_b, dw) and torch.equal(gc.scatter_taps_grouped(gout, i, w, Pm), dm3)
        again5 = torch.equal(gc.taps_dot_grouped(maps, gout, i), dw5)
        del dm_b, dw_b
        log(f"[kernel] scatter_taps_grouped {name}: dmaps bit-equal to scatter_tapdot_grouped's: {same}; "
            f"two launches of each bit-equal: {again}; of row 5: {again5}")
        check(same, f"{name}: scatter_taps_grouped's dmaps differ from the fused kernel's")
        check(again, f"{name}: two launches of row 3 or row 6 differ")
        check(again5, f"{name}: two launches of row 5 differ")

    cases(f"bf16 K={K}", maps32[..., :K].to(bf), gout32[..., :K].to(bf), idx, wts, "bf16")
    cases(f"f32 K={K}", maps32[..., :K], gout32[..., :K], idx, wts, "f32")
    cases("bf16 K=128", maps32.to(bf), gout32.to(bf), idx, wts, "bf16")
    cases("f32 K=128", maps32, gout32, idx, wts, "f32")
    cases("ragged K=13 bf16", maps32[..., :13].to(bf), gout32[..., :13].to(bf), idx, wts, "bf16")
    cases("ragged K=13 f32", maps32[..., :13], gout32[..., :13], idx, wts, "f32")
    # every tap masked, the maps poisoned: sample and dmaps exactly 0, and
    # d_wts still <maps[idx], gout> for every tap
    cases(f"all taps weight 0, poisoned, bf16 K={K}", torch.full((G, P, K), 1e6, device=dev).to(bf),
          gout32[..., :K].to(bf), idx, torch.zeros_like(wts), "zero")
    bad = coords.clone()
    bad[:, ::97, 0] = float("nan")
    bad[:, 5::89, 1] = float("inf")
    bad[:, 7::101] = -float("inf")
    banchors, bwts = anchored_taps(bad, (Hf, Wf))
    cases(f"non-finite coords f32 K={K}", maps32[..., :K], gout32[..., :K], flat_taps(banchors, Wf + 1),
          bwts.contiguous(), "f32")
    # every sample at one coordinate, all four weights live (9/16, 3/16,
    # 3/16, 1/16): the taps of a group fall on four rows, 43,200 taps a
    # row, each row's carries chained across hundreds of chunks. Integer
    # cotangents make every sum exact, whatever its order
    hanchors, hwts = anchored_taps(torch.full_like(coords, 20.25), (Hf, Wf))
    hot = (flat_taps(hanchors, Wf + 1), hwts.contiguous())
    check(bool((hot[1] > 0).all()), "hot rows: every weight live")
    hot_gout = torch.randint(-4, 5, (G, N, K), generator=gen, device=dev).float()
    cases(f"hot rows bf16 K={K}", maps32[..., :K].to(bf), hot_gout.to(bf), *hot, "bf16")
    cases(f"hot rows f32 K={K}", maps32[..., :K], hot_gout, *hot, "f32")
    partition_cases(dev, idx, wts, P)

    # the deformable sampler's shapes (s4, s4*16: B = 2 and 16 at
    # ATTN_STRIDE 4; s1: B = 2 at 1; K = 32), the per-frame backward's (one
    # group a (frame, view), K = 128: pf2 training at batch 2, pf16 the
    # deform query warp serving at 16) and the unfused fusions' (warp_views
    # on the applied encoder projection, K = FEAT_DIM 1280; training at
    # batch 2: G = 14, rows 4 and 3 alone), bf16, and f32 at batch 2
    shapes = {"flag": f"bf16 K={K}", "query": "bf16 K=128"}  # label -> the case's name
    inputs = {}
    for label, (maps, gout, i, w) in grouped_timing_inputs(dev, torch.float32).items():
        if not label.startswith("warp"):
            shapes[label] = f"{label} G={i.shape[0]} N={i.shape[1]} K={maps.shape[2]} bf16"
            cases(shapes[label], maps.to(bf), gout.to(bf), i, w, "bf16", one_sided=label == "G=14 K=1280")
            if label in ("s4", "s1", "pf2"):
                cases(shapes[label][:-4] + "f32", maps, gout, i, w, "f32")
            inputs[label] = (maps.to(bf), gout.to(bf), i, w)
        del maps, gout
    # serving (batch 16): G = 112, an output of 6.2e9 elements, the one
    # launch of the port whose offsets pass 2**32. The kernel runs once on
    # the whole input; its plain version, which would not fit, on 8 groups
    # at a time, every group held
    p_idx, p_wts = inputs["pf16"][2:]
    w_maps = torch.randn((112, P, 1280), generator=gen, device=dev).to(bf)
    out = gc.sample_tiles_grouped(w_maps, p_idx, p_wts)
    torch.cuda.synchronize()
    check(tuple(out.shape) == (112, N, 1280) and out.dtype == bf and out.numel() > 2**32, "unfused G=112: shape/dtype")
    bad = []
    for g0 in range(0, 112, 8):
        ref = gc.sample_tiles_grouped_ref(w_maps[g0:g0 + 8], p_idx[g0:g0 + 8], p_wts[g0:g0 + 8])
        ok = (out[g0:g0 + 8] == ref).all(dim=2).all(dim=1)
        bad += [g0 + j for j in range(8) if not bool(ok[j])]
        del ref
    log(f"[kernel] sample_tiles_grouped unfused G=112 N={N} K=1280 bf16 ({out.numel()} elements out, groups from "
        f"{2**32 // (N * 1280) + 1} on start past 2**32), all 112 groups against the plain version 8 at a time: "
        f"bit-equal {'ok' if not bad else 'FAIL'}")
    check(not bad, f"sample_tiles_grouped at G=112 K=1280 disagrees with the plain version in groups {bad}")
    del out, w_maps
    torch.cuda.empty_cache()

    inputs["flag"] = (maps32[..., :K].to(bf).contiguous(), gout32[..., :K].to(bf).contiguous(), idx, wts)
    inputs["query"] = (maps32.to(bf).contiguous(), gout32.to(bf).contiguous(), idx, wts)
    # each kernel's entry is at a shape its main path gives it; the others follow
    plan = (
        ("scatter_taps_grouped", 686, "dmaps3", ("query", "flag", "s1", "s4", "pf2", "pf16", "G=14 K=1280")),
        ("sample_tiles_grouped", 955, "sample", ("flag", "query", "s4", "s4*16", "s1", "pf2", "pf16", "G=14 K=1280")),
        ("taps_dot_grouped", 1125, "d_wts5", ("s1", "s4", "query")),
        ("scatter_tapdot_grouped", 1288, "dmaps", ("s4", "s4*16", "s1", "flag")),
    )
    entries = []
    for kind, line, key, labels in plan:
        readings = [measure(dev, kind, *inputs[label], errs[f"{key} {shapes[label]}"]) for label in labels]
        entries.append({"name": kind, "route": "cuda", "source": GROUPED_SRC, "replaces": f"{WARP_TPU}:{line}",
                        "launches": None, **readings[0], "other_shapes": readings[1:]})

    sync_free_backward(inputs["s4"])
    return entries


def serve_inputs(cfg, B=16, seed=0):
    """uint8 frames from a numpy seed and ring cameras for ``cfg``."""
    from vsta_tpu_torch.data.synthetic import make_ring_camera

    V, (H, W) = cfg.data.views, cfg.data.img_size
    frames = np.random.default_rng(seed).integers(0, 256, (B, V, H, W, 3), dtype=np.uint8)
    Ks, Rts = zip(*(make_ring_camera(v, V, img_hw=(H, W)) for v in range(V)))
    K = np.broadcast_to(np.stack(Ks), (B, V, 3, 3)).astype(np.float32)
    Rt = np.broadcast_to(np.stack(Rts), (B, V, 4, 4)).astype(np.float32)
    return frames, K, Rt


def check_served(cfg, out, B):
    D, (Hb, Wb) = cfg.eval.max_dets, cfg.model.bev_size
    for k, shape in (("boxes", (B, D, 4)), ("scores", (B, D)), ("valid", (B, D)), ("heatmap", (B, Hb, Wb, 1))):
        check(tuple(out[k].shape) == shape, f"{k} shape {tuple(out[k].shape)} != {shape}")
    for k in ("boxes", "scores", "heatmap"):
        check(bool(torch.isfinite(out[k]).all()), f"{k} not finite")
    check(out["valid"].dtype == torch.bool, "valid dtype")


def all_counters():
    """The kernel wrappers on the model paths, warp_tiles first."""
    from vsta_tpu_torch.kernels import wrappers

    return wrappers(ablation=False)


def with_model_fields(cfg, **fields):
    """``cfg`` with fields of its MODEL section replaced in memory."""
    return dataclasses.replace(cfg, model=dataclasses.replace(cfg.model, **fields))


def reset(counters) -> None:
    for c in counters:
        c.launches = 0


def serve_inputs_perframe(cfg, B=16, seed=0):
    """As :func:`serve_inputs`, with another calibration in every frame."""
    frames, _, _ = serve_inputs(cfg, B, seed)
    K, Rt = perframe_cameras(B, cfg.data.views, tuple(cfg.data.img_size))
    return frames, K, Rt


def wake_sampling_heads(state, seed=7, scale=0.05):
    """Small random kernels for a deformable model's sampling heads, which
    start at zero, where the sampling does not depend on the query."""
    g = torch.Generator().manual_seed(seed)
    for name in ("offsets", "attn"):
        key = f"deform_fusion.{name}.weight"
        if key in state:
            state[key] = scale * torch.randn(state[key].shape, generator=g)
    return state


def heatmaps_kernels_vs_plain(serve, inputs, counters, label, batches=(16, 1)):
    """The same requests with every kernel and with every plain version:
    both sum in f32 and round once, so the heatmaps of a bf16 model may
    differ by no more than 2 bf16 ulps of |ref|, and an f32 model's by no
    more than 16 f32 ulps of |ref| (summation order alone; a bf16 rounding
    anywhere on the path would exceed it by orders of magnitude)."""
    from vsta_tpu_torch.ops import bn_act_cuda, gn_act_cuda
    from vsta_tpu_torch.ops import grouped_cuda as gc
    from vsta_tpu_torch.ops.warp_cuda import warp_tiles, warp_tiles_ref
    from vsta_tpu_torch.ops.warp_views_cuda import warp_views_sum, warp_views_sum_ref

    model = serve.model
    for B in batches:
        args = tuple(a[:B] for a in inputs)
        got = serve(*args)["heatmap"]
        before = [c.launches for c in counters]
        model.warp, model.views_sum, model.grouped = warp_tiles_ref, warp_views_sum_ref, gc.PLAIN
        # BatchNorm and the head look them up a call
        bn_act, bn_act_cuda.bn_act = bn_act_cuda.bn_act, bn_act_cuda.bn_act_ref
        gn_act, gn_act_cuda.gn_act = gn_act_cuda.gn_act, gn_act_cuda.gn_act_ref
        try:
            ref = serve(*args)["heatmap"]
        finally:
            model.warp, model.views_sum, model.grouped = warp_tiles, warp_views_sum, gc.KERNELS
            bn_act_cuda.bn_act, gn_act_cuda.gn_act = bn_act, gn_act
        check([c.launches for c in counters] == before, "the plain-version run launched a kernel")
        diff = (got - ref).abs()
        f32 = model.dtype == torch.float32
        ok = bool((diff <= (16 * f32_ulp(ref) if f32 else 2 * bf16_ulp(ref))).all())
        dtype = str(model.dtype).split(".")[-1]
        log(f"[{label}] {dtype} B={B} heatmap, kernels vs plain versions: max_abs_diff={float(diff.max()):.3e}, "
            f"largest in f32 ulps of |ref| {float((diff / f32_ulp(ref)).max()):.1f} "
            f"(<= {'16 f32' if f32 else '2 bf16'} ulps of |ref|) {'ok' if ok else 'FAIL'}")
        check(ok, f"{label}: {dtype} heatmap at batch {B} with the kernels disagrees with the plain versions")


def kernel_device_ms(fn, args, kernel, calls=5):
    """Mean device time a launch of the kernels whose name holds ``kernel``
    over the launches the profiler recorded in ``calls`` calls of fn (late
    in the full run it records fewer): the kernel without the gaps between
    launches that events around calls as short as a launch include. None
    if the profiler saw no such kernel."""
    from torch.profiler import ProfilerActivity, profile

    fn(*args)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn(*args)
        torch.cuda.synchronize()
    seen = [e for e in prof.key_averages() if e.device_type == torch.autograd.DeviceType.CUDA and kernel in e.key]
    device_us = sum(getattr(e, "self_device_time_total", None) or getattr(e, "self_cuda_time_total", 0) for e in seen)
    return device_us / 1e3 / sum(e.count for e in seen) if seen else None


def train_batch(cfg, B, seed):
    """uint8 frames, ring cameras and about 12 boxes a frame inside the BEV
    bounds, from a numpy seed."""
    from vsta_tpu_torch.data.synthetic import make_ring_camera

    rng = np.random.default_rng(seed)
    V, (H, W) = cfg.data.views, cfg.data.img_size
    x_min, x_max, y_min, y_max = cfg.model.bev_bounds
    Ks, Rts = zip(*(make_ring_camera(v, V, img_hw=(H, W)) for v in range(V)))
    boxes = np.zeros((B, cfg.loss.max_objects, 4), np.float32)
    n = min(12, cfg.loss.max_objects)
    boxes[:, :n, 0] = rng.uniform(x_min + 0.5, x_max - 0.5, (B, n))
    boxes[:, :n, 1] = rng.uniform(y_min + 0.5, y_max - 0.5, (B, n))
    boxes[:, :n, 2:] = rng.uniform(0.4, 0.8, (B, n, 2))
    return {
        "images": rng.integers(0, 256, (B, V, H, W, 3), dtype=np.uint8),
        "K": np.broadcast_to(np.stack(Ks), (B, V, 3, 3)).astype(np.float32),
        "Rt": np.broadcast_to(np.stack(Rts), (B, V, 4, 4)).astype(np.float32),
        "boxes_world": boxes,
        "num_boxes": np.full((B,), n, np.int32),
    }


def grad_distance(a, b):
    """Per parameter, ||a - b|| / max(||b||, 1e-2 * the largest ||b||),
    largest first, as (value, parameter) pairs. The floor keeps gradients
    that are 0 up to rounding (a BatchNorm bias ahead of a 1x1 conv and
    another BatchNorm) from dividing noise by noise."""
    norms = {k: float(v.float().norm()) for k, v in b.items()}
    floor = 1e-2 * max(norms.values())
    return sorted(((float((a[k].float() - b[k].float()).norm()) / max(norms[k], floor), k) for k in b),
                  reverse=True)


def train_batch_perframe(cfg, B, seed):
    """As :func:`train_batch`, with another calibration in every frame
    (and in every batch)."""
    batch = train_batch(cfg, B, seed)
    batch["K"], batch["Rt"] = perframe_cameras(B, cfg.data.views, tuple(cfg.data.img_size), seed=100 + seed)
    return batch


def copy_check(dev, B=16):
    """A batch-16 flagship frame set to the card pageable (as serving.py
    copies it), through the Prefetcher's put (one side stream and two) and
    from pinned memory: each lands, the pinned copy holding the frames."""
    from vsta_tpu_torch.data.pipeline import DevicePut

    frames = np.random.default_rng(0).integers(0, 256, (B, 7, 270, 480, 3), dtype=np.uint8)
    consumer = torch.cuda.current_stream(dev)

    def through(put):
        out, event = put({"images": frames}, consumer)
        consumer.wait_event(event)
        return out["images"]

    pinned = torch.from_numpy(frames).pin_memory().to(dev, non_blocking=True)
    outs = [torch.as_tensor(frames, device=dev), through(DevicePut(dev)), through(DevicePut(dev, h2d_streams=2)), pinned]
    torch.cuda.synchronize()
    for out in outs:
        check(out.shape == frames.shape and out.device.type == "cuda", "copy landed")
    check(torch.equal(pinned.cpu(), torch.from_numpy(frames)), "the pinned copy changed the frames")


def resume_check(dev, cfg, save_dir):
    """Three train-step calls (with ACCUM_STEPS 2: an update, then a call
    whose gradients wait in the accumulator), save, one more call; a fresh
    state restored from the file and given the same fourth call must be
    bit-equal: parameters, BatchNorm statistics, Adam's state, the
    accumulator and the counts."""
    from vsta_tpu_torch.training.checkpoint import CheckpointManager
    from vsta_tpu_torch.training.state import create_state, make_train_step

    step = make_train_step(cfg)
    batches = [train_batch(cfg, cfg.data.batch_size, seed) for seed in range(4)]
    ckpt = CheckpointManager(str(save_dir))
    a = create_state(cfg, seed=0, device=dev, steps_per_epoch=4)
    for b in batches[:3]:
        step(a, b)
    ckpt.save("resume_check", a, epoch=0, best_f1=0.0)
    step(a, batches[3])
    b_state = create_state(cfg, seed=1, device=dev, steps_per_epoch=4)
    ckpt.restore("resume_check", b_state)
    step(b_state, batches[3])

    def flat(state):
        opt = state.opt_state
        out = {f"model.{k}": v for k, v in state.model.state_dict().items()}
        out.update({f"acc.{k}": v for k, v in opt.acc.items()})
        for i, st in opt.inner.state_dict()["state"].items():
            out.update({f"adam.{i}.{k}": torch.as_tensor(v) for k, v in st.items()})
        return out, (opt.mini_step, opt.count, state.step)

    (fa, ca), (fb, cb) = flat(a), flat(b_state)
    differ = [k for k in fa if not torch.equal(fa[k], fb[k])]
    log(f"[loop] resume on the card: save after 3 calls, restore into a fresh state, 1 call: {len(fa)} tensors "
        f"(parameters, BatchNorm statistics, Adam moments and steps, accumulator), counts {cb} against {ca}; "
        f"{len(differ)} differ from 4 uninterrupted calls {differ[:4]}")
    check(not differ and ca == cb and any(k.startswith("adam.") for k in fa), "resume on the card is not bit-equal")
    del a, b_state
    torch.cuda.empty_cache()


def loop_phase(dev, cfg_path=FLAGSHIP, tree=None, timeout=600):
    """The training loop end to end: ``run_training`` of ``cfg_path`` (2
    epochs) on a synthetic tree (7 views of 1080x1920, 10 frames) in a
    temporary directory; the train --resume, evaluate, inference, export
    and serve CLIs as subprocesses; the frame-set copies; resume on the
    card. Returns the launches by kernels-line entry and no readings."""
    import shutil
    import tempfile

    import yaml

    from vsta_tpu_torch.config import from_dict
    from vsta_tpu_torch.data.synthetic import generate_synthetic_wildtrack
    from vsta_tpu_torch.data.wildtrack import WildtrackDataset
    from vsta_tpu_torch.training.loop import run_training

    tree = tree or dict(n_frames=10, n_views=7, n_people=12, img_hw=(1080, 1920))
    tmp = Path(tempfile.mkdtemp(prefix="vsta_loop_"))
    try:
        root = generate_synthetic_wildtrack(tmp / "wildtrack", **tree)
        raw = yaml.safe_load(Path(cfg_path).read_text())
        raw["DATA"]["DATA_ROOT"] = str(root)
        raw["TRAIN"]["EPOCHS"] = 2
        raw["EVAL"]["INTERVAL"] = 1
        cfg = from_dict(raw)
        work = tmp / "work"
        train_ds = WildtrackDataset(cfg, train=True)
        val_ds = WildtrackDataset(cfg, train=False, cache_from=train_ds)
        counters = all_counters()
        reset(counters)
        metrics = run_training(cfg, work_dir=str(work), dataset=train_ds, val_dataset=val_ds, device=dev)
        launches = {c.__name__: c.launches for c in counters}
        save_dir = work / cfg.runtime.save_dir
        records = [json.loads(x) for x in (save_dir / "metrics.jsonl").read_text().splitlines()]
        scalars = [json.loads(x) for x in (save_dir / "scalars.jsonl").read_text().splitlines()]
        losses = [r["value"] for r in scalars if r["tag"] == "train/loss_iter"]
        log(f"[loop] run_training returned {json.dumps({k: round(v, 4) for k, v in metrics.items()})}; "
            f"launches {json.dumps(launches)}; decoders {sorted(train_ds.decoders)}")
        check([r["epoch"] for r in records] == [0, 1] and all(r.get("n_frames") == 2.0 for r in records),
              f"two epochs, each with an eval of 2 frames: {records}")
        check(len(losses) == 8 and all(math.isfinite(x) for x in losses), f"finite losses, 4 steps an epoch: {losses}")
        check((save_dir / "last").exists() and (save_dir / "best").exists(), "last and best checkpoints")
        for name in ("warp_tiles", "sample_tiles_grouped", "scatter_taps_grouped"):
            check(launches[name] > 0, f"{name} was not launched inside the loop")
        del train_ds, val_ds
        torch.cuda.empty_cache()

        raw["TRAIN"]["EPOCHS"] = 3
        cfg3 = tmp / "three.yaml"
        cfg3.write_text(yaml.safe_dump(raw))
        # inference: the same model, writing to the temporary directory, with a
        # threshold that random weights clear, so that the tracker has detections
        infer_cfg = tmp / "infer.yaml"
        infer_cfg.write_text(yaml.safe_dump({**raw, "RUNTIME": {**raw["RUNTIME"], "OUTPUT_DIR": str(tmp / "outputs")},
                                             "EVAL": {**raw["EVAL"], "CONF_THRESH": INFER_CONF_THRESH}}))
        env = {**os.environ, "PYTHONPATH": str(ROOT)}
        runs = {
            "train --resume": ["vsta_tpu_torch.train", "--config", str(cfg3), "--work_dir", str(work), "--resume"],
            "evaluate --split all": ["vsta_tpu_torch.evaluate", "--config", str(cfg3), "--checkpoint",
                                     str(save_dir / "best"), "--split", "all"],
            "inference --track --clips 2": ["vsta_tpu_torch.inference", "--config", str(infer_cfg), "--checkpoint",
                                            str(save_dir / "best"), "--track", "--clips", "2"],
        }
        for label, args in runs.items():
            r = subprocess.run([sys.executable, "-m", *args], capture_output=True, text=True, timeout=timeout,
                               env=env, cwd=str(ROOT))
            lines = [x for x in r.stdout.splitlines() if x.startswith(("[resume]", "[done]", "[ckpt]", "[time]", "Saved"))]
            log(f"[loop] {label}: exit {r.returncode}; " + " | ".join(lines))
            check(r.returncode == 0, f"{label} failed:\n{r.stdout[-3000:]}\n{r.stderr[-3000:]}")
            if label.startswith("train"):
                check("[resume] from epoch 2" in r.stdout and "[done]" in r.stdout, f"{label}: no resume from epoch 2")
            elif label.startswith("inference"):
                inference_outputs(tmp / "outputs", tree["n_frames"])
            else:
                block = json.loads(r.stdout[r.stdout.index("{"):])
                log(f"[loop] evaluate: {json.dumps(block)}")
                check(block["n_frames"] == float(tree["n_frames"]), f"evaluate scored {block['n_frames']} frames")
        serve_cli(tmp, infer_cfg, save_dir / "best", env, tree["n_frames"], timeout)
        copy_check(dev)
        resume_check(dev, cfg, save_dir)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return tally({}, launches), []


INFER_CONF_THRESH = 0.05  # the untrained heatmap sits near sigmoid(-2.19) = 0.10


def serve_cli(tmp, cfg_path, ckpt, env, n_frames, timeout):
    """``python -m vsta_tpu_torch.export`` of the loop's checkpoint at batch
    2, then ``python -m vsta_tpu_torch.serve --track --clips 2`` on the
    loop's tree, synchronous and with ``--overlap``: the two runs' frame
    JSONs must be identical."""
    artifact = Path(tmp) / "loop_b2.pt"
    runs = {"export --batch 2": ["vsta_tpu_torch.export", "--config", str(cfg_path), "--checkpoint", str(ckpt),
                                 "--out", str(artifact), "--batch", "2"]}
    for mode in ("sync", "overlap"):
        runs[f"serve --track --clips 2 ({mode})"] = [
            "vsta_tpu_torch.serve", "--artifact", str(artifact), "--track", "--clips", "2", "--out",
            str(Path(tmp) / f"served_{mode}")] + (["--overlap"] if mode == "overlap" else [])
    for label, args in runs.items():
        r = subprocess.run([sys.executable, "-m", *args], capture_output=True, text=True, timeout=timeout,
                           env=env, cwd=str(ROOT))
        lines = [x for x in r.stdout.splitlines() if x.startswith(("[ckpt]", "[export]", "[serve]", "Saved"))]
        log(f"[loop] {label}: exit {r.returncode}; " + " | ".join(lines))
        check(r.returncode == 0, f"{label} failed:\n{r.stdout[-3000:]}\n{r.stderr[-3000:]}")
    outs = {}
    for mode in ("sync", "overlap"):
        files = sorted((Path(tmp) / f"served_{mode}").glob("frame_*.json"))
        outs[mode] = {f.name: json.loads(f.read_text()) for f in files}
    n_tracks = sum(len(d["tracks"]) for d in outs["sync"].values())
    same = outs["sync"] == outs["overlap"]
    log(f"[serve-cli] {len(outs['sync'])} frame JSONs a run, clips {sorted({d['clip'] for d in outs['sync'].values()})}, "
        f"{n_tracks} confirmed tracks; --overlap identical to the synchronous run: {same}")
    check(len(outs["sync"]) == n_frames and same, "[serve-cli] --overlap output differs from the synchronous run")


def inference_outputs(out_dir, n_frames):
    """The inference CLI's output with --track --clips 2: a JSON a frame
    with finite boxes and scores, its clip and its tracks; detections and
    confirmed tracks in both clips."""
    files = sorted(Path(out_dir).glob("frame_*.json"))
    frames = [json.loads(f.read_text()) for f in files]
    check(len(frames) == n_frames, f"[inference] {len(frames)} frame files for {n_frames} frames")
    check(all({"frame_idx", "boxes", "scores", "tracks", "clip"} <= set(d) for d in frames),
          "[inference] a frame file lacks a key")
    check(all(np.isfinite(np.asarray(d["boxes"] or [0.0])).all() for d in frames), "[inference] non-finite boxes")
    clips = sorted({d["clip"] for d in frames})
    n_tracks = sum(len(d["tracks"]) for d in frames)
    log(f"[inference] {len(frames)} frame files, clips {clips}, {sum(len(d['boxes']) for d in frames)} detections, "
        f"{n_tracks} confirmed tracks over all frames, track ids {sorted({t['id'] for d in frames for t in d['tracks']})}")
    check(clips == [0, 1], f"[inference] clips {clips}")
    check(all(any(d["tracks"] for d in frames if d["clip"] == c) for c in clips),
          "[inference] a clip has no confirmed track")


def determinism_phase(dev):
    """The deform family's residual upsample: its backward twice at the
    flagship's shape, bit for bit. (The spread of a whole call's gradients
    over two runs is the training cases' "kernels run twice" reading.)"""
    from vsta_tpu_torch.ops.resize import resize_bilinear

    g = torch.Generator(device=dev).manual_seed(12)
    res = torch.randn((16, 30, 90, 128), generator=g, device=dev)
    gout = torch.randn((16, *BEV_HW, 128), generator=g, device=dev)
    grads = []
    for _ in range(2):
        leaf = res.clone().requires_grad_(True)
        resize_bilinear(leaf.permute(0, 3, 1, 2), BEV_HW).permute(0, 2, 3, 1).backward(gout)
        grads.append(leaf.grad)
    same = torch.equal(*grads)
    log(f"[determinism] residual upsample (resize_bilinear) backward, f32 [16, 30, 90, 128] -> {BEV_HW}, run twice: bit-equal {same}")
    check(same, "the residual upsample's backward differs between two runs")


SMALL_DEFORM = {"FUSION": "deform_attn", "WARP_IMPL": "fused", "ATTN_HEADS": 2, "ATTN_POINTS": 2, "ATTN_STRIDE": 2}


# the MODEL fields of the small f32 models, by family
SMALL_FAMILIES = {
    "concat": {},
    "deform_attn": SMALL_DEFORM,
    "concat per-frame": {"STATIC_CAMERAS": False},
    "deform_attn per-frame": {**SMALL_DEFORM, "STATIC_CAMERAS": False},
    "attn": {"FUSION": "attn", "WARP_IMPL": "gather"},
    "max": {"FUSION": "max", "WARP_IMPL": "gather"},
}


def small_model(family, proj_ch, **sections):
    """A small f32 model of ``family`` (3 views of 64x96): its config,
    random weights (a deformable one with non-zero kernels in its sampling
    heads, so that the sampling depends on the query) and cameras for 2
    frames (drawn per frame for a per-frame family, else one ring)."""
    from vsta_tpu_torch.config import from_dict
    from vsta_tpu_torch.convert import init_state_dict

    cfg = from_dict({
        "DATA": {"IMG_SIZE": [3, 64, 96], "VIEWS": 3},
        "MODEL": {"BACKBONE": "efficientnet_b0", "FEAT_DIM": 48, "BEV_SIZE": [32, 16, 48],
                  "BEV_BOUNDS": [-12.0, 12.0, -4.0, 4.0], "BEV_PROJ_CH": proj_ch,
                  "HEAD_MID1": 64, "HEAD_MID2": 32, "WARP_IMPL": "pallas", **SMALL_FAMILIES[family]},
        "RUNTIME": {"USE_AMP": False}, **sections,
    })
    if "per-frame" in family:
        cameras = perframe_cameras(2, 3, (64, 96), seed=3, radius=(8.0, 12.0), height=(3.0, 5.0))
    else:
        cameras = perframe_cameras(2, 3, (64, 96), radius=(10.0, 10.0), height=(4.0, 4.0))
    return cfg, wake_sampling_heads(init_state_dict(cfg, seed=1), seed=1, scale=0.3), cameras


def small_train_phase(dev, family="concat"):
    """One f32 train step of a small model on the card against the CPU."""
    from vsta_tpu_torch.training.state import create_state, make_train_step

    cfg, sd, cameras = small_model(family, 48, DATA={"BATCH_SIZE": 2, "IMG_SIZE": [3, 64, 96], "VIEWS": 3},
                                   LOSS={"MAX_OBJECTS": 16})
    batch = train_batch(cfg, 2, seed=5)
    if "per-frame" in family:
        batch["K"], batch["Rt"] = cameras
    out = {}
    for where in ("cpu", dev):
        state = create_state(cfg, sd, device=where, steps_per_epoch=10)
        grads = {}
        update = state.tx.update

        def keep(opt_state, model, g, update=update, grads=grads):
            grads.update({k: v.detach().cpu() for k, v in g.items()})
            return update(opt_state, model, g)

        state.tx.update = keep
        metrics = make_train_step(cfg)(state, batch)
        out[str(where)] = ({k: float(v) for k, v in metrics.items()}, grads)
    (m_cpu, g_cpu), (m_gpu, g_gpu) = out["cpu"], out[str(dev)]
    loss_err = max(abs(m_gpu[k] - m_cpu[k]) / abs(m_cpu[k]) for k in m_cpu)
    dist, dist_k = grad_distance(g_gpu, g_cpu)[0]
    log(f"[small] {family} f32 train step, card vs CPU: losses and grad_norm max rel diff {loss_err:.3e} (<= 1e-4); "
        f"gradients worst per-parameter ||a-b|| / max(||b||, 1e-2 max||b||) = {dist:.3e} ({dist_k}) "
        f"(<= 5e-3; TF32 off)")
    check(loss_err <= 1e-4 and dist <= 5e-3, f"small {family} f32 train step on the card disagrees with the CPU")


def small_model_phase(dev, family="concat"):
    """A small f32 model on the card against the same model on the CPU."""
    from vsta_tpu_torch.serving import build_serving_fn

    cfg, state, (K, Rt) = small_model(family, 32)
    frames = np.random.default_rng(1).integers(0, 256, (2, 3, 64, 96, 3), dtype=np.uint8)
    cpu = build_serving_fn(cfg, state, device="cpu")(frames, K, Rt)
    gpu = build_serving_fn(cfg, state, device=dev)(frames, K, Rt)
    d = float((gpu["heatmap"].cpu() - cpu["heatmap"]).abs().max())
    log(f"[small] {family} f32 heatmap, card vs CPU: max_abs_diff={d:.3e} (<= 1e-4; TF32 off)")
    check(d <= 1e-4, f"small {family} f32 model on the card disagrees with the CPU")


def grouped_timing_inputs(dev, dtype=torch.bfloat16):
    """The grouped sampler's timed shapes (PERF.md's table), label ->
    (maps, gout, idx, wts): the flagship warp's taps at K = 82 and 128, the
    deformable sampler's (s4, s4*16, s1), the per-frame warp's (pf2, pf16)
    and the unfused fusions' G = 14 at K = 1,280; maps and cotangents
    random, in ``dtype``."""
    from vsta_tpu_torch.ops.warp import anchored_taps, flat_taps

    Hf, Wf = GROUPED_HW
    P = (Hf + 1) * (Wf + 1)
    gen = torch.Generator(device=dev).manual_seed(9)

    def rand(G, N, K):
        return (torch.randn((G, P, K), generator=gen, device=dev).to(dtype),
                torch.randn((G, N, K), generator=gen, device=dev).to(dtype))

    anchors, wts = anchored_taps(flagship_lut(dev), (Hf, Wf))
    flag = (flat_taps(anchors, Wf + 1), wts.contiguous())
    N = flag[0].shape[1]
    shapes = {f"warp K={GROUPED_K}": (*rand(GROUPED_G, N, GROUPED_K), *flag), "warp K=128": (*rand(GROUPED_G, N, 128), *flag)}
    for label, B, stride in (("s4", 2, 4), ("s4*16", 16, 4), ("s1", 2, 1)):
        i, w = deform_taps(dev, B, stride)
        shapes[label] = (*rand(i.shape[0], i.shape[1], 32), i, w)
    for label, Bp in (("pf2", 2), ("pf16", 16)):
        a, w = anchored_taps(flagship_lut(dev, Bp).reshape(Bp * 7, N, 2), (Hf, Wf))
        shapes[label] = (*rand(Bp * 7, N, 128), flat_taps(a, Wf + 1), w.contiguous())
    shapes["G=14 K=1280"] = (*rand(14, N, 1280), *shapes["pf2"][2:])
    return shapes


def baseline_phase(dev, base_dir):
    """warp_tiles, warp_views_sum, sample_tiles_grouped and taps_dot_grouped
    of another checkout (``--baseline DIR``, with this one's C interface;
    built here with its nvcc flags, all at once) timed beside this one's
    in turns (base, this, this, base) at the main shapes, outputs
    compared."""
    import ctypes

    from vsta_tpu_torch import kernels
    from vsta_tpu_torch.ops import grouped_cuda as gc
    from vsta_tpu_torch.ops.warp import precompute_warp_lut
    from vsta_tpu_torch.ops.warp_cuda import warp_tiles
    from vsta_tpu_torch.ops.warp_views_cuda import warp_views_sum
    from vsta_tpu_torch.utils.timing import cuda_ms

    kernels.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    builds = {}
    for name in ("warp_tiles", "warp_views_sum", "grouped_taps"):
        src = Path(base_dir) / "vsta_tpu_torch" / "csrc" / f"{name}.cu"
        lib = kernels.BUILD_DIR / f"libbaseline-{name}.so"
        proc = subprocess.Popen([kernels._nvcc(), *kernels.NVCC_FLAGS, "-o", str(lib), str(src)],
                                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        builds[name] = (proc, lib)
    base = {}
    for name, (proc, lib) in builds.items():
        text = proc.communicate()[0]
        check(proc.returncode == 0, f"baseline build of {name} failed:\n{text}")
        base[name] = ctypes.CDLL(str(lib))
        if name == "grouped_taps":
            base[name].grouped_sample_launch.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 6 + [ctypes.c_void_p]
            base[name].grouped_taps_dot_launch.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
        else:
            getattr(base[name], f"{name}_launch").argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 7 + [ctypes.c_void_p]
    V, P, Wb = 7, 34 * 60, BEV_HW[1]
    idx, wts = precompute_warp_lut(flagship_lut(dev), (34, 60))
    N = idx.shape[1]
    pidx, pwts = precompute_warp_lut(flagship_lut(dev, 16), (34, 60))
    g = torch.Generator(device=dev).manual_seed(0)
    f32 = torch.randn((V, P, WARP_K), generator=g, device=dev)
    pf32 = torch.randn((16, V, P, 128), generator=g, device=dev)
    code = {torch.float32: 0, torch.bfloat16: 1}

    def run_base(name, feats, i, w, out_dtype):
        fn = getattr(base[name], f"{name}_launch")
        lead = (N, feats.shape[-1]) if name == "warp_tiles" else (feats.shape[0], N, feats.shape[-1])
        out = torch.empty(lead, dtype=out_dtype, device=dev)
        if name == "warp_tiles":
            args = [V, P, N, feats.shape[-1], code[feats.dtype], code[out_dtype]]
        else:
            args = [feats.shape[0], V, P, N, feats.shape[-1], code[feats.dtype]]
        rc = fn(feats.data_ptr(), i.data_ptr(), w.data_ptr(), out.data_ptr(), *args, Wb,
                torch.cuda.current_stream(dev).cuda_stream)
        check(rc == 0, f"baseline {name} launch failed ({rc})")
        return out

    def run_grouped(lib, kind, maps, gout, i, w):
        """Row 4 or row 5 of ``lib`` through its C entry point, as the
        wrapper calls it (4 taps a sample): both sides of a turn take the
        same host path, so that at shapes as short as a launch the kernels,
        not the wrappers' checks, are compared."""
        Gm, Pm, Km = maps.shape
        stream = torch.cuda.current_stream(dev).cuda_stream
        if kind == "sample_tiles_grouped":
            out = torch.empty((Gm, i.shape[1], Km), dtype=maps.dtype, device=dev)
            rc = lib.grouped_sample_launch(
                maps.data_ptr(), i.data_ptr(), w.data_ptr(), out.data_ptr(), Gm, Pm, i.shape[1], Km,
                4, code[maps.dtype], stream)
        else:
            out = torch.empty((Gm, i.shape[1], 4), dtype=torch.float32, device=dev)
            rc = lib.grouped_taps_dot_launch(
                maps.data_ptr(), gout.data_ptr(), i.data_ptr(), out.data_ptr(), Gm, Pm, i.shape[1], Km, code[maps.dtype],
                stream)
        check(rc == 0, f"{kind} launch failed ({rc})")
        return out

    cases = [("warp_tiles", f"bf16 K={K}", f32[..., :K].to(torch.bfloat16).contiguous(), idx, wts, torch.bfloat16)
             for K in (WARP_K, TRAIN_K, 128)]
    cases.append(("warp_tiles", f"f32 K={WARP_K}", f32, idx, wts, torch.float32))
    cases += [("warp_views_sum", f"bf16 B={B}", pf32[:B].to(torch.bfloat16).contiguous(), pidx[:B].contiguous(),
               pwts[:B].contiguous(), torch.float32) for B in (16, 2, 1)]
    cases.append(("warp_views_sum", "f32 B=16", pf32, pidx, pwts, torch.float32))
    table = {}

    def turns(key, this, other, diff, rule, kernel=None):
        t = [cuda_ms(f, warmup=3, iters=20) for f in (other, this, this, other)]
        table[key] = {"base_ms": [round(t[0], 4), round(t[3], 4)], "ms": [round(t[1], 4), round(t[2], 4)],
                      "max_abs_diff": diff}
        dev_s = ""
        if kernel:  # the kernels alone, without the gaps between launches
            d = [kernel_device_ms(f, (), kernel) for f in (other, this)]
            table[key].update(base_device_ms=d[0], device_ms=d[1])
            dev_s = f"; device base {d[0]} ms, this {d[1]} ms (profiler, 5 calls each)"
        log(f"[baseline] {key}: base {t[0]:.4f} / {t[3]:.4f} ms, this {t[1]:.4f} / {t[2]:.4f} ms "
            f"(base, this, this, base), outputs differ by {diff:.3e}{rule}{dev_s}")

    for name, label, feats, i, w, out_dtype in cases:
        if name == "warp_tiles":
            this = lambda: warp_tiles(feats, i, w, out_dtype=out_dtype, grid_w=Wb)
        else:
            this = lambda: warp_views_sum(feats, i, w, grid_w=Wb)
        other = lambda: run_base(name, feats, i, w, out_dtype)
        turns(f"{name} {label}", this, other, float((this().float() - other().float()).abs().max()), "")
    del f32, pf32
    # rows 4 and 5 at every shape of PERF.md's table (bf16), and row 5 in
    # f32 at s1: row 4's outputs must agree bit for bit, row 5's within
    # 1e-5 max (both sum in f32, in other orders)
    grouped = grouped_timing_inputs(dev)
    runs = [(kind, label, inputs) for label, inputs in grouped.items()
            for kind in ("sample_tiles_grouped", "taps_dot_grouped")]
    s1 = grouped["s1"]
    runs.append(("taps_dot_grouped", "s1 f32", (s1[0].float(), s1[1].float(), *s1[2:])))
    mine = gc._library()
    for kind, label, (maps, gout, i, w) in runs:
        this = lambda: run_grouped(mine, kind, maps, gout, i, w)
        other = lambda: run_grouped(base["grouped_taps"], kind, maps, gout, i, w)
        a, b = this(), other()
        diff = float((a.float() - b.float()).abs().max())
        if kind == "sample_tiles_grouped":
            check(torch.equal(a, b), f"baseline {kind} {label}: outputs differ ({diff:.3e})")
            rule = " (bit-equal)"
        else:
            tol = 1e-5 * float(b.abs().max())
            check(diff <= tol, f"baseline {kind} {label}: outputs differ by {diff:.3e} > {tol:.3e}")
            rule = f" (<= 1e-5*max = {tol:.3e})"
        del a, b
        turns(f"{kind} {label} G={maps.shape[0]} N={i.shape[1]} K={maps.shape[2]}", this, other, diff, rule,
              KERNEL_NAMES[kind])
    print(json.dumps({"baseline": str(base_dir), "times": table}))


RESNET_CONFIGS = {
    "sanity": ROOT / "configs" / "wildtrack_sanity.yaml",
    "resnet50": ROOT / "configs" / "wildtrack_v1_resnet50.yaml",
    "ms_max": ROOT / "configs" / "wildtrack_ms_max.yaml",
}


def capturing_kernels(store):
    """The grouped kernels, with rows 4, 6 and 3 keeping the inputs of
    their first call in ``store``: the shapes a model path gives them."""
    from vsta_tpu_torch.ops import grouped_cuda as gc

    def sample(maps, idx, wts):
        store.setdefault("sample_tiles_grouped", (maps.detach(), idx, wts.detach()))
        return gc.sample_tiles_grouped(maps, idx, wts)

    def scatter_tapdot(maps, gout, idx, wts, *rest):
        store.setdefault("scatter_tapdot_grouped", (maps.detach(), gout.detach(), idx, wts.detach()))
        return gc.scatter_tapdot_grouped(maps, gout, idx, wts, *rest)

    def scatter_taps(gout, idx, wts, P, *rest):
        store.setdefault("scatter_taps_grouped", (gout.detach(), idx, wts.detach(), P))
        return gc.scatter_taps_grouped(gout, idx, wts, P, *rest)

    return gc.KERNELS._replace(sample=sample, scatter_tapdot=scatter_tapdot, scatter_taps=scatter_taps)


def capturing_warp(store):
    """warp_tiles, keeping the inputs of its first call in ``store``: the
    shape a model path gives it."""
    from vsta_tpu_torch.ops.warp_cuda import warp_tiles

    def warp(feats, idx, wts, *, out_dtype, grid_w=None):
        store.setdefault("warp_tiles", (feats.detach(), idx, wts.detach(), out_dtype, grid_w))
        return warp_tiles(feats, idx, wts, out_dtype=out_dtype, grid_w=grid_w)

    return warp


def captured_readings(dev, label, store):
    """warp_tiles and rows 4, 6 and 3 on the inputs a model call gave
    them: each against its plain version (warp_tiles within one ulp of its
    output dtype as in kernel_phase, row 4 bit-equal, rows 6 and 3 within
    1e-5 of max|ref|), then its time and the bound. The warp's reading is
    keyed by its entry in the kernels line."""
    from vsta_tpu_torch.ops import grouped_cuda as gc
    from vsta_tpu_torch.ops.warp_cuda import warp_tiles, warp_tiles_ref

    readings = {}
    if "warp_tiles" in store:
        feats, idx, wts, out_dtype, grid_w = store["warp_tiles"]
        out = warp_tiles(feats, idx, wts, out_dtype=out_dtype, grid_w=grid_w)
        rule = "bf16" if out_dtype == torch.bfloat16 else "f32"
        err = hold(f"warp_tiles {label}", out, warp_tiles_ref(feats, idx, wts, out_dtype=out_dtype), rule)
        check(torch.equal(out, warp_tiles(feats, idx, wts, out_dtype=out_dtype, grid_w=grid_w)),
              f"warp_tiles {label}: two launches differ")
        name = WARP_ENTRY[out_dtype]
        readings[name] = {"path": label, **warp_reading(dev, name, feats, idx, wts, out_dtype, grid_w, err)}
        del out
    if "sample_tiles_grouped" in store:
        maps, idx, wts = store["sample_tiles_grouped"]
        out = gc.sample_tiles_grouped(maps, idx, wts)
        err = hold(f"sample_tiles_grouped {label}", out, gc.sample_tiles_grouped_ref(maps, idx, wts), "exact")
        readings["sample_tiles_grouped"] = {"path": label, **measure(dev, "sample_tiles_grouped", maps, out, idx, wts, err)}
        del out
    if "scatter_tapdot_grouped" in store:
        maps, gout, idx, wts = store["scatter_tapdot_grouped"]
        dm, dw = gc.scatter_tapdot_grouped(maps, gout, idx, wts)
        ref_dm, ref_dw = gc.scatter_tapdot_grouped_ref(maps, gout, idx, wts)
        err = max(hold(f"scatter_tapdot_grouped dmaps {label}", dm, ref_dm, "f32"),
                  hold(f"scatter_tapdot_grouped d_wts {label}", dw, ref_dw, "f32"))
        readings["scatter_tapdot_grouped"] = {
            "path": label, **measure(dev, "scatter_tapdot_grouped", maps, gout, idx, wts, err)}
        del dm, dw, ref_dm, ref_dw
    if "scatter_taps_grouped" in store:
        gout, idx, wts, P = store["scatter_taps_grouped"]
        dm = gc.scatter_taps_grouped(gout, idx, wts, P)
        err = hold(f"scatter_taps_grouped {label}", dm, gc.scatter_taps_grouped_ref(gout, idx, wts, P), "f32")
        shape_of = torch.empty((gout.shape[0], P, gout.shape[2]), dtype=gout.dtype, device=dev)
        readings["scatter_taps_grouped"] = {
            "path": label, **measure(dev, "scatter_taps_grouped", shape_of, gout, idx, wts, err)}
        del dm, shape_of
    store.clear()
    torch.cuda.empty_cache()
    return readings


def case_config(path, fields, f32=False):
    """``path``'s config, MODEL ``fields`` replaced (``f32``: no AMP)."""
    from vsta_tpu_torch.config import load_config

    cfg = with_model_fields(load_config(str(path)), **fields)
    return dataclasses.replace(cfg, runtime=dataclasses.replace(cfg.runtime, use_amp=False)) if f32 else cfg


def check_dispatch(cfg, B, dtype):
    """The flagship's warp at batch ``B`` is resident in bf16, windowed in f32."""
    from vsta_tpu_torch.ops.warp_cuda import warp_out_dtype

    V, (H, W) = cfg.data.views, cfg.data.img_size
    P = math.ceil(H / 8) * math.ceil(W / 8)  # the stride-8 map of OUT_INDEX 2
    check(warp_out_dtype(V, P, B * cfg.model.bev_proj_ch, dtype) == dtype, "dispatch")


def tally(total, launches, f32=False):
    """``launches`` added into ``total`` by kernels-line entry (WARP_ENTRY)."""
    for name, n in launches.items():
        name = WARP_ENTRY[torch.float32 if f32 else torch.bfloat16] if name == "warp_tiles" else name
        total[name] = total.get(name, 0) + n
    return total


class ServeCase(NamedTuple):
    """One serving case (:func:`serve_case`): ``path`` with MODEL ``fields``
    replaced (``f32``: no AMP); ``requests`` at each of ``batches``, each
    launching the kernels of ``a_request`` and no other; the heatmaps at
    ``heatmaps``; ``capture``: the grouped kernels' first inputs kept;
    ``expect``: MODEL fields the config must have."""
    path: Path
    a_request: dict
    fields: dict = {}
    f32: bool = False
    batches: tuple = (16, 1)
    requests: int = 2
    heatmaps: tuple = (16, 1)
    capture: bool = False
    expect: dict = {}


SERVE_CASES = {
    "serve": ServeCase(FLAGSHIP, {"warp_tiles": 1, "bn_act": BN_ACT_A_REQUEST["flagship"],
                                  "gn_act": GN_ACT_A_REQUEST["flagship"]}),
    # batch 16 in f32 takes the windowed dispatch (f32 out), and the plain BatchNorm and GroupNorm
    "serve f32": ServeCase(FLAGSHIP, {"warp_tiles": 1}, f32=True, batches=(16,), heatmaps=()),
    "deform-serve": ServeCase(DEFORM, {"sample_tiles_grouped": 2, "bn_act": BN_ACT_A_REQUEST["deform"],
                                       "gn_act": GN_ACT_A_REQUEST["deform"]}),
    # another calibration in every frame: the LUT is built every request
    "perframe-concat": ServeCase(FLAGSHIP, {"warp_views_sum": 1, "bn_act": BN_ACT_A_REQUEST["flagship per-frame"],
                                            "gn_act": GN_ACT_A_REQUEST["flagship per-frame"]},
                                 {"static_cameras": False}, expect={"fusion": "concat"}),
    "perframe-deform_attn": ServeCase(DEFORM, {"sample_tiles_grouped": 2, "bn_act": BN_ACT_A_REQUEST["flagship"],
                                               "gn_act": GN_ACT_A_REQUEST["deform"]},
                                      {"static_cameras": False}, expect={"fusion": "deform_attn"}),
    # every view's BEV map through warp_views (G = 112, K = FEAT_DIM); the
    # heatmaps at batch 1 alone: the plain sampler at 16 would hold copies
    # of 12.4 GB of maps (grouped_phase holds that shape group by group)
    **{f"fusion-{fusion}": ServeCase(FLAGSHIP, {"sample_tiles_grouped": 1, "bn_act": BN_ACT_A_REQUEST["flagship"],
                                                "gn_act": GN_ACT_A_REQUEST["flagship"]},
                                     {"fusion": fusion, "warp_impl": "gather"}, heatmaps=(1,))
       for fusion in ("max", "attn")},
    **{f"resnet-serve {name}": ServeCase(path, {"sample_tiles_grouped": 1, "bn_act": BN_ACT_A_REQUEST[name],
                                                "gn_act": GN_ACT_A_REQUEST[name]}, capture=True)
       for name, path in RESNET_CONFIGS.items()},
}


def serve_case(dev, label, case):
    """``case`` (:class:`ServeCase`) through build_serving_fn: every
    request's outputs checked, the launches a request, then the heatmaps
    with the kernels against the plain versions. Returns the launches, the
    captured inputs (:func:`capturing_kernels`) and the last request's
    outputs."""
    from vsta_tpu_torch.convert import init_state_dict
    from vsta_tpu_torch.ops import grouped_cuda as gc
    from vsta_tpu_torch.serving import build_serving_fn

    cfg = case_config(case.path, case.fields, case.f32)
    check(all(getattr(cfg.model, k) == v for k, v in case.expect.items()), f"{case.path} is not {case.expect}")
    serve = build_serving_fn(cfg, wake_sampling_heads(init_state_dict(cfg, seed=0)), device=dev)
    model = serve.model
    log(f"[{label}] {case.path.name} {json.dumps(case.fields)}: compute dtype {model.dtype}, FUSION "
        f"{cfg.model.fusion}, {cfg.data.views} views")
    if "warp_tiles" in case.a_request:
        check_dispatch(cfg, 16, model.dtype)
    if cfg.model.static_cameras:
        inputs = serve_inputs(cfg)
    else:
        check(not model.static_cameras, "the model still shares frame 0's cameras")
        inputs = serve_inputs_perframe(cfg)
        check(float(np.abs(inputs[2][0] - inputs[2][1]).max()) > 0.1, "the frames share a calibration")
    counters, store = all_counters(), {}
    reset(counters)
    if case.capture:
        model.grouped = capturing_kernels(store)
    try:
        for B in case.batches:
            for _ in range(case.requests):
                out = serve(*(a[:B] for a in inputs))
                check_served(cfg, out, B)
    finally:
        model.grouped = gc.KERNELS
    n = case.requests * len(case.batches)
    launches = {c.__name__: c.launches for c in counters}
    log(f"[{label}] {n} requests, launches {json.dumps(launches)}")
    check(launches == {c.__name__: case.a_request.get(c.__name__, 0) * n for c in counters},
          f"{label} launches {launches}")
    heatmaps_kernels_vs_plain(serve, inputs, counters, label, batches=case.heatmaps)
    return launches, store, out


def serving_phase(dev):
    """Every case of :data:`SERVE_CASES`, then a small f32 model of each
    family on the card against the CPU. Returns the launches by
    kernels-line entry and the capturing cases' kernel readings."""
    total, readings = {}, []
    for label, case in SERVE_CASES.items():
        launches, store, _ = serve_case(dev, label, case)
        tally(total, launches, case.f32)
        if store:
            readings.append(captured_readings(dev, f"{label} B={case.batches[0]}", store))
        torch.cuda.empty_cache()
    for family in SMALL_FAMILIES:
        small_model_phase(dev, family)
    return total, readings


B0_STATS = ("encoder.backbone.stem_bn.running_mean", "encoder.backbone.stages.6.0.project_bn.running_var")


class TrainCase(NamedTuple):
    """One training case (:func:`training_phase`): ``path`` with MODEL
    ``fields`` replaced in memory for ``calls`` train-step calls, each
    launching the kernels of ``per_call`` and no other; ``watched``
    parameters move on every ACCUM_STEPS-th call, ``stats`` on every call;
    ``named`` gradients exist only through d_wts; ``perframe``: another
    calibration in every frame; ``settle``: calls before the gradients."""
    path: Path
    per_call: dict
    watched: tuple
    calls: int
    fields: dict = {}
    named: tuple = ()
    perframe: bool = False
    stats: tuple = B0_STATS
    extra: Optional[Callable] = None
    expect: dict = {}
    settle: int = 0


def forced_fused(dev, label, cfg, grads_with, g_kernel, spread):
    """The flagship's warp takes its tap weights from the calibration, so
    its backward runs scatter_taps_grouped alone: the gradients must equal
    those of a backward forced through the fused kernel."""
    from vsta_tpu_torch.ops import grouped_cuda as gc
    from vsta_tpu_torch.ops.warp_cuda import warp_tiles

    check(cfg.model.bev_proj_ch > 40 + 1, "the flagship takes the warp-first backward")

    def fused_dmaps(gout, idx, wts, P_):
        maps = torch.zeros((gout.shape[0], P_, gout.shape[2]), dtype=gout.dtype, device=gout.device)
        return gc.scatter_tapdot_grouped(maps, gout, idx, wts)[0]

    n = gc.scatter_tapdot_grouped.launches
    g_fused = grads_with(warp_tiles, gc.KERNELS._replace(scatter_taps=fused_dmaps))
    check(gc.scatter_tapdot_grouped.launches == n + 1, "the forced run did not take the fused kernel")
    same = all(torch.equal(g_kernel[k], g_fused[k]) for k in g_kernel)
    worst, worst_k = grad_distance(g_fused, g_kernel)[0]
    log(f"[{label}] gradients through scatter_taps_grouped against those forced through scatter_tapdot_grouped: "
        f"bit-equal {same}; worst distance {worst:.3e} ({worst_k}); two runs of one route differ by {spread:.3e}")
    # bit-equal where the card's backward is deterministic (two runs of
    # one route agree); where it is not, equality cannot show, and the
    # distance is held to the limit of the kernels-vs-plain check (the
    # kernels' own dmaps are held bit-equal in the grouped phase)
    check(same or (spread > 0 and worst <= 2e-2), "the flagship's gradients changed with the backward's dispatch")


def twice_and_captured(dev, label, cfg, grads_with, g_kernel, spread):
    """One call's gradients run twice, bit for bit; rows 4 and 3 at the
    shapes the call gives them."""
    from vsta_tpu_torch.ops.warp_cuda import warp_tiles

    log(f"[determinism] {label}: one call's gradients run twice: worst distance {spread:.3e} "
        f"(bit-equal {spread == 0})")
    check(spread == 0, f"{label}: two runs of one call's gradients differ")
    store = {}
    grads_with(warp_tiles, capturing_kernels(store))
    return captured_readings(dev, label, store)


FLAGSHIP_WATCHED = ("view_proj", "detector.stem0.weight", "encoder.backbone.stages.6.0.expand_conv.weight")
DEFORM_WATCHED = ("query_proj", "deform_fusion.offsets.weight", "deform_fusion.attn.bias",
                  "deform_fusion.value.weight", "encoder.proj.weight", "detector.stem0.weight")
DEFORM_NAMED = ("deform_fusion.offsets.weight", "deform_fusion.offsets.bias", "deform_fusion.attn.weight",
                "deform_fusion.attn.bias")
ROW4_ROW3 = {"sample_tiles_grouped": 1, "scatter_taps_grouped": 1}
TRAIN_CASES = {  # each config as it stands otherwise (the flagship: batch 2, ACCUM_STEPS 2, bf16)
    "train": TrainCase(FLAGSHIP, {"warp_tiles": 1, **ROW4_ROW3}, FLAGSHIP_WATCHED, 8, extra=forced_fused, settle=2),
    # ATTN_STRIDE 4: the sampler's backward takes the fused kernel; at 1 the two one-sided kernels
    "deform-train": TrainCase(DEFORM, {"sample_tiles_grouped": 2, "scatter_taps_grouped": 1,
                                       "scatter_tapdot_grouped": 1}, DEFORM_WATCHED, 10, named=DEFORM_NAMED,
                              expect={"attn_stride": 4, "fusion": "deform_attn"}, settle=2),
    "deform-train ATTN_STRIDE 1": TrainCase(DEFORM, {"sample_tiles_grouped": 2, "scatter_taps_grouped": 2,
                                                     "taps_dot_grouped": 1}, DEFORM_WATCHED, 5, {"attn_stride": 1},
                                            named=DEFORM_NAMED),
    # concat: warp_views_sum forward, then the VJP of the per-batch
    # fused_warp_proj, the grouped sampler at G = 14; deform: the query
    # warp at G = 14 and the sampler
    "perframe-train": TrainCase(FLAGSHIP, {"warp_views_sum": 1, **ROW4_ROW3}, FLAGSHIP_WATCHED, 7,
                                {"static_cameras": False}, perframe=True, settle=2),
    "perframe-deform-train": TrainCase(
        DEFORM, {"sample_tiles_grouped": 2, "scatter_taps_grouped": 1, "scatter_tapdot_grouped": 1},
        ("query_proj", "deform_fusion.offsets.weight", "deform_fusion.value.weight", "encoder.proj.weight"), 7,
        {"static_cameras": False}, named=("deform_fusion.offsets.weight", "deform_fusion.attn.weight"),
        perframe=True),
    # warp_views forward (K = FEAT_DIM) and its maps' gradient backward
    "fusion-attn-train": TrainCase(FLAGSHIP, ROW4_ROW3, ("bev_proj.weight", "attn_fusion.hidden.weight",
                                                        "attn_fusion.logit.bias", "encoder.proj.weight"), 5,
                                   {"fusion": "attn", "warp_impl": "gather"}),
    **{f"resnet-train {name}" + (" NORM group" if fields else ""): TrainCase(
        RESNET_CONFIGS[name], ROW4_ROW3,
        ("bev_proj.weight" if name == "ms_max" else "view_proj", "detector.stem0.weight",
         "encoder.backbone.stem_conv.weight"), 5, fields, extra=twice_and_captured, settle=2 * (name == "resnet50"),
        stats=() if fields else ("encoder.backbone.stem_bn.running_mean",
                                 "encoder.backbone.stages.3.1.norms.0.running_var"))
       for name, fields in (("sanity", {}), ("resnet50", {}), ("ms_max", {}), ("sanity", {"norm": "group"}))},
}


def training_phase(dev, label, case):
    """A :class:`TrainCase` on the card: its calls, then one call's
    gradients with the kernels against the same call on their plain
    versions; then ``case.extra(dev, label, cfg, grads_with, g_kernel,
    spread)`` (``spread``: the worst distance between two runs with the
    kernels). Returns the launches and the extra's readings."""
    from vsta_tpu_torch.ops import grouped_cuda as gc
    from vsta_tpu_torch.ops.warp_cuda import warp_tiles, warp_tiles_ref
    from vsta_tpu_torch.ops.warp_views_cuda import warp_views_sum, warp_views_sum_ref
    from vsta_tpu_torch.training.state import (
        apply_gradients, batch_to_device, create_state, gradients, loss_fn, make_train_step,
    )

    cfg = case_config(case.path, case.fields)
    check(all(getattr(cfg.model, k) == v for k, v in case.expect.items()), f"{case.path} is not {case.expect}")
    B, watched, stats = cfg.data.batch_size, list(case.watched), list(case.stats)
    state = create_state(cfg, seed=0, device=dev, steps_per_epoch=100)
    model = state.model
    log(f"[{label}] batch {B}, ACCUM_STEPS {cfg.train.accum_steps}, compute dtype {model.dtype}, "
        f"{sum(p.numel() for p in model.parameters())} parameters")
    if "warp_tiles" in case.per_call:
        check_dispatch(cfg, B, model.dtype)
    train_step = make_train_step(cfg)
    batch_fn = train_batch_perframe if case.perframe else train_batch
    batches = [batch_fn(cfg, B, seed) for seed in range(4)]

    def snapshot(names):
        sd = model.state_dict()
        return {k: sd[k].clone() for k in names}

    counters = all_counters()
    reset(counters)
    for i in range(case.calls):
        before, before_s = snapshot(watched), snapshot(stats)
        metrics = train_step(state, batches[i % len(batches)])
        check(all(bool(torch.isfinite(v)) for v in metrics.values()), f"call {i}: non-finite {metrics}")
        after, after_s = snapshot(watched), snapshot(stats)
        moved = [not torch.equal(before[k], after[k]) for k in watched]
        update = state.step % cfg.train.accum_steps == 0
        check(all(moved) if update else not any(moved),
              f"call {state.step}: parameters moved {moved}, expected {'all' if update else 'none'}")
        check(all(not torch.equal(before_s[k], after_s[k]) for k in stats), f"call {state.step}: statistics still")
    launches = {c.__name__: c.launches for c in counters}
    moved_s = "BatchNorm statistics on every call" if stats else "no BatchNorm statistics (GroupNorm)"
    log(f"[{label}] {case.calls} calls, last losses {json.dumps({k: round(float(v), 4) for k, v in metrics.items()})}; "
        f"parameters moved on every {cfg.train.accum_steps}nd call only, {moved_s}; launches {json.dumps(launches)}")
    for name, n in launches.items():
        want = case.per_call.get(name, 0)
        check(n == want * case.calls,
              f"{label}: {name} launched {n} times in {case.calls} train-step calls, expected {want} a call")

    # the state the limits below were read at (four updates outside the
    # train step, then ``case.settle`` calls), then one call's gradients
    # with the kernels, again, and with all of them on their plain versions
    for i in range(4):
        apply_gradients(state, gradients(model, loss_fn(cfg, model, batch_to_device(batches[i], dev))["total_loss"]))
    for _ in range(case.settle):
        train_step(state, batches[0])
    b = batch_to_device(batches[0], dev)

    def grads_with(warp, grouped, views_sum=warp_views_sum):
        model.warp, model.grouped, model.views_sum = warp, grouped, views_sum
        try:
            return gradients(model, loss_fn(cfg, model, b)["total_loss"])
        finally:
            model.warp, model.grouped, model.views_sum = warp_tiles, gc.KERNELS, warp_views_sum

    g_kernel = grads_with(warp_tiles, gc.KERNELS)
    g_again = grads_with(warp_tiles, gc.KERNELS)
    before = [c.launches for c in counters]
    g_plain = grads_with(warp_tiles_ref, gc.PLAIN, warp_views_sum_ref)
    check([c.launches for c in counters] == before, "the plain-version run launched a kernel")
    spread = grad_distance(g_again, g_kernel)
    dist = grad_distance(g_kernel, g_plain)
    # the plain scatter adds with atomics in another order: in bf16 dfeats
    # is then rounded to bf16; in f32 nothing is rounded below f32, and a
    # bf16 rounding anywhere would put the distance above 1e-3
    limit = 1e-5 if model.dtype == torch.float32 else 2e-2
    worst = ", ".join(f"{d:.3e} ({k})" for d, k in dist[:3])
    log(f"[{label}] gradients, kernels vs plain versions: per-parameter ||a-b|| / max(||b||, 1e-2 max||b||): "
        f"worst {worst}; median {dist[len(dist) // 2][0]:.3e}; kernels run twice: worst {spread[0][0]:.3e}; "
        f"limit {limit:.0e} ({model.dtype})")
    check(dist[0][0] <= limit, f"{label}: gradients with the kernels disagree with the plain versions ({worst})")
    if case.named:
        by_name = {k: d for d, k in dist}
        norms = {k: float(g_kernel[k].float().norm()) for k in case.named}
        log(f"[{label}] gradients that exist only through d_wts, kernels vs plain versions: "
            + ", ".join(f"{k} {by_name[k]:.3e} (||g|| {norms[k]:.3e})" for k in case.named))
        check(all(n > 0 and math.isfinite(n) for n in norms.values()), f"{label}: a d_wts gradient is zero: {norms}")
    readings = None if case.extra is None else case.extra(dev, label, cfg, grads_with, g_kernel, spread[0][0])
    return launches, readings


def training_cases(dev):
    """Every case of :data:`TRAIN_CASES`, then [pretrained] and a small f32
    train step of each family on the card against the CPU. Returns the
    launches by kernels-line entry and the ResNet cases' kernel readings."""
    total, readings = {}, []
    for label, case in TRAIN_CASES.items():
        launches, found = training_phase(dev, label, case)
        tally(total, launches)
        readings += [found] if found else []
        torch.cuda.empty_cache()
    pretrained_phase(dev)
    for family in ("concat", "deform_attn", "concat per-frame", "attn"):
        small_train_phase(dev, family)
    return total, readings


MVDET = ROOT / "configs" / "torch" / "wildtrack_mvdet.yaml"
MVDET_BATCH = 16  # the offline cell's request


def is_kernel(key: str, name: str) -> bool:
    """A device kernel's name holds ``name`` as a word of its own (so
    ``sample_kernel`` is not ``upsample_kernel``)."""
    return re.search(rf"(?<![A-Za-z0-9_]){name}", key) is not None


def taps_bound_ms(idx, wts, P: int, K: int, itemsize: int = 2) -> float:
    """The least time of one sample_tiles_grouped launch at these taps:
    the live taps' distinct map rows read once, the output [G, N, K]
    written once and an int32 index and a float32 weight a tap read once,
    over the HBM's bandwidth (benchmark/counts/kernels.sample_grouped's
    count)."""
    G, N, T = idx.shape
    rows = torch.arange(G, device=idx.device)[:, None, None] * P + idx.long()
    distinct = torch.unique(rows[wts != 0]).numel()
    return (distinct * K * itemsize + G * N * K * itemsize + G * N * T * 8) / HBM_BYTES_PER_S * 1e3


MVDET_CASE = ServeCase(MVDET, {"sample_tiles_grouped": 1, "bn_act": BN_ACT_A_REQUEST["mvdet"],
                               "gn_act": GN_ACT_A_REQUEST["mvdet"]},
                       batches=(MVDET_BATCH,), requests=1, heatmaps=(), capture=True)


def mvdet_phase(dev):
    """MVDet (:data:`MVDET`, batch 16, bf16): one eager request through
    :func:`serve_case` (one 9-tap sample_tiles_grouped launch, 20 bn_act;
    the sampler's inputs kept, the eval BatchNorms' shapes read by a
    forward hook); row 4 on those inputs (G = 112, P = 14,400, the
    upsample folded into the taps; N = 43,200, K = 512) bit-equal, timed
    against its own bound and the views roofline's 4-tap count; the
    batch-16 artifact as one CUDA graph: launches at the load, one profiled
    replay's device kernels exactly one 9-tap ``sample_kernel``, 20
    ``bn_act`` and no ``upsample_bilinear2d``, detections equal to the
    eager request's; bn_act at each distinct BatchNorm shape, held and
    timed; row 4 at its 4-tap shapes bit-equal and timed. Returns the
    launches by kernels-line entry and no readings."""
    import shutil
    import tempfile

    from torch.profiler import ProfilerActivity, profile

    from vsta_tpu_torch.convert import init_state_dict
    from vsta_tpu_torch.export import WARMUP_REQUESTS, export_serving, load_serving, save_exported
    from vsta_tpu_torch.geometry import bev_sample_coords_with_depth, ground_grid
    from vsta_tpu_torch.ops import grouped_cuda as gc
    from vsta_tpu_torch.ops.warp import anchored_taps, flat_taps

    B, a_request = MVDET_BATCH, MVDET_CASE.a_request
    cfg = case_config(MVDET, {})
    m, V, (Hb, Wb) = cfg.model, cfg.data.views, cfg.model.bev_size
    by_taps = gc.sample_tiles_grouped.launches_by_taps
    by_taps.update(dict.fromkeys(by_taps, 0))
    with batchnorms_seen([]) as seen:
        launches, store, out = serve_case(dev, "mvdet", MVDET_CASE)
    log(f"[mvdet] sample_tiles_grouped by taps a sample {json.dumps(by_taps)}, {len(seen)} eval BatchNorms")
    check(by_taps == {4: 0, 9: 1}, f"[mvdet] sample_tiles_grouped launches by taps a sample {by_taps}")
    total = tally({}, launches)
    want = {k: out[k].clone() for k in ("boxes", "scores", "valid", "heatmap")}
    del out
    torch.cuda.empty_cache()

    maps, idx, wts = store.pop("sample_tiles_grouped")
    (H, W), (Fh, Fw) = cfg.data.img_size, m.feat_size
    P = maps.shape[1]  # the trunk's map, 90 x 160 at 720 x 1280
    check((maps.shape[0], maps.shape[2], tuple(idx.shape[1:]), maps.dtype)
          == (B * V, m.feat_dim, (Hb * Wb, 9), torch.bfloat16) and P * 9 == Fh * Fw,
          f"[mvdet] the sampler's inputs {tuple(maps.shape)} {tuple(idx.shape)} {maps.dtype}")
    got = gc.sample_tiles_grouped(maps, idx, wts)
    err = hold(f"sample_tiles_grouped mvdet serving B={B}", got, gc.sample_tiles_grouped_ref(maps, idx, wts), "exact")
    check(torch.equal(got, gc.sample_tiles_grouped(maps, idx, wts)), "[mvdet] sample_tiles_grouped: two launches differ")
    sample = {"path": f"mvdet serving B={B}", **measure(dev, "sample_tiles_grouped", maps, got, idx, wts, err)}
    # the bound of this launch from its live taps' distinct rows, and the
    # one the views roofline counts: the 4-tap sample of the same cells on
    # the 270 x 480 maps, padded, of every frame
    own_ms = taps_bound_ms(idx, wts, P, m.feat_dim)
    args = tuple(torch.as_tensor(a, device=dev) for a in serve_inputs(cfg, B=B))
    coords, _ = bev_sample_coords_with_depth(args[1][0], args[2][0], (H, W), (Fh, Fw),
                                             ground_grid(Hb, Wb, m.bev_bounds, device=dev))
    anchors, w4 = anchored_taps(coords.reshape(V, Hb * Wb, 2), (Fh, Fw))
    stale_ms = B * taps_bound_ms(flat_taps(anchors, Fw + 1), w4, (Fh + 1) * (Fw + 1), m.feat_dim)
    live = (wts != 0).sum(-1)
    sample.update(own_bound_ms=own_ms, views_count_ms=stale_ms, live_taps_max=int(live.max()),
                  live_taps_mean=float(live.float().mean()))
    t = sample["ms"]  # CUDA events over 10 launches
    log(f"[mvdet] 9-tap sample_tiles_grouped: {t:.4f} ms (profiler {sample['device_ms']}), its own bound "
        f"{own_ms:.4f} ms (share {own_ms / t:.3f}), the views roofline's 4-tap count {stale_ms:.4f} ms "
        f"(would read {100 * stale_ms / t:.1f} %); live taps a sample at most {int(live.max())}, mean "
        f"{float(live.float().mean()):.3f}")
    del maps, idx, wts, got, coords, anchors, w4, live
    store.clear()
    torch.cuda.empty_cache()

    tmp = tempfile.mkdtemp(prefix="vsta_mvdet_")
    try:
        path = Path(tmp) / f"mvdet_b{B}.pt"
        save_exported(export_serving(cfg, init_state_dict(cfg, seed=0), batch_size=B, platforms=(dev.type,)), path)
        counters = all_counters()
        reset(counters)
        served = load_serving(path, device=dev)
        launches = {c.__name__: c.launches for c in counters}
        per_load = {k: a_request.get(k, 0) * (WARMUP_REQUESTS + 2) for k in launches}
        log(f"[mvdet] artifact B={B} loaded and captured: launches {json.dumps(launches)}")
        check(launches == per_load, f"[mvdet] launches at the load {launches} != {per_load}")
        tally(total, launches)
        replayed = served(*args)
        check_served(cfg, replayed, B)
        for k, v in want.items():
            check(torch.equal(replayed[k], v), f"[mvdet] replayed {k} differs from the eager request "
                                                f"(max {float((replayed[k].float() - v.float()).abs().max()):.3e})")
        torch.cuda.synchronize()
        reset(counters)
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            served(*args)
            torch.cuda.synchronize()
        kernels = [e.name for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
        per_replay = {name: sum(is_kernel(k, name) for k in kernels)
                      for name in ("sample_kernel", "bn_act", "upsample_bilinear2d")}
        samplers = sorted({k for k in kernels if is_kernel(k, "sample_kernel")})
        log(f"[mvdet] one profiled replay: {len(kernels)} device operations, {json.dumps(per_replay)}, "
            f"wrapper launches {sum(c.launches for c in counters)}; the sampler {samplers}")
        check(all(c.launches == 0 for c in counters), "[mvdet] a replay went through a Python kernel wrapper")
        check(per_replay == {"sample_kernel": 1, "bn_act": a_request["bn_act"], "upsample_bilinear2d": 0},
              f"[mvdet] one replay's kernels {per_replay}")
        check(all(re.search(r"sample_kernel<[^>]*,\s*9>", k) for k in samplers),
              f"[mvdet] the replay's sampler is not the 9-tap instantiation: {samplers}")
        del served, replayed
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    del args, want
    torch.cuda.empty_cache()

    shapes = {}
    for shape, act, lay, eps in seen:
        shapes[(shape, act, lay, eps)] = shapes.get((shape, act, lay, eps), 0) + 1
    log(f"[mvdet] the trunk's eval BatchNorms ((N, C, H, W), act, layout, eps): count "
        + json.dumps([[list(k[0]), k[1], k[2], k[3], n] for k, n in shapes.items()]))
    check(sum(shapes.values()) == a_request["bn_act"] and all(k[1] is None and k[2] == "nhwc" for k in shapes),
          f"[mvdet] {sum(shapes.values())} eval BatchNorms, not {a_request['bn_act']} channels-last without SiLU")
    worst, rows = 0, []
    for i, ((shape, act, _, eps), n) in enumerate(shapes.items()):
        x = bn_act_inputs(dev, *shape, "nhwc", seed=3000 + i)
        worst = max(worst, bn_act_case(f"mvdet N={shape[0]} C={shape[1]} {shape[2]}x{shape[3]} nhwc {act}", *x, eps, act))
        ms, bound_ms = bn_act_times(dev, *x, eps, act)
        rows.append({"C": shape[1], "HxW": f"{shape[2]}x{shape[3]}", "n": n, "ms": round(ms, 4),
                     "bound_ms": round(bound_ms, 4), "share": round(bound_ms / ms, 3)})
        del x
        torch.cuda.empty_cache()
    request = {k: sum(r[k] * r["n"] for r in rows) for k in ("ms", "bound_ms")}
    log(f"[mvdet] bn_act as the trunk runs it, ms a launch: {json.dumps(rows)}; a request's "
        f"{a_request['bn_act']}: kernel {request['ms']:.4f} ms, bound {request['bound_ms']:.4f} ms "
        f"(share {request['bound_ms'] / request['ms']:.3f}), max {worst} bf16 ulp")
    log("[mvdet] sample_tiles_grouped: " + json.dumps(sample))
    four = {}
    for label, (maps, _, idx, wts) in grouped_timing_inputs(dev).items():
        got = gc.sample_tiles_grouped(maps, idx, wts)
        check(torch.equal(got, gc.sample_tiles_grouped_ref(maps, idx, wts)),
              f"[mvdet] row 4 at 4 taps, {label}: not bit-equal to its plain version")
        four[f"{label} G={maps.shape[0]} N={idx.shape[1]} K={maps.shape[2]}"] = kernel_device_ms(
            gc.sample_tiles_grouped, (maps, idx, wts), KERNEL_NAMES["sample_tiles_grouped"])
        del got
    log("[mvdet] row 4 at 4 taps, bit-equal, device ms a launch (profiler, 5 calls each): " + json.dumps(four))
    return total, []


def torchvision_resnet18(seed):
    """A ResNet-18 state_dict under torchvision's names (fc included), its
    weights and BatchNorm statistics random from ``seed``."""
    from vsta_tpu_torch.models.encoders.resnet import ResNetFeatures

    torch.manual_seed(seed)
    trunk = ResNetFeatures("resnet18")
    sd = {"fc.weight": torch.randn(1000, 512), "fc.bias": torch.randn(1000)}
    for k, t in trunk.state_dict().items():
        if k.endswith("num_batches_tracked"):
            continue
        t = torch.rand_like(t) + 0.5 if k.endswith(("running_var", "weight")) and t.ndim == 1 else t.clone()
        if k.endswith("running_mean") or (k.endswith("bias") and t.ndim == 1):
            t = 0.1 * torch.randn_like(t)
        parts = k.split(".")
        if parts[0] == "stem_conv":
            name = "conv1." + parts[1]
        elif parts[0] == "stem_bn":
            name = "bn1." + parts[1]
        else:  # stages.i.j.{convs,norms}.k.<tensor>
            i, j, kind, n = int(parts[1]), int(parts[2]), parts[3], int(parts[4])
            block = trunk.stages[i][j]
            stem = f"layer{i + 1}.{j}"
            if n < block.n_main:
                name = f"{stem}.{'conv' if kind == 'convs' else 'bn'}{n + 1}.{parts[5]}"
            else:
                name = f"{stem}.downsample.{0 if kind == 'convs' else 1}.{parts[5]}"
        sd[name] = t
    return sd


def pretrained_phase(dev):
    """configs/wildtrack_sanity.yaml with MODEL.PRETRAINED true and
    PRETRAINED_PATH a torchvision-named ResNet-18 state_dict written from a
    seed to a temporary .pth: create_state loads it on the card, prints the
    JAX package's line, and the loaded stem_conv weight, a block's conv and
    a projection norm's running variance equal the file's."""
    import contextlib
    import io
    import tempfile

    from vsta_tpu_torch.config import load_config
    from vsta_tpu_torch.training.state import create_state

    sd = torchvision_resnet18(seed=5)
    with tempfile.TemporaryDirectory(prefix="vsta_pretrained_") as tmp:
        path = Path(tmp) / "resnet18.pth"
        torch.save(sd, path)
        cfg = with_model_fields(load_config(str(RESNET_CONFIGS["sanity"])), pretrained=True, pretrained_path=str(path))
        out = io.StringIO()
        with contextlib.redirect_stdout(out):
            state = create_state(cfg, seed=0, device=dev, steps_per_epoch=1)
    line = out.getvalue().strip()
    bb = state.model.encoder.backbone
    pairs = {"conv1.weight": bb.stem_conv.weight, "layer3.1.conv2.weight": bb.stages[2][1].convs[1].weight,
             "layer4.0.downsample.1.running_var": bb.stages[3][0].norms[2].running_var}
    same = {k: bool(torch.equal(t.detach().cpu(), sd[k])) and t.is_cuda for k, t in pairs.items()}
    log(f"[pretrained] {line!r}; on the card and equal to the file's: {json.dumps(same)}")
    check(line.startswith("[pretrained] loaded 60 param + 40 batch-stat tensors"), f"pretrained load printed {line!r}")
    check(all(same.values()), f"pretrained weights differ from the file's: {same}")
    del state
    torch.cuda.empty_cache()


EXPORT_CONFIGS = {
    "flagship": (FLAGSHIP, {}),
    "flagship per-frame": (FLAGSHIP, {"static_cameras": False}),
    "deform": (DEFORM, {}),
    **{name: (path, {}) for name, path in RESNET_CONFIGS.items()},
}
# the kernels a request of each artifact launches, and how often
EXPORT_LAUNCHES = {
    "flagship": {"warp_tiles": 1},
    "flagship per-frame": {"warp_views_sum": 1},
    "deform": {"sample_tiles_grouped": 2},
    **{name: {"sample_tiles_grouped": 1} for name in RESNET_CONFIGS},
}
INT8_CONFIGS = {  # name: (head, encoder)
    "flagship": (True, False),
    "resnet50": (True, True),
    "ms_max": (False, True),
}
EXPORT_BATCHES = (16, 1)
# an int8 artifact's heatmap against its float artifact's, max |diff|: the
# JAX package's PTQ bound (tests/test_quant.py); the card read 0.0055 to
# 0.016 on the three int8 artifacts (NVIDIA H100 80GB HBM3, 700 W)
INT8_DRIFT_LIMIT = 0.05


def export_config(name):
    """The shipped config of ``name`` as it stands (one field replaced in
    memory for the per-frame flagship), its random weights and its batch-16
    frames and cameras."""
    from vsta_tpu_torch.convert import init_state_dict

    cfg = case_config(*EXPORT_CONFIGS[name])
    state = wake_sampling_heads(init_state_dict(cfg, seed=0))
    inputs = serve_inputs_perframe(cfg) if not cfg.model.static_cameras else serve_inputs(cfg)
    return cfg, state, inputs


def eager_reference(dev, cfg, state, inputs, per_request, quant):
    """``build_serving_fn``'s eager function for ``cfg`` (int8 trees in
    ``quant``) at each batch size: the outputs an artifact's replay is held
    to. Returns {B: (args on the card, outputs)}."""
    from vsta_tpu_torch.serving import build_serving_fn

    counters = all_counters()
    full = tuple(torch.as_tensor(a, device=dev) for a in inputs)
    fn = build_serving_fn(cfg, state, device=dev, **quant)
    out = {}
    for B in EXPORT_BATCHES:
        args = tuple(a[:B] for a in full)
        reset(counters)
        outputs = {k: v for k, v in fn(*args).items() if k in ("boxes", "scores", "valid", "heatmap")}
        check(sum(c.launches for c in counters) > 0 or not per_request, "eager requests launched no kernel")
        out[B] = (args, outputs)
    del fn
    torch.cuda.empty_cache()
    return out


def replayed_artifact(dev, tmp, label, cfg, state, B, per_request, eager, quant):
    """Export ``state`` at batch B (int8 trees in ``quant``), load it on the
    card (one CUDA graph captured, launches counted from 0 around the
    load), hold a replay's outputs equal to ``eager``'s (args, outputs) bit
    for bit, and a second replay to no Python kernel wrapper. Returns
    (launches, replayed heatmap on the CPU)."""
    from vsta_tpu_torch.export import WARMUP_REQUESTS, export_serving, load_serving, save_exported

    args, want_out = eager
    path = Path(tmp) / f"{label.replace(' ', '_')}_b{B}.pt"
    save_exported(export_serving(cfg, state, batch_size=B, **quant), path)
    counters = all_counters()
    reset(counters)
    serve = load_serving(path, device=dev)
    launches = {c.__name__: c.launches for c in counters}
    eager_requests = WARMUP_REQUESTS + 2  # warm-up, the sync check, the captured one
    want = {c.__name__: per_request.get(c.__name__, 0) * eager_requests for c in counters}
    check(launches == want, f"[export] {label} B={B}: launches at load {launches} != {want}")
    replayed = serve(*args)
    check_served(cfg, replayed, B)
    for k, v in want_out.items():
        check(torch.equal(replayed[k], v),
              f"[export] {label} B={B}: replayed {k} differs from eager serving "
              f"(max {float((replayed[k].float() - v.float()).abs().max()):.3e})")
    reset(counters)
    serve(*args)
    check(all(c.launches == 0 for c in counters), "a replay went through a Python kernel wrapper")
    log(f"[export] {label} B={B}: int8 {sorted(quant)}, launches at load {json.dumps(launches)}, replay bit-equal "
        f"to eager serving, valid dets/frame {float(replayed['valid'].float().sum(1).mean()):.2f}")
    heatmap = replayed["heatmap"].cpu()
    del serve, replayed
    torch.cuda.empty_cache()
    return launches, heatmap


def decode_replay(dev, cfg):
    """The decode alone (3x3 peak pool, sort, the 128-step greedy NMS loop)
    on the flagship's heatmap shape at batch 16 and 1: one captured CUDA
    graph of it, its outputs equal to eager's."""
    from vsta_tpu_torch.ops.decode import decode_detections

    (Hb, Wb), e = cfg.model.bev_size, cfg.eval
    kw = dict(bounds=cfg.model.bev_bounds, conf_thresh=e.conf_thresh, nms_dist_m=e.nms_dist_m, max_dets=e.max_dets)
    g = torch.Generator(device=dev).manual_seed(5)
    for B in EXPORT_BATCHES:
        args = (torch.rand((B, Hb, Wb, 1), device=dev, generator=g),
                torch.rand((B, Hb, Wb, 2), device=dev, generator=g),
                torch.rand((B, Hb, Wb, 2), device=dev, generator=g) * 3)
        side = torch.cuda.Stream(dev)
        side.wait_stream(torch.cuda.current_stream(dev))
        with torch.cuda.stream(side):
            decode_detections(*args, **kw)
        torch.cuda.current_stream(dev).wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            static = decode_detections(*args, **kw)
        graph.replay()
        want = decode_detections(*args, **kw)
        check(all(torch.equal(static[k], want[k]) for k in want), f"[decode] replay differs from eager at B={B}")
        del graph, static
    log("[decode] alone, one CUDA graph at batch 16 and 1: replay equal to eager")


def int_mm_phase(dev, B=16, hw=(120, 360)):
    """torch._int_mm at the flagship head's three stem products (130 -> 512,
    512 -> 128 dilated 2, 128 -> 128; batch 16 x 120 x 360): the card's
    int32 equal to an exact f64 product on the card and to the CPU's
    _int_mm on the same int8 tensors, every row."""
    from vsta_tpu_torch.ops.quant import im2col_int8, pad_cin

    g = torch.Generator(device=dev).manual_seed(17)
    for cin, cout, d in ((130, 512, 1), (512, 128, 2), (128, 128, 1)):
        x = torch.randint(-127, 128, (B, *hw, cin), dtype=torch.int8, device=dev, generator=g)
        w = torch.randint(-127, 128, (cout, 3, 3, cin), dtype=torch.int8, device=dev, generator=g)
        cols, _ = im2col_int8(x, 3, 3, 1, d)
        wt = pad_cin(w).reshape(cout, -1).t()
        y = torch._int_mm(cols, wt)
        M, K = cols.shape
        exact = True
        for r0 in range(0, M, 1 << 16):
            ref = (cols[r0:r0 + (1 << 16)].double() @ wt.double()).to(torch.int32)
            exact &= bool(torch.equal(y[r0:r0 + (1 << 16)], ref))
        same_cpu = bool(torch.equal(y.cpu(), torch._int_mm(cols.cpu(), wt.cpu())))
        stem = f"{cin}->{cout} d{d}"
        log(f"[int8] _int_mm {stem} M={M} K={K} N={cout}: equal to an exact f64 product {exact}, to the CPU's {same_cpu}")
        check(exact and same_cpu, f"[int8] _int_mm at {stem}: card vs exact {exact}, card vs CPU {same_cpu}")
        del x, w, cols, wt, y
        torch.cuda.empty_cache()


def int8_sites_vs_cpu(dev, label, cfg, state, inputs, qh, qe):
    """One batch-1 request through the int8 stages on the card, every int8
    site recorded (its int8 operands, stride, dilation and int32 product):
    each site's product equal to the CPU's conv_int8 on the card's own
    operands."""
    from vsta_tpu_torch.export import _model
    from vsta_tpu_torch.ops import quant, quant_resnet

    model = _model(cfg, state, dev)
    args = tuple(torch.as_tensor(a, device=dev) for a in inputs)
    qh = None if qh is None else quant.tree_to(qh, dev)
    qe = None if qe is None else quant.tree_to(qe, dev)
    conv, records = quant.conv_int8, []

    def recording(x_i8, w_i8, stride=1, dilation=1):
        y = conv(x_i8, w_i8, stride, dilation)
        records.append((x_i8, w_i8, stride, dilation, y))
        return y

    quant.conv_int8 = quant_resnet.conv_int8 = recording
    try:
        with torch.no_grad():
            model(*(a[:1] for a in args), quant_head=qh, quant_encoder=qe)
    finally:
        quant.conv_int8 = quant_resnet.conv_int8 = conv
    want = (0 if qh is None else len(qh["stems"])) + (0 if qe is None else len(qe["sites"]))
    check(len(records) == want, f"[int8] {label}: {len(records)} int8 sites ran, {want} in the trees")
    differ = [i for i, (x_i8, w_i8, stride, dilation, y) in enumerate(records)
              if not torch.equal(y.cpu(), conv(x_i8.cpu(), w_i8.cpu(), stride, dilation))]
    log(f"[int8] {label}: {len(records)} int8 sites of a batch-1 request, card int32 equal to the CPU's on the "
        f"card's operands at {len(records) - len(differ)}")
    check(not differ, f"[int8] {label}: int32 differs from the CPU's at sites {differ}")
    del model
    torch.cuda.empty_cache()


def export_phase(dev):
    """Every shipped config (and the per-frame flagship) exported at batch
    16 and 1 and loaded as one CUDA graph: replay bit-equal to eager
    serving, launches at capture, none at a replay (the serving phase holds
    the kernels at these shapes against their plain versions). Then the
    decode alone as a graph; int8: _int_mm card vs CPU, and INT8_CONFIGS
    exported and replayed, every int8 site of a batch-1 request equal to
    the CPU's, the heatmaps within INT8_DRIFT_LIMIT of the float
    artifacts'. Returns the launches by kernels-line entry and no
    readings."""
    import shutil
    import tempfile

    from vsta_tpu_torch.export import calibrate

    total, heatmaps = {}, {}
    tmp = tempfile.mkdtemp(prefix="vsta_export_")

    def artifacts(name, label, cfg, state, inputs, quant):
        """Eager serving, then an artifact at each batch size: {B: heatmap}."""
        per_request = {**EXPORT_LAUNCHES[name], "bn_act": 0 if "quant_encoder" in quant else BN_ACT_A_REQUEST[name],
                       "gn_act": 0 if "quant_head" in quant else GN_ACT_A_REQUEST[name]}
        eager = eager_reference(dev, cfg, state, inputs, per_request, quant)
        out = {}
        for B in EXPORT_BATCHES:
            launches, out[B] = replayed_artifact(dev, tmp, label, cfg, state, B, per_request, eager[B], quant)
            tally(total, launches)
        return out

    try:
        for name in EXPORT_CONFIGS:
            cfg, state, inputs = export_config(name)
            for B, hm in artifacts(name, name, cfg, state, inputs, {}).items():
                heatmaps[(name, B)] = hm
            del state

        decode_replay(dev, export_config("flagship")[0])
        int_mm_phase(dev)
        for name, (head, encoder) in INT8_CONFIGS.items():
            cfg, state, inputs = export_config(name)
            calib_inputs = serve_inputs(cfg, B=8, seed=1)
            calib = [tuple(a[i * 4:(i + 1) * 4] for a in calib_inputs) for i in range(2)]
            qh, qe = calibrate(cfg, state, calib, head=head, encoder=encoder, device=dev)
            label = f"{name} int8"
            quant = {k: v for k, v in (("quant_head", qh), ("quant_encoder", qe)) if v is not None}
            for B, hm in artifacts(name, label, cfg, state, inputs, quant).items():
                drift = float((hm - heatmaps[(name, B)]).abs().max())
                log(f"[int8] {label} B={B}: heatmap drift against the float artifact {drift:.5f} "
                    f"(limit {INT8_DRIFT_LIMIT}, the JAX package's PTQ bound)")
                check(drift <= INT8_DRIFT_LIMIT, f"{label} B={B}: heatmap drift {drift} > {INT8_DRIFT_LIMIT}")
            int8_sites_vs_cpu(dev, label, cfg, state, inputs, qh, qe)
            del state, qh, qe
            torch.cuda.empty_cache()
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return total, []


# -- multi-device: the ('data', 'view') mesh on torch.distributed ------------

# run -> (config, fields replaced in memory, mesh (n_data, n_view), limit
# of the first call's per-parameter gradient distance to one device's,
# limit of that distance to one device warping the ranks' halves of the
# views (``view-halves``) or None); each a world of two gloo ranks on
# cuda:0 (NCCL refuses two ranks on one card). Every view rank encodes all
# the views of its frames, as JAX's compiled mesh program does, so the one
# sum split over 'view' is the warp's. Each limit is set from that run's
# own reading on an H100 (the distance is deterministic: two runs read the
# same value), with the headroom named beside it.
MULTIDEVICE_RUNS = {
    # the flagship at full width, 7 views, batch 2, data parallel; float32:
    # a bf16 rounding anywhere would exceed the limit. Read 3.33e-6 since
    # BatchNorm sums in float64 (1.93e-4 before; one device with its frames
    # rotated: 4.58e-6); limit 1e-4, thirty times it
    "b": (FLAGSHIP, {"runtime": {"use_amp": False}}, (2, 1), 1e-4, None),
    # wildtrack_ms_max as shipped: 2 views, max over the views (rows 4 and
    # 3), no sum split over 'view'. Reads 0, one device's gradients and
    # losses bit for bit (frames rotated, the same function summed in
    # another order: 3.7e-4); limit 1e-6, the bound the partition is held to
    "c": (ROOT / "configs" / "wildtrack_ms_max.yaml", {}, (1, 2), 1e-6, None),
    # the flagship with 6 views: the all_reduce after warp_tiles at a local
    # V of 3, two bf16 half-sums of the views where one device rounds one,
    # the sum JAX's program splits too. Reads 3.935e-2 from one device
    # (frames rotated: 5.65e-3); limit 0.1, two and a half times it. Against
    # one device warping the two halves: reads 0, every gradient and loss
    # bit-equal; limit 1e-6
    "d": (FLAGSHIP, {"data": {"views": 6}}, (1, 2), 0.1, 1e-6),
    # the deformable family with 6 views: the warped query's all_reduce
    # after sample_tiles_grouped at a local V of 3, the deformable fusion on
    # every view on each rank (rows 4, 6 and 3). Reads 4.705e-2 from one
    # device (frames rotated: 6.55e-3); limit 0.1, about twice it. Against
    # one device warping the query's two halves: reads 0, bit-equal; limit
    # 1e-6
    "e": (DEFORM, {"data": {"views": 6}}, (1, 2), 0.1, 1e-6),
}
MULTIDEVICE_STEPS = 3
MULTIDEVICE_WORLD = 2


def multidevice_config(run):
    from vsta_tpu_torch.config import load_config

    path, fields = MULTIDEVICE_RUNS[run][:2]
    cfg = load_config(str(path))
    for section, values in fields.items():
        cfg = dataclasses.replace(cfg, **{section: dataclasses.replace(getattr(cfg, section), **values)})
    return cfg


def multidevice_steps(cfg, dev, mesh=None, store=None):
    """MULTIDEVICE_STEPS train-step calls of ``cfg`` from seed-0 weights on
    this rank's part of seeded batches: losses, the first call's
    gradients, the final state and the launches, all on the CPU.
    ``store``: the model's kernels keep the inputs of their first call
    there (:func:`capturing_warp`, :func:`capturing_kernels`)."""
    from vsta_tpu_torch.parallel import shard_batch
    from vsta_tpu_torch.training.state import batch_to_device, create_state, make_train_step

    state = create_state(cfg, seed=0, device=dev, steps_per_epoch=100, mesh=mesh)
    if store is not None:
        state.model.warp, state.model.grouped = capturing_warp(store), capturing_kernels(store)
    B = cfg.data.batch_size
    batches = [train_batch(cfg, B, seed) for seed in range(MULTIDEVICE_STEPS)]
    grads, update = {}, state.tx.update

    def spy(opt_state, model, g):
        if not grads:
            grads.update({k: v.detach().float().cpu() for k, v in g.items()})
        return update(opt_state, model, g)

    state.tx.update = spy
    step = make_train_step(cfg)
    counters = all_counters()
    reset(counters)
    losses = []
    for b in batches:
        b = batch_to_device(b, dev) if mesh is None else shard_batch(b, mesh, dev)
        losses.append(float(step(state, b)["total_loss"]))
    return {
        "losses": losses, "grads": grads, "launches": {c.__name__: c.launches for c in counters},
        "state": {k: v.detach().cpu() for k, v in state.model.state_dict().items()},
    }


def multidevice_worker(run, outdir) -> int:
    """One rank of a MULTIDEVICE_RUNS world (``--multidevice-rank RUN
    DIR``): gloo, chosen explicitly, on cuda:0."""
    sys.path.insert(0, str(ROOT))
    from vsta_tpu_torch.parallel import init_distributed, make_mesh

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = init_distributed("cuda:0", backend="gloo")
    cfg = multidevice_config(run)
    mesh = make_mesh(*MULTIDEVICE_RUNS[run][2], batch_size=cfg.data.batch_size, views=cfg.data.views)
    check(mesh.size == MULTIDEVICE_WORLD and mesh.member, f"run {run}: mesh {mesh}")
    store = {}
    out = multidevice_steps(cfg, dev, mesh, store=store)
    torch.distributed.barrier()  # both ranks are done with the card
    out["readings"] = {}
    if mesh.rank == 0:  # the kernels at the shapes this rank gave them, each against its plain version
        out["readings"] = captured_readings(dev, f"mesh {run} {mesh.n_data}x{mesh.n_view} rank 0", store)
    torch.save(out, Path(outdir) / f"{run}-rank{mesh.rank}.pt")
    torch.distributed.destroy_process_group()
    return 0


def spawn_ranks(run, tmp):
    """``run`` on two gloo ranks on cuda:0 (subprocesses of this script):
    each rank's record and rank 0's log."""
    env = {**os.environ, "PYTHONPATH": str(ROOT), "MASTER_ADDR": "127.0.0.1", "MASTER_PORT": str(free_port()),
           "WORLD_SIZE": str(MULTIDEVICE_WORLD)}
    procs = [subprocess.Popen([sys.executable, str(Path(__file__).resolve()), "--multidevice-rank", run, str(tmp)],
                              env={**env, "RANK": str(r), "LOCAL_RANK": "0"}, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for r in range(MULTIDEVICE_WORLD)]
    try:
        logs = [p.communicate(timeout=900)[0] for p in procs]
    finally:
        for p in procs:
            p.kill()
    for r, (p, text) in enumerate(zip(procs, logs)):
        check(p.returncode == 0, f"[multidevice] run {run} rank {r} failed:\n{text[-4000:]}")
    ranks = [torch.load(tmp / f"{run}-rank{r}.pt", weights_only=False) for r in range(MULTIDEVICE_WORLD)]
    return ranks, logs[0]


def free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def multidevice_run(dev, run, tmp):
    """``run`` on one device (and, with a halves limit, warping the ranks'
    halves of the views), then on two gloo ranks, held to it. Returns the
    ranks' launches by kernels-line entry and rank 0's kernel readings."""
    cfg = multidevice_config(run)
    mesh_shape, limit, halves_limit = MULTIDEVICE_RUNS[run][2:]
    ref = multidevice_steps(cfg, dev)
    halves = None
    if halves_limit is not None:
        with patched(view_halves()):
            halves = multidevice_steps(cfg, dev)
    torch.cuda.empty_cache()
    ranks, log0 = spawn_ranks(run, tmp)
    for ln in log0.splitlines():  # rank 0's kernels at the mesh's shapes
        if ln.startswith(("[kernel]", "[grouped]")):
            log(ln)
    f32 = cfg.runtime.use_amp is False
    dists = [grad_distance(r["grads"], ref["grads"]) for r in ranks]
    same = all(torch.equal(ranks[0]["state"][k], r["state"][k]) for r in ranks[1:] for k in ranks[0]["state"])
    halves_s = ""
    if halves is not None:
        to_halves = [grad_distance(r["grads"], halves["grads"]) for r in ranks]
        halves_s = (f"; against one device warping the ranks' halves of the views: per-parameter distance worst "
                    f"{[f'{d[0][0]:.3e} ({d[0][1]})' for d in to_halves]} (limit {halves_limit:.0e}), losses "
                    f"{[round(x, 6) for x in halves['losses']]}")

    def norm(g):
        return math.sqrt(sum(float(v.double().pow(2).sum()) for v in g.values()))

    ratios = [norm(r["grads"]) / norm(ref["grads"]) for r in ranks]
    log(f"[multidevice] {run}: {Path(MULTIDEVICE_RUNS[run][0]).name} {json.dumps(MULTIDEVICE_RUNS[run][1])}, "
        f"batch {cfg.data.batch_size}, {cfg.data.views} views, {'float32' if f32 else 'bfloat16'}, mesh data "
        f"{mesh_shape[0]} x view {mesh_shape[1]} (gloo, 2 ranks on cuda:0); losses one device "
        f"{[round(x, 6) for x in ref['losses']]}, ranks {[[round(x, 6) for x in r['losses']] for r in ranks]}; "
        f"first call's per-parameter gradient distance worst {[f'{d[0][0]:.3e} ({d[0][1]})' for d in dists]} "
        f"(limit {limit:.0e}){halves_s}; global gradient norm over one device's {[f'{x:.6f}' for x in ratios]}; "
        f"launches one device {json.dumps(ref['launches'])}, ranks {[json.dumps(r['launches']) for r in ranks]}; "
        f"parameters bit-equal across ranks {same}")
    check(same, f"[multidevice] {run}: parameters differ across ranks")
    for i, (r, d) in enumerate(zip(ranks, dists)):
        # the losses: float32 at rtol 2e-4, as JAX's multi-device tests;
        # bfloat16 at 2e-3 (half a bf16 ulp); where the run has a halves
        # reference, at 1e-6 of that one device, which computes the mesh's
        # function. The first call's gradients within the run's limit
        # (MULTIDEVICE_RUNS), and within its halves limit of one device
        # warping the ranks' halves. The global norm within 1 % of one
        # device's: the trap (gradients n_view times or 1/n_data of one
        # device's) moves it by 50 % or more
        if halves is None:
            np.testing.assert_allclose(r["losses"], ref["losses"], rtol=2e-4 if f32 else 2e-3)
        else:
            np.testing.assert_allclose(r["losses"], halves["losses"], rtol=1e-6)
            h = to_halves[i][0]
            check(h[0] <= halves_limit, f"[multidevice] {run}: against the views' halves {h[0]:.3e} ({h[1]})")
        check(d[0][0] <= limit, f"[multidevice] {run}: gradients {d[0][0]:.3e} ({d[0][1]}) > {limit:.3e}")
        for name, n in ref["launches"].items():
            check((n > 0) == (r["launches"][name] > 0), f"[multidevice] {run}: {name} launched {r['launches'][name]}")
    check(all(abs(x - 1) <= 1e-2 for x in ratios), f"[multidevice] {run}: gradient norm ratios {ratios}")
    launched = {k for k, n in ref["launches"].items() if n > 0 and k != "warp_tiles"}
    if ref["launches"]["warp_tiles"]:
        launched.add(WARP_ENTRY[torch.float32 if f32 else torch.bfloat16])
    check(set(ranks[0]["readings"]) == launched,
          f"[multidevice] {run}: kernels held at the mesh's shapes {sorted(ranks[0]['readings'])}, launched {launched}")
    total = {}
    for r in ranks:
        tally(total, r["launches"], f32)
    return total, ranks[0]["readings"]


def world_of_one(dev):
    """(a): the flagship's train step x3 and an eval step through
    ``make_mesh()`` with no process group (the 1x1 mesh), against
    today's single-device path: bit-equal, with the same launches."""
    from vsta_tpu_torch.config import load_config
    from vsta_tpu_torch.parallel import make_mesh
    from vsta_tpu_torch.training.state import create_state, make_eval_step

    cfg = load_config(str(FLAGSHIP))
    mesh = make_mesh()
    check(mesh.shape == {"data": 1, "view": 1} and mesh.group is None, f"world of one: {mesh}")
    out = {}
    for label, m in (("single-device", None), ("1x1 mesh", mesh)):
        res = multidevice_steps(cfg, dev, m)
        state = create_state(cfg, res["state"], device=dev, steps_per_epoch=100, mesh=m)
        counters = all_counters()
        before = [c.launches for c in counters]
        res["eval"] = {k: v.cpu() for k, v in make_eval_step(cfg)(state, train_batch(cfg, 2, 9)).items()}
        res["eval_launches"] = [c.launches - b for c, b in zip(counters, before)]
        out[label] = res
    a, b = out["single-device"], out["1x1 mesh"]
    same = (a["losses"] == b["losses"] and all(torch.equal(a["state"][k], b["state"][k]) for k in a["state"])
            and all(torch.equal(a["eval"][k], b["eval"][k]) for k in a["eval"]))
    log(f"[multidevice] a: world of one, flagship as it stands, 3 train steps and an eval step: losses "
        f"{a['losses']} / {b['losses']}; launches {json.dumps(a['launches'])} / {json.dumps(b['launches'])}, "
        f"eval {a['eval_launches']} / {b['eval_launches']}; bit-equal {same}")
    check(same, "a world of one is not bit-equal to the single-device step")
    check(a["launches"] == b["launches"] and a["eval_launches"] == b["eval_launches"], "world of one: launches differ")
    total = {k: a["launches"][k] + b["launches"][k] for k in a["launches"]}
    total["warp_tiles"] += a["eval_launches"][0] + b["eval_launches"][0]  # all_counters() starts with warp_tiles
    return tally({}, total)


def multidevice_phase(dev):
    """The mesh on the card: (a) a world of one through the new code; (b)
    to (e) MULTIDEVICE_RUNS, each two gloo ranks on cuda:0 held to the same
    run on one device: the sharded math and the kernels a shard runs, not
    NCCL. Returns the launches by kernels-line entry and rank 0's kernel
    readings at the shapes the mesh gave them."""
    import shutil
    import tempfile

    launches = world_of_one(dev)
    readings = []
    tmp = Path(tempfile.mkdtemp(prefix="vsta_mesh_"))
    try:
        for run in MULTIDEVICE_RUNS:
            part, reading = multidevice_run(dev, run, tmp)
            for k, n in part.items():
                launches[k] = launches.get(k, 0) + n
            readings.append(reading)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    log(f"[multidevice] launches on the mesh runs (world of one and both ranks of b-e): {json.dumps(launches)}")
    return launches, readings


def view_halves():
    """The one-device view-summed warps (concat's ``warp_proj`` and the
    deformable query's ``fused_warp_proj``) in the two halves of the views
    that a 1x2 mesh's ranks hold, each half's features contiguous as the
    rank's slice is, the halves added in the compute dtype and the bias
    added once after, as ``warp_proj_sharded`` and its all-reduce do:
    (module, name, value)."""
    from vsta_tpu_torch.models import bevnet

    def halves_of(whole):
        def halves(feats, coords, kernel, bias, dtype, **kw):
            V = feats.shape[1]
            out = None
            for s in (slice(0, V // 2), slice(V // 2, V)):
                c = coords[s] if coords.ndim == 4 else coords[:, s]
                part = whole(feats[:, s].contiguous(), c, kernel[s], None, dtype, **kw)
                out = part if out is None else out + part
            return out if bias is None else out + bias.to(out.dtype)

        return halves

    return [(bevnet, "warp_proj", halves_of(bevnet.warp_proj)),
            (bevnet, "fused_warp_proj", halves_of(bevnet.fused_warp_proj))]


@contextlib.contextmanager
def patched(patches):
    """``patches`` ((module, name, value), as :func:`view_halves` gives
    them) in place for the block."""
    saved = []
    try:
        for module, attr, value in patches:
            saved.append((module, attr, getattr(module, attr)))
            setattr(module, attr, value)
        yield
    finally:
        for module, attr, value in reversed(saved):
            setattr(module, attr, value)


def chained_step_phase(dev):
    """``utils.timing``'s chained forward and decode (the JAX package's
    benchmark protocol) of the flagship at batch 16 and 1: the chained
    scalar and ``forward_decode_fps`` finite."""
    from vsta_tpu_torch.config import load_config
    from vsta_tpu_torch.convert import init_state_dict
    from vsta_tpu_torch.serving import build_serving_fn
    from vsta_tpu_torch.utils.timing import forward_decode_fps, forward_decode_step

    cfg = load_config(str(FLAGSHIP))
    model = build_serving_fn(cfg, init_state_dict(cfg, 0), device=dev).model
    _, K, Rt = serve_inputs(cfg, 16)
    frames = np.random.default_rng(0).standard_normal((16, cfg.data.views, *cfg.data.img_size, 3)).astype(np.float32)
    step, zero = forward_decode_step(cfg, model), torch.zeros((), device=dev)
    for B in (16, 1):
        images, k, rt = (torch.as_tensor(a[:B], device=dev) for a in (frames, K, Rt))
        with torch.no_grad():
            scalar = float(step(images + zero * 1e-30, k, rt))
            fps = forward_decode_fps(cfg, model, images, k, rt)
        log(f"[timing] batch {B}: the chained scalar {scalar:.6g}, forward_decode_fps finite and positive")
        check(math.isfinite(scalar), f"[timing] batch {B}: the chained scalar is {scalar}")
        check(math.isfinite(fps) and fps > 0, f"[timing] batch {B}: forward_decode_fps {fps}")


TF32_HEATMAP_BOUND = 5e-3  # |heatmap with cuDNN's TF32 - without|: ten times the 4.9e-4 an H100 read (PERF.md)


def tf32_phase(dev):
    """cuDNN's TF32 on the f32 convolutions: one f32 wildtrack_sanity
    request (batch 16) and one flagship heatmap (batch 1; its head's
    output convolutions run in f32) with ``cudnn.allow_tf32`` at its
    default (True, where the port leaves it) and off: the heatmaps within
    TF32_HEATMAP_BOUND."""
    from vsta_tpu_torch.config import load_config
    from vsta_tpu_torch.convert import init_state_dict
    from vsta_tpu_torch.serving import build_serving_fn

    for name, B in (("wildtrack_sanity.yaml", 16), ("wildtrack.yaml", 1)):
        cfg = load_config(str(ROOT / "configs" / name))
        serve = build_serving_fn(cfg, init_state_dict(cfg, seed=0), device=dev)
        args = tuple(torch.as_tensor(a, device=dev) for a in serve_inputs(cfg, B))
        res = {}
        for tf32 in (True, False):
            torch.backends.cudnn.allow_tf32 = tf32
            try:
                res[tf32] = serve(*args)["heatmap"].float()
            finally:
                torch.backends.cudnn.allow_tf32 = False
        diff = float((res[True] - res[False]).abs().max())
        log(f"[tf32] {name} B={B} ({serve.model.dtype}): heatmap max |TF32 - f32| {diff:.3e} "
            f"(max heatmap {float(res[False].max()):.3f})")
        check(diff <= TF32_HEATMAP_BOUND, f"[tf32] {name}: TF32 moved the heatmap by {diff} > {TF32_HEATMAP_BOUND}")
        del serve


def overfit_phase(dev, timeout=900):
    """``python -m vsta_tpu_torch.overfit_check`` on the card: ResNet-18,
    4 views at 216x384, batch 2, 40 epochs; it must reach F1 0.8."""
    import tempfile

    work = tempfile.mkdtemp(prefix="vsta_overfit_")
    r = subprocess.run([sys.executable, "-m", "vsta_tpu_torch.overfit_check", "--work_dir", work],
                       capture_output=True, text=True, timeout=timeout, env={**os.environ, "PYTHONPATH": str(ROOT)},
                       cwd=str(ROOT))
    lines = [x for x in r.stdout.splitlines() if x.startswith("[overfit]") or "phase=eval" in x]
    log(f"[overfit] exit {r.returncode}: " + " | ".join(lines[-6:]))
    import shutil

    shutil.rmtree(work, ignore_errors=True)
    check(r.returncode == 0 and "[overfit] PASS" in r.stdout,
          f"overfit_check did not reach F1 0.8:\n{r.stdout[-3000:]}\n{r.stderr[-3000:]}")


# The harnesses run the kernels in subprocesses, where no capture reaches
# them, so they keep to shapes that kernel_phase, grouped_phase and the
# "train" training case hold against the plain versions: training and
# eval at the flagship's batch 2 (warp_tiles K = 2 x 128, rows 4 and 3 at
# G = 7, K = 2 x 41), artifacts at batch 1 and 2 (warp_tiles K = 128, 256).
E2E_TRAIN = ["--frames", "20", "--epochs", "3", "--batch", "2", "--img_hw", "270x480", "--track"]
E2E_SERVE = ["--clips", "1,2", "--limit", "8"]
E2E_HELD_BATCHES = {"train": (TRAIN_K // 128,), "serve": (1, TRAIN_K // 128, WARP_K // 128)}


def launch_log_totals(path):
    """The launches that the processes logging to ``path`` made
    (``kernels.LAUNCH_LOG_ENV``), summed by kernel, and how many processes
    wrote."""
    lines = [json.loads(x) for x in Path(path).read_text().splitlines()] if Path(path).exists() else []
    total = {}
    for rec in lines:
        for k, n in rec["launches"].items():
            total[k] = total.get(k, 0) + n
    return total, len(lines)


def e2e_phase(dev, cfg_path=FLAGSHIP, train_args=E2E_TRAIN, serve_args=E2E_SERVE, timeout=600):
    """The recorded-accuracy harnesses on the card, as subprocesses:
    ``python -m vsta_tpu_torch.train_synthetic_e2e`` of the flagship at
    full width on a small tree (E2E_TRAIN), then ``python -m
    vsta_tpu_torch.bench_serve_e2e`` (E2E_SERVE) on its checkpoint with
    ``--overlap`` off and on at once. Both exit 0; every metric finite, the
    ground truth not empty, every served frame scored, the MOT numbers
    equal with and without ``--overlap``. Returns the launches of every
    process the harnesses started (``kernels.LAUNCH_LOG_ENV``) by
    kernels-line entry, and no readings."""
    import shutil
    import tempfile

    import yaml

    arg = dict(zip(train_args, train_args[1:]))
    clips = [int(c) for c in serve_args[serve_args.index("--clips") + 1].split(",")]
    check(int(arg["--batch"]) in E2E_HELD_BATCHES["train"] and set(clips) <= set(E2E_HELD_BATCHES["serve"]),
          f"[e2e] batch {arg['--batch']} / clips {clips}: the kernels are held only at {E2E_HELD_BATCHES}")
    tmp = Path(tempfile.mkdtemp(prefix="vsta_e2e_"))
    try:
        log_path = tmp / "launches.jsonl"
        env = {**os.environ, "PYTHONPATH": str(ROOT), "TMPDIR": str(tmp), "VSTA_TORCH_LAUNCH_LOG": str(log_path)}
        r = subprocess.run([sys.executable, "-m", "vsta_tpu_torch.train_synthetic_e2e", "--config", str(cfg_path),
                            "--work_dir", str(tmp / "run"), *train_args], capture_output=True, text=True,
                           timeout=timeout, env=env, cwd=str(ROOT))
        lines = dict(re.findall(r"^\[(e2e-result|track-result)\] (\{.*\})$", r.stdout, re.MULTILINE))
        log(f"[e2e] train_synthetic_e2e {' '.join(train_args)}: exit {r.returncode}")
        check(r.returncode == 0 and set(lines) == {"e2e-result", "track-result"},
              f"[e2e] train_synthetic_e2e failed:\n{r.stdout[-3000:]}\n{r.stderr[-3000:]}")
        summary = json.loads(lines["e2e-result"])
        log(f"[e2e] e2e-result {json.dumps(summary)}")
        metrics = {k: v for k, v in summary.items() if isinstance(v, (int, float))}
        check(all(math.isfinite(v) for v in metrics.values()) and summary["track_n_gt"] > 0 and summary["n_frames"] > 0,
              f"[e2e] a non-finite metric or no ground truth: {summary}")
        train_launches, n_train = launch_log_totals(log_path)
        log_path.unlink()

        frames = int(serve_args[serve_args.index("--limit") + 1])
        root = tmp / f"vsta_e2e_{arg['--frames']}f_{arg['--img_hw']}"
        save_dir = yaml.safe_load(Path(cfg_path).read_text())["RUNTIME"]["SAVE_DIR"]
        cmd = [sys.executable, "-m", "vsta_tpu_torch.bench_serve_e2e", "--checkpoint",
               str(tmp / "run" / save_dir / "best"), "--config", str(cfg_path), "--data", str(root), *serve_args]
        runs = {}
        for mode in ("sync", "overlap"):  # the two at once, each in a directory of its own
            (tmp / mode).mkdir()
            runs[mode] = subprocess.Popen(cmd + (["--overlap"] if mode == "overlap" else []), stdout=subprocess.PIPE,
                                          stderr=subprocess.PIPE, text=True, env={**env, "TMPDIR": str(tmp / mode)},
                                          cwd=str(ROOT))
        try:
            outs = {mode: p.communicate(timeout=timeout) for mode, p in runs.items()}
        finally:
            for p in runs.values():
                p.kill()
        rows = {}
        for mode, (out, err) in outs.items():
            check(runs[mode].returncode == 0, f"[e2e] bench_serve_e2e ({mode}) failed:\n{out[-3000:]}\n{err[-3000:]}")
            rows[mode] = [json.loads(m) for m in re.findall(r"^\[serve-e2e\] (\{.*\})$", out, re.MULTILINE)]
            for row in rows[mode]:
                log(f"[e2e] bench_serve_e2e ({mode}) {json.dumps(row)}")
                served = sorted((tmp / mode).glob(f"vsta_serve_e2e_*/serve_clips{row['clips']}/frame_*.json"))
                check(row["frames"] == frames == len(served),
                      f"[e2e] clips {row['clips']} ({mode}): {row['frames']} frames served, {len(served)} scored")
                check(all(math.isfinite(row[k]) for k in ("mota", "idf1", "motp_m", "id_switches")),
                      f"[e2e] a non-finite MOT number: {row}")
            per_clip = re.findall(r"^\[serve-e2e\] per-clip: (\{.*\})$", out, re.MULTILINE)
            check(sum(c["n_gt"] for c in json.loads(per_clip[-1]).values()) > 0, f"[e2e] no ground truth: {per_clip}")
        mot = {mode: [{k: r[k] for k in ("clips", "mota", "idf1", "motp_m", "id_switches", "frames")} for r in rs]
               for mode, rs in rows.items()}
        log(f"[e2e] bench_serve_e2e {' '.join(serve_args)}, sync and --overlap at once: "
            f"MOT with --overlap equal to without: {mot['sync'] == mot['overlap']}")
        check([r["clips"] for r in rows["sync"]] == clips and mot["sync"] == mot["overlap"],
              f"[e2e] --overlap changed the MOT numbers: {mot}")
        serve_launches, n_serve = launch_log_totals(log_path)
        launches = {k: train_launches.get(k, 0) + serve_launches.get(k, 0) for k in {**train_launches, **serve_launches}}
        log(f"[e2e] launches: train_synthetic_e2e {json.dumps(train_launches)} ({n_train} process); the exports and "
            f"serve CLIs {json.dumps(serve_launches)} ({n_serve} processes)")
        for name in ("warp_tiles", "sample_tiles_grouped", "scatter_taps_grouped"):
            check(train_launches.get(name, 0) > 0, f"[e2e] {name} was not launched in training")
        check(serve_launches.get("warp_tiles", 0) > 0, "[e2e] warp_tiles was not launched by the artifacts")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return tally({}, launches), []


def main() -> int:
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device (torch.cuda.is_available() is False)")
    if "--multidevice-rank" in sys.argv:  # one rank of multidevice_phase's worlds
        i = sys.argv.index("--multidevice-rank")
        return multidevice_worker(sys.argv[i + 1], sys.argv[i + 2])
    sys.path.insert(0, str(ROOT))
    from vsta_tpu_torch import kernels

    t_start = time.perf_counter()
    line = smi()
    dev = torch.device("cuda", 0)
    log(f"[device] {line} | {torch.cuda.get_device_name(0)} | torch {torch.__version__} "
        f"cuda {torch.version.cuda} | python {sys.version.split()[0]}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    t = time.perf_counter()
    names = sorted(p.stem for p in kernels.CSRC.glob("*.cu"))
    texts = kernels.build(*names)
    log(f"[build] {', '.join(names)}: {time.perf_counter() - t:.1f}s")
    for name, text in texts.items():
        for ln in text.splitlines():
            if "registers" in ln or "spill" in ln:
                log(f"[build] {name}: {ln.strip()}")

    if "--baseline" in sys.argv:  # a comparison only: python3 chip_smoke.py --baseline DIR
        baseline_phase(dev, sys.argv[sys.argv.index("--baseline") + 1])
        return 0
    if "--bn-act" in sys.argv:  # the one-pass BatchNorm kernel alone
        bn_act_phase(dev)
        return 0
    if "--gn-act" in sys.argv:  # the one-pass GroupNorm kernel alone
        gn_act_phase(dev)
        return 0
    if "--mvdet" in sys.argv:  # MVDet's serving path alone
        mvdet_phase(dev)
        return 0

    t = time.perf_counter()
    entries = kernel_phase(dev) + grouped_phase(dev) + [perframe_kernel_phase(dev)]
    ablation_entry, bn_entry, gn_entry = ablation_phase(dev), bn_act_phase(dev), gn_act_phase(dev)
    log(f"[kernel] phases {time.perf_counter() - t:.1f}s")
    # launches on the model paths by kernels-line entry, each path counted
    # from 0 over its own run (an artifact's at its capture: a replay goes
    # through no Python wrapper; the harnesses' in their processes), and
    # the kernels' readings at the shapes the ResNet paths and the mesh
    # runs gave them. The ablation variants are on no model path: their
    # count is the attribution run's.
    total, readings = {}, []
    for phase in (serving_phase, mvdet_phase, export_phase, training_cases, loop_phase, determinism_phase,
                  multidevice_phase, tf32_phase, chained_step_phase, overfit_phase, e2e_phase):
        t = time.perf_counter()
        launches, found = phase(dev) or ({}, [])
        log(f"[{phase.__name__}] {time.perf_counter() - t:.1f}s")
        tally(total, launches)
        readings += found
    for reading in readings:
        for entry in entries:
            if entry["name"] in reading:
                entry["other_shapes"].append(reading[entry["name"]])
    entries.append(ablation_entry)
    check(len(entries) == 8, "the kernels line lists eight TPU kernels")
    entries += [bn_entry, gn_entry]  # replace no TPU kernel
    for entry in entries:
        if entry is not ablation_entry:
            entry["launches"] = total.get(entry["name"], 0)
        check(entry["launches"] > 0, f"{entry['name']} was not launched on its path")
    log("[launches] on the model paths (warp_tiles_variant: the attribution run): "
        + json.dumps({e["name"]: e["launches"] for e in entries}))
    log(f"[done] {time.perf_counter() - t_start:.1f}s")
    print(json.dumps({"kernels": entries}))
    print(line)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
