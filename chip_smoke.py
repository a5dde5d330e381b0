#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (vsta_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py
    python3 chip_smoke.py --baseline DIR   # kernel rows 1, 2, 4, 5, 7 of the checkout in DIR beside these

Phases, each of which raises on failure (exit code != 0):

1. device: the card's name and power limit; TF32 off for the f32 phases;
2. build: every CUDA kernel from the sources in this checkout (one nvcc a
   source, all started together);
3. warp kernel vs plain version at the flagship warp shapes (V=7,
   P=34*60, N=120*360, K=16*128 serving and K=2*128 training, LUT from
   ring cameras; 8x8 tiles of the 360-wide grid as the model passes it,
   and runs of 64 cells without it; random taps whose tiles fill many
   pieces of the weight tile), every case launched twice and bit-equal,
   the distinct source rows a tile touches: each case's max error, the
   kernel's time, its plain version's, the library yardstick's
   (torch.sparse.mm) and the least time the card could take;
4. the grouped sampler's four kernels vs plain versions (sample_tiles_grouped,
   scatter_tapdot_grouped, scatter_taps_grouped, taps_dot_grouped) at the
   shapes the training paths give them: the calibrated warps' backward
   (G=7 maps of 35*61 padded rows, N=43,200 samples, K=2*41 flagship and
   2*64 deformable query) and the deformable fusion's sampler (G=56 and
   448, N=10,800 at ATTN_STRIDE 4 and 172,800 at 1, K=32), with ragged K,
   all-zero weights on poisoned maps, non-finite coordinates and hot rows
   (every sample at one coordinate: four rows of 43,200 taps a group);
   sample_tiles_grouped bit-equal to its plain version in every case;
   sample_tiles_grouped and taps_dot_grouped at every branch of their work
   partition (K = 1, 2, 13, 26, 41, 82, 32, 128 and 1,280, bf16 and f32,
   maps and cotangents aligned and at an odd element offset, N = 43,197:
   short last blocks and output runs off 16 bytes), each launch's
   partition as the library reports it equal to grouped_cuda's mirror;
   the scatters' inverse LUT (tap_lut) equal to its plain version,
   scatter_taps_grouped's dmaps bit-equal to the fused kernel's, two
   launches of each of the four bit-equal; the same readings for each, rows 3 and 6
   split into the sort (lut_ms) and the walk (kernel_ms), row 3's library
   yardstick with its CSR built beforehand and inside the timed call; a
   sweep of the chunk size; one profiled call of each; both routes of the
   backward that wants both gradients (fused; the two one-sided kernels)
   timed at the sampler's shapes, and one backward of each route under
   torch.cuda.set_sync_debug_mode("error"); the unfused fusions' shapes
   at K = 1,280: G = 14 (training, sample_tiles_grouped and
   scatter_taps_grouped) and G = 112 (serving at
   batch 16: one launch that writes 6.2e9 elements, every group held
   against the plain version, 8 groups at a time);
5. serving: configs/wildtrack.yaml at full width with random weights
   (bf16, batch 16 and 1, and f32 at batch 16, which takes the
   windowed dispatch), launch counts, latency, frames/s, peak memory;
   each layer's time (CUDA events) and one request under torch.profiler
   (device busy share, top kernels); the bf16 heatmaps at batch 16 and 1
   against the same requests with the warp swapped for its plain
   version; then configs/wildtrack_deform.yaml the same way (bf16, batch
   16 and 1; encoder / query warp / deformable fusion / head / decode;
   two launches of sample_tiles_grouped a request; heatmaps with the
   kernels against their plain versions); a small f32 model of each
   family on the card against the CPU;
6. training: configs/wildtrack.yaml as it is (batch 2, ACCUM_STEPS 2,
   bf16) for 8 train-step calls: time per call, frame sets/s, the
   forward/backward/optimizer split, peak memory, launches a call
   (warp_tiles, sample_tiles_grouped and scatter_taps_grouped once each),
   parameters that move on every second call and BatchNorm statistics on
   every call; one call's gradients with the kernels against the same
   call on their plain versions, and against a backward forced through
   the fused kernel; configs/wildtrack_deform.yaml the same way for 10
   calls (sample_tiles_grouped twice, scatter_taps_grouped and
   scatter_tapdot_grouped once each) and for 5 calls with ATTN_STRIDE 1
   (scatter_taps_grouped twice, taps_dot_grouped once), the gradients of
   the offsets and attention heads on a line of their own; both configs
   with per-frame cameras (warp_views_sum once forward, the grouped
   sampler at G = 14 backward) and FUSION attn; a small f32 train step of
   each family on the card against the CPU;
7. the training loop end to end (after phase 6's flagship calls): a
   synthetic Wildtrack tree written by the port's generator in a
   temporary directory (7 views at 1080x1920, 10 frames, 12 people),
   configs/wildtrack.yaml with DATA_ROOT there, EPOCHS 2 and EVAL.INTERVAL 1
   through run_training on the card (two epochs, an eval of 2 frames each,
   finite losses, last and best checkpoints, launches of warp_tiles,
   sample_tiles_grouped and scatter_taps_grouped counted inside the loop;
   epoch times, a step's time and the wait on the Prefetcher's queue);
   ``python -m vsta_tpu_torch.train --resume`` (EPOCHS 3: resumes from
   epoch 2) and ``python -m vsta_tpu_torch.evaluate --split all`` (10
   frames) as subprocesses; the host probe (Pillow, matplotlib, psutil,
   g++ with libjpeg/libpng/zlib) and the decoder the reader used; a
   batch-16 frame set copied pageable and through the Prefetcher's pinned
   non_blocking copy; save, restore and one call bit-equal to uninterrupted
   calls;
8. the dense per-frame warp warp_views_sum vs its plain version at B = 16,
   2 and 1, V = 7, P = 2,040, N = 43,200, C = 128 (bf16 and f32 maps,
   ragged C, an all-blind frame on poisoned maps, non-finite coordinates,
   random taps), every case twice and bit-equal, with the same readings;
   the grouped sampler's kernels at the per-frame
   backward's shapes (G = 14 and 112, K = 128) inside phase 4;
9. the ablation variants of the warp kernel (warp_tiles_variant: full,
   const_weights, row0, no_gather) at K = 2,048, bf16 and f32, each against
   its plain version, 'full' bit-equal to warp_tiles, and one line of the
   four times;
10. determinism: the deform family's residual upsample backward twice,
   bit-equal, and the ops that torch.use_deterministic_algorithms(True,
   warn_only=True) names in one train step of each config (the ResNet
   train paths' two runs are held bit-equal in phase 12);
11. the ResNet family served (after phase 5): configs/wildtrack_sanity.yaml
   (ResNet-18, f32), configs/wildtrack_v1_resnet50.yaml and
   configs/wildtrack_ms_max.yaml (ResNet-18, OUT_INDEX [1, 2], FUSION max,
   2 views; bf16) at full width with random weights, batch 16 and 1:
   request times, peak memory, one launch of sample_tiles_grouped a
   request, the heatmaps with the kernel against its plain version, and
   sample_tiles_grouped at the shape a batch-16 request gives it (held to
   its plain version, timed, bound);
12. the ResNet family trained: each of the three configs as it stands
   (batch 1 f32; batch 2, ACCUM_STEPS 2, bf16; batch 4 bf16) and the sanity
   config with MODEL.NORM group, through the training phase's readings
   (sample_tiles_grouped and scatter_taps_grouped once a call; gradients
   with the kernels against the plain versions), one call's gradients run
   twice and bit-equal, and rows 4 and 3 at the shapes a call gives them;
   then [pretrained]: a torchvision-named ResNet-18 state_dict from a seed
   in a temporary .pth, loaded on the card by create_state with
   MODEL.PRETRAINED true, equal to the file's; and in phase 7, after
   evaluate, ``python -m vsta_tpu_torch.inference --track --clips 2`` on the
   loop's tree and checkpoint, with EVAL.CONF_THRESH 0.05, which the
   untrained heatmap clears (a JSON a frame, with its clip, and confirmed
   tracks in both clips).

Prints the kernels JSON line (eight kernels), the nvidia-smi line, then as the last line
``{"ok": true, "device": {...}}``. Exits non-zero without a CUDA device,
and outside a checkout of the repository.
"""

from __future__ import annotations

import dataclasses
import json
import math
import os
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
FLAGSHIP = ROOT / "configs" / "wildtrack.yaml"
DEFORM = ROOT / "configs" / "wildtrack_deform.yaml"
HBM_BYTES_PER_S = 3.35e12  # H100 SXM data sheet
# peak operation rate by input type (H100 SXM data sheet, dense): bf16 on
# the tensor cores, float32 outside them
PEAK_FLOPS_PER_S = {torch.bfloat16: 989e12, torch.float32: 67e12}
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


def flagship_lut(dev):
    from vsta_tpu_torch.data.synthetic import make_ring_camera
    from vsta_tpu_torch.geometry import bev_sample_coords_with_depth, ground_grid

    Ks, Rts = zip(*(make_ring_camera(v, 7, img_hw=(270, 480)) for v in range(7)))
    K = torch.tensor(np.stack(Ks), dtype=torch.float32, device=dev)
    Rt = torch.tensor(np.stack(Rts), dtype=torch.float32, device=dev)
    grid = ground_grid(*BEV_HW, (-24.0, 24.0, -7.2, 7.2), device=dev)
    coords, _ = bev_sample_coords_with_depth(K, Rt, (270, 480), (34, 60), grid)
    return coords.reshape(7, -1, 2)


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


def perframe_coords(dev, B):
    """[B, 7, N, 2] feature-pixel coordinates of the flagship BEV grid
    under :func:`perframe_cameras`."""
    from vsta_tpu_torch.geometry import bev_sample_coords_with_depth, ground_grid

    K, Rt = (torch.as_tensor(a, device=dev) for a in perframe_cameras(B, 7, (270, 480)))
    grid = ground_grid(*BEV_HW, (-24.0, 24.0, -7.2, 7.2), device=dev)
    coords, _ = bev_sample_coords_with_depth(K, Rt, (270, 480), (34, 60), grid)
    return coords.reshape(B, 7, -1, 2)


def shared_taps_coo(idx, wts, P):
    """The shared-camera warp as a sparse [N, V * P] matrix: the live taps
    of idx/wts [V, N, 4], duplicates summed."""
    V, N, _ = idx.shape
    nz = wts != 0
    row_of = torch.arange(N, device=idx.device)[None, :, None].expand(V, N, 4)[nz]
    col_of = (torch.arange(V, device=idx.device)[:, None, None] * P + idx)[nz].long()
    return torch.sparse_coo_tensor(torch.stack([row_of, col_of]), wts[nz], (N, V * P)).coalesce()


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


def tile_stats(label, idx, wts, P, grid_w):
    """Log the distinct source rows a tile of the warp kernels touches
    (over all views of one frame): what their shared memory is sized for."""
    from vsta_tpu_torch.ops.warp_views_cuda import A_SLOTS, distinct_rows_per_tile

    T = distinct_rows_per_tile(idx, wts, P, grid_w).float()
    live = int(((wts != 0) & (idx >= 0) & (idx < P)).sum())
    padded = float(((T + 15) // 16 * 16).clamp_min(16).sum()) * 64
    tiling = f"8x8 of a {grid_w}-wide grid" if grid_w else "runs of 64 cells"
    log(f"[tiles] {label} ({tiling}): {T.numel()} tiles, distinct rows a tile mean {float(T.mean()):.1f} max "
        f"{int(T.max())} (weight-tile piece {A_SLOTS[1]} slots, {A_SLOTS[3]} with 3 planes: tiles over it "
        f"{int((T > A_SLOTS[1]).sum())} / {int((T > A_SLOTS[3]).sum())}); padded products / live taps "
        f"{padded / max(live, 1):.2f}")


def kernel_phase(dev):
    from vsta_tpu_torch.ops.warp import precompute_warp_lut
    from vsta_tpu_torch.ops.warp_cuda import warp_tiles, warp_tiles_ref
    from vsta_tpu_torch.utils.timing import cuda_ms

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
    tile_stats("the flagship LUT", idx, wts, P, Wb)
    tile_stats("the flagship LUT", idx, wts, P, None)
    tile_stats("random taps", ridx, rwts, P, Wb)

    # timing at the main path's shapes
    nz = wts != 0
    nnz = int(nz.sum())
    rows = torch.unique((torch.arange(V, device=dev)[:, None, None] * P + idx)[nz]).numel()
    coo = shared_taps_coo(idx, wts, P)
    entries = []
    for name, feats, out_dtype, replaces in (
        ("warp_tiles (resident dispatch: compute-dtype out)", bf, torch.bfloat16, f"{WARP_TPU}:162"),
        ("warp_tiles (windowed dispatch: f32 out)", f32, torch.float32, f"{WARP_TPU}:353"),
        (f"warp_tiles K={TRAIN_K} (training forward, resident dispatch)", bf_train, torch.bfloat16, None),
    ):
        Kf = feats.shape[-1]
        ms = cuda_ms(warp_tiles, feats, idx, wts, out_dtype=out_dtype, grid_w=Wb, warmup=5, iters=50)
        plain_ms = cuda_ms(warp_tiles_ref, feats, idx, wts, out_dtype=out_dtype, warmup=1, iters=5)
        csr = coo.to(feats.dtype).to_sparse_csr()
        dense = feats.reshape(V * P, Kf)
        lib_out = torch.sparse.mm(csr, dense)
        lib_err = float((lib_out.float() - warp_tiles_ref(feats, idx, wts, out_dtype=torch.float32)).abs().max())
        library_ms = cuda_ms(torch.sparse.mm, csr, dense, warmup=2, iters=10)
        in_size, out_size = feats.element_size(), torch.empty((), dtype=out_dtype).element_size()
        nbytes = rows * Kf * in_size + N * Kf * out_size + V * N * 4 * 8
        flops = 2 * nnz * Kf
        t_bytes, t_ops = nbytes / HBM_BYTES_PER_S * 1e3, flops / PEAK_FLOPS_PER_S[feats.dtype] * 1e3
        entry = {
            "name": name, "route": "cuda", "source": WARP_SRC, "replaces": replaces,
            "launches": None,
            "max_abs_err": errs[f"bf16->bf16 K={K}" if out_dtype == torch.bfloat16 else f"f32->f32 K={K}"],
            "ms": ms, "plain_ms": plain_ms,
            "bound_ms": max(t_bytes, t_ops), "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "library_ms": library_ms,
        }
        log(
            f"[kernel] {name}: ms={ms:.4f} plain_ms={plain_ms:.4f} library_ms(sparse.mm)={library_ms:.4f} "
            f"(library max_abs_err {lib_err:.3e}) bound_ms={entry['bound_ms']:.4f} ({entry['bound_by']}: "
            f"{nbytes / 1e6:.1f} MB = {rows} source rows read once + out + LUT; {flops / 1e9:.2f} GFLOP "
            f"over {nnz} live taps of {V * N * 4}) roofline_share={entry['bound_ms'] / ms:.3f}"
        )
        if replaces is not None:  # the K=256 shape is row 1's kernel again: logged, not a new entry
            entries.append(entry)
    # batch 1's shape, and the tiling without the grid's width, beside
    more = {
        "K=128 (batch 1)": cuda_ms(warp_tiles, bf[..., :128].contiguous(), idx, wts, out_dtype=torch.bfloat16,
                                   grid_w=Wb, warmup=5, iters=50),
        f"K={K}, runs of 64 cells": cuda_ms(warp_tiles, bf, idx, wts, out_dtype=torch.bfloat16, warmup=5, iters=50),
    }
    log("[kernel] warp_tiles bf16->bf16, ms a launch: " + json.dumps({k: round(v, 4) for k, v in more.items()}))
    return entries


def perframe_kernel_phase(dev):
    """The dense per-frame warp against its plain version at the shapes the
    per-frame concat path gives it (B = 16 serving, 2 training; V = 7,
    P = 34 * 60, N = 120 * 360, C = 128), and its times. Returns the
    kernel's entry."""
    from vsta_tpu_torch.ops.warp import precompute_warp_lut
    from vsta_tpu_torch.ops.warp_views_cuda import warp_views_sum, warp_views_sum_ref
    from vsta_tpu_torch.utils.timing import cuda_ms

    B, V, P, C = 16, 7, 34 * 60, 128
    coords = perframe_coords(dev, B)
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
    for b in (0, 1):
        tile_stats(f"the per-frame LUT, frame {b}", idx[b], wts[b], P, Wb)
    tile_stats("random taps, frame 0", ridx[0], rwts[0], P, Wb)

    def measure(feats, i, w, err_key):
        Bm = feats.shape[0]
        nz = w != 0
        nnz = int(nz.sum())
        rows_g = torch.arange(Bm * V, device=dev).reshape(Bm, V, 1, 1) * P + i
        rows = torch.unique(rows_g[nz]).numel()
        ms = cuda_ms(warp_views_sum, feats, i, w, grid_w=Wb, warmup=3, iters=20)
        plain_ms = cuda_ms(warp_views_sum_ref, feats, i, w, warmup=1, iters=3)
        # the library yardstick: one sparse product with the block-diagonal
        # CSR of the taps, [B*N, B*V*P] @ [B*V*P, C]
        row_of = torch.arange(Bm * N, device=dev).reshape(Bm, 1, N, 1).expand(Bm, V, N, 4)[nz]
        coo = torch.sparse_coo_tensor(torch.stack([row_of, rows_g[nz].long()]), w[nz], (Bm * N, Bm * V * P)).coalesce()
        csr = coo.to(feats.dtype).to_sparse_csr()
        dense = feats.reshape(Bm * V * P, C)
        lib_out = torch.sparse.mm(csr, dense).reshape(Bm, N, C)
        lib_err = float((lib_out.float() - warp_views_sum_ref(feats, i, w)).abs().max())
        library_ms = cuda_ms(torch.sparse.mm, csr, dense, warmup=1, iters=5)
        del coo, csr, lib_out
        nbytes = rows * C * feats.element_size() + Bm * N * C * 4 + 2 * Bm * V * N * 4 * 4
        flops = 2 * nnz * C
        t_bytes, t_ops = nbytes / HBM_BYTES_PER_S * 1e3, flops / PEAK_FLOPS_PER_S[feats.dtype] * 1e3
        shape = f"B={Bm} V={V} P={P} N={N} C={C} {str(feats.dtype).split('.')[-1]}"
        reading = {
            "shape": shape, "max_abs_err": errs[err_key], "ms": ms, "plain_ms": plain_ms,
            "bound_ms": max(t_bytes, t_ops), "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "library_ms": library_ms,
        }
        log(f"[perframe-kernel] warp_views_sum {shape}: ms={ms:.4f} plain_ms={plain_ms:.4f} "
            f"library_ms(sparse.mm, block-diagonal CSR of the taps)={library_ms:.4f} (library max_abs_err {lib_err:.3e}) "
            f"bound_ms={reading['bound_ms']:.4f} ({reading['bound_by']}: {nbytes / 1e6:.1f} MB = {rows} source rows read "
            f"once + f32 out + LUT {2 * Bm * V * N * 16 / 1e6:.1f} MB; {flops / 1e9:.2f} GFLOP over {nnz} live taps of "
            f"{w.numel()}) roofline_share={reading['bound_ms'] / ms:.3f}")
        return reading

    two = tuple(t[:2].contiguous() for t in (bf, idx, wts))
    one = tuple(t[:1].contiguous() for t in (bf, idx, wts))
    readings = [
        measure(bf, idx, wts, "warp_views_sum bf16 B=16 C=128"),
        measure(*two, "warp_views_sum bf16 B=2 C=128 (training)"),
        measure(*one, "warp_views_sum bf16 B=1 C=128 (batch 1)"),
        measure(f32, idx, wts, "warp_views_sum f32 B=16 C=128"),
    ]
    first = readings[0]
    return {
        "name": "warp_views_sum", "route": "cuda", "source": VIEWS_SRC, "replaces": f"{WARP_TPU}:1391",
        "launches": None, **{k: first[k] for k in ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")},
        "shape": first["shape"], "other_shapes": readings[1:],
    }


def ablation_phase(dev):
    """The ablation variants of the warp kernel at the flagship serving
    shape (K = 2,048), bf16 and f32: each against its plain version, 'full'
    bit-equal to warp_tiles, then the four times side by side (the
    attribution run, whose launches are the entry's count) with
    torch.sparse.mm on each variant's taps as the library yardstick.
    Returns the entry of the TPU script's _resident_variant."""
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

    # the attribution run: its launches are what the entry counts. Beside
    # each variant that is a sparse product (all but no_gather) the library
    # yardstick on the same inputs: torch.sparse.mm with the CSR of the
    # taps, its values or columns changed as the variant changes them
    wc.warp_tiles_variant.launches = 0
    times, library, lib_err = {}, {}, 0.0
    as_sparse = {"full": (idx, wts), "const_weights": (idx, torch.full_like(wts, 0.25)), "row0": (torch.zeros_like(idx), wts)}
    for feats, out_dtype in ((bf, torch.bfloat16), (f32, torch.float32)):
        tag = str(out_dtype).split(".")[-1]
        times[tag] = {v: cuda_ms(wc.warp_tiles_variant, feats, idx, wts, v, out_dtype=out_dtype, grid_w=Wb,
                                 warmup=3, iters=30) for v in wc.VARIANTS}
        times[tag]["warp_tiles"] = cuda_ms(wc.warp_tiles, feats, idx, wts, out_dtype=out_dtype, grid_w=Wb,
                                           warmup=3, iters=30)
        library[tag] = {"no_gather": None}
        dense = feats.reshape(V * P, K)
        for variant, (i, w) in as_sparse.items():
            csr = shared_taps_coo(i, w, P).to(feats.dtype).to_sparse_csr()
            ref = wc.warp_tiles_variant_ref(feats, idx, wts, variant, out_dtype=torch.float32)
            lib_err = max(lib_err, float((torch.sparse.mm(csr, dense).float() - ref).abs().max() / ref.abs().max()))
            library[tag][variant] = cuda_ms(torch.sparse.mm, csr, dense, warmup=2, iters=10)
            del csr, ref
    launches = wc.warp_tiles_variant.launches
    check(launches == 2 * len(wc.VARIANTS) * 33, f"ablation launches {launches}")
    live, taps = int((wts != 0).sum()), wts.numel()
    for tag, t in times.items():
        log(f"[ablation] K={K} {tag}, ms a launch: " + json.dumps({k: round(v, 4) for k, v in t.items()})
            + f" ({live} live taps of {taps}: const_weights stages every tap's row; row0 loads the taps and applies "
              f"the weights but stages one row a view; no_gather reads no map); library_ms(sparse.mm, the "
              f"variant's CSR): " + json.dumps({k: v and round(v, 4) for k, v in library[tag].items()}))
    log(f"[ablation] sparse.mm against the variants' plain versions: max_abs_err / max|ref| = {lib_err:.3e}")
    plain_ms = cuda_ms(wc.warp_tiles_variant_ref, bf, idx, wts, "full", out_dtype=torch.bfloat16, warmup=1, iters=5)
    rows = torch.unique((torch.arange(V, device=dev)[:, None, None] * P + idx)[wts != 0]).numel()
    nbytes = rows * K * 2 + N * K * 2 + V * N * 4 * 8
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S * 1e3, 2 * live * K / PEAK_FLOPS_PER_S[torch.bfloat16] * 1e3
    return {
        "name": "warp_tiles_variant", "route": "cuda", "source": WARP_SRC, "replaces": "scripts/roofline_warp.py:190",
        "launches": launches, "max_abs_err": worst, "ms": times["bfloat16"]["full"], "plain_ms": plain_ms,
        # ms, plain_ms, bound_ms and library_ms are the 'full' variant's, bf16: the function warp_tiles computes
        "bound_ms": max(t_bytes, t_ops), "bound_by": "bytes" if t_bytes >= t_ops else "operations",
        "library_ms": library["bfloat16"]["full"], "variants_ms": times, "variants_library_ms": library,
    }


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


def lut_stats(label, idx, wts, P):
    """Log the taps a source row (all in range: what a walk by row takes;
    live: what the scatters sum) and how the chunks of the sorted taps
    split the rows."""
    from vsta_tpu_torch.ops import grouped_cuda as gc

    G, C = idx.shape[0], gc.CHUNK_TAPS
    rows_all = (torch.arange(G, device=idx.device)[:, None, None] * P + idx.long()).reshape(-1)
    per_row = torch.bincount(rows_all, minlength=G * P).float()
    lut = gc.tap_lut(idx, wts, P)
    live = lut.rows[lut.rows < G * P].long()
    per_live = torch.bincount(live, minlength=G * P)
    end = torch.cumsum(per_live, 0)
    start = end - per_live
    read = per_live > 0
    span = (end[read] - 1) // C - start[read] // C + 1  # chunks a live row spans
    log(f"[grouped] taps a source row at {label}: all {idx.numel()} taps, mean {float(per_row.mean()):.1f}, max "
        f"{int(per_row.max())}; the {live.numel()} live ones: mean {float(per_live.float().mean()):.1f}, max "
        f"{int(per_live.max())}, over {int(read.sum())} rows; chunks of {C} taps: {-(-idx.numel() // C)}, "
        f"{-(-live.numel() // C)} with live taps; rows split across chunks {int((span > 1).sum())}, the longest "
        f"over {int(span.max())} chunks")


def chunk_sweep(P, shapes, sizes=(64, 128, 256, 512, 1024)):
    """Rows 3 and 6 over a LUT built beforehand (kernel_ms) at each chunk
    size, bf16; the package's CHUNK_TAPS is put back after."""
    from vsta_tpu_torch.ops import grouped_cuda as gc
    from vsta_tpu_torch.utils.timing import cuda_ms

    keep, times = gc.CHUNK_TAPS, {}
    try:
        for kind, label, (maps, gout, i, w) in shapes:
            lut = gc.tap_lut(i, w, P)
            for C in sizes:
                gc.CHUNK_TAPS = C
                args = (gout, i, w, P) if kind == "scatter_taps_grouped" else (maps, gout, i, w)
                times[f"{kind} {label} C={C}"] = round(cuda_ms(getattr(gc, kind), *args, lut, warmup=2, iters=10), 4)
            del lut
    finally:
        gc.CHUNK_TAPS = keep
    log(f"[grouped] chunk sweep, kernel_ms by taps a chunk (CHUNK_TAPS = {keep}): {json.dumps(times)}")


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
        before = {c.__name__: c.launches for c in grouped_counters()}
        if fused is not None:
            gc.fused_backward_fits = lambda *a, f=fused: f
        torch.cuda.set_sync_debug_mode("error")
        try:
            out.backward(gout)
        finally:
            torch.cuda.set_sync_debug_mode(0)
            gc.fused_backward_fits = fits
        torch.cuda.synchronize()
        launched = {c.__name__: c.launches - before[c.__name__] for c in grouped_counters()}
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
    each launch takes, as the library reports it, equal to grouped_cuda's
    mirror of its rules (which tests/test_torch_grouped_partition.py
    models)."""
    from vsta_tpu_torch.ops import grouped_cuda as gc

    G, N = idx.shape[0], idx.shape[1] - 3
    i, w = idx[:, :N].contiguous(), wts[:, :N].contiguous()
    gen = torch.Generator(device=dev).manual_seed(8)
    taken = {}
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
                    taken.setdefault(name, []).append("{}: V={} L={} S={} cells={}{}".format(
                        kernel.split("_")[0], *lib[:4], " staged" if lib.staged else ""))
                del out, dw, maps, gout
        del maps32, gout32
    log("[partition] rows 4 and 5, each case twice and bit-equal, the library's partition equal to grouped_cuda's "
        "mirror: " + "; ".join(f"{name}: {', '.join(parts)}" for name, parts in taken.items()))


def measure(dev, kind, maps, gout, i, w, max_abs_err, library=True):
    """One grouped kernel at one shape: its time, the plain version's,
    the library yardstick's and the bound from these inputs;
    ``max_abs_err`` is the case's error against the plain version."""
    from vsta_tpu_torch.ops import grouped_cuda as gc
    from vsta_tpu_torch.utils.timing import cuda_ms

    Gm, Pm, Km = maps.shape
    Nm = i.shape[1]
    itemsize = maps.element_size()
    live = w != 0
    n_live, n_taps = int(live.sum()), w.numel()
    rows_g = torch.arange(Gm, device=dev)[:, None, None] * Pm + i
    rows_read = torch.unique(rows_g).numel()
    idx_bytes, wts_bytes = Gm * Nm * 4 * 4, Gm * Nm * 4 * 4
    map_bytes, gout_bytes = rows_read * Km * itemsize, Gm * Nm * Km * itemsize
    fn, plain, args = {
        "sample_tiles_grouped": (gc.sample_tiles_grouped, gc.sample_tiles_grouped_ref, (maps, i, w)),
        "scatter_tapdot_grouped": (gc.scatter_tapdot_grouped, gc.scatter_tapdot_grouped_ref, (maps, gout, i, w)),
        "scatter_taps_grouped": (gc.scatter_taps_grouped, gc.scatter_taps_grouped_ref, (gout, i, w, Pm)),
        "taps_dot_grouped": (gc.taps_dot_grouped, gc.taps_dot_grouped_ref, (maps, gout, i)),
    }[kind]
    ms = cuda_ms(fn, *args, warmup=2, iters=10)
    plain_ms = cuda_ms(plain, *args, warmup=1, iters=3)
    library_ms, lib_s, more = None, "library_ms=null", {}
    if kind in ("scatter_taps_grouped", "scatter_tapdot_grouped"):
        # the two parts of the wrapper's time: the sort, and the walk
        # with its carries over a LUT built beforehand
        lut = gc.tap_lut(i, w, Pm)
        more["lut_ms"] = cuda_ms(gc.tap_lut, i, w, Pm, warmup=2, iters=10)
        more["kernel_ms"] = cuda_ms(fn, *args, lut, warmup=2, iters=10)
        del lut

    def taps_matrix():
        """The sampler as a sparse [G*N, G*P] matrix (4 taps a row)."""
        row_of = torch.arange(Gm * Nm, device=dev)[:, None].expand(Gm * Nm, 4).reshape(-1)
        at = torch.stack([row_of, rows_g.reshape(-1)])
        return torch.sparse_coo_tensor(at, w.reshape(-1), (Gm * Nm, Gm * Pm))

    if kind == "sample_tiles_grouped":
        nbytes = map_bytes + gout_bytes + idx_bytes + wts_bytes  # out has gout's size
        flops = 2 * n_live * Km
        if library:
            csr = taps_matrix().coalesce().to(maps.dtype).to_sparse_csr()
            library_ms = cuda_ms(torch.sparse.mm, csr, maps.reshape(Gm * Pm, Km), warmup=1, iters=5)
            lib_s = f"library_ms(sparse.mm, CSR of the taps)={library_ms:.4f}"
    elif kind == "scatter_taps_grouped":
        nbytes = gout_bytes + idx_bytes + wts_bytes + Gm * Pm * Km * 4
        flops = 2 * n_live * Km
        if library:
            # two ways: the transposed CSR built beforehand, and built
            # from the taps inside the timed call, as the kernel's LUT is
            g2 = gout.reshape(Gm * Nm, Km)
            csr_t = taps_matrix().t().coalesce().to(gout.dtype).to_sparse_csr()
            library_ms = cuda_ms(torch.sparse.mm, csr_t, g2, warmup=1, iters=5)
            del csr_t
            more["library_built_ms"] = cuda_ms(
                lambda: torch.sparse.mm(taps_matrix().t().coalesce().to(gout.dtype).to_sparse_csr(), g2),
                warmup=1, iters=5)
            lib_s = (f"library_ms(sparse.mm, transposed CSR of the taps, built beforehand)={library_ms:.4f}, "
                     f"with the CSR built in the timed call={more['library_built_ms']:.4f}")
    elif kind == "taps_dot_grouped":
        nbytes = map_bytes + gout_bytes + idx_bytes + Gm * Nm * 4 * 4  # it reads no weights
        flops = 2 * n_taps * Km
        if library:
            # torch.sparse.sampled_addmm, (gout @ maps^T) sampled at the
            # taps' CSR pattern, is the same function. On CUDA it takes
            # float32, not bfloat16, so it runs on float32 copies of these
            # inputs, beside the kernel's own time on the same copies.
            # The padded anchored taps of a sample are four distinct
            # rows in increasing order, so idx is the pattern's columns
            # and the values come back in tap order.
            check(bool((i[..., 1:] > i[..., :-1]).all()), f"{kind}: a sample's taps are not distinct and increasing")
            maps_f, gout_f = maps.float(), gout.float()
            crow = torch.arange(Gm * Nm + 1, device=dev, dtype=torch.int32) * 4
            pattern = torch.sparse_csr_tensor(
                crow, rows_g.reshape(-1).int(), torch.zeros(n_taps, device=dev), (Gm * Nm, Gm * Pm),
                check_invariants=False)
            dense = (pattern, gout_f.reshape(Gm * Nm, Km), maps_f.reshape(Gm * Pm, Km).t())
            got = torch.sparse.sampled_addmm(*dense, beta=0.0).values().reshape(Gm, Nm, 4)
            hold(f"sampled_addmm vs taps_dot_grouped_ref {Gm}x{Nm}x{Km} f32", got, plain(maps_f, gout_f, i), "f32")
            del got
            library_ms = cuda_ms(torch.sparse.sampled_addmm, *dense, beta=0.0, warmup=1, iters=5)
            more = {"library_dtype": "float32", "ms_float32": cuda_ms(fn, maps_f, gout_f, i, warmup=2, iters=10)}
            lib_s = (f"library_ms(sparse.sampled_addmm on the taps' CSR pattern, float32: bfloat16 is not "
                     f"implemented)={library_ms:.4f} beside the kernel's float32 ms={more['ms_float32']:.4f}")
            del maps_f, gout_f, pattern, dense
    else:
        nbytes = map_bytes + gout_bytes + idx_bytes + wts_bytes + Gm * Pm * Km * 4 + Gm * Nm * 4 * 4
        flops = 2 * n_live * Km + 2 * n_taps * Km
        lib_s = "library_ms=null (no one call gives dmaps and d_wts)"
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S * 1e3, flops / PEAK_FLOPS_PER_S[maps.dtype] * 1e3
    shape = f"G={Gm} P={Pm} N={Nm} K={Km} {str(maps.dtype).split('.')[-1]}"
    reading = {
        "shape": shape, "max_abs_err": max_abs_err, "ms": ms, "plain_ms": plain_ms,
        "bound_ms": max(t_bytes, t_ops), "bound_by": "bytes" if t_bytes >= t_ops else "operations",
        "library_ms": library_ms, **more,
    }
    split_s = (f" (lut_ms={more['lut_ms']:.4f} + kernel_ms={more['kernel_ms']:.4f})" if "lut_ms" in more else "")
    if kind in ("sample_tiles_grouped", "taps_dot_grouped"):  # out, like maps, is a fresh aligned tensor
        more["partition"] = "V={} L={} S={} cells={} staged={}".format(
            *gc.library_partition(kind, Km, maps.dtype, maps, maps if kind == "sample_tiles_grouped" else gout))
        more["device_ms"] = kernel_device_ms(fn, args, KERNEL_NAMES[kind])
        split_s += f" (device_ms={more['device_ms']} [{more['partition']}])"
    log(f"[grouped] {kind} {shape}: ms={ms:.4f}{split_s} plain_ms={plain_ms:.4f} {lib_s} "
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
    from vsta_tpu_torch.utils.timing import cuda_ms

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

    # the deformable sampler's shapes: B = 2 and 16 at ATTN_STRIDE 4, B = 2 at 1
    deform = {}
    for label, B, stride in (("G=56 N=10800", 2, 4), ("G=448 N=10800", 16, 4), ("G=56 N=172800", 2, 1)):
        d_idx, d_wts = deform_taps(dev, B, stride)
        Gd, Nd = d_idx.shape[:2]
        gen = torch.Generator(device=dev).manual_seed(3)
        d_maps = torch.randn((Gd, P, 32), generator=gen, device=dev)
        d_gout = torch.randn((Gd, Nd, 32), generator=gen, device=dev)
        cases(f"deform {label} K=32 bf16", d_maps.to(bf), d_gout.to(bf), d_idx, d_wts, "bf16")
        if B == 2:
            cases(f"deform {label} K=32 f32", d_maps, d_gout, d_idx, d_wts, "f32")
        deform[label] = (d_maps.to(bf), d_gout.to(bf), d_idx, d_wts)
        del d_maps, d_gout

    # the per-frame backward's shapes: one group a (frame, view) at batch 2
    # (training) and 16 (the deform query warp in serving), K = 128
    perframe = {}
    for label, Bp in (("G=14", 2), ("G=112", 16)):
        p_anchors, p_wts = anchored_taps(perframe_coords(dev, Bp).reshape(Bp * 7, N, 2), (Hf, Wf))
        p_idx, p_wts = flat_taps(p_anchors, Wf + 1), p_wts.contiguous()
        gen = torch.Generator(device=dev).manual_seed(5)
        p_maps = torch.randn((Bp * 7, P, 128), generator=gen, device=dev)
        p_gout = torch.randn((Bp * 7, N, 128), generator=gen, device=dev)
        cases(f"per-frame {label} N={N} K=128 bf16", p_maps.to(bf), p_gout.to(bf), p_idx, p_wts, "bf16")
        if Bp == 2:
            cases(f"per-frame {label} N={N} K=128 f32", p_maps, p_gout, p_idx, p_wts, "f32")
        perframe[label] = (p_maps.to(bf), p_gout.to(bf), p_idx, p_wts)
        del p_maps, p_gout

    # the unfused fusions' shapes: warp_views on the applied encoder
    # projection, K = FEAT_DIM 1280. Training (batch 2): G = 14, rows 4 and 3
    gen = torch.Generator(device=dev).manual_seed(6)
    p_idx, p_wts = perframe["G=14"][2:]
    wide14 = (torch.randn((14, P, 1280), generator=gen, device=dev).to(bf),
              torch.randn((14, N, 1280), generator=gen, device=dev).to(bf), p_idx, p_wts)
    cases(f"unfused G=14 N={N} K=1280 bf16", *wide14, "bf16", one_sided=True)
    # serving (batch 16): G = 112, an output of 6.2e9 elements, the one
    # launch of the port whose offsets pass 2**32. The kernel runs once on
    # the whole input; its plain version, which would not fit, on 8 groups
    # at a time, every group held
    p_idx, p_wts = perframe["G=112"][2:]
    w_maps = torch.randn((112, P, 1280), generator=gen, device=dev).to(bf)
    out = gc.sample_tiles_grouped(w_maps, p_idx, p_wts)
    torch.cuda.synchronize()
    check(tuple(out.shape) == (112, N, 1280) and out.dtype == bf and out.numel() > 2**32, "unfused G=112: shape/dtype")
    first_past = 2**32 // (N * 1280) + 1  # the first group that starts past 2**32 elements
    worst, worst_past, bad = 0.0, 0.0, []
    for g0 in range(0, 112, 8):
        ref = gc.sample_tiles_grouped_ref(w_maps[g0:g0 + 8], p_idx[g0:g0 + 8], p_wts[g0:g0 + 8])
        diff = (out[g0:g0 + 8].float() - ref.float()).abs()
        per_group = diff.amax(dim=(1, 2))
        ok = (out[g0:g0 + 8] == ref).all(dim=2).all(dim=1)
        bad += [g0 + j for j in range(8) if not bool(ok[j])]
        worst = max(worst, float(per_group.max()))
        worst_past = max([worst_past] + [float(per_group[j]) for j in range(8) if g0 + j >= first_past])
        del ref, diff
    log(f"[kernel] sample_tiles_grouped unfused G=112 N={N} K=1280 bf16 ({out.numel()} elements out), all 112 groups "
        f"against the plain version 8 at a time: max_abs_err={worst:.3e}; groups {first_past}..111, which start past "
        f"2**32 elements: {worst_past:.3e} (bit-equal) {'ok' if not bad else 'FAIL'}")
    check(not bad, f"sample_tiles_grouped at G=112 K=1280 disagrees with the plain version in groups {bad}")
    del out
    wide_ms = cuda_ms(gc.sample_tiles_grouped, w_maps, p_idx, p_wts, warmup=1, iters=3)
    rows_read = torch.unique(torch.arange(112, device=dev)[:, None, None] * P + p_idx).numel()
    wide_bytes = rows_read * 1280 * 2 + 112 * N * 1280 * 2 + 2 * 112 * N * 4 * 4
    log(f"[grouped] sample_tiles_grouped G=112 P={P} N={N} K=1280 bfloat16: ms={wide_ms:.4f} "
        f"bound_ms={wide_bytes / HBM_BYTES_PER_S * 1e3:.4f} (bytes: {wide_bytes / 1e6:.1f} MB); plain_ms and library_ms "
        f"not measured (neither fits beside the 12.4 GB output)")
    del w_maps
    torch.cuda.empty_cache()

    flag = (maps32[..., :K].to(bf).contiguous(), gout32[..., :K].to(bf).contiguous(), idx, wts)
    query = (maps32.to(bf).contiguous(), gout32.to(bf).contiguous(), idx, wts)
    s4, s4b16, s1 = deform["G=56 N=10800"], deform["G=448 N=10800"], deform["G=56 N=172800"]
    pf14, pf112 = perframe["G=14"], perframe["G=112"]
    # each kernel's entry is at a shape its main path gives it; the others follow
    plan = (
        ("scatter_taps_grouped", 686, [
            (query, "dmaps3 bf16 K=128", True), (flag, f"dmaps3 bf16 K={K}", True),
            (s1, "dmaps3 deform G=56 N=172800 K=32 bf16", True), (s4, "dmaps3 deform G=56 N=10800 K=32 bf16", True),
            (pf14, f"dmaps3 per-frame G=14 N={N} K=128 bf16", True), (pf112, f"dmaps3 per-frame G=112 N={N} K=128 bf16", True),
            (wide14, f"dmaps3 unfused G=14 N={N} K=1280 bf16", True)]),
        ("sample_tiles_grouped", 955, [
            (flag, f"sample bf16 K={K}", True), (query, "sample bf16 K=128", True),
            (s4, "sample deform G=56 N=10800 K=32 bf16", True), (s4b16, "sample deform G=448 N=10800 K=32 bf16", True),
            (s1, "sample deform G=56 N=172800 K=32 bf16", True),
            (pf14, f"sample per-frame G=14 N={N} K=128 bf16", True), (pf112, f"sample per-frame G=112 N={N} K=128 bf16", True),
            (wide14, f"sample unfused G=14 N={N} K=1280 bf16", True)]),
        ("taps_dot_grouped", 1125, [
            (s1, "d_wts5 deform G=56 N=172800 K=32 bf16", True), (s4, "d_wts5 deform G=56 N=10800 K=32 bf16", True),
            (query, "d_wts5 bf16 K=128", True)]),
        ("scatter_tapdot_grouped", 1288, [
            (s4, "dmaps deform G=56 N=10800 K=32 bf16", False), (s4b16, "dmaps deform G=448 N=10800 K=32 bf16", False),
            (s1, "dmaps deform G=56 N=172800 K=32 bf16", False), (flag, f"dmaps bf16 K={K}", False)]),
    )
    entries = []
    for kind, line, shapes in plan:
        readings = [measure(dev, kind, *inputs, errs[key], library=lib) for inputs, key, lib in shapes]
        first = dict(readings[0])
        entries.append({
            "name": kind, "route": "cuda", "source": GROUPED_SRC, "replaces": f"{WARP_TPU}:{line}",
            "launches": None, **{k: first[k] for k in ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")},
            **{k: first[k] for k in ("lut_ms", "kernel_ms", "library_built_ms") if k in first},
            "shape": first["shape"], "other_shapes": readings[1:],
        })

    # where the device time of one call goes: the key kernel and the sort's
    # passes, the memset, the walk and the carries
    profile_request(gc.scatter_taps_grouped, (flag[1], flag[2], flag[3], P), f"scatter_taps_grouped G=7 K={K} bf16")
    profile_request(gc.scatter_tapdot_grouped, s4, "scatter_tapdot_grouped G=56 N=10800 K=32 bf16")

    # the two routes of the backward that wants both gradients, at the
    # deformable sampler's shapes (the reference takes the fused kernel at
    # ATTN_STRIDE 4 and the two one-sided kernels at 1)
    def split_route(maps, gout, i, w):
        return gc.scatter_taps_grouped(gout, i, w, maps.shape[1]), gc.taps_dot_grouped(maps, gout, i)

    for label, inputs in (("ATTN_STRIDE 4 (G=56 N=10800 K=32)", s4), ("ATTN_STRIDE 1 (G=56 N=172800 K=32)", s1)):
        fits = gc.fused_backward_fits(P, inputs[2].shape[1], 32, bf)
        fused_ms = cuda_ms(gc.scatter_tapdot_grouped, *inputs, warmup=2, iters=10)
        split_ms = cuda_ms(split_route, *inputs, warmup=2, iters=10)
        log(f"[grouped] backward routes at {label}, bf16: fused scatter_tapdot_grouped {fused_ms:.4f} ms; "
            f"scatter_taps_grouped + taps_dot_grouped {split_ms:.4f} ms; the dispatch takes "
            f"{'the fused kernel' if fits else 'the two one-sided kernels'}")
    lut_stats("G=7 N=43200 (the flagship warp's taps)", idx, wts, P)
    lut_stats("hot rows G=7 N=43200", *hot, P)
    lut_stats("deform G=56 N=172800", s1[2], s1[3], P)
    chunk_sweep(P, (("scatter_taps_grouped", f"K={K}", flag), ("scatter_taps_grouped", "K=128", query),
                    ("scatter_taps_grouped", "per-frame G=14 K=128", pf14), ("scatter_taps_grouped", "deform s1 K=32", s1),
                    ("scatter_tapdot_grouped", "deform s4 K=32", s4), ("scatter_tapdot_grouped", f"K={K}", flag)))
    sync_free_backward(s4)
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


def timed_requests(cfg, serve_fn, inputs, B, warm, timed, label):
    """``warm`` + ``timed`` requests of batch B; logs the median latency
    and the peak memory; returns (last output, requests made)."""
    args = tuple(a[:B] for a in inputs)
    for _ in range(warm):
        check_served(cfg, serve_fn(*args), B)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    lat = []
    for _ in range(timed):
        t = time.perf_counter()
        out = serve_fn(*args)
        torch.cuda.synchronize()
        lat.append(time.perf_counter() - t)
        check_served(cfg, out, B)
    peak = torch.cuda.max_memory_allocated() / 2**30
    med = float(np.median(lat))
    log(f"[serve] {label} B={B}: latency per request (host clock, uint8 frames in, synchronised) "
        f"median={med * 1e3:.2f} ms all={[round(x * 1e3, 2) for x in lat]} -> {B / med:.1f} f/s; "
        f"peak device memory {peak:.2f} GiB; valid dets/frame {float(out['valid'].float().sum(1).mean()):.1f}")
    return out, warm + timed


def deform_serving_phase(dev, cfg_path=DEFORM):
    """configs/wildtrack_deform.yaml served at full width (bf16, batch 16
    and 1, random weights): latency, the forward's parts, peak memory,
    two launches of sample_tiles_grouped a request, and the heatmap with
    the kernels against the heatmap with their plain versions. Returns
    the launches."""
    from vsta_tpu_torch.config import load_config
    from vsta_tpu_torch.convert import init_state_dict
    from vsta_tpu_torch.geometry import bev_sample_coords_with_depth, ground_grid
    from vsta_tpu_torch.models.bevnet import positional_encoding
    from vsta_tpu_torch.ops.decode import decode_detections
    from vsta_tpu_torch.serving import build_serving_fn
    from vsta_tpu_torch.utils.timing import cuda_ms

    cfg = load_config(str(cfg_path))
    (H, W), (Hb, Wb) = cfg.data.img_size, cfg.model.bev_size
    t0 = time.perf_counter()
    state = wake_sampling_heads(init_state_dict(cfg, seed=0))
    serve = build_serving_fn(cfg, state, device="cuda")
    model = serve.model
    log(f"[deform-serve] model built: {sum(v.numel() for v in state.values())} weights, "
        f"{time.perf_counter() - t0:.1f}s, compute dtype {model.dtype}, ATTN_STRIDE {model.attn_stride}")
    inputs = serve_inputs(cfg)
    counters = grouped_counters() + (warp_tiles_counter(),)
    reset(counters)
    _, n16 = timed_requests(cfg, serve, inputs, 16, 3, 5, "deform bf16")
    _, n1 = timed_requests(cfg, serve, inputs, 1, 2, 5, "deform bf16")
    launches = {c.__name__: c.launches for c in counters}
    log(f"[deform-serve] {n16 + n1} requests, launches {json.dumps(launches)}")
    check(launches == {"sample_tiles_grouped": 2 * (n16 + n1), "scatter_tapdot_grouped": 0, "scatter_taps_grouped": 0,
                       "taps_dot_grouped": 0, "warp_tiles": 0}, f"deform serving launches {launches}")

    # the forward's parts (CUDA events)
    x, k, rt = (torch.as_tensor(a, device=dev) for a in inputs)
    with torch.no_grad():
        normed = (x.float() - 127.5) / 64.0
        kw = dict(bounds=cfg.model.bev_bounds, conf_thresh=cfg.eval.conf_thresh,
                  nms_dist_m=cfg.eval.nms_dist_m, max_dets=cfg.eval.max_dets)
        for B in (16, 1):
            feats = model.encoder(normed[:B])
            Hf, Wf = feats.shape[2:4]
            grid = ground_grid(Hb, Wb, cfg.model.bev_bounds, device=dev)
            coords, depth_w = bev_sample_coords_with_depth(k[0], rt[0], (H, W), (Hf, Wf), grid)
            pos = positional_encoding(Hb, Wb, cfg.model.bev_bounds, device=dev)[None].expand(B, Hb, Wb, 2)
            query = model.warped_query(feats, coords)
            q_in = torch.cat([query, pos.to(query.dtype)], dim=-1)
            outs = model(x[:B], k[:B], rt[:B])
            layers = {
                "encoder": cuda_ms(model.encoder, normed[:B], warmup=2, iters=5),
                "query_warp": cuda_ms(model.warped_query, feats, coords, warmup=2, iters=5),
                "deformable_fusion": cuda_ms(model.attention_residual, feats, coords, depth_w, q_in, warmup=2, iters=5),
                "head": cuda_ms(model.detector, outs["bev_feat"].to(model.dtype), warmup=2, iters=5),
                "decode": cuda_ms(decode_detections, outs["heatmap"], outs["offset"], outs["size"],
                                  warmup=2, iters=10, **kw),
                "forward": cuda_ms(model, x[:B], k[:B], rt[:B], warmup=1, iters=5),
            }
            log(f"[deform-serve] layers B={B} (CUDA events, ms): " + json.dumps(layers))
    profile_request(serve, inputs, "one deform B=16 request")

    heatmaps_kernels_vs_plain(serve, inputs, counters, "deform-serve")
    return launches


def grouped_counters():
    from vsta_tpu_torch.ops import grouped_cuda as gc

    return (gc.sample_tiles_grouped, gc.scatter_tapdot_grouped, gc.scatter_taps_grouped, gc.taps_dot_grouped)


def warp_tiles_counter():
    from vsta_tpu_torch.ops.warp_cuda import warp_tiles

    return warp_tiles


def warp_views_sum_counter():
    from vsta_tpu_torch.ops.warp_views_cuda import warp_views_sum

    return warp_views_sum


def all_counters():
    return (warp_tiles_counter(), warp_views_sum_counter()) + grouped_counters()


def with_model_fields(cfg, **fields):
    """``cfg`` with fields of its MODEL section replaced in memory."""
    return dataclasses.replace(cfg, model=dataclasses.replace(cfg.model, **fields))


def reset(counters) -> None:
    for c in counters:
        c.launches = 0


def serving_phase(dev, cfg_path=FLAGSHIP):
    from vsta_tpu_torch.config import load_config
    from vsta_tpu_torch.convert import init_state_dict
    from vsta_tpu_torch.ops.decode import decode_detections
    from vsta_tpu_torch.ops.warp_cuda import warp_out_dtype, warp_tiles
    from vsta_tpu_torch.serving import build_serving_fn
    from vsta_tpu_torch.utils.timing import cuda_ms

    cfg = load_config(str(cfg_path))
    V, (H, W) = cfg.data.views, cfg.data.img_size
    P = math.ceil(H / 8) * math.ceil(W / 8)  # the stride-8 map of OUT_INDEX 2
    t0 = time.perf_counter()
    state = init_state_dict(cfg, seed=0)
    serve = build_serving_fn(cfg, state, device="cuda")
    log(f"[serve] model built: {sum(v.numel() for v in state.values())} weights, "
        f"{time.perf_counter() - t0:.1f}s, compute dtype {serve.model.dtype}")
    frames, K16, Rt16 = serve_inputs(cfg)

    def run(serve_fn, B, warm, timed, label):
        return timed_requests(cfg, serve_fn, (frames, K16, Rt16), B, warm, timed, label)

    launches = {}
    # bf16 main path: batch 16 takes the resident dispatch (compute-dtype out)
    check(warp_out_dtype(V, P, 16 * cfg.model.bev_proj_ch, torch.bfloat16) == torch.bfloat16, "dispatch")
    warp_tiles.launches = 0
    out16, n16 = run(serve, 16, 3, 5, "bf16")
    _, n1 = run(serve, 1, 2, 5, "bf16")
    launches["resident"] = warp_tiles.launches
    log(f"[serve] bf16: {n16 + n1} requests, warp_tiles launches {warp_tiles.launches}")
    check(warp_tiles.launches == n16 + n1, "warp kernel launches != requests on the bf16 path")

    # f32 at batch 16: the windowed dispatch (f32 out)
    cfg32 = dataclasses.replace(cfg, runtime=dataclasses.replace(cfg.runtime, use_amp=False))
    check(warp_out_dtype(V, P, 16 * cfg.model.bev_proj_ch, torch.float32) == torch.float32, "dispatch")
    serve32 = build_serving_fn(cfg32, state, device="cuda")
    warp_tiles.launches = 0
    _, n32 = run(serve32, 16, 1, 2, "f32")
    launches["windowed"] = warp_tiles.launches
    log(f"[serve] f32: {n32} requests, warp_tiles launches {warp_tiles.launches}")
    check(warp_tiles.launches == n32, "warp kernel launches != requests on the f32 path")
    del serve32

    # where a request's time goes: each layer alone (CUDA events), then
    # the device's busy share and top kernels over one request (profiler)
    model = serve.model
    x16 = torch.as_tensor(frames, device=dev)
    k16 = torch.as_tensor(K16, device=dev)
    rt16 = torch.as_tensor(Rt16, device=dev)
    with torch.no_grad():
        outs = model(x16, k16, rt16)
        bev = outs["bev_feat"].to(model.dtype)
        normed = (x16.float() - 127.5) / 64.0
        kw = dict(bounds=cfg.model.bev_bounds, conf_thresh=cfg.eval.conf_thresh,
                  nms_dist_m=cfg.eval.nms_dist_m, max_dets=cfg.eval.max_dets)
        for B in (16, 1):
            layers = {
                "encoder": cuda_ms(model.encoder, normed[:B], warmup=2, iters=5),
                "head": cuda_ms(model.detector, bev[:B], warmup=2, iters=5),
                "decode": cuda_ms(decode_detections, outs["heatmap"][:B], outs["offset"][:B],
                                  outs["size"][:B], warmup=2, iters=10, **kw),
                "forward": cuda_ms(model, x16[:B], k16[:B], rt16[:B], warmup=1, iters=5),
            }
            log(f"[serve] layers B={B} (CUDA events, ms): " + json.dumps(layers))
    profile_request(serve, (frames, K16, Rt16))

    heatmaps_kernels_vs_plain(serve, (frames, K16, Rt16), (warp_tiles,), "serve")
    return launches


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
    from vsta_tpu_torch.ops import grouped_cuda as gc
    from vsta_tpu_torch.ops.warp_cuda import warp_tiles, warp_tiles_ref
    from vsta_tpu_torch.ops.warp_views_cuda import warp_views_sum, warp_views_sum_ref

    model = serve.model
    for B in batches:
        args = tuple(a[:B] for a in inputs)
        got = serve(*args)["heatmap"]
        before = [c.launches for c in counters]
        model.warp, model.views_sum, model.grouped = warp_tiles_ref, warp_views_sum_ref, gc.PLAIN
        try:
            ref = serve(*args)["heatmap"]
        finally:
            model.warp, model.views_sum, model.grouped = warp_tiles, warp_views_sum, gc.KERNELS
        check([c.launches for c in counters] == before, "the plain-version run launched a kernel")
        diff = (got - ref).abs()
        f32 = model.dtype == torch.float32
        ok = bool((diff <= (16 * f32_ulp(ref) if f32 else 2 * bf16_ulp(ref))).all())
        dtype = str(model.dtype).split(".")[-1]
        log(f"[{label}] {dtype} B={B} heatmap, kernels vs plain versions: max_abs_diff={float(diff.max()):.3e}, "
            f"largest in f32 ulps of |ref| {float((diff / f32_ulp(ref)).max()):.1f} "
            f"(<= {'16 f32' if f32 else '2 bf16'} ulps of |ref|) {'ok' if ok else 'FAIL'}")
        check(ok, f"{label}: {dtype} heatmap at batch {B} with the kernels disagrees with the plain versions")


def perframe_serving_phase(dev, cfg_path, family):
    """``cfg_path`` with STATIC_CAMERAS false (one field replaced in
    memory) served at full width with another calibration in every frame
    (bf16, batch 16 and 1): latency, peak memory, launches a request
    (concat: warp_views_sum once and warp_tiles never; deform_attn:
    sample_tiles_grouped twice), the forward's parts with the LUT as its
    own layer, the device's busy share, and the heatmaps with the kernels
    against the plain versions. Returns the launches."""
    from vsta_tpu_torch.config import load_config
    from vsta_tpu_torch.convert import init_state_dict
    from vsta_tpu_torch.geometry import bev_sample_coords_with_depth, ground_grid
    from vsta_tpu_torch.models.bevnet import positional_encoding
    from vsta_tpu_torch.ops.decode import decode_detections
    from vsta_tpu_torch.ops.warp import anchored_taps, flat_taps, precompute_warp_lut
    from vsta_tpu_torch.ops.warp_views_cuda import warp_views_sum
    from vsta_tpu_torch.serving import build_serving_fn
    from vsta_tpu_torch.utils.timing import cuda_ms

    label = f"perframe-{family}"
    cfg = with_model_fields(load_config(str(cfg_path)), static_cameras=False)
    check(cfg.model.fusion == family, f"{cfg_path} is not {family}")
    (H, W), (Hb, Wb) = cfg.data.img_size, cfg.model.bev_size
    state = wake_sampling_heads(init_state_dict(cfg, seed=0))
    serve = build_serving_fn(cfg, state, device="cuda")
    model = serve.model
    check(not model.static_cameras, "the model still shares frame 0's cameras")
    inputs = serve_inputs_perframe(cfg)
    check(float(np.abs(inputs[2][0] - inputs[2][1]).max()) > 0.1, "the frames share a calibration")
    counters = all_counters()
    reset(counters)
    _, n16 = timed_requests(cfg, serve, inputs, 16, 3, 5, f"{family} per-frame cameras bf16")
    _, n1 = timed_requests(cfg, serve, inputs, 1, 2, 5, f"{family} per-frame cameras bf16")
    launches = {c.__name__: c.launches for c in counters}
    log(f"[{label}] {n16 + n1} requests, launches {json.dumps(launches)}")
    a_request = {"warp_views_sum": 1} if family == "concat" else {"sample_tiles_grouped": 2}
    check(launches == {c.__name__: a_request.get(c.__name__, 0) * (n16 + n1) for c in counters},
          f"{label} launches {launches}")

    # the forward's parts (CUDA events); the LUT is rebuilt every request
    x, k, rt = (torch.as_tensor(a, device=dev) for a in inputs)
    kw = dict(bounds=cfg.model.bev_bounds, conf_thresh=cfg.eval.conf_thresh,
              nms_dist_m=cfg.eval.nms_dist_m, max_dets=cfg.eval.max_dets)
    with torch.no_grad():
        normed = (x.float() - 127.5) / 64.0
        grid = ground_grid(Hb, Wb, cfg.model.bev_bounds, device=dev)
        for B in (16, 1):
            enc = model.encoder(normed[:B])
            feats = enc[0] if family == "concat" else enc
            Hf, Wf = feats.shape[2:4]
            coords, depth_w = bev_sample_coords_with_depth(k[:B], rt[:B], (H, W), (Hf, Wf), grid)
            outs = model(x[:B], k[:B], rt[:B])
            layers = {
                "encoder": cuda_ms(model.encoder, normed[:B], warmup=2, iters=5),
                "coords": cuda_ms(bev_sample_coords_with_depth, k[:B], rt[:B], (H, W), (Hf, Wf), grid, warmup=2, iters=5),
            }
            if family == "concat":
                idx, wts = precompute_warp_lut(coords.reshape(B, -1, Hb * Wb, 2), (Hf, Wf))
                proj = torch.randn((B, cfg.data.views, Hf * Wf, cfg.model.bev_proj_ch), device=dev).to(model.dtype)
                layers["lut"] = cuda_ms(precompute_warp_lut, coords, (Hf, Wf), warmup=2, iters=5)
                layers["warp_fusion (projection, lut, kernel, bias)"] = cuda_ms(
                    model._concat, *enc, coords, warmup=2, iters=5)
                layers["warp_views_sum"] = cuda_ms(warp_views_sum, proj, idx, wts, warmup=2, iters=5)
            else:
                def taps(c):
                    anchors, w = anchored_taps(c.reshape(-1, Hb * Wb, 2), (Hf, Wf))
                    return flat_taps(anchors, Wf + 1), w

                pos = positional_encoding(Hb, Wb, cfg.model.bev_bounds, device=dev)[None].expand(B, Hb, Wb, 2)
                query = model.warped_query(feats, coords)
                q_in = torch.cat([query, pos.to(query.dtype)], dim=-1)
                layers["lut"] = cuda_ms(taps, coords, warmup=2, iters=5)
                layers["query_warp (projection, lut, sampler, sum)"] = cuda_ms(model.warped_query, feats, coords, warmup=2, iters=5)
                layers["deformable_fusion"] = cuda_ms(model.attention_residual, feats, coords, depth_w, q_in, warmup=2, iters=5)
            layers["head"] = cuda_ms(model.detector, outs["bev_feat"].to(model.dtype), warmup=2, iters=5)
            layers["decode"] = cuda_ms(decode_detections, outs["heatmap"], outs["offset"], outs["size"],
                                       warmup=2, iters=10, **kw)
            layers["forward"] = cuda_ms(model, x[:B], k[:B], rt[:B], warmup=1, iters=5)
            log(f"[{label}] layers B={B} (CUDA events, ms): " + json.dumps({a: round(b, 4) for a, b in layers.items()}))
    profile_request(serve, inputs, f"one {family} per-frame B=16 request")
    heatmaps_kernels_vs_plain(serve, inputs, counters, label)
    return launches


def fusion_serving_phase(dev, cfg_path=FLAGSHIP):
    """configs/wildtrack.yaml with FUSION max and attn under WARP_IMPL
    gather (fields replaced in memory), served at full width, bf16, batch
    16: every view's BEV map through warp_views (one launch of
    sample_tiles_grouped a request, G = 112, K = FEAT_DIM), then the fusion
    and bev_proj. Latency, peak memory, launches, the forward's parts, and
    the heatmap with the kernel against its plain version at batch 1 (the
    plain sampler at batch 16 would hold several copies of the per-view
    maps; the kernel at that shape, G = 112 and K = 1,280, is held group
    by group in grouped_phase). Returns the launches."""
    from vsta_tpu_torch.config import load_config
    from vsta_tpu_torch.convert import init_state_dict
    from vsta_tpu_torch.geometry import bev_sample_coords_with_depth, ground_grid
    from vsta_tpu_torch.serving import build_serving_fn
    from vsta_tpu_torch.utils.timing import cuda_ms

    base = load_config(str(cfg_path))
    (H, W), (Hb, Wb) = base.data.img_size, base.model.bev_size
    inputs = serve_inputs(base)
    x, k, rt = (torch.as_tensor(a, device=dev) for a in inputs)
    counters = all_counters()
    total = {c.__name__: 0 for c in counters}
    for fusion in ("max", "attn"):
        label = f"fusion-{fusion}"
        cfg = with_model_fields(base, fusion=fusion, warp_impl="gather")
        serve = build_serving_fn(cfg, init_state_dict(cfg, seed=0), device="cuda")
        model = serve.model
        reset(counters)
        _, n16 = timed_requests(cfg, serve, inputs, 16, 2, 3, f"FUSION {fusion} bf16")
        _, n1 = timed_requests(cfg, serve, inputs, 1, 1, 3, f"FUSION {fusion} bf16")
        launches = {c.__name__: c.launches for c in counters}
        log(f"[{label}] {n16 + n1} requests, launches {json.dumps(launches)}")
        check(launches == {c.__name__: (n16 + n1 if c.__name__ == "sample_tiles_grouped" else 0) for c in counters},
              f"{label} launches {launches}")
        total = {a: total[a] + launches[a] for a in total}
        with torch.no_grad():
            normed = (x.float() - 127.5) / 64.0
            feats = model.encoder(normed)
            Hf, Wf = feats.shape[2:4]
            grid = ground_grid(Hb, Wb, cfg.model.bev_bounds, device=dev)
            coords, _ = bev_sample_coords_with_depth(k[0], rt[0], (H, W), (Hf, Wf), grid)
            layers = {
                "forward": cuda_ms(model, x, k, rt, warmup=1, iters=3),
                "encoder": cuda_ms(model.encoder, normed, warmup=1, iters=3),
                "warp_views": cuda_ms(model.per_view, feats, coords, warmup=1, iters=3),
            }
            per_view = model.per_view(feats, coords)
            layers["fusion + bev_proj"] = cuda_ms(model.fuse_views, per_view, warmup=1, iters=3)
            log(f"[{label}] layers B=16 (CUDA events, ms): " + json.dumps({a: round(b, 4) for a, b in layers.items()})
                + f"; per-view maps {tuple(per_view.shape)} {per_view.dtype}, {per_view.numel() * per_view.element_size() / 2**30:.2f} GiB")
            del per_view, feats
        heatmaps_kernels_vs_plain(serve, inputs, counters, label, batches=(1,))
        del serve, model
        torch.cuda.empty_cache()
    return total


def dev_us(e):
    """A profiler event's own device time in microseconds."""
    return getattr(e, "self_device_time_total", None) or getattr(e, "self_cuda_time_total", 0)


def kernel_device_ms(fn, args, kernel, calls=5):
    """Mean device time a call of the kernels whose name holds ``kernel``,
    over ``calls`` calls of fn under torch.profiler: the kernel alone,
    without the gaps between launches that an event timing of calls as
    short as the host's launch takes includes. None if the profiler saw
    no such kernel."""
    from torch.profiler import ProfilerActivity, profile

    fn(*args)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn(*args)
        torch.cuda.synchronize()
    us = [dev_us(e) for e in prof.key_averages()
          if e.device_type == torch.autograd.DeviceType.CUDA and kernel in e.key]
    return sum(us) / 1e3 / calls if us else None


def profile_request(fn, args, label=None) -> None:
    """Device busy share and the top kernels of one call (torch.profiler)."""
    from torch.profiler import ProfilerActivity, profile

    label = label or f"one B={len(args[0])} request"
    fn(*args)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        fn(*args)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t) * 1e3
    # device-side events only (kernels, copies): a CPU op's device time
    # repeats its kernels'
    stats = [e for e in prof.key_averages()
             if e.device_type == torch.autograd.DeviceType.CUDA and not getattr(e, "is_user_annotation", False)]
    busy_ms = sum(dev_us(e) for e in stats) / 1e3
    if busy_ms == 0:
        log("[profile] the profiler recorded no device time: busy share not measured")
        return
    top = sorted(stats, key=dev_us, reverse=True)[:10]
    log(f"[profile] {label}: wall {wall_ms:.2f} ms (profiler on), device busy "
        f"{busy_ms:.2f} ms = {busy_ms / wall_ms:.3f} of wall")
    for e in top:
        log(f"[profile]   {dev_us(e) / 1e3:8.3f} ms  x{e.count:<4d} {e.key[:110]}")


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


B0_STATS = ("encoder.backbone.stem_bn.running_mean", "encoder.backbone.stages.6.0.project_bn.running_var")


def training_phase(dev, cfg, label, per_call, watched, warm=2, timed=8, profile=True, named=(), extra=None,
                   batch_fn=train_batch, stats=B0_STATS):
    """Train-step calls of ``cfg`` on the card: time a call, its split,
    peak memory; each kernel's launches a call against ``per_call``;
    parameters that move on every ACCUM_STEPS-th call and BatchNorm
    statistics on every call; one call's gradients with the kernels
    against the same call on their plain versions, the parameters in
    ``named`` on a line of their own. ``extra(grads_with, g_kernel,
    spread)`` runs a path's own check (``spread``: the worst distance
    between two runs with the kernels). ``per_call`` names the kernels a
    call launches (the others: never); ``batch_fn`` makes the batches;
    ``stats`` names BatchNorm statistics that must move on every call
    (none under GroupNorm). Returns the launches."""
    from vsta_tpu_torch.ops import grouped_cuda as gc
    from vsta_tpu_torch.ops.warp_cuda import warp_tiles, warp_tiles_ref
    from vsta_tpu_torch.ops.warp_views_cuda import warp_views_sum, warp_views_sum_ref
    from vsta_tpu_torch.training.state import (
        apply_gradients, batch_to_device, create_state, gradients, loss_fn, make_train_step,
    )

    B = cfg.data.batch_size
    t0 = time.perf_counter()
    state = create_state(cfg, seed=0, device="cuda", steps_per_epoch=100)
    model = state.model
    log(f"[{label}] state built: {time.perf_counter() - t0:.1f}s, batch {B}, ACCUM_STEPS {cfg.train.accum_steps}, "
        f"compute dtype {model.dtype}, {sum(p.numel() for p in model.parameters())} parameters")
    train_step = make_train_step(cfg)
    batches = [batch_fn(cfg, B, seed) for seed in range(4)]
    stats = list(stats)

    def snapshot(names):
        sd = model.state_dict()
        return {k: sd[k].clone() for k in names}

    counters = all_counters()
    reset(counters)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    lat = []
    for i in range(warm + timed):
        before, before_s = snapshot(watched), snapshot(stats)
        t = time.perf_counter()
        metrics = train_step(state, batches[i % len(batches)])
        torch.cuda.synchronize()
        if i >= warm:
            lat.append(time.perf_counter() - t)
        check(all(bool(torch.isfinite(v)) for v in metrics.values()), f"call {i}: non-finite {metrics}")
        after, after_s = snapshot(watched), snapshot(stats)
        moved = [not torch.equal(before[k], after[k]) for k in watched]
        update = state.step % cfg.train.accum_steps == 0
        check(all(moved) if update else not any(moved),
              f"call {state.step}: parameters moved {moved}, expected {'all' if update else 'none'}")
        check(all(not torch.equal(before_s[k], after_s[k]) for k in stats), f"call {state.step}: statistics still")
    launches = {c.__name__: c.launches for c in counters}
    peak = torch.cuda.max_memory_allocated() / 2**30
    med = float(np.median(lat))
    log(f"[{label}] {warm + timed} calls: per call (host clock, synchronised) median={med * 1e3:.2f} ms "
        f"all={[round(x * 1e3, 2) for x in lat]} -> {B / med:.2f} frame sets/s; peak device memory {peak:.2f} GiB; "
        f"last losses {json.dumps({k: round(float(v), 4) for k, v in metrics.items()})}")
    moved_s = "BatchNorm statistics on every call" if stats else "no BatchNorm statistics (GroupNorm)"
    log(f"[{label}] parameters moved on every {cfg.train.accum_steps}nd call only, {moved_s}; "
        f"launches {json.dumps(launches)}")
    for name, n in launches.items():
        check(n == per_call.get(name, 0) * (warm + timed),
              f"{label}: {name} launched {n} times in {warm + timed} train-step calls, expected {per_call.get(name, 0)} a call")

    # where a call's time goes (CUDA events around its three parts)
    split = {"forward+loss": [], "backward": [], "optimizer": []}
    for i in range(4):
        b = batch_to_device(batches[i], dev)
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(4)]
        ev[0].record()
        losses = loss_fn(cfg, model, b)
        ev[1].record()
        grads = gradients(model, losses["total_loss"])
        ev[2].record()
        apply_gradients(state, grads)
        ev[3].record()
        torch.cuda.synchronize()
        for (k, v), a, z in zip(split.items(), ev[:-1], ev[1:]):
            v.append(a.elapsed_time(z))
    del losses, grads
    log(f"[{label}] split per call, CUDA events, median of 4 (ms): "
        + json.dumps({k: round(float(np.median(v)), 3) for k, v in split.items()})
        + " (the optimizer's time is an update on every second call)")
    if profile:
        profile_request(train_step, (state, batches[0]), f"one {label} call (an update call)")

    # one call's gradients with the kernels, again with the kernels, and
    # with all of them on their plain versions (same weights, same batch)
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
    if named:
        by_name = {k: d for d, k in dist}
        norms = {k: float(g_kernel[k].float().norm()) for k in named}
        log(f"[{label}] gradients that exist only through d_wts, kernels vs plain versions: "
            + ", ".join(f"{k} {by_name[k]:.3e} (||g|| {norms[k]:.3e})" for k in named))
        check(all(n > 0 and math.isfinite(n) for n in norms.values()), f"{label}: a d_wts gradient is zero: {norms}")
    if extra is not None:
        extra(grads_with, g_kernel, spread[0][0])
    return launches


def flagship_training_phase(dev, cfg_path=FLAGSHIP):
    """configs/wildtrack.yaml as it stands (batch 2, ACCUM_STEPS 2, bf16).
    Its warp's tap weights come from the calibration, so its backward runs
    scatter_taps_grouped alone; the gradients must equal those of a
    backward forced through the fused kernel."""
    from vsta_tpu_torch.config import load_config
    from vsta_tpu_torch.ops import grouped_cuda as gc
    from vsta_tpu_torch.ops.warp_cuda import warp_out_dtype, warp_tiles

    cfg = load_config(str(cfg_path))
    B, V, (H, W) = cfg.data.batch_size, cfg.data.views, cfg.data.img_size
    P = math.ceil(H / 8) * math.ceil(W / 8)
    check(warp_out_dtype(V, P, B * cfg.model.bev_proj_ch, torch.bfloat16) == torch.bfloat16, "dispatch")
    check(cfg.model.bev_proj_ch > 40 + 1, "the flagship takes the warp-first backward")

    def fused_dmaps(gout, idx, wts, P_):
        maps = torch.zeros((gout.shape[0], P_, gout.shape[2]), dtype=gout.dtype, device=gout.device)
        return gc.scatter_tapdot_grouped(maps, gout, idx, wts)[0]

    def forced_fused(grads_with, g_kernel, spread):
        n = gc.scatter_tapdot_grouped.launches
        g_fused = grads_with(warp_tiles, gc.KERNELS._replace(scatter_taps=fused_dmaps))
        check(gc.scatter_tapdot_grouped.launches == n + 1, "the forced run did not take the fused kernel")
        same = all(torch.equal(g_kernel[k], g_fused[k]) for k in g_kernel)
        worst, worst_k = grad_distance(g_fused, g_kernel)[0]
        log(f"[train] gradients through scatter_taps_grouped against those forced through scatter_tapdot_grouped: "
            f"bit-equal {same}; worst distance {worst:.3e} ({worst_k}); two runs of one route differ by {spread:.3e}")
        # bit-equal where the card's backward is deterministic (two runs of
        # one route agree); where it is not, equality cannot show, and the
        # distance is held to the limit of the kernels-vs-plain check (the
        # kernels' own dmaps are held bit-equal in the grouped phase)
        check(same or (spread > 0 and worst <= 2e-2), "the flagship's gradients changed with the backward's dispatch")

    return training_phase(
        dev, cfg, "train",
        per_call={"warp_tiles": 1, "sample_tiles_grouped": 1, "scatter_taps_grouped": 1,
                  "scatter_tapdot_grouped": 0, "taps_dot_grouped": 0},
        watched=["view_proj", "detector.stem0.weight", "encoder.backbone.stages.6.0.expand_conv.weight"],
        warm=2, timed=6, extra=forced_fused,
    )


def probe_host() -> dict:
    """What the host offers the data path: Pillow, matplotlib and psutil
    (each imported alone), whether g++ links against libjpeg, libpng and
    zlib, and whether the port's C++ codec is built and loaded."""
    import tempfile

    from vsta_tpu_torch import native

    out = {}
    for mod in ("PIL", "matplotlib", "psutil"):
        r = subprocess.run([sys.executable, "-c", f"import {mod}; print({mod}.__version__)"],
                           capture_output=True, text=True)
        out[mod] = r.stdout.strip() if r.returncode == 0 else "missing"
    with tempfile.TemporaryDirectory() as d:
        src = Path(d) / "p.c"
        src.write_text("int main(void) { return 0; }\n")
        try:
            r = subprocess.run(["g++", str(src), "-o", str(Path(d) / "p"), "-ljpeg", "-lpng", "-lz"],
                               capture_output=True, text=True)
            out["g++ -ljpeg -lpng -lz"] = "links" if r.returncode == 0 else r.stderr.strip().splitlines()[0]
        except OSError as e:
            out["g++ -ljpeg -lpng -lz"] = f"no g++ ({e})"
    out["native codec"] = "built" if native.available() else "unavailable (PIL decodes)"
    return out


def copy_timing(dev, B=16, reps=5):
    """A batch-16 flagship frame set, uint8 [16, 7, 270, 480, 3], to the
    card: pageable (``torch.as_tensor(..., device=)``, as serving.py does),
    through the Prefetcher's put (pinned staging, then the non_blocking
    copy on its side stream; one stream and two), and the copy alone from
    memory already pinned (CUDA events). Host clock around each, the
    consumer's stream synchronised; medians of ``reps`` after two warm-ups."""
    from vsta_tpu_torch.data.pipeline import DevicePut

    frames = np.random.default_rng(0).integers(0, 256, (B, 7, 270, 480, 3), dtype=np.uint8)
    nbytes = frames.nbytes
    consumer = torch.cuda.current_stream(dev)

    def host_ms(fn):
        ts = []
        for i in range(2 + reps):
            torch.cuda.synchronize()
            t = time.perf_counter()
            out = fn()
            torch.cuda.synchronize()
            if i >= 2:
                ts.append((time.perf_counter() - t) * 1e3)
            check(out.shape == frames.shape and out.device.type == "cuda", "copy landed")
        return float(np.median(ts)), ts

    def through(put):
        def fn():
            out, event = put({"images": frames}, consumer)
            consumer.wait_event(event)
            return out["images"]
        return fn

    res = {"pageable": host_ms(lambda: torch.as_tensor(frames, device=dev)),
           "prefetcher put, 1 stream": host_ms(through(DevicePut(dev))),
           "prefetcher put, 2 streams": host_ms(through(DevicePut(dev, h2d_streams=2)))}
    pinned = torch.from_numpy(frames).pin_memory()
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
    ts = []
    for i in range(2 + reps):
        ev[0].record()
        out = pinned.to(dev, non_blocking=True)
        ev[1].record()
        torch.cuda.synchronize()
        if i >= 2:
            ts.append(ev[0].elapsed_time(ev[1]))
    res["pinned copy alone (events)"] = (float(np.median(ts)), ts)
    check(torch.equal(out.cpu(), torch.from_numpy(frames)), "the pinned copy changed the frames")
    for label, (ms, all_ms) in res.items():
        log(f"[loop] copy {B}x7x270x480x3 uint8 ({nbytes / 1e6:.1f} MB) {label}: {ms:.3f} ms = "
            f"{nbytes / ms / 1e6:.2f} GB/s (all {[round(x, 3) for x in all_ms]})")
    return {k: v[0] for k, v in res.items()}


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
    """The training loop end to end: a synthetic Wildtrack tree (7 views at
    1080x1920, 10 frames, 12 people) written by the port's generator in a
    temporary directory; ``cfg_path`` (the flagship) with DATA_ROOT there,
    EPOCHS 2 and EVAL.INTERVAL 1; ``run_training`` in process (launches
    counted from 0 around it); then ``python -m vsta_tpu_torch.train
    --resume`` with EPOCHS 3 and ``python -m vsta_tpu_torch.evaluate
    --split all`` as subprocesses; the frame-set copy both ways; resume on
    the card. Returns the loop's launches."""
    import shutil
    import tempfile

    import yaml

    from vsta_tpu_torch.config import from_dict
    from vsta_tpu_torch.data.synthetic import generate_synthetic_wildtrack
    from vsta_tpu_torch.data.wildtrack import WildtrackDataset
    from vsta_tpu_torch.training.loop import run_training

    log("[loop] host probe: " + json.dumps(probe_host()))
    tree = tree or dict(n_frames=10, n_views=7, n_people=12, img_hw=(1080, 1920))
    tmp = Path(tempfile.mkdtemp(prefix="vsta_loop_"))
    try:
        t = time.perf_counter()
        root = generate_synthetic_wildtrack(tmp / "wildtrack", **tree)
        log(f"[loop] synthetic tree {tree}: {time.perf_counter() - t:.1f}s")
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
        t = time.perf_counter()
        metrics = run_training(cfg, work_dir=str(work), dataset=train_ds, val_dataset=val_ds, device=dev)
        loop_s = time.perf_counter() - t
        launches = {c.__name__: c.launches for c in counters}
        save_dir = work / cfg.runtime.save_dir
        records = [json.loads(x) for x in (save_dir / "metrics.jsonl").read_text().splitlines()]
        scalars = [json.loads(x) for x in (save_dir / "scalars.jsonl").read_text().splitlines()]
        times = {(r["tag"], r["step"]): r["value"] for r in scalars if r["tag"].startswith("time/")}
        losses = [r["value"] for r in scalars if r["tag"] == "train/loss_iter"]
        log(f"[loop] run_training {loop_s:.1f}s: returned {json.dumps({k: round(v, 4) for k, v in metrics.items()})}; "
            f"launches {json.dumps(launches)}; decoders {sorted(train_ds.decoders)}")
        check([r["epoch"] for r in records] == [0, 1] and all(r.get("n_frames") == 2.0 for r in records),
              f"two epochs, each with an eval of 2 frames: {records}")
        check(len(losses) == 8 and all(math.isfinite(x) for x in losses), f"finite losses, 4 steps an epoch: {losses}")
        check((save_dir / "last").exists() and (save_dir / "best").exists(), "last and best checkpoints")
        for name in ("warp_tiles", "sample_tiles_grouped", "scatter_taps_grouped"):
            check(launches[name] > 0, f"{name} was not launched inside the loop")
        steps2 = times[("time/steps", 1)]
        log(f"[loop] readings: epoch 1 {times[('time/epoch_s', 0)]:.3f} s (decode), epoch 2 "
            f"{times[('time/epoch_s', 1)]:.3f} s (cached); a train step in epoch 2 "
            f"{times[('time/train_s', 1)] / steps2 * 1e3:.2f} ms (host clock over {steps2:.0f} steps, losses fetched); "
            f"the loop's wait on the train Prefetcher's queue {times[('time/input_wait_s', 1)] / steps2 * 1e3:.2f} ms "
            f"a step in epoch 2 ({times[('time/input_wait_s', 0)] / times[('time/steps', 0)] * 1e3:.2f} in epoch 1); "
            f"decoder {sorted(train_ds.decoders)}")
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
            t = time.perf_counter()
            r = subprocess.run([sys.executable, "-m", *args], capture_output=True, text=True, timeout=timeout,
                               env=env, cwd=str(ROOT))
            lines = [x for x in r.stdout.splitlines() if x.startswith(("[resume]", "[done]", "[ckpt]", "[time]", "Saved"))]
            log(f"[loop] {label}: exit {r.returncode} in {time.perf_counter() - t:.1f}s; " + " | ".join(lines))
            check(r.returncode == 0, f"{label} failed:\n{r.stdout[-3000:]}\n{r.stderr[-3000:]}")
            if label.startswith("train"):
                check("[resume] from epoch 2" in r.stdout and "[done]" in r.stdout, f"{label}: no resume from epoch 2")
            elif label.startswith("inference"):
                inference_outputs(tmp / "outputs", tree["n_frames"])
            else:
                block = json.loads(r.stdout[r.stdout.index("{"):])
                log(f"[loop] evaluate: {json.dumps(block)}")
                check(block["n_frames"] == float(tree["n_frames"]), f"evaluate scored {block['n_frames']} frames")
        copy_timing(dev)
        resume_check(dev, cfg, save_dir)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return launches


INFER_CONF_THRESH = 0.05  # the untrained heatmap sits near sigmoid(-2.19) = 0.10


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


def deform_training_phase(dev, cfg_path=DEFORM):
    """configs/wildtrack_deform.yaml as it stands (batch 2, ACCUM_STEPS 2,
    bf16, ATTN_STRIDE 4: the sampler's backward takes the fused kernel),
    then the same with ATTN_STRIDE 1 (it takes the two one-sided kernels).
    Returns the launches of both runs, added up."""
    import dataclasses

    from vsta_tpu_torch.config import load_config

    cfg = load_config(str(cfg_path))
    check(cfg.model.attn_stride == 4 and cfg.model.fusion == "deform_attn", "the deform config")
    watched = ["query_proj", "deform_fusion.offsets.weight", "deform_fusion.attn.bias", "deform_fusion.value.weight",
               "encoder.proj.weight", "detector.stem0.weight"]
    named = ["deform_fusion.offsets.weight", "deform_fusion.offsets.bias", "deform_fusion.attn.weight",
             "deform_fusion.attn.bias"]
    total = training_phase(
        dev, cfg, "deform-train",
        per_call={"warp_tiles": 0, "sample_tiles_grouped": 2, "scatter_taps_grouped": 1,
                  "scatter_tapdot_grouped": 1, "taps_dot_grouped": 0},
        watched=watched, warm=2, timed=8, named=named,
    )
    cfg1 = dataclasses.replace(cfg, model=dataclasses.replace(cfg.model, attn_stride=1))
    stride1 = training_phase(
        dev, cfg1, "deform-train ATTN_STRIDE 1",
        per_call={"warp_tiles": 0, "sample_tiles_grouped": 2, "scatter_taps_grouped": 2,
                  "scatter_tapdot_grouped": 0, "taps_dot_grouped": 1},
        watched=watched, warm=1, timed=4, profile=False, named=named,
    )
    return {k: total[k] + stride1[k] for k in total}


def perframe_training_phase(dev):
    """Both configs with STATIC_CAMERAS false (one field replaced in
    memory) and another calibration in every frame, as they stand
    otherwise (batch 2, ACCUM_STEPS 2, bf16). Concat: warp_views_sum once
    forward, then the VJP of the per-batch fused_warp_proj, the grouped
    sampler at G = 14 (sample_tiles_grouped and scatter_taps_grouped once
    each). Deform: the query warp at G = 14 and the sampler. Returns both
    runs' launches, added up."""
    from vsta_tpu_torch.config import load_config

    concat = training_phase(
        dev, with_model_fields(load_config(str(FLAGSHIP)), static_cameras=False), "perframe-train",
        per_call={"warp_views_sum": 1, "sample_tiles_grouped": 1, "scatter_taps_grouped": 1},
        watched=["view_proj", "detector.stem0.weight", "encoder.backbone.stages.6.0.expand_conv.weight"],
        warm=2, timed=5, batch_fn=train_batch_perframe,
    )
    deform = training_phase(
        dev, with_model_fields(load_config(str(DEFORM)), static_cameras=False), "perframe-deform-train",
        per_call={"sample_tiles_grouped": 2, "scatter_taps_grouped": 1, "scatter_tapdot_grouped": 1},
        watched=["query_proj", "deform_fusion.offsets.weight", "deform_fusion.value.weight", "encoder.proj.weight"],
        named=["deform_fusion.offsets.weight", "deform_fusion.attn.weight"],
        warm=2, timed=5, profile=False, batch_fn=train_batch_perframe,
    )
    return {k: concat[k] + deform[k] for k in concat}


def fusion_training_phase(dev):
    """configs/wildtrack.yaml with FUSION attn under WARP_IMPL gather
    (fields replaced in memory; batch 2, ACCUM_STEPS 2, bf16): warp_views
    forward (sample_tiles_grouped at G = 14, K = FEAT_DIM) and its maps'
    gradient backward (scatter_taps_grouped), once a call each."""
    from vsta_tpu_torch.config import load_config

    cfg = with_model_fields(load_config(str(FLAGSHIP)), fusion="attn", warp_impl="gather")
    return training_phase(
        dev, cfg, "fusion-attn-train",
        per_call={"sample_tiles_grouped": 1, "scatter_taps_grouped": 1},
        watched=["bev_proj.weight", "attn_fusion.hidden.weight", "attn_fusion.logit.bias", "encoder.proj.weight"],
        warm=1, timed=4, profile=False,
    )


def determinism_phase(dev):
    """Training gradients run to run. The deform family's residual
    upsample: its backward twice at the flagship's shape, bit for bit.
    Then one train step (forward and backward) of each config under
    torch.use_deterministic_algorithms(True, warn_only=True), which warns
    for every op that has no deterministic implementation: the ops it
    names are logged (it is switched off after; the library never sets
    it). The spread of a whole call's gradients over two runs is the
    training phases' "kernels run twice" reading."""
    import warnings
    from collections import Counter

    from vsta_tpu_torch.config import load_config
    from vsta_tpu_torch.ops.resize import resize_bilinear
    from vsta_tpu_torch.training.state import batch_to_device, create_state, gradients, loss_fn

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
    del res, gout, grads
    for label, path in (("deform", DEFORM), ("concat", FLAGSHIP)):
        cfg = load_config(str(path))
        state = create_state(cfg, seed=0, device="cuda", steps_per_epoch=100)
        b = batch_to_device(train_batch(cfg, cfg.data.batch_size, 0), dev)
        torch.use_deterministic_algorithms(True, warn_only=True)
        try:
            with warnings.catch_warnings(record=True) as caught:
                warnings.simplefilter("always")
                gradients(state.model, loss_fn(cfg, state.model, b)["total_loss"])
                torch.cuda.synchronize()
        finally:
            torch.use_deterministic_algorithms(False)
        names = Counter(" ".join(str(w.message).split())[:200] for w in caught)
        log(f"[determinism] one {label} train step under use_deterministic_algorithms(True, warn_only=True): "
            f"{len(caught)} warnings, {len(names)} distinct" + ("" if names else " (no op without a deterministic "
                                                                 "implementation)"))
        for msg, n in names.most_common():
            log(f"[determinism]   x{n}: {msg}")
        del state, b
    torch.cuda.empty_cache()


SMALL_DEFORM = {"FUSION": "deform_attn", "WARP_IMPL": "fused", "ATTN_HEADS": 2, "ATTN_POINTS": 2, "ATTN_STRIDE": 2}


def small_state_dict(cfg, seed):
    """Random weights for a small model; a deformable one gets non-zero
    kernels in its sampling heads, so that the sampling depends on the
    query."""
    from vsta_tpu_torch.convert import init_state_dict

    return wake_sampling_heads(init_state_dict(cfg, seed=seed), seed=seed, scale=0.3)

# the MODEL fields of the small f32 models, by family
SMALL_FAMILIES = {
    "concat": {},
    "deform_attn": SMALL_DEFORM,
    "concat per-frame": {"STATIC_CAMERAS": False},
    "deform_attn per-frame": {**SMALL_DEFORM, "STATIC_CAMERAS": False},
    "attn": {"FUSION": "attn", "WARP_IMPL": "gather"},
    "max": {"FUSION": "max", "WARP_IMPL": "gather"},
}


def small_cameras(family, B, V, img_hw):
    """Ring cameras for a small model: drawn per frame for a per-frame
    family, else one ring shared by the batch."""
    if "per-frame" in family:
        return perframe_cameras(B, V, img_hw, seed=3, radius=(8.0, 12.0), height=(3.0, 5.0))
    return perframe_cameras(B, V, img_hw, radius=(10.0, 10.0), height=(4.0, 4.0))


def small_train_phase(dev, family="concat"):
    """One f32 train step of a small model on the card against the CPU."""
    from vsta_tpu_torch.config import from_dict
    from vsta_tpu_torch.training.state import create_state, make_train_step

    cfg = from_dict({
        "DATA": {"BATCH_SIZE": 2, "IMG_SIZE": [3, 64, 96], "VIEWS": 3},
        "MODEL": {"BACKBONE": "efficientnet_b0", "FEAT_DIM": 48, "BEV_SIZE": [32, 16, 48],
                  "BEV_BOUNDS": [-12.0, 12.0, -4.0, 4.0], "BEV_PROJ_CH": 48,
                  "HEAD_MID1": 64, "HEAD_MID2": 32, "WARP_IMPL": "pallas", **SMALL_FAMILIES[family]},
        "LOSS": {"MAX_OBJECTS": 16},
        "RUNTIME": {"USE_AMP": False},
    })
    sd = small_state_dict(cfg, seed=1)
    batch = train_batch(cfg, 2, seed=5)
    if "per-frame" in family:
        batch["K"], batch["Rt"] = small_cameras(family, 2, 3, (64, 96))
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
    from vsta_tpu_torch.config import from_dict
    from vsta_tpu_torch.serving import build_serving_fn

    cfg = from_dict({
        "DATA": {"IMG_SIZE": [3, 64, 96], "VIEWS": 3},
        "MODEL": {"BACKBONE": "efficientnet_b0", "FEAT_DIM": 48, "BEV_SIZE": [32, 16, 48],
                  "BEV_BOUNDS": [-12.0, 12.0, -4.0, 4.0], "BEV_PROJ_CH": 32,
                  "HEAD_MID1": 64, "HEAD_MID2": 32, "WARP_IMPL": "pallas", **SMALL_FAMILIES[family]},
        "RUNTIME": {"USE_AMP": False},
    })
    state = small_state_dict(cfg, seed=1)
    rng = np.random.default_rng(1)
    frames = rng.integers(0, 256, (2, 3, 64, 96, 3), dtype=np.uint8)
    K, Rt = small_cameras(family, 2, 3, (64, 96))
    cpu = build_serving_fn(cfg, state, device="cpu")(frames, K, Rt)
    gpu = build_serving_fn(cfg, state, device=dev)(frames, K, Rt)
    d = float((gpu["heatmap"].cpu() - cpu["heatmap"]).abs().max())
    log(f"[small] {family} f32 heatmap, card vs CPU: max_abs_diff={d:.3e} (<= 1e-4; TF32 off)")
    check(d <= 1e-4, f"small {family} f32 model on the card disagrees with the CPU")


def grouped_timing_inputs(dev):
    """The grouped sampler's timed shapes (PERF.md's table), bf16, label ->
    (maps, gout, idx, wts): the flagship warp's taps at K = 82 and 128, the
    deformable sampler's (s4, s4*16, s1), the per-frame warp's (pf2, pf16)
    and the unfused fusions' G = 14 at K = 1,280; maps and cotangents
    random."""
    from vsta_tpu_torch.ops.warp import anchored_taps, flat_taps

    (Hf, Wf), bf = GROUPED_HW, torch.bfloat16
    P = (Hf + 1) * (Wf + 1)
    gen = torch.Generator(device=dev).manual_seed(9)

    def rand(G, N, K):
        return (torch.randn((G, P, K), generator=gen, device=dev).to(bf),
                torch.randn((G, N, K), generator=gen, device=dev).to(bf))

    anchors, wts = anchored_taps(flagship_lut(dev), (Hf, Wf))
    flag = (flat_taps(anchors, Wf + 1), wts.contiguous())
    N = flag[0].shape[1]
    shapes = {f"warp K={GROUPED_K}": (*rand(GROUPED_G, N, GROUPED_K), *flag), "warp K=128": (*rand(GROUPED_G, N, 128), *flag)}
    for label, B, stride in (("s4", 2, 4), ("s4*16", 16, 4), ("s1", 2, 1)):
        i, w = deform_taps(dev, B, stride)
        shapes[label] = (*rand(i.shape[0], i.shape[1], 32), i, w)
    for label, Bp in (("pf2", 2), ("pf16", 16)):
        a, w = anchored_taps(perframe_coords(dev, Bp).reshape(Bp * 7, N, 2), (Hf, Wf))
        shapes[label] = (*rand(Bp * 7, N, 128), flat_taps(a, Wf + 1), w.contiguous())
    shapes["G=14 K=1280"] = (*rand(14, N, 1280), *shapes["pf2"][2:])
    return shapes


def baseline_phase(dev, base_dir):
    """The kernels of another checkout (``--baseline DIR``, such as the
    parent commit unpacked) timed beside this one's, in turns (base, this,
    this, base), at the main path's shapes, and their outputs compared:
    the dense warp kernels (warp_tiles, warp_views_sum) and the grouped
    sampler's sample-major ones (sample_tiles_grouped, taps_dot_grouped).
    The base's sources are built here with this checkout's nvcc flags, one
    nvcc a source, all started together; a warp source without the
    grid-width argument has the C interface from before it."""
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
        builds[name] = (proc, src, lib)
    base = {}
    for name, (proc, src, lib) in builds.items():
        text = proc.communicate()[0]
        check(proc.returncode == 0, f"baseline build of {name} failed:\n{text}")
        if name == "grouped_taps":
            base[name] = ctypes.CDLL(str(lib))
            for fname in ("grouped_sample_launch", "grouped_taps_dot_launch"):
                getattr(base[name], fname).argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
            continue
        fn = getattr(ctypes.CDLL(str(lib)), f"{name}_launch")
        grid_arg = "int grid_w" in src.read_text()
        fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * (6 + grid_arg) + [ctypes.c_void_p]
        base[name] = (fn, grid_arg)
    V, P, Wb = 7, 34 * 60, BEV_HW[1]
    idx, wts = precompute_warp_lut(flagship_lut(dev), (34, 60))
    N = idx.shape[1]
    pidx, pwts = precompute_warp_lut(perframe_coords(dev, 16), (34, 60))
    g = torch.Generator(device=dev).manual_seed(0)
    f32 = torch.randn((V, P, WARP_K), generator=g, device=dev)
    pf32 = torch.randn((16, V, P, 128), generator=g, device=dev)
    code = {torch.float32: 0, torch.bfloat16: 1}

    def run_base(name, feats, i, w, out_dtype):
        fn, grid_arg = base[name]
        lead = (N, feats.shape[-1]) if name == "warp_tiles" else (feats.shape[0], N, feats.shape[-1])
        out = torch.empty(lead, dtype=out_dtype, device=dev)
        if name == "warp_tiles":
            args = [V, P, N, feats.shape[-1], code[feats.dtype], code[out_dtype]]
        else:
            args = [feats.shape[0], V, P, N, feats.shape[-1], code[feats.dtype]]
        rc = fn(feats.data_ptr(), i.data_ptr(), w.data_ptr(), out.data_ptr(), *args, *([Wb] if grid_arg else []),
                torch.cuda.current_stream(dev).cuda_stream)
        check(rc == 0, f"baseline {name} launch failed ({rc})")
        return out

    def run_grouped(lib, kind, maps, gout, i, w):
        """Row 4 or row 5 of ``lib`` through its C entry point, as the
        wrapper calls it: both sides of a turn take the same host path, so
        that at shapes as short as a launch the kernels, not the wrappers'
        checks, are compared."""
        Gm, Pm, Km = maps.shape
        stream = torch.cuda.current_stream(dev).cuda_stream
        if kind == "sample_tiles_grouped":
            out = torch.empty((Gm, i.shape[1], Km), dtype=maps.dtype, device=dev)
            rc = lib.grouped_sample_launch(
                maps.data_ptr(), i.data_ptr(), w.data_ptr(), out.data_ptr(), Gm, Pm, i.shape[1], Km, code[maps.dtype], stream)
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
    """The grouped kernels, with rows 4 and 3 keeping the inputs of their
    first call in ``store``: the shapes a model path gives them."""
    from vsta_tpu_torch.ops import grouped_cuda as gc

    def sample(maps, idx, wts):
        store.setdefault("sample_tiles_grouped", (maps.detach(), idx, wts.detach()))
        return gc.sample_tiles_grouped(maps, idx, wts)

    def scatter_taps(gout, idx, wts, P, *rest):
        store.setdefault("scatter_taps_grouped", (gout.detach(), idx, wts.detach(), P))
        return gc.scatter_taps_grouped(gout, idx, wts, P, *rest)

    return gc.KERNELS._replace(sample=sample, scatter_taps=scatter_taps)


def captured_readings(dev, label, store):
    """Rows 4 and 3 on the inputs a model call gave them: each against its
    plain version (row 4 bit-equal, row 3 within 1e-5 of max|ref|), then
    its time, the plain version's, the library's and the bound."""
    from vsta_tpu_torch.ops import grouped_cuda as gc

    readings = {}
    if "sample_tiles_grouped" in store:
        maps, idx, wts = store["sample_tiles_grouped"]
        out = gc.sample_tiles_grouped(maps, idx, wts)
        err = hold(f"sample_tiles_grouped {label}", out, gc.sample_tiles_grouped_ref(maps, idx, wts), "exact")
        readings["sample_tiles_grouped"] = {"path": label, **measure(dev, "sample_tiles_grouped", maps, out, idx, wts, err)}
        del out
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


def resnet_serving_phase(dev):
    """The three shipped ResNet configs served at full width with random
    weights from init_state_dict (wildtrack_sanity f32, wildtrack_v1_resnet50
    and wildtrack_ms_max bf16), batch 16 and 1: uint8 frames in, detections
    out; request times and peak memory; one launch of sample_tiles_grouped
    a request and no other kernel; the heatmaps with the kernel against its
    plain version; row 4 at the shape a batch-16 request gives it. Returns
    (launches, readings)."""
    from vsta_tpu_torch.config import load_config
    from vsta_tpu_torch.convert import init_state_dict
    from vsta_tpu_torch.ops import grouped_cuda as gc
    from vsta_tpu_torch.serving import build_serving_fn

    counters = all_counters()
    total = {c.__name__: 0 for c in counters}
    readings = []
    for name, path in RESNET_CONFIGS.items():
        cfg = load_config(str(path))
        t0 = time.perf_counter()
        state = init_state_dict(cfg, seed=0)
        serve = build_serving_fn(cfg, state, device="cuda")
        model = serve.model
        log(f"[resnet-serve] {name}: model built, {sum(v.numel() for v in state.values())} weights, "
            f"{time.perf_counter() - t0:.1f}s, compute dtype {model.dtype}, OUT_INDEX {cfg.model.out_index}, "
            f"FUSION {cfg.model.fusion}, {cfg.data.views} views")
        inputs = serve_inputs(cfg)
        store = {}
        model.grouped = capturing_kernels(store)
        try:
            serve(*inputs)
        finally:
            model.grouped = gc.KERNELS
        readings.append(captured_readings(dev, f"{name} serving B=16", store))
        reset(counters)
        _, n16 = timed_requests(cfg, serve, inputs, 16, 2, 5, f"{name} {str(model.dtype).split('.')[-1]}")
        _, n1 = timed_requests(cfg, serve, inputs, 1, 2, 5, f"{name} {str(model.dtype).split('.')[-1]}")
        launches = {c.__name__: c.launches for c in counters}
        log(f"[resnet-serve] {name}: {n16 + n1} requests, launches {json.dumps(launches)}")
        check(launches == {c.__name__: (n16 + n1 if c.__name__ == "sample_tiles_grouped" else 0) for c in counters},
              f"{name} serving launches {launches}")
        total = {k: total[k] + launches[k] for k in total}
        heatmaps_kernels_vs_plain(serve, inputs, counters, f"resnet-serve {name}")
        del serve, model, state
        torch.cuda.empty_cache()
    return total, readings


def resnet_training_phase(dev):
    """Each shipped ResNet config's train step as the config stands
    (sanity: batch 1, f32; ResNet-50: batch 2, ACCUM_STEPS 2, bf16; ms_max:
    batch 4, bf16), then sanity with MODEL.NORM group (one field replaced
    in memory): sample_tiles_grouped forward and scatter_taps_grouped
    backward once a call, finite losses, gradients with the kernels
    against their plain versions, call times and peak memory; one call's
    gradients twice, bit for bit; rows 4 and 3 at the shapes the call
    gives them. Returns (launches, readings)."""
    from vsta_tpu_torch.config import load_config
    from vsta_tpu_torch.ops.warp_cuda import warp_tiles

    runs = (("sanity", {}), ("resnet50", {}), ("ms_max", {}), ("sanity", {"norm": "group"}))
    total, readings = None, []
    for name, fields in runs:
        cfg = with_model_fields(load_config(str(RESNET_CONFIGS[name])), **fields)
        label = f"resnet-train {name}" + (" NORM group" if fields else "")
        store = {}

        def extra(grads_with, g_kernel, spread, label=label, store=store):
            log(f"[determinism] {label}: one call's gradients run twice: worst distance {spread:.3e} "
                f"(bit-equal {spread == 0})")
            check(spread == 0, f"{label}: two runs of one call's gradients differ")
            grads_with(warp_tiles, capturing_kernels(store))
            readings.append(captured_readings(dev, label, store))

        head = "view_proj" if cfg.model.fusion == "concat" else "bev_proj.weight"
        launches = training_phase(
            dev, cfg, label, per_call={"sample_tiles_grouped": 1, "scatter_taps_grouped": 1},
            watched=[head, "detector.stem0.weight", "encoder.backbone.stem_conv.weight"],
            warm=1, timed=4, profile=name == "resnet50" and not fields, extra=extra,
            stats=() if cfg.model.norm == "group" else (
                "encoder.backbone.stem_bn.running_mean", "encoder.backbone.stages.3.1.norms.0.running_var"),
        )
        total = launches if total is None else {k: total[k] + launches[k] for k in total}
        torch.cuda.empty_cache()
    return total, readings


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
            state = create_state(cfg, seed=0, device="cuda", steps_per_epoch=1)
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


def main() -> int:
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device (torch.cuda.is_available() is False)")
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

    t = time.perf_counter()
    entries = kernel_phase(dev)
    entries += grouped_phase(dev)
    views_entry = perframe_kernel_phase(dev)
    ablation_entry = ablation_phase(dev)
    log(f"[kernel] phases {time.perf_counter() - t:.1f}s")
    t = time.perf_counter()
    serve_launches = serving_phase(dev)
    log(f"[serve] phase {time.perf_counter() - t:.1f}s")
    t = time.perf_counter()
    deform_serve = deform_serving_phase(dev)
    log(f"[deform-serve] phase {time.perf_counter() - t:.1f}s")
    t = time.perf_counter()
    perframe_serve = [perframe_serving_phase(dev, FLAGSHIP, "concat"), perframe_serving_phase(dev, DEFORM, "deform_attn")]
    log(f"[perframe-serve] phases {time.perf_counter() - t:.1f}s")
    t = time.perf_counter()
    fusion_serve = fusion_serving_phase(dev)
    log(f"[fusion-serve] phase {time.perf_counter() - t:.1f}s")
    for family in SMALL_FAMILIES:
        small_model_phase(dev, family)
    t = time.perf_counter()
    resnet_serve, serve_readings = resnet_serving_phase(dev)
    log(f"[resnet-serve] phase {time.perf_counter() - t:.1f}s")
    t = time.perf_counter()
    train = flagship_training_phase(dev)
    log(f"[train] phase {time.perf_counter() - t:.1f}s")
    t = time.perf_counter()
    loop = loop_phase(dev)
    log(f"[loop] phase {time.perf_counter() - t:.1f}s")
    t = time.perf_counter()
    deform_train = deform_training_phase(dev)
    log(f"[deform-train] phase {time.perf_counter() - t:.1f}s")
    t = time.perf_counter()
    perframe_train = perframe_training_phase(dev)
    log(f"[perframe-train] phases {time.perf_counter() - t:.1f}s")
    t = time.perf_counter()
    fusion_train = fusion_training_phase(dev)
    log(f"[fusion-train] phase {time.perf_counter() - t:.1f}s")
    t = time.perf_counter()
    resnet_train, train_readings = resnet_training_phase(dev)
    log(f"[resnet-train] phases {time.perf_counter() - t:.1f}s")
    t = time.perf_counter()
    pretrained_phase(dev)
    log(f"[pretrained] phase {time.perf_counter() - t:.1f}s")
    for family in ("concat", "deform_attn", "concat per-frame", "attn"):
        small_train_phase(dev, family)
    t = time.perf_counter()
    determinism_phase(dev)
    log(f"[determinism] phase {time.perf_counter() - t:.1f}s")
    # launches on the model paths, each path counted from 0 over its own
    # run: flagship serving (both warp dispatches), training and the loop, deform
    # serving and training (ATTN_STRIDE 4 and 1), both families with
    # per-frame cameras, the max and attn fusions, the three ResNet configs
    # served and trained (and sanity with GroupNorm). The ablation variants
    # are on no model path: their count is the attribution run's.
    paths = [train, loop, deform_serve, deform_train, *perframe_serve, fusion_serve, perframe_train, fusion_train,
             resnet_serve, resnet_train]
    on_paths = {k: sum(path.get(k, 0) for path in paths) for k in train}
    entries += [views_entry, ablation_entry]
    counts = {
        f"{WARP_TPU}:162": serve_launches["resident"] + train["warp_tiles"] + loop["warp_tiles"],
        f"{WARP_TPU}:353": serve_launches["windowed"],
        **{e["replaces"]: on_paths[e["name"]] for e in entries if e["name"] in on_paths},
        ablation_entry["replaces"]: ablation_entry["launches"],
    }
    # rows 4 and 3 at the shapes the ResNet paths gave them
    for reading in serve_readings + train_readings:
        for entry in entries:
            if entry["name"] in reading:
                entry["other_shapes"].append(reading[entry["name"]])
    check(len(entries) == 8 and len(counts) == 8, "the kernels line lists eight kernels")
    for entry in entries:
        entry["launches"] = counts[entry["replaces"]]
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
