#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (vsta_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py
    python3 chip_smoke.py --baseline DIR   # kernel rows 1, 2, 4, 5, 7 of the checkout in DIR beside these
    python3 chip_smoke.py --bn-timing        # train-step time with BatchNorm's sums in float64 and float32
    python3 chip_smoke.py --bn-act           # the one-pass eval BatchNorm kernel (phase 9's second half) alone
    python3 chip_smoke.py --mvdet            # MVDet's serving path and its kernels' shapes (phase 11's end) alone

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
   four times; then the port's own kernel, the eval BatchNorm with its
   SiLU in one pass (bn_act, csrc/bn_act.cu), against its plain version
   (f32 BatchNorm, cast, SiLU) at the 15 shapes of the flagship trunk's
   eval BatchNorms (from hooks on the trunk) at 112 and 7 images, both
   layouts, with and without SiLU, at ResNet-50's 2,048 channels and at an
   odd element offset: twice, bit-equal, bit-equal to the same arithmetic
   in PyTorch's ops (Flax's order), 99.9 % bit-equal to the plain version
   (its largest distance in ulps logged); the 15 timed as the model runs
   them (device time, a CUDA graph of 20 launches) against 4 bytes an
   element at 3.35 TB/s; bn_act launches 15 times a bf16 B0 request in
   every serving phase below (BN_ACT_A_REQUEST), and the plain-version
   runs of the heatmap checks take its plain version too;
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
   its plain version, timed, bound); then MVDet
   (configs/torch/wildtrack_mvdet.yaml: a dilated ResNet-18 on 7 views of
   720x1280, each map upsampled to 270x480 and warped apart at 512
   channels) at batch 16, bf16, random weights, ring cameras:
   sample_tiles_grouped on the inputs a request gives it (G = 112, K =
   512, N = 43,200) bit-equal to its plain version, timed, bound; the
   batch-16 artifact loaded as one CUDA graph, its launches at the load
   exactly one sample_tiles_grouped and 20 bn_act a request, one profiled
   replay's device kernels exactly one sample_kernel and 20 bn_act, the
   replay's detections equal to eager serving's; bn_act at every distinct
   shape of the trunk's 20 eval BatchNorms (N = 112, C 64 to 512, 360x640
   to 90x160, no SiLU) by phase 9's rule, timed;
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
   tracks in both clips); then ``python -m vsta_tpu_torch.export`` of that
   checkpoint at batch 2 and ``python -m vsta_tpu_torch.serve --track
   --clips 2`` on the tree, synchronous and with ``--overlap``, the two
   runs' frame JSONs identical;
13. export (after phase 11): every shipped config as it stands, and the
   flagship with per-frame cameras, exported at batch 16 and 1 with random
   weights and loaded on the card, each as one CUDA graph captured after a
   request under torch.cuda.set_sync_debug_mode("error"): the replayed
   boxes, scores, valid and heatmap equal to eager serving bit for bit,
   launches counted at the capture (a replay passes no Python wrapper),
   eager against replay time a request (median and p90 of 20), the memory
   reserved at the peak of an eager request and of a replay, read the same
   way (rows 1, 4 and 7 at these artifacts' shapes are held to their plain
   versions by the serving phases, which serve the same configs at batch
   16 and 1); the decode alone, eager against a CUDA graph of it; then int8: torch._int_mm at the flagship head's three stem products
   (batch 16 x 120 x 360) equal to an exact f64 product on the card and to
   the CPU's _int_mm on every row, timed against a bf16 product of the
   same shape; the flagship with an int8 head, wildtrack_v1_resnet50 with
   an int8 encoder and head, wildtrack_ms_max with an int8 encoder
   (calibrated on 2 batches of 4 frames), each exported, replayed
   bit-equal to eager, timed, its heatmap within 0.05 of the float
   artifact's (the JAX package's PTQ bound), every int8 site of a batch-1
   request equal to the CPU's conv_int8 on the same int8 operands, and the
   int8 head and encoder against the float ones (CUDA events);
14. the mesh (after phase 10): a world of one, the flagship's train step
   x3 and an eval step through ``parallel.make_mesh()`` with no process
   group, bit-equal to the single-device path with the same launches;
   then four worlds of two gloo ranks on cuda:0 (``--multidevice-rank``
   subprocesses of this script; NCCL refuses two ranks on one card),
   every view rank encoding all the views of its frames as JAX's compiled
   mesh program does: the flagship in float32 on a 2x1 mesh,
   configs/wildtrack_ms_max.yaml as shipped on 1x2 (max over the views,
   rows 4 and 3; no sum split over 'view': one device's gradients), the
   flagship with 6 views on 1x2 (the all-reduce after warp_tiles at a
   local V of 3) and configs/wildtrack_deform.yaml with 6 views on 1x2
   (the warped query's all-reduce after sample_tiles_grouped; rows 4, 6
   and 3); each 3 train steps held to the same steps on one device
   (losses, the first call's gradients within the run's own limit; a run
   with the frames rotated by one as a control of the summation order;
   the last two also against one device warping the ranks' halves of the
   views, ``view-halves``, within 1e-6), rank 0's kernels at the shapes
   the mesh gave them against their plain versions, parameters bit-equal
   across the ranks, ms a step a rank, launches by kernel
   (``[multidevice]``);
15. ``[tf32]``: an f32 wildtrack_sanity request (batch 16) and a flagship
   heatmap (batch 1) with cuDNN's TF32 at its default and off, timed, the
   heatmaps within TF32_HEATMAP_BOUND;
   then ``[timing]``: ``utils.timing.forward_decode_fps`` (the chained-N
   slope of the JAX package's benchmarks) of the flagship in bf16 at
   batch 16 and 1, beside ``cuda_ms`` of the same call;
16. ``[overfit]``: ``python -m vsta_tpu_torch.overfit_check`` (ResNet-18,
   4 views at 216x384, batch 2, 40 epochs) reaches F1 0.8;
17. ``[e2e]``: the recorded-accuracy harnesses as subprocesses on the
   flagship at full width: ``python -m vsta_tpu_torch.train_synthetic_e2e
   --track`` on a 20-frame tree (3 epochs, batch 2), then ``python -m
   vsta_tpu_torch.bench_serve_e2e --clips 1,2 --limit 8`` on its checkpoint,
   synchronous and ``--overlap`` at once: both exit 0, every metric finite,
   every served frame scored, the MOT rows equal with and without
   ``--overlap``; their processes' launches (``VSTA_TORCH_LAUNCH_LOG``)
   count into the kernels line.

Prints the kernels JSON line (the eight TPU kernels' rows, then bn_act's), the nvidia-smi line, then as the last line
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


# the kernels line's two entries of warp_tiles, by the warp's output dtype
WARP_ENTRY = {
    torch.bfloat16: "warp_tiles (resident dispatch: compute-dtype out)",
    torch.float32: "warp_tiles (windowed dispatch: f32 out)",
}


def warp_reading(dev, name, feats, idx, wts, out_dtype, grid_w, max_abs_err):
    """warp_tiles at one shape: its time, the plain version's, sparse.mm's
    on the same taps and the bound from these inputs; ``max_abs_err`` is
    the case's error against the plain version."""
    from vsta_tpu_torch.ops.warp_cuda import warp_tiles, warp_tiles_ref
    from vsta_tpu_torch.utils.timing import cuda_ms

    V, P, Kf = feats.shape
    N = idx.shape[1]
    nz = wts != 0
    nnz = int(nz.sum())
    rows = torch.unique((torch.arange(V, device=dev)[:, None, None] * P + idx)[nz]).numel()
    ms = cuda_ms(warp_tiles, feats, idx, wts, out_dtype=out_dtype, grid_w=grid_w, warmup=5, iters=50)
    plain_ms = cuda_ms(warp_tiles_ref, feats, idx, wts, out_dtype=out_dtype, warmup=1, iters=5)
    csr = shared_taps_coo(idx, wts, P).to(feats.dtype).to_sparse_csr()
    dense = feats.reshape(V * P, Kf)
    lib_out = torch.sparse.mm(csr, dense)
    lib_err = float((lib_out.float() - warp_tiles_ref(feats, idx, wts, out_dtype=torch.float32)).abs().max())
    library_ms = cuda_ms(torch.sparse.mm, csr, dense, warmup=2, iters=10)
    in_size, out_size = feats.element_size(), torch.empty((), dtype=out_dtype).element_size()
    nbytes = rows * Kf * in_size + N * Kf * out_size + V * N * 4 * 8
    flops = 2 * nnz * Kf
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S * 1e3, flops / PEAK_FLOPS_PER_S[feats.dtype] * 1e3
    reading = {
        "shape": f"V={V} P={P} N={N} K={Kf} {str(feats.dtype).split('.')[-1]}->{str(out_dtype).split('.')[-1]}",
        "max_abs_err": max_abs_err, "ms": ms, "plain_ms": plain_ms,
        "bound_ms": max(t_bytes, t_ops), "bound_by": "bytes" if t_bytes >= t_ops else "operations",
        "library_ms": library_ms,
    }
    log(
        f"[kernel] {name} {reading['shape']}: ms={ms:.4f} plain_ms={plain_ms:.4f} library_ms(sparse.mm)="
        f"{library_ms:.4f} (library max_abs_err {lib_err:.3e}) bound_ms={reading['bound_ms']:.4f} "
        f"({reading['bound_by']}: {nbytes / 1e6:.1f} MB = {rows} source rows read once + out + LUT; "
        f"{flops / 1e9:.2f} GFLOP over {nnz} live taps of {V * N * 4}) roofline_share={reading['bound_ms'] / ms:.3f}"
    )
    return reading


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
    entries = []
    for name, feats, out_dtype, replaces in (
        (WARP_ENTRY[torch.bfloat16], bf, torch.bfloat16, f"{WARP_TPU}:162"),
        (WARP_ENTRY[torch.float32], f32, torch.float32, f"{WARP_TPU}:353"),
        (f"warp_tiles K={TRAIN_K} (training forward, resident dispatch)", bf_train, torch.bfloat16, None),
    ):
        err = errs[f"bf16->bf16 K={K}" if out_dtype == torch.bfloat16 else f"f32->f32 K={K}"]
        reading = warp_reading(dev, name, feats, idx, wts, out_dtype, Wb, err)
        if replaces is not None:  # the K=256 shape is row 1's kernel again: logged, not a new entry
            entries.append({"name": name, "route": "cuda", "source": WARP_SRC, "replaces": replaces,
                            "launches": None, **reading, "other_shapes": []})
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


def bn_act_shapes(dev):
    """(C, H, W, act, layout) of every eval BatchNorm of the flagship's
    trunk in one request, in order, from forward hooks on the B0 trunk (to
    OUT_INDEX 2, bf16) over 7 channels-last 270x480 images, as
    ``ViewEncoder`` hands them."""
    from vsta_tpu_torch.models.encoders.efficientnet import EfficientNetFeatures
    from vsta_tpu_torch.models.encoders.norm import BatchNorm
    from vsta_tpu_torch.ops.bn_act_cuda import layout

    trunk = EfficientNetFeatures(torch.bfloat16).to(dev).eval()
    seen = []
    hooks = [m.register_forward_hook(lambda m, a, kw, out: seen.append(
                 (*a[0].shape[1:], kw.get("act"), layout(a[0]))), with_kwargs=True)
             for m in trunk.modules() if isinstance(m, BatchNorm)]
    with torch.no_grad():
        trunk(torch.zeros(7, 270, 480, 3, device=dev).permute(0, 3, 1, 2), 3)
    for h in hooks:
        h.remove()
    return seen


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
    least 99.9 % of elements bit-equal. The largest distance from the plain
    version is logged with the largest |plain| among elements more than 1
    ulp from it: where (x - mean) * mul + bias nears 0, the plain form
    cancels terms as large as |mean * mul| in f32 and loses more than a
    bf16 ulp of the small result; through SiLU a 1-ulp step grows by up
    to |1 + x (1 - sigmoid(x))|, 3 at x = -4. Returns the largest distance
    in ulps."""
    from vsta_tpu_torch.ops.bn_act_cuda import bn_act, bn_act_ref

    got = bn_act(x, mean, var, weight, bias, eps, act)
    again = bn_act(x, mean, var, weight, bias, eps, act)
    check(got.stride() == x.stride(), f"[bn_act] {label}: output strides {got.stride()} != input's {x.stride()}")
    check(torch.equal(got, again), f"[bn_act] {label}: two launches differ")
    ref = bn_act_ref(x, mean, var, weight, bias, eps, act)
    ulps = bf16_ulps_apart(got, ref)
    # shares from whole counts: a float32 mean of 1.7e9 ones need not be 1
    worst, same = int(ulps.max()), 1.0 - int((ulps != 0).sum()) / ulps.numel()
    far = ulps > 1
    far_ref = float(ref.float().abs()[far].max()) if bool(far.any()) else 0.0
    apart = bf16_ulps_apart(got, flax_order_ref(x, mean, var, weight, bias, eps, act)) != 0
    flax_same = 1.0 - int(apart.sum()) / apart.numel()
    ok = flax_same == 1.0 and same >= 0.999
    log(f"[bn_act] {label}: {x.numel()} elements, {100 * flax_same:.4f} % bit-equal to the Flax-order ops; "
        f"against the plain version {100 * same:.4f} % bit-equal, max {worst} bf16 ulp, {int(far.sum())} more "
        f"than 1 apart (largest |plain| among them {far_ref:.3e}); two launches bit-equal {'ok' if ok else 'FAIL'}")
    check(ok, f"[bn_act] {label}: {100 * flax_same:.4f} % bit-equal to the Flax-order ops, "
              f"{100 * same:.4f} % to the plain version")
    return worst


def bn_act_times(dev, x, mean, var, weight, bias, eps, act, reps=20):
    """(kernel ms, plain ms, bound ms) a launch, device time: ``reps``
    launches captured in one CUDA graph (so no host overhead between them,
    as in a replayed request), the input cycled through enough copies
    (COLD_BYTES) that each launch reads it from device memory, not from
    L2; the bound 4 bytes an element at HBM_BYTES_PER_S."""
    from vsta_tpu_torch.ops.bn_act_cuda import bn_act, bn_act_ref
    from vsta_tpu_torch.utils.timing import cuda_ms

    nbytes = 2 * x.numel()
    copies = [x] + [x.clone() for _ in range(max(0, math.ceil(COLD_BYTES / nbytes) - 1))]

    def graph_ms(fn):
        side = torch.cuda.Stream(dev)
        side.wait_stream(torch.cuda.current_stream(dev))
        with torch.cuda.stream(side):
            fn(x, mean, var, weight, bias, eps, act)
        torch.cuda.current_stream(dev).wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            for r in range(reps):
                fn(copies[r % len(copies)], mean, var, weight, bias, eps, act)
        ms = cuda_ms(graph.replay, warmup=2, iters=5) / reps
        del graph
        return ms

    return graph_ms(bn_act), graph_ms(bn_act_ref), 2 * nbytes / HBM_BYTES_PER_S * 1e3


def bn_act_phase(dev):
    """csrc/bn_act.cu against its plain version (``F.batch_norm`` in f32,
    the cast, ``F.silu``) at the flagship's 15 eval BatchNorms (their
    shapes from the trunk's hooks) at 112 images (batch 16) and 7 (batch
    1), each in both layouts, with and without SiLU; at ResNet-50's 2,048
    channels in both layouts (NCHW: the element-wise kernel, a plane of
    135); channels-last at an odd element offset (the element-wise kernel
    again): every case launched twice, bit-equal, and held to the plain
    version by :func:`bn_act_case`'s rule. Then each of the
    15 as the model runs it (channels-last, its own activation) timed at
    112 and 7 images against its bound and the plain version's time. Returns
    the kernels-line entry (ms, plain_ms, bound_ms: the 15 of a batch-16
    request summed)."""
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
            ms, plain_ms, bound_ms = bn_act_times(dev, *args, eps, act)
            rows.append({"C": C, "HxW": f"{H}x{W}", "act": act, "ms": round(ms, 4), "plain_ms": round(plain_ms, 4),
                         "bound_ms": round(bound_ms, 4), "share": round(bound_ms / ms, 3)})
            del args
        totals[N] = {k: sum(r[k] for r in rows) for k in ("ms", "plain_ms", "bound_ms")}
        log(f"[bn_act] N={N}, the 15 as the model runs them (channels-last), ms a launch: {json.dumps(rows)}")
        log(f"[bn_act] N={N}, a request's 15: kernel {totals[N]['ms']:.4f} ms, plain version "
            f"{totals[N]['plain_ms']:.4f} ms, bound {totals[N]['bound_ms']:.4f} ms "
            f"(share {totals[N]['bound_ms'] / totals[N]['ms']:.3f})")
    C, H, W = RESNET50_WIDE
    wide = {lay: bn_act_times(dev, *bn_act_inputs(dev, 112, C, H, W, lay, seed=9), 1e-5, None) for lay in ("nhwc", "nchw")}
    log(f"[bn_act] ResNet-50 width N=112 C={C} {H}x{W}, (ms, plain_ms, bound_ms): " + json.dumps(wide))
    t = totals[BN_ACT_BATCHES[0]]
    return {"name": "bn_act", "route": "cuda", "source": BN_ACT_SRC, "replaces": None,
            "launches": bn_act.launches - launches0, "max_ulps": worst, "ms": t["ms"], "plain_ms": t["plain_ms"],
            "bound_ms": t["bound_ms"], "bound_by": "bytes", "library_ms": None,
            "batch1": totals[BN_ACT_BATCHES[1]], "resnet50_width": wide, "other_shapes": []}


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
    Nm, T = i.shape[1:]
    itemsize = maps.element_size()
    live = w != 0
    n_live, n_taps = int(live.sum()), w.numel()
    rows_g = torch.arange(Gm, device=dev)[:, None, None] * Pm + i
    rows_read = torch.unique(rows_g).numel()
    idx_bytes, wts_bytes = Gm * Nm * T * 4, Gm * Nm * T * 4
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
            *gc.library_partition(kind, Km, maps.dtype, maps, maps if kind == "sample_tiles_grouped" else gout, T))
        more["device_ms"] = kernel_device_ms(fn, args, KERNEL_NAMES[kind])
        split_s += f" (device_ms={more['device_ms']} [{more['partition']}])"
        reading.update(partition=more["partition"], device_ms=more["device_ms"])
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
    counters = all_counters()
    reset(counters)
    _, n16 = timed_requests(cfg, serve, inputs, 16, 3, 5, "deform bf16")
    _, n1 = timed_requests(cfg, serve, inputs, 1, 2, 5, "deform bf16")
    launches = {c.__name__: c.launches for c in counters}
    log(f"[deform-serve] {n16 + n1} requests, launches {json.dumps(launches)}")
    check(launches == {"sample_tiles_grouped": 2 * (n16 + n1), "scatter_tapdot_grouped": 0, "scatter_taps_grouped": 0,
                       "taps_dot_grouped": 0, "warp_tiles": 0, "warp_views_sum": 0,
                       "bn_act": BN_ACT_A_REQUEST["deform"] * (n16 + n1)},
          f"deform serving launches {launches}")

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


def serving_phase(dev, cfg_path=FLAGSHIP):
    from vsta_tpu_torch.config import load_config
    from vsta_tpu_torch.convert import init_state_dict
    from vsta_tpu_torch.ops.bn_act_cuda import bn_act
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
    warp_tiles.launches = bn_act.launches = 0
    out16, n16 = run(serve, 16, 3, 5, "bf16")
    _, n1 = run(serve, 1, 2, 5, "bf16")
    launches["resident"], launches["bn_act"] = warp_tiles.launches, bn_act.launches
    log(f"[serve] bf16: {n16 + n1} requests, warp_tiles launches {warp_tiles.launches}, bn_act {bn_act.launches}")
    check(warp_tiles.launches == n16 + n1, "warp kernel launches != requests on the bf16 path")
    check(bn_act.launches == BN_ACT_A_REQUEST["flagship"] * (n16 + n1), "bn_act launches != 15 a bf16 request")

    # f32 at batch 16: the windowed dispatch (f32 out)
    cfg32 = dataclasses.replace(cfg, runtime=dataclasses.replace(cfg.runtime, use_amp=False))
    check(warp_out_dtype(V, P, 16 * cfg.model.bev_proj_ch, torch.float32) == torch.float32, "dispatch")
    serve32 = build_serving_fn(cfg32, state, device="cuda")
    warp_tiles.launches = bn_act.launches = 0
    _, n32 = run(serve32, 16, 1, 2, "f32")
    launches["windowed"] = warp_tiles.launches
    log(f"[serve] f32: {n32} requests, warp_tiles launches {warp_tiles.launches}")
    check(warp_tiles.launches == n32, "warp kernel launches != requests on the f32 path")
    check(bn_act.launches == 0, "an f32 request launched bn_act (f32 takes the plain BatchNorm)")
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

    heatmaps_kernels_vs_plain(serve, (frames, K16, Rt16), (warp_tiles, bn_act), "serve")
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
    from vsta_tpu_torch.ops import bn_act_cuda
    from vsta_tpu_torch.ops import grouped_cuda as gc
    from vsta_tpu_torch.ops.warp_cuda import warp_tiles, warp_tiles_ref
    from vsta_tpu_torch.ops.warp_views_cuda import warp_views_sum, warp_views_sum_ref

    model = serve.model
    for B in batches:
        args = tuple(a[:B] for a in inputs)
        got = serve(*args)["heatmap"]
        before = [c.launches for c in counters]
        model.warp, model.views_sum, model.grouped = warp_tiles_ref, warp_views_sum_ref, gc.PLAIN
        bn_act, bn_act_cuda.bn_act = bn_act_cuda.bn_act, bn_act_cuda.bn_act_ref  # BatchNorm looks it up a call
        try:
            ref = serve(*args)["heatmap"]
        finally:
            model.warp, model.views_sum, model.grouped = warp_tiles, warp_views_sum, gc.KERNELS
            bn_act_cuda.bn_act = bn_act
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
    a_request["bn_act"] = BN_ACT_A_REQUEST["flagship"]  # both families run the flagship's trunk
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
        a_request = {"sample_tiles_grouped": 1, "bn_act": BN_ACT_A_REQUEST["flagship"]}
        check(launches == {c.__name__: a_request.get(c.__name__, 0) * (n16 + n1) for c in counters},
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
    """Mean device time a launch of the kernels whose name holds ``kernel``
    (one launch a call of fn, for every caller), over the launches the
    profiler recorded in ``calls`` calls: the kernel alone, without the
    gaps between launches that an event timing of calls as short as the
    host's launch takes includes. The divisor is the launches recorded, not
    ``calls``: late in the full smoke run the profiler has recorded fewer
    (five calls of the G = 112, K = 512 sampler summed 8.96 ms, three
    launches at the 2.99 ms its events read). None if the profiler saw no
    such kernel."""
    from torch.profiler import ProfilerActivity, profile

    fn(*args)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn(*args)
        torch.cuda.synchronize()
    seen = [e for e in prof.key_averages() if e.device_type == torch.autograd.DeviceType.CUDA and kernel in e.key]
    return sum(dev_us(e) for e in seen) / 1e3 / sum(e.count for e in seen) if seen else None


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
        serve_cli(tmp, infer_cfg, save_dir / "best", env, tree["n_frames"], timeout)
        copy_timing(dev)
        resume_check(dev, cfg, save_dir)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return launches


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
        t = time.perf_counter()
        r = subprocess.run([sys.executable, "-m", *args], capture_output=True, text=True, timeout=timeout,
                           env=env, cwd=str(ROOT))
        lines = [x for x in r.stdout.splitlines() if x.startswith(("[ckpt]", "[export]", "[serve]", "Saved"))]
        log(f"[loop] {label}: exit {r.returncode} in {time.perf_counter() - t:.1f}s; " + " | ".join(lines))
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
            # a source from before 9-tap samples has no taps argument
            base_taps = "int K, int taps, int dtype" in src.read_text()
            base[name] = ctypes.CDLL(str(lib))
            for fname in ("grouped_sample_launch", "grouped_taps_dot_launch"):
                extra = base_taps and fname == "grouped_sample_launch"
                getattr(base[name], fname).argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * (5 + extra) + [ctypes.c_void_p]
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

    def run_grouped(lib, kind, maps, gout, i, w, taps_arg):
        """Row 4 or row 5 of ``lib`` through its C entry point, as the
        wrapper calls it: both sides of a turn take the same host path, so
        that at shapes as short as a launch the kernels, not the wrappers'
        checks, are compared. ``taps_arg``: the library's row 4 takes the
        taps a sample (4 here)."""
        Gm, Pm, Km = maps.shape
        stream = torch.cuda.current_stream(dev).cuda_stream
        if kind == "sample_tiles_grouped":
            out = torch.empty((Gm, i.shape[1], Km), dtype=maps.dtype, device=dev)
            rc = lib.grouped_sample_launch(
                maps.data_ptr(), i.data_ptr(), w.data_ptr(), out.data_ptr(), Gm, Pm, i.shape[1], Km,
                *([4] if taps_arg else []), code[maps.dtype], stream)
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
        this = lambda: run_grouped(mine, kind, maps, gout, i, w, True)
        other = lambda: run_grouped(base["grouped_taps"], kind, maps, gout, i, w, base_taps)
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
    1e-5 of max|ref|), then its time, the plain version's, the library's
    and the bound. The warp's reading is keyed by its entry in the kernels
    line."""
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
        a_request = {"sample_tiles_grouped": 1, "bn_act": BN_ACT_A_REQUEST[name]}
        check(launches == {c.__name__: a_request.get(c.__name__, 0) * (n16 + n1) for c in counters},
              f"{name} serving launches {launches}")
        total = {k: total[k] + launches[k] for k in total}
        heatmaps_kernels_vs_plain(serve, inputs, counters, f"resnet-serve {name}")
        del serve, model, state
        torch.cuda.empty_cache()
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


def mvdet_phase(dev):
    """MVDet at its published widths (:data:`MVDET`) at batch 16, bf16,
    random weights from init_state_dict, ring cameras: one eager request
    through build_serving_fn (one sample_tiles_grouped launch, of 9 taps a
    sample, and 20 bn_act launches; the inputs of its sampler call kept,
    the shapes its eval BatchNorms see read by hooks); row 4 on those
    inputs (G = 112, P = 14,400: the trunk's 90x160 maps, the upsample to
    270x480 folded into the taps; N = 43,200, K = 512) bit-equal to its
    plain version and timed against its own bound and against the 4-tap
    sample of the 270x480 maps that the benchmark's views roofline counts;
    the batch-16 artifact exported and loaded as one CUDA graph, the
    launches at the load those of the capture's eager requests exactly,
    one profiled replay's device kernels exactly one ``sample_kernel`` (its
    9-tap instantiation), 20 ``bn_act`` ones and no ``upsample_bilinear2d``
    with the counters at 0 before it and after it, the replay's detections
    equal to the eager request's; then bn_act at each distinct shape the
    BatchNorms saw, held by :func:`bn_act_case` and timed as the model
    runs it; last, row 4 at its 4-tap shapes (:func:`grouped_timing_inputs`)
    bit-equal and timed, as before 9 taps. Returns the launches."""
    import tempfile

    from torch.profiler import ProfilerActivity, profile

    from vsta_tpu_torch.config import load_config
    from vsta_tpu_torch.convert import init_state_dict
    from vsta_tpu_torch.export import WARMUP_REQUESTS, export_serving, load_serving, save_exported
    from vsta_tpu_torch.geometry import bev_sample_coords_with_depth, ground_grid
    from vsta_tpu_torch.models.encoders.norm import BatchNorm
    from vsta_tpu_torch.ops import grouped_cuda as gc
    from vsta_tpu_torch.ops.bn_act_cuda import layout
    from vsta_tpu_torch.ops.warp import anchored_taps, flat_taps
    from vsta_tpu_torch.serving import build_serving_fn

    B = MVDET_BATCH
    cfg = load_config(str(MVDET))
    m, V, (Hb, Wb) = cfg.model, cfg.data.views, cfg.model.bev_size
    state = init_state_dict(cfg, seed=0)
    args = tuple(torch.as_tensor(a, device=dev) for a in serve_inputs(cfg, B=B))
    counters = all_counters()
    total = {c.__name__: 0 for c in counters}
    a_request = {"sample_tiles_grouped": 1, "bn_act": BN_ACT_A_REQUEST["mvdet"]}
    torch.cuda.empty_cache()

    serve = build_serving_fn(cfg, state, device=dev)
    model = serve.model
    store, seen = {}, []
    hooks = [n.register_forward_hook(lambda n, a, kw, out: seen.append(
                 (tuple(a[0].shape), kw.get("act"), layout(a[0]), n.eps)), with_kwargs=True)
             for n in model.encoder.modules() if isinstance(n, BatchNorm)]
    model.grouped = capturing_kernels(store)
    reset(counters)
    by_taps = gc.sample_tiles_grouped.launches_by_taps
    by_taps.update(dict.fromkeys(by_taps, 0))
    try:
        torch.cuda.reset_peak_memory_stats()
        out = serve(*args)
        torch.cuda.synchronize()
    finally:
        model.grouped = gc.KERNELS
        for h in hooks:
            h.remove()
    launches = {c.__name__: c.launches for c in counters}
    log(f"[mvdet] eager B={B}: launches {json.dumps(launches)}, sample_tiles_grouped by taps a sample "
        f"{json.dumps(by_taps)}, peak allocated {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB, "
        f"{len(seen)} eval BatchNorms")
    check(launches == {k: a_request.get(k, 0) for k in launches}, f"[mvdet] eager request launches {launches}")
    check(by_taps == {4: 0, 9: 1}, f"[mvdet] sample_tiles_grouped launches by taps a sample {by_taps}")
    total = {k: total[k] + launches[k] for k in total}
    check_served(cfg, out, B)
    want = {k: out[k].clone() for k in ("boxes", "scores", "valid", "heatmap")}
    del serve, model, out
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
    sample = {"path": f"mvdet serving B={B}", **measure(dev, "sample_tiles_grouped", maps, got, idx, wts, err,
                                                         library=False)}
    # the bound of this launch from its live taps' distinct rows, and the
    # one the views roofline counts: the 4-tap sample of the same cells on
    # the 270 x 480 maps, padded, of every frame
    own_ms = taps_bound_ms(idx, wts, P, m.feat_dim)
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
        save_exported(export_serving(cfg, state, batch_size=B, platforms=(dev.type,)), path)
        reset(counters)
        torch.cuda.reset_peak_memory_stats()
        t = time.perf_counter()
        served = load_serving(path, device=dev)
        load_s = time.perf_counter() - t
        launches = {c.__name__: c.launches for c in counters}
        per_load = {k: a_request.get(k, 0) * (WARMUP_REQUESTS + 2) for k in launches}
        log(f"[mvdet] artifact B={B} loaded and captured in {load_s:.1f}s: launches {json.dumps(launches)}, "
            f"peak allocated {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB, reserved "
            f"{torch.cuda.memory_reserved() / 2**30:.2f} GiB")
        check(launches == per_load, f"[mvdet] launches at the load {launches} != {per_load}")
        total = {k: total[k] + launches[k] for k in total}
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
        replay_ms = request_ms(served, args, n=5)
        log(f"[mvdet] replay B={B}: median {replay_ms[0]:.2f} ms, p90 {replay_ms[1]:.2f} ms "
            f"({B / replay_ms[0] * 1e3:.1f} frame sets/s); valid dets/frame "
            f"{float(replayed['valid'].float().sum(1).mean()):.1f}")
        del served, replayed
    finally:
        import shutil

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
        ms, plain_ms, bound_ms = bn_act_times(dev, *x, eps, act)
        rows.append({"C": shape[1], "HxW": f"{shape[2]}x{shape[3]}", "n": n, "ms": round(ms, 4),
                     "plain_ms": round(plain_ms, 4), "bound_ms": round(bound_ms, 4), "share": round(bound_ms / ms, 3)})
        del x
        torch.cuda.empty_cache()
    request = {k: sum(r[k] * r["n"] for r in rows) for k in ("ms", "plain_ms", "bound_ms")}
    log(f"[mvdet] bn_act as the trunk runs it, ms a launch: {json.dumps(rows)}; a request's "
        f"{a_request['bn_act']}: kernel {request['ms']:.4f} ms, plain version {request['plain_ms']:.4f} ms, bound "
        f"{request['bound_ms']:.4f} ms (share {request['bound_ms'] / request['ms']:.3f}), max {worst} bf16 ulp")
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
    return total


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
TIMED_REQUESTS = 20
# an int8 artifact's heatmap against its float artifact's, max |diff|: the
# JAX package's PTQ bound (tests/test_quant.py); the card read 0.0055 to
# 0.016 on the three int8 artifacts (NVIDIA H100 80GB HBM3, 700 W)
INT8_DRIFT_LIMIT = 0.05


def request_ms(fn, args, n=TIMED_REQUESTS, warm=2):
    """Host clock around ``n`` synchronised requests: (median, p90) ms."""
    for _ in range(warm):
        fn(*args)
    torch.cuda.synchronize()
    lat = []
    for _ in range(n):
        t = time.perf_counter()
        fn(*args)
        torch.cuda.synchronize()
        lat.append((time.perf_counter() - t) * 1e3)
    return float(np.median(lat)), float(np.percentile(lat, 90))


def request_reserved_gib(fn, args, base):
    """Memory reserved at the peak of one request, over ``base`` (what was
    reserved before the model was loaded; the frames already on the card),
    the allocator's cache emptied first: the same reading for an eager
    request and a replay, so both count whole segments, the weights and
    what the request keeps (a graph's private pool stays reserved)."""
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    fn(*args)
    torch.cuda.synchronize()
    return (torch.cuda.max_memory_reserved() - base) / 2**30


def export_config(name):
    """The shipped config of ``name`` as it stands (one field replaced in
    memory for the per-frame flagship), its random weights and its batch-16
    frames and cameras."""
    from vsta_tpu_torch.config import load_config
    from vsta_tpu_torch.convert import init_state_dict

    path, fields = EXPORT_CONFIGS[name]
    cfg = with_model_fields(load_config(str(path)), **fields)
    state = init_state_dict(cfg, seed=0)
    if cfg.model.fusion == "deform_attn":
        state = wake_sampling_heads(state)
    inputs = serve_inputs_perframe(cfg) if not cfg.model.static_cameras else serve_inputs(cfg)
    return cfg, state, inputs


def eager_reference(cfg, state, inputs, per_request, quant):
    """``build_serving_fn``'s eager function for ``cfg`` (int8 trees in
    ``quant``) at each batch size: the outputs an artifact's replay is held
    to, the time a request (median and p90 of 20) and the memory reserved
    at a request's peak. Returns {B: (args on the card, outputs, reading)}."""
    from vsta_tpu_torch.serving import build_serving_fn

    counters = all_counters()
    full = tuple(torch.as_tensor(a, device="cuda") for a in inputs)
    torch.cuda.empty_cache()
    base = torch.cuda.memory_reserved()
    fn = build_serving_fn(cfg, state, device="cuda", **quant)
    weights = sum(t.numel() * t.element_size() for t in (*fn.model.parameters(), *fn.model.buffers()))
    readings = {}
    for B in EXPORT_BATCHES:
        args = tuple(a[:B] for a in full)
        reset(counters)
        ms = request_ms(fn, args)
        check(sum(c.launches for c in counters) > 0 or not per_request, "eager requests launched no kernel")
        readings[B] = {"eager_ms_median": round(ms[0], 3), "eager_ms_p90": round(ms[1], 3),
                       "eager_reserved_gib": round(request_reserved_gib(fn, args, base), 3),
                       "weights_gib": round(weights / 2**30, 3)}
    out = {}
    for B in EXPORT_BATCHES:  # the reference outputs, kept once every reading is taken
        args = tuple(a[:B] for a in full)
        outputs = {k: v for k, v in fn(*args).items() if k in ("boxes", "scores", "valid", "heatmap")}
        out[B] = (args, outputs, readings[B])
    del fn
    torch.cuda.empty_cache()
    return out


def replayed_artifact(tmp, label, cfg, state, B, per_request, eager, quant):
    """Export ``state`` at batch B (int8 trees in ``quant``), load it on the
    card (one CUDA graph captured, launches counted from 0 around the
    load), hold the replayed outputs equal to ``eager``'s (args, outputs,
    reading) bit for bit, time the replay and read the memory reserved at
    a replay's peak as :func:`eager_reference` reads an eager request's.
    Returns (launches, reading, replayed heatmap on the CPU)."""
    from vsta_tpu_torch.export import WARMUP_REQUESTS, export_serving, load_serving, save_exported

    args, want_out, eager_reading = eager
    path = Path(tmp) / f"{label.replace(' ', '_')}_b{B}.pt"
    save_exported(export_serving(cfg, state, batch_size=B, **quant), path)
    counters = all_counters()
    reset(counters)
    torch.cuda.empty_cache()
    base = torch.cuda.memory_reserved()
    t = time.perf_counter()
    serve = load_serving(path, device="cuda")
    load_s = time.perf_counter() - t
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
    replay_ms = request_ms(serve, args)
    check(all(c.launches == 0 for c in counters), "a replay went through a Python kernel wrapper")
    reserved = request_reserved_gib(serve, args, base)
    reading = {
        "config": label, "B": B, "load_s": round(load_s, 2), "int8": sorted(quant),
        **eager_reading, "replay_ms_median": round(replay_ms[0], 3), "replay_ms_p90": round(replay_ms[1], 3),
        "speedup_median": round(eager_reading["eager_ms_median"] / replay_ms[0], 3),
        "replay_reserved_gib": round(reserved, 3),
        "bit_equal": True, "valid_dets_per_frame": round(float(replayed["valid"].float().sum(1).mean()), 2),
    }
    log(f"[export] {label} B={B}: " + json.dumps(reading))
    heatmap = replayed["heatmap"].cpu()
    del serve, replayed
    torch.cuda.empty_cache()
    return launches, reading, heatmap


def decode_replay(dev, cfg):
    """The decode alone (3x3 peak pool, sort, the 128-step greedy NMS loop)
    on the flagship's heatmap shape, eager against one captured CUDA graph
    of it: host clock a synchronised call, median and p90 of 20, batch 16
    and 1; the replay's outputs equal to eager's."""
    from vsta_tpu_torch.ops.decode import decode_detections

    (Hb, Wb), e = cfg.model.bev_size, cfg.eval
    kw = dict(bounds=cfg.model.bev_bounds, conf_thresh=e.conf_thresh, nms_dist_m=e.nms_dist_m, max_dets=e.max_dets)
    g = torch.Generator(device=dev).manual_seed(5)
    out = {}
    for B in EXPORT_BATCHES:
        args = (torch.rand((B, Hb, Wb, 1), device=dev, generator=g),
                torch.rand((B, Hb, Wb, 2), device=dev, generator=g),
                torch.rand((B, Hb, Wb, 2), device=dev, generator=g) * 3)
        fn = lambda *a: decode_detections(*a, **kw)  # noqa: E731
        side = torch.cuda.Stream(dev)
        side.wait_stream(torch.cuda.current_stream(dev))
        with torch.cuda.stream(side):
            fn(*args)
        torch.cuda.current_stream(dev).wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            static = fn(*args)
        graph.replay()
        want = fn(*args)
        check(all(torch.equal(static[k], want[k]) for k in want), f"[decode] replay differs from eager at B={B}")
        eager = request_ms(fn, args)
        replay = request_ms(lambda *a: graph.replay(), args)
        out[f"B={B}"] = {"eager_ms_median": round(eager[0], 3), "eager_ms_p90": round(eager[1], 3),
                         "replay_ms_median": round(replay[0], 3), "replay_ms_p90": round(replay[1], 3)}
        del graph, static
    log("[decode] alone, eager against one CUDA graph (host clock, synchronised): " + json.dumps(out))
    return out


def int_mm_phase(dev, B=16, hw=(120, 360)):
    """torch._int_mm at the flagship head's three stem products (130 -> 512,
    512 -> 128 dilated 2, 128 -> 128; batch 16 x 120 x 360): the card's
    int32 equal to an exact f64 product on the card and to the CPU's
    _int_mm on the same int8 tensors, every row; its time against a bf16
    product of the same shape, and the bound."""
    from vsta_tpu_torch.ops.quant import im2col_int8, pad_cin
    from vsta_tpu_torch.utils.timing import cuda_ms

    g = torch.Generator(device=dev).manual_seed(17)
    readings = []
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
        ms = cuda_ms(torch._int_mm, cols, wt, warmup=2, iters=10)
        colsb, wtb = cols.to(torch.bfloat16), wt.to(torch.bfloat16)
        bf16_ms = cuda_ms(torch.matmul, colsb, wtb, warmup=2, iters=10)
        ops = 2.0 * M * K * cout
        bound = max(ops / 1979e12, (M * K + K * cout + 4 * M * cout) / HBM_BYTES_PER_S) * 1e3
        bound_bf16 = max(ops / PEAK_FLOPS_PER_S[torch.bfloat16], (2 * M * K + 2 * K * cout + 2 * M * cout) / HBM_BYTES_PER_S) * 1e3
        r = {"stem": f"{cin}->{cout} d{d}", "M": M, "K": K, "N": cout, "equal_exact_f64": exact, "equal_cpu": same_cpu,
             "int_mm_ms": round(ms, 4), "bound_ms": round(bound, 4), "bf16_mm_ms": round(bf16_ms, 4),
             "bf16_bound_ms": round(bound_bf16, 4), "int8_tops": round(ops / ms / 1e9, 1),
             "bf16_tflops": round(ops / bf16_ms / 1e9, 1)}
        log("[int8] _int_mm " + json.dumps(r))
        check(exact and same_cpu, f"[int8] _int_mm at {r['stem']}: card vs exact {exact}, card vs CPU {same_cpu}")
        readings.append(r)
        del x, w, cols, wt, y, colsb, wtb
        torch.cuda.empty_cache()
    return readings


def int8_sites_vs_cpu(model, args, qh, qe, label):
    """One batch-1 request through the int8 stages on the card, every int8
    site recorded (its int8 operands, stride, dilation and int32 product):
    each site's product equal to the CPU's conv_int8 on the card's own
    operands. Returns the count of sites."""
    from vsta_tpu_torch.ops import quant, quant_resnet

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
    differ, shapes = [], set()
    for i, (x_i8, w_i8, stride, dilation, y) in enumerate(records):
        shapes.add((tuple(x_i8.shape[1:]), w_i8.shape[0], w_i8.shape[1], stride, dilation))
        if not torch.equal(y.cpu(), conv(x_i8.cpu(), w_i8.cpu(), stride, dilation)):
            differ.append(i)
    log(f"[int8] {label}: {len(records)} int8 sites of a batch-1 request, card int32 equal to the CPU's on the "
        f"card's operands at {len(records) - len(differ)}; {len(shapes)} site shapes (input HWC, Cout, k, "
        f"stride, dilation): {sorted(shapes)}")
    check(not differ, f"[int8] {label}: int32 differs from the CPU's at sites {differ}")
    return len(records)


def stage_times(dev, label, cfg, state, inputs, qh, qe):
    """Every int8 site of a batch-1 request held to the CPU
    (:func:`int8_sites_vs_cpu`), then the int8 stages against the float
    ones on the same inputs (CUDA events, ms), batch 16 and 1: 'head'
    (apply_quant_head against the float BEVDetectorHead on one bev_feat)
    and 'encoder' (apply_quant_encoder against the float ViewEncoder on the
    normalized frames)."""
    from vsta_tpu_torch.export import _model
    from vsta_tpu_torch.ops.quant import apply_quant_head, tree_to
    from vsta_tpu_torch.ops.quant_resnet import apply_quant_encoder
    from vsta_tpu_torch.utils.timing import cuda_ms

    model = _model(cfg, state, dev)
    x, k, rt = (torch.as_tensor(a, device=dev) for a in inputs)
    qh = None if qh is None else tree_to(qh, dev)
    qe = None if qe is None else tree_to(qe, dev)
    out = {"int8_sites_equal_cpu": int8_sites_vs_cpu(model, (x, k, rt), qh, qe, label)}
    with torch.no_grad():
        normed = (x.float() - model.img_mean) * model.img_scale
        bev = model(x, k, rt)["bev_feat"]
        for B in EXPORT_BATCHES:
            if qh is not None:
                out[f"head B={B}"] = {
                    "float": round(cuda_ms(model.detector, bev[:B].to(model.dtype), warmup=2, iters=5), 3),
                    "int8": round(cuda_ms(apply_quant_head, qh, bev[:B], warmup=2, iters=5), 3)}
            if qe is not None:
                out[f"encoder B={B}"] = {
                    "float": round(cuda_ms(model.encoder, normed[:B], warmup=2, iters=5), 3),
                    "int8": round(cuda_ms(apply_quant_encoder, qe, normed[:B], warmup=2, iters=5), 3)}
    del model
    torch.cuda.empty_cache()
    return out


def export_phase(dev):
    """Every shipped config (and the flagship with per-frame cameras)
    exported at batch 16 and 1 and loaded on the card as one CUDA graph:
    replay bit-equal to build_serving_fn's eager outputs, eager against
    replay time a request (median and p90 of 20, frames already on the
    card), the memory reserved at the peak of an eager request and of a
    replay (:func:`request_reserved_gib`), launches at capture. Rows 1, 4
    and 7 are held against their plain versions at these artifacts' shapes
    by the serving phases (the same configs, batch 16 and 1), and a replay
    is held to eager serving bit for bit, so no second pass runs here. Then
    int8: _int_mm card vs CPU at the head's stem shapes, and the flagship
    (--quantize-head), wildtrack_v1_resnet50 (both) and wildtrack_ms_max
    (--quantize-encoder) exported, replayed, timed, every int8 site of a
    batch-1 request equal to the CPU's, their heatmaps within
    INT8_DRIFT_LIMIT of the float artifacts'. Returns (launches, readings)."""
    import tempfile

    from vsta_tpu_torch.export import calibrate

    counters = all_counters()
    total = {c.__name__: 0 for c in counters}
    readings, heatmaps = [], {}
    tmp = tempfile.mkdtemp(prefix="vsta_export_")

    def artifacts(name, label, cfg, state, inputs, quant):
        """Eager serving, then an artifact at each batch size: [(B, reading, heatmap)]."""
        per_request = {**EXPORT_LAUNCHES[name], "bn_act": 0 if "quant_encoder" in quant else BN_ACT_A_REQUEST[name]}
        eager = eager_reference(cfg, state, inputs, per_request, quant)
        out = []
        for B in EXPORT_BATCHES:
            launches, reading, hm = replayed_artifact(tmp, label, cfg, state, B, per_request, eager[B], quant)
            for k in total:
                total[k] += launches[k]
            readings.append(reading)
            out.append((B, reading, hm))
        return out

    try:
        for name in EXPORT_CONFIGS:
            cfg, state, inputs = export_config(name)
            for B, _, hm in artifacts(name, name, cfg, state, inputs, {}):
                heatmaps[(name, B)] = hm
            del state

        readings.append({"decode": decode_replay(dev, export_config("flagship")[0])})
        readings.append({"int_mm": int_mm_phase(dev)})
        for name, (head, encoder) in INT8_CONFIGS.items():
            cfg, state, inputs = export_config(name)
            calib_inputs = serve_inputs(cfg, B=8, seed=1)
            calib = [tuple(a[i * 4:(i + 1) * 4] for a in calib_inputs) for i in range(2)]
            t = time.perf_counter()
            qh, qe = calibrate(cfg, state, calib, head=head, encoder=encoder, device=dev)
            log(f"[int8] {name}: calibrated (head {head}, encoder {encoder}) on 2 batches of 4 frames in "
                f"{time.perf_counter() - t:.1f}s")
            label = f"{name} int8"
            quant = {k: v for k, v in (("quant_head", qh), ("quant_encoder", qe)) if v is not None}
            for B, reading, hm in artifacts(name, label, cfg, state, inputs, quant):
                drift = float((hm - heatmaps[(name, B)]).abs().max())
                reading["heatmap_drift_vs_float"] = round(drift, 5)
                log(f"[int8] {label} B={B}: heatmap drift against the float artifact {drift:.5f} "
                    f"(limit {INT8_DRIFT_LIMIT}, the JAX package's PTQ bound)")
                check(drift <= INT8_DRIFT_LIMIT, f"{label} B={B}: heatmap drift {drift} > {INT8_DRIFT_LIMIT}")
            stages = stage_times(dev, label, cfg, state, inputs, qh, qe)
            log(f"[int8] {name} stages (CUDA events, ms): " + json.dumps(stages))
            readings.append({"config": label, "stages": stages})
            del state, qh, qe
            torch.cuda.empty_cache()
    finally:
        import shutil

        shutil.rmtree(tmp, ignore_errors=True)
    return total, readings


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


def multidevice_steps(cfg, dev, mesh=None, rotate=False, store=None):
    """MULTIDEVICE_STEPS train-step calls of ``cfg`` from seed-0 weights on
    this rank's part of seeded batches: losses, ms a call (host clock,
    synchronised), the first call's gradients, the final state and the
    launches, all on the CPU. ``rotate`` moves each batch's frames by one
    place (the last first): the same function, summed in another order.
    ``store``:
    the model's kernels keep the inputs of their first call there
    (:func:`capturing_warp`, :func:`capturing_kernels`)."""
    from vsta_tpu_torch.parallel import shard_batch
    from vsta_tpu_torch.training.state import batch_to_device, create_state, make_train_step

    state = create_state(cfg, seed=0, device=dev, steps_per_epoch=100, mesh=mesh)
    if store is not None:
        state.model.warp, state.model.grouped = capturing_warp(store), capturing_kernels(store)
    B = cfg.data.batch_size
    batches = [train_batch(cfg, B, seed) for seed in range(MULTIDEVICE_STEPS)]
    if rotate:
        batches = [{k: np.roll(v, 1, axis=0) for k, v in b.items()} for b in batches]
    grads, update = {}, state.tx.update

    def spy(opt_state, model, g):
        if not grads:
            grads.update({k: v.detach().float().cpu() for k, v in g.items()})
        return update(opt_state, model, g)

    state.tx.update = spy
    step = make_train_step(cfg)
    counters = all_counters()
    reset(counters)
    losses, ms = [], []
    for b in batches:
        b = batch_to_device(b, dev) if mesh is None else shard_batch(b, mesh, dev)
        torch.cuda.synchronize(dev)
        t = time.perf_counter()
        metrics = step(state, b)
        torch.cuda.synchronize(dev)
        ms.append((time.perf_counter() - t) * 1e3)
        losses.append(float(metrics["total_loss"]))
    return {
        "losses": losses, "ms": ms, "grads": grads, "launches": {c.__name__: c.launches for c in counters},
        "state": {k: v.detach().cpu() for k, v in state.model.state_dict().items()},
    }


def multidevice_worker(run, outdir, patches=()) -> int:
    """One rank of a MULTIDEVICE_RUNS world (``--multidevice-rank RUN
    DIR [PATCH ...]``): gloo, chosen explicitly, on cuda:0. With
    PATCHES named, the run takes them and reads no kernel."""
    sys.path.insert(0, str(ROOT))
    from vsta_tpu_torch.parallel import init_distributed, make_mesh

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = init_distributed("cuda:0", backend="gloo")
    cfg = multidevice_config(run)
    mesh = make_mesh(*MULTIDEVICE_RUNS[run][2], batch_size=cfg.data.batch_size, views=cfg.data.views)
    check(mesh.size == MULTIDEVICE_WORLD and mesh.member, f"run {run}: mesh {mesh}")
    store = None if patches else {}
    with patched(*patches):
        out = multidevice_steps(cfg, dev, mesh, store=store)
    torch.distributed.barrier()  # both ranks are done with the card
    out["readings"] = {}
    if mesh.rank == 0 and store is not None:  # the kernels at the shapes this rank gave them, each against its plain version
        out["readings"] = captured_readings(dev, f"mesh {run} {mesh.n_data}x{mesh.n_view} rank 0", store)
    torch.save(out, Path(outdir) / f"{'+'.join((run, *patches))}-rank{mesh.rank}.pt")
    torch.distributed.destroy_process_group()
    return 0


def spawn_ranks(run, tmp, patches=()):
    """``run`` on two gloo ranks on cuda:0 (subprocesses of this script):
    each rank's record, rank 0's log and the world's wall time."""
    env = {**os.environ, "PYTHONPATH": str(ROOT), "MASTER_ADDR": "127.0.0.1", "MASTER_PORT": str(free_port()),
           "WORLD_SIZE": str(MULTIDEVICE_WORLD)}
    t = time.perf_counter()
    procs = [subprocess.Popen([sys.executable, str(Path(__file__).resolve()), "--multidevice-rank", run, str(tmp),
                               *patches],
                              env={**env, "RANK": str(r), "LOCAL_RANK": "0"}, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for r in range(MULTIDEVICE_WORLD)]
    try:
        logs = [p.communicate(timeout=900)[0] for p in procs]
    finally:
        for p in procs:
            p.kill()
    wall = time.perf_counter() - t
    for r, (p, text) in enumerate(zip(procs, logs)):
        check(p.returncode == 0, f"[multidevice] run {run} {patches} rank {r} failed:\n{text[-4000:]}")
    tag = "+".join((run, *patches))
    ranks = [torch.load(tmp / f"{tag}-rank{r}.pt", weights_only=False) for r in range(MULTIDEVICE_WORLD)]
    return ranks, logs[0], wall


def free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def max_rel_grad_err(got, want):
    """max over parameters of max|got - want| / max(max|want|, 1e-2 of the
    largest max|want|): the floor keeps gradients that are 0 up to
    rounding from dividing noise by noise, as :func:`grad_distance`."""
    peaks = {k: float(w.abs().max()) for k, w in want.items()}
    floor = 1e-2 * max(peaks.values())
    return max(float((got[k] - w).abs().max()) / max(peaks[k], floor) for k, w in want.items())


def worst_by_group(dists):
    """The worst per-parameter distance among the encoder's parameters,
    whose gradients sum over the images a rank holds, and among the
    others, computed after the view reduction on every rank alike."""
    enc = next(((d, k) for d, k in dists if k.startswith("encoder.")), (0.0, "-"))
    rest = next(((d, k) for d, k in dists if not k.startswith("encoder.")), (0.0, "-"))
    return f"encoder {enc[0]:.3e} ({enc[1]}), the rest {rest[0]:.3e} ({rest[1]})"


def multidevice_run(dev, run, tmp):
    """Run ``run`` on one device in this process (as it stands, with its
    frames rotated, and, where the run has a halves limit, with the warp
    in the ranks' halves of the views), then on two gloo ranks
    (subprocesses of this script), and hold the ranks to it. Returns the
    ranks' launches, summed, and rank 0's readings of the kernels at the
    shapes the mesh gave them."""
    cfg = multidevice_config(run)
    mesh_shape, limit, halves_limit = MULTIDEVICE_RUNS[run][2:]
    ref = multidevice_steps(cfg, dev)
    control = multidevice_steps(cfg, dev, rotate=True)
    halves = None
    if halves_limit is not None:
        with patched("view-halves"):
            halves = multidevice_steps(cfg, dev)
    torch.cuda.empty_cache()
    ranks, log0, wall = spawn_ranks(run, tmp)
    for ln in log0.splitlines():  # rank 0's kernels at the mesh's shapes
        if ln.startswith(("[kernel]", "[grouped]")):
            log(ln)
    f32 = cfg.runtime.use_amp is False
    errs = [max_rel_grad_err(r["grads"], ref["grads"]) for r in ranks]
    dists = [grad_distance(r["grads"], ref["grads"]) for r in ranks]
    same = all(torch.equal(ranks[0]["state"][k], r["state"][k]) for r in ranks[1:] for k in ranks[0]["state"])
    control_dists = grad_distance(control["grads"], ref["grads"])
    floor = (max_rel_grad_err(control["grads"], ref["grads"]), control_dists[0])
    halves_s = ""
    if halves is not None:
        to_halves = [grad_distance(r["grads"], halves["grads"]) for r in ranks]
        equal = [all(torch.equal(r["grads"][k], halves["grads"][k]) for k in halves["grads"]) for r in ranks]
        halves_s = (f"; against one device warping the ranks' halves of the views: per-parameter distance worst "
                    f"{[f'{d[0][0]:.3e} ({d[0][1]})' for d in to_halves]} (limit {halves_limit:.0e}; by group, rank "
                    f"0: {worst_by_group(to_halves[0])}), every gradient bit-equal {equal}; that one device against "
                    f"one device: {worst_by_group(grad_distance(halves['grads'], ref['grads']))}, ms per step "
                    f"{[round(x, 2) for x in halves['ms']]}")

    def norm(g):
        return math.sqrt(sum(float(v.double().pow(2).sum()) for v in g.values()))

    ratios = [norm(r["grads"]) / norm(ref["grads"]) for r in ranks]
    log(f"[multidevice] {run}: {Path(MULTIDEVICE_RUNS[run][0]).name} {json.dumps(MULTIDEVICE_RUNS[run][1])}, "
        f"batch {cfg.data.batch_size}, {cfg.data.views} views, {'float32' if f32 else 'bfloat16'}, mesh data "
        f"{mesh_shape[0]} x view {mesh_shape[1]} (gloo, 2 ranks on cuda:0); losses one device "
        f"{[round(x, 6) for x in ref['losses']]}, ranks {[[round(x, 6) for x in r['losses']] for r in ranks]}"
        f"{'' if halves is None else ', one device on the halves ' + str([round(x, 6) for x in halves['losses']])}; "
        f"max relative gradient error (first call, max|a-b| / max(max|b|, 1e-2 of the largest) over parameters) "
        f"{[f'{e:.3e}' for e in errs]}, per-parameter distance worst {[f'{d[0][0]:.3e} ({d[0][1]})' for d in dists]} "
        f"(limit {limit:.0e}; by group, rank 0: {worst_by_group(dists[0])}) (one device with its frames rotated: "
        f"{floor[0]:.3e}, {floor[1][0]:.3e} ({floor[1][1]}); by group: {worst_by_group(control_dists)}; losses "
        f"{[round(x, 6) for x in control['losses']]}){halves_s}; global gradient norm over one device's "
        f"{[f'{x:.6f}' for x in ratios]}; "
        f"ms per step one device {[round(x, 2) for x in ref['ms']]}, ranks "
        f"{[[round(x, 2) for x in r['ms']] for r in ranks]}; launches one device {json.dumps(ref['launches'])}, "
        f"ranks {[json.dumps(r['launches']) for r in ranks]}; parameters bit-equal across ranks {same}; "
        f"world's wall {wall:.1f}s")
    check(same, f"[multidevice] {run}: parameters differ across ranks")
    for r, d in zip(ranks, dists):
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
            h = grad_distance(r["grads"], halves["grads"])[0]
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
        for k, n in r["launches"].items():
            total[k] = total.get(k, 0) + n
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
        f"{a['losses']} / {b['losses']}; ms per step {[round(x, 2) for x in a['ms']]} / "
        f"{[round(x, 2) for x in b['ms']]}; launches {json.dumps(a['launches'])} / {json.dumps(b['launches'])}, "
        f"eval {a['eval_launches']} / {b['eval_launches']}; bit-equal {same}")
    check(same, "a world of one is not bit-equal to the single-device step")
    check(a["launches"] == b["launches"] and a["eval_launches"] == b["eval_launches"], "world of one: launches differ")
    total = {k: a["launches"][k] + b["launches"][k] for k in a["launches"]}
    total["warp_tiles"] += a["eval_launches"][0] + b["eval_launches"][0]
    return total


def multidevice_phase(dev):
    """The mesh on the card: (a) a world of one through the new code; (b)
    to (e) MULTIDEVICE_RUNS, each two gloo ranks on cuda:0 held to the same
    run on one device. Two ranks on one card show that the sharded math
    and the kernels a shard runs are right, not the speed of NCCL. Returns
    the launches of the mesh runs by kernel, the warp split by its output
    dtype ("resident" bf16, "windowed" f32), and rank 0's readings of
    each run's kernels at the shapes the mesh gave them."""
    import shutil
    import tempfile

    launches = {"resident": 0, "windowed": 0}

    def add(part, f32):
        for k, n in part.items():
            if k == "warp_tiles":
                launches["windowed" if f32 else "resident"] += n
            else:
                launches[k] = launches.get(k, 0) + n

    add(world_of_one(dev), False)
    readings = []
    tmp = Path(tempfile.mkdtemp(prefix="vsta_mesh_"))
    try:
        for run in MULTIDEVICE_RUNS:
            part, reading = multidevice_run(dev, run, tmp)
            add(part, multidevice_config(run).runtime.use_amp is False)
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


def batchnorm_f32_sums():
    """BatchNorm's training statistics on one device summed in float32, as
    before they were summed in float64: (class, name, value)."""
    from vsta_tpu_torch.models.encoders import norm

    shipped = norm.BatchNorm.forward

    def forward(self, x):
        if not self.training or self.mesh is not None:
            return shipped(self, x)
        xf = x.float()
        mean, sq = xf.mean(dim=(0, 2, 3)), (xf * xf).mean(dim=(0, 2, 3))
        var = torch.clamp(sq - mean * mean, min=0.0)
        with torch.no_grad():
            m = norm.BN_MOMENTUM
            self.running_mean.copy_(m * self.running_mean + (1 - m) * mean)
            self.running_var.copy_(m * self.running_var + (1 - m) * var)
        mul = torch.rsqrt(var + self.eps) * self.weight
        return ((xf - mean[:, None, None]) * mul[:, None, None] + self.bias[:, None, None]).to(x.dtype)

    return [(norm.BatchNorm, "forward", forward)]


PATCHES = {"view-halves": view_halves, "batchnorm-f32-sums": batchnorm_f32_sums}


@contextlib.contextmanager
def patched(*names):
    """The PATCHES named, in place for the block."""
    saved = []
    try:
        for name in names:
            for module, attr, value in PATCHES[name]():
                saved.append((module, attr, getattr(module, attr)))
                setattr(module, attr, value)
        yield
    finally:
        for module, attr, value in reversed(saved):
            setattr(module, attr, value)


BN_TIMING_CONFIGS = {"flagship": FLAGSHIP, "resnet50": ROOT / "configs" / "wildtrack_v1_resnet50.yaml"}


def bn_timing_phase(dev, calls=10, warm=2):
    """``python3 chip_smoke.py --bn-timing``: the train step of the flagship
    and of ResNet-50 as shipped, with BatchNorm's training sums in float64
    (the code) and in float32 (``batchnorm-f32-sums``, the code before), in
    turns (float64, float32, float32, float64) from a fresh state each:
    ``warm`` calls, then ``calls`` timed, per call on the host clock
    (synchronised) and in CUDA events. Prints the medians of each."""
    from vsta_tpu_torch.config import load_config
    from vsta_tpu_torch.training.state import batch_to_device, create_state, make_train_step

    for label, path in BN_TIMING_CONFIGS.items():
        cfg = load_config(str(path))
        batches = [train_batch(cfg, cfg.data.batch_size, seed) for seed in range(2)]
        host, device = {"float64": [], "float32": []}, {"float64": [], "float32": []}
        for turn in ("float64", "float32", "float32", "float64"):
            with patched(*(("batchnorm-f32-sums",) if turn == "float32" else ())):
                state = create_state(cfg, seed=0, device=dev, steps_per_epoch=100)
                step = make_train_step(cfg)
                for i in range(warm + calls):
                    b = batch_to_device(batches[i % 2], dev)
                    e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
                    torch.cuda.synchronize(dev)
                    t = time.perf_counter()
                    e0.record()
                    step(state, b)
                    e1.record()
                    torch.cuda.synchronize(dev)
                    if i >= warm:
                        host[turn].append((time.perf_counter() - t) * 1e3)
                        device[turn].append(e0.elapsed_time(e1))
            del state
            torch.cuda.empty_cache()
        med = {k: (float(np.median(host[k])), float(np.median(device[k]))) for k in host}
        log(f"[bn-timing] {label} ({path.name}, batch {cfg.data.batch_size}, {cfg.data.views} views, "
            f"{'bf16' if cfg.runtime.use_amp else 'f32'}): per train-step call, median of {2 * calls} in two turns, "
            f"host clock / CUDA events (ms): BatchNorm sums in float64 {med['float64'][0]:.2f} / "
            f"{med['float64'][1]:.2f}, "
            f"in float32 {med['float32'][0]:.2f} / {med['float32'][1]:.2f}; events by turn "
            f"{json.dumps({k: [round(x, 2) for x in v] for k, v in device.items()})}")


TIMING_BATCHES = (16, 1)


def timing_phase(dev):
    """``[timing]``: ``utils.timing.forward_decode_fps`` of the flagship as
    it stands (bf16) with seed-0 weights on float32 frames from a numpy
    seed (the JAX benchmark's input), at batch 16 and 1, beside
    ``cuda_ms`` of the same call (the chain's step with its ``1e-30``
    fold of a zero scalar); the step's scalar finite. The slope counts
    the host's launches where the host is slower than the card (the
    chain's calls are launched one by one; XLA runs its chain in one
    program)."""
    from vsta_tpu_torch.config import load_config
    from vsta_tpu_torch.convert import init_state_dict
    from vsta_tpu_torch.models import BEVNet
    from vsta_tpu_torch.utils.timing import N_HI, N_LO, N_REPEAT, cuda_ms, forward_decode_fps, forward_decode_step

    cfg = load_config(str(FLAGSHIP))
    model = BEVNet.from_config(cfg)
    model.load_state_dict(init_state_dict(cfg, 0))
    model.to(dev).eval()
    _, K, Rt = serve_inputs(cfg, max(TIMING_BATCHES), seed=0)
    V, (H, W) = cfg.data.views, cfg.data.img_size
    frames = np.random.default_rng(0).standard_normal((max(TIMING_BATCHES), V, H, W, 3)).astype(np.float32)
    step = forward_decode_step(cfg, model)
    zero = torch.zeros((), device=dev)
    for B in TIMING_BATCHES:
        images = torch.as_tensor(frames[:B], device=dev)
        k, rt = torch.as_tensor(K[:B], device=dev), torch.as_tensor(Rt[:B], device=dev)
        with torch.no_grad():
            scalar = float(step(images + zero * 1e-30, k, rt))
            fps = forward_decode_fps(cfg, model, images, k, rt)
            ms = cuda_ms(lambda: step(images + zero * 1e-30, k, rt))
        check(math.isfinite(scalar), f"[timing] batch {B}: the chained scalar is {scalar}")
        check(math.isfinite(fps) and fps > 0, f"[timing] batch {B}: forward_decode_fps {fps}")
        log(f"[timing] {FLAGSHIP.name} bf16 batch {B}: forward_decode_fps {fps:.2f} frames/s (chained slope, n "
            f"{N_LO} and {N_HI}, best of {N_REPEAT}: {B / fps * 1e3:.3f} ms a call); cuda_ms of the same call "
            f"{ms:.3f} ms ({B / ms * 1e3:.2f} frames/s); slope over cuda_ms {B / fps * 1e3 / ms:.3f}; "
            f"scalar {scalar:.6g}")
        del images, k, rt
    del model
    torch.cuda.empty_cache()


TF32_HEATMAP_BOUND = 5e-3  # |heatmap with cuDNN's TF32 - without|: ten times the 4.9e-4 an H100 read (PERF.md)


def tf32_phase(dev):
    """cuDNN's TF32 on the f32 convolutions: one f32 wildtrack_sanity
    request (batch 16) and one flagship heatmap (batch 1; its head's
    output convolutions run in f32) with ``cudnn.allow_tf32`` at its
    default (True) and off, timed (CUDA events) and compared. The port's
    entry points and CLIs leave it at its default; the heatmaps must stay
    within TF32_HEATMAP_BOUND of the float32 ones."""
    from vsta_tpu_torch.config import load_config
    from vsta_tpu_torch.convert import init_state_dict
    from vsta_tpu_torch.serving import build_serving_fn
    from vsta_tpu_torch.utils.timing import cuda_ms

    for name, B in (("wildtrack_sanity.yaml", 16), ("wildtrack.yaml", 1)):
        cfg = load_config(str(ROOT / "configs" / name))
        serve = build_serving_fn(cfg, init_state_dict(cfg, seed=0), device=dev)
        args = tuple(torch.as_tensor(a, device=dev) for a in serve_inputs(cfg, B))
        res = {}
        for tf32 in (True, False):
            torch.backends.cudnn.allow_tf32 = tf32
            try:
                hm = serve(*args)["heatmap"].float()
                res[tf32] = (hm, cuda_ms(serve, *args, warmup=2, iters=5))
            finally:
                torch.backends.cudnn.allow_tf32 = False
        diff = float((res[True][0] - res[False][0]).abs().max())
        log(f"[tf32] {name} B={B} ({serve.model.dtype}): request {res[True][1]:.3f} ms with cuDNN TF32 (its default) "
            f"against {res[False][1]:.3f} ms without; heatmap max |TF32 - f32| {diff:.3e} "
            f"(max heatmap {float(res[False][0].max()):.3f})")
        check(diff <= TF32_HEATMAP_BOUND, f"[tf32] {name}: TF32 moved the heatmap by {diff} > {TF32_HEATMAP_BOUND}")
        del serve


def overfit_phase(timeout=900):
    """``python -m vsta_tpu_torch.overfit_check`` on the card: ResNet-18,
    4 views at 216x384, batch 2, 40 epochs; it must reach F1 0.8."""
    import tempfile

    work = tempfile.mkdtemp(prefix="vsta_overfit_")
    t = time.perf_counter()
    r = subprocess.run([sys.executable, "-m", "vsta_tpu_torch.overfit_check", "--work_dir", work],
                       capture_output=True, text=True, timeout=timeout, env={**os.environ, "PYTHONPATH": str(ROOT)},
                       cwd=str(ROOT))
    lines = [x for x in r.stdout.splitlines() if x.startswith("[overfit]") or "phase=eval" in x]
    log(f"[overfit] exit {r.returncode} in {time.perf_counter() - t:.1f}s: " + " | ".join(lines[-6:]))
    import shutil

    shutil.rmtree(work, ignore_errors=True)
    check(r.returncode == 0 and "[overfit] PASS" in r.stdout,
          f"overfit_check did not reach F1 0.8:\n{r.stdout[-3000:]}\n{r.stderr[-3000:]}")


# The harnesses run the kernels in subprocesses, where no capture reaches
# them, so they keep to shapes that kernel_phase, grouped_phase and
# flagship_training_phase hold against the plain versions: training and
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
    """The recorded-accuracy harnesses on the card, as subprocesses: ``python
    -m vsta_tpu_torch.train_synthetic_e2e`` of the flagship (EfficientNet-B0,
    concat, bf16) at full width on a small tree (E2E_TRAIN: 20 frames at
    270x480, 3 epochs, batch 2, ``--track``: 16 frames train, the last 4
    tracked), then ``python -m vsta_tpu_torch.bench_serve_e2e`` (E2E_SERVE:
    artifacts at batch 1 and 2, 8 frames served) on its checkpoint, with
    ``--overlap`` off and on at once. Both exit 0; every metric of both
    result lines is finite and the ground truth is not empty; every served
    frame is scored; the MOT numbers with ``--overlap`` equal those without.
    Returns the launches of every process the harnesses started
    (``kernels.LAUNCH_LOG_ENV``): training and eval, export, and the serve
    CLI's warm-up requests and graph capture."""
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
        t = time.perf_counter()
        r = subprocess.run([sys.executable, "-m", "vsta_tpu_torch.train_synthetic_e2e", "--config", str(cfg_path),
                            "--work_dir", str(tmp / "run"), *train_args], capture_output=True, text=True,
                           timeout=timeout, env=env, cwd=str(ROOT))
        train_s = time.perf_counter() - t
        lines = dict(re.findall(r"^\[(e2e-result|track-result)\] (\{.*\})$", r.stdout, re.MULTILINE))
        evals = [x for x in r.stdout.splitlines() if "phase=eval" in x]
        log(f"[e2e] train_synthetic_e2e {' '.join(train_args)}: exit {r.returncode} in {train_s:.1f}s; "
            + " | ".join(evals[-3:]))
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
        t = time.perf_counter()
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
        serve_s = time.perf_counter() - t
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
        log(f"[e2e] bench_serve_e2e {' '.join(serve_args)}, sync and --overlap at once: {serve_s:.1f}s; "
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
    return launches


def main() -> int:
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device (torch.cuda.is_available() is False)")
    if "--multidevice-rank" in sys.argv:  # one rank of multidevice_phase's worlds
        i = sys.argv.index("--multidevice-rank")
        return multidevice_worker(sys.argv[i + 1], sys.argv[i + 2], tuple(sys.argv[i + 3:]))
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
    if "--bn-timing" in sys.argv:  # readings only
        bn_timing_phase(dev)
        return 0
    if "--bn-act" in sys.argv:  # the one-pass BatchNorm kernel alone
        bn_act_phase(dev)
        return 0
    if "--mvdet" in sys.argv:  # MVDet's serving path alone
        mvdet_phase(dev)
        return 0

    t = time.perf_counter()
    entries = kernel_phase(dev)
    entries += grouped_phase(dev)
    views_entry = perframe_kernel_phase(dev)
    ablation_entry = ablation_phase(dev)
    bn_entry = bn_act_phase(dev)
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
    mvdet_serve = mvdet_phase(dev)
    log(f"[mvdet] phase {time.perf_counter() - t:.1f}s")
    t = time.perf_counter()
    export_launches, _ = export_phase(dev)
    log(f"[export] phase {time.perf_counter() - t:.1f}s")
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
    t = time.perf_counter()
    mesh, mesh_readings = multidevice_phase(dev)
    log(f"[multidevice] phase {time.perf_counter() - t:.1f}s")
    t = time.perf_counter()
    tf32_phase(dev)
    log(f"[tf32] phase {time.perf_counter() - t:.1f}s")
    t = time.perf_counter()
    timing_phase(dev)
    log(f"[timing] phase {time.perf_counter() - t:.1f}s")
    t = time.perf_counter()
    overfit_phase()
    log(f"[overfit] phase {time.perf_counter() - t:.1f}s")
    t = time.perf_counter()
    e2e = e2e_phase(dev)
    log(f"[e2e] phase {time.perf_counter() - t:.1f}s")
    # launches on the model paths, each path counted from 0 over its own
    # run: flagship serving (both warp dispatches), training and the loop, deform
    # serving and training (ATTN_STRIDE 4 and 1), both families with
    # per-frame cameras, the max and attn fusions, the three ResNet configs
    # served and trained (and sanity with GroupNorm), MVDet served (its eager
    # request and its artifact's capture), the exported artifacts
    # (counted at their capture: a replay goes through no Python wrapper), the mesh runs (a world of
    # one and both ranks of each two-rank world), and the harnesses' processes (the e2e phase: training
    # and eval, the exports, the serve CLIs' warm-ups and captures). The ablation variants
    # are on no model path: their count is the attribution run's.
    paths = [train, loop, deform_serve, deform_train, *perframe_serve, fusion_serve, perframe_train, fusion_train,
             resnet_serve, resnet_train, mvdet_serve, export_launches, mesh, e2e]
    on_paths = {k: sum(path.get(k, 0) for path in paths) for k in train}
    entries += [views_entry, ablation_entry]
    counts = {
        f"{WARP_TPU}:162": serve_launches["resident"] + train["warp_tiles"] + loop["warp_tiles"]
        + export_launches["warp_tiles"] + mesh["resident"] + e2e["warp_tiles"],
        f"{WARP_TPU}:353": serve_launches["windowed"] + mesh["windowed"],
        **{e["replaces"]: on_paths[e["name"]] for e in entries if e["name"] in on_paths},
        ablation_entry["replaces"]: ablation_entry["launches"],
    }
    bn_entry["launches"] = serve_launches["bn_act"] + on_paths["bn_act"]  # replaces no TPU kernel
    # warp_tiles and rows 4 and 3 at the shapes the ResNet paths and the mesh runs gave them
    for reading in serve_readings + train_readings + mesh_readings:
        for entry in entries:
            if entry["name"] in reading:
                entry["other_shapes"].append(reading[entry["name"]])
    check(len(entries) == 8 and len(counts) == 8, "the kernels line lists eight TPU kernels")
    for entry in entries:
        entry["launches"] = counts[entry["replaces"]]
    entries.append(bn_entry)
    for entry in entries:
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
