"""Overfit a few frames: the twin of ``scripts/overfit_check.py``.

    python -m vsta_tpu_torch.overfit_check [--epochs 40] [--fusion concat] [--device cpu]

Writes a small synthetic Wildtrack scene (``--frames`` frames of
``--views`` ring cameras at 216x384, 6 people), trains BEVNet on it
(ResNet-18 at stride 4, batch 2, BEV 60x120, bf16) and scores the same
frames every second epoch, so the model must drive detection F1 toward
1.0: targets, loss, gradients, decode and metrics agree with one
another. Prints ``[overfit] ... best F1 x`` and PASS (exit 0) at
``--target_f1`` or above, else FAIL (exit 1). Runs on the CUDA device
unless ``--device cpu``.
"""

import argparse
import os
import sys
import tempfile
import time
from pathlib import Path

from .config import Config, DataConfig, EvalConfig, LossConfig, ModelConfig, RuntimeConfig, TrainConfig
from .data.synthetic import generate_synthetic_wildtrack
from .data.wildtrack import WildtrackDataset
from .training.loop import run_training


def main(argv=None) -> int:
    parser = argparse.ArgumentParser()
    parser.add_argument("--epochs", type=int, default=40)
    parser.add_argument("--frames", type=int, default=10)
    parser.add_argument("--views", type=int, default=4)
    parser.add_argument("--fusion", type=str, default="concat")
    parser.add_argument("--backbone", type=str, default="resnet18")
    parser.add_argument("--out_index", type=str, default="1",
                        help="pyramid level, or comma-separated levels for multi-scale (e.g. '1,2')")
    parser.add_argument("--device", type=str, default="cuda", help="cuda (default) or cpu")
    parser.add_argument("--lr", type=float, default=2e-3)
    parser.add_argument("--work_dir", type=str, default=os.path.join(tempfile.gettempdir(), "vsta_torch_overfit"))
    parser.add_argument("--target_f1", type=float, default=0.8)
    args = parser.parse_args(argv)

    work = Path(args.work_dir)
    root = generate_synthetic_wildtrack(
        work / "data", n_frames=args.frames, n_views=args.views, n_people=6, img_hw=(216, 384), seed=0
    )
    levels = tuple(int(i) for i in args.out_index.split(","))
    cfg = Config(
        data=DataConfig(batch_size=2, img_size=(216, 384), views=args.views, data_root=str(root)),
        model=ModelConfig(
            backbone=args.backbone,
            feat_dim=64,
            out_index=levels[0] if len(levels) == 1 else levels,
            bev_size=(60, 120),
            bev_bounds=(-12.0, 12.0, -6.0, 6.0),
            bev_proj_ch=64,
            fusion=args.fusion,
        ),
        train=TrainConfig(epochs=args.epochs, lr=args.lr, warmup_epochs=2, seed=0),
        loss=LossConfig(max_objects=16),
        runtime=RuntimeConfig(num_workers=2, save_dir="ckpt/", output_dir="out/"),
        eval=EvalConfig(conf_thresh=0.35, nms_dist_m=1.0, interval=2, max_dets=32),
    )

    # the overfit protocol: train and score the same frames, without jitter
    ds = WildtrackDataset(cfg, train=False)
    t0 = time.time()
    all_idx = list(range(len(ds)))
    metrics = run_training(
        cfg, work_dir=str(work), dataset=ds, val_dataset=ds, train_indices=all_idx, val_indices=all_idx,
        device=args.device,
    )
    dt = time.time() - t0
    print(f"[overfit] {args.epochs} epochs in {dt:.0f}s -> best F1 {metrics['best_f1']:.3f}")
    if metrics["best_f1"] >= args.target_f1:
        print(f"[overfit] PASS (>= {args.target_f1})")
        return 0
    print(f"[overfit] FAIL (< {args.target_f1})")
    return 1


if __name__ == "__main__":
    sys.exit(main())
