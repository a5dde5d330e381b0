"""Dataset smoke check of the port: the twin of ``scripts/check_dataset.py``.

    python -m vsta_tpu_torch.check_dataset --config configs/wildtrack.yaml
    python -m vsta_tpu_torch.check_dataset --data_root /path/to/Wildtrack --views 7

Reads the tree with the port's reader and prints the frame count, the
view folders, the calibration's shapes and camera heights, the
annotations a frame, each camera's homography round-trip error
(:func:`~vsta_tpu_torch.geometry.geom_consistency_error`, flagged above
1e-2 m) and one sample's shapes, then ``OK``. Everything runs on the CPU:
the check needs no device.
"""

import argparse

import numpy as np
import torch

from .config import Config, DataConfig, load_config
from .data.wildtrack import WildtrackDataset
from .geometry import geom_consistency_error


def main() -> None:
    parser = argparse.ArgumentParser()
    parser.add_argument("--config", type=str, default=None)
    parser.add_argument("--data_root", type=str, default=None)
    parser.add_argument("--views", type=int, default=7)
    args = parser.parse_args()
    if args.config:
        cfg = load_config(args.config)
    elif args.data_root:
        cfg = Config(data=DataConfig(data_root=args.data_root, views=args.views))
    else:
        parser.error("pass --config or --data_root")

    ds = WildtrackDataset(cfg, train=False)
    print(f"frames: {len(ds)}")
    print(f"views:  {ds.views} ({[d.name for d in ds.cam_dirs]})")
    print(f"native resolution: {ds.orig_hw[1]}x{ds.orig_hw[0]}")
    print(f"K (rescaled to {cfg.data.img_size[1]}x{cfg.data.img_size[0]}): {ds.Ks.shape}")
    print(f"Rt: {ds.Rts.shape}")
    for v in range(ds.views):  # the camera centre's height above the ground
        R, t = ds.Rts[v, :3, :3], ds.Rts[v, :3, 3]
        cam_pos = -R.T @ t
        print(f"  C{v + 1}: cam height {cam_pos[2]:+.2f} m, dist {np.linalg.norm(cam_pos[:2]):.1f} m")

    counts = [len(c) for c in ds.centers_per_frame]
    print(f"annotations: mean {np.mean(counts):.1f} / max {max(counts)} people per frame"
          f" ({sum(1 for c in counts if c == 0)} empty frames)")

    pts = np.stack(np.meshgrid(np.linspace(-5, 5, 5), np.linspace(-3, 3, 5)), -1).reshape(-1, 2)
    err = geom_consistency_error(
        torch.as_tensor(ds.Ks, dtype=torch.float32), torch.as_tensor(ds.Rts, dtype=torch.float32),
        torch.as_tensor(pts, dtype=torch.float32),
    )
    for v in range(ds.views):
        e = float(err[v])
        flag = "" if e < 1e-2 else "  <-- SUSPICIOUS"
        print(f"  C{v + 1}: homography round-trip error {e:.2e} m{flag}")

    s = ds[0]
    print(f"sample[0]: images {s['images'].shape} {s['images'].dtype},"
          f" boxes_world {s['boxes_world'].shape}, num_boxes {int(s['num_boxes'])}")
    print("OK")


if __name__ == "__main__":
    main()
