"""Training CLI of the port: the twin of ``train.py``.

    python -m vsta_tpu_torch.train --config configs/wildtrack.yaml \\
        [--resume] [--save_vis] [--work_dir DIR] [--profile N]

Runs on the CUDA device unless ``RUNTIME.DEVICE`` is ``cpu``; without a
CUDA device any other value raises. ``--profile N`` writes a
``torch.profiler`` trace of the first N train steps to SAVE_DIR/profile.

Multi-device: ``torchrun --nproc_per_node N -m vsta_tpu_torch.train
--config C`` with ``RUNTIME.MESH_DATA`` / ``MESH_VIEW`` set in C (NCCL,
one card a rank; with ``RUNTIME.DEVICE: cpu``, gloo); rank 0 prints.
"""

import argparse

from .config import load_config
from .parallel.mesh import init_distributed, quiet_unless_main
from .training.loop import run_training
from .utils.platform import runtime_device


def main() -> None:
    parser = argparse.ArgumentParser()
    parser.add_argument("--config", type=str, required=True)
    parser.add_argument("--save_vis", action="store_true", default=False)
    parser.add_argument("--resume", action="store_true", default=False)
    parser.add_argument("--work_dir", type=str, default=".")
    parser.add_argument(
        "--profile", type=int, default=0, metavar="N",
        help="capture a torch.profiler trace of the first N train steps (written to SAVE_DIR/profile)",
    )
    args = parser.parse_args()
    cfg = load_config(args.config)
    dev = init_distributed(runtime_device(cfg.runtime.device))
    quiet_unless_main()
    metrics = run_training(
        cfg, work_dir=args.work_dir, save_vis=args.save_vis, resume=args.resume, profile_steps=args.profile,
        device=dev,
    )
    print("[done]", {k: round(v, 4) for k, v in metrics.items()})


if __name__ == "__main__":
    main()
