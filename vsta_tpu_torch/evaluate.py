"""Evaluation CLI of the port: the twin of ``evaluate.py``.

    python -m vsta_tpu_torch.evaluate --config configs/wildtrack.yaml \\
        --checkpoint checkpoints/best [--split val|train|all]

Loads a checkpoint of this package (``training/checkpoint.py``), scores the
split (the 400/100 or 80/20 protocol of ``data/pipeline.split_train_val``)
and prints precision, recall, F1, MLE, MODA and MODP as one JSON block,
NaN as null. Runs on the CUDA device unless ``RUNTIME.DEVICE`` is ``cpu``,
over the mesh of ``RUNTIME.MESH_DATA`` x ``MESH_VIEW`` (under torchrun:
each rank scores its slice, the detections are gathered over 'data', and
rank 0 prints).
``--quantize-head`` / ``--quantize-encoder`` score the int8 serving paths,
calibrated on two batches of the train split (``export.calibrate``).
"""

import argparse
import json
import math
from pathlib import Path

from .config import load_config
from .data.pipeline import Prefetcher, split_train_val
from .data.wildtrack import WildtrackDataset
from .export import calibrate, train_split_batches
from .training.checkpoint import CheckpointManager
from .parallel.mesh import init_distributed, quiet_unless_main
from .training.loop import config_mesh, global_batch
from .training.metrics import DetectionMetrics
from .training.state import create_state, make_eval_step
from .utils.platform import runtime_device


def main() -> None:
    parser = argparse.ArgumentParser()
    parser.add_argument("--config", type=str, required=True)
    parser.add_argument("--checkpoint", type=str, default="checkpoints/best")
    parser.add_argument("--split", type=str, default="val", choices=["val", "train", "all"])
    parser.add_argument("--quantize-head", action="store_true", default=False,
                        help="score the int8 detector stem, calibrated on two train-split batches")
    parser.add_argument("--quantize-encoder", action="store_true", default=False,
                        help="score the int8 ResNet encoder (BatchNorm-fold PTQ; resnet backbones only), "
                             "calibrated on two train-split batches")
    args = parser.parse_args()

    cfg = load_config(args.config)
    dev = init_distributed(runtime_device(cfg.runtime.device))
    quiet_unless_main()
    mesh = config_mesh(cfg)
    if not mesh.member:
        return
    ds = WildtrackDataset(cfg, train=False)
    idx_train, idx_val = split_train_val(len(ds), cfg.train.seed)
    indices = {"val": idx_val, "train": idx_train, "all": list(range(len(ds)))}[args.split]
    dl = Prefetcher(ds, indices, cfg.data.batch_size, shuffle=False, num_workers=cfg.runtime.num_workers, device=dev,
                    shard=mesh.slice_batch if mesh.size > 1 else None)

    state = create_state(cfg, device=dev, steps_per_epoch=1, mesh=mesh)
    ckpt_path = Path(args.checkpoint)
    state, epoch, f1 = CheckpointManager(str(ckpt_path.parent)).restore(ckpt_path.name, state)
    print(f"[ckpt] loaded {args.checkpoint} (epoch {epoch}, f1={f1:.3f})")

    quant_head = quant_encoder = None
    if args.quantize_head or args.quantize_encoder:
        quant_head, quant_encoder = calibrate(
            cfg, state.model.state_dict(), train_split_batches(cfg, ds, cfg.data.batch_size, dev), head=args.quantize_head,
            encoder=args.quantize_encoder, device=dev, source="train-split ",
        )
    eval_step = make_eval_step(cfg, quant_head=quant_head, quant_encoder=quant_encoder)
    acc = DetectionMetrics(match_dist=cfg.eval.nms_dist_m)
    for batch in dl:
        out = eval_step(state, batch)
        gt = global_batch(mesh, batch, ("boxes_world", "num_boxes", "batch_mask"))
        acc.update_batch(
            out["boxes"].cpu().numpy(),
            out["scores"].cpu().numpy(),
            out["valid"].cpu().numpy(),
            gt["boxes_world"],
            gt["num_boxes"],
            gt["batch_mask"],
        )
    # a zero-frame eval gives NaN metrics, which are not JSON: null
    clean = {k: (None if math.isnan(v) else round(float(v), 4)) for k, v in acc.summary().items()}
    print(json.dumps(clean, indent=2))


if __name__ == "__main__":
    main()
