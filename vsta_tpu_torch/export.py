"""Serving export of the port: an artifact loaded and replayed as one CUDA
graph, the twin of ``vsta_tpu/export.py`` and of the ``export.py`` CLI.

    exp = export_serving(cfg, state_dict, batch_size=1)
    save_exported(exp, "model.pt")         # + model.pt.json, the manifest
    ...
    serve = load_serving("model.pt")       # on the CUDA device
    out = serve(images, K, Rt)             # {'boxes','scores','valid','heatmap'}

    python -m vsta_tpu_torch.export --config configs/wildtrack.yaml \\
        --checkpoint checkpoints/best --out model.pt --batch 1 \\
        [--quantize-head] [--quantize-encoder] [--platform cuda|cpu]

The artifact differs from the JAX package's StableHLO one:

* it is a weights file (``torch.save`` of the state dict, the int8
  trees and the frozen batch size; ``torch.load(weights_only=True)``
  reads it) and a JSON manifest beside it (``<path>.json``: ``fn_name``,
  ``platforms``, ``in_avals`` / ``out_avals`` in JAX's string form such as
  ``"uint8[1,7,270,480,3]"``, ``torch_version`` and the ``config``);
* loading it needs this package's model code and its kernel sources (the
  kernels build on first use), not a framework alone: :func:`load_serving`
  rebuilds the model from the manifest's config and loads the weights;
* on the card the program is a CUDA graph captured at load time, one for
  the frozen batch size, holding the whole forward and decode (the
  per-request LUT build included), not a serialized program. ``platforms``
  is ``cuda`` or ``cpu``; a TPU artifact comes from the JAX package.

The batch size and the decode contract (top-k, NMS radius, confidence
threshold) are frozen at export, as in the JAX package: another batch
size raises.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
from dataclasses import dataclass
from pathlib import Path
from typing import Any, Dict, List, Mapping, Optional, Sequence, Tuple

import numpy as np
import torch

from .config import Config, from_dict, load_config, to_dict
from .models.bevnet import BEVNet
from .models.encoders.resnet import RESNET_SPECS
from .ops.quant import quantize_head, tree_to
from .ops.quant_resnet import quantize_encoder
from .serving import build_serving_fn
from .utils import tracing
from .utils.platform import resolve_device

__all__ = [
    "build_serving_fn", "calibrate", "calibrate_quant_head", "calibrate_quant_encoder", "export_serving",
    "save_exported", "load_serving", "Exported", "Serving",
]

_MANIFEST_SUFFIX = ".json"
FN_NAME = "serve"
PLATFORMS = ("cuda", "cpu")
WARMUP_REQUESTS = 2  # eager requests on a side stream before the capture


def _model(cfg: Config, state_dict: Mapping[str, torch.Tensor], dev: torch.device) -> BEVNet:
    model = BEVNet.from_config(cfg)
    model.load_state_dict(state_dict)
    return model.to(dev).eval()


@torch.no_grad()
def calibrate_quant_head(
    cfg: Config, state_dict: Mapping[str, torch.Tensor], batches: Sequence[tuple], quant_encoder: Optional[Dict] = None,
    *, device: str | torch.device = "cuda",
) -> Dict:
    """Int8 head parameters from representative (images, K, Rt) batches:
    the float model's own ``bev_feat`` maps calibrate the detector stem
    (:func:`~vsta_tpu_torch.ops.quant.quantize_head`). Pass
    ``quant_encoder`` when the deployment runs both int8 stages, so that
    the head calibrates on the maps it will see. The tree is on ``device``.
    The CenterNet head only: ``HEAD: mvdet`` raises ``ValueError``."""
    if cfg.model.head != "centernet":
        raise ValueError(f"head quantization takes the CenterNet head, not MODEL.HEAD {cfg.model.head!r}")
    dev = resolve_device(device)
    model = _model(cfg, state_dict, dev)
    qe = None if quant_encoder is None else tree_to(quant_encoder, dev)
    feats = [
        model(torch.as_tensor(images, device=dev), torch.as_tensor(K, device=dev, dtype=torch.float32),
              torch.as_tensor(Rt, device=dev, dtype=torch.float32), quant_encoder=qe)["bev_feat"]
        for images, K, Rt in batches
    ]
    return quantize_head(model.detector.state_dict(), feats)


@torch.no_grad()
def calibrate_quant_encoder(
    cfg: Config, state_dict: Mapping[str, torch.Tensor], batches: Sequence[tuple],
    *, device: str | torch.device = "cuda",
) -> Dict:
    """Int8 ResNet-encoder parameters from representative (images, K, Rt)
    batches (:func:`~vsta_tpu_torch.ops.quant_resnet.quantize_encoder`).
    The ResNet family with BatchNorm, undilated and projected, only:
    anything else raises ``ValueError``. uint8 frames are normalized as the
    model does."""
    m = cfg.model
    if any(m.dilation) or m.head != "centernet":
        raise ValueError("encoder quantization takes an undilated ResNet with its projection "
                         f"(MODEL.DILATION {list(m.dilation)}, HEAD {m.head!r})")
    if m.backbone not in RESNET_SPECS:
        raise ValueError(
            f"encoder quantization supports the resnet family, not {m.backbone!r} (BatchNorm-fold PTQ)"
        )
    if m.norm != "batch":
        raise ValueError(
            f"encoder quantization folds BatchNorm into the int8 convs; MODEL.NORM={m.norm!r} has no "
            "running stats to fold"
        )
    dev = resolve_device(device)
    model = _model(cfg, state_dict, dev)
    imgs = []
    for images, _K, _Rt in batches:
        x = torch.as_tensor(images, device=dev)
        x = (x.float() - model.img_mean) * model.img_scale if x.dtype == torch.uint8 else x.float()
        B, V, H, W, _ = x.shape
        imgs.append(x.reshape(B * V, H, W, 3))
    return quantize_encoder(m.backbone, model.encoder.state_dict(), imgs, m.out_index, model.fold_proj)


def calibrate(
    cfg: Config, state_dict: Mapping[str, torch.Tensor], batches: Sequence[tuple], *, head: bool, encoder: bool,
    device: str | torch.device = "cuda", source: str = "",
) -> Tuple[Optional[Dict], Optional[Dict]]:
    """(quant_head, quant_encoder) as the CLIs' ``--quantize-head`` /
    ``--quantize-encoder`` ask: the encoder first, so that the head
    calibrates behind it. Prints a line for each."""
    qe = qh = None
    if encoder:
        qe = calibrate_quant_encoder(cfg, state_dict, batches, device=device)
        print(f"[quant] int8 encoder calibrated on {len(batches)} {source}batches")
    if head:
        qh = calibrate_quant_head(cfg, state_dict, batches, quant_encoder=qe, device=device)
        print(f"[quant] int8 head calibrated on {len(batches)} {source}batches")
    return qh, qe


def train_split_batches(cfg: Config, ds, batch_size: int, device: torch.device, n: int = 2) -> List[tuple]:
    """The first ``n`` (images, K, Rt) batches of the train split of
    ``ds``: the evaluate and inference CLIs calibrate on them, never on the
    split they score."""
    from .data.pipeline import Prefetcher, split_train_val

    idx_train, _ = split_train_val(len(ds), cfg.train.seed)
    out = []
    dl = Prefetcher(ds, idx_train, batch_size, shuffle=False, num_workers=cfg.runtime.num_workers, device=device)
    for batch in dl:
        out.append((batch["images"], batch["K"], batch["Rt"]))
        if len(out) >= n:
            break
    return out


def _aval(dtype: torch.dtype, shape: Sequence[int]) -> str:
    """JAX's string form of an abstract value: ``float32[2,7,3,3]``."""
    return f"{str(dtype).split('.')[-1]}[{','.join(str(int(s)) for s in shape)}]"


def input_specs(cfg: Config, batch_size: int) -> List[Tuple[Tuple[int, ...], torch.dtype]]:
    """(shape, dtype) of images, K and Rt: uint8 frames under
    ``DATA.DEVICE_NORMALIZE`` (normalized in the program), f32 otherwise."""
    V, (H, W) = cfg.data.views, cfg.data.img_size
    img_dtype = torch.uint8 if cfg.data.device_normalize else torch.float32
    return [((batch_size, V, H, W, 3), img_dtype), ((batch_size, V, 3, 3), torch.float32),
            ((batch_size, V, 4, 4), torch.float32)]


def output_specs(cfg: Config, batch_size: int) -> List[Tuple[Tuple[int, ...], torch.dtype]]:
    """(shape, dtype) of the outputs in the flattened order of JAX's
    output dict (its keys sorted): boxes, heatmap, scores, valid."""
    B, D, (Hb, Wb) = batch_size, cfg.eval.max_dets, cfg.model.bev_size
    return [((B, D, 4), torch.float32), ((B, Hb, Wb, 1), torch.float32), ((B, D), torch.float32), ((B, D), torch.bool)]


@dataclass
class Exported:
    """What :func:`save_exported` writes: the weights on the CPU, the int8
    trees, the frozen batch size and the platforms the artifact loads on."""

    cfg: Config
    state_dict: Dict[str, torch.Tensor]
    batch_size: int
    platforms: Tuple[str, ...]
    quant_head: Optional[Dict] = None
    quant_encoder: Optional[Dict] = None
    fun_name: str = FN_NAME

    @property
    def in_avals(self) -> List[str]:
        return [_aval(d, s) for s, d in input_specs(self.cfg, self.batch_size)]

    @property
    def out_avals(self) -> List[str]:
        return [_aval(d, s) for s, d in output_specs(self.cfg, self.batch_size)]


def export_serving(
    cfg: Config, state_dict: Mapping[str, torch.Tensor], batch_size: int = 1,
    platforms: Optional[Sequence[str]] = None, quant_head: Optional[Dict] = None,
    quant_encoder: Optional[Dict] = None,
) -> Exported:
    """The serving artifact of ``cfg`` with ``state_dict``'s weights for
    ``batch_size`` frames. ``platforms``: where it may load, ``("cuda",)``
    by default or ``("cpu",)``. The weights must fit the config (they are
    loaded into its model here) and an int8 encoder tree must have been
    made for this config's ``fold_proj`` contract."""
    platforms = tuple(platforms) if platforms else ("cuda",)
    for p in platforms:
        if p == "tpu":
            raise ValueError(
                "platform 'tpu': this package exports for the CUDA device or the CPU; a TPU artifact comes "
                "from the JAX package's export.py (python export.py --platform tpu)"
            )
        if p not in PLATFORMS:
            raise ValueError(f"unknown platform {p!r}: one of {PLATFORMS}")
    if batch_size < 1:
        raise ValueError(f"batch_size must be >= 1, got {batch_size}")
    model = BEVNet.from_config(cfg)
    model.load_state_dict(state_dict)
    if quant_encoder is not None and quant_encoder["fold_proj"] != model.fold_proj:
        raise ValueError("quant_encoder was calibrated for a different fold_proj contract than this config")
    cpu = torch.device("cpu")
    return Exported(
        cfg=cfg, state_dict={k: v.detach().to(cpu) for k, v in state_dict.items()}, batch_size=int(batch_size),
        platforms=platforms, quant_head=None if quant_head is None else tree_to(quant_head, cpu),
        quant_encoder=None if quant_encoder is None else tree_to(quant_encoder, cpu),
    )


def manifest_path(path: str | Path) -> Path:
    return Path(str(path) + _MANIFEST_SUFFIX)


def save_exported(exp: Exported, path: str | Path) -> None:
    """Write the weights file and the JSON manifest beside it."""
    path = Path(path)
    torch.save({"state_dict": exp.state_dict, "quant_head": exp.quant_head, "quant_encoder": exp.quant_encoder,
                "batch_size": exp.batch_size}, path)
    manifest: Dict[str, Any] = {
        "fn_name": exp.fun_name,
        "platforms": list(exp.platforms),
        "in_avals": exp.in_avals,
        "out_avals": exp.out_avals,
        "torch_version": torch.__version__,
        "config": to_dict(exp.cfg),
    }
    manifest_path(path).write_text(json.dumps(manifest, indent=2))


def _example_inputs(cfg: Config, specs, dev: torch.device, seed: int = 0) -> List[torch.Tensor]:
    """Frames from a seed and ring cameras, at the artifact's shapes: the
    capture's warm-up requests run on plausible geometry."""
    from .data.synthetic import make_ring_camera

    (shape, img_dtype), _, _ = specs
    B, V, H, W, _ = shape
    rng = np.random.default_rng(seed)
    frames = rng.integers(0, 256, shape) if img_dtype == torch.uint8 else rng.standard_normal(shape)
    Ks, Rts = zip(*(make_ring_camera(v, V, img_hw=(H, W)) for v in range(V)))
    K = np.broadcast_to(np.stack(Ks), (B, V, 3, 3))
    Rt = np.broadcast_to(np.stack(Rts), (B, V, 4, 4))
    return [torch.as_tensor(np.array(a)).to(device=dev, dtype=d) for a, (_, d) in zip((frames, K, Rt), specs)]


class Serving:
    """A loaded artifact: ``serve(images, K, Rt)`` at the frozen batch size.

    On the CUDA device the request is copied into the graph's input
    buffers, the graph replays, and the outputs are cloned, so the next
    request does not overwrite them. On the CPU it runs eagerly.
    ``model``, ``batch_size``, ``manifest`` and ``graph`` (None on the
    CPU) describe it. The graph carries the stage marks of the serving
    function (``vsta_stage_encoder`` … ``vsta_stage_end``,
    :mod:`~vsta_tpu_torch.utils.tracing`), so a replay's device trace
    names its stages; a call is the host span ``serve``, tagged with
    ``requests``, the count of calls before it.
    """

    def __init__(self, fn, specs, dev: torch.device, manifest: Dict, batch_size: int, example: List[torch.Tensor]):
        self.fn, self.specs, self.device = fn, specs, dev
        self.model, self.manifest, self.batch_size = fn.model, manifest, batch_size
        self.graph = None
        self.requests = 0
        if dev.type == "cuda":
            self._capture(example)

    def _capture(self, example: List[torch.Tensor]) -> None:
        """Warm up on a side stream, run one request with host syncs made
        errors, then capture one request. A failed capture raises."""
        dev = self.device
        self._inputs = example
        side = torch.cuda.Stream(dev)
        side.wait_stream(torch.cuda.current_stream(dev))
        with torch.cuda.stream(side):
            for _ in range(WARMUP_REQUESTS):
                self.fn(*self._inputs)
        torch.cuda.current_stream(dev).wait_stream(side)
        torch.cuda.synchronize(dev)
        before = torch.cuda.get_sync_debug_mode()
        torch.cuda.set_sync_debug_mode("error")
        try:
            self.fn(*self._inputs)
        finally:
            torch.cuda.set_sync_debug_mode(before)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            self._outputs = self.fn(*self._inputs)
        self.graph = graph

    def _check(self, args) -> List[torch.Tensor]:
        out = []
        for name, a, (shape, dtype) in zip(("images", "K", "Rt"), args, self.specs):
            t = torch.as_tensor(a)
            if tuple(t.shape) != shape:
                raise ValueError(
                    f"{name} of shape {tuple(t.shape)}: the artifact takes {_aval(dtype, shape)} "
                    f"(its batch size is frozen at {self.batch_size})"
                )
            if name == "images" and t.dtype != dtype:
                raise TypeError(f"images of dtype {t.dtype}: the artifact takes {_aval(dtype, shape)}")
            out.append(t)
        return out

    def __call__(self, images, K, Rt) -> Dict[str, torch.Tensor]:
        request, self.requests = self.requests, self.requests + 1
        with tracing.span("serve", request):
            args = self._check((images, K, Rt))
            if self.graph is None:
                return self.fn(*args)
            for buf, a in zip(self._inputs, args):
                buf.copy_(a, non_blocking=a.device.type == "cpu" and a.is_pinned())
            self.graph.replay()
            return {k: v.clone() for k, v in self._outputs.items()}


def load_serving(path: str | Path, device: str | torch.device = "cuda") -> Serving:
    """Load an artifact: returns ``serve(images, K, Rt) -> dict`` of device
    tensors. On the CUDA device (the default) one CUDA graph of the frozen
    batch size is captured here; without a card, or where the artifact was
    not exported for the device's platform, it raises."""
    dev = resolve_device(device)
    manifest = json.loads(manifest_path(path).read_text())
    if dev.type not in manifest["platforms"]:
        raise ValueError(f"{path} was exported for {manifest['platforms']}, not {dev.type!r}")
    cfg = from_dict(manifest["config"])
    blob = torch.load(Path(path), map_location="cpu", weights_only=True)
    B = int(blob["batch_size"])
    fn = build_serving_fn(
        cfg, blob["state_dict"], quant_head=blob["quant_head"], quant_encoder=blob["quant_encoder"], device=dev
    )
    specs = input_specs(cfg, B)
    example = _example_inputs(cfg, specs, dev) if dev.type == "cuda" else []
    return Serving(fn, specs, dev, manifest, B, example)


def _calibration_batches(cfg: Config, batch_size: int, n_batches: int) -> List[tuple]:
    """(images, K, Rt) numpy batches from DATA_ROOT when it holds frames,
    else synthetic ring-camera frames at the configured shapes."""
    root = Path(cfg.data.data_root) if cfg.data.data_root else None
    ds = None
    if root and root.exists():
        from .data.wildtrack import WildtrackDataset

        ds = WildtrackDataset(cfg, train=False)
        if len(ds) == 0:
            print(f"[quant] DATA_ROOT {root} has no frames; calibrating on synthetic inputs instead")
            ds = None
    out = []
    if ds is not None:
        idx = 0
        for _ in range(n_batches):
            samples = [ds[(idx + i) % len(ds)] for i in range(batch_size)]
            idx += batch_size
            out.append(tuple(np.stack([np.asarray(s[k]) for s in samples]) for k in ("images", "K", "Rt")))
        return out

    from .data.synthetic import make_ring_camera

    V, (H, W) = cfg.data.views, cfg.data.img_size
    rng = np.random.default_rng(0)
    Ks, Rts = zip(*(make_ring_camera(v, V, img_hw=(H, W)) for v in range(V)))
    K = np.broadcast_to(np.stack(Ks), (batch_size, V, 3, 3)).astype(np.float32)
    Rt = np.broadcast_to(np.stack(Rts), (batch_size, V, 4, 4)).astype(np.float32)
    for _ in range(n_batches):
        out.append((rng.standard_normal((batch_size, V, H, W, 3)).astype(np.float32), K, Rt))
    return out


def main(argv: Optional[Sequence[str]] = None) -> None:
    ap = argparse.ArgumentParser(description="Export a checkpoint of the port to a serving artifact.")
    ap.add_argument("--config", type=str, required=True)
    ap.add_argument("--checkpoint", type=str, default="checkpoints/best")
    ap.add_argument("--out", type=str, required=True)
    ap.add_argument("--batch", type=int, default=1)
    ap.add_argument("--platform", type=str, default="cuda",
                    help="where the artifact loads: 'cuda' (default) or 'cpu'")
    ap.add_argument("--warp_impl", type=str, default=None, help="override MODEL.WARP_IMPL")
    ap.add_argument("--quantize-head", action="store_true", default=False,
                    help="serve the detector stem in int8; calibrated on DATA_ROOT frames when "
                         "available, synthetic frames otherwise")
    ap.add_argument("--quantize-encoder", action="store_true", default=False,
                    help="serve the ResNet encoder in int8 (BatchNorm-fold PTQ; resnet backbones only)")
    ap.add_argument("--calib-batches", type=int, default=4, help="calibration batches for --quantize-*")
    args = ap.parse_args(argv)

    cfg = load_config(args.config)
    if args.warp_impl:
        cfg = dataclasses.replace(cfg, model=dataclasses.replace(cfg.model, warp_impl=args.warp_impl))
    from .training.checkpoint import CheckpointManager
    from .training.state import create_state
    from .utils.platform import runtime_device

    dev = runtime_device(cfg.runtime.device)
    state = create_state(cfg, device=dev, steps_per_epoch=1)
    ckpt_path = Path(args.checkpoint)
    state, epoch, f1 = CheckpointManager(str(ckpt_path.parent)).restore(ckpt_path.name, state)
    print(f"[ckpt] loaded {args.checkpoint} (epoch {epoch}, f1={f1:.3f})")
    sd = state.model.state_dict()

    quant_head = quant_encoder = None
    if args.quantize_head or args.quantize_encoder:
        calib = _calibration_batches(cfg, args.batch, args.calib_batches)
        quant_head, quant_encoder = calibrate(
            cfg, sd, calib, head=args.quantize_head, encoder=args.quantize_encoder, device=dev
        )

    exp = export_serving(cfg, sd, batch_size=args.batch, platforms=[args.platform],
                         quant_head=quant_head, quant_encoder=quant_encoder)
    save_exported(exp, args.out)
    size_mb = Path(args.out).stat().st_size / 1e6
    print(f"[export] {args.out} ({size_mb:.1f} MB, platforms={list(exp.platforms)}, batch={args.batch})")


if __name__ == "__main__":
    main()
