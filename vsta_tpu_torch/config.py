"""Typed configuration for the PyTorch port.

The port's own copy of the JAX package's YAML schema (sections
DATA/MODEL/TRAIN/LOSS/RUNTIME/EVAL/TRACK, same key names and defaults),
backed by frozen dataclasses. Three MODEL keys are the port's own, for
MVDet's detector (``HEAD: mvdet``): ``DILATION``, ``FEAT_SIZE`` and
``HEAD``; their defaults build every model the JAX package builds. ``RUNTIME.DEVICE`` is obeyed by the
training loop and the train/evaluate CLIs (``cpu``, or the CUDA device for
any other value: ``utils/platform.runtime_device``); the library entry
points (``build_serving_fn``, ``create_state``) take the device as an
argument.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Dict, Tuple, Union

import yaml


@dataclass(frozen=True)
class DataConfig:
    batch_size: int = 2
    img_size: Tuple[int, int] = (270, 480)  # (H, W); YAML stores [C,H,W]
    views: int = 7
    data_root: str = "data/Wildtrack"
    # cache decoded+resized uint8 frames in RAM (Wildtrack at 270x480 is
    # ~1.1 GB for all 400x7 images): decode once, then epochs are
    # normalize-only - essential when the host has few cores.
    cache_images: bool = True
    # decode official Wildtrack positionID annotations directly to world
    # coordinates (2.5 cm grid from (-3.0, -9.0) m). False = reference
    # behavior (project per-view foot points and average,
    # wildtrack_loader.py:311-363).
    use_position_id: bool = False
    # ship uint8 images to the device and normalize there (4x less
    # host->device transfer). False = reference behavior (normalize on host).
    device_normalize: bool = True


@dataclass(frozen=True)
class ModelConfig:
    backbone: str = "resnet18"
    pretrained: bool = False
    pretrained_path: str = ""  # local torch .pth state_dict to convert
    feat_dim: int = 64  # channels of the per-view feature map fed to the warp
    # pyramid level (index into feature pyramid, stride 2^(i+1)); a tuple
    # selects several levels - coarser maps are bilinearly upsampled to
    # the finest selected level and channel-concatenated (multi-scale
    # features, BASELINE configs[1])
    out_index: Union[int, Tuple[int, ...]] = 2
    # backbone normalization: 'batch' (torch parity, pretrained-loadable)
    # or 'group' (GroupNorm-32, resnets only: stateless, batch-size
    # independent, and keeps BN stat updates off the train step's
    # critical path)
    norm: str = "batch"
    bev_size: Tuple[int, int] = (120, 360)  # (H, W) cells; YAML stores [C,H,W]
    bev_bounds: Tuple[float, float, float, float] = (-24.0, 24.0, -7.2, 7.2)
    bev_proj_ch: int = 128  # channels after fused view-projection
    warp_impl: str = "fused"  # 'fused' (proj-then-warp) | 'gather' | 'pallas'
    fusion: str = "concat"  # 'concat' | 'mean' | 'max' | 'sum' | 'deform_attn'
    # Wildtrack's camera rig is fixed: one calibration for the whole
    # dataset (ref wildtrack_loader.py:288). When True the model uses
    # batch element 0's K/Rt for all frames, unlocking the shared-camera
    # warp fast path (the gather index rides the whole batch).
    static_cameras: bool = True
    # Detector-stem widths (ref detector.py:17-27 hardcodes 512/128).
    # The 512-ch stem conv dominates flagship FLOPs (~100 GFLOP/frame at
    # BEV 120x360); narrowing it trades accuracy headroom for speed.
    head_mid1: int = 512
    head_mid2: int = 128
    # deformable-attention fusion (Phase 2) knobs
    attn_heads: int = 4
    attn_points: int = 4
    # deformable attention runs on a BEV grid strided by this factor and
    # its residual is bilinearly upsampled: sampling work drops by
    # stride^2. 1 = full resolution.
    attn_stride: int = 4
    # the port's own keys (MVDet: hou-yz/MVDet, persp_trans_detector.py).
    # torchvision's replace_stride_with_dilation for the ResNets' stages
    # 2..4: a dilated stage keeps its input's stride and dilates its 3x3s
    # instead (MVDet's ResNet-18: [false, true, true], stride 8 at C5)
    dilation: Tuple[bool, bool, bool] = (False, False, False)
    # (H, W) the per-view maps are warped at, as resized bilinearly to it
    # (the resize folded into the warp's taps: ops/warp.folded_taps);
    # (0, 0): warped at the trunk's own size
    feat_size: Tuple[int, int] = (0, 0)
    # 'centernet' (the GroupNorm stem and its heatmap, offset and size
    # outputs) or 'mvdet' (MVDet's map classifier over the concatenated
    # per-view warps, an occupancy map alone: models/heads.MVDetHead; its
    # encoder has no projection, so FEAT_DIM is the trunk's channels).
    # mvdet fixes three keys, which a configuration states as they are and
    # validate() holds it to: FUSION concat and WARP_IMPL gather (each
    # view warped apart, the warps side by side) and BEV_PROJ_CH = FEAT_DIM
    # (the channels a view carries into the warp, which the benchmark's
    # operation count reads)
    head: str = "centernet"

    @property
    def bev_h(self) -> int:
        return self.bev_size[0]

    @property
    def bev_w(self) -> int:
        return self.bev_size[1]

    @property
    def res_x(self) -> float:
        """Metres a BEV cell along x."""
        b = self.bev_bounds
        return (b[1] - b[0]) / float(self.bev_w)

    @property
    def res_y(self) -> float:
        """Metres a BEV cell along y."""
        b = self.bev_bounds
        return (b[3] - b[2]) / float(self.bev_h)


@dataclass(frozen=True)
class TrainConfig:
    epochs: int = 50
    lr: float = 1e-3
    opt: str = "Adam"
    weight_decay: float = 1e-4
    lr_scheduler: str = "cosine_warm"
    warmup_epochs: int = 3
    accum_steps: int = 1
    patience: int = 0
    seed: int = 0
    freeze_backbone: bool = False  # reference ViewEncoder.freeze (base.py:26-28)


@dataclass(frozen=True)
class LossConfig:
    default_box_wh: Tuple[float, float] = (0.6, 0.6)
    max_objects: int = 64
    hm_alpha: float = 2.0
    hm_beta: float = 4.0
    hm_weight: float = 1.0
    offset_weight: float = 1.0
    size_weight: float = 0.1
    gaussian_min_radius: int = 2
    gaussian_iou: float = 0.7


@dataclass(frozen=True)
class RuntimeConfig:
    # 'cpu', or any other value for the CUDA device (utils/platform.py);
    # the library entry points take the device as an argument instead
    device: str = "tpu"
    num_workers: int = 4
    save_dir: str = "checkpoints/"
    output_dir: str = "outputs/"
    use_amp: bool = True  # bfloat16 compute, float32 params; no loss scaler
    debug_max_steps: int = 0
    debug_nans: bool = False
    memory_limit_percent: int = 90
    mesh_data: int = 0  # 0 => use all devices on the data axis
    mesh_view: int = 1


@dataclass(frozen=True)
class EvalConfig:
    conf_thresh: float = 0.4
    nms_dist_m: float = 0.5
    interval: int = 1
    max_dets: int = 128  # static-shape cap on decoded detections per frame
    baseline_model: str = "baseline"
    baseline_f1: float = 0.0
    improvement_threshold: float = 5.0


@dataclass(frozen=True)
class TrackConfig:
    """SORT tracker knobs (Phase 3; reference declares but stubs tracking)."""

    max_age: int = 5
    min_hits: int = 2
    match_dist_m: float = 1.0


@dataclass(frozen=True)
class Config:
    data: DataConfig = field(default_factory=DataConfig)
    model: ModelConfig = field(default_factory=ModelConfig)
    train: TrainConfig = field(default_factory=TrainConfig)
    loss: LossConfig = field(default_factory=LossConfig)
    runtime: RuntimeConfig = field(default_factory=RuntimeConfig)
    eval: EvalConfig = field(default_factory=EvalConfig)
    track: TrackConfig = field(default_factory=TrackConfig)


def _get(d: Dict[str, Any], key: str, default: Any) -> Any:
    v = d.get(key, default)
    return default if v is None else v


VALID_FUSION = ("concat", "mean", "max", "sum", "attn", "deform_attn")
VALID_HEADS = ("centernet", "mvdet")
VALID_WARP_IMPL = ("fused", "gather", "pallas")
VALID_BACKBONES = (
    "simple",
    "resnet18",
    "resnet34",
    "resnet50",
    "resnet101",
    "efficientnet_b0",
)


def validate(cfg: Config) -> Config:
    """Fail fast on invalid enum-like values instead of erroring deep
    inside model construction."""
    if cfg.model.fusion not in VALID_FUSION:
        raise ValueError(
            f"MODEL.FUSION={cfg.model.fusion!r} is not one of {VALID_FUSION}"
        )
    if cfg.model.warp_impl not in VALID_WARP_IMPL:
        raise ValueError(
            f"MODEL.WARP_IMPL={cfg.model.warp_impl!r} is not one of {VALID_WARP_IMPL}"
        )
    if cfg.model.backbone not in VALID_BACKBONES:
        raise ValueError(
            f"MODEL.BACKBONE={cfg.model.backbone!r} is not one of {VALID_BACKBONES}"
        )
    if cfg.data.views < 1:
        raise ValueError(f"DATA.VIEWS must be >= 1, got {cfg.data.views}")
    oi = cfg.model.out_index
    levels = (oi,) if isinstance(oi, int) else tuple(oi)
    # pyramids have 5 levels (stride 2^(i+1)); fail here, not deep inside
    # the encoder
    if len(levels) == 0 or any(
        not isinstance(i, int) or i < 0 or i > 4 for i in levels
    ):
        raise ValueError(
            f"MODEL.OUT_INDEX={oi!r} must be a pyramid level in [0, 4] "
            "or a non-empty list of them"
        )
    if cfg.model.attn_stride < 1:
        raise ValueError(f"MODEL.ATTN_STRIDE must be >= 1, got {cfg.model.attn_stride}")
    for key, val in (("HEAD_MID1", cfg.model.head_mid1), ("HEAD_MID2", cfg.model.head_mid2)):
        # detector stem uses GroupNorm(32) (ref detector.py:18-26)
        if val < 32 or val % 32 != 0:
            raise ValueError(f"MODEL.{key} must be a positive multiple of 32, got {val}")
    _validate_head(cfg.model)
    return cfg


def _validate_head(m: ModelConfig) -> None:
    """The port's own keys: MVDet's detector, and what it needs."""
    if m.head not in VALID_HEADS:
        raise ValueError(f"MODEL.HEAD={m.head!r} is not one of {VALID_HEADS}")
    if len(m.dilation) != 3:
        raise ValueError(f"MODEL.DILATION must list 3 stages (2 to 4), got {list(m.dilation)}")
    if any(m.dilation) and not m.backbone.startswith("resnet"):
        raise ValueError(f"MODEL.DILATION is for the resnet backbones, not {m.backbone!r}")
    if len(m.feat_size) != 2 or any(s < 0 for s in m.feat_size):
        raise ValueError(f"MODEL.FEAT_SIZE must be [H, W] (or [0, 0]), got {list(m.feat_size)}")
    if m.head == "centernet":
        if any(m.feat_size):
            raise ValueError("MODEL.FEAT_SIZE is for HEAD mvdet")
        return
    wants = {"FUSION": (m.fusion, "concat"), "WARP_IMPL": (m.warp_impl, "gather"),
             "BEV_PROJ_CH": (m.bev_proj_ch, m.feat_dim)}
    for key, (got, want) in wants.items():
        if got != want:
            raise ValueError(f"MODEL.HEAD mvdet warps every view's map apart and concatenates them: "
                             f"MODEL.{key} must be {want!r}, got {got!r}")
    if not all(m.feat_size):
        raise ValueError("MODEL.HEAD mvdet needs MODEL.FEAT_SIZE, the size its maps are warped at")
    if not isinstance(m.out_index, int):
        raise ValueError(f"MODEL.HEAD mvdet takes one pyramid level, got MODEL.OUT_INDEX={m.out_index!r}")


def from_dict(raw: Dict[str, Any]) -> Config:
    """Build a Config from a reference-schema YAML dict."""
    raw = raw or {}
    d = raw.get("DATA", {}) or {}
    m = raw.get("MODEL", {}) or {}
    t = raw.get("TRAIN", {}) or {}
    l = raw.get("LOSS", {}) or {}
    r = raw.get("RUNTIME", {}) or {}
    e = raw.get("EVAL", {}) or {}
    k = raw.get("TRACK", {}) or {}

    img_size = _get(d, "IMG_SIZE", [3, 270, 480])
    if len(img_size) == 3:  # [C,H,W] as in the reference
        img_hw = (int(img_size[1]), int(img_size[2]))
    else:
        img_hw = (int(img_size[0]), int(img_size[1]))

    bev_size = _get(m, "BEV_SIZE", [32, 120, 360])
    if len(bev_size) == 3:  # [C,H,W]; channel entry parsed-but-unused in ref
        bev_hw = (int(bev_size[1]), int(bev_size[2]))
    else:
        bev_hw = (int(bev_size[0]), int(bev_size[1]))

    default_wh = _get(l, "DEFAULT_BOX_WH", [0.6, 0.6])

    cfg = Config(
        data=DataConfig(
            batch_size=int(_get(d, "BATCH_SIZE", 2)),
            img_size=img_hw,
            views=int(_get(d, "VIEWS", 7)),
            data_root=str(_get(d, "DATA_ROOT", "data/Wildtrack")),
            cache_images=bool(_get(d, "CACHE_IMAGES", True)),
            use_position_id=bool(_get(d, "USE_POSITION_ID", False)),
            device_normalize=bool(_get(d, "DEVICE_NORMALIZE", True)),
        ),
        model=ModelConfig(
            backbone=str(_get(m, "BACKBONE", "resnet18")),
            norm=str(_get(m, "NORM", "batch")),
            pretrained=bool(_get(m, "PRETRAINED", False)),
            pretrained_path=str(_get(m, "PRETRAINED_PATH", "")),
            feat_dim=int(_get(m, "FEAT_DIM", 64)),
            out_index=(
                tuple(int(i) for i in _get(m, "OUT_INDEX", 2))
                if isinstance(_get(m, "OUT_INDEX", 2), (list, tuple))
                else int(_get(m, "OUT_INDEX", 2))
            ),
            bev_size=bev_hw,
            bev_bounds=tuple(float(x) for x in _get(m, "BEV_BOUNDS", [-24.0, 24.0, -7.2, 7.2])),
            bev_proj_ch=int(_get(m, "BEV_PROJ_CH", 128)),
            warp_impl=str(_get(m, "WARP_IMPL", "fused")),
            fusion=str(_get(m, "FUSION", "concat")),
            static_cameras=bool(_get(m, "STATIC_CAMERAS", True)),
            head_mid1=int(_get(m, "HEAD_MID1", 512)),
            head_mid2=int(_get(m, "HEAD_MID2", 128)),
            attn_heads=int(_get(m, "ATTN_HEADS", 4)),
            attn_points=int(_get(m, "ATTN_POINTS", 4)),
            attn_stride=int(_get(m, "ATTN_STRIDE", 4)),
            dilation=tuple(bool(x) for x in _get(m, "DILATION", [False, False, False])),
            feat_size=tuple(int(x) for x in _get(m, "FEAT_SIZE", [0, 0])),
            head=str(_get(m, "HEAD", "centernet")),
        ),
        train=TrainConfig(
            epochs=int(_get(t, "EPOCHS", 50)),
            lr=float(_get(t, "LR", 1e-3)),
            opt=str(_get(t, "OPT", "Adam")),
            weight_decay=float(_get(t, "WEIGHT_DECAY", 1e-4)),
            lr_scheduler=str(_get(t, "LR_SCHEDULER", "cosine_warm")),
            warmup_epochs=int(_get(t, "WARMUP_EPOCHS", 3)),
            accum_steps=int(_get(t, "ACCUM_STEPS", 1)),
            patience=int(_get(t, "PATIENCE", 0)),
            seed=int(_get(t, "SEED", 0)),
            freeze_backbone=bool(_get(t, "FREEZE_BACKBONE", False)),
        ),
        loss=LossConfig(
            default_box_wh=(float(default_wh[0]), float(default_wh[1])),
            max_objects=int(_get(l, "MAX_OBJECTS", 64)),
            hm_alpha=float(_get(l, "HM_ALPHA", 2.0)),
            hm_beta=float(_get(l, "HM_BETA", 4.0)),
            hm_weight=float(_get(l, "HM_WEIGHT", 1.0)),
            offset_weight=float(_get(l, "OFFSET_WEIGHT", 1.0)),
            size_weight=float(_get(l, "SIZE_WEIGHT", 0.1)),
            gaussian_min_radius=int(_get(l, "GAUSSIAN_MIN_RADIUS", 2)),
            gaussian_iou=float(_get(l, "GAUSSIAN_IOU", 0.7)),
        ),
        runtime=RuntimeConfig(
            device=str(_get(r, "DEVICE", "tpu")),
            num_workers=int(_get(r, "NUM_WORKERS", 4)),
            save_dir=str(_get(r, "SAVE_DIR", "checkpoints/")),
            output_dir=str(_get(r, "OUTPUT_DIR", "outputs/")),
            use_amp=bool(_get(r, "USE_AMP", True)),
            debug_max_steps=int(_get(r, "DEBUG_MAX_STEPS", 0)),
            debug_nans=bool(_get(r, "DEBUG_NANS", False)),
            memory_limit_percent=int(_get(r, "MEMORY_LIMIT_PERCENT", 90)),
            mesh_data=int(_get(r, "MESH_DATA", 0)),
            mesh_view=int(_get(r, "MESH_VIEW", 1)),
        ),
        eval=EvalConfig(
            conf_thresh=float(_get(e, "CONF_THRESH", 0.4)),
            nms_dist_m=float(_get(e, "NMS_DIST_M", 0.5)),
            interval=int(_get(e, "INTERVAL", 1)),
            max_dets=int(_get(e, "MAX_DETS", 128)),
            baseline_model=str(_get(e, "BASELINE_MODEL", "baseline")),
            baseline_f1=float(_get(e, "BASELINE_F1", 0.0)),
            improvement_threshold=float(_get(e, "IMPROVEMENT_THRESHOLD", 5.0)),
        ),
        track=TrackConfig(
            max_age=int(_get(k, "MAX_AGE", 5)),
            min_hits=int(_get(k, "MIN_HITS", 2)),
            match_dist_m=float(_get(k, "MATCH_DIST_M", 1.0)),
        ),
    )
    return validate(cfg)


def to_dict(cfg: Config) -> Dict[str, Any]:
    """A Config back in the reference YAML schema: every key
    :func:`from_dict` reads, so ``from_dict(to_dict(cfg)) == cfg``."""
    d, m, t, l, r, e, k = cfg.data, cfg.model, cfg.train, cfg.loss, cfg.runtime, cfg.eval, cfg.track
    return {
        "DATA": {
            "BATCH_SIZE": d.batch_size, "IMG_SIZE": [3, d.img_size[0], d.img_size[1]], "VIEWS": d.views,
            "DATA_ROOT": d.data_root, "CACHE_IMAGES": d.cache_images, "USE_POSITION_ID": d.use_position_id,
            "DEVICE_NORMALIZE": d.device_normalize,
        },
        "MODEL": {
            "BACKBONE": m.backbone, "PRETRAINED": m.pretrained, "PRETRAINED_PATH": m.pretrained_path,
            "FEAT_DIM": m.feat_dim, "NORM": m.norm,
            "OUT_INDEX": list(m.out_index) if isinstance(m.out_index, tuple) else m.out_index,
            "BEV_SIZE": [32, m.bev_size[0], m.bev_size[1]], "BEV_BOUNDS": list(m.bev_bounds),
            "BEV_PROJ_CH": m.bev_proj_ch, "WARP_IMPL": m.warp_impl, "FUSION": m.fusion,
            "STATIC_CAMERAS": m.static_cameras, "HEAD_MID1": m.head_mid1, "HEAD_MID2": m.head_mid2,
            "ATTN_HEADS": m.attn_heads, "ATTN_POINTS": m.attn_points, "ATTN_STRIDE": m.attn_stride,
            "DILATION": list(m.dilation), "FEAT_SIZE": list(m.feat_size), "HEAD": m.head,
        },
        "TRAIN": {
            "EPOCHS": t.epochs, "LR": t.lr, "OPT": t.opt, "WEIGHT_DECAY": t.weight_decay,
            "LR_SCHEDULER": t.lr_scheduler, "WARMUP_EPOCHS": t.warmup_epochs, "ACCUM_STEPS": t.accum_steps,
            "PATIENCE": t.patience, "SEED": t.seed, "FREEZE_BACKBONE": t.freeze_backbone,
        },
        "LOSS": {
            "DEFAULT_BOX_WH": list(l.default_box_wh), "MAX_OBJECTS": l.max_objects, "HM_ALPHA": l.hm_alpha,
            "HM_BETA": l.hm_beta, "HM_WEIGHT": l.hm_weight, "OFFSET_WEIGHT": l.offset_weight,
            "SIZE_WEIGHT": l.size_weight, "GAUSSIAN_MIN_RADIUS": l.gaussian_min_radius,
            "GAUSSIAN_IOU": l.gaussian_iou,
        },
        "RUNTIME": {
            "DEVICE": r.device, "NUM_WORKERS": r.num_workers, "SAVE_DIR": r.save_dir, "OUTPUT_DIR": r.output_dir,
            "USE_AMP": r.use_amp, "DEBUG_MAX_STEPS": r.debug_max_steps, "DEBUG_NANS": r.debug_nans,
            "MEMORY_LIMIT_PERCENT": r.memory_limit_percent, "MESH_DATA": r.mesh_data, "MESH_VIEW": r.mesh_view,
        },
        "EVAL": {
            "CONF_THRESH": e.conf_thresh, "NMS_DIST_M": e.nms_dist_m, "INTERVAL": e.interval,
            "MAX_DETS": e.max_dets, "BASELINE_MODEL": e.baseline_model, "BASELINE_F1": e.baseline_f1,
            "IMPROVEMENT_THRESHOLD": e.improvement_threshold,
        },
        "TRACK": {"MAX_AGE": k.max_age, "MIN_HITS": k.min_hits, "MATCH_DIST_M": k.match_dist_m},
    }


def load_config(path: str) -> Config:
    """Load a reference-schema YAML config file (UTF-8, like ref train.py:40-43)."""
    with open(path, "r", encoding="utf-8") as f:
        raw = yaml.safe_load(f)
    return from_dict(raw)
