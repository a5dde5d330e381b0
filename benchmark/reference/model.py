"""Plain PyTorch reference of the detector's forward pass.

A frozen, functional copy of what the configurations compute: the
EfficientNet-B0 trunk (BatchNorm from running statistics in eval mode, from
the batch in training mode), the encoder's 1x1 projection, the ground-plane
homographies and the bilinear warp onto the BEV grid, the concat fusion or
the deformable fusion, the positional encoding and the CenterNet head. It
takes a weight dict under the detector's parameter names (``param_specs``
lists them) and the same frames and calibrations as the program, and
computes in float32 with TF32 off. It imports nothing of the program.

``q`` is the precision of the products: every convolution's and every
matrix product's operands, and every sampled map, pass through it first
(identity for float32; ``precision.fp8`` for the control).
"""

from __future__ import annotations

import math
from typing import Callable, Dict, List, Tuple

import torch
import torch.nn.functional as F

from .precision import exact

Q = Callable[[torch.Tensor], torch.Tensor]
IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)
# (expand, out_ch, repeats, stride, kernel) of EfficientNet-B0's seven stages
B0_STAGES = ((1, 16, 1, 1, 3), (6, 24, 2, 2, 3), (6, 40, 2, 2, 5), (6, 80, 3, 2, 3),
             (6, 112, 3, 1, 5), (6, 192, 4, 2, 5), (6, 320, 1, 1, 3))
B0_LEVEL_CH = (16, 24, 40, 112, 320)
B0_BN_EPS = 1e-3
GN_GROUPS, GN_EPS = 32, 1e-5
HEAD_MID = (512, 128)
POS_CH = 2


def tf32_off() -> None:
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


# -- parameters -----------------------------------------------------------

def _b0_blocks():
    """(prefix, in_ch, out_ch, expand, kernel, stride) of every MBConv."""
    out, in_ch = [], 32
    for s, (expand, out_ch, repeats, stride, kernel) in enumerate(B0_STAGES):
        for r in range(repeats):
            out.append((f"encoder.backbone.stages.{s}.{r}.", in_ch, out_ch, expand, kernel, stride if r == 0 else 1))
            in_ch = out_ch
    return out


def bn_specs(p: str, ch: int) -> List[Tuple[str, Tuple[int, ...], str]]:
    """The five entries of a BatchNorm of ``ch`` channels under prefix ``p``."""
    return [(p + "weight", (ch,), "norm_w"), (p + "bias", (ch,), "norm_b"), (p + "running_mean", (ch,), "bn_mean"),
            (p + "running_var", (ch,), "bn_var"), (p + "num_batches_tracked", (), "count")]


def b0_specs(m: Dict) -> List[Tuple[str, Tuple[int, ...], str]]:
    """The EfficientNet-B0 trunk's weights, then the encoder's projection."""
    specs = [("encoder.backbone.stem_conv.weight", (32, 3, 3, 3), "conv")]
    specs += bn_specs("encoder.backbone.stem_bn.", 32)
    for p, cin, cout, expand, k, _ in _b0_blocks():
        mid = cin * expand
        if expand != 1:
            specs.append((p + "expand_conv.weight", (mid, cin, 1, 1), "conv"))
            specs += bn_specs(p + "expand_bn.", mid)
        specs.append((p + "dw_conv.weight", (mid, 1, k, k), "conv"))
        specs += bn_specs(p + "dw_bn.", mid)
        red = max(1, int(cin * 0.25))
        specs += [(p + "se.reduce.weight", (red, mid, 1, 1), "conv"), (p + "se.reduce.bias", (red,), "bias"),
                  (p + "se.expand.weight", (mid, red, 1, 1), "conv"), (p + "se.expand.bias", (mid,), "bias")]
        specs.append((p + "project_conv.weight", (cout, mid, 1, 1), "conv"))
        specs += bn_specs(p + "project_bn.", cout)
    return specs + proj_specs(m, B0_LEVEL_CH[m["OUT_INDEX"]])


def proj_specs(m: Dict, level_ch: int) -> List[Tuple[str, Tuple[int, ...], str]]:
    """The encoder's 1x1 projection from the trunk's ``level_ch`` channels."""
    F_ = m["FEAT_DIM"]
    return [("encoder.proj.weight", (F_, level_ch, 1, 1), "conv"), ("encoder.proj.bias", (F_,), "bias")]


def bev_specs(m: Dict) -> List[Tuple[str, Tuple[int, ...], str]]:
    """The weights after the encoder: the fusion's and the head's."""
    specs = []
    F_, C = m["FEAT_DIM"], m["BEV_PROJ_CH"]
    V = m["VIEWS"]
    if m["FUSION"] == "concat":
        specs += [("view_proj", (V, F_, C), "dense_views"), ("view_proj_bias", (C,), "bias")]
    elif m["FUSION"] == "deform_attn":
        Mh, Pt, Cq = m["ATTN_HEADS"], m["ATTN_POINTS"], C + POS_CH
        specs += [("query_proj", (V, F_, C), "dense_views"), ("query_proj_bias", (C,), "bias")]
        for name, cin, cout in (("value", F_, C), ("offsets", Cq, V * Mh * Pt * 2), ("attn", Cq, V * Mh * Pt),
                                ("out", C, C)):
            kind = "sampling" if name in ("offsets", "attn") else "dense"
            specs += [(f"deform_fusion.{name}.weight", (cout, cin), kind), (f"deform_fusion.{name}.bias", (cout,), "bias")]
    else:
        raise ValueError(f"the reference has no fusion {m['FUSION']!r}")
    cin = C + POS_CH
    for i, (name, cout, k) in enumerate((("stem0", HEAD_MID[0], 3), ("stem1", HEAD_MID[1], 3), ("stem2", HEAD_MID[1], 3))):
        specs.append((f"detector.{name}.weight", (cout, cin, k, k), "conv"))
        specs += [(f"detector.gn{i}.weight", (cout,), "norm_w"), (f"detector.gn{i}.bias", (cout,), "norm_b")]
        cin = cout
    for name, cout in (("heatmap_head", 1), ("offset_head", 2), ("size_head", 2)):
        kind = "heatmap_w" if name == "heatmap_head" else "head"
        specs += [(f"detector.{name}.weight", (cout, cin, 3, 3), kind), (f"detector.{name}.bias", (cout,), name)]
    return specs


def param_specs(m: Dict) -> List[Tuple[str, Tuple[int, ...], str]]:
    """(name, shape, kind) of every weight of the model ``m`` (the config's
    MODEL section with VIEWS added). Kinds: conv, dense (fan-in scaled),
    bias, norm_w, norm_b, bn_mean, bn_var, count."""
    return b0_specs(m) + bev_specs(m)


# -- the trunk ------------------------------------------------------------

def same_pad(x: torch.Tensor, k: int, s: int) -> torch.Tensor:
    """TensorFlow's 'SAME' padding of an NCHW map for a k x k conv of stride s."""
    pads = []
    for n in (x.shape[3], x.shape[2]):
        total = max((-(-n // s) - 1) * s + k - n, 0)
        pads += [total // 2, total - total // 2]
    return F.pad(x, pads)


class Trunk:
    """EfficientNet-B0 up to pyramid level ``level`` (0-based), then the
    encoder's 1x1 projection. ``train``: BatchNorm from the batch."""

    eps = B0_BN_EPS

    def __init__(self, w: Dict[str, torch.Tensor], level: int, q: Q = exact, train: bool = False, stats=None):
        self.w, self.level, self.q, self.train = w, level, q, train
        self.stats = stats  # a dict: record each BatchNorm's batch statistics there

    def conv(self, x, name, stride=1, groups=1, bias=None):
        wt = self.w[name]
        k = wt.shape[-1]
        b = None if bias is None else self.w[bias]
        return F.conv2d(same_pad(self.q(x), k, stride), self.q(wt), b, stride, 0, 1, groups)

    def bn(self, x, p):
        w = self.w
        if self.train:
            mean = x.mean(dim=(0, 2, 3))
            var = x.var(dim=(0, 2, 3), unbiased=False)
            if self.stats is not None:
                self.stats[p] = (mean.detach(), var.detach())
        else:
            mean, var = w[p + "running_mean"], w[p + "running_var"]
        mul = w[p + "weight"] / torch.sqrt(var + self.eps)
        return (x - mean[:, None, None]) * mul[:, None, None] + w[p + "bias"][:, None, None]

    def block(self, x, p, cin, cout, expand, k, stride):
        y = x
        mid = cin * expand
        if expand != 1:
            y = F.silu(self.bn(self.conv(y, p + "expand_conv.weight"), p + "expand_bn."))
        y = F.silu(self.bn(self.conv(y, p + "dw_conv.weight", stride, groups=mid), p + "dw_bn."))
        s = y.mean(dim=(2, 3), keepdim=True)
        s = F.silu(self.conv(s, p + "se.reduce.weight", bias=p + "se.reduce.bias"))
        y = y * torch.sigmoid(self.conv(s, p + "se.expand.weight", bias=p + "se.expand.bias"))
        y = self.bn(self.conv(y, p + "project_conv.weight"), p + "project_bn.")
        return y + x if stride == 1 and cin == cout else y

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        """x [N, 3, H, W] normalised -> the projected level [N, FEAT_DIM, h, w]."""
        y = F.silu(self.bn(self.conv(x, "encoder.backbone.stem_conv.weight", 2), "encoder.backbone.stem_bn."))
        banked = 0
        for p, cin, cout, expand, k, stride in _b0_blocks():
            if stride == 2 and p.endswith(".0."):
                if banked == self.level:
                    break
                banked += 1
            y = self.block(y, p, cin, cout, expand, k, stride)
        return self.conv(y, "encoder.proj.weight", bias="encoder.proj.bias")


def normalise(images: torch.Tensor) -> torch.Tensor:
    """uint8 [N, H, W, 3] -> float32 NCHW, ImageNet mean and std."""
    mean = torch.tensor(IMAGENET_MEAN, device=images.device) * 255.0
    std = torch.tensor(IMAGENET_STD, device=images.device) * 255.0
    return ((images.float() - mean) / std).permute(0, 3, 1, 2)


# -- geometry and sampling --------------------------------------------------

def ground_cells(Hb: int, Wb: int, bounds, device) -> Tuple[torch.Tensor, torch.Tensor]:
    """World x, y of every BEV cell's centre, [Hb, Wb] each."""
    x_min, x_max, y_min, y_max = bounds
    rx, ry = (x_max - x_min) / Wb, (y_max - y_min) / Hb
    xs = x_min + (torch.arange(Wb, device=device, dtype=torch.float64) + 0.5) * rx
    ys = y_min + (torch.arange(Hb, device=device, dtype=torch.float64) + 0.5) * ry
    yy, xx = torch.meshgrid(ys, xs, indexing="ij")
    return xx.float(), yy.float()


def project_cells(K, Rt, img_hw, feat_hw, Hb, Wb, bounds):
    """Feature-pixel coordinates [..., Hb, Wb, 2] of every cell's ground
    point and its homogeneous depth [..., Hb, Wb], for K [..., 3, 3] and
    world->camera Rt [..., 4, 4]; a depth under 1e-6 in size divides by 1."""
    xx, yy = ground_cells(Hb, Wb, bounds, K.device)
    Hm = K.float() @ torch.stack([Rt[..., :3, 0], Rt[..., :3, 1], Rt[..., :3, 3]], dim=-1).float()
    pts = torch.stack([xx, yy, torch.ones_like(xx)], dim=-1)  # [Hb, Wb, 3]
    uvw = torch.einsum("...ij,hwj->...hwi", Hm, pts)
    w = uvw[..., 2]
    ws = torch.where(w.abs() < 1e-6, torch.ones_like(w), w)
    sx, sy = feat_hw[1] / img_hw[1], feat_hw[0] / img_hw[0]
    return torch.stack([uvw[..., 0] / ws * sx, uvw[..., 1] / ws * sy], dim=-1), w


def bilinear(maps: torch.Tensor, xy: torch.Tensor) -> torch.Tensor:
    """Bilinear samples of maps [G, H, W, C] at xy [G, S, 2] (x, y in
    pixels, samples at integer positions), zero outside the map and at a
    non-finite coordinate: [G, S, C]."""
    G, H, W, C = maps.shape
    x, y = xy[..., 0], xy[..., 1]
    finite = torch.isfinite(x) & torch.isfinite(y)
    x = torch.where(finite, x, torch.full_like(x, -10.0))
    y = torch.where(finite, y, torch.full_like(y, -10.0))
    x0, y0 = torch.floor(x), torch.floor(y)
    fx, fy = x - x0, y - y0
    flat = maps.reshape(G, H * W, C)
    out = 0.0
    for dy, wy in ((0, 1.0 - fy), (1, fy)):
        for dx, wx in ((0, 1.0 - fx), (1, fx)):
            xi, yi = x0 + dx, y0 + dy
            inside = (xi >= 0) & (xi < W) & (yi >= 0) & (yi < H)
            idx = (yi.clamp(0, H - 1) * W + xi.clamp(0, W - 1)).long()
            rows = torch.gather(flat, 1, idx[..., None].expand(-1, -1, C))
            out = out + rows * (wx * wy * inside)[..., None]
    return out


def positional(Hb: int, Wb: int, bounds, device) -> torch.Tensor:
    """[Hb, Wb, 2]: sin of 2 pi x and cos of 2 pi y, each normalised over
    the bounds taken inclusively (the grid's corners, not its centres)."""
    xn = torch.linspace(0.0, 1.0, Wb, device=device)
    yn = torch.linspace(0.0, 1.0, Hb, device=device)
    yy, xx = torch.meshgrid(yn, xn, indexing="ij")
    return torch.stack([torch.sin(2 * math.pi * xx), torch.cos(2 * math.pi * yy)], dim=-1)


# -- the model ----------------------------------------------------------------

class Reference:
    """The detector of one configuration. ``cfg``: the configuration file's
    ``config`` dict (DATA, MODEL, LOSS, EVAL sections)."""

    def __init__(self, cfg: Dict, weights: Dict[str, torch.Tensor], q: Q = exact):
        d, m = cfg["DATA"], cfg["MODEL"]
        self.w, self.q = weights, q
        self.views = d["VIEWS"]
        self.img_hw = tuple(d["IMG_SIZE"][-2:])
        self.bev_hw = tuple(m["BEV_SIZE"][-2:])
        self.bounds = tuple(m["BEV_BOUNDS"])
        self.fusion, self.level = m["FUSION"], m["OUT_INDEX"]
        self.heads, self.points, self.stride = m.get("ATTN_HEADS", 4), m.get("ATTN_POINTS", 4), m.get("ATTN_STRIDE", 4)

    def feature_hw(self) -> Tuple[int, int]:
        h, w = self.img_hw
        for _ in range(self.level + 1):
            h, w = -(-h // 2), -(-w // 2)
        return h, w

    def trunk(self, train: bool = False, stats=None) -> Trunk:
        """The trunk and the encoder's projection on this model's weights;
        ``stats``: a dict where train mode records each BatchNorm's batch
        statistics by the norm's parameter prefix."""
        return Trunk(self.w, self.level, self.q, train, stats)

    def batch_stats(self, images: torch.Tensor) -> Dict[str, Tuple[torch.Tensor, torch.Tensor]]:
        """Every BatchNorm's batch mean and biased variance over the uint8
        frames [N, H, W, 3], each norm fed by the ones before it in train
        mode: the running statistics that make eval mode normalise them."""
        stats: Dict = {}
        self.trunk(True, stats)(normalise(images))
        return stats

    def encode(self, images: torch.Tensor, train: bool = False) -> torch.Tensor:
        """images [B, V, H, W, 3] uint8 -> [B, V, h, w, FEAT_DIM]."""
        B, V = images.shape[:2]
        x = normalise(images.reshape(B * V, *images.shape[2:]))
        f = self.trunk(train)(x)
        return f.permute(0, 2, 3, 1).reshape(B, V, *f.shape[2:], f.shape[1])

    def warp_sum(self, maps: torch.Tensor, coords: torch.Tensor) -> torch.Tensor:
        """maps [B, V, h, w, C], coords [B, V, Hb, Wb, 2] -> the views'
        bilinear warps summed, [B, Hb, Wb, C]."""
        B, V, h, w, C = maps.shape
        Hb, Wb = coords.shape[2:4]
        s = bilinear(self.q(maps).reshape(B * V, h, w, C), coords.reshape(B * V, Hb * Wb, 2))
        return s.reshape(B, V, Hb, Wb, C).sum(dim=1)

    def fuse(self, feats: torch.Tensor, K: torch.Tensor, Rt: torch.Tensor) -> torch.Tensor:
        """The fused BEV map [B, Hb, Wb, BEV_PROJ_CH]."""
        w, q = self.w, self.q
        Hb, Wb = self.bev_hw
        if self.fusion == "concat":
            coords, _ = project_cells(K, Rt, self.img_hw, feats.shape[2:4], Hb, Wb, self.bounds)
            proj = torch.einsum("bvhwf,vfo->bvhwo", q(feats), q(w["view_proj"]))
            return self.warp_sum(proj, coords) + w["view_proj_bias"]
        query, coords_s, depth_s, q_in = self.deform_inputs(feats, K, Rt)
        res = self.deformable(feats, coords_s, depth_s, q_in)
        if self.stride > 1:
            res = F.interpolate(res.permute(0, 3, 1, 2), size=(Hb, Wb), mode="bilinear",
                                align_corners=False).permute(0, 2, 3, 1)
        return query + res

    def warp_views(self, feats, coords):
        """Every view's warp, kept apart: [B, Hb, Wb, V, C]."""
        B, V, h, wd, C = feats.shape
        Hb, Wb = coords.shape[2:4]
        s = bilinear(self.q(feats).reshape(B * V, h, wd, C), coords.reshape(B * V, Hb * Wb, 2))
        return s.reshape(B, V, Hb, Wb, C).permute(0, 2, 3, 1, 4)

    def dense(self, x, name):
        return x @ self.q(self.w[name + ".weight"]).t() + self.w[name + ".bias"]

    def sampling(self, feats, coords, depth, query):
        """The deformable fusion's sampling: the value maps [G, h, w, hc],
        the points [G, S, 2] and their attention weights [G, S], one group a
        (frame, view, head), S = Hq * Wq * points, and whether any view
        sees each query cell [B, Hq, Wq]."""
        B, V, h, wd, _ = feats.shape
        Hq, Wq = query.shape[1:3]
        M, P = self.heads, self.points
        q = self.q(query)
        values = self.dense(self.q(feats), "deform_fusion.value")
        hc = values.shape[-1] // M
        offsets = self.dense(q, "deform_fusion.offsets").reshape(B, Hq, Wq, V, M, P, 2)
        logits = self.dense(q, "deform_fusion.attn").reshape(B, Hq, Wq, V, M, P)
        base = coords.permute(0, 2, 3, 1, 4)  # [B, Hq, Wq, V, 2]
        valid = (torch.isfinite(base).all(-1) & (base[..., 0] >= -1) & (base[..., 0] <= wd)
                 & (base[..., 1] >= -1) & (base[..., 1] <= h) & (depth.permute(0, 2, 3, 1) > 1e-6))
        logits = torch.where(valid[..., None, None], logits, torch.full_like(logits, -1e9))
        attn = torch.softmax(logits.permute(0, 1, 2, 4, 3, 5).reshape(B, Hq, Wq, M, V * P), dim=-1)
        attn = attn.reshape(B, Hq, Wq, M, V, P)
        loc = base[:, :, :, :, None, None, :] + offsets  # [B, Hq, Wq, V, M, P, 2]
        maps = values.reshape(B, V, h, wd, M, hc).permute(0, 1, 4, 2, 3, 5).reshape(B * V * M, h, wd, hc)
        xy = loc.permute(0, 3, 4, 1, 2, 5, 6).reshape(B * V * M, Hq * Wq * P, 2)
        wts = attn.permute(0, 4, 3, 1, 2, 5).reshape(B * V * M, Hq * Wq * P)
        return maps, xy, wts, valid.any(-1)

    def deformable(self, feats, coords, depth, query):
        """Multi-view deformable attention on the strided query grid:
        [B, Hq, Wq, BEV_PROJ_CH]."""
        B, V = feats.shape[:2]
        Hq, Wq = query.shape[1:3]
        M, P = self.heads, self.points
        maps, xy, wts, seen = self.sampling(feats, coords, depth, query)
        hc = maps.shape[-1]
        samples = bilinear(self.q(maps), xy) * wts[..., None]
        per_head = samples.reshape(B, V, M, Hq, Wq, P, hc).sum(dim=(1, 5))  # [B, M, Hq, Wq, hc]
        fused = per_head.permute(0, 2, 3, 1, 4).reshape(B, Hq, Wq, M * hc)
        fused = fused * seen[..., None]
        return self.dense(self.q(fused), "deform_fusion.out")

    def deform_inputs(self, feats, K, Rt):
        """The warped query [B, Hb, Wb, C] and what the deformable fusion
        gets on the strided grid: coordinates, depths and the query with
        its positional encoding."""
        Hb, Wb = self.bev_hw
        coords, depth = project_cells(K, Rt, self.img_hw, feats.shape[2:4], Hb, Wb, self.bounds)
        query = torch.einsum("bhwvf,vfo->bhwo", self.warp_views(feats, coords), self.q(self.w["query_proj"]))
        query = query + self.w["query_proj_bias"]
        pos = positional(Hb, Wb, self.bounds, feats.device).expand(feats.shape[0], Hb, Wb, POS_CH)
        s = self.stride
        q_in = torch.cat([query, pos], dim=-1)[:, ::s, ::s]
        return query, coords[:, :, ::s, ::s], depth[:, :, ::s, ::s], q_in

    def head(self, bev: torch.Tensor) -> Dict[str, torch.Tensor]:
        """bev [B, Hb, Wb, C + 2] -> logits and maps, channels-last."""
        w, q = self.w, self.q
        x = bev.permute(0, 3, 1, 2)
        for i, (name, dil) in enumerate((("stem0", 1), ("stem1", 2), ("stem2", 1))):
            x = F.conv2d(q(x), q(w[f"detector.{name}.weight"]), None, 1, dil, dil)
            x = F.relu(F.group_norm(x, GN_GROUPS, w[f"detector.gn{i}.weight"], w[f"detector.gn{i}.bias"], GN_EPS))
        out = {}
        for name in ("heatmap", "offset", "size"):
            y = F.conv2d(q(x), q(w[f"detector.{name}_head.weight"]), w[f"detector.{name}_head.bias"], 1, 1)
            out[name + "_logits"] = y.permute(0, 2, 3, 1)
        out["heatmap"] = torch.sigmoid(out["heatmap_logits"])
        out["offset"] = torch.sigmoid(out["offset_logits"])
        out["size"] = torch.exp(out["size_logits"])
        return out

    def forward(self, images, K, Rt, train: bool = False) -> Dict[str, torch.Tensor]:
        """images [B, V, H, W, 3] uint8, K [B, V, 3, 3], Rt [B, V, 4, 4]."""
        feats = self.encode(images, train)
        bev = self.fuse(feats, K, Rt)
        Hb, Wb = self.bev_hw
        pos = positional(Hb, Wb, self.bounds, bev.device).expand(bev.shape[0], Hb, Wb, POS_CH)
        return self.head(torch.cat([bev, pos], dim=-1))

    __call__ = forward
