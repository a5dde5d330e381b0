"""int8 post-training quantization of the detector head (serving), the
twin of ``vsta_tpu/ops/quant.py``.

The scheme is the JAX package's:

* weights: symmetric per-output-channel int8 (absmax / 127);
* activations: symmetric per-tensor int8, ``clip(round(x / scale))`` with
  round-half-to-even, the scales the 99.99th percentile of |x| at each
  stem convolution's input over a few calibration maps;
* the three 3x3 stem convolutions run s8 x s8 -> s32, each dequantized as
  ``y * (x_scale * w_scale)`` (the two scales multiplied first) into the
  f32 GroupNorm-32 + ReLU that follows;
* the three output convolutions (heatmap, offset, size) stay f32.

The int8 product is :func:`conv_int8`: the 'dots' lowering of the JAX
package (nine shifted slices of the zero-padded input, dilation and stride
applied in the slicing), its slices laid side by side along the
contraction axis so that one ``torch._int_mm`` (cuBLASLt's s8 x s8 -> s32
product on the card) sums all nine. Integer sums are exact, so this is
the same int32 function as JAX's 'conv' and 'dots' lowerings: a tree
keeps its ``'impl'`` string (:data:`CONV_IMPLS`) readable, and both map to
this one route. ``_int_mm`` wants more
than 16 rows and inner and output widths that are multiples of 8: the
input channels are zero-padded to a multiple of 8 (the head's 130 or 66
to 136 or 72) and the rows to 17 where fewer, both exact.

Layouts: activations are channels-last [B, H, W, C], as in the JAX
package; an int8 kernel is [Cout, KH, KW, Cin] (each output channel's taps
in the order of the slices' columns); float kernels are the port's OIHW.
"""

from __future__ import annotations

from typing import Dict, List, Mapping, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

# stem conv dilations by position (the head's middle conv is dilated 2)
_STEM_DILATIONS = (1, 2, 1)
_GN_GROUPS = 32
_GN_EPS = 1e-5
CONV_IMPL = "conv"  # the JAX package's default; both lowerings are this one route here
CONV_IMPLS = ("conv", "dots")
_MIN_ROWS = 17  # torch._int_mm's least row count on the card


def quantize_weight_per_cout(w: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """OIHW [Cout, Cin, KH, KW] float -> (int8 [Cout, KH, KW, Cin], f32 scale [Cout])."""
    w = w.float()
    absmax = w.abs().amax(dim=(1, 2, 3))
    scale = torch.clamp(absmax, min=1e-8) / 127.0
    wq = torch.clamp(torch.round(w / scale[:, None, None, None]), -127, 127).to(torch.int8)
    return wq.permute(0, 2, 3, 1).contiguous(), scale


def quantize_act(x: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """Symmetric per-tensor int8: clip(round(x / scale)), half to even."""
    return torch.clamp(torch.round(x / scale), -127, 127).to(torch.int8)


def im2col_int8(
    x_i8: torch.Tensor, kh: int, kw: int, stride: int = 1, dilation: int = 1
) -> Tuple[torch.Tensor, Tuple[int, int, int]]:
    """The 'dots' lowering's slices side by side: x_i8 [B, H, W, Cin] ->
    ([rows, kh * kw * Cin'] int8, (B, Ho, Wo)), the input zero-padded
    symmetrically (``dilation * (k - 1) // 2``) and its channels to Cin', a
    multiple of 8; rows = B * Ho * Wo, at least 17 (zero rows added)."""
    B, H, W, Cin = x_i8.shape
    d, s = dilation, stride
    ph, pw = d * (kh - 1) // 2, d * (kw - 1) // 2
    Ho = (H + 2 * ph - (d * (kh - 1) + 1)) // s + 1
    Wo = (W + 2 * pw - (d * (kw - 1) + 1)) // s + 1
    x_pad = F.pad(x_i8, (0, -Cin % 8, pw, pw, ph, ph))
    taps = [
        x_pad[:, dy * d : dy * d + s * (Ho - 1) + 1 : s, dx * d : dx * d + s * (Wo - 1) + 1 : s]
        for dy in range(kh)
        for dx in range(kw)
    ]
    cols = (torch.cat(taps, dim=-1) if len(taps) > 1 else taps[0].contiguous()).reshape(B * Ho * Wo, -1)
    if cols.shape[0] < _MIN_ROWS:
        cols = F.pad(cols, (0, 0, 0, _MIN_ROWS - cols.shape[0]))
    return cols, (B, Ho, Wo)


def conv_int8(x_i8: torch.Tensor, w_i8: torch.Tensor, stride: int = 1, dilation: int = 1) -> torch.Tensor:
    """Odd-kernel convolution with torch's symmetric padding
    (``dilation * (K - 1) // 2``) in exact int8 arithmetic.

    x_i8 [B, H, W, Cin] int8; w_i8 [Cout, KH, KW, Cin] int8 -> [B, Ho, Wo,
    Cout] int32, Ho = (H + 2p - (d * (KH - 1) + 1)) // stride + 1: one
    ``torch._int_mm`` of :func:`im2col_int8`'s slices.
    """
    Cout, KH, KW, Cin = w_i8.shape
    cols, (B, Ho, Wo) = im2col_int8(x_i8, KH, KW, stride, dilation)
    y = torch._int_mm(cols, pad_cin(w_i8).reshape(Cout, -1).t())
    return y[: B * Ho * Wo].reshape(B, Ho, Wo, Cout)


def pad_cin(w_i8: torch.Tensor) -> torch.Tensor:
    """An int8 kernel [Cout, KH, KW, Cin] with Cin zero-padded to a multiple of 8."""
    cp = -w_i8.shape[-1] % 8
    return F.pad(w_i8, (0, cp)) if cp else w_i8


def conv3x3_int8(x_i8: torch.Tensor, w_i8: torch.Tensor, dilation: int = 1) -> torch.Tensor:
    """Stride-1 3x3 wrapper over :func:`conv_int8` (the detector stem)."""
    return conv_int8(x_i8, w_i8, stride=1, dilation=dilation)


def check_impl(impl: str) -> str:
    """A tree's ``'impl'`` (the JAX lowering it was made for), checked:
    'conv' and 'dots' both run :func:`conv_int8`; anything else raises."""
    if impl not in CONV_IMPLS:
        raise ValueError(f"unknown int8 conv impl {impl!r}: one of {CONV_IMPLS}")
    return impl


def _nchw(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 3, 1, 2)


def _nhwc(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 2, 3, 1)


def _group_norm(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor) -> torch.Tensor:
    """GroupNorm(32, eps 1e-5) of a channels-last map, in f32."""
    return _nhwc(F.group_norm(_nchw(x.float()), _GN_GROUPS, scale, bias, _GN_EPS))


def _conv3x3_f32(x: torch.Tensor, kernel: torch.Tensor, bias: torch.Tensor) -> torch.Tensor:
    return _nhwc(F.conv2d(_nchw(x), kernel, bias, 1, 1))


def _float_stem_inputs(det: Mapping[str, torch.Tensor], bev_feat: torch.Tensor) -> List[torch.Tensor]:
    """Run the float stem; each convolution's input (for calibration).
    ``det``: the head's state dict (``model.detector.state_dict()``)."""
    xs = []
    x = bev_feat.float()
    for i, d in enumerate(_STEM_DILATIONS):
        xs.append(x)
        y = _nhwc(F.conv2d(_nchw(x), det[f"stem{i}.weight"].float(), None, 1, d, d))
        x = F.relu(_group_norm(y, det[f"gn{i}.weight"].float(), det[f"gn{i}.bias"].float()))
    return xs


def percentile(x: torch.Tensor, q: float) -> torch.Tensor:
    """``jnp.percentile(x, q)`` (method 'linear') of all of x, on x's device.

    ``torch.quantile`` refuses inputs above 2^24 elements (the flagship's
    stem-1 input holds 22.1 M at batch 1). This follows ``jax.numpy``'s
    ``_quantile`` step by step in float32: q / 100, times (n - 1) with n
    rounded to float32, floor and ceil clamped to [0, n - 1], and
    ``low * (1 - w) + high * w``; the two order statistics come from one
    partial sort of the top of x (``torch.topk``). NaN anywhere gives NaN.
    """
    a = x.reshape(-1).float()
    if bool(torch.isnan(a).any()):
        return torch.full((), float("nan"), device=a.device)
    f32 = np.float32
    n = f32(a.numel())
    qn = (f32(q) / f32(100.0)) * (n - f32(1.0))
    low, high = np.floor(qn), np.ceil(qn)
    w_high = f32(qn - low)
    w_low = f32(1.0) - w_high
    top = n - f32(1.0)
    count = a.numel()
    # n rounded to f32 may exceed the count above 2^24: clamp the index too, as a gather clamps it
    i_low = min(int(min(max(low, f32(0.0)), top)), count - 1)
    i_high = min(int(min(max(high, f32(0.0)), top)), count - 1)
    v = torch.topk(a, count - i_low, largest=True, sorted=True).values  # descending: v[count - 1 - i] = sorted[i]
    lo, hi = v[count - 1 - i_low], v[count - 1 - i_high]
    return lo * torch.tensor(w_low, device=a.device) + hi * torch.tensor(w_high, device=a.device)


def quantize_head(
    det: Mapping[str, torch.Tensor],
    calib_feats: Sequence[torch.Tensor],
    clip_percentile: float = 99.99,
) -> Dict:
    """Int8 serving parameters of the detector head.

    ``det``: the trained head's state dict (``model.detector.state_dict()``);
    ``calib_feats``: a few ``bev_feat`` maps [B, H, W, C] (the model's own
    output). Each stem input's activation scale is the largest over the
    maps of the ``clip_percentile`` of its |x|, over 127.

    Returns ``{'stems': [{w_i8, w_scale, x_scale, gn_scale, gn_bias} x 3],
    'out': {name: {kernel, bias}} for the three f32 output convs, 'impl':
    CONV_IMPL}``
    on ``det``'s device.
    """
    if not calib_feats:
        raise ValueError("need at least one calibration batch")
    amaxes = [0.0, 0.0, 0.0]
    with torch.no_grad():
        for feat in calib_feats:
            for i, x in enumerate(_float_stem_inputs(det, feat)):
                amaxes[i] = max(amaxes[i], float(percentile(x.abs(), clip_percentile)))
    stems = []
    for i in range(3):
        w_i8, w_scale = quantize_weight_per_cout(det[f"stem{i}.weight"])
        stems.append({
            "w_i8": w_i8,
            "w_scale": w_scale,
            # the scale in double, rounded once to f32, as the JAX package
            "x_scale": torch.tensor(max(amaxes[i], 1e-8) / 127.0, dtype=torch.float32, device=w_i8.device),
            "gn_scale": det[f"gn{i}.weight"].float().clone(),
            "gn_bias": det[f"gn{i}.bias"].float().clone(),
        })
    out = {
        name: {"kernel": det[f"{name}.weight"].float().clone(), "bias": det[f"{name}.bias"].float().clone()}
        for name in ("heatmap_head", "offset_head", "size_head")
    }
    return {"stems": stems, "out": out, "impl": CONV_IMPL}


def apply_quant_head(qparams: Dict, bev_feat: torch.Tensor) -> Dict[str, torch.Tensor]:
    """Int8-stem twin of ``BEVDetectorHead.forward`` (same output dict,
    channels-last, f32)."""
    x = bev_feat.float()
    for i, qs in enumerate(qparams["stems"]):
        y = conv3x3_int8(quantize_act(x, qs["x_scale"]), qs["w_i8"], dilation=_STEM_DILATIONS[i])
        y = y.float() * (qs["x_scale"] * qs["w_scale"])
        x = F.relu(_group_norm(y, qs["gn_scale"], qs["gn_bias"]))
    out = qparams["out"]
    hm = _conv3x3_f32(x, out["heatmap_head"]["kernel"], out["heatmap_head"]["bias"])
    off = _conv3x3_f32(x, out["offset_head"]["kernel"], out["offset_head"]["bias"])
    size = _conv3x3_f32(x, out["size_head"]["kernel"], out["size_head"]["bias"])
    return {
        "heatmap_logits": hm,
        "heatmap": torch.sigmoid(hm),
        "offset_raw": off,
        "offset": torch.sigmoid(off),
        "size_raw": size,
        "size": torch.exp(size),
    }


def tree_to(tree, device: torch.device):
    """A quantization tree (dicts, lists, tensors, strings) with its tensors
    on ``device``."""
    if isinstance(tree, torch.Tensor):
        return tree.to(device)
    if isinstance(tree, dict):
        return {k: tree_to(v, device) for k, v in tree.items()}
    if isinstance(tree, list):
        return [tree_to(v, device) for v in tree]
    return tree
