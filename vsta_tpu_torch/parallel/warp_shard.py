"""The warp + concat fusion + projection on a sharded mesh: the twin of
``vsta_tpu/parallel/warp_shard.py``.

Every rank holds the features of all the views of its frames (the
encoder runs on every view, as JAX's compiled mesh program runs it). Each
rank takes its slice of the views, of their coordinates and of the
``[V, C, C_out]`` kernel, runs the single-device warp on it with no bias,
and one ``all_reduce(SUM)`` over 'view' adds the other ranks' views; the
bias is added once, after it. That sum is the one split over 'view', as
the psum is in JAX's program. In the backward each rank's cotangent slice
of the features and of the kernel is gathered over 'view', so every
rank holds the whole features' cotangent (the encoder's backward then
runs whole on each) and the whole kernel's gradient. The warp's output
dtype and its dispatch follow the local view count
(``warp_cuda.warp_out_dtype``), as JAX's per-shard dispatch does.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch

from ..ops.grouped_cuda import KERNELS, GroupedKernels
from ..ops.warp_cuda import warp_proj, warp_tiles
from ..ops.warp_views_cuda import warp_views_sum
from .collectives import sum_to_replicated, take_slice


def warp_proj_sharded(
    feats: torch.Tensor,
    coords: torch.Tensor,
    proj_kernel: torch.Tensor,
    proj_bias: Optional[torch.Tensor],
    mesh,
    *,
    impl: str = "fused",
    compute_dtype: torch.dtype = torch.float32,
    warp: Callable = warp_tiles,
    grouped: GroupedKernels = KERNELS,
    views_sum: Callable = warp_views_sum,
) -> torch.Tensor:
    """Mesh-sharded warp + concat fusion + 1x1 projection.

    feats [B_local, V, Hf, Wf, C] and coords [V, Hb, Wb, 2] or
    [B_local, V, Hb, Wb, 2]: this rank's frames, every view;
    proj_kernel [V, C, C_out]; proj_bias [C_out] or None. ``impl``
    'pallas' or 'fused', dispatched by
    :func:`~vsta_tpu_torch.ops.warp_cuda.warp_proj` as on one device, on
    this rank's ``V / n_view`` views. Returns [B_local, Hb, Wb, C_out] in
    ``compute_dtype``, equal on every view rank of a data group.
    """
    V = feats.shape[1]
    if proj_kernel.shape[0] != V:
        raise ValueError(f"features of {V} views; the kernel has {proj_kernel.shape[0]}")
    feats = take_slice(feats, mesh, "view", 1)
    kernel = take_slice(proj_kernel, mesh, "view", 0)
    coords = coords[mesh.view_slice(V)] if coords.ndim == 4 else coords[:, mesh.view_slice(V)]
    out = warp_proj(
        feats, coords, kernel, None, compute_dtype, impl=impl, warp=warp, grouped=grouped, views_sum=views_sum
    )
    out = sum_to_replicated(out, mesh, "view")
    if proj_bias is not None:
        out = out + proj_bias.to(out.dtype)
    return out
