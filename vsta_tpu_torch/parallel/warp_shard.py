"""The warp + concat fusion + projection on a sharded mesh: the twin of
``vsta_tpu/parallel/warp_shard.py``.

Each rank runs the single-device warp on its slice of the batch and of
the views, with its views' slice of the ``[V, C, C_out]`` kernel and no
bias; one differentiable ``all_reduce(SUM)`` over 'view' then adds the
views of the other ranks, and the bias is added once, after it. That sum
is the only collective, as the psum is in JAX's ``shard_map``. The warp's
output dtype and its dispatch follow the local view count
(``warp_cuda.warp_out_dtype``), as JAX's per-shard dispatch does.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch

from ..ops.grouped_cuda import KERNELS, GroupedKernels
from ..ops.warp_cuda import warp_proj, warp_tiles
from ..ops.warp_views_cuda import warp_views_sum
from .collectives import all_reduce_sum


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

    feats [B_local, V_local, Hf, Wf, C] and coords [V_local, Hb, Wb, 2] or
    [B_local, V_local, Hb, Wb, 2]: this rank's frames and views;
    proj_kernel [V, C, C_out], the whole kernel (this rank takes its
    views' slice); proj_bias [C_out] or None. ``impl`` 'pallas' or
    'fused', dispatched by :func:`~vsta_tpu_torch.ops.warp_cuda.warp_proj`
    as on one device. Returns [B_local, Hb, Wb, C_out]
    in ``compute_dtype``, equal on every view rank of a data group.
    """
    kernel = proj_kernel[mesh.view_slice(proj_kernel.shape[0])]
    if kernel.shape[0] != feats.shape[1]:
        raise ValueError(
            f"this rank holds {feats.shape[1]} views; its slice of the kernel has {kernel.shape[0]}"
        )
    out = warp_proj(
        feats, coords, kernel, None, compute_dtype, impl=impl, warp=warp, grouped=grouped, views_sum=views_sum
    )
    out = all_reduce_sum(out, mesh, "view")
    if proj_bias is not None:
        out = out + proj_bias.to(out.dtype)
    return out
