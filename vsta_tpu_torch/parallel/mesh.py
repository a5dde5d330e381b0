"""The ('data', 'view') mesh over ``torch.distributed``: the twin of
``vsta_tpu/parallel/mesh.py``.

One process a device. The ranks of a mesh of ``n_data x n_view`` sit at
``(rank // n_view, rank % n_view)``, as JAX lays its devices out with
``reshape(n_data, n_view)``:

* 'data' splits the batch: each rank takes ``B / n_data`` frames;
* 'view' splits the cameras of the host batch, and the model partitions
  them as JAX's compiled mesh program does: each rank gathers the images
  of its data group over 'view' and encodes every view of its frames,
  then warps its ``V / n_view`` views, and the warp's sum over the views
  crosses the ranks of its data group
  (:mod:`~vsta_tpu_torch.parallel.warp_shard`).

Parameters are replicated; every view rank holds the whole gradients of
its frames, and they are summed over 'data', so the gradients on every
rank equal the single-device gradients of the global batch
(``training/state.py``). A process with no process group is the 1x1
mesh: it makes no collective and runs the single-device code as it is.

Launch: ``torchrun --nproc_per_node N -m vsta_tpu_torch.train --config
C`` with ``RUNTIME.MESH_DATA`` / ``MESH_VIEW`` set; :func:`init_distributed`
reads torchrun's environment.
"""

from __future__ import annotations

import os
import sys
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

from ..utils.platform import resolve_device

AXES = ("data", "view")


def _largest_divisor_leq(n: int, cap: int) -> int:
    """Largest d such that d | n and d <= cap (n, cap >= 1)."""
    for d in range(min(n, cap), 0, -1):
        if n % d == 0:
            return d
    return 1


def world() -> Tuple[int, int]:
    """(rank, world size); (0, 1) without a process group."""
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


def init_distributed(device: str | torch.device = "cuda", backend: Optional[str] = None) -> torch.device:
    """Join the process group that torchrun describes (``RANK``,
    ``WORLD_SIZE``, ``LOCAL_RANK``, ``MASTER_ADDR``, ``MASTER_PORT``) and
    return this rank's device.

    Without ``RANK`` in the environment there is no process group: a world
    of one, and ``device`` as it is. A CUDA device without an index
    becomes ``cuda:LOCAL_RANK``, one device a rank; one with an index
    stays. ``backend``: NCCL for a CUDA device, gloo for the CPU, unless
    the caller names one (two gloo ranks can share one card, which NCCL
    refuses). Joining twice is a no-op.
    """
    dev = resolve_device(device)
    if "RANK" not in os.environ and not dist.is_initialized():
        return dev
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", int(os.environ.get("LOCAL_RANK", "0")))
    if not dist.is_initialized():
        if dev.type == "cuda":
            torch.cuda.set_device(dev)
        dist.init_process_group(
            backend or ("nccl" if dev.type == "cuda" else "gloo"),
            rank=int(os.environ["RANK"]), world_size=int(os.environ["WORLD_SIZE"]),
        )
    return dev


def quiet_unless_main() -> None:
    """Send this process's standard output to /dev/null unless it is
    rank 0, so that a CLI under torchrun prints its lines once."""
    if world()[0] != 0:
        sys.stdout = open(os.devnull, "w")


class Mesh:
    """The ('data', 'view') mesh of ranks this process belongs to.

    ``shape`` {'data': n, 'view': m}; ``rank``, ``data_index``,
    ``view_index``: this rank and its coordinates; ``group``,
    ``data_group`` (the ranks of this view index, one a data index) and
    ``view_group`` (the ranks of this data index): its process groups,
    None on an axis of one rank. ``member`` is False for a rank that the
    clamp left out: it takes no part.
    """

    axis_names = AXES

    def __init__(self, n_data: int, n_view: int, rank: int = 0, groups: Optional[Dict[str, Any]] = None):
        self.n_data, self.n_view = n_data, n_view
        self.rank = rank
        self.member = rank < n_data * n_view
        self.data_index, self.view_index = divmod(rank, n_view) if self.member else (-1, -1)
        groups = groups or {}
        self.group = groups.get("mesh")
        self.data_group = groups.get("data")
        self.view_group = groups.get("view")

    @property
    def shape(self) -> Dict[str, int]:
        return {"data": self.n_data, "view": self.n_view}

    @property
    def size(self) -> int:
        return self.n_data * self.n_view

    @property
    def is_main(self) -> bool:
        return self.rank == 0

    def __repr__(self) -> str:
        return f"Mesh({self.shape}, rank={self.rank})"

    def local_views(self, views: int) -> int:
        if views % self.n_view:
            raise ValueError(f"views {views} not divisible by the view axis {self.n_view}")
        return views // self.n_view

    def view_slice(self, views: int) -> slice:
        n = self.local_views(views)
        return slice(self.view_index * n, (self.view_index + 1) * n)

    def data_slice(self, batch: int) -> slice:
        if batch % self.n_data:
            raise ValueError(f"batch {batch} not divisible by the data axis {self.n_data}")
        n = batch // self.n_data
        return slice(self.data_index * n, (self.data_index + 1) * n)

    def slice_batch(self, batch: Dict[str, Any]) -> Dict[str, Any]:
        """This rank's part of a host batch, by :func:`batch_sharding`:
        ``[B, V, ...]`` arrays over both axes, per-frame arrays over
        'data', anything else whole."""
        if not self.member:
            raise ValueError(f"rank {self.rank} is outside the {self.n_data}x{self.n_view} mesh: it holds no part")
        spec = batch_sharding(self)
        out = {}
        for k, v in batch.items():
            axes = spec.get(k, ())
            if axes:
                v = v[self.data_slice(v.shape[0])]
            if "view" in axes:
                v = v[:, self.view_slice(v.shape[1])]
            out[k] = v
        return out


def make_mesh(
    n_data: int = 0,
    n_view: int = 1,
    *,
    batch_size: Optional[int] = None,
    views: Optional[int] = None,
    register: bool = False,
) -> Mesh:
    """Build the ('data', 'view') mesh over the process group's ranks.
    ``n_data=0`` means world // n_view.

    Given ``batch_size`` / ``views``, each axis is clamped to the largest
    divisor of that dimension, as JAX's ``make_mesh`` does (with its
    messages). A mesh larger than the world raises. Ranks past the mesh
    say so and are left out (``member`` False). Every rank of the world
    must call this, in the same order: it creates the process groups.
    ``register=True`` also makes the mesh the active one
    (:func:`set_active_mesh`); registration is opt-in.
    """
    rank, n = world()
    if views is not None and n_view > 1 and views % n_view != 0:
        new_view = _largest_divisor_leq(views, n_view)
        print(f"[mesh] VIEWS={views} not divisible by mesh_view={n_view}; clamping the view axis to {new_view}")
        n_view = new_view
    if n_data <= 0:
        n_data = max(1, n // max(1, n_view))
    if batch_size is not None and batch_size % n_data != 0:
        new_data = _largest_divisor_leq(batch_size, n_data)
        print(
            f"[mesh] BATCH_SIZE={batch_size} not divisible by "
            f"mesh_data={n_data}; clamping the data axis to {new_data} "
            f"device(s) (set RUNTIME.MESH_DATA or a divisible DATA."
            "BATCH_SIZE to use more)"
        )
        n_data = new_data
    use = n_data * n_view
    if use > n:
        raise ValueError(f"a {n_data}x{n_view} mesh needs {use} ranks; the world has {n}")
    groups: Dict[str, Any] = {}
    if use > 1:
        # new_group is collective over the world: every rank creates every
        # group, in this order, and keeps its own
        mesh_ranks = list(range(use))
        g = dist.new_group(mesh_ranks) if use < n else dist.group.WORLD
        if rank < use:
            groups["mesh"] = g
        if n_data > 1:
            for v in range(n_view):
                ranks = [d * n_view + v for d in range(n_data)]
                g = dist.new_group(ranks)
                if rank in ranks:
                    groups["data"] = g
        if n_view > 1:
            for d in range(n_data):
                ranks = [d * n_view + v for v in range(n_view)]
                g = dist.new_group(ranks)
                if rank in ranks:
                    groups["view"] = g
    mesh = Mesh(n_data, n_view, rank, groups)
    if not mesh.member:
        print(f"[mesh] rank {rank} is outside the {n_data}x{n_view} mesh; it takes no part")
    if register:
        set_active_mesh(mesh)
    return mesh


class _ActiveSentinel:
    """Default for mesh-accepting APIs: 'consult the active-mesh
    registry'. Distinct from None, which means single-device."""

    def __repr__(self) -> str:  # pragma: no cover
        return "<active mesh>"


ACTIVE = _ActiveSentinel()

_ACTIVE_MESH: Optional[Mesh] = None


def set_active_mesh(mesh: Optional[Mesh]) -> Optional[Mesh]:
    """Register the mesh the program runs under (None to clear); returns
    the previous one. ``BEVNet.from_config(cfg, mesh=ACTIVE)`` reads it.
    Prefer passing the mesh explicitly."""
    global _ACTIVE_MESH
    prev = _ACTIVE_MESH
    _ACTIVE_MESH = mesh
    return prev


def get_active_mesh() -> Optional[Mesh]:
    return _ACTIVE_MESH


def batch_sharding(mesh: Mesh) -> Dict[str, Tuple[str, ...]]:
    """The mesh axes each key of a collated batch is split over:
    ``[B, V, ...]`` arrays over ('data', 'view'), per-frame arrays over
    'data'; a key not named here is replicated."""
    return {
        "images": AXES,
        "K": AXES,
        "Rt": AXES,
        "boxes_world": ("data",),
        "num_boxes": ("data",),
        "frame_idx": ("data",),
        "batch_mask": ("data",),
    }


def shard_batch(batch: Dict[str, Any], mesh: Mesh, device: str | torch.device) -> Dict[str, torch.Tensor]:
    """This rank's part of a host batch (numpy arrays), put on ``device``
    through the pinned :class:`~vsta_tpu_torch.data.pipeline.DevicePut`;
    the current stream waits for the copies."""
    from ..data.pipeline import DevicePut  # which imports the model through serving

    put = DevicePut(device)
    out, event = put({k: np.asarray(v) for k, v in mesh.slice_batch(batch).items()})
    if event is not None:
        torch.cuda.current_stream(put.device).wait_event(event)
    return out
