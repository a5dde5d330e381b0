"""Checkpoints with resume: the twin of ``vsta_tpu/training/checkpoint.py``,
with ``torch.save`` / ``torch.load(weights_only=True)`` in place of orbax.

A checkpoint is one file, ``save_dir/<name>`` (``last``, ``best``,
``mem_triggered``), so ``--checkpoint checkpoints/best`` names one as it
does for the JAX package; the files of the two packages are not readable
across them. It holds the model's parameters and buffers (BatchNorm
statistics), the optimizer's state (Adam's moments and step, the
ACCUM_STEPS running mean, the calls since the last update and the
schedule's count), ``TrainState.step``, ``epoch`` and ``best_f1``, all on
the CPU. It is written to a temporary file in ``save_dir`` and renamed
over the old one, so a crash leaves the previous checkpoint whole.
:meth:`CheckpointManager.restore` copies it into a freshly created state on
whatever device that state is on.
"""

from __future__ import annotations

import os
from pathlib import Path
from typing import Any, Dict, Optional, Tuple

import torch

from .state import TrainState

FORMAT = 1


def _cpu(tree):
    """Tensors of a nested dict/list moved to the CPU."""
    if isinstance(tree, torch.Tensor):
        return tree.detach().cpu()
    if isinstance(tree, dict):
        return {k: _cpu(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_cpu(v) for v in tree)
    return tree


class CheckpointManager:
    def __init__(self, save_dir: str):
        self.save_dir = Path(save_dir).resolve()
        self.save_dir.mkdir(parents=True, exist_ok=True)

    def _path(self, name: str) -> Path:
        return self.save_dir / name

    def save(
        self,
        name: str,
        state: TrainState,
        *,
        epoch: int,
        best_f1: float,
        extra: Optional[Dict[str, Any]] = None,
    ) -> None:
        opt = state.opt_state
        payload = {
            "format": FORMAT,
            "step": int(state.step),
            "model": _cpu(state.model.state_dict()),
            "optimizer": _cpu(opt.inner.state_dict()),
            "accumulator": _cpu(opt.acc),
            "mini_step": int(opt.mini_step),
            "count": int(opt.count),
            "epoch": int(epoch),
            "best_f1": float(best_f1),
        }
        if extra:
            payload["extra"] = extra
        path = self._path(name)
        tmp = path.with_name(f".{name}.{os.getpid()}.tmp")
        torch.save(payload, tmp)
        os.replace(tmp, path)

    def restore(self, name: str, state: TrainState) -> Tuple[TrainState, int, float]:
        """Restore into ``state`` (freshly created for the same config),
        in place; returns (state, epoch, best_f1)."""
        payload = torch.load(self._path(name), map_location="cpu", weights_only=True)
        if payload.get("format") != FORMAT:
            raise ValueError(f"{self._path(name)}: not a checkpoint of this package (format {payload.get('format')!r})")
        opt = state.opt_state
        if payload["accumulator"].keys() != opt.acc.keys():
            raise ValueError(f"{self._path(name)}: its ACCUM_STEPS accumulator does not fit this config")
        state.model.load_state_dict(payload["model"])
        opt.inner.load_state_dict(payload["optimizer"])
        with torch.no_grad():
            for k, t in payload["accumulator"].items():
                opt.acc[k].copy_(t)
        opt.mini_step = int(payload["mini_step"])
        opt.count = int(payload["count"])
        state.step = int(payload["step"])
        return state, int(payload["epoch"]), float(payload["best_f1"])

    def exists(self, name: str) -> bool:
        return self._path(name).exists()
