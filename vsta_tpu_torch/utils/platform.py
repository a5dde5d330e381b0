"""``RUNTIME.DEVICE`` as a ``torch.device``: the twin of
``vsta_tpu/utils/platform.select_platform``.

``cpu`` means the CPU. Every other value means the CUDA device: the
shipped configs say ``tpu``, and for the port that names the accelerator.
Without a CUDA device that raises (``serving.resolve_device``); nothing
falls back to the CPU.
"""

from __future__ import annotations

import torch

from ..serving import resolve_device


def runtime_device(name: str) -> torch.device:
    """The device that ``RUNTIME.DEVICE: name`` asks for."""
    return resolve_device("cpu" if str(name).lower() == "cpu" else "cuda")
