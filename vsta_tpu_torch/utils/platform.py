"""``RUNTIME.DEVICE`` as a ``torch.device``: the twin of
``vsta_tpu/utils/platform.select_platform``.

``cpu`` means the CPU. Every other value means the CUDA device: the
shipped configs say ``tpu``, and for the port that names the accelerator.
Without a CUDA device that raises (:func:`resolve_device`); nothing
falls back to the CPU.
"""

from __future__ import annotations

import torch


def resolve_device(device: str | torch.device) -> torch.device:
    """``device`` as a torch.device; a CUDA device must exist."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {str(device)!r} requested but no CUDA device is available; "
            "pass device='cpu' to run the plain PyTorch versions on the CPU"
        )
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}")
    return dev


def runtime_device(name: str) -> torch.device:
    """The device that ``RUNTIME.DEVICE: name`` asks for."""
    return resolve_device("cpu" if str(name).lower() == "cpu" else "cuda")
