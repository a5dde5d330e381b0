"""Device and host telemetry: the port's own copy of
``vsta_tpu/utils/telemetry.py``, from ``torch.cuda.mem_get_info`` and
``torch.cuda.memory_allocated`` in place of the JAX runtime's stats.
The device readings are None or empty on the CPU.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch


def device_memory_stats(device: Optional[torch.device] = None) -> Dict[str, float]:
    """Per CUDA device: memory in use on the card (every process's), the
    caching allocator's share of it (MiB) and the percent of the card.
    Only ``device`` when one is given; empty on a CPU device or without CUDA."""
    if device is not None and device.type != "cuda":
        return {}
    if not torch.cuda.is_available():
        return {}
    indices = range(torch.cuda.device_count()) if device is None else [device.index or 0]
    out: Dict[str, float] = {}
    for i in indices:
        free, total = torch.cuda.mem_get_info(i)
        used = total - free
        out[f"device{i}_mem_used_mb"] = used / (1024 * 1024)
        out[f"device{i}_allocated_mb"] = torch.cuda.memory_allocated(i) / (1024 * 1024)
        if total:
            out[f"device{i}_mem_percent"] = 100.0 * used / total
    return out


def host_stats() -> Dict[str, float]:
    """CPU and RAM percent through psutil; empty where it does not import."""
    try:
        import psutil
    except ImportError:
        return {}
    return {
        "cpu_percent": psutil.cpu_percent(interval=None),
        "ram_percent": psutil.virtual_memory().percent,
    }


def max_device_memory_percent(device: Optional[torch.device] = None) -> Optional[float]:
    """The fullest card's memory percent; None on the CPU."""
    stats = device_memory_stats(device)
    pcts = [v for k, v in stats.items() if k.endswith("mem_percent")]
    return max(pcts) if pcts else None
