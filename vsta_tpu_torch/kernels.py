"""Build and load the port's CUDA kernels.

Each ``csrc/<name>.cu`` compiles with ``nvcc`` into a shared library with
a plain C interface, loaded with :mod:`ctypes`. The build runs at first
use, from the package's sources only, into ``build/kernels/`` beside the
package (listed in ``.gitignore``); the library's file name carries a
hash of its source and of the headers in ``csrc/``, so an edited source
or header is rebuilt.

With ``VSTA_TORCH_LAUNCH_LOG`` set to a file's path, a process that
imported the kernels appends one JSON line to it when it exits: its pid,
its command line and every kernel wrapper's launch count
(:func:`launch_counts`). So a caller can count the launches of the CLIs
it runs as subprocesses (``chip_smoke.py``'s e2e phase).
"""

from __future__ import annotations

import atexit
import ctypes
import functools
import hashlib
import json
import os
import shutil
import subprocess
import sys
from pathlib import Path
from typing import Dict

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent.parent / "build" / "kernels"
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
]

_loaded: Dict[str, ctypes.CDLL] = {}
LAUNCH_LOG_ENV = "VSTA_TORCH_LAUNCH_LOG"


def _nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    for cand in (os.path.join(cuda_home, "bin", "nvcc"), shutil.which("nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found (set CUDA_HOME or put nvcc on PATH)")


def library_path(name: str) -> Path:
    """The library's path, named by a hash of its source and of every
    header in ``csrc/`` (a source may include them)."""
    h = hashlib.sha1((CSRC / f"{name}.cu").read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        h.update(header.read_bytes())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:12]}.so"


def build(*names: str) -> Dict[str, str]:
    """Compile each ``csrc/<name>.cu`` that is not built already, one
    ``nvcc`` a source, all started together.

    Returns each name's compiler output (ptxas register and spill report,
    empty when the library was built already); raises if a build fails.
    """
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name in names:
        lib = library_path(name)
        if lib.exists():
            continue
        tmp = lib.with_suffix(f".{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True), tmp, lib)
    out = {name: "" for name in names}
    failed = []
    for name, (proc, tmp, lib) in procs.items():
        out[name] = proc.communicate()[0]
        if proc.returncode != 0:
            failed.append(f"nvcc failed for {name}:\n{out[name]}")
        else:
            os.replace(tmp, lib)
    if failed:
        raise RuntimeError("\n".join(failed))
    return out


def load(name: str) -> ctypes.CDLL:
    """The built library for ``csrc/<name>.cu`` (built on first use)."""
    if name not in _loaded:
        build(name)
        _loaded[name] = ctypes.CDLL(str(library_path(name)))
    return _loaded[name]


@functools.lru_cache(maxsize=None)
def _sm_count(idx: int) -> int:
    import torch

    return torch.cuda.get_device_properties(idx).multi_processor_count


def sm_count(dev) -> int:
    """The SMs of CUDA device ``dev`` (a ``torch.device``; no index: the
    current device)."""
    import torch

    return _sm_count(dev.index if dev.index is not None else torch.cuda.current_device())


def wrappers(ablation: bool = True) -> tuple:
    """Every kernel wrapper; each counts its launches in ``.launches``.
    Without ``ablation``, those on the model paths only: all but
    ``warp_tiles_variant``."""
    from .ops import bn_act_cuda, gn_act_cuda, grouped_cuda, warp_cuda, warp_views_cuda

    on_paths = (
        warp_cuda.warp_tiles, warp_views_cuda.warp_views_sum,
        grouped_cuda.sample_tiles_grouped, grouped_cuda.scatter_tapdot_grouped,
        grouped_cuda.scatter_taps_grouped, grouped_cuda.taps_dot_grouped,
        bn_act_cuda.bn_act, gn_act_cuda.gn_act,
    )
    return on_paths + ((warp_cuda.warp_tiles_variant,) if ablation else ())


def launch_counts() -> Dict[str, int]:
    """Every kernel wrapper's launch count in this process, by name: the
    launches through the wrappers, in eager calls and at a CUDA graph's
    capture, never on a replay, which runs no Python. A replay's launches
    are read from the device trace, by kernel name (the benchmark's
    ``warp_tiles_roofline`` counts ``tile_kernel`` so). The stage markers
    (``utils/tracing.py``) are not model kernels and are not counted."""
    return {f.__name__: f.launches for f in wrappers()}


def _append_launch_log(path: str) -> None:
    with open(path, "a") as f:
        f.write(json.dumps({"pid": os.getpid(), "argv": sys.argv, "launches": launch_counts()}) + "\n")


if os.environ.get(LAUNCH_LOG_ENV):
    atexit.register(_append_launch_log, os.environ[LAUNCH_LOG_ENV])
