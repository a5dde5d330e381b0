"""Parts every driver module shares: the run's outcome, the program's config and
serving artifact, the port's Prefetcher pass after pass, the seeded sample
of requests the comparison reads, and the reference's side of a serving
comparison."""

from __future__ import annotations

import gc
import sys
import tempfile
import time
from dataclasses import dataclass, field
from itertools import islice
from pathlib import Path
from typing import Any, Dict, Iterator, List, Optional, Tuple

import numpy as np
import torch

from ..reference.decode import decode
from ..reference.precision import PRECISIONS
from .cell import Records
from .inputs import order
from .judge import serving_numbers


@dataclass
class Outcome:
    attempted: int
    failed: int
    end_to_end: Dict[str, float]
    records: Records
    memory_peak_bytes: int
    numbers: Dict[str, float] = field(default_factory=dict)


def log_setup(t0: float, marks) -> None:
    """One line on standard error: the set-up's parts, in seconds."""
    parts, t = [], t0
    for name, at in marks:
        parts.append(f"{name} {at - t:.3f}")
        t = at
    print("[setup] " + ", ".join(parts), file=sys.stderr, flush=True)


def program_config(cfg: Dict):
    """The program's Config of the configuration file's ``config``."""
    from vsta_tpu_torch.config import from_dict

    return from_dict(cfg)


def load_artifact(cfg: Dict, weights: Dict[str, torch.Tensor], batch: int, device, workdir: Path):
    """Export, save and load the serving artifact of ``weights`` at
    ``batch``, as a deployment serves it (one CUDA graph a request)."""
    from vsta_tpu_torch.export import export_serving, load_serving, save_exported

    path = workdir / f"model_b{batch}.pt"
    platform = torch.device(device).type
    save_exported(export_serving(program_config(cfg), weights, batch_size=batch, platforms=(platform,)), path)
    return load_serving(path, device=device)


def workdir() -> tempfile.TemporaryDirectory:
    """A directory under TMPDIR for the run's artifact, removed at its end."""
    return tempfile.TemporaryDirectory(prefix="vsta_bench_")


class Feed:
    """The port's ``Prefetcher`` pass after pass, as training makes an
    epoch and ``.serve`` a pass over its frames: each pass is a new
    Prefetcher over the next ``per_pass`` batches' indices of ``order``.
    Yields (the batch's dataset indices, the batch on the device) without
    end; ``wait_s`` and ``n_yielded`` sum the Prefetchers' own counters
    over the passes. ``close()`` stops the producer and waits for it."""

    def __init__(self, ds, batch: int, per_pass: int, seed: int, workers: int, prefetch: int, device):
        from vsta_tpu_torch.data.pipeline import Prefetcher

        self._loader = lambda idx: Prefetcher(ds, idx, batch, num_workers=workers, prefetch=prefetch, device=device)
        self._order, self.batch, self.per_pass = order(len(ds), seed), batch, per_pass
        self._past_wait, self._past_n, self._dl = 0.0, 0, None
        self._gen = self._batches()

    def _batches(self) -> Iterator[Tuple[List[int], Dict[str, torch.Tensor]]]:
        B = self.batch
        while True:
            idx = list(islice(self._order, self.per_pass * B))
            dl = self._dl = self._loader(idx)
            it = iter(dl)
            try:
                for j, batch in enumerate(it):
                    yield idx[j * B:(j + 1) * B], batch
            finally:
                it.close()
                producer = getattr(dl, "_last_producer", None)
                if producer is not None:
                    producer.join(timeout=60)
                self._past_wait, self._past_n, self._dl = self._past_wait + dl.wait_s, self._past_n + dl.n_yielded, None

    def __iter__(self):
        return self

    def __next__(self):
        return next(self._gen)

    def close(self) -> None:
        self._gen.close()

    @property
    def wait_s(self) -> float:
        return self._past_wait + (self._dl.wait_s if self._dl is not None else 0.0)

    @property
    def n_yielded(self) -> int:
        return self._past_n + (self._dl.n_yielded if self._dl is not None else 0)


class Sample:
    """A seeded uniform sample of ``k`` of the requests offered to it
    (reservoir sampling): which ones depends on the seed and the count only."""

    def __init__(self, k: int, seed: int):
        self.k, self.rng, self.seen = k, np.random.default_rng(seed + 4), 0
        self.items: List[Any] = []

    def offer(self, item_fn) -> None:
        """``item_fn()`` makes the item, called only when it is kept."""
        self.seen += 1
        if len(self.items) < self.k:
            self.items.append(item_fn())
            return
        j = int(self.rng.integers(0, self.seen))
        if j < self.k:
            self.items[j] = item_fn()


def sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def memory_peak(device) -> int:
    return torch.cuda.max_memory_allocated(device) if torch.device(device).type == "cuda" else 0


def free_program(device) -> None:
    gc.collect()
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)
        torch.cuda.empty_cache()


def reference_maps(reference, cfg: Dict, weights, batch: Dict[str, np.ndarray], device, precision: str = "exact",
                   block: int = 4) -> Dict[str, torch.Tensor]:
    """The heatmap, offset and size maps of the configuration's
    ``reference`` module for a stacked batch, ``block`` frame sets at a
    time, on the CPU."""
    reference.tf32_off()
    ref = reference.Reference(cfg, weights, PRECISIONS[precision])
    outs: Dict[str, List[torch.Tensor]] = {"heatmap": [], "offset": [], "size": []}
    n = len(batch["images"])
    with torch.no_grad():
        for a in range(0, n, block):
            args = [torch.as_tensor(batch[k][a:a + block], device=device) for k in ("images", "K", "Rt")]
            o = ref(*args)
            for k in outs:
                outs[k].append(o[k].cpu())
    return {k: torch.cat(v) for k, v in outs.items()}


def as_served(cfg: Dict, maps: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """The reference's maps decoded as the program serves them."""
    e, m = cfg["EVAL"], cfg["MODEL"]
    det = decode(maps["heatmap"][..., 0], maps["offset"], maps["size"], bounds=tuple(m["BEV_BOUNDS"]),
                 conf=e["CONF_THRESH"], nms_dist_m=e["NMS_DIST_M"], max_dets=e["MAX_DETS"])
    return {"boxes": det["boxes"], "scores": det["scores"], "valid": det["valid"], "heatmap": maps["heatmap"]}


def judge_serving(reference, cfg: Dict, weights, ds, sample: Sample, device,
                  control: Optional[str] = None) -> Dict[str, float]:
    """The comparison numbers of the sampled requests; each item of the
    sample is (dataset indices, program outputs on the CPU). With
    ``control`` the reference in that precision stands in the program's
    place, and its numbers are returned under ``control.<name>``."""
    t = time.perf_counter()
    prog, refs, ctrl = [], [], []
    for idx, out in sample.items:
        batch = ds.batch(list(idx))
        refs.append(reference_maps(reference, cfg, weights, batch, device))
        prog.append(out)
        if control:
            ctrl.append(as_served(cfg, reference_maps(reference, cfg, weights, batch, device, control)))
    numbers = serving_numbers(prog, refs, cfg)
    if control:
        numbers.update({f"control.{k}": v for k, v in serving_numbers(ctrl, refs, cfg).items()})
    numbers["sampled_requests"] = len(sample.items)
    numbers["reference_s"] = time.perf_counter() - t
    return numbers
