"""Host input pipeline: threaded decode, then page-locked, non_blocking
copies to the GPU. The port's own copy of ``vsta_tpu/data/pipeline.py``.

A thread pool decodes the views of upcoming samples while the card
computes, and :class:`Prefetcher` keeps ``prefetch`` batches in flight.
Its producer thread collates each batch and puts it on the device through
:class:`DevicePut`: every leaf is staged in pinned host memory (PyTorch's
caching host allocator, which reuses a block only after the copies that
read it have completed, so no pinned memory is freed per batch) and copied
``non_blocking`` on a side CUDA stream that the producer thread enters
itself. The batch carries the copy's event; the consumer's stream waits on
it before the batch is used, and every tensor is marked with
``record_stream`` for the consumer's stream so that the caching allocator
does not hand its memory out early.
"""

from __future__ import annotations

import contextlib
import queue
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from typing import Any, Callable, Dict, Iterator, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..utils.platform import resolve_device
from .wildtrack import collate

Batch = Dict[str, Any]
# leaves below 1 MB are copied whole even with h2d_streams > 1
CHUNK_MIN_BYTES = 1 << 20


def split_train_val(n_total: int, seed: int = 0) -> Tuple[List[int], List[int]]:
    """Wildtrack protocol: fixed 400/100 when >= 500 frames, else random
    80/20 with at least one frame held out from two frames on."""
    if n_total >= 500:
        return list(range(0, 400)), list(range(400, 500))
    rng = np.random.default_rng(seed)
    perm = rng.permutation(n_total)
    n_val = int(n_total * 0.2)
    if n_val == 0 and n_total >= 2:
        # int(4 * 0.2) = 0 would leave an empty val split, whose eval
        # scores nothing; hold out one frame instead
        print(
            f"[split] {n_total} frames is too few for a 20% val split; "
            "holding out 1 frame"
        )
        n_val = 1
    n_train = n_total - n_val
    return perm[:n_train].tolist(), perm[n_train:].tolist()


def multi_clip_plan(
    indices: Sequence[int], n_clips: int
) -> List[Tuple[List[int], int]]:
    """Batch plan for batched multi-clip inference.

    Splits ``indices`` into ``n_clips`` contiguous temporal windows and
    emits one batch per time step whose row c is clip c's t-th frame.
    Remainder frames go to the first clips, so exhausted clips are always
    a row suffix and the Prefetcher's prefix ``batch_mask`` applies.
    """
    idx = list(indices)
    n = len(idx)
    if n_clips < 1 or n_clips > n:
        raise ValueError(f"need 1 <= clips <= {n} frames, got {n_clips}")
    base, rem = divmod(n, n_clips)
    clips, start = [], 0
    for c in range(n_clips):
        length = base + (1 if c < rem else 0)
        clips.append(idx[start : start + length])
        start += length
    plan = []
    for t in range(len(clips[0])):
        n_real = sum(1 for cl in clips if t < len(cl))
        chunk = [cl[t] if t < len(cl) else cl[-1] for cl in clips]
        plan.append((chunk, n_real))
    return plan


def piece_bounds(n: int, pieces: int) -> List[Tuple[int, int]]:
    """[start, stop) of ``np.array_split``'s pieces of n elements."""
    base, rem = divmod(n, pieces)
    out, a = [], 0
    for i in range(pieces):
        b = a + base + (1 if i < rem else 0)
        out.append((a, b))
        a = b
    return out


class DevicePut:
    """Puts a collated numpy batch on ``device``.

    On the CPU a leaf is ``torch.from_numpy``. On a CUDA device each leaf
    is pinned and copied ``non_blocking`` on side streams; the call must
    run on the thread that issues the copies, and returns the batch with
    the event its copies end at. With ``h2d_streams`` > 1 a leaf of 1 MB
    or more is split into that many pieces, each copied on its own stream
    into its slice of one device tensor (the join is in place on the
    device); the batches are identical either way.
    """

    def __init__(self, device: str | torch.device, h2d_streams: int = 1):
        self.device = resolve_device(device)
        self.h2d_streams = max(1, int(h2d_streams))
        self._streams: Optional[List[torch.cuda.Stream]] = None

    @property
    def cuda(self) -> bool:
        return self.device.type == "cuda"

    def streams(self) -> List["torch.cuda.Stream"]:
        if self._streams is None:
            self._streams = [torch.cuda.Stream(self.device) for _ in range(self.h2d_streams)]
        return self._streams

    def __call__(
        self, batch: Dict[str, np.ndarray], consumer: Optional["torch.cuda.Stream"] = None
    ) -> Tuple[Dict[str, torch.Tensor], Optional["torch.cuda.Event"]]:
        """The batch on the device and the event its copies end at (None
        on the CPU). ``consumer``: the stream that will use the batch."""
        if not self.cuda:
            return {k: self._leaf(v, None, None) for k, v in batch.items()}, None
        streams = self.streams()
        with torch.cuda.stream(streams[0]):
            out = {k: self._leaf(v, streams, consumer) for k, v in batch.items()}
            event = streams[0].record_event()
        return out, event

    def _leaf(self, arr: np.ndarray, streams, consumer) -> torch.Tensor:
        src = torch.from_numpy(np.ascontiguousarray(arr))
        if self.cuda:
            src = src.pin_memory()
        n = src.numel()
        pieces = piece_bounds(n, self.h2d_streams) if src.nbytes >= CHUNK_MIN_BYTES else [(0, n)]
        if len(pieces) == 1:
            if not self.cuda:
                return src
            dst = src.to(self.device, non_blocking=True)
        else:
            dst = torch.empty(src.shape, dtype=src.dtype, device=self.device)
            flat_src, flat_dst = src.view(-1), dst.view(-1)
            for (a, b), s in zip(pieces, streams or [None] * len(pieces)):
                ctx = contextlib.nullcontext() if s is None else torch.cuda.stream(s)
                if s is not None and s is not streams[0]:
                    s.wait_stream(streams[0])  # dst's memory may be in use there until now
                    dst.record_stream(s)
                with ctx:
                    flat_dst[a:b].copy_(flat_src[a:b], non_blocking=self.cuda)
            for s in streams or []:
                if s is not streams[0]:
                    streams[0].wait_stream(s)
        if consumer is not None:
            dst.record_stream(consumer)
        return dst


class _ProducerError:
    """Queue envelope carrying a producer-thread exception to the consumer."""

    def __init__(self, exc: BaseException):
        self.exc = exc


class Prefetcher:
    """Iterate batches of a dataset with background decoding.

    dataset: indexable returning sample dicts (numpy).
    indices: subset to iterate; shuffled by ``seed + epoch`` when shuffle.
    device: None yields numpy batches; ``"cpu"`` or a CUDA device yields
    tensors there (a CUDA device must exist). Every batch has
    ``batch_mask`` [B] bool: the last batch is right-padded by repeating its
    last sample unless ``drop_last``. ``plan``: explicit (chunk, n_real)
    batches (``multi_clip_plan``). ``shard``: takes each collated host
    batch to this rank's part before the copy (``Mesh.slice_batch``: every
    rank reads the same batch and keeps its slice). ``wait_s`` is the time the consumer
    spent waiting on the queue in the latest pass, over ``n_yielded``
    batches.
    """

    def __init__(
        self,
        dataset,
        indices: Sequence[int],
        batch_size: int,
        *,
        shuffle: bool = False,
        num_workers: int = 4,
        prefetch: int = 2,
        seed: int = 0,
        drop_last: bool = False,
        device: Optional[str | torch.device] = None,
        plan: Optional[List[Tuple[List[int], int]]] = None,
        h2d_streams: int = 1,
        shard: Optional[Callable[[Batch], Batch]] = None,
    ):
        self.dataset = dataset
        self.indices = list(indices)
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.num_workers = max(1, num_workers)
        self.prefetch = max(1, prefetch)
        self.seed = seed
        self.drop_last = drop_last
        self.put = None if device is None else DevicePut(device, h2d_streams)
        self.shard = shard
        self._epoch = 0
        self.wait_s = 0.0
        self.n_yielded = 0
        # explicit (chunk, n_real) batches override the flat split (e.g.
        # multi_clip_plan); incompatible with shuffle by construction
        self.plan = plan
        if plan is not None:
            if shuffle:
                raise ValueError("an explicit batch plan cannot be shuffled")
            if not all(len(c) == batch_size for c, _ in plan):
                raise ValueError("every plan chunk must match batch_size")

    def __len__(self) -> int:
        if self.plan is not None:
            return len(self.plan)
        n = len(self.indices)
        if self.drop_last:
            return n // self.batch_size
        return (n + self.batch_size - 1) // self.batch_size

    def _batches(self) -> List[Tuple[List[int], int]]:
        if self.plan is not None:
            return list(self.plan)
        order = list(self.indices)
        if self.shuffle:
            rng = np.random.default_rng(self.seed + self._epoch)
            order = [order[i] for i in rng.permutation(len(order))]
        out = []
        for i in range(0, len(order), self.batch_size):
            chunk = order[i : i + self.batch_size]
            if len(chunk) < self.batch_size:
                if self.drop_last:
                    continue
                # static shapes: right-pad the final batch by repeating its
                # last sample; consumers use 'batch_mask' to ignore padding
                chunk = chunk + [chunk[-1]] * (self.batch_size - len(chunk))
                out.append((chunk, len(order) - i))
                continue
            out.append((chunk, len(chunk)))
        return out

    def __iter__(self) -> Iterator[Batch]:
        batches = self._batches()
        if hasattr(self.dataset, "set_epoch"):
            # advances the dataset's per-(epoch, frame) jitter derivation
            self.dataset.set_epoch(self._epoch)
        self._epoch += 1
        self.wait_s, self.n_yielded = 0.0, 0
        q: "queue.Queue" = queue.Queue(maxsize=self.prefetch)
        stop = threading.Event()
        put, shard = self.put, self.shard
        consumer = torch.cuda.current_stream(put.device) if put is not None and put.cuda else None

        def _put(item) -> bool:
            # never block forever: the consumer may break out mid-epoch
            # leaving the queue full; re-check `stop` between bounded put
            # attempts so the thread exits promptly
            while not stop.is_set():
                try:
                    q.put(item, timeout=0.1)
                    return True
                except queue.Full:
                    continue
            return False

        def producer():
            # any raise here (a bad image, a failed copy, ...) must reach
            # the consumer, or __iter__ would wait in q.get() forever
            try:
                with ThreadPoolExecutor(self.num_workers) as pool:
                    for chunk, n_real in batches:
                        if stop.is_set():
                            return
                        samples = list(pool.map(self.dataset.__getitem__, chunk))
                        batch = collate(samples)
                        mask = np.zeros(len(chunk), bool)
                        mask[:n_real] = True
                        batch["batch_mask"] = mask
                        if shard is not None:
                            batch = shard(batch)
                        item = (batch, None) if put is None else put(batch, consumer)
                        if not _put(item):
                            return
            except BaseException as e:  # noqa: BLE001 - forwarded, not hidden
                _put(_ProducerError(e))
                return
            _put(None)

        t = threading.Thread(target=producer, daemon=True)
        t.start()
        self._last_producer = t  # exposed for tests/diagnostics
        try:
            while True:
                t0 = time.perf_counter()
                item = q.get()
                self.wait_s += time.perf_counter() - t0
                if item is None:
                    return
                if isinstance(item, _ProducerError):
                    raise RuntimeError("Prefetcher producer thread failed") from item.exc
                batch, event = item
                if event is not None:
                    consumer.wait_event(event)
                self.n_yielded += 1
                yield batch
        finally:
            stop.set()
            # drain anything still queued so a blocked _put wakes up
            try:
                while True:
                    q.get_nowait()
            except queue.Empty:
                pass
