"""Host loader: batching, static-shape collation and the copy to the
device (counterpart of ``dfvod_tpu/data/loader.py``).

A thread prefetches and collates the next batch while the device computes
(or, with ``num_workers`` > 0, a pool of threads builds whole batches, in
order). The JPEG decoder and the resize are C++ called through ctypes,
which releases the GIL, so the threads run beside the train step. With a
``device``, each batch becomes tensors in pinned host memory, copied to the
device with ``non_blocking=True``: the copy overlaps what the device is
still running, as the JAX package's ``device_put`` of the next batch does.

With masks in the samples (``--masks``), a batch holds ``masks`` (B', T,
H, W) uint8 on the batch's canvas.

Clips of (1 + N) frames are split into frame rows, so a batch holds
``batch_size * (1 + num_ref_frames)`` rows, key frame first within each
clip (``util/misc_multi.py:304-340`` of the reference).

Augmentation draws come from ``np.random.default_rng((seed, epoch, rank,
batch_index))``, so batches do not depend on the number of workers and
equal the JAX package's.

With ``pack_s2d`` each batch's canvas is 2x2 space-to-depth packed on the
host (``data/device_pipeline.py::pack_s2d``): the same bytes, (B', H/2,
W/2, 12|16).

Data parallelism: with ``world`` > 1 each process loads its contiguous
shard of the (shuffled) order, padded to a multiple of ``world`` by
wrapping (``shard_indices``, the JAX package's and the reference's
``samplers.py:48-66``). ``batch_size`` is per process, as the reference's
per-GPU batch, and ``len`` counts this rank's batches.
"""
from __future__ import annotations

import os
import queue
import threading
import time
from collections import deque
from concurrent.futures import ThreadPoolExecutor
from typing import Iterator, List

import numpy as np
import torch

from dfvod_tpu_torch.data.device_pipeline import pack_s2d
from dfvod_tpu_torch.data.transforms import bucket_shape, pad_u8

TIMING_KEYS = ("decode", "transform", "collate", "wait")
# the canvas: each side rounded up to a multiple of BUCKET_STEP, at most
# PAD_CAP (the JAX loader's defaults, which no caller changes)
BUCKET_STEP, PAD_CAP = 128, 1344


def shard_indices(n: int, rank: int, world: int, *, shuffle: bool,
                  seed: int, epoch: int) -> np.ndarray:
    """Pad to a multiple of ``world`` by wrapping, then this rank's
    contiguous shard (``samplers.py:48-66`` of the reference)."""
    if shuffle:
        order = np.random.default_rng(seed + epoch).permutation(n)
    else:
        order = np.arange(n)
    num = -(-n // world)
    order = np.concatenate([order, order[: num * world - n]])
    return order[rank * num:(rank + 1) * num]


class Loader:
    """Iterable over batches: image (B', H, W, C) uint8 padded bottom and
    right into one canvas, labels (B', T), boxes (B', T, 4), valid (B', T),
    image_id (B',), size and orig_size (B', 2) as (h, w), where B' =
    batch_size * clip frames. Numpy arrays without a ``device``, tensors on
    it with one.

    ``timings`` adds up, in seconds: ``decode`` (reading the frames and
    their targets), ``transform`` (flip and resize), ``collate`` (the
    canvas and the stacked targets) of every batch built, and ``wait``, the
    time the consumer blocked for the next batch; ``batches`` counts the
    batches built. ``reset_timings()`` sets them to 0."""

    def __init__(self, dataset, transform, *, batch_size: int,
                 max_boxes: int = 64, use_depth: bool = False,
                 shuffle: bool = True, seed: int = 42,
                 rank: int = 0, world: int = 1, drop_last: bool = False,
                 prefetch: int = 2, pack_s2d: bool = False,
                 num_workers: int = 0, device=None):
        if not 0 <= rank < world:
            raise ValueError(f"rank {rank} outside a world of {world}")
        self.dataset = dataset
        self.transform = transform
        self.batch_size = batch_size
        self.max_boxes = max_boxes
        self.use_depth = use_depth
        self.shuffle = shuffle
        self.seed = seed
        self.rank, self.world = rank, world
        self.drop_last = drop_last
        self.prefetch = prefetch
        self.num_workers = num_workers
        self.pack_s2d = pack_s2d
        self.device = torch.device(device) if device is not None else None
        # DFVOD_BUCKET_LADDER="512,896": snap every padded dim up to the
        # nearest rung instead of the BUCKET_STEP multiple (read once, as
        # the JAX package reads it)
        ladder = os.environ.get("DFVOD_BUCKET_LADDER", "")
        self.bucket_ladder = (tuple(sorted(int(v) for v in ladder.split(",")))
                              if ladder else None)
        self.epoch = 0
        self._lock = threading.Lock()
        self.reset_timings()

    def set_epoch(self, epoch: int):
        self.epoch = epoch

    def reset_timings(self):
        with self._lock:
            self.timings = {**{k: 0.0 for k in TIMING_KEYS}, "batches": 0}

    def _add(self, **seconds):
        with self._lock:
            for k, v in seconds.items():
                self.timings[k] += v

    def __len__(self):
        per_rank = -(-len(self.dataset) // self.world)
        if self.drop_last:
            return per_rank // self.batch_size
        return -(-per_rank // self.batch_size)

    def _pad_shape(self, hs: List[int], ws: List[int]):
        if self.bucket_ladder:
            def snap(v):
                return next((s for s in self.bucket_ladder if v <= s), PAD_CAP)
            return snap(max(hs)), snap(max(ws))
        return bucket_shape(max(hs), max(ws), BUCKET_STEP, PAD_CAP)

    def _collate(self, clips: List[List], rng) -> dict:
        t0 = time.perf_counter()
        frames = []
        for clip in clips:
            frames.extend(self.transform(clip, rng))
        t1 = time.perf_counter()
        ph, pw = self._pad_shape([f.rgb.shape[0] for f in frames],
                                 [f.rgb.shape[1] for f in frames])
        canvas = np.zeros((len(frames), ph, pw, 4 if self.use_depth else 3),
                          np.uint8)
        cols = [pad_u8(f, (ph, pw), self.use_depth, self.max_boxes,
                       out_img=canvas[i]) for i, f in enumerate(frames)]
        batch = {k: np.stack([c[k] for c in cols])
                 for k in cols[0] if k != "image"}
        batch["image"] = pack_s2d(canvas) if self.pack_s2d else canvas
        self._add(transform=t1 - t0, collate=time.perf_counter() - t1)
        return batch

    def _batch_chunks(self) -> Iterator[np.ndarray]:
        idx = shard_indices(len(self.dataset), self.rank, self.world,
                            shuffle=self.shuffle, seed=self.seed,
                            epoch=self.epoch)
        for i in range(0, len(idx), self.batch_size):
            chunk = idx[i:i + self.batch_size]
            if self.drop_last and len(chunk) < self.batch_size:
                return
            # pad the last short batch by wrapping (static shapes)
            if len(chunk) < self.batch_size:
                chunk = np.concatenate(
                    [chunk, idx[: self.batch_size - len(chunk)]])
            yield chunk

    def _make_batch(self, batch_index: int, chunk: np.ndarray) -> dict:
        """One batch on the host: numpy, or pinned tensors for a CUDA
        device."""
        rng = np.random.default_rng(
            (self.seed, self.epoch, self.rank, batch_index))
        t0 = time.perf_counter()
        clips = [self.dataset[int(j)] for j in chunk]
        self._add(decode=time.perf_counter() - t0, batches=1)
        batch = self._collate(clips, rng)
        if self.device is None:
            return batch
        batch = {k: torch.from_numpy(v) for k, v in batch.items()}
        if self.device.type == "cuda":
            batch = {k: v.pin_memory() for k, v in batch.items()}
        return batch

    def _to_device(self, batch: dict) -> dict:
        if self.device is None:
            return batch
        return {k: v.to(self.device, non_blocking=True)
                for k, v in batch.items()}

    def first_batch(self) -> dict:
        """The first batch, built synchronously (for shapes and warm-ups:
        ``next(iter(loader))`` would leave a prefetch thread holding
        batches)."""
        chunk = next(self._batch_chunks())
        return self._to_device(self._make_batch(0, chunk))

    def _waited(self, get):
        t0 = time.perf_counter()
        item = get()
        self._add(wait=time.perf_counter() - t0)
        return item

    def _pool_batches(self) -> Iterator[dict]:
        """``num_workers`` > 0: whole batches built in a thread pool, a
        bounded window ahead, yielded in order."""
        window = self.num_workers + self.prefetch
        with ThreadPoolExecutor(max_workers=self.num_workers) as pool:
            pending: deque = deque()
            try:
                for bi, chunk in enumerate(self._batch_chunks()):
                    pending.append(pool.submit(self._make_batch, bi, chunk))
                    if len(pending) >= window:
                        yield self._waited(pending.popleft().result)
                while pending:
                    yield self._waited(pending.popleft().result)
            finally:
                for f in pending:
                    f.cancel()

    def _thread_batches(self) -> Iterator[dict]:
        """One prefetch thread, ``prefetch`` batches ahead; an exception in
        it is raised in the consumer."""
        q: "queue.Queue" = queue.Queue(maxsize=self.prefetch)
        done = object()
        closed = threading.Event()

        def put(item) -> bool:
            while not closed.is_set():
                try:
                    q.put(item, timeout=0.1)
                    return True
                except queue.Full:
                    pass
            return False

        def worker():
            try:
                for bi, chunk in enumerate(self._batch_chunks()):
                    if not put(self._make_batch(bi, chunk)):
                        return
                put(done)
            except BaseException as e:  # noqa: BLE001 - carried to the consumer
                put(e)

        thread = threading.Thread(target=worker, daemon=True)
        thread.start()
        try:
            while True:
                item = self._waited(q.get)
                if item is done:
                    return
                if isinstance(item, BaseException):
                    raise item
                yield item
        finally:
            closed.set()
            thread.join(timeout=60)

    def __iter__(self) -> Iterator[dict]:
        batches = (self._pool_batches() if self.num_workers > 0
                   else self._thread_batches())
        for b in batches:
            yield self._to_device(b)


def to_train_batch(sample: dict) -> dict:
    """A loader batch as the train step and ``evaluate`` take it
    (``dfvod_tpu/cli/main.py::to_batch`` with the device-preprocess keys):
    images uint8, sizes, labels, boxes, valid, orig_size, image_id, and
    masks when the batch has them (``--masks``)."""
    batch = {"images": sample["image"], "sizes": sample["size"],
             "labels": sample["labels"], "boxes": sample["boxes"],
             "valid": sample["valid"], "orig_size": sample["orig_size"],
             "image_id": sample["image_id"]}
    if "masks" in sample:
        batch["masks"] = sample["masks"]
    return batch
