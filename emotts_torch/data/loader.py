"""Bucketed, prefetching batch loader (numpy only).

Own copy of ``emotts/data/loader.py``: examples are grouped by length
bucket so that every batch has one of a small, fixed set of shapes, shuffling
is seeded per epoch, and a background thread keeps a prefetch queue full so
that host collation overlaps device compute.  The same seed gives the same
plan as the reference's loader.  Under data parallelism over processes every
process plans the same epoch and loads only its contiguous rows of each
global batch.
"""

from __future__ import annotations

import queue
import threading
import time
from typing import Callable, Dict, Iterator, List, Optional, Sequence

import numpy as np

from emotts_torch.utils.trace import span


class BucketLoader:
    """Iterates fixed-shape batches grouped by length bucket.

    Args:
      dataset: indexable with __len__, __getitem__, and length_of(idx).
      buckets: ascending length buckets; examples longer than the largest
        are dropped (drop_overflow) or clamped into it.
      batch_size: examples per batch.
      collate: fn(examples, bucket) -> batch dict.
      shuffle: reshuffle example order each epoch (seeded).
      drop_last: drop trailing partial batches.
      pad_to_multiple: pad trailing partial batches (drop_last=False) to a
        multiple of this by cyclically repeating examples; the repeated rows
        are flagged 0.0 in the batch's ``row_valid``.
      process_index, process_count: this process's place on the data axis
        (``Mesh.rank``, ``Mesh.data``).  With more than one process only
        full batches are kept, and each process loads its contiguous
        ``batch_size / process_count`` rows of every global batch, with the
        ``row_valid`` slice beside them.
      batch_shape: fn(global batch indices) -> extra keyword arguments of
        ``collate`` decided on the full global batch, as the frame bucket is
        (e.g. the FastSpeech2 phone bucket), so that every process collates
        the same shapes.

    ``stats`` counts the batches built and the seconds spent building them
    (file reads and collation, on the prefetch thread: the span
    ``loader.build``); the trainers log its growth over each epoch.
    """

    def __init__(
        self,
        dataset,
        buckets: Sequence[int],
        batch_size: int,
        collate: Callable,
        shuffle: bool = True,
        seed: int = 0,
        drop_last: bool = True,
        drop_overflow: bool = True,
        prefetch: int = 2,
        pad_to_multiple: int = 1,
        process_index: int = 0,
        process_count: int = 1,
        batch_shape: Optional[Callable[[List[int]], dict]] = None,
    ):
        self.dataset = dataset
        self.buckets = sorted(buckets)
        self.batch_size = batch_size
        self.collate = collate
        self.shuffle = shuffle
        self.seed = seed
        self.drop_last = drop_last
        self.drop_overflow = drop_overflow
        self.prefetch = prefetch
        self.pad_to_multiple = max(1, pad_to_multiple)
        if self.pad_to_multiple > 1 and batch_size % self.pad_to_multiple:
            raise ValueError(
                f"batch_size {batch_size} must be a multiple of "
                f"pad_to_multiple {self.pad_to_multiple}")
        if not 0 <= process_index < process_count:
            raise ValueError(f"process_index {process_index} is not in "
                             f"[0, {process_count})")
        if batch_size % process_count:
            raise ValueError(f"batch_size {batch_size} must divide evenly "
                             f"across {process_count} processes")
        self.process_index = process_index
        self.process_count = process_count
        self.batch_shape = batch_shape
        self._lengths: Optional[List[int]] = None
        self.stats = {"batches": 0, "build_s": 0.0}
        self._stats_lock = threading.Lock()  # two epochs' threads may overlap

    def _bucket_of(self, length: int) -> int:
        for b in self.buckets:
            if length <= b:
                return b
        return -1 if self.drop_overflow else self.buckets[-1]

    def _ensure_lengths(self):
        if self._lengths is None:
            self._lengths = [self.dataset.length_of(i) for i in range(len(self.dataset))]

    def plan_epoch(self, epoch: int) -> List[List[int]]:
        """Deterministic batch plan: shuffle, group by bucket, chunk."""
        self._ensure_lengths()
        n = len(self.dataset)
        order = np.arange(n)
        if self.shuffle:
            rng = np.random.default_rng(self.seed + epoch)
            rng.shuffle(order)
        groups: Dict[int, List[int]] = {}
        for idx in order:
            b = self._bucket_of(self._lengths[idx])
            if b < 0:
                continue
            groups.setdefault(b, []).append(int(idx))
        batches: List[List[int]] = []
        for b, idxs in groups.items():
            for i in range(0, len(idxs), self.batch_size):
                chunk = idxs[i : i + self.batch_size]
                if len(chunk) < self.batch_size and self.drop_last:
                    continue
                m = self.pad_to_multiple
                if len(chunk) < self.batch_size and len(chunk) % m:
                    need = -(-len(chunk) // m) * m - len(chunk)
                    chunk = chunk + [chunk[j % len(chunk)] for j in range(need)]
                batches.append(chunk)
        if self.shuffle:
            rng = np.random.default_rng(self.seed * 7919 + epoch)
            rng.shuffle(batches)
        if self.process_count > 1:
            # every process keeps the SAME batch list (lockstep steps and
            # identical bucket shapes); only full batches split into rows
            batches = [b for b in batches if len(b) == self.batch_size]
        return batches

    def batches_per_epoch(self, epoch: int = 0) -> int:
        return len(self.plan_epoch(epoch))

    def _make_batch(self, idxs: List[int]):
        t0 = time.perf_counter()
        with span("loader.build"):
            self._ensure_lengths()
            # shapes are decided on the FULL (global) batch so that every
            # process collates the same ones, THEN this process loads its rows
            bucket = self._bucket_of(max(self._lengths[i] for i in idxs))
            extra = self.batch_shape(idxs) if self.batch_shape is not None else {}
            # pre-pad chunks hold unique indices (a shuffled permutation slice);
            # pad_to_multiple appends cyclic duplicates at the END, so the valid
            # prefix length is exactly the unique-index count
            n_valid = len(set(idxs))
            row_valid = np.zeros(len(idxs), dtype=np.float32)
            row_valid[:n_valid] = 1.0
            if self.process_count > 1:
                per = len(idxs) // self.process_count
                lo = self.process_index * per
                idxs = idxs[lo : lo + per]
                row_valid = row_valid[lo : lo + per]
            batch = self.collate([self.dataset[i] for i in idxs], bucket, **extra)
            batch["row_valid"] = row_valid
        with self._stats_lock:
            self.stats["batches"] += 1
            self.stats["build_s"] += time.perf_counter() - t0
        return batch

    def epoch(self, epoch: int = 0) -> Iterator[Dict[str, np.ndarray]]:
        """Yield collated batches with background prefetch."""
        plan = self.plan_epoch(epoch)
        if not plan:
            return
        q: "queue.Queue" = queue.Queue(maxsize=self.prefetch)
        sentinel = object()
        error_holder = {}

        def producer():
            try:
                for idxs in plan:
                    q.put(self._make_batch(idxs))
            except Exception as e:  # surfaced in the consumer
                error_holder["error"] = e
            finally:
                q.put(sentinel)

        thread = threading.Thread(target=producer, daemon=True)
        thread.start()
        while True:
            item = q.get()
            if item is sentinel:
                break
            yield item
        thread.join()
        if "error" in error_holder:
            raise error_holder["error"]
