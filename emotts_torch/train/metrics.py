"""Metrics logging: JSONL scalars (TensorBoard too where importable), step
timing, and the profiler capture of one epoch.  Counterpart of
``emotts/train/metrics.py``."""

from __future__ import annotations

import contextlib
import json
import os
import socket
import time
from collections import defaultdict
from pathlib import Path
from typing import Dict, Iterable, Iterator, Optional

import torch

from emotts_torch.utils.trace import all_threads_config, span


class MetricsWriter:
    """Writes every scalar to ``<exp>/metrics.jsonl`` and, where TensorBoard
    is importable, to an event file beside it.

    The event file is written record by record with TensorBoard's own
    record framing and protos: ``torch.utils.tensorboard`` would import
    TensorFlow where it is installed (seconds at every trainer's start) to
    write the same records."""

    def __init__(self, exp_path: str):
        self.exp_path = Path(exp_path)
        self.exp_path.mkdir(parents=True, exist_ok=True)
        self._jsonl = open(self.exp_path / "metrics.jsonl", "a")
        try:
            from tensorboard.compat.proto.event_pb2 import Event
            from tensorboard.compat.proto.summary_pb2 import Summary
            from tensorboard.summary.writer.record_writer import RecordWriter
        except ImportError:  # TensorBoard is optional
            self._tb = None
        else:
            self._event, self._summary = Event, Summary
            name = (f"events.out.tfevents.{int(time.time())}."
                    f"{socket.gethostname()}.{os.getpid()}.0")
            self._tb = RecordWriter(open(self.exp_path / name, "wb"))
            self._tb.write(Event(wall_time=time.time(),
                                 file_version="brain.Event:2").SerializeToString())

    def scalar(self, tag: str, value: float, step: int) -> None:
        if self._tb is not None:
            summary = self._summary(value=[self._summary.Value(
                tag=tag, simple_value=float(value))])
            self._tb.write(self._event(wall_time=time.time(), step=int(step),
                                       summary=summary).SerializeToString())
        self._jsonl.write(json.dumps(
            {"tag": tag, "value": float(value), "step": int(step)}) + "\n")

    def scalars(self, values: Dict[str, float], step: int, prefix: str = "") -> None:
        for k, v in values.items():
            self.scalar(f"{prefix}{k}", float(v), step)
        self._jsonl.flush()
        if self._tb is not None:
            self._tb.flush()

    def close(self) -> None:
        if self._tb is not None:
            self._tb.close()
        self._jsonl.close()


class EpochAverager:
    """Accumulate per-batch loss dicts into epoch means.

    ``weight`` (default 1.0) weights a batch's contribution — eval loops pass
    the batch's valid-row count so that a padded trailing batch does not
    count as much as a full one."""

    def __init__(self):
        self._sums = defaultdict(float)
        self._n = 0.0

    def update(self, values: Dict[str, float], weight: float = 1.0) -> None:
        for k, v in values.items():
            self._sums[k] += float(v) * weight
        self._n += weight

    def means(self) -> Dict[str, float]:
        if self._n == 0:
            return {}
        return {k: v / self._n for k, v in self._sums.items()}


class StepTimer:
    """Rolling step-time meter (skips the first step, which pays for library
    start-up).  ``tick`` waits for the device before it reads the clock:
    PyTorch returns before the device finishes, and an unsynchronised clock
    would time the enqueue.  ``batches`` sums the host time each step waited
    for its batch into ``loader_wait_s``."""

    def __init__(self, device=None):
        self._cuda = device is not None and torch.device(device).type == "cuda"
        self._device = device
        self._t0: Optional[float] = None
        self._times = []
        self.loader_wait_s = 0.0

    def batches(self, batches: Iterable) -> Iterator:
        """The items of ``batches``, each wait for the next one timed (and
        inside a ``loader.wait`` span)."""
        it = iter(batches)
        while True:
            t0 = time.perf_counter()
            with span("loader.wait"):
                batch = next(it, None)
            self.loader_wait_s += time.perf_counter() - t0
            if batch is None:
                return
            yield batch

    def tick(self) -> None:
        if self._cuda:
            torch.cuda.synchronize(self._device)
        now = time.perf_counter()
        if self._t0 is not None:
            self._times.append(now - self._t0)
        self._t0 = now

    def mean_step_time(self, skip: int = 1) -> Optional[float]:
        xs = self._times[skip:]
        return sum(xs) / len(xs) if xs else None


@contextlib.contextmanager
def profile_trace(out_dir: str, device):
    """``torch.profiler`` over the block (host activity and, on a CUDA
    device, the card's kernels), its Chrome trace written to
    ``<out_dir>/trace.json``: the counterpart of the reference's
    ``jax.profiler.trace(<exp>/profile)`` around ``profile_epoch``.  Every
    thread is recorded where the installed torch can (the loader's prefetch
    thread and its ``loader.build`` spans too), the profile's own elsewhere."""
    from torch.profiler import ProfilerActivity, profile

    cuda = torch.device(device).type == "cuda"
    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    os.makedirs(out_dir, exist_ok=True)
    with profile(activities=activities,
                 experimental_config=all_threads_config()) as prof:
        yield
        if cuda:
            torch.cuda.synchronize(device)
    prof.export_chrome_trace(os.path.join(out_dir, "trace.json"))
