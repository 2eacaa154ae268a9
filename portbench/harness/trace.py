"""The traced stretch of a ``--trace 1`` run: ``torch.profiler`` over the
host and the card for a steady stretch inside the window, read in memory
(no trace file).  The benchmark's own ranges (``record_function`` names
starting ``portbench.``) mark the layers it calls into; a kernel belongs
to the range that was open on the host when it was launched."""

from __future__ import annotations

import bisect
import time
from collections import defaultdict
from typing import Dict, List, Optional, Tuple

PREFIX = "portbench."
SHORT_GAP_S = 10e-6
_LAUNCH = ("cudaLaunchKernel", "cuLaunchKernel", "cudaLaunchCooperativeKernel",
           "cudaMemcpy", "cudaMemset", "cuMemcpy", "cuMemset", "cudaGraphLaunch")


class Range:
    """A host range around a call into a layer, seen by the profiler
    while one runs; free when none does."""

    def __init__(self, name: str):
        import torch

        self._rf = torch.profiler.record_function(PREFIX + name)

    def __enter__(self):
        self._rf.__enter__()
        return self

    def __exit__(self, *exc):
        self._rf.__exit__(*exc)


def _union(intervals: List[Tuple[float, float]]) -> List[Tuple[float, float]]:
    out: List[List[float]] = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return [(s, e) for s, e in out]


class Trace:
    """What a stretch's events reduce to (times in seconds)."""

    def __init__(self, events, window_s: float):
        from torch.autograd import DeviceType

        self.window_s = window_s
        device, launches, host_ranges, host_ops, gpu_ranges = [], {}, defaultdict(list), [], defaultdict(list)
        for e in events:
            s, t = e.time_range.start * 1e-6, e.time_range.end * 1e-6
            if e.device_type == DeviceType.CUDA:
                if getattr(e, "is_user_annotation", False):
                    if e.name.startswith(PREFIX):
                        gpu_ranges[e.name[len(PREFIX):]].append((s, t))
                else:
                    device.append((e.name, s, t, e.id))
            elif e.name.startswith(PREFIX):
                host_ranges[e.name[len(PREFIX):]].append((s, t))
            elif e.name.startswith(_LAUNCH):
                launches[e.id] = s
            elif not getattr(e, "is_async", False):
                host_ops.append((s, t, e.name))
        self.kernels = [(n, s, t, launches.get(i)) for n, s, t, i in device
                        if not n.startswith(("Memcpy", "Memset"))]
        busy = _union([(s, t) for _, s, t, _ in device])
        self.busy_s = sum(t - s for s, t in busy)
        self.launched_share = (sum(1 for k in self.kernels if k[3] is not None)
                               / max(1, len(self.kernels)))
        self._host_ranges = {k: sorted(v) for k, v in host_ranges.items()}
        self._gpu_ranges = {k: sorted(v) for k, v in gpu_ranges.items()}
        self._host_ops = host_ops
        self._busy = busy

    # -- kernels ---------------------------------------------------------
    def kernel_seconds(self, *needles: str) -> float:
        """Device time of the kernels whose names hold any of ``needles``
        (all kernels without needles)."""
        return sum(t - s for n, s, t, _ in self.kernels
                   if not needles or any(x in n for x in needles))

    def kernel_count(self) -> int:
        return len(self.kernels)

    def in_range(self, name: str) -> float:
        """Device time of the kernels launched while the host range
        ``name`` was open (by launch time; by device time inside the
        range's device span where launches were not recorded)."""
        if self.launched_share >= 0.9:
            spans, at = self._host_ranges.get(name, []), 3
        else:
            spans, at = self._gpu_ranges.get(name, []), 1
        starts = [s for s, _ in spans]
        total = 0.0
        for k in self.kernels:
            x = k[at]
            if x is None:
                continue
            i = bisect.bisect_right(starts, x) - 1
            if i >= 0 and x <= spans[i][1]:
                total += k[2] - k[1]
        return total

    def ranges(self, name: str) -> int:
        return len(self._host_ranges.get(name, [])) or len(self._gpu_ranges.get(name, []))

    # -- what the host did while the card waited ----------------------------
    def breakdown(self) -> Dict[str, list]:
        ops: Dict[str, float] = defaultdict(float)
        for n, s, t, _ in self.kernels:
            ops[n[:120]] += t - s
        gaps: Dict[str, float] = defaultdict(float)
        spans = sorted((s, t, n) for n, s, t in (
            [(PREFIX + k, s, t) for k, v in self._host_ranges.items() for s, t in v]
            + [(n, s, t) for s, t, n in self._host_ops]))
        starts = [s for s, _, _ in spans]
        for (_, a), (b, _) in zip(self._busy, self._busy[1:]):
            if b - a < SHORT_GAP_S:
                gaps[f"gaps under {SHORT_GAP_S * 1e6:.0f} us"] += b - a
                continue
            mid = 0.5 * (a + b)
            i = bisect.bisect_right(starts, mid)
            # the innermost span open at the gap's middle started last
            name = next((n for s, t, n in reversed(spans[max(0, i - 200):i]) if t >= mid),
                        "host, no op traced")
            gaps[name[:120]] += b - a
        top = lambda d: [[k, v] for k, v in sorted(d.items(), key=lambda kv: -kv[1])[:10]]
        return {"device_ops": top(ops), "idle_gaps": top(gaps)}


def _sync(torch):
    if torch.cuda.is_available():
        torch.cuda.synchronize()


class Stretch:
    """Start and stop the profiler around part of a window.  ``begin`` /
    ``end`` are host clock readings just outside the profiler's own start
    and stop, so that a window can leave the stretch and its overhead out
    of a rate it reports."""

    def __init__(self):
        self.prof = None
        self.begin = self.end = None
        self._t0 = self._t1 = None
        self.done = False

    @property
    def active(self) -> bool:
        return self.prof is not None and not self.done

    def start(self) -> None:
        import torch
        from torch.profiler import ProfilerActivity, profile

        self.begin = time.perf_counter()
        acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if torch.cuda.is_available() else [])
        self.prof = profile(activities=acts)
        self.prof.__enter__()
        _sync(torch)
        self._t0 = time.perf_counter()

    def stop(self) -> None:
        import torch

        if not self.active:
            return
        _sync(torch)
        self._t1 = time.perf_counter()
        self.prof.__exit__(None, None, None)
        self.done = True
        self.end = time.perf_counter()

    def read(self) -> Optional[Trace]:
        if not self.done:
            return None
        return Trace(self.prof.events(), self._t1 - self._t0)
