"""Rates are taken over the whole window and the tail over all requests,
a stall included: checked on a synthetic window."""

import threading
import time

import numpy as np

from harness.sentences import Request
from harness.spec import ROOT, load_module
from harness.stats import percentile

open_loop = load_module(ROOT / "traffic" / "open_loop.py")


def test_a_rate_is_all_the_work_over_all_the_window(monkeypatch):
    """A closed-loop window with one call stalled: the rate counts every
    call's audio over the time from the first call's start to the last
    call's end, the stall included."""
    import torch

    import run
    import tiny
    from emotts_torch.infer.synthesize import Synthesizer

    orig, calls = Synthesizer.synthesize_requests, []

    def stalled(self, requests, **kw):
        calls.append(1)
        if len(calls) == 3:
            time.sleep(0.5)
        return orig(self, requests, **kw)
    monkeypatch.setattr(Synthesizer, "synthesize_requests", stalled)
    args = run.parse(["--workload", "fs2v1.batch", "--seed", "7", "--seconds", "1.0"])
    result, info = run.measure(args, tiny.cell("fs2v1.batch"), torch, device="cpu")
    window = info["window"]
    assert window["wall_s"] >= 1.0
    rate = result["metrics"]["audio_s_per_s"]["value"]
    assert abs(rate - window["notes"]["audio_s"] / window["wall_s"]) < 1e-9


def test_percentile_is_nearest_rank_over_every_value():
    values = list(range(1, 101))
    assert percentile(values, 95) == 95
    assert percentile([5.0] * 94 + [100.0] * 6, 95) == 100.0


class StallingService:
    """Answers at once, except one stall that every request queued behind
    it waits out, as a device lock would make them."""

    def __init__(self, stall_at: int, stall_s: float):
        self.lock, self.n, self.stall_at, self.stall_s = threading.Lock(), 0, stall_at, stall_s

    def synthesize(self, body):
        with self.lock:
            self.n += 1
            if self.n == self.stall_at:
                time.sleep(self.stall_s)


def test_a_stall_counts_against_the_requests_it_delays():
    due = np.arange(40) * 0.01  # 100 requests a second for 0.4 s
    reqs = [Request(i, f"r{i}", 0, 0, 0, 3) for i in range(40)]
    latency, missing, lag, wall, _ = open_loop.drive(StallingService(10, 0.25), reqs, due, 5.0)
    assert not missing.any() and wall >= 0.39
    # the requests due during the stall wait for it, timed from their due time
    assert (latency[10:30] > 0.05).sum() >= 15
    assert percentile(latency.tolist(), 95) >= 0.15
    # the generator itself kept to the schedule
    assert np.nanmax(lag) < 0.1


def test_a_request_that_never_returns_counts_as_missing():
    class Failing:
        def synthesize(self, body):
            if body["text"] == "r3":
                raise RuntimeError("lost")

    due = np.arange(5) * 0.01
    reqs = [Request(i, f"r{i}", 0, 0, 0, 3) for i in range(5)]
    latency, missing, _, _, _ = open_loop.drive(Failing(), reqs, due, 0.2)
    assert missing.tolist() == [False, False, False, True, False]
    assert latency[3] == latency.max() >= 0.2


def test_schedule_offers_every_seed_the_same_gaps():
    mix = {"rate_per_s": 50.0}
    a = open_loop.schedule(mix, np.random.default_rng(1), 10.0)
    b = open_loop.schedule(mix, np.random.default_rng(2), 10.0)
    assert len(a) == len(b) == 500 and a[0] == b[0] == 0.0 and (a < 10).all()
    assert np.allclose(np.sort(np.diff(a)[:-1]).sum(), np.sort(np.diff(b)[:-1]).sum(), atol=0.2)
    assert not np.allclose(a, b)
    burst = open_loop.schedule({"rate_per_s": 50.0, "arrivals": "onoff", "period_s": 2.0,
                                "on_s": 0.5}, np.random.default_rng(1), 10.0)
    assert len(burst) == 500 and ((burst % 2.0) < 0.5).all() and burst.max() < 10.0
