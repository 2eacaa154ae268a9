"""Open loop: requests arrive on a schedule drawn from the seed, each on
its own client thread calling ``TTSService.synthesize``, and each is timed
from when it was due to when its waveform came back, so a stall counts
against every request it delays.  The window holds the requests due in
``[0, seconds)``; after its close the harness waits up to ``wait_s`` for
the last ones.  A request that fails or never returns counts as missing:
its latency is the whole wait.

Mix parameters: ``rate_per_s``; ``arrivals`` "poisson" (exponential gaps)
or "onoff" (Poisson at ``rate_per_s · period_s / on_s`` during the first
``on_s`` of every ``period_s``, nothing in the rest: the same mean rate);
``arrival_seed`` the stream the due times are drawn from (the same for
every run: the tail of an open loop follows the arrivals' order more
than anything the seed draws); ``window_ms`` the micro-batcher's
collection window; ``sentence`` (see
``harness/sentences.py``); ``warm_s`` seconds of set-up traffic from a
stream of its own; ``vocode_max_rows`` / ``fs2_rows`` the row counts warmed beside it
(every vocoder chunk, and FastSpeech2 at a spread of batch sizes); ``sample`` requests compared; ``traced`` [start, end) seconds of the
window under the profiler; ``wait_s`` how long the window's close waits."""

from __future__ import annotations

import threading
import time

import numpy as np

from harness.sentences import Sentences
from harness.stats import percentile


def _bank(c):
    return c["bank"]["speakers"], c["bank"]["emotions"], c["bank"]["levels"]


def schedule(mix: dict, rng: np.random.Generator, seconds: float) -> np.ndarray:
    """Due times in [0, seconds): the n = rate·seconds gaps are the
    exponential distribution's quantiles at (i + ½) / n, scaled to sum to
    the window, in an order drawn from the seed (every seed offers the
    same load in another order).  "onoff" lays the same gaps over the
    "on" part of each period."""
    rate = float(mix["rate_per_s"])
    n = max(1, int(round(rate * seconds)))
    gaps = -np.log1p(-(np.arange(n) + 0.5) / n)
    if mix.get("arrivals", "poisson") == "poisson":
        span = seconds
    else:
        period, on = float(mix["period_s"]), float(mix["on_s"])
        span = seconds * on / period
    gaps = rng.permutation(gaps * (span / gaps.sum()))
    due = np.concatenate([[0.0], np.cumsum(gaps)[:-1]])
    if mix.get("arrivals", "poisson") != "poisson":
        due = (due // on) * period + due % on
    return due


def plan(cell, seed: int, seconds: float, registry: dict):
    """The window's requests with their due times, and its sample.  The
    due times are the mix's own (drawn from its ``arrival_seed``): every
    seed offers the same arrivals, and orders other sentences, speakers,
    emotions and levels into them."""
    stream = Sentences(cell.mix, np.random.default_rng([seed, 1]), registry, _bank(cell.config))
    due = schedule(cell.mix, np.random.default_rng(cell.mix["arrival_seed"]), seconds)
    requests = stream.requests(len(due))
    pick = np.random.default_rng([seed, 3]).choice(
        len(requests), size=min(cell.mix["sample"], len(requests)), replace=False)
    return requests, due, [requests[i] for i in pick]


class Clients:
    """Starts each request's thread at its due time and records when it
    started and ended and whether it failed; opens and closes the traced
    stretch at its times."""

    def __init__(self, service, requests, due, stretch=None, traced=None, served=None):
        n = len(requests)
        self.started, self.done = np.full(n, np.nan), np.full(n, np.nan)
        self.failed = np.zeros(n, bool)
        self.service, self.requests, self.due = service, requests, due
        self.stretch, self.traced, self.served = stretch, traced, served
        self.threads = []
        self.t0 = None

    def _client(self, i, body):
        try:
            self.service.synthesize(body)
            self.done[i] = time.perf_counter()
        except Exception:  # noqa: BLE001 - a failed request counts as missing
            self.failed[i] = True

    def _trace(self, now):
        st = self.stretch
        if st is None:
            return
        if not st.active and not st.done and now >= self.traced[0]:
            st.start()
            self.served.trace(True)
        elif st.active and now >= self.traced[1]:
            self.served.trace(False)
            st.stop()

    def run(self) -> None:
        self.t0 = time.perf_counter()
        for i, (q, d) in enumerate(zip(self.requests, self.due)):
            self._trace(time.perf_counter() - self.t0)
            wait = self.t0 + d - time.perf_counter()
            if wait > 0:
                time.sleep(wait)
            th = threading.Thread(target=self._client, args=(i, q.body()), daemon=True)
            self.started[i] = time.perf_counter()
            th.start()
            self.threads.append(th)
        if self.stretch is not None and self.stretch.active:
            self.served.trace(False)
            self.stretch.stop()

    def join(self, wait_s: float) -> float:
        """Wait for every request, at most ``wait_s`` past the window's
        close; returns the deadline."""
        deadline = max(time.perf_counter(), self.t0 + (self.due[-1] if len(self.due) else 0)) + wait_s
        for th in self.threads:
            th.join(max(0.0, deadline - time.perf_counter()))
        return deadline


def drive(service, requests, due, wait_s, stretch=None, traced=None, served=None):
    clients = Clients(service, requests, due, stretch, traced, served)
    clients.run()
    deadline = clients.join(wait_s)
    end = np.nanmax(clients.done) if np.isfinite(clients.done).any() else deadline
    missing = np.isnan(clients.done) | clients.failed
    latency = np.where(missing, deadline, clients.done) - (clients.t0 + due)
    lag = clients.started - (clients.t0 + due)
    return latency, missing, lag, max(end, clients.started[-1]) - clients.t0, clients.t0


def run(cell, seed: int, seconds: float, stretch, device):
    mix, c = cell.mix, cell.config
    t_build = time.perf_counter()
    served = cell.model().Served(c, seed, device, {})
    t_warm = time.perf_counter()
    service = served.service(mix["window_ms"])
    warm = Sentences(mix, np.random.default_rng([seed, 2]), served.registry, _bank(c))
    warm_due = schedule(mix, np.random.default_rng([mix["arrival_seed"], 1]), mix["warm_s"])
    drive(service, warm.requests(len(warm_due)), warm_due, mix["wait_s"])
    served.warm(mix["vocode_max_rows"], mix["fs2_rows"])
    served.reset()
    requests, due, sample = plan(cell, seed, seconds, served.registry)
    served.want = {q.id for q in sample}
    latency, missing, lag, wall, t0 = drive(service, requests, due, mix["wait_s"], stretch,
                                        mix["traced"], served)
    compare = [q for q, m in zip(requests, missing) if q.id in served.want and not m]
    if served.longest is not None and served.longest.id not in served.want:
        compare.append(served.longest)
    return {"system": served, "t0": t0, "wall_s": wall, "attempted": len(requests),
            "failed": int(missing.sum()), "compare": compare,
            "metrics": {"request_p95_ms": 1e3 * percentile(latency.tolist(), 95)},
            "notes": {"requests": len(requests), "rate_per_s": mix["rate_per_s"],
                      "latency_p50_ms": 1e3 * float(np.median(latency)),
                      "lag_p50_ms": 1e3 * float(np.median(lag)),
                      "lag_p95_ms": 1e3 * percentile(lag.tolist(), 95),
                      "lag_max_ms": 1e3 * float(lag.max()),
                      "p99_ms": 1e3 * percentile(latency.tolist(), 99),
                      "max_ms": 1e3 * float(latency.max()),
                      "p95_by_tenth_ms": [1e3 * percentile(x.tolist(), 95)
                                          for x in np.array_split(latency, 10)],
                      "p50_first_third_ms": 1e3 * float(np.median(latency[:len(latency) // 3])),
                      "p50_last_third_ms": 1e3 * float(np.median(latency[-(len(latency) // 3):])),
                      "dispatches": served.engine_calls, "build_s": t_warm - t_build,
                      "warm_s": t0 - t_warm}}


def control_requests(cell, seed: int, seconds: float):
    requests, _, sample = plan(cell, seed, seconds, {})
    longest = max(requests, key=lambda q: q.phones)
    return sample + ([] if longest in sample else [longest])
