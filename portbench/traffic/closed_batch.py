"""Closed loop with one client: back-to-back ``synthesize_requests`` calls,
each one request for every (speaker, emotion, level) of the bank, one
generated sentence a request.  The window runs calls until ``seconds``
have passed; its rate is the delivered audio of every call over the time
from the first call's start to the last call's end.

Mix parameters: ``sentence`` (see ``harness/sentences.py``), ``warm_calls``
calls of set-up traffic from a stream of their own, ``vocode_max_rows`` /
``fs2_rows`` the row counts warmed beside them (every vocoder chunk, and
FastSpeech2 at a spread of batch sizes), ``sample`` requests compared
(drawn from the seed among the calls of the first half of any window),
``traced_calls`` [first, end) calls under the profiler."""

from __future__ import annotations

import time

import numpy as np

from harness.sentences import Sentences


def _bank(c):
    return c["bank"]["speakers"], c["bank"]["emotions"], c["bank"]["levels"]


def plan(cell, seed: int, seconds: float, registry: dict):
    """The window's stream of requests and the ids of its sample."""
    bank = _bank(cell.config)
    stream = Sentences(cell.mix, np.random.default_rng([seed, 1]), registry, bank)
    per_call = bank[0] * bank[1] * bank[2]
    pool = per_call * max(1, int(seconds // 2))
    first = len(registry)
    ids = first + np.random.default_rng([seed, 3]).choice(
        pool, size=min(cell.mix["sample"], pool), replace=False)
    return stream, pool, set(ids.tolist())


def run(cell, seed: int, seconds: float, stretch, device):
    mix, c = cell.mix, cell.config
    sr = c["audio"]["sampling_rate"]
    t_build = time.perf_counter()
    served = cell.model().Served(c, seed, device, {})
    t_warm = time.perf_counter()
    warm_stream = Sentences(mix, np.random.default_rng([seed, 2]), served.registry, _bank(c))
    for _ in range(mix["warm_calls"]):
        served.synth.synthesize_requests([q.body() for q in warm_stream.sweep()])
    served.warm(mix["vocode_max_rows"], mix["fs2_rows"])
    served.reset()
    stream, _, served.want = plan(cell, seed, seconds, served.registry)
    first, end = mix["traced_calls"]
    calls, audio_s = 0, 0.0
    t0 = time.perf_counter()
    while True:
        if stretch is not None and calls == first:
            stretch.start()
            served.trace(True)
        waves = served.synth.synthesize_requests([q.body() for q in stream.sweep()])
        calls += 1
        audio_s += sum(w.shape[0] for w in waves) / sr
        if stretch is not None and stretch.active and calls >= end:
            served.trace(False)
            stretch.stop()
        if time.perf_counter() - t0 >= seconds:
            break
    wall = time.perf_counter() - t0
    if stretch is not None and stretch.active:
        served.trace(False)
        stretch.stop()
    compare = [q for q in served.registry.values() if q.id in served.want]
    if served.longest is not None and served.longest.id not in served.want:
        compare.append(served.longest)
    return {"system": served, "t0": t0, "wall_s": wall, "attempted": calls * len(waves), "failed": 0,
            "compare": compare, "metrics": {"audio_s_per_s": audio_s / wall},
            "notes": {"calls": calls, "audio_s": audio_s, "build_s": t_warm - t_build,
                      "warm_s": t0 - t_warm}}


def control_requests(cell, seed: int, seconds: float):
    """The requests the control answers in the program's place: the same
    sample, and the longest of the calls it is drawn from."""
    registry = {}
    stream, pool, ids = plan(cell, seed, seconds, registry)
    while len(registry) < pool:
        stream.sweep()
    reqs = list(registry.values())
    longest = max(reqs, key=lambda q: q.phones)
    return [q for q in reqs if q.id in ids] + ([] if longest.id in ids else [longest])
