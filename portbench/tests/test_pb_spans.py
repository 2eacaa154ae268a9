"""The readers of the program's spans (``layer_metrics/_spans.py``) on a
stand-in for ``harness.trace.Trace`` with hand-placed host spans and busy
intervals, and on the trace of a whole traced run on the CPU."""

from types import SimpleNamespace

import pytest

from harness import spec

P = "emotts_torch."
# the card busy over [0, 1], [2, 3], [5, 6], [8, 9]: idle (1, 2), (3, 5), (6, 8)
BUSY = [(0.0, 1.0), (2.0, 3.0), (5.0, 6.0), (8.0, 9.0)]
HOST_OPS = [
    (0.0, 10.0, P + "engine.call"),
    (0.5, 2.5, P + "engine.text"),  # idle (1, 2) inside: 1 s
    (3.5, 4.0, P + "engine.condition"),
    (3.8, 4.5, P + "engine.pcm"),  # with condition, [3.5, 4.5]: 1 s, all idle
    (5.0, 7.0, P + "engine.fs2"),  # not a host phase of the engine
    (6.0, 6.5, "aten::add"),
    (7.0, 9.5, P + "engine.assemble"),  # idle (6, 8) inside: 1 s of 2.5
]
# per engine call, two calls: text 2 s, condition + pcm + assemble 1 + 2.5 s,
# idle inside the four 1 + 1 + 1 s
WANT = {"text_ms": 1000.0, "engine_host_ms": 1750.0, "host_idle_ms": 1500.0}


def ctx(host_ops, calls=2, busy=BUSY):
    return SimpleNamespace(trace=SimpleNamespace(_host_ops=host_ops, _busy=busy),
                           bounds={"engine_calls": calls})


@pytest.mark.parametrize("metric", sorted(WANT))
def test_a_reader_gives_the_hand_computed_value(metric):
    assert spec.reader(metric + ".batch").read(ctx(HOST_OPS)) == pytest.approx(WANT[metric])


@pytest.mark.parametrize("metric", sorted(WANT))
def test_a_reader_reads_none_without_the_programs_spans(metric):
    """The parent commit opens no span: every reader is silent there, as
    it is without a trace or without an engine call."""
    read = spec.reader(metric + ".batch").read
    assert read(ctx([(6.0, 6.5, "aten::add"), (0.0, 1.0, "portbench.fs2")])) is None
    assert read(ctx(HOST_OPS, calls=0)) is None
    assert read(SimpleNamespace(trace=None, bounds={})) is None


def test_the_readers_find_the_spans_of_a_traced_run():
    """A whole ``--trace 1`` run of the tiny batch cell on the CPU: the
    profiler's own trace holds the engine's spans, and the result line
    the three metrics (no card: nothing is busy, so nothing idle)."""
    import torch

    import run
    import tiny

    args = run.parse(["--workload", "fs2v1.batch", "--seed", "2147483901",
                      "--seconds", "0.5", "--trace", "1"])
    result, _ = run.measure(args, tiny.cell("fs2v1.batch"), torch, device="cpu")
    got = result["metrics"]
    assert got["text_ms.batch"]["value"] > 0 and got["engine_host_ms.batch"]["value"] > 0
    assert got["host_idle_ms.batch"]["value"] == 0.0
