"""Acoustic model: device ms per engine call of the kernels issued inside
FastSpeech2's forwards (the benchmark's ``fs2`` range)."""

from harness.spec import ROOT, load_module

_ranges = load_module(ROOT / "layer_metrics" / "_range_ms.py")


def read(ctx):
    return _ranges.per_call(ctx, "fs2")
