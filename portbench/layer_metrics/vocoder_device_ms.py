"""Vocoder: device ms per engine call of the kernels issued inside the
generator's forwards (the benchmark's ``vocoder`` range)."""

from harness.spec import ROOT, load_module

_ranges = load_module(ROOT / "layer_metrics" / "_range_ms.py")


def read(ctx):
    return _ranges.per_call(ctx, "vocoder")
