"""Synthesis engine: host ms per engine call in its own host work around
the models (the program's ``engine.condition``, ``engine.pcm`` and
``engine.assemble`` spans)."""

from harness.spec import ROOT, load_module

_spans = load_module(ROOT / "layer_metrics" / "_spans.py")


def read(ctx):
    return _spans.host_ms(ctx, "engine.condition", "engine.pcm", "engine.assemble")
