"""Synthesis engine: card-idle ms per engine call that falls inside the
engine's host phases (the program's ``engine.text``, ``engine.condition``,
``engine.pcm`` and ``engine.assemble`` spans)."""

from harness.spec import ROOT, load_module

_spans = load_module(ROOT / "layer_metrics" / "_spans.py")


def read(ctx):
    return _spans.idle_ms(ctx, "engine.text", "engine.condition", "engine.pcm",
                          "engine.assemble")
