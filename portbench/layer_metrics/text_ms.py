"""Text front end: host ms per engine call in sentence splitting and G2P
(the program's ``engine.text`` span)."""

from harness.spec import ROOT, load_module

_spans = load_module(ROOT / "layer_metrics" / "_spans.py")


def read(ctx):
    return _spans.host_ms(ctx, "engine.text")
