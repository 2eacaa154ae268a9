"""Kernels: the attention backward kernels' (delta and fused passes)
share of their roofline."""

from harness.spec import ROOT, load_module

_r = load_module(ROOT / "layer_metrics" / "_roofline.py")


def read(ctx):
    return _r.share(ctx, "attention_bwd", "attention_bwd")
