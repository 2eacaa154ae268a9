"""Kernels: the attention forward kernel's share of its roofline."""

from harness.spec import ROOT, load_module

_r = load_module(ROOT / "layer_metrics" / "_roofline.py")


def read(ctx):
    return _r.share(ctx, "attention_fwd", "attention_fwd")
