"""Kernels: the MRF-stage and ResBlock kernels' share of their roofline."""

from harness.spec import ROOT, load_module

_r = load_module(ROOT / "layer_metrics" / "_roofline.py")


def read(ctx):
    return _r.share(ctx, "vocoder_kernels", "mrf_stage_kernel", "mrf_step_kernel",
                    "resblock1_kernel")
