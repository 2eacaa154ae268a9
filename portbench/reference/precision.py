"""The arithmetic a reference runs in.

``FP32`` is the reference itself: float32 products with TF32 off.
``TF32`` and ``FP8`` are the controls, the reference computed one step
below what a configuration states (TF32 for its float32 parts, fp8 for
its bfloat16 parts): every product's operands pass through ``q``, which
rounds them to e4m3 with one scale per tensor (the backward passes the
gradient straight through the rounding)."""

from __future__ import annotations

import contextlib

import torch

E4M3_MAX = 448.0


def _same(x):
    return x


def fp8_round(x: torch.Tensor) -> torch.Tensor:
    amax = x.detach().abs().amax().float().clamp(min=1e-30)
    scale = amax / E4M3_MAX
    q = (x.detach() / scale).to(torch.float8_e4m3fn).to(x.dtype) * scale
    return x + (q - x).detach()


class Precision:
    def __init__(self, name: str, q=_same, tf32: bool = False):
        self.name, self.q, self.tf32 = name, q, tf32

    @contextlib.contextmanager
    def products(self):
        """TF32 on or off for float32 matmuls and convolutions, restored after."""
        m, c = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
        torch.backends.cuda.matmul.allow_tf32 = self.tf32
        torch.backends.cudnn.allow_tf32 = self.tf32
        try:
            yield
        finally:
            torch.backends.cuda.matmul.allow_tf32 = m
            torch.backends.cudnn.allow_tf32 = c


FP32 = Precision("float32")
TF32 = Precision("tf32", tf32=True)
FP8 = Precision("fp8", q=fp8_round)
