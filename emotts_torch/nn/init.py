"""Seeded random weights for the port's modules.

A checkpoint trained by the reference converts through
``emotts_torch.nn.convert``; where none is at hand (smoke runs, tests) the
weights are drawn here from an explicit ``torch.Generator``, never from the
global one."""

from __future__ import annotations

import math

import torch
from torch import nn

from emotts_torch.nn.hifigan import HiFiGANGenerator


@torch.no_grad()
def seeded_init_(module: nn.Module, generator: torch.Generator,
                 gain: float = 1.0) -> nn.Module:
    """Redraw every weight of rank ≥ 2 as N(0, gain²/fan_in) from
    ``generator`` (on the CPU, then copied to the parameter's device);
    vectors (biases, norm scales) keep their constructed values.

    fan_in follows each layout: (out, in[, k[, k2]]) for Linear and 1-D or
    2-D conv weights and embeddings (fan_in = in·k·k2, features for an
    embedding), (k, in, out) and (n_d, k, in, out) for the generator's
    kernels.  The trainers start from these weights too
    (``emotts_torch.train.rank_trainer.init_rank_model``)."""
    vocoder = isinstance(module, HiFiGANGenerator)
    for _, p in module.named_parameters():
        if p.dim() < 2:
            continue
        if vocoder and p.dim() == 2:
            continue  # a ResBlock's stacked biases (n_d, C)
        if vocoder:
            fan_in = p.shape[-2] * p.shape[-3]  # in · k
        else:
            fan_in = p.shape[1:].numel()
        w = torch.randn(p.shape, generator=generator, dtype=torch.float32)
        p.copy_((w * (gain / math.sqrt(fan_in))).to(p.device))
    return module
