"""Seeded random weights for the port's modules.

A checkpoint trained by the reference converts through
``emotts_torch.nn.convert``; where none is at hand (smoke runs, tests) the
weights are drawn here from an explicit ``torch.Generator``, never from the
global one, and the vectors take flax's constant initial values, so that a
module's seeded weights are a function of the seed alone."""

from __future__ import annotations

import math

import torch
from torch import nn

from emotts_torch.nn.hifigan import HiFiGANGenerator

_NORMS = (nn.LayerNorm, nn.BatchNorm1d, nn.GroupNorm)


@torch.no_grad()
def seeded_init_(module: nn.Module, generator: torch.Generator,
                 gain: float = 1.0) -> nn.Module:
    """Redraw every weight of rank ≥ 2 as N(0, gain²/fan_in) from
    ``generator`` (on the CPU, then copied to the parameter's device); set
    every bias to zero and every norm's scale to one, as flax initialises
    ``Dense``, ``Conv``, ``LayerNorm`` and ``BatchNorm`` (``nn.Linear``
    would otherwise keep its draw from the global generator).

    fan_in follows each layout: (out, in[, k[, k2]]) for Linear and 1-D or
    2-D conv weights and embeddings (fan_in = in·k·k2, features for an
    embedding), (k, in, out) and (n_d, k, in, out) for the generator's
    kernels.  The trainers start from these weights too
    (``emotts_torch.train.rank_trainer.init_rank_model``)."""
    vocoder = isinstance(module, HiFiGANGenerator)
    norm_scales = {id(m.weight) for m in module.modules()
                   if isinstance(m, _NORMS) and m.weight is not None}
    for p in module.parameters():
        if id(p) in norm_scales:
            p.fill_(1.0)
            continue
        if p.dim() < 2 or (vocoder and p.dim() == 2):
            p.zero_()  # biases, norm shifts; a ResBlock's stacked biases (n_d, C)
            continue
        if vocoder:
            fan_in = p.shape[-2] * p.shape[-3]  # in · k
        else:
            fan_in = p.shape[1:].numel()
        w = torch.randn(p.shape, generator=generator, dtype=torch.float32)
        p.copy_((w * (gain / math.sqrt(fan_in))).to(p.device))
    return module
