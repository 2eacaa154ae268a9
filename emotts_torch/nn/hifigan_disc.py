"""HiFi-GAN discriminators: multi-period (MPD) and multi-scale (MSD).

Counterpart of ``emotts/nn/hifigan_disc.py`` (Kong et al., 2020):

* MPD: one sub-discriminator per period p ∈ {2,3,5,7,11}; the waveform,
  reflect-padded up to a multiple of p, is folded to (B, 1, T/p, p) and run
  through (5,1)-kernel 2-D convs of stride (3,1), one stride-1 (5,1) conv
  and a (3,1) post conv, so that each column sees one of p interleaved
  sub-sequences.
* MSD: three 1-D conv stacks (kernels 15/41/…/5, grouped convs) on the
  waveform average-pooled ×1, ×2, ×4.

LeakyReLU slope 0.1.  Each returns per-position logits, flattened H-major
as the reference's ``reshape(b, -1)`` of NHWC does, and every layer's
feature map for the feature-matching loss, in this package's layout: MPD
(B, C, T/p, p), MSD (B, C, T).

Parameters are torch conv weights — MPD (cout, cin, 5, 1), MSD (cout,
cin/g, k) — which ``emotts_torch.nn.convert.disc_from_flax`` fills from the
reference's trees.  Every conv casts its input, weight and bias to the
compute ``dtype`` (bf16 by default) as the reference does; there is no
autocast.

The reference's TPU layouts — ``fold_periods`` (period axis folded into
batch), ``dense_groups`` and ``group_merge`` (grouped convs as block-diagonal
dense ones) — have identical math and parameters.  They are accepted here and
the plain grouped and unfolded convs are computed.
"""

from __future__ import annotations

import math
from typing import List, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

LRELU_SLOPE = 0.1
_MPD_CHANNELS = (32, 128, 512, 1024)
_MSD_CHANNELS = (128, 128, 256, 512, 1024, 1024, 1024)


class _Conv(nn.Module):
    """Weight and bias of one conv, computed in ``dtype``."""

    def __init__(self, weight_shape: Tuple[int, ...], dtype: torch.dtype):
        super().__init__()
        fan_in = math.prod(weight_shape[1:])
        self.weight = nn.Parameter(torch.randn(weight_shape) / math.sqrt(fan_in))
        self.bias = nn.Parameter(torch.zeros(weight_shape[0]))
        self.dtype = dtype

    def cast(self, x: torch.Tensor):
        dt = self.dtype
        return x.to(dt), self.weight.to(dt), self.bias.to(dt)


class PeriodDiscriminator(nn.Module):
    """One MPD sub-discriminator; ``fold_1d`` is accepted (see the module
    docstring)."""

    def __init__(self, period: int, channels: Sequence[int] = _MPD_CHANNELS,
                 fold_1d: bool = False, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.period, self.fold_1d = int(period), fold_1d
        shapes, cin = [], 1
        for ch in channels:
            shapes.append((ch, cin, 5, 1))
            cin = ch
        shapes += [(channels[-1], cin, 5, 1), (1, channels[-1], 3, 1)]
        self.convs = nn.ModuleList(_Conv(s, dtype) for s in shapes)

    def forward(self, y: torch.Tensor) -> Tuple[torch.Tensor, List[torch.Tensor]]:
        """y: (B, T) waveform → (logits (B, ·), feature maps)."""
        b, t = y.shape
        p = self.period
        pad = (-t) % p
        if pad:
            y = F.pad(y[:, None], (0, pad), mode="reflect")[:, 0]
        x = y.reshape(b, 1, -1, p)
        feats = []
        last = len(self.convs) - 1
        for i, conv in enumerate(self.convs):
            stride = (3, 1) if i < last - 1 else (1, 1)
            x, w, bias = conv.cast(x)
            x = F.conv2d(x, w, bias, stride=stride, padding=(w.shape[2] // 2, 0))
            if i < last:
                x = F.leaky_relu(x, LRELU_SLOPE)
            feats.append(x)
        return x.reshape(b, -1), feats


class ScaleDiscriminator(nn.Module):
    """One MSD sub-discriminator: grouped 1-D convs with padding k//2, the
    group count of a layer cut to divide both of its channel counts."""

    def __init__(self, channels: Sequence[int] = _MSD_CHANNELS,
                 groups: Sequence[int] = (1, 4, 16, 16, 16, 16, 1),
                 kernels: Sequence[int] = (15, 41, 41, 41, 41, 41, 5),
                 strides: Sequence[int] = (1, 2, 2, 4, 4, 1, 1),
                 dense_groups: bool = False, group_merge: int = 0,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dense_groups, self.group_merge = dense_groups, group_merge
        self.strides, self.groups = [], []
        convs, cin = [], 1
        for ch, g, k, s in zip(channels, groups, kernels, strides):
            g = math.gcd(g, math.gcd(cin, ch))
            convs.append(_Conv((ch, cin // g, k), dtype))
            self.strides.append(s)
            self.groups.append(g)
            cin = ch
        convs.append(_Conv((1, cin, 3), dtype))
        self.strides.append(1)
        self.groups.append(1)
        self.convs = nn.ModuleList(convs)

    def forward(self, y: torch.Tensor) -> Tuple[torch.Tensor, List[torch.Tensor]]:
        b = y.shape[0]
        x = y[:, None]  # (B, 1, T)
        feats = []
        last = len(self.convs) - 1
        for i, (conv, s, g) in enumerate(zip(self.convs, self.strides, self.groups)):
            x, w, bias = conv.cast(x)
            x = F.conv1d(x, w, bias, stride=s, padding=w.shape[2] // 2, groups=g)
            if i < last:
                x = F.leaky_relu(x, LRELU_SLOPE)
            feats.append(x)
        return x.reshape(b, -1), feats


class MultiPeriodDiscriminator(nn.Module):
    def __init__(self, periods: Sequence[int] = (2, 3, 5, 7, 11),
                 channel_mult: float = 1.0, fold_periods: Sequence[int] = (),
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        chans = tuple(max(4, int(c * channel_mult)) for c in _MPD_CHANNELS)
        self.discriminators = nn.ModuleDict({
            f"period_{p}": PeriodDiscriminator(p, chans, p in tuple(fold_periods), dtype)
            for p in periods})

    def forward(self, y: torch.Tensor):
        """Returns (list of logits, list of feature lists), one per period."""
        outs, feats = [], []
        for d in self.discriminators.values():
            o, f = d(y)
            outs.append(o)
            feats.append(f)
        return outs, feats


class MultiScaleDiscriminator(nn.Module):
    def __init__(self, n_scales: int = 3, channel_mult: float = 1.0,
                 dense_groups: bool = False, group_merge: int = 0,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        chans = tuple(max(4, int(c * channel_mult)) for c in _MSD_CHANNELS)
        self.discriminators = nn.ModuleDict({
            f"scale_{i}": ScaleDiscriminator(chans, dense_groups=dense_groups,
                                             group_merge=group_merge, dtype=dtype)
            for i in range(n_scales)})

    def forward(self, y: torch.Tensor):
        outs, feats = [], []
        x = y
        for i, d in enumerate(self.discriminators.values()):
            if i:
                # flax's avg_pool divides by the whole window, padding included
                x = F.avg_pool1d(x[:, None], 4, 2, padding=1,
                                 count_include_pad=True)[:, 0]
            o, f = d(x)
            outs.append(o)
            feats.append(f)
        return outs, feats


class Discriminators(nn.Module):
    """MPD and MSD applied to one waveform batch: their logits and feature
    lists, MPD's first (the reference trainer's ``disc_all``)."""

    def __init__(self, mpd: MultiPeriodDiscriminator, msd: MultiScaleDiscriminator):
        super().__init__()
        self.mpd, self.msd = mpd, msd

    def forward(self, y: torch.Tensor):
        outs_p, feats_p = self.mpd(y)
        outs_s, feats_s = self.msd(y)
        return outs_p + outs_s, feats_p + feats_s
