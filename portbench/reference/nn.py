"""Layers shared by the references, over (B, T, C) activations and the
port's parameter layouts: Linear (out, in), Conv1d (out, in, k), the
vocoder's kernels (k, in, out)."""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F


def linear(x, p, name, q, bias=True):
    b = p.get(f"{name}.bias") if bias else None
    return F.linear(q(x), q(p[f"{name}.weight"]), b)


def conv1d(x, p, name, q):
    """Same-padded conv over (B, T, C), weight (out, in, k)."""
    w = p[f"{name}.weight"]
    y = F.conv1d(q(x).transpose(1, 2), q(w), p[f"{name}.bias"],
                 padding=(w.shape[-1] - 1) // 2)
    return y.transpose(1, 2)


def layer_norm(x, p, name, eps):
    return F.layer_norm(x, (x.shape[-1],), p[f"{name}.weight"], p[f"{name}.bias"], eps)


def sequence_mask(lengths, t):
    return torch.arange(t, device=lengths.device)[None, :] < lengths[:, None]


def sinusoid(t, d, device):
    pos = np.arange(t, dtype=np.float64)[:, None]
    div = np.exp(np.arange(0, d, 2, dtype=np.float64) * (-np.log(10000.0) / d))
    pe = np.zeros((t, d))
    pe[:, 0::2] = np.sin(pos * div)
    pe[:, 1::2] = np.cos(pos * div)
    return torch.from_numpy(pe.astype(np.float32)).to(device)[None]


def attention(x, p, name, heads, valid, q, keep=None, rate=0.0):
    """Multi-head self-attention with padded keys masked out; ``keep``
    (B, H, T, T) drops probabilities at ``rate`` (inverted dropout)."""
    b, t, d = x.shape
    hd = d // heads
    qh, kh, vh = (linear(x, p, f"{name}.{s}", q).view(b, t, heads, hd)
                  for s in ("query", "key", "value"))
    s = torch.einsum("bqhd,bkhd->bhqk", q(qh), q(kh)) / math.sqrt(hd)
    s = s.masked_fill(~valid[:, None, None, :], -1e9)
    prob = torch.softmax(s, dim=-1)
    if keep is not None:
        prob = torch.where(keep, prob / (1.0 - rate), torch.zeros((), device=x.device))
    o = torch.einsum("bhqk,bkhd->bqhd", q(prob), q(vh)).reshape(b, t, d)
    return linear(o, p, f"{name}.out", q)
