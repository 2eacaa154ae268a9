"""Shared building blocks: masks, positional encoding, FFT blocks.

Counterpart of ``emotts/nn/blocks.py``.  The FFT block is an encoder layer
whose feed-forward is a pair of 1-D convolutions:

    y = Norm(x + MHA(x))                        (post-norm; pre-norm switchable)
    z = Norm(y + Conv_k2(act(Conv_k1(y))))

Activations are (B, T, C) as in the reference.  Matmuls and convs run in
``dtype`` (bf16 on the card) with fp32 parameters cast at use; LayerNorm and
softmax compute in fp32 and cast back where the reference does.  Inference
only so far: there is no dropout on this path.
"""

from __future__ import annotations

import math
from typing import Callable, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from emotts_torch.ops.attention import fused_attention


def sequence_mask(lengths: torch.Tensor, max_len: int) -> torch.Tensor:
    """(B,) lengths → (B, T) bool mask; True = valid frame."""
    return torch.arange(max_len, device=lengths.device)[None, :] < lengths[:, None]


def sinusoidal_positional_encoding(length: int, d_model: int) -> np.ndarray:
    """Standard sinusoidal table, shape (1, length, d_model); sin on even
    channels, cos on odd."""
    position = np.arange(length, dtype=np.float64)[:, None]
    div_term = np.exp(
        np.arange(0, d_model, 2, dtype=np.float64) * (-np.log(10000.0) / d_model)
    )
    pe = np.zeros((length, d_model), dtype=np.float64)
    pe[:, 0::2] = np.sin(position * div_term)
    pe[:, 1::2] = np.cos(position * div_term)
    return pe[None].astype(np.float32)


def positional_encoding_like(x: torch.Tensor, d_model: int,
                             max_len: int = 4096) -> torch.Tensor:
    """The (1, T, D) table for ``x`` (B, T, D), on its device and dtype."""
    pe = sinusoidal_positional_encoding(min(x.shape[1], max_len), d_model)
    return torch.from_numpy(pe).to(device=x.device, dtype=x.dtype)


class CastLinear(nn.Linear):
    """Linear with fp32 parameters applied in the input's dtype."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        bias = None if self.bias is None else self.bias.to(x.dtype)
        return F.linear(x, self.weight.to(x.dtype), bias)


class CastConv1d(nn.Module):
    """Same-padded 1-D convolution over (B, T, C) with an odd kernel; fp32
    parameters in torch's (out, in, k) layout, applied in the input's dtype."""

    def __init__(self, in_channels: int, out_channels: int, kernel_size: int):
        super().__init__()
        if kernel_size % 2 != 1:
            # flax pads even kernels asymmetrically; nothing on this path
            # has one
            raise ValueError(f"odd kernel sizes only, got {kernel_size}")
        self.kernel_size = kernel_size
        self.weight = nn.Parameter(
            torch.empty(out_channels, in_channels, kernel_size)
        )
        self.bias = nn.Parameter(torch.zeros(out_channels))
        nn.init.kaiming_uniform_(self.weight, a=math.sqrt(5))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = F.conv1d(
            x.transpose(1, 2), self.weight.to(x.dtype), self.bias.to(x.dtype),
            padding=(self.kernel_size - 1) // 2,
        )
        return y.transpose(1, 2)


class LayerNorm32(nn.LayerNorm):
    """LayerNorm computed in fp32 whatever comes in; returns fp32."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.layer_norm(
            x.float(), self.normalized_shape, self.weight, self.bias, self.eps
        )


class MultiHeadSelfAttention(nn.Module):
    """Self-attention with key-padding masking; fp32 softmax.

    ``fused=True`` routes scores → softmax → AV through the hand-written
    kernel (``emotts_torch.ops.attention``) with an additive -1e9 key bias;
    the unfused path masks with the most negative fp32 value, as the
    reference's two paths do.  Parameters are the same either way."""

    def __init__(self, d_model: int, n_heads: int, dtype: torch.dtype = torch.float32,
                 fused: bool = False):
        super().__init__()
        if d_model % n_heads:
            raise ValueError("d_model must be divisible by n_heads")
        self.d_model, self.n_heads = d_model, n_heads
        self.dtype, self.fused = dtype, fused
        self.query = CastLinear(d_model, d_model)
        self.key = CastLinear(d_model, d_model)
        self.value = CastLinear(d_model, d_model)
        self.out = CastLinear(d_model, d_model)

    def forward(self, x: torch.Tensor,
                key_valid: Optional[torch.Tensor]) -> torch.Tensor:
        b, t, _ = x.shape
        h, d = self.n_heads, self.d_model // self.n_heads
        x = x.to(self.dtype)
        q = self.query(x).view(b, t, h, d)
        k = self.key(x).view(b, t, h, d)
        v = self.value(x).view(b, t, h, d)
        if self.fused:
            if key_valid is not None:
                bias = (1.0 - key_valid.float()) * -1e9
            else:
                bias = torch.zeros((b, t), dtype=torch.float32, device=x.device)
            out = fused_attention(q, k, v, bias)
        else:
            scale = 1.0 / math.sqrt(d)
            logits = torch.einsum("bqhd,bkhd->bhqk", q, k).float() * scale
            if key_valid is not None:
                neg = torch.finfo(torch.float32).min
                logits = logits + torch.where(
                    key_valid[:, None, None, :], 0.0, neg
                )
            weights = torch.softmax(logits, dim=-1).to(self.dtype)
            out = torch.einsum("bhqk,bkhd->bqhd", weights, v)
        return self.out(out.reshape(b, t, h * d))


class ConvFFN(nn.Module):
    """Two same-padded 1-D convolutions over time with activation between."""

    def __init__(self, d_model: int, ffn_dim: int, kernel_sizes: Tuple[int, int],
                 activation: Callable = F.relu):
        super().__init__()
        k1, k2 = kernel_sizes
        self.conv1 = CastConv1d(d_model, ffn_dim, k1)
        self.conv2 = CastConv1d(ffn_dim, d_model, k2)
        self.activation = activation

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.conv2(self.activation(self.conv1(x)))


class FFTBlock(nn.Module):
    """Transformer encoder layer with convolutional feed-forward."""

    def __init__(self, d_model: int, n_heads: int, ffn_dim: int,
                 kernel_sizes: Tuple[int, int] = (9, 1),
                 activation: Callable = F.relu, normalize_before: bool = False,
                 ln_eps: float = 1e-6, fused_attention: bool = False,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.normalize_before = normalize_before
        self.dtype = dtype
        self.norm1 = LayerNorm32(d_model, eps=ln_eps)
        self.norm2 = LayerNorm32(d_model, eps=ln_eps)
        self.attn = MultiHeadSelfAttention(d_model, n_heads, dtype, fused_attention)
        self.ffn = ConvFFN(d_model, ffn_dim, kernel_sizes, activation)

    def forward(self, x: torch.Tensor,
                key_valid: Optional[torch.Tensor] = None) -> torch.Tensor:
        attn_in = self.norm1(x).to(self.dtype) if self.normalize_before else x
        x = x + self.attn(attn_in, key_valid)
        if not self.normalize_before:
            x = self.norm1(x).to(self.dtype)
        ffn_in = self.norm2(x).to(self.dtype) if self.normalize_before else x
        x = x + self.ffn(ffn_in.to(self.dtype))
        if not self.normalize_before:
            x = self.norm2(x).to(self.dtype)
        return x


class FFTStack(nn.Module):
    """N stacked FFT blocks with optional final LayerNorm."""

    def __init__(self, num_layers: int, d_model: int, n_heads: int, ffn_dim: int,
                 kernel_sizes: Tuple[int, int] = (9, 1),
                 activation: Callable = F.relu, normalize_before: bool = False,
                 final_norm: bool = False, ln_eps: float = 1e-6,
                 fused_attention: bool = False,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype = dtype
        self.layers = nn.ModuleList([
            FFTBlock(d_model, n_heads, ffn_dim, kernel_sizes, activation,
                     normalize_before, ln_eps, fused_attention, dtype)
            for _ in range(num_layers)
        ])
        self.final_norm = LayerNorm32(d_model, eps=ln_eps) if final_norm else None

    def forward(self, x: torch.Tensor,
                key_valid: Optional[torch.Tensor] = None) -> torch.Tensor:
        for layer in self.layers:
            x = layer(x, key_valid)
        if self.final_norm is not None:
            x = self.final_norm(x).to(self.dtype)
        return x
