"""Shared building blocks: masks, positional encoding, FFT blocks.

Counterpart of ``emotts/nn/blocks.py``.  The FFT block is an encoder layer
whose feed-forward is a pair of 1-D convolutions:

    y = Norm(x + Dropout(MHA(x)))               (post-norm; pre-norm switchable)
    z = Norm(y + Dropout(Conv_k2(act(Conv_k1(y)))))

Style differences are parameters: the rank model uses GELU, kernel sizes
(9, 9) and dropout also inside the FFN after the activation; FastSpeech2 uses
ReLU, kernel sizes (9, 1) and dropout on the residuals only.

Activations are (B, T, C) as in the reference.  Matmuls and convs run in
``dtype`` (bf16 on the card) with fp32 parameters cast at use; LayerNorm and
softmax compute in fp32 and cast back where the reference does.

Training mode is a call argument, as in the reference: ``deterministic=False``
switches dropout on, and every random draw comes from the ``generator`` the
caller passes (the trainer owns and checkpoints it), never from the global
one; under data parallelism the trainer wraps it in a
``parallel.mesh.RowDraws``, and every draw is this rank's rows of the draw a
one-process run on the global batch makes.

Under tensor parallelism (``parallel.tp.shard_module_``) an attention holds
``n_heads / M`` heads and a conv-FFN ``ffn_dim / M`` channels of ``conv1``
with the matching input channels of ``conv2``; each pair is bracketed by
the model axis's ``f`` and ``g``, and every dropout mask inside it is this
rank's slice of the mask at the full width.  ``FFTStack(remat=True)``
recomputes each block in the backward (``torch.utils.checkpoint``),
replaying the block's draws from the caller's generator: it changes memory,
not numbers.
"""

from __future__ import annotations

import math
from typing import Callable, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from emotts_torch.ops.attention import fused_attention
from emotts_torch.parallel.mesh import base_generator, draw_rows, row_index
from emotts_torch.parallel.tp import (ModelAxis, copy_to_model, offset_seeds,
                                      reduce_from_model)


def dropout(x: torch.Tensor, rate: float, generator,
            split: Optional[Tuple[int, int, int]] = None) -> torch.Tensor:
    """Inverted dropout with an explicit generator (on the device of ``x``):
    an entry is kept with probability 1 - rate and scaled by 1 / (1 - rate).
    Under data parallelism ``generator`` is a ``RowDraws``: the mask is this
    rank's rows of the mask of the global batch; ``split`` (a model axis's
    ``ModelAxis.split``): its slice of the mask at the full width."""
    if rate <= 0.0:
        return x
    if generator is None:
        raise ValueError("dropout needs the caller's torch.Generator")
    keep = draw_rows(torch.rand, x.shape, generator, split=split,
                     device=x.device) >= rate
    return torch.where(keep, x / (1.0 - rate), torch.zeros((), dtype=x.dtype,
                                                           device=x.device))


def draw_attention_seeds(batch: int, generator, device) -> torch.Tensor:
    """(B,) int32 per-example dropout seeds for the fused kernel:
    ``base + row`` with int32 wrap-around, ``base`` one int32 drawn from
    the generator per call and ``row`` the example's row in the global batch
    (``arange(B)`` in one process), so example i keeps its stream whatever
    the batch around it and whichever rank runs it.  Stays on the device: no
    host read."""
    if generator is None:
        raise ValueError("dropout needs the caller's torch.Generator")
    base = torch.randint(-2 ** 31, 2 ** 31, (1,), generator=base_generator(generator),
                         device=device, dtype=torch.int64)
    seeds = base + row_index(generator, batch, device)
    return (((seeds + 2 ** 31) % 2 ** 32) - 2 ** 31).to(torch.int32)


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

    def forward(self, x: torch.Tensor, bias: bool = True) -> torch.Tensor:
        y = F.conv1d(
            x.transpose(1, 2), self.weight.to(x.dtype),
            self.bias.to(x.dtype) if bias else None,
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
    reference's two paths do.  Parameters are the same either way.  With
    ``deterministic=False`` the probabilities are dropped out at ``dropout``:
    inside the kernel on the fused path (Philox streams seeded per example
    from the generator), by :func:`dropout` on the unfused one — two streams,
    one distribution.

    With a ``model_axis`` (set by ``parallel.tp.shard_module_``) it holds
    heads ``rank·H/M …`` of the layer: the fused kernel's seeds are offset to
    them and the unfused mask is their slice of the full-width mask, and
    the ``out`` projection's partial sums are added over the model group
    before its bias."""

    model_axis: Optional[ModelAxis] = None

    def __init__(self, d_model: int, n_heads: int, dtype: torch.dtype = torch.float32,
                 fused: bool = False, dropout: float = 0.0):
        super().__init__()
        if d_model % n_heads:
            raise ValueError("d_model must be divisible by n_heads")
        self.d_model, self.n_heads = d_model, n_heads
        self.dtype, self.fused, self.dropout = dtype, fused, dropout
        self.query = CastLinear(d_model, d_model)
        self.key = CastLinear(d_model, d_model)
        self.value = CastLinear(d_model, d_model)
        self.out = CastLinear(d_model, d_model)

    @property
    def tp_units(self) -> Tuple[str, int]:
        return "n_heads", self.n_heads

    def forward(self, x: torch.Tensor, key_valid: Optional[torch.Tensor],
                deterministic: bool = True,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        b, t, _ = x.shape
        rate = 0.0 if deterministic else self.dropout
        axis = self.model_axis
        h, d = self.n_heads, self.d_model // self.n_heads
        x = x.to(self.dtype)
        if axis is not None:
            h //= axis.size
            x = copy_to_model(x, axis)
        q = self.query(x).view(b, t, h, d)
        k = self.key(x).view(b, t, h, d)
        v = self.value(x).view(b, t, h, d)
        if self.fused:
            if key_valid is not None:
                bias = (1.0 - key_valid.float()) * -1e9
            else:
                bias = torch.zeros((b, t), dtype=torch.float32, device=x.device)
            seeds = None
            if rate > 0.0:
                seeds = draw_attention_seeds(b, generator, x.device)
                if axis is not None:
                    seeds = offset_seeds(seeds, axis.rank * h)
            out = fused_attention(q, k, v, bias, seeds, rate)
        else:
            scale = 1.0 / math.sqrt(d)
            logits = torch.einsum("bqhd,bkhd->bhqk", q, k).float() * scale
            if key_valid is not None:
                neg = torch.finfo(torch.float32).min
                logits = logits + torch.where(
                    key_valid[:, None, None, :], 0.0, neg
                )
            weights = torch.softmax(logits, dim=-1).to(self.dtype)
            weights = dropout(weights, rate, generator,
                              None if axis is None else axis.split(1))
            out = torch.einsum("bhqk,bkhd->bqhd", weights, v)
        out = out.reshape(b, t, h * d)
        if axis is None:
            return self.out(out)
        out = reduce_from_model(F.linear(out, self.out.weight.to(out.dtype)), axis)
        return out + self.out.bias.to(out.dtype)


class ConvFFN(nn.Module):
    """Two same-padded 1-D convolutions over time with activation between.
    With a ``model_axis`` it holds its rank's ``ffn_dim / M`` channels
    (``conv1``'s outputs, ``conv2``'s inputs); ``conv2``'s partial sums are
    added over the model group before its bias."""

    model_axis: Optional[ModelAxis] = None

    def __init__(self, d_model: int, ffn_dim: int, kernel_sizes: Tuple[int, int],
                 activation: Callable = F.relu, dropout: float = 0.0,
                 internal_dropout: bool = False):
        super().__init__()
        k1, k2 = kernel_sizes
        self.conv1 = CastConv1d(d_model, ffn_dim, k1)
        self.conv2 = CastConv1d(ffn_dim, d_model, k2)
        self.activation = activation
        # rank-model style: dropout after the activation
        self.dropout = dropout if internal_dropout else 0.0

    @property
    def tp_units(self) -> Tuple[str, int]:
        return "ffn_dim", self.conv1.weight.shape[0]

    def forward(self, x: torch.Tensor, deterministic: bool = True,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        axis = self.model_axis
        if axis is not None:
            x = copy_to_model(x, axis)
        y = self.activation(self.conv1(x))
        if not deterministic:
            y = dropout(y, self.dropout, generator,
                        None if axis is None else axis.split(2))
        if axis is None:
            return self.conv2(y)
        y = reduce_from_model(self.conv2(y, bias=False), axis)
        return y + self.conv2.bias.to(y.dtype)


class FFTBlock(nn.Module):
    """Transformer encoder layer with convolutional feed-forward."""

    def __init__(self, d_model: int, n_heads: int, ffn_dim: int,
                 kernel_sizes: Tuple[int, int] = (9, 1),
                 activation: Callable = F.relu, normalize_before: bool = False,
                 ln_eps: float = 1e-6, fused_attention: bool = False,
                 dtype: torch.dtype = torch.float32, dropout: float = 0.0,
                 ffn_internal_dropout: bool = False):
        super().__init__()
        self.normalize_before = normalize_before
        self.dtype = dtype
        self.dropout = dropout
        self.norm1 = LayerNorm32(d_model, eps=ln_eps)
        self.norm2 = LayerNorm32(d_model, eps=ln_eps)
        self.attn = MultiHeadSelfAttention(d_model, n_heads, dtype,
                                           fused_attention, dropout)
        self.ffn = ConvFFN(d_model, ffn_dim, kernel_sizes, activation, dropout,
                           ffn_internal_dropout)

    def forward(self, x: torch.Tensor, key_valid: Optional[torch.Tensor] = None,
                deterministic: bool = True,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        rate = 0.0 if deterministic else self.dropout
        attn_in = self.norm1(x).to(self.dtype) if self.normalize_before else x
        x = x + dropout(self.attn(attn_in, key_valid, deterministic, generator),
                        rate, generator)
        if not self.normalize_before:
            x = self.norm1(x).to(self.dtype)
        ffn_in = self.norm2(x).to(self.dtype) if self.normalize_before else x
        x = x + dropout(self.ffn(ffn_in.to(self.dtype), deterministic, generator),
                        rate, generator)
        if not self.normalize_before:
            x = self.norm2(x).to(self.dtype)
        return x


class FFTStack(nn.Module):
    """N stacked FFT blocks with optional final LayerNorm.

    ``remat=True`` keeps no activation of a block for the backward but its
    input, and runs the block again there (the reference's ``nn.remat``):
    the stack's activations cost one block instead of N.  The recompute
    replays the block's draws: the caller's generator is put back to where
    the block's first forward found it and, after the recompute, to where
    the recompute found it, so masks, seeds and the generator's state are
    those of the step without remat."""

    def __init__(self, num_layers: int, d_model: int, n_heads: int, ffn_dim: int,
                 kernel_sizes: Tuple[int, int] = (9, 1),
                 activation: Callable = F.relu, normalize_before: bool = False,
                 final_norm: bool = False, ln_eps: float = 1e-6,
                 fused_attention: bool = False,
                 dtype: torch.dtype = torch.float32, dropout: float = 0.0,
                 ffn_internal_dropout: bool = False, remat: bool = False):
        super().__init__()
        self.dtype, self.remat = dtype, remat
        self.layers = nn.ModuleList([
            FFTBlock(d_model, n_heads, ffn_dim, kernel_sizes, activation,
                     normalize_before, ln_eps, fused_attention, dtype, dropout,
                     ffn_internal_dropout)
            for _ in range(num_layers)
        ])
        self.final_norm = LayerNorm32(d_model, eps=ln_eps) if final_norm else None

    def forward(self, x: torch.Tensor, key_valid: Optional[torch.Tensor] = None,
                deterministic: bool = True,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        remat = self.remat and torch.is_grad_enabled()
        for layer in self.layers:
            if remat:
                x = _rematerialized(layer, x, key_valid, deterministic, generator)
            else:
                x = layer(x, key_valid, deterministic, generator)
        if self.final_norm is not None:
            x = self.final_norm(x).to(self.dtype)
        return x


def _rematerialized(block: FFTBlock, x: torch.Tensor,
                    key_valid: Optional[torch.Tensor], deterministic: bool,
                    generator) -> torch.Tensor:
    """``block(x, …)`` under ``torch.utils.checkpoint``, its draws replayed
    in the recompute.  ``checkpoint`` would restore the global generators
    only; every draw here comes from ``generator``, so their states are not
    saved (``preserve_rng_state=False``) and ``generator``'s is."""
    gen = base_generator(generator)
    start = None if gen is None else gen.get_state()
    first = [True]

    def run(x):
        if first[0] or gen is None:
            first[0] = False
            return block(x, key_valid, deterministic, generator)
        end = gen.get_state()  # the recompute, in the backward
        gen.set_state(start)
        try:
            return block(x, key_valid, deterministic, generator)
        finally:
            gen.set_state(end)

    return checkpoint(run, x, use_reentrant=False, preserve_rng_state=False)
