"""One fully fused HiFi-GAN MRF stage — CUDA kernel, wrapper, plain version.

Replaces the Pallas TPU kernel ``_mrf_kernel`` of ``emotts/ops/mrf.py``
(reached through ``fused_mrf_stage``): the mean over the stage's ResBlock1s
(kernel sizes 3, 7, 11) of, per dilation d in (1, 3, 5),

    x += c2(lrelu(c1(lrelu(x), d))),   slope 0.1, zero padding,

with fp32 accumulation and the values between ops kept in the input dtype
(so bf16 activations are rounded after each leaky-relu, as the reference
kernel rounds them, and the weights are cast to bf16).  The kernel is
``csrc/mrf.cu``: one block per (batch row, time tile), every intermediate in
shared memory, one write of the mean.  It is bound by operations
(2·B·T·126·C² against 2·B·T·C·itemsize bytes) and runs them as fp32 FMA (not
TF32) on values that are exact in fp32.
"""

from __future__ import annotations

import ctypes
from typing import Sequence, Tuple

import torch
import torch.nn.functional as F

from emotts_torch.ops import _build
from emotts_torch.ops.resblock import (LRELU_SLOPE, MAX_TILE, SLAB_FLOATS,
                                       SMEM_FLOATS, conv1d_btc, chain_halo,
                                       check_block_params)

# number of times the wrapper launched the CUDA kernel
launch_count = 0

SUPPORTED_CHANNELS = (32, 64, 128)
MAX_RESBLOCKS = 4

BlockParams = Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]


def stage_tile(channels: int, kernel_sizes: Sequence[int],
               dilations: Sequence[int]) -> int:
    """Largest tile (a multiple of 8 rows) for which window, intermediate and
    running mean fit in shared memory beside the weight slab."""
    halo = max(chain_halo(k, dilations) for k in kernel_sizes)
    ld = channels + 1
    room = SMEM_FLOATS - SLAB_FLOATS - 4 * halo * ld
    tile = min(room // (2 * ld + channels) // 8 * 8, MAX_TILE)
    if tile < 8:
        raise ValueError(
            f"MRF stage with C={channels}, kernels {tuple(kernel_sizes)}, "
            f"dilations {tuple(dilations)} does not fit in shared memory"
        )
    return tile


def fused_mrf_stage_plain(x: torch.Tensor, params: Sequence[BlockParams],
                          kernel_sizes: Sequence[int] = (3, 7, 11),
                          dilations: Sequence[int] = (1, 3, 5)) -> torch.Tensor:
    """Plain PyTorch version, same rounding points as the reference kernel:
    the residual and all sums in fp32, conv inputs and weights in x's dtype.
    x (B, T, C); params: per ResBlock (w1, b1, w2, b2), w (n_d, k, C, C) in
    (tap, in, out) order, b (n_d, C)."""
    dt = x.dtype
    avg = None
    for w1, b1, w2, b2 in params:
        buf = x.float()
        for i, d in enumerate(dilations):
            y = F.leaky_relu(buf, LRELU_SLOPE).to(dt).float()
            z = conv1d_btc(y, w1[i].to(dt).float(), d) + b1[i].float()
            z = F.leaky_relu(z, LRELU_SLOPE).to(dt).float()
            buf = buf + (conv1d_btc(z, w2[i].to(dt).float(), 1) + b2[i].float())
        avg = buf if avg is None else avg + buf
    return (avg / len(params)).to(dt)


def _lib():
    lib = _build.load("mrf")
    fn = lib.emotts_mrf_stage
    if not fn.argtypes:
        fn.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.POINTER(ctypes.c_void_p),
            ctypes.POINTER(ctypes.c_int), ctypes.c_int,
            ctypes.POINTER(ctypes.c_int), ctypes.c_int, ctypes.c_int,
            ctypes.c_longlong, ctypes.c_int, ctypes.c_int, ctypes.c_int,
            ctypes.c_void_p,
        ]
        fn.restype = ctypes.c_int
    return fn


def fused_mrf_stage(x: torch.Tensor, params: Sequence[BlockParams],
                    kernel_sizes: Sequence[int] = (3, 7, 11),
                    dilations: Sequence[int] = (1, 3, 5)) -> torch.Tensor:
    """Whole MRF stage (mean of ResBlock1 outputs) in one fused kernel.

    x: (B, T, C) fp32 or bf16, C in {32, 64, 128}; params: per ResBlock the
    stacked (w1, b1, w2, b2), fp32.  CUDA tensors go through the kernel (or
    raise); CPU tensors take the plain version."""
    kernel_sizes = tuple(int(k) for k in kernel_sizes)
    dilations = tuple(int(d) for d in dilations)
    if len(params) != len(kernel_sizes) or not params:
        raise ValueError("one (w1, b1, w2, b2) per kernel size")
    for (w1, b1, w2, b2), k in zip(params, kernel_sizes):
        if check_block_params(x, w1, b1, w2, b2, len(dilations)) != k:
            raise ValueError(f"weights do not have kernel size {k}")
    if x.device.type == "cpu":
        return fused_mrf_stage_plain(x, params, kernel_sizes, dilations)
    if x.device.type != "cuda":
        raise ValueError(f"unsupported device {x.device}")
    b, t, c = x.shape
    if c not in SUPPORTED_CHANNELS:
        raise ValueError(f"kernel takes C in {SUPPORTED_CHANNELS}, got {c}")
    if len(params) > MAX_RESBLOCKS:
        raise ValueError(f"kernel takes up to {MAX_RESBLOCKS} ResBlocks")
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"kernel takes float32 or bfloat16, got {x.dtype}")
    if not x.is_contiguous():
        raise ValueError("x must be contiguous")
    is_bf16 = x.dtype == torch.bfloat16
    if is_bf16:
        # the reference casts the weights to the activation dtype; the kernel
        # reads fp32, so hand it fp32 values that are exact in bf16
        params = [
            (w1.bfloat16().float(), b1, w2.bfloat16().float(), b2)
            for w1, b1, w2, b2 in params
        ]
    tile = min(stage_tile(c, kernel_sizes, dilations), -(-t // 8) * 8)
    out = torch.empty_like(x)
    ptrs = (ctypes.c_void_p * (4 * len(params)))(
        *[p.data_ptr() for block in params for p in block]
    )
    ks = (ctypes.c_int * len(kernel_sizes))(*kernel_sizes)
    dils = (ctypes.c_int * len(dilations))(*dilations)
    fn = _lib()
    global launch_count
    with torch.cuda.device(x.device):
        code = fn(x.data_ptr(), out.data_ptr(), ptrs, ks, len(kernel_sizes),
                  dils, len(dilations), b, t, c, tile, int(is_bf16),
                  torch.cuda.current_stream(x.device).cuda_stream)
    _build.check(code, "emotts_mrf_stage")
    launch_count += 1
    return out
