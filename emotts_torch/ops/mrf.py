"""One fully fused HiFi-GAN MRF stage — CUDA kernel, wrapper, plain version.

Replaces the Pallas TPU kernel ``_mrf_kernel`` of ``emotts/ops/mrf.py``
(reached through ``fused_mrf_stage``): the mean over the stage's ResBlock1s
(kernel sizes 3, 7, 11) of, per dilation d in (1, 3, 5),

    x += c2(lrelu(c1(lrelu(x), d))),   slope 0.1, zero padding,

with fp32 accumulation and the values between ops kept in the input dtype
(so bf16 activations are rounded after each leaky-relu, as the reference
kernel rounds them, and the weights are cast to bf16).  The kernel is
``csrc/mrf.cu``: one block per (batch row, time tile), every intermediate in
shared memory, one write of the mean; where shared memory leaves too short a
tile for the stage's halo (C = 128), one launch per dilation step of each
ResBlock instead (:func:`launch_plan`).  It is bound by operations
(2·B·T·126·C² against 2·B·T·C·itemsize bytes) and runs them on the tensor
cores: as 3xTF32 for fp32 (a documented emulation of fp32: each operand split
into two TF32 values, three products a term), as one TF32 product a term for
bf16, whose operands are exact in bf16 and so in TF32.
"""

from __future__ import annotations

import ctypes
from typing import List, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

from emotts_torch.ops import _build
from emotts_torch.ops.resblock import (LRELU_SLOPE, chain_halo, chain_rows,
                                       check_block_params, conv1d_btc, fit_pass,
                                       tile_for, z_offset)

# number of times the wrapper launched the CUDA kernel
launch_count = 0

SUPPORTED_CHANNELS = (32, 64, 128)
MAX_RESBLOCKS = 4

BlockParams = Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]


def stage_tile(channels: int, kernel_sizes: Sequence[int],
               dilations: Sequence[int]) -> int:
    """Largest tile (a multiple of 8 rows) for which window and intermediate
    fit in shared memory beside the weight ring (the running sum over the
    ResBlocks is kept in device memory)."""
    halo = max(chain_halo(k, dilations) for k in kernel_sizes)
    z_off = min(z_offset(k, dilations, halo) for k in kernel_sizes)
    tile = fit_pass(channels, tile_for(channels, halo, z_off), 2 * (halo - z_off))
    if tile < 8:
        raise ValueError(
            f"MRF stage with C={channels}, kernels {tuple(kernel_sizes)}, "
            f"dilations {tuple(dilations)} does not fit in shared memory"
        )
    return tile


# the whole stage goes in one launch when it computes at most this many rows
# per row it keeps; else one launch per (ResBlock, dilation step)
MAX_HALO_RATIO = 1.25


def launch_plan(channels: int, kernel_sizes: Sequence[int],
                dilations: Sequence[int]) -> List[Tuple[Optional[int], Optional[int], int]]:
    """How a stage is cut into launches: ``[(None, None, tile)]`` for the
    whole stage in one launch, or ``[(resblock, step, tile), ...]`` for one
    launch per dilation step of each ResBlock, each with the halo of that
    step only (r·d + r rows a side).  The one launch recomputes each step's
    halo for the steps after it: where shared memory leaves a tile too short
    for that (about 1.6 rows computed per row kept at C = 128), the steps go
    one by one and their results through device memory instead (measured on
    the card: PERF.md)."""
    taps = 2 * len(dilations) * sum(kernel_sizes)
    try:
        tile = stage_tile(channels, kernel_sizes, dilations)
    except ValueError:
        tile = 0
    if tile and (sum(chain_rows(k, dilations, tile) for k in kernel_sizes)
                 <= MAX_HALO_RATIO * taps * tile):
        return [(None, None, tile)]
    plan = []
    for rb, k in enumerate(kernel_sizes):
        for j, d in enumerate(dilations):
            h = chain_halo(k, (d,))
            z_off = z_offset(k, (d,), h)
            tile = fit_pass(channels, tile_for(channels, h, z_off), 2 * (h - z_off))
            if tile < 8:
                raise ValueError(
                    f"MRF stage with C={channels}, k={k}, d={d} does not fit "
                    "in shared memory")
            plan.append((rb, j, tile))
    return plan


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
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.POINTER(ctypes.c_void_p),
            ctypes.POINTER(ctypes.c_int), ctypes.c_int,
            ctypes.POINTER(ctypes.c_int), ctypes.c_int, ctypes.c_int,
            ctypes.c_longlong, ctypes.c_int, ctypes.c_int, ctypes.c_int,
            ctypes.c_void_p,
        ]
        fn.restype = ctypes.c_int
        step = lib.emotts_mrf_step
        step.argtypes = (
            [ctypes.c_void_p, ctypes.c_int] + [ctypes.c_void_p] * 7
            + [ctypes.c_int] * 5 + [ctypes.c_longlong] + [ctypes.c_int] * 3
            + [ctypes.c_void_p]
        )
        step.restype = ctypes.c_int
    return fn, lib.emotts_mrf_step


# the mode flags of emotts_mrf_step (csrc/mrf.cu)
_FIRST, _LAST, _TO_NEXT = 1, 2, 4


def fused_mrf_stage(x: torch.Tensor, params: Sequence[BlockParams],
                    kernel_sizes: Sequence[int] = (3, 7, 11),
                    dilations: Sequence[int] = (1, 3, 5)) -> torch.Tensor:
    """Whole MRF stage (mean of ResBlock1 outputs) through the fused kernel:
    one launch, or one per dilation step of each ResBlock (:func:`launch_plan`).

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
    # the kernel reads the weights as (tap, out, in), fp32; with bf16
    # activations the reference casts them to bf16, so the kernel gets fp32
    # values that are exact in bf16
    dt = x.dtype
    params = [
        tuple(w.to(dt).float().transpose(-1, -2).contiguous() if i % 2 == 0 else w
              for i, w in enumerate(block))
        for block in params
    ]
    plan = launch_plan(c, kernel_sizes, dilations)
    t8 = -(-t // 8) * 8
    out = torch.empty_like(x)
    # fp32 running sum over the ResBlocks: `out` itself for fp32
    acc = torch.empty(x.shape, dtype=torch.float32, device=x.device) if is_bf16 else out
    stage, step = _lib()
    stream = torch.cuda.current_stream(x.device).cuda_stream
    global launch_count
    if plan[0][0] is None:
        ptrs = (ctypes.c_void_p * (4 * len(params)))(
            *[p.data_ptr() for block in params for p in block]
        )
        ks = (ctypes.c_int * len(kernel_sizes))(*kernel_sizes)
        dils = (ctypes.c_int * len(dilations))(*dilations)
        with torch.cuda.device(x.device):
            code = stage(x.data_ptr(), out.data_ptr(), acc.data_ptr(), ptrs, ks,
                         len(kernel_sizes), dils, len(dilations), b, t, c,
                         min(plan[0][2], t8), int(is_bf16), stream)
        _build.check(code, "emotts_mrf_stage")
        launch_count += 1
        return out
    # one launch per step; a ResBlock's steps hand on fp32 results through
    # two buffers in turn
    inner = [torch.empty(x.shape, dtype=torch.float32, device=x.device)
             for _ in range(2 if len(dilations) > 1 else 0)]
    n_rb, last_step = len(kernel_sizes), len(dilations) - 1
    h = x
    for rb, j, tile in plan:
        w1, b1, w2, b2 = params[rb]
        if j == last_step:
            mode = (_FIRST if rb == 0 else 0) | (_LAST if rb == n_rb - 1 else 0)
            nxt = None
        else:
            mode, nxt = _TO_NEXT, inner[j % 2]
        with torch.cuda.device(x.device):
            code = step(h.data_ptr(), int(j == 0), nxt.data_ptr() if nxt is not None else None,
                        acc.data_ptr(), out.data_ptr(), w1[j].data_ptr(), b1[j].data_ptr(),
                        w2[j].data_ptr(), b2[j].data_ptr(), kernel_sizes[rb],
                        dilations[j], mode, n_rb, b, t, c, min(tile, t8),
                        int(is_bf16), stream)
        _build.check(code, "emotts_mrf_step")
        launch_count += 1
        h = x if nxt is None else nxt
    return out
