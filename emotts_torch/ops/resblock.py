"""Fused HiFi-GAN ResBlock1 — CUDA kernel, wrapper, plain version.

Replaces the Pallas TPU kernel ``_kernel`` of ``emotts/ops/resblock.py``
(reached through ``fused_resblock1``).  Per dilation d:

    x += c2(lrelu(c1(lrelu(x), d))),   slope 0.1, zero padding,

fp32 throughout; bf16 activations are widened on load and rounded once on
store.  The kernel is ``csrc/resblock.cu``: one block per (batch row, time
tile) keeps the tile and its halo in shared memory through the chain and
forces rows outside [0, T) to zero after both convs of every step.  It is
bound by operations (2·B·T·6k·C² against 2·B·T·C·itemsize bytes) and runs
them as fp32 FMA, not TF32.

Shared memory decides how much of a chain one launch can take
(:func:`launch_plan`): where the window of the whole chain leaves no room
for a useful tile (C = 256 with k = 7 or 11) the block runs as one launch
per dilation step.
"""

from __future__ import annotations

import ctypes
from typing import List, Sequence, Tuple

import torch
import torch.nn.functional as F

from emotts_torch.ops import _build

LRELU_SLOPE = 0.1

# number of times the wrapper launched the CUDA kernel
launch_count = 0

SMEM_FLOATS = 232448 // 4  # dynamic shared memory a block may use on sm_90
SLAB_FLOATS = 2048  # weight slab of the kernel (csrc/resblock_common.cuh)
SUPPORTED_CHANNELS = (32, 64, 128, 256)
MAX_TILE = 512


def chain_halo(kernel_size: int, dilations: Sequence[int]) -> int:
    """One-sided receptive field of the chained block (no rounding: the 8-row
    rounding of the TPU version is a DMA constraint of that hardware)."""
    r = (kernel_size - 1) // 2
    return sum(r * d + r for d in dilations)


def _tile_for(channels: int, halo: int) -> int:
    """Largest tile (a multiple of 8 rows) whose window and intermediate fit
    in shared memory beside the weight slab; 0 if none does."""
    rows = (SMEM_FLOATS - SLAB_FLOATS) // (2 * (channels + 1))
    tile = min((rows - 2 * halo) // 8 * 8, MAX_TILE)
    return max(tile, 0)


def launch_plan(channels: int, kernel_size: int,
                dilations: Sequence[int]) -> List[Tuple[int, int, int]]:
    """How a block is cut into launches: ``[(first, last, tile), ...]`` over
    dilation steps ``[first, last)``.  The whole chain in one launch when its
    tile is at least as long as its halo (so that no more than about two rows
    are computed per row kept); else one launch per step."""
    halo = chain_halo(kernel_size, dilations)
    tile = _tile_for(channels, halo)
    if tile >= max(halo, 8):
        return [(0, len(dilations), tile)]
    plan = []
    for i, d in enumerate(dilations):
        tile = _tile_for(channels, chain_halo(kernel_size, (d,)))
        if tile < 8:
            raise ValueError(
                f"ResBlock1 with C={channels}, k={kernel_size}, d={d} does "
                "not fit in shared memory"
            )
        plan.append((i, i + 1, tile))
    return plan


def conv1d_btc(x: torch.Tensor, w: torch.Tensor, dilation: int) -> torch.Tensor:
    """(B, T, C) × (k, in, out) same-size conv with symmetric zero padding."""
    k = w.shape[0]
    pad = (k - 1) // 2 * dilation
    y = F.conv1d(x.transpose(1, 2), w.permute(2, 1, 0), padding=pad,
                 dilation=dilation)
    return y.transpose(1, 2)


def fused_resblock1_plain(x: torch.Tensor, w1: torch.Tensor, b1: torch.Tensor,
                          w2: torch.Tensor, b2: torch.Tensor,
                          dilations: Sequence[int]) -> torch.Tensor:
    """Plain PyTorch version, same rounding points as the reference kernel:
    fp32 from load to store.  x (B, T, C); w (n_d, k, C, C) in (tap, in, out)
    order; b (n_d, C)."""
    buf = x.float()
    for i, d in enumerate(dilations):
        y = F.leaky_relu(buf, LRELU_SLOPE)
        y = conv1d_btc(y, w1[i].float(), d) + b1[i].float()
        y = F.leaky_relu(y, LRELU_SLOPE)
        y = conv1d_btc(y, w2[i].float(), 1) + b2[i].float()
        buf = buf + y
    return buf.to(x.dtype)


def _lib():
    lib = _build.load("resblock")
    fn = lib.emotts_resblock1
    if not fn.argtypes:
        fn.argtypes = (
            [ctypes.c_void_p] * 6
            + [ctypes.c_int, ctypes.POINTER(ctypes.c_int), ctypes.c_int,
               ctypes.c_int, ctypes.c_longlong, ctypes.c_int, ctypes.c_int,
               ctypes.c_int, ctypes.c_void_p]
        )
        fn.restype = ctypes.c_int
    return fn


def check_block_params(x, w1, b1, w2, b2, n_dil: int) -> int:
    """Validate one ResBlock's tensors for the kernels; returns k."""
    if x.dim() != 3:
        raise ValueError(f"x must be (B, T, C), got {tuple(x.shape)}")
    c = x.shape[2]
    if w1.dim() != 4 or w1.shape[0] != n_dil or tuple(w1.shape[2:]) != (c, c):
        raise ValueError(f"w1 must be ({n_dil}, k, {c}, {c}), got {tuple(w1.shape)}")
    k = int(w1.shape[1])
    if k % 2 != 1:
        raise ValueError(f"kernel size must be odd, got {k}")
    if w2.shape != w1.shape:
        raise ValueError("w2 must have w1's shape")
    if tuple(b1.shape) != (n_dil, c) or tuple(b2.shape) != (n_dil, c):
        raise ValueError(f"b1, b2 must be ({n_dil}, {c})")
    for name, t in (("w1", w1), ("b1", b1), ("w2", w2), ("b2", b2)):
        if t.dtype != torch.float32:
            raise ValueError(f"{name} must be float32, got {t.dtype}")
        if t.device != x.device:
            raise ValueError(f"{name} lies on {t.device}, x on {x.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    return k


def fused_resblock1(x: torch.Tensor, w1: torch.Tensor, b1: torch.Tensor,
                    w2: torch.Tensor, b2: torch.Tensor,
                    dilations: Sequence[int]) -> torch.Tensor:
    """Fused ResBlock1.  x (B, T, C) fp32 or bf16; w1, w2 (n_d, k, C, C) fp32
    in (tap, in, out) order; b1, b2 (n_d, C) fp32.  CUDA tensors go through
    the kernel (or raise); CPU tensors take the plain version."""
    dilations = tuple(int(d) for d in dilations)
    k = check_block_params(x, w1, b1, w2, b2, len(dilations))
    if x.device.type == "cpu":
        return fused_resblock1_plain(x, w1, b1, w2, b2, dilations)
    if x.device.type != "cuda":
        raise ValueError(f"unsupported device {x.device}")
    b, t, c = x.shape
    if c not in SUPPORTED_CHANNELS:
        raise ValueError(f"kernel takes C in {SUPPORTED_CHANNELS}, got {c}")
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"kernel takes float32 or bfloat16, got {x.dtype}")
    if not x.is_contiguous():
        raise ValueError("x must be contiguous")
    fn = _lib()
    global launch_count
    stream = torch.cuda.current_stream(x.device).cuda_stream
    for first, last, tile in launch_plan(c, k, dilations):
        out = torch.empty_like(x)
        dils = (ctypes.c_int * (last - first))(*dilations[first:last])
        tile = min(tile, -(-t // 8) * 8)
        with torch.cuda.device(x.device):
            code = fn(x.data_ptr(), out.data_ptr(), w1[first:last].data_ptr(),
                      b1[first:last].data_ptr(), w2[first:last].data_ptr(),
                      b2[first:last].data_ptr(), k, dils, last - first, b, t,
                      c, tile, int(x.dtype == torch.bfloat16), stream)
        _build.check(code, "emotts_resblock1")
        launch_count += 1
        x = out
    return x
