"""One fully fused HiFi-GAN MRF stage — CUDA kernel, wrapper, plain version.

Replaces the Pallas TPU kernel ``_mrf_kernel`` of ``emotts/ops/mrf.py``
(reached through ``fused_mrf_stage``): the mean over the stage's ResBlock1s
(kernel sizes 3, 7, 11) of, per dilation d in (1, 3, 5),

    x += c2(lrelu(c1(lrelu(x), d))),   slope 0.1, zero padding,

with fp32 accumulation and the values between ops kept in the input dtype
(so bf16 activations are rounded after each leaky-relu, as the reference
kernel rounds them, and the weights are cast to bf16).  The kernel is
``csrc/mrf.cu``: one block per (batch row, time tile), every intermediate in
shared memory, one write of the mean; where shared memory leaves a tile that
computes too many halo rows per row kept (C = 128 and 64 on a long
sequence), one launch per dilation step of each ResBlock instead, each
launch's tile fitted to the sequence (:func:`launch_plan`).  It is bound
by operations (2·B·T·126·C² against 2·B·T·C·itemsize bytes) and runs them
on Hopper's warpgroup MMA (``wgmma``, TF32) through the conv core it shares
with the ResBlock1 kernel: as 3xTF32 for fp32 (a documented emulation of
fp32: each operand split into two TF32 values, three products a term), as
one TF32 product a term for bf16, whose operands are exact in bf16 and so
in TF32.  The weights are packed for the kernel's ring at their first call
(``resblock.packed_weights``: two parts for fp32, one for bf16).
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

from emotts_torch.ops import _build
from emotts_torch.ops.resblock import (LRELU_SLOPE, SMS, STEP_OVERHEAD, chain_cost,
                                       chain_fits, chain_halo, check_block_params,
                                       conv1d_btc, device_sms, fit_pass, fit_tile,
                                       packed_weights, pass_rows, tile_for, z_offset)

# number of times the wrapper launched the CUDA kernel
launch_count = 0

SUPPORTED_CHANNELS = (32, 64, 128)
MAX_RESBLOCKS = 4

BlockParams = Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]


def stage_tile(channels: int, kernel_sizes: Sequence[int],
               dilations: Sequence[int], parts: int = 2) -> int:
    """The tile for which window and intermediate fit in shared memory beside
    the weight ring (the running sum over the ResBlocks is kept in device
    memory), fitted to the core's passes for a long sequence (``fit_pass``)."""
    tile, _ = _whole_stage(channels, tuple(kernel_sizes), tuple(dilations), parts)
    if tile < 8:
        raise ValueError(
            f"MRF stage with C={channels}, kernels {tuple(kernel_sizes)}, "
            f"dilations {tuple(dilations)} does not fit in shared memory"
        )
    return tile


def _stage_cost(kernel_sizes, dilations):
    return lambda t, s: sum(chain_cost(k, dilations, t, s) for k in kernel_sizes)


@functools.lru_cache(maxsize=None)
def _stage_fit(channels, kernel_sizes, dilations, parts):
    """(tile_for, fit_pass) of the whole stage in one launch."""
    halo = max(chain_halo(k, dilations) for k in kernel_sizes)
    z_off = min(z_offset(k, dilations, halo) for k in kernel_sizes)
    tile = tile_for(channels, halo, z_off)
    step = pass_rows(channels, parts)
    cost = _stage_cost(kernel_sizes, dilations)
    return tile, fit_pass(tile, lambda t: cost(t, step))


def _whole_stage(channels, kernel_sizes, dilations, parts, rows=0, length=0, sms=SMS):
    """fit_tile of the whole stage in one launch."""
    return fit_tile(*_stage_fit(channels, kernel_sizes, dilations, parts),
                    _stage_cost(kernel_sizes, dilations), pass_rows(channels, parts),
                    rows, length, sms)


@functools.lru_cache(maxsize=1024)
def launch_plan(channels: int, kernel_sizes: Tuple[int, ...], dilations: Tuple[int, ...],
                parts: int = 2, rows: int = 0, length: int = 0, sms: int = SMS
                ) -> Tuple[Tuple[Optional[int], Optional[int], int], ...]:
    """How a stage over ``rows`` sequences of ``length`` rows (0: long
    enough to fill the card) with ``parts`` weight parts (2: fp32, 1: bf16)
    is cut into launches: ``((None, None, tile),)`` for the whole stage in
    one launch, or ``((resblock, step, tile), ...)`` for one launch per
    dilation step of each ResBlock, each with the halo of that step only
    (r·d + r rows a side), every tile fitted by ``fit_tile``.  The one
    launch recomputes each step's halo for the steps after it, the nine
    send each step's result through device memory: whichever takes less
    time, the steps' time taken ``STEP_OVERHEAD`` times.  For a long fp32
    sequence that is nine launches at C = 128 and 64 (the whole stage's
    passes 3.07 and 1.45 times the steps') and one at C = 32 (1.24); a
    short sequence takes shorter tiles, and on a stream's window (one row
    of 49-66 frames) the whole stage then goes in one launch at every C."""
    kernel_sizes, dilations = tuple(kernel_sizes), tuple(dilations)
    step = pass_rows(channels, parts)
    whole, whole_time = _whole_stage(channels, kernel_sizes, dilations, parts,
                                     rows, length, sms)
    plan, steps_time = [], 0.0
    for rb, k in enumerate(kernel_sizes):
        for j, d in enumerate(dilations):
            tile, time = fit_tile(*chain_fits(channels, k, (d,), parts),
                                  lambda t, s, k=k, d=d: chain_cost(k, (d,), t, s),
                                  step, rows, length, sms)
            if not tile:
                raise ValueError(
                    f"MRF stage with C={channels}, k={k}, d={d} does not fit "
                    "in shared memory")
            plan.append((rb, j, tile))
            steps_time += time
    if whole and whole_time <= STEP_OVERHEAD[parts] * steps_time:
        return ((None, None, whole),)
    return tuple(plan)


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
    # the kernel reads the weights packed for its ring: with bf16 activations
    # the reference casts them to bf16, and values exact in bf16 take one
    # TF32 part; fp32 weights take two (3xTF32)
    dt = x.dtype
    params = [
        tuple(packed_weights(w, 1 if is_bf16 else 2, dt) if i % 2 == 0 else w
              for i, w in enumerate(block))
        for block in params
    ]
    plan = launch_plan(c, kernel_sizes, dilations, 1 if is_bf16 else 2, b, t,
                       device_sms(x.device.index))
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
