"""Fused HiFi-GAN ResBlock1 — CUDA kernel, wrapper, plain version.

Replaces the Pallas TPU kernel ``_kernel`` of ``emotts/ops/resblock.py``
(reached through ``fused_resblock1``).  Per dilation d:

    x += c2(lrelu(c1(lrelu(x), d))),   slope 0.1, zero padding,

fp32 throughout; bf16 activations are widened on load and rounded once on
store.  The kernel is ``csrc/resblock.cu``: one block per (batch row, time
tile) keeps the tile and its halo in shared memory through the chain and
forces rows outside [0, T) to zero after both convs of every step.  It is
bound by operations (2·B·T·6k·C² against 2·B·T·C·itemsize bytes) and runs
them on Hopper's warpgroup MMA (``wgmma``, TF32, A from registers) as
3xTF32: each operand split into two TF32 values and three products a term,
a documented emulation of fp32 that keeps the result within the fp32
tolerance of the plain version.

The weights' split is done here, once a weight tensor (:func:`packed_weights`
keeps it until the tensor changes): :func:`pack_weights` hands
the kernel hi = tf32(w) and lo = tf32(w - hi), rounded as ``cvt.rna``
rounds, in the order and swizzle in which the kernel's weight ring reads
them (one bulk copy a stage).  This module also mirrors the kernels'
shared-memory geometry (``ring_floats``, ``row_floats``, ``pass_rows``,
``tile_for``, ``chain_cost``), and plans the launches of both vocoder
kernels from it (:func:`fit_tile`, :func:`launch_plan`): a whole chain in
one launch, or one launch per dilation step where the window of the whole
chain leaves no tile that computes few rows per row kept (C = 256), each
launch's tile fitted to the sequence, so that a short one still spreads
over the card's SMs.
"""

from __future__ import annotations

import ctypes
import functools
import math
from typing import Callable, Dict, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch.utils.weak import WeakTensorKeyDictionary

from emotts_torch.ops import _build

LRELU_SLOPE = 0.1

# number of times the wrapper launched the CUDA kernel
launch_count = 0

SMEM_FLOATS = 232448 // 4  # dynamic shared memory a block may use on sm_90
SUPPORTED_CHANNELS = (32, 64, 128, 256)
MAX_TILE = 512
M_TILE = 64  # rows of one wgmma accumulator tile (m64)
SMS = 132  # streaming multiprocessors of an H100 SXM (the wrappers ask the card)


# The shared-memory geometry of csrc/resblock_common.cuh (ring_stages,
# stage_bytes, ring_bytes, row_floats, ConvGeom): a ring of weight stages,
# each one 128-byte row for each of the C outputs (two at C <= 64), 1024-byte
# aligned (up to 1008 bytes of slack), with a full and an empty mbarrier (16
# bytes) a stage; and activation rows of C floats.
def ring_stages(channels: int) -> int:
    """Stages of the kernels' weight ring."""
    return 2 if channels >= 256 else 4


def ring_floats(channels: int) -> int:
    """Floats of dynamic shared memory the kernels' weight ring takes, its
    alignment and barriers included."""
    stage = (2 if channels <= 64 else 1) * channels * 128
    return (1024 + ring_stages(channels) * (stage + 16)) // 4


def row_floats(channels: int) -> int:
    """Row stride of the activation buffers, in floats."""
    return channels


def pass_rows(channels: int, parts: int = 2) -> int:
    """Rows of one pass of the conv core over a conv's weights (ConvGeom in
    csrc/resblock_common.cuh): each warpgroup holds 64 accumulator registers
    a thread, so 128 / N m64 tiles of N accumulator columns.  At C = 256 the
    two warpgroups split the 256 columns over one m64 tile; below, each
    takes all C columns (2C at C <= 64 with two weight parts, stacked) of
    its own tiles: 128 rows a pass at C = 128 and at C = 64 with two parts,
    256 at C = 64 with one and at C = 32 with two, 512 at C = 32 with one."""
    columns = min(channels, 128) * (2 if stacked(channels, parts) else 1)
    warpgroups_along_m = 2 if channels <= 128 else 1
    return M_TILE * warpgroups_along_m * (128 // columns)


# The packed weights the kernels read (csrc/resblock_common.cuh, "B is split
# once"): per (tap, chunk of input channels) one ring stage of rows of 32
# floats, each part's channels permuted within 16 as the core's A fragments
# take them, and each row's 16-byte chunks swizzled (chunk q at q ^ (row %
# 8), the row counted in the stage).  One part: C rows (outputs) of 32
# channels.  Two parts at C >= 128: C rows of 16 channels, TF32 hi then lo
# side by side in a row.  Two parts at C <= 64 (stacked): 32 channels, the
# hi part's C rows then the lo part's.  Position p of 16 channels holds
# channel _PERM16[p]: k8 step p // 8, fragment column c = p % 8 is channel
# 4c + 2s (c < 4) or 4(c - 4) + 2s + 1.
_PERM16 = [4 * (p % 8) + 2 * (p // 8) if p % 8 < 4 else 4 * (p % 8 - 4) + 2 * (p // 8) + 1
           for p in range(16)]
_pack_index: Dict[Tuple[int, int, str], torch.Tensor] = {}


def stacked(channels: int, parts: int) -> bool:
    """Whether the weights' parts are stacked as rows (ConvGeom::STACK)."""
    return parts == 2 and channels <= 64


def _packed_source_index(channels: int, parts: int, device) -> torch.Tensor:
    """For each float of one tap's packed weights (chunk, row, 32), its
    index in that tap's (part, in, out) weights."""
    key = (channels, parts, str(device))
    idx = _pack_index.get(key)
    if idx is None:
        c = channels
        rows = c * parts if stacked(c, parts) else c
        kc = 32 if stacked(c, parts) else 32 // parts
        q = torch.arange(c // kc).view(-1, 1, 1)   # chunk of input channels
        row = torch.arange(rows).view(1, -1, 1)    # row of the stage
        p = torch.arange(32).view(1, 1, -1)        # float of the row
        lp = 4 * ((p // 4) ^ (row % 8)) + p % 4    # before the swizzle
        if stacked(c, parts):
            part, n, u = row // c, row % c, lp
        else:
            part, n, u = lp // kc, row, lp % kc
        perm = torch.tensor(_PERM16)
        ci = q * kc + 16 * (u // 16) + perm[u % 16]
        idx = (part * c * c + ci * c + n).reshape(-1)
        _pack_index[key] = idx = idx.to(device)
    return idx


def tf32_rna(x: torch.Tensor) -> torch.Tensor:
    """fp32 -> TF32 (10 mantissa bits) to nearest, ties away from zero, as
    ``cvt.rna.tf32.f32`` rounds: integer operations on the fp32 bits."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


def pack_weights(w: torch.Tensor, parts: int) -> torch.Tensor:
    """Weights (..., k, C_in, C_out) fp32 in (tap, in, out) order -> the
    kernels' packed form (..., k, stages, rows, 32), one ring stage of rows
    a (tap, chunk of input channels): with two parts hi = tf32(w) and
    lo = tf32(w - hi) (3xTF32), with one the values as they are (the bf16
    MRF instance: exact in bf16, so in TF32).  Torch operations on w's
    device."""
    *lead, k, c, c_out = w.shape
    if c != c_out or c % 32 or parts not in (1, 2):
        raise ValueError(f"cannot pack {tuple(w.shape)} in {parts} parts")
    w = w.float()
    if parts == 2:
        hi = tf32_rna(w)
        w = torch.stack([hi, tf32_rna(w - hi)], dim=-3)
    src = w.reshape(*lead, k, parts * c * c)
    out = src.index_select(-1, _packed_source_index(c, parts, w.device))
    rows = c * parts if stacked(c, parts) else c
    return out.view(*lead, k, c * c * parts // (32 * rows), rows, 32)


# the packed form of each weight tensor a wrapper was given, kept beside it
# (weakly) with what it was packed from: see packed_weights
_packed = WeakTensorKeyDictionary()


def packed_weights(w: torch.Tensor, parts: int, dtype: torch.dtype = torch.float32
                   ) -> torch.Tensor:
    """``pack_weights(w.to(dtype), parts)``, packed once and kept beside ``w``
    until ``w`` changes: a module's weights are packed at their first call,
    not at every call (on a short sequence the packing's small launches cost
    more host time than the kernel).  A change is seen by ``w``'s storage
    and its version counter, which every in-place operation on ``w`` moves;
    a write that bypasses it (through ``w.data``, or a collective such as
    ``dist.broadcast``, which does not move it) must be followed by
    ``torch.autograd.graph.increment_version(w)``, as
    ``parallel/mesh.py::replicate`` does."""
    key = (w._version, w.data_ptr(), parts, dtype)
    hit = _packed.get(w)
    if hit is not None and hit[0] == key:
        return hit[1]
    with torch.no_grad():
        packed = pack_weights(w.to(dtype), parts)
    _packed[w] = (key, packed)
    return packed


def unpack_weights(packed: torch.Tensor, parts: int) -> Tuple[torch.Tensor, ...]:
    """The inverse of :func:`pack_weights`: its parts, each (..., k, C_out,
    C_in) in (tap, out, in) order."""
    *lead, k, chunks, rows, row = packed.shape
    c = math.isqrt(chunks * rows * row // parts)  # a tap holds parts · C² floats
    flat = packed.reshape(*lead, k, parts * c * c)
    src = torch.empty_like(flat)
    src[..., _packed_source_index(c, parts, packed.device)] = flat
    src = src.view(*lead, k, parts, c, c).transpose(-1, -2)
    return tuple(src[..., i, :, :] for i in range(parts))


def chain_halo(kernel_size: int, dilations: Sequence[int]) -> int:
    """One-sided receptive field of the chained block (no rounding: the 8-row
    rounding of the TPU version is a DMA constraint of that hardware)."""
    r = (kernel_size - 1) // 2
    return sum(r * d + r for d in dilations)


def chain_cost(kernel_size: int, dilations: Sequence[int], tile: int,
               step: int) -> int:
    """Rows × taps the convs of one chain compute for one tile, as
    resblock_chain in csrc/resblock_common.cuh runs it (chain_convs: conv1 of
    a step over the rows that later steps still need plus r a side, conv2
    over those rows), each conv's rows rounded up to whole ``step`` rows.
    With ``step`` = M_TILE it counts the m64 tiles the core computes: over
    ``len(dilations) · 2 · k · tile`` the design's computed rows per row
    kept.  With ``step`` = :func:`pass_rows` it counts whole passes, which
    is what a block's time follows: a pass that its conv fills only in part
    takes about as long as a full one."""
    r = (kernel_size - 1) // 2
    rem = chain_halo(kernel_size, dilations)
    rows = 0
    for d in dilations:
        rem -= r * d + r
        for n in (tile + 2 * (rem + r), tile + 2 * rem):
            rows += -(-n // step) * step
    return rows * kernel_size


def tile_for(channels: int, halo: int, z_offset: int = 0) -> int:
    """Largest tile (rows) whose window (tile + 2·halo rows) and
    intermediate (the window less ``z_offset`` rows a side, see ``z_offset``
    in csrc/resblock_common.cuh) fit in shared memory beside the weight ring;
    0 if none does."""
    rows = (SMEM_FLOATS - ring_floats(channels)) // row_floats(channels)
    tile = min((rows - 4 * halo + 2 * z_offset) // 2, MAX_TILE)
    return max(tile, 0)


def fit_pass(tile: int, cost_of: Callable[[int], int]) -> int:
    """The tile (at most ``tile`` rows, at least a third of it) for which
    the conv core takes the least time per row kept on a sequence long
    enough to fill the card many times over: ``cost_of(t)`` is what one
    block of a t-row tile costs (:func:`chain_cost` in whole passes, so that
    a tile whose convs just fill their last pass beats a longer one that
    starts another); on a tie the longer tile; 0 if ``tile`` < 8."""
    if tile < 8:
        return 0
    best, best_cost = tile, cost_of(tile) / tile
    for t in range(tile - 1, tile // 3 - 1, -1):
        if t >= 8 and cost_of(t) / t < best_cost - 1e-12:
            best, best_cost = t, cost_of(t) / t
    return best


def fit_tile(tile: int, long_tile: int, cost_of: Callable[[int, int], int], step: int,
             rows: int = 0, length: int = 0, sms: int = SMS) -> Tuple[int, float]:
    """The tile (8 to ``tile`` rows) for which one launch over ``rows``
    sequences of ``length`` rows takes the least time, and that time, in
    one block's pass rows × taps.  ``cost_of(t, s)`` is what one block of a
    t-row tile computes, each conv's rows rounded up to ``s``
    (:func:`chain_cost`); a block's time follows its whole passes (``s`` =
    ``step``).  ``long_tile`` is :func:`fit_pass`'s tile, the best per row
    kept: without a sequence (``length`` 0) it is the answer, its time per
    row kept.  With one, the kernels run one block an SM, so rows·⌈length/t⌉
    blocks take that many waves of ``sms`` blocks, each as long as one
    block; where ``long_tile`` leaves SMs idle, a shorter tile that spreads
    the blocks over more of them takes less.  On a tie the fewer m64 tiles
    a block (the core skips those of a pass past its conv), then the longer
    tile."""
    if not long_tile:
        return 0, math.inf
    if not length:
        return long_tile, cost_of(long_tile, step) / long_tile

    def waves(t):
        return -(-rows * -(-length // t) // sms)

    def key(t):
        return waves(t) * cost_of(t, step), waves(t) * cost_of(t, M_TILE), -t

    def longest_alike(t):
        # the longest tile whose blocks cost what t's do (costs grow with
        # the rows): as many waves or fewer
        lo, hi, same = t, tile, (cost_of(t, step), cost_of(t, M_TILE))
        while lo < hi:
            mid = (lo + hi + 1) // 2
            if (cost_of(mid, step), cost_of(mid, M_TILE)) == same:
                lo = mid
            else:
                hi = mid - 1
        return lo

    best = min(long_tile, -(-length // 8) * 8)
    best_key = key(best)
    # for w waves the shortest tile that needs no more, lengthened
    for w in range(1, min(waves(best), 8) + 1):
        tiles_a_row = w * sms // rows
        t = max(8, -(-length // tiles_a_row)) if tiles_a_row else best
        if t < best:
            t = longest_alike(t)
            if key(t) < best_key:
                best, best_key = t, key(t)
    return best, best_key[0]


def z_offset(kernel_size: int, dilations: Sequence[int], halo: int) -> int:
    """Rows a side of the window that a chain's intermediate never holds."""
    r = (kernel_size - 1) // 2
    return halo - chain_halo(kernel_size, dilations) + r * dilations[0]


# A plan of one launch per dilation step moves each step's result through
# device memory and back, and launches a kernel for each: its time is about
# this much over its passes' (fit_tile), against one launch that recomputes
# the later steps' halo instead (both kernels: ops/mrf.py::launch_plan and
# launch_plan below).  Measured on an H100 (tools/probe_vocoder_core.py, the
# MRF stage at 16 rows of 1024 frames, PERF.md): with two weight parts
# (3xTF32) 1.31-1.36 at C = 128, 64 and 32; with one (bf16) 1.43-1.60, its
# passes cheaper for the same traffic: 1.6 puts the bf16 C = 64 stage, whose
# one launch has 1.57 times the passes of nine, in one launch (28.6 against
# 29.1 ms).
STEP_OVERHEAD = {2: 1.35, 1: 1.6}


@functools.lru_cache(maxsize=None)
def device_sms(index: int) -> int:
    """Streaming multiprocessors of CUDA device ``index``."""
    return torch.cuda.get_device_properties(index).multi_processor_count


@functools.lru_cache(maxsize=None)
def chain_fits(channels: int, kernel_size: int, dilations: Tuple[int, ...],
               parts: int = 2) -> Tuple[int, int]:
    """(tile_for, fit_pass) of a chain over ``dilations`` in one launch: the
    longest tile shared memory takes, and the best per row kept."""
    step = pass_rows(channels, parts)
    halo = chain_halo(kernel_size, dilations)
    tile = tile_for(channels, halo, z_offset(kernel_size, dilations, halo))
    return tile, fit_pass(tile, lambda t: chain_cost(kernel_size, dilations, t, step))


@functools.lru_cache(maxsize=1024)
def launch_plan(channels: int, kernel_size: int, dilations: Tuple[int, ...],
                rows: int = 0, length: int = 0, sms: int = SMS
                ) -> Tuple[Tuple[int, int, int], ...]:
    """How a block over ``rows`` sequences of ``length`` rows (0: long
    enough to fill the card) is cut into launches: ``((first, last, tile),
    ...)`` over dilation steps ``[first, last)``, each launch's tile fitted
    by :func:`fit_tile`.  The whole chain in one launch, or one launch per
    step with the halo of that step only (at C = 256 the window of a whole
    chain leaves no room for a long tile), whichever takes less time, the
    steps' time taken STEP_OVERHEAD times."""
    dilations = tuple(dilations)
    step = pass_rows(channels, 2)

    def fit(dils):
        return fit_tile(*chain_fits(channels, kernel_size, dils),
                        lambda t, s: chain_cost(kernel_size, dils, t, s),
                        step, rows, length, sms)

    whole, whole_time = fit(dilations)
    plan, steps_time = [], 0.0
    for i, d in enumerate(dilations):
        tile, time = fit((d,))
        if not tile:
            raise ValueError(
                f"ResBlock1 with C={channels}, k={kernel_size}, d={d} does "
                "not fit in shared memory"
            )
        plan.append((i, i + 1, tile))
        steps_time += time
    if whole and whole_time <= STEP_OVERHEAD[2] * steps_time:
        return ((0, len(dilations), whole),)
    return tuple(plan)


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
    the kernel (or raise), its weights packed on the card at their first
    call (:func:`packed_weights`); CPU tensors take the plain version."""
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
    # the kernel reads the weights split and packed for its ring (3xTF32 in
    # both instances: after the first step the residual is an fp32 sum)
    w1, w2 = (packed_weights(w, 2) for w in (w1, w2))
    for first, last, tile in launch_plan(c, k, dilations, b, t, device_sms(x.device.index)):
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
