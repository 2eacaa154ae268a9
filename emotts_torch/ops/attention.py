"""Fused self-attention for the FFT blocks — CUDA kernels, wrappers, plain versions.

Replaces the Pallas TPU kernels ``_fwd_kernel`` and ``_bwd_kernel`` of
``emotts/ops/attention.py`` (reached through ``fused_attention`` and its
custom VJP).  Per (batch, head):

    S   = Q Kᵀ / √D + bias[key]        bias: 0.0 valid, -1e9 padded (additive)
    P   = softmax(S) in fp32, cast to the compute dtype
    P_d = keep ? P / (1 - rate) : 0    dropout on the probabilities (training)
    O   = P_d V with fp32 accumulation, cast to the compute dtype

and backward, with every product accumulated in fp32:

    dV = P_dᵀ dO ;  dP = keep ? (dO Vᵀ) / (1 - rate) : 0
    dS = P ⊙ (dP − rowsum(dP ⊙ P)) · scale, cast to the compute dtype
    dQ = dS K ;  dK = dSᵀ Q

The forward kernel is ``csrc/attention.cu``: one block per (batch, head,
query tile), an online softmax over key tiles.  The backward is
``csrc/attention_bwd.cu``, two launches a call in either dtype, on one
schedule: a delta pass over query tiles, then a fused pass over key tiles
that forms P and dS once per tile pair, keeps dK and dV in registers and
adds each query tile's dQ partial in a fixed key-tile order (bf16: into an
fp32 workspace, the last add rounding into dq; fp32: into dq itself).
Neither uses an atomic whose order varies, so a repeated call gives the
same bits.
Nothing of size T×T reaches device memory either way, and the module's own
(B, T, H, D) layout is read with strides.  When a gradient is wanted the
forward also writes each row's softmax maximum and sum (2·B·H·T floats) and
the backward forms P from them; rowsum(dP ⊙ P) is summed from the same
rounded P in a pass of its own, as the reference sums it.  Both kernels
are bound by operations and run every product on the tensor cores: bf16 on
``wgmma`` (building blocks in ``csrc/wgmma.cuh``), fp32 on ``mma.sync`` with
TF32 operands, each product as three (3×TF32: hi·hi + hi·lo + lo·hi of each
operand split into a TF32 high part and a TF32 remainder), which stays
within the fp32 tolerance where one TF32 product would not; see the notes at
the top of the sources.

The dropout mask is a pure function of (seed[b], head, query, key): Philox4x32-10
keyed by ``seed[b] + head·(−1640531527)`` (int32 wrap-around, the reference's
per-head mix), counter (query, key // 4), word key % 4, kept where the word is
``>= min(int(rate·2³²), 2³²−1)``.  The reference draws from the TPU's own
generator, so the bits differ from its bits; ``philox_keep_mask`` computes the
kernels' bits in PyTorch integer arithmetic, and the plain versions use it, so
kernel and plain version agree value for value at any rate.
"""

from __future__ import annotations

import contextlib
import ctypes
import math
from typing import Optional, Tuple

import torch

from emotts_torch.ops import _build

# number of times the forward wrapper launched its CUDA kernel
launch_count = 0
# number of CUDA launches the backward wrapper made (BWD_LAUNCHES_PER_CALL
# per call)
bwd_launch_count = 0
# the fp32 instances' share of the two counts above
fp32_launch_count = 0
fp32_bwd_launch_count = 0

_SUPPORTED_D = (32, 64, 96, 128, 192, 256)
# CUDA launches of one backward call, the same in both dtypes: the delta pass
# and the fused pass
BWD_LAUNCHES_PER_CALL = 2


def _bwd_query_tile(d: int, bf16: bool) -> int:
    """Queries a step of the fused backward pass (its dQ counters' tiles):
    ``BwdFusedTc::BQ`` and ``BwdFusedF32::BQ`` in ``csrc/attention_bwd.cu``."""
    return 64 if bf16 else (16 if d > 192 else 32)


_HEAD_MIX = -1640531527  # golden-ratio constant decorrelating the heads
_M32 = 0xFFFFFFFF
_PHILOX_M0, _PHILOX_M1 = 0xD2511F53, 0xCD9E8D57
_PHILOX_W0, _PHILOX_W1 = 0x9E3779B9, 0xBB67AE85


def philox4x32_10(counter, key):
    """Philox4x32-10 on int64 tensors holding 32-bit words.

    ``counter``: four broadcastable int64 tensors, ``key``: two.  Returns the
    four output words (int64 tensors in [0, 2³²)).  A 32×32→64-bit product
    wraps in int64; its bit pattern is still the unsigned product's, so the
    low word is a mask and the high word a shift and a mask."""
    c0, c1, c2, c3 = counter
    k0, k1 = key
    for _ in range(10):
        p0 = c0 * _PHILOX_M0
        p1 = c2 * _PHILOX_M1
        hi0, lo0 = (p0 >> 32) & _M32, p0 & _M32
        hi1, lo1 = (p1 >> 32) & _M32, p1 & _M32
        c0, c1, c2, c3 = hi1 ^ c1 ^ k0, lo1, hi0 ^ c3 ^ k1, lo0
        k0 = (k0 + _PHILOX_W0) & _M32
        k1 = (k1 + _PHILOX_W1) & _M32
    return c0, c1, c2, c3


def dropout_threshold(rate: float) -> int:
    """An entry is kept where its random 32-bit word is >= this."""
    return min(int(rate * float(2 ** 32)), 2 ** 32 - 1)


def philox_keep_mask(seeds: torch.Tensor, h: int, t: int, rate: float,
                     device=None) -> torch.Tensor:
    """The kernels' keep-mask, (B, H, T, T) bool, True = kept.

    ``seeds``: (B,) int32 per-example seeds.  Row b depends on ``seeds[b]``
    alone, not on the batch around it."""
    device = seeds.device if device is None else device
    i64 = dict(dtype=torch.int64, device=device)
    key0 = (seeds.to(**i64)[:, None] + torch.arange(h, **i64)[None, :] * _HEAD_MIX) & _M32
    groups = (t + 3) // 4
    zero = torch.zeros((), **i64)
    words = philox4x32_10(
        (torch.arange(t, **i64)[None, None, :, None],
         torch.arange(groups, **i64)[None, None, None, :], zero, zero),
        (key0[:, :, None, None], zero),
    )
    bits = torch.stack(words, dim=-1).reshape(seeds.shape[0], h, t, 4 * groups)
    return bits[..., :t] >= dropout_threshold(rate)


def _wide(x: torch.Tensor) -> torch.Tensor:
    """fp32 for the products' accumulation (float64 stays, for gradcheck)."""
    return x if x.dtype == torch.float64 else x.float()


def _probs(q, k, bias) -> torch.Tensor:
    scale = 1.0 / float(math.sqrt(q.shape[-1]))
    s = torch.einsum("bqhd,bkhd->bhqk", _wide(q), _wide(k)) * scale
    s = s + _wide(bias)[:, None, None, :]
    return torch.softmax(s, dim=-1).to(q.dtype)


def fused_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          bias: torch.Tensor,
                          seeds: Optional[torch.Tensor] = None,
                          rate: float = 0.0) -> torch.Tensor:
    """Plain PyTorch version of the forward, same rounding points as the
    reference kernel: fp32 scores and softmax, P cast to the input dtype,
    kept entries scaled in that dtype, P V accumulated in fp32 (the products
    of two bf16 values are exact in fp32, so widening first is the same
    arithmetic).

    q, k, v: (B, T, H, D); bias: (B, T) fp32.  Returns (B, T, H, D)."""
    p = _probs(q, k, bias)
    if rate > 0.0:
        keep = philox_keep_mask(seeds, q.shape[2], q.shape[1], rate)
        p = torch.where(keep, (_wide(p) * (1.0 / (1.0 - rate))).to(q.dtype),
                        torch.zeros((), dtype=q.dtype, device=q.device))
    o = torch.einsum("bhqk,bkhd->bqhd", _wide(p), _wide(v))
    return o.to(q.dtype)


def fused_attention_bwd_plain(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, bias: torch.Tensor,
    dout: torch.Tensor, seeds: Optional[torch.Tensor] = None, rate: float = 0.0,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of the backward: the five products written out
    with the reference's rounding points (P and dS·scale cast to the input
    dtype before their products, the softmax Jacobian in fp32).  Returns
    (dq, dk, dv), each (B, T, H, D) in the input dtype."""
    dtype = q.dtype
    scale = 1.0 / float(math.sqrt(q.shape[-1]))
    p = _probs(q, k, bias)  # pre-dropout probabilities, in the compute dtype
    p32 = _wide(p)
    do = _wide(dout)
    dpd = torch.einsum("bqhd,bkhd->bhqk", do, _wide(v))
    if rate > 0.0:
        inv_keep = 1.0 / (1.0 - rate)
        keep = philox_keep_mask(seeds, q.shape[2], q.shape[1], rate)
        pd = torch.where(keep, (p32 * inv_keep).to(dtype),
                         torch.zeros((), dtype=dtype, device=q.device))
        dp = torch.where(keep, dpd * inv_keep, torch.zeros_like(dpd))
    else:
        pd, dp = p, dpd
    dv = torch.einsum("bhqk,bqhd->bkhd", _wide(pd), do)
    ds = p32 * (dp - (dp * p32).sum(dim=-1, keepdim=True))
    ds = _wide((ds * scale).to(dtype))
    dq = torch.einsum("bhqk,bkhd->bqhd", ds, _wide(k))
    dk = torch.einsum("bhqk,bqhd->bkhd", ds, _wide(q))
    return dq.to(dtype), dk.to(dtype), dv.to(dtype)


def _entry(name: str, library: str, argtypes):
    fn = getattr(_build.load(library), name)
    if not fn.argtypes:
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return fn


_P, _I = ctypes.c_void_p, ctypes.c_int
_FWD_ARGTYPES = [_P] * 7 + [_I] * 6 + [ctypes.c_uint32, ctypes.c_float, _P]
_BWD_ARGTYPES = [_P] * 14 + [_I] * 6 + [ctypes.c_uint32, ctypes.c_float, _P]


def _check_inputs(q, k, v, bias, seeds, rate, extra=()) -> None:
    """What both wrappers require of their inputs, on any device.  Written
    for few tensor-attribute reads: on the card a short call's wall time is
    this host work."""
    shape = q.shape
    if len(shape) != 4 or k.shape != shape or v.shape != shape:
        raise ValueError(f"q, k, v must share one (B, T, H, D) shape, got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}")
    b, t = shape[0], shape[1]
    if bias.shape != (b, t):
        raise ValueError(f"bias must be (B, T) = {(b, t)}, got {tuple(bias.shape)}")
    if not 0.0 <= rate < 1.0:
        raise ValueError(f"dropout rate must lie in [0, 1), got {rate}")
    others = [k, v] + [x for _, x in extra]
    dtype, device = q.dtype, q.device
    for x in others:
        if x.dtype != dtype or x.shape != shape:
            raise ValueError("q, k, v (and dout) must share one shape and dtype")
    for x in others + [bias]:
        if x.device != device:
            raise ValueError("q, k, v, bias must lie on one device")
    if rate > 0.0:
        if seeds is None:
            raise ValueError("dropout (rate > 0) needs per-example seeds")
        if seeds.shape != (b,) or seeds.dtype != torch.int32:
            raise ValueError(f"seeds must be (B,) = ({b},) int32, got "
                             f"{tuple(seeds.shape)} {seeds.dtype}")
        if seeds.device != device:
            raise ValueError("seeds must lie on the device of q")


def _check_cuda(q, bias, seeds, rate, tensors) -> None:
    """What the kernels take beyond that; raises on anything else."""
    if q.device.type != "cuda":
        raise ValueError(f"unsupported device {q.device}")
    if q.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"kernel takes float32 or bfloat16, got {q.dtype}")
    if q.shape[-1] not in _SUPPORTED_D:
        raise ValueError(f"kernel takes head dim in {_SUPPORTED_D}, got {q.shape[-1]}")
    if bias.dtype != torch.float32:
        raise ValueError(f"bias must be float32, got {bias.dtype}")
    named = list(tensors) + [("bias", bias)]
    if rate > 0.0:
        named.append(("seeds", seeds))
    for name, x in named:
        if not x.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


def _launch_device(x: torch.Tensor):
    """The device context of a launch; nothing to switch when it is current
    (the switch costs host time that a short launch notices)."""
    if x.device.index == torch.cuda.current_device():
        return contextlib.nullcontext()
    return torch.cuda.device(x.device)


def attention_forward(q, k, v, bias, seeds=None, rate: float = 0.0,
                      want_stats: bool = False):
    """The forward wrapper: (out, stats).  ``stats`` is the (2, B, H, T) fp32
    row maxima and sums the backward kernels need, or None when they are not
    asked for or the tensors lie on the CPU (the plain backward recomputes
    the softmax).  CUDA tensors go through the kernel or raise; CPU tensors,
    and only those, take the plain version."""
    _check_inputs(q, k, v, bias, seeds, rate)
    if q.device.type == "cpu":
        return fused_attention_plain(q, k, v, bias, seeds, rate), None
    _check_cuda(q, bias, seeds, rate, [("q", q), ("k", k), ("v", v)])
    b, t, h, d = q.shape
    out = torch.empty_like(q)
    stats = (torch.empty((2, b, h, t), dtype=torch.float32, device=q.device)
             if want_stats else None)
    fn = _entry("emotts_attention_fwd", "attention", _FWD_ARGTYPES)
    drop = rate > 0.0
    global launch_count, fp32_launch_count
    with _launch_device(q):
        code = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), bias.data_ptr(),
                  seeds.data_ptr() if drop else None, out.data_ptr(),
                  None if stats is None else stats.data_ptr(),
                  b, t, h, d, int(q.dtype == torch.bfloat16), int(drop),
                  dropout_threshold(rate), 1.0 / (1.0 - rate),
                  torch.cuda.current_stream().cuda_stream)
    _build.check(code, "emotts_attention_fwd")
    launch_count += 1
    if q.dtype == torch.float32:
        fp32_launch_count += 1
    return out, stats


def attention_backward(q, k, v, bias, seeds, stats, dout, rate: float = 0.0):
    """The backward wrapper: (dq, dk, dv) from the forward's inputs, its row
    statistics, and the output's gradient.  CUDA tensors go through the two
    kernels or raise; CPU tensors take the plain version.  Scratch of both
    dtypes: delta (B, H, T), the keep bits (B, H, ⌈T/32⌉, T) words at rate >
    0 and the dQ adds' counters (B, H, ⌈T/BQ⌉), BQ the fused pass's query
    tile (64 for bf16; 32 for fp32, 16 at D = 256), which the delta pass sets
    to 0.  bf16 also takes the fp32 dQ workspace (64 × D rounded up to whole
    64-column blocks, per (B, H, 64-query tile)); fp32 adds its dQ partials
    into dq itself."""
    _check_inputs(q, k, v, bias, seeds, rate, extra=[("dout", dout)])
    if q.device.type == "cpu":
        return fused_attention_bwd_plain(q, k, v, bias, dout, seeds, rate)
    _check_cuda(q, bias, seeds, rate, [("q", q), ("k", k), ("v", v),
                                       ("dout", dout)])
    b, t, h, d = q.shape
    if (stats is None or stats.shape != (2, b, h, t) or stats.dtype != torch.float32
            or stats.device != q.device or not stats.is_contiguous()):
        raise ValueError("stats must be the contiguous (2, B, H, T) float32 "
                         "tensor the forward kernel wrote")
    dq, dk, dv = torch.empty_like(q), torch.empty_like(q), torch.empty_like(q)
    delta = torch.empty((b, h, t), dtype=torch.float32, device=q.device)
    drop = rate > 0.0
    bf16 = q.dtype == torch.bfloat16
    keep = dq_acc = None
    if drop:  # uint32 words, held as int32
        keep = torch.empty((b, h, (t + 31) // 32, t), dtype=torch.int32, device=q.device)
    if bf16:
        # per 64-query tile, 64 rows of D rounded up to whole 64-column blocks
        dq_acc = torch.empty((b, h, (t + 63) // 64, 64 * ((d + 63) // 64 * 64)),
                             dtype=torch.float32, device=q.device)
    counters = torch.empty((b, h, -(-t // _bwd_query_tile(d, bf16))), dtype=torch.int32,
                           device=q.device)
    fn = _entry("emotts_attention_bwd", "attention_bwd", _BWD_ARGTYPES)
    global bwd_launch_count, fp32_bwd_launch_count
    with _launch_device(q):
        code = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), bias.data_ptr(),
                  seeds.data_ptr() if drop else None,
                  stats.data_ptr(), dout.data_ptr(), dq.data_ptr(),
                  dk.data_ptr(), dv.data_ptr(), delta.data_ptr(),
                  None if keep is None else keep.data_ptr(),
                  None if dq_acc is None else dq_acc.data_ptr(), counters.data_ptr(),
                  b, t, h, d, int(bf16), int(drop),
                  dropout_threshold(rate), 1.0 / (1.0 - rate),
                  torch.cuda.current_stream().cuda_stream)
    _build.check(code, "emotts_attention_bwd")
    bwd_launch_count += BWD_LAUNCHES_PER_CALL
    if q.dtype == torch.float32:
        fp32_bwd_launch_count += BWD_LAUNCHES_PER_CALL
    return dq, dk, dv


class FusedAttention(torch.autograd.Function):
    """forward = the forward kernel, backward = the backward kernels;
    gradients for q, k, v only."""

    @staticmethod
    def forward(ctx, q, k, v, bias, seeds, rate, want_grad):
        out, stats = attention_forward(q, k, v, bias, seeds, rate,
                                       want_stats=want_grad)
        if want_grad:
            ctx.rate = rate
            ctx.save_for_backward(q, k, v, bias, seeds, stats)
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, bias, seeds, stats = ctx.saved_tensors
        # autograd may hand over a strided gradient; the kernels take none
        dq, dk, dv = attention_backward(q, k, v, bias, seeds, stats,
                                        dout.contiguous(), ctx.rate)
        return dq, dk, dv, None, None, None, None


def fused_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    bias: torch.Tensor, seeds: Optional[torch.Tensor] = None,
                    rate: float = 0.0) -> torch.Tensor:
    """Fused multi-head self-attention, differentiable in q, k, v.

    q, k, v: (B, T, H, D) in the compute dtype (fp32 or bf16); bias: (B, T)
    additive fp32 key bias (0.0 valid, -1e9 pad) broadcast over queries and
    heads; seeds: (B,) int32 per-example dropout streams (unused at rate 0).
    Returns (B, T, H, D).  CUDA tensors go through the kernels (or raise);
    CPU tensors take the plain versions.
    """
    want_grad = torch.is_grad_enabled() and (
        q.requires_grad or k.requires_grad or v.requires_grad)
    return FusedAttention.apply(q, k, v, bias, seeds, float(rate), want_grad)


def resolve_fused_attention(flag, device) -> bool:
    """Resolve a config's fused-attention flag (True/False/None).  None takes
    the kernels on a CUDA device and the unfused path elsewhere; it states no
    speed."""
    if flag is not None:
        return bool(flag)
    return torch.device(device).type == "cuda"
