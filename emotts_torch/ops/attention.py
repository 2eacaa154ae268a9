"""Fused self-attention for the FFT blocks — CUDA kernel, wrapper, plain version.

Replaces the Pallas TPU kernel ``_fwd_kernel`` of ``emotts/ops/attention.py``
(reached through ``fused_attention``).  Per (batch, head):

    S = Q Kᵀ / √D + bias[key]          bias: 0.0 valid, -1e9 padded (additive)
    P = softmax(S) in fp32, cast to the compute dtype
    O = P V with fp32 accumulation, cast to the compute dtype

The kernel is ``csrc/attention.cu``: one block per (batch, head, 64-query
tile), an online softmax over 64-key tiles, nothing of size T×T in device
memory, the module's own (B, T, H, D) layout read with strides.  It is bound
by operations (4·B·H·T²·D against 8·B·T·H·D·itemsize bytes) and in this first
version runs them on the fp32 FMA units; see the note at the top of the
source for what that costs and what comes next.

Only the forward at dropout rate 0 exists so far (inference).  The backward
kernel and in-kernel dropout come with training.
"""

from __future__ import annotations

import ctypes
import math

import torch

from emotts_torch.ops import _build

# number of times the wrapper launched the CUDA kernel
launch_count = 0

_SUPPORTED_D = (32, 64, 96, 128, 192, 256)


def fused_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          bias: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of the same function, same rounding points as
    the reference kernel: fp32 scores and softmax, P cast to the input dtype,
    P V accumulated in fp32 (the products of two bf16 values are exact in
    fp32, so widening first is the same arithmetic).

    q, k, v: (B, T, H, D); bias: (B, T) fp32.  Returns (B, T, H, D)."""
    d = q.shape[-1]
    scale = 1.0 / float(math.sqrt(d))
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    s = s + bias.float()[:, None, None, :]
    p = torch.softmax(s, dim=-1).to(q.dtype)
    o = torch.einsum("bhqk,bkhd->bqhd", p.float(), v.float())
    return o.to(q.dtype)


def _lib():
    lib = _build.load("attention")
    fn = lib.emotts_attention_fwd
    if not fn.argtypes:
        fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return fn


def fused_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    bias: torch.Tensor, rate: float = 0.0) -> torch.Tensor:
    """Fused multi-head self-attention.

    q, k, v: (B, T, H, D) in the compute dtype (fp32 or bf16); bias: (B, T)
    additive fp32 key bias (0.0 valid, -1e9 pad) broadcast over queries and
    heads.  Returns (B, T, H, D).  CUDA tensors go through the kernel (or
    raise); CPU tensors take the plain version.
    """
    if rate > 0.0:
        raise NotImplementedError(
            "fused_attention: dropout (rate > 0) belongs to the training "
            "path, whose kernels are not ported yet"
        )
    if q.dim() != 4 or q.shape != k.shape or q.shape != v.shape:
        raise ValueError(f"q, k, v must share one (B, T, H, D) shape, got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}")
    b, t, h, d = q.shape
    if bias.shape != (b, t):
        raise ValueError(f"bias must be (B, T) = {(b, t)}, got {tuple(bias.shape)}")
    if not (q.dtype == k.dtype == v.dtype):
        raise ValueError("q, k, v must share one dtype")
    if not (q.device == k.device == v.device == bias.device):
        raise ValueError("q, k, v, bias must lie on one device")
    if q.device.type == "cpu":
        return fused_attention_plain(q, k, v, bias)
    if q.device.type != "cuda":
        raise ValueError(f"unsupported device {q.device}")
    if q.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"kernel takes float32 or bfloat16, got {q.dtype}")
    if d not in _SUPPORTED_D:
        raise ValueError(f"kernel takes head dim in {_SUPPORTED_D}, got {d}")
    if bias.dtype != torch.float32:
        raise ValueError(f"bias must be float32, got {bias.dtype}")
    for name, x in (("q", q), ("k", k), ("v", v), ("bias", bias)):
        if not x.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    out = torch.empty_like(q)
    fn = _lib()
    global launch_count
    with torch.cuda.device(q.device):
        code = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), bias.data_ptr(),
                  out.data_ptr(), b, t, h, d, int(q.dtype == torch.bfloat16),
                  torch.cuda.current_stream().cuda_stream)
    _build.check(code, "emotts_attention_fwd")
    launch_count += 1
    return out
