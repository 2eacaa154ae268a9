#!/usr/bin/env python3
"""Where the attention kernels' time goes, on one GPU: fp32 and bf16.

    python3 tools/profile_attention_f32.py [--bf16-only]

Compiles ``csrc/attention.cu`` and ``csrc/attention_bwd.cu`` once more with
``-Xptxas -v`` and prints the registers and spills of every kernel instance
(each head dim, rate 0 and > 0); then, at the fp32 backward's shapes of
``chip_smoke.py`` and at the bf16 backward's (rate 0 and 0.1), the device
time of each kernel a call launches
(the forward and every backward kernel) beside the kernels of SDPA's
backward on the same inputs (gradients of one retained forward; at rate 0.1
SDPA's own dropout, which draws other mask bits), from a ``torch.profiler``
trace of 10 calls.  Prints one JSON line per shape, and first one with the
rate at which the card runs ``mma.sync.m16n8k8`` TF32 products (the fp32
kernels' instruction) from 8 and from 32 warps an SM, each warp issuing
products to 8 accumulators of its own.  Needs one GPU and nvcc.
"""

import argparse
import json
import os
import re
import subprocess
import sys
import tempfile

import torch
import torch.nn.functional as F
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from emotts_torch.ops import _build  # noqa: E402
from emotts_torch.ops import attention as A  # noqa: E402

SEED = 1234
# (dtype, B, T, H, D, rate)
SHAPES = [("float32", 8, 512, 2, 192, 0.0), ("float32", 8, 512, 2, 192, 0.1),
          ("float32", 16, 1024, 2, 192, 0.0), ("float32", 16, 1024, 2, 192, 0.1),
          ("float32", 8, 512, 1, 192, 0.0), ("float32", 3, 200, 2, 192, 0.0),
          ("float32", 8, 250, 2, 256, 0.0),
          ("bfloat16", 16, 1024, 2, 192, 0.0), ("bfloat16", 16, 1024, 2, 192, 0.1),
          ("bfloat16", 16, 1024, 1, 192, 0.0), ("bfloat16", 16, 512, 2, 192, 0.0),
          ("bfloat16", 16, 777, 2, 192, 0.1), ("bfloat16", 8, 144, 2, 192, 0.1)]


def _instance(mangled):
    """(kernel, D, dropout) of a mangled kernel template instance."""
    m = re.search(r"\d+(attention_\w+?_kernel)ILi(\d+)ELb([01])E", mangled)
    return (m.group(1), int(m.group(2)), bool(int(m.group(3)))) if m else None


def ptxas_usage(name, out_dir):
    """Registers and spill bytes of every kernel instance of one source, from
    ptxas' report."""
    cmd = [_build.find_nvcc(), *_build.NVCC_FLAGS, "-Xptxas", "-v",
           "-o", os.path.join(out_dir, f"{name}.so"), str(_build.CSRC_DIR / f"{name}.cu")]
    res = subprocess.run(cmd, capture_output=True, text=True, check=True)
    rows, kernel, spills = [], None, None
    for line in (res.stdout + res.stderr).splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            kernel = _instance(m.group(1))
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if kernel and m:
            spills = (int(m.group(1)), int(m.group(2)))
        m = re.search(r"Used (\d+) registers", line)
        if kernel and m:
            rows.append(dict(kernel=kernel[0], d=kernel[1], dropout=kernel[2],
                             registers=int(m.group(1)), spill_bytes=spills))
            kernel = None
    return rows


_MMA_RATE_SRC = r"""
#include <cuda_runtime.h>
#include <stdint.h>
__global__ void mma_tf32_rate(float* out, int iters) {
  float d[8][4] = {};
  const uint32_t x = 0x3F800000u + (threadIdx.x << 13);  // TF32 values near 1
  const uint32_t a[4] = {x, x ^ 0x2000u, x ^ 0x4000u, x ^ 0x6000u}, b[2] = {x, x ^ 0x8000u};
  for (int i = 0; i < iters; ++i) {
#pragma unroll
    for (int n = 0; n < 8; ++n)
      asm volatile("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
                   "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
                   : "+f"(d[n][0]), "+f"(d[n][1]), "+f"(d[n][2]), "+f"(d[n][3])
                   : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
  }
  float sum = 0.f;
  for (int n = 0; n < 8; ++n) sum += d[n][0] + d[n][1] + d[n][2] + d[n][3];
  out[blockIdx.x * blockDim.x + threadIdx.x] = sum;
}
extern "C" int launch_mma_tf32_rate(float* out, int blocks, int threads, int iters,
                                    void* stream) {
  mma_tf32_rate<<<blocks, threads, 0, (cudaStream_t)stream>>>(out, iters);
  return (int)cudaGetLastError();
}
"""


def mma_rate(out_dir, iters=4096):
    """TFLOP/s of mma.sync.m16n8k8 TF32 on the card: one block an SM of 8 or
    32 warps, 8 accumulators a warp (2048 operations a product)."""
    import ctypes

    src = os.path.join(out_dir, "mma_rate.cu")
    with open(src, "w") as f:
        f.write(_MMA_RATE_SRC)
    lib_path = os.path.join(out_dir, "mma_rate.so")
    subprocess.run([_build.find_nvcc(), *_build.NVCC_FLAGS, "-o", lib_path, src], check=True)
    lib = ctypes.CDLL(lib_path)
    lib.launch_mma_tf32_rate.argtypes = [ctypes.c_void_p] + [ctypes.c_int] * 3 + [ctypes.c_void_p]
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    rows = []
    for warps in (8, 32):
        out = torch.empty(sms * warps * 32, device="cuda")
        stream = torch.cuda.current_stream().cuda_stream

        def run():
            code = lib.launch_mma_tf32_rate(out.data_ptr(), sms, warps * 32, iters, stream)
            if code:
                raise RuntimeError(f"mma_rate launch failed: {code}")

        run()
        torch.cuda.synchronize()
        start, stop = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        start.record()
        run()
        stop.record()
        torch.cuda.synchronize()
        ms = start.elapsed_time(stop)
        ops = sms * warps * iters * 8 * 2048
        rows.append(dict(warps_per_sm=warps, ms=ms, tflops=ops / (ms * 1e-3) / 1e12))
    return rows


def kernel_ms(fn, calls=10):
    """Mean device ms per call of each kernel that ``fn`` launches."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    return {e.key[:96]: e.self_device_time_total / calls / 1e3
            for e in prof.key_averages() if e.device_type == DeviceType.CUDA}


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--bf16-only", action="store_true",
                    help="only the bf16 instances and shapes")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("needs a GPU")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True)
    print(card.stdout.strip(), flush=True)
    with tempfile.TemporaryDirectory() as tmp:
        print(json.dumps(dict(mma_sync_tf32=mma_rate(tmp))), flush=True)
        for name in ("attention", "attention_bwd"):
            for row in ptxas_usage(name, tmp):
                if not (args.bf16_only and "f32" in row["kernel"]):
                    print(json.dumps(row), flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", 0)
    gen = torch.Generator().manual_seed(SEED)
    for dtype, b, t, h, d, rate in SHAPES:
        if args.bf16_only and dtype == "float32":
            continue
        q, k, v, dout = (torch.randn(b, t, h, d, generator=gen).to(dev, getattr(torch, dtype))
                         for _ in range(4))
        lens = torch.randint(1, t + 1, (b,), generator=gen)
        lens[0], lens[1] = t, 0
        bias = ((torch.arange(t)[None, :] >= lens[:, None]).float() * -1e9).to(dev)
        seeds = torch.randint(-2 ** 31, 2 ** 31, (b,), generator=gen).to(dev, torch.int32)
        _, stats = A.attention_forward(q, k, v, bias, seeds, rate, want_stats=True)

        def ours():
            A.attention_forward(q, k, v, bias, seeds, rate)
            A.attention_backward(q, k, v, bias, seeds, stats, dout, rate)

        qh, kh, vh = (x.transpose(1, 2).detach().requires_grad_() for x in (q, k, v))
        out = F.scaled_dot_product_attention(qh, kh, vh, attn_mask=bias[:, None, None, :].to(q.dtype),
                                             dropout_p=rate)

        def library_backward():
            torch.autograd.grad(out, (qh, kh, vh), dout.transpose(1, 2), retain_graph=True)

        print(json.dumps(dict(dtype=dtype, shape=[b, t, h, d], rate=rate,
                              kernels_ms=kernel_ms(ours),
                              library_backward_kernels_ms=kernel_ms(library_backward))),
              flush=True)
        del q, k, v, dout, stats, qh, kh, vh, out
        torch.cuda.empty_cache()


if __name__ == "__main__":
    main()
