#!/usr/bin/env python3
"""Where the fp32 attention kernels' time goes, on one GPU.

    python3 tools/profile_attention_f32.py

Compiles ``csrc/attention.cu`` and ``csrc/attention_bwd.cu`` once more with
``-Xptxas -v`` and prints each fp32 kernel instance's registers and spills
at D = 192; then, at the fp32 backward's shapes of ``chip_smoke.py``
(rate 0), the device time of each kernel a call launches (the dq and the
dkv kernel, and the forward) beside the kernels of SDPA's backward on the
same inputs (gradients of one retained forward), from a ``torch.profiler``
trace of 10 calls.  Prints one JSON line per shape.  Needs one GPU and nvcc.
"""

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
SHAPES = [(8, 512, 192), (16, 1024, 192), (3, 200, 192)]  # (B, T, D), 2 heads


def ptxas_usage(name, out_dir):
    """(kernel, registers, spill stores, spill loads) of the D = 192 fp32
    kernels of one source, from ptxas' report."""
    cmd = [_build.find_nvcc(), *_build.NVCC_FLAGS, "-Xptxas", "-v",
           "-o", os.path.join(out_dir, f"{name}.so"), str(_build.CSRC_DIR / f"{name}.cu")]
    res = subprocess.run(cmd, capture_output=True, text=True, check=True)
    out = res.stdout + res.stderr
    rows, kernel, spills = [], None, None
    for line in out.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            kernel = m.group(1) if "f32" in m.group(1) and "ILi192" in m.group(1) else None
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if kernel and m:
            spills = (int(m.group(1)), int(m.group(2)))
        m = re.search(r"Used (\d+) registers", line)
        if kernel and m:
            rows.append(dict(kernel=kernel, registers=int(m.group(1)),
                             spill_bytes=spills))
            kernel = None
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
    if not torch.cuda.is_available():
        sys.exit("needs a GPU")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True)
    print(card.stdout.strip(), flush=True)
    with tempfile.TemporaryDirectory() as tmp:
        for name in ("attention", "attention_bwd"):
            for row in ptxas_usage(name, tmp):
                print(json.dumps(row), flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", 0)
    gen = torch.Generator().manual_seed(SEED)
    for b, t, d in SHAPES:
        q, k, v, dout = (torch.randn(b, t, 2, d, generator=gen).to(dev) for _ in range(4))
        lens = torch.randint(1, t + 1, (b,), generator=gen)
        lens[0], lens[1] = t, 0
        bias = ((torch.arange(t)[None, :] >= lens[:, None]).float() * -1e9).to(dev)
        _, stats = A.attention_forward(q, k, v, bias, want_stats=True)

        def ours():
            A.attention_forward(q, k, v, bias)
            A.attention_backward(q, k, v, bias, None, stats, dout)

        qh, kh, vh = (x.transpose(1, 2).detach().requires_grad_() for x in (q, k, v))
        out = F.scaled_dot_product_attention(qh, kh, vh, attn_mask=bias[:, None, None, :])

        def library_backward():
            torch.autograd.grad(out, (qh, kh, vh), dout.transpose(1, 2), retain_graph=True)

        print(json.dumps(dict(shape=[b, t, 2, d], kernels_ms=kernel_ms(ours),
                              library_backward_kernels_ms=kernel_ms(library_backward))),
              flush=True)


if __name__ == "__main__":
    main()
