#!/usr/bin/env python3
"""Probe where the vocoder kernels' time goes, on one GPU.

    python3 tools/probe_vocoder_core.py

Builds variants of the conv core (``emotts_torch/csrc/resblock_common.cuh``,
each a text substitution in a copy of ``csrc/`` under a temporary
directory), loads each variant's `mrf` and `resblock` libraries in turn into
this process, and times ``chip_smoke.py``'s fp32 main-path vocoder cases (and
the bf16 MRF stage at C = 128) with each, twice, in the order of VARIANTS and
then reversed.  Every case reports its largest error against the plain
version, so that a probe whose results are wrong on purpose says so.

    as_is          the core as it stands
    no_products    the mma.sync calls compiled out: what the rest costs
                   (results wrong)
    one_product    one TF32 product a term in the fp32 instances instead of
                   three (results outside the fp32 tolerance)
    int_rounding   cvt.rna.tf32.f32 replaced by the same rounding done with
                   integer operations (equal results for finite values)
    whole_stage    every MRF stage in one launch (``ops/mrf.py::launch_plan``
                   overridden; the C = 128 stage otherwise runs per step)
    every_step     every MRF stage as one launch per dilation step of each
                   ResBlock (the C = 64 and 32 stages otherwise run whole)

Prints one JSON line per case with each variant's times in ms, then the card
line.  Needs one GPU and nvcc.
"""

import ctypes
import json
import os
import shutil
import subprocess
import sys
import tempfile

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

SEED = 1234
CVT = 'asm("cvt.rna.tf32.f32 %0, %1;\\n" : "=r"(r) : "f"(v));'
VARIANTS = [
    ("as_is", [], None),
    ("no_products", [("mma_tf32(acc[j][nt], a", "if (0) mma_tf32(acc[j][nt], a")], None),
    ("one_product", [("constexpr bool SPLIT = !ROUND;", "constexpr bool SPLIT = false;")],
     None),
    ("int_rounding", [(CVT, "r = (__float_as_uint(v) + 0x1000u) & 0xffffe000u;")], None),
    ("whole_stage", [], "whole"),
    ("every_step", [], "steps"),
]
# (kernel, dtype, rows, T, C, k): chip_smoke.py's main-path shapes
CASES = [
    ("mrf", "float32", 16, 65536, 128, None), ("mrf", "float32", 16, 131072, 64, None),
    ("mrf", "float32", 16, 262144, 32, None), ("resblock", "float32", 16, 8192, 256, 3),
    ("resblock", "float32", 16, 8192, 256, 7), ("resblock", "float32", 16, 8192, 256, 11),
    ("mrf", "bfloat16", 16, 65536, 128, None),
]


def build(work, name, subs):
    """Copy csrc/ to work/name, apply the substitutions, start both nvccs."""
    from emotts_torch.ops import _build

    src = os.path.join(work, name)
    shutil.copytree(_build.CSRC_DIR, src)
    path = os.path.join(src, "resblock_common.cuh")
    text = open(path).read()
    for old, new in subs:
        if old not in text:
            raise RuntimeError(f"{name}: {old!r} is not in the core")
        text = text.replace(old, new)
    open(path, "w").write(text)
    return src, [subprocess.Popen(
        [_build.find_nvcc(), *_build.NVCC_FLAGS, "-o", os.path.join(src, f"lib{lib}.so"),
         os.path.join(src, f"{lib}.cu")], stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True) for lib in ("mrf", "resblock")]


def main():
    import torch

    from emotts_torch.ops import _build
    from emotts_torch.ops import mrf as M
    from emotts_torch.ops import resblock as R

    if not torch.cuda.is_available():
        print("probe_vocoder_core.py needs a GPU", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    plan = M.launch_plan

    def whole_plan(channels, kernel_sizes, dilations):
        return [(None, None, M.stage_tile(channels, kernel_sizes, dilations))]

    def step_plan(channels, kernel_sizes, dilations):
        # the per-step plan launch_plan gives where the halo ratio is high
        saved = M.MAX_HALO_RATIO
        M.MAX_HALO_RATIO = 0.0
        try:
            return plan(channels, kernel_sizes, dilations)
        finally:
            M.MAX_HALO_RATIO = saved

    plans = {None: plan, "whole": whole_plan, "steps": step_plan}

    with tempfile.TemporaryDirectory(prefix="vocoder_probe_") as work:
        started = [(name, *build(work, name, subs), route)
                   for name, subs, route in VARIANTS]
        variants = []
        for name, src, procs, route in started:
            for p in procs:
                out, _ = p.communicate()
                if p.returncode:
                    raise RuntimeError(f"{name}: nvcc failed\n{out[-3000:]}")
            variants.append((name, src, route))

        def use(src, route):
            for lib in ("mrf", "resblock"):
                _build._loaded[lib] = ctypes.CDLL(os.path.join(src, f"lib{lib}.so"))
            M.launch_plan = plans[route]

        def ms_of(fn, iters=3):
            fn()
            torch.cuda.synchronize()
            start, stop = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            start.record()
            for _ in range(iters):
                fn()
            stop.record()
            torch.cuda.synchronize()
            return start.elapsed_time(stop) / iters

        for kernel, dtype, rows, t, c, k in CASES:
            gen = torch.Generator().manual_seed(SEED)
            x = torch.randn(rows, t, c, generator=gen).to(dev, getattr(torch, dtype))

            def weights(kk):
                std = 0.5 / (kk * c) ** 0.5
                w1, w2 = (torch.randn(3, kk, c, c, generator=gen).mul_(std).to(dev)
                          for _ in range(2))
                b1, b2 = (torch.randn(3, c, generator=gen).mul_(0.1).to(dev)
                          for _ in range(2))
                return w1, b1, w2, b2

            if kernel == "mrf":
                params = [weights(kk) for kk in (3, 7, 11)]
                fn = lambda: M.fused_mrf_stage(x, params)  # noqa: E731
                want = M.fused_mrf_stage_plain(x, params).float()
            else:
                w = weights(k)
                fn = lambda: R.fused_resblock1(x, *w, (1, 3, 5))  # noqa: E731
                want = R.fused_resblock1_plain(x, *w, (1, 3, 5)).float()
            row = dict(kernel=kernel, dtype=dtype, shape=[rows, t, c], k=k)
            for rep in range(2):
                for name, src, route in (variants if rep == 0 else variants[::-1]):
                    use(src, route)
                    got = fn().float()
                    row.setdefault(name, {}).setdefault("ms", []).append(ms_of(fn))
                    row[name]["max_abs_err"] = (got - want).abs().max().item()
                    row[name]["launches"] = len(M.launch_plan(c, (3, 7, 11), (1, 3, 5))) \
                        if kernel == "mrf" else len(R.launch_plan(c, k, (1, 3, 5)))
                    del got
            print(json.dumps(row), flush=True)
            del x, want
            torch.cuda.empty_cache()
    M.launch_plan = plan
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60).stdout.strip(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
