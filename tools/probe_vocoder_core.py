#!/usr/bin/env python3
"""Probe where the vocoder kernels' time goes, on one GPU.

    python3 tools/probe_vocoder_core.py [--variants as_is,no_products,...]

Builds variants of the conv core (``emotts_torch/csrc/resblock_common.cuh``,
each a text substitution in a copy of ``csrc/`` under a temporary
directory; variants with the same substitutions share a build), with the
Python mirror of the geometry or the launch plans patched to match where a
variant changes them, loads each variant's `mrf` and `resblock` libraries
in turn into this process, and times ``chip_smoke.py``'s main-path vocoder
cases (fp32, and the bf16 MRF stages) and the stages of a stream's first
window (one row of 49 mel frames) with each, twice, in the order of the
variants and then reversed.  Every case reports its launches and its
largest error against the plain version, so that a probe whose results are
wrong on purpose says so.

    as_is            the core and the plans as they stand
    no_products      the wgmma calls compiled out: what the rest costs
                     (results wrong)
    one_product      the products of a_lo dropped in the fp32 instances: one
                     TF32 product a term (two at C <= 64, where a_hi*b_lo
                     comes with a_hi*b_hi from one wgmma; results outside the
                     fp32 tolerance)
    no_stack         at C <= 64 the fp32 weights' parts side by side in a
                     row (three wgmmas of N = C a k8 step) instead of
                     stacked as rows (two, of N = 2C and C)
    narrow_one_part  the bf16 instance with one m64 tile a warpgroup at
                     C = 64 and two at C = 32 (as the fp32 instance) instead
                     of 128 accumulator columns' worth (two and four)
    ring_2, ring_3, ring_6
                     2 / 3 / 6 stages in the weight ring below C = 256 and
                     2 / 3 / 2 at it, where a stage is 32 KB (as_is: 4 and
                     2), the tiles refitted to the shared memory left
    m64_fit          tiles fitted to the fewest m64 tiles per row kept
                     instead of the fewest rows of passes (pass_rows)
    whole_stage      every MRF stage and ResBlock in one launch where
                     shared memory takes the whole chain
    every_step       every MRF stage and ResBlock one launch per dilation
                     step
    long_plans       the plans made as for a long sequence whatever the
                     sequence (no fit to the SMs)

Prints one JSON line per case with each variant's times in ms, then the card
line.  Needs one GPU and nvcc.
"""

import argparse
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
RING = "__host__ __device__ constexpr int ring_stages(int C) { return C >= 256 ? 2 : 4; }"


def ring(small, big):
    """Ring stages `small` below C = 256 and `big` at it, in the core and in
    the Python mirror."""
    return dict(subs=[(RING, RING.replace("C >= 256 ? 2 : 4", f"C >= 256 ? {big} : {small}"))],
                ring=lambda c: big if c >= 256 else small)


# name: substitutions in resblock_common.cuh (subs), the Python mirror's
# ring_stages (ring) and pass_rows (pass_rows), a launch plan (plan: "whole",
# "steps" or "long"), the packing's layout choice (stacked)
VARIANTS = {
    "as_is": {},
    "no_products": dict(subs=[("wg::mma_tf32_rs(", "if (0) wg::mma_tf32_rs(")]),
    "one_product": dict(subs=[("if (SPLIT)", "if (false)")]),
    "no_stack": dict(subs=[("static constexpr bool STACK = PARTS == 2 && C <= 64;",
                            "static constexpr bool STACK = false;")],
                     stacked=lambda channels, parts: False,
                     pass_rows=lambda c, parts=2: {32: 256, 64: 128, 128: 128}.get(c, 64)),
    "narrow_one_part": dict(
        subs=[("static constexpr int MT = 128 / NACC;",
               "static constexpr int MT = (C <= 64 ? 64 : 128) / NW;")],
        pass_rows=lambda c, parts=2: {32: 256, 64: 128, 128: 128}.get(c, 64)),
    "ring_2": ring(2, 2),
    "ring_3": ring(3, 3),
    "ring_6": ring(6, 2),
    "m64_fit": dict(pass_rows=lambda c, parts=2: 64),
    "whole_stage": dict(plan="whole"),
    "every_step": dict(plan="steps"),
    "long_plans": dict(plan="long"),
}
# (kernel, dtype, rows, T, C, k): chip_smoke.py's main-path shapes, then the
# stages of a stream's first window (49 mel frames)
CASES = [
    ("mrf", "float32", 16, 65536, 128, None), ("mrf", "float32", 16, 131072, 64, None),
    ("mrf", "float32", 16, 262144, 32, None), ("resblock", "float32", 16, 8192, 256, 3),
    ("resblock", "float32", 16, 8192, 256, 7), ("resblock", "float32", 16, 8192, 256, 11),
    ("mrf", "bfloat16", 16, 65536, 128, None), ("mrf", "bfloat16", 16, 131072, 64, None),
    ("mrf", "bfloat16", 16, 262144, 32, None),
    ("mrf", "float32", 1, 49 * 64, 128, None), ("mrf", "float32", 1, 49 * 128, 64, None),
    ("mrf", "float32", 1, 49 * 256, 32, None), ("resblock", "float32", 1, 49 * 8, 256, 3),
    ("resblock", "float32", 1, 49 * 8, 256, 7), ("resblock", "float32", 1, 49 * 8, 256, 11),
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
    ap = argparse.ArgumentParser()
    ap.add_argument("--variants", default=",".join(VARIANTS),
                    help="comma-separated names (default: all)")
    ap.add_argument("--iters", type=int, default=3)
    args = ap.parse_args()
    names = args.variants.split(",")
    unknown = [n for n in names if n not in VARIANTS]
    if unknown:
        print(f"unknown variants {unknown}; known: {list(VARIANTS)}", file=sys.stderr)
        return 2

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
    saved = dict(mrf_plan=M.launch_plan, resblock_plan=R.launch_plan,
                 ring_stages=R.ring_stages, stacked=R.stacked, pass_rows=R.pass_rows)

    def whole_mrf(channels, kernel_sizes, dilations, parts=2, rows=0, length=0, sms=R.SMS):
        return ((None, None, M._whole_stage(channels, tuple(kernel_sizes), tuple(dilations),
                                            parts, rows, length, sms)[0]),)

    def whole_resblock(channels, kernel_size, dilations, rows=0, length=0, sms=R.SMS):
        dils = tuple(dilations)
        tile = R.fit_tile(*R.chain_fits(channels, kernel_size, dils),
                          lambda t, s: R.chain_cost(kernel_size, dils, t, s),
                          R.pass_rows(channels, 2), rows, length, sms)[0]
        return ((0, len(dils), tile),) if tile else saved["resblock_plan"](
            channels, kernel_size, dils, rows, length, sms)

    def every_step(plan):
        def steps(*args):
            saved_overhead = dict(R.STEP_OVERHEAD)
            R.STEP_OVERHEAD.update({p: 0.0 for p in R.STEP_OVERHEAD})
            try:
                plan.cache_clear()
                return plan(*args)
            finally:
                R.STEP_OVERHEAD.update(saved_overhead)
                plan.cache_clear()
        return steps

    def long_plan(plan, n_fixed):
        return lambda *args: plan(*args[:n_fixed])

    plans = {
        None: (saved["mrf_plan"], saved["resblock_plan"]),
        "whole": (whole_mrf, whole_resblock),
        "steps": (every_step(saved["mrf_plan"]), every_step(saved["resblock_plan"])),
        "long": (long_plan(saved["mrf_plan"], 4), long_plan(saved["resblock_plan"], 3)),
    }

    with tempfile.TemporaryDirectory(prefix="vocoder_probe_") as work:
        builds = {}  # substitutions -> build directory and its nvccs
        for name in names:
            subs = tuple(VARIANTS[name].get("subs", []))
            if subs not in builds:
                builds[subs] = build(work, f"build{len(builds)}", list(subs))
        for subs, (src, procs) in builds.items():
            for p in procs:
                out, _ = p.communicate()
                if p.returncode:
                    raise RuntimeError(f"{subs}: nvcc failed\n{out[-3000:]}")
        variants = [(name, builds[tuple(VARIANTS[name].get("subs", []))][0])
                    for name in names]

        def use(name, src):
            for lib in ("mrf", "resblock"):
                _build._loaded[lib] = ctypes.CDLL(os.path.join(src, f"lib{lib}.so"))
            v = VARIANTS[name]
            R.ring_stages = v.get("ring") or saved["ring_stages"]
            M.launch_plan, R.launch_plan = plans[v.get("plan")]
            R.pass_rows = M.pass_rows = v.get("pass_rows") or saved["pass_rows"]
            R.stacked = v.get("stacked") or saved["stacked"]
            for cached in (saved["mrf_plan"], saved["resblock_plan"], R.chain_fits,
                           M._stage_fit):
                cached.cache_clear()  # fits of another geometry
            R._pack_index.clear()  # the packings of another layout
            R._packed.clear()

        def ms_of(fn, iters):
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
                for name, src in (variants if rep == 0 else variants[::-1]):
                    use(name, src)
                    got = fn().float()
                    row.setdefault(name, {}).setdefault("ms", []).append(
                        ms_of(fn, args.iters))
                    row[name]["max_abs_err"] = (got - want).abs().max().item()
                    before = M.launch_count + R.launch_count
                    fn()
                    row[name]["launches"] = M.launch_count + R.launch_count - before
                    del got
            print(json.dumps(row), flush=True)
            del x, want
            torch.cuda.empty_cache()
    M.launch_plan, R.launch_plan = plans[None]
    R.ring_stages, R.stacked = saved["ring_stages"], saved["stacked"]
    R.pass_rows = M.pass_rows = saved["pass_rows"]
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60).stdout.strip(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
