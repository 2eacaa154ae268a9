#!/usr/bin/env python3
"""Time the port's vocoder kernels (MRF stage, ResBlock1) on one GPU, and
those of a second checkout in turns with them.

    python3 tools/compare_vocoder_builds.py                  # this checkout
    git archive <parent> | tar -x -C _archive_check/parent
    python3 tools/compare_vocoder_builds.py _archive_check/parent

Each checkout builds its own `mrf` and `resblock` libraries (all builds
started together), then runs ``chip_smoke.py``'s vocoder kernel cases in a
process of its own; with a second checkout the order is that, this, this,
that.  Inputs come from one seed, so both checkouts see the same numbers.  A
case reports the kernel's time (CUDA events around back-to-back wrapper
calls; these kernels run for milliseconds, so it is device time), the plain
version's time, and the largest error against the plain version with
whether it is within ``chip_smoke.py``'s tolerance; a case that is not is
reported, not raised, so that one run shows every case.  Prints one JSON
line per run, then the means of each checkout's runs, then the card line.
Needs one GPU and nvcc; exits non-zero if a case of this checkout is out of
tolerance.
"""

import argparse
import json
import os
import subprocess
import sys

SEED = 1234
FRAMES, ROWS = 1024, 16  # chip_smoke.py: max_mel_len frames, rows per chunk
# (kernel, dtype, rows, T, C, k): the main path's shapes first, then ragged
# ones (edge masks, a last tile that is cut)
CASES = [
    ("mrf", d, ROWS, FRAMES * u, c, None)
    for d in ("float32", "bfloat16") for u, c in ((64, 128), (128, 64), (256, 32))
] + [
    ("resblock", d, ROWS, FRAMES * 8, 256, k)
    for d in ("float32", "bfloat16") for k in (3, 7, 11)
] + [
    ("mrf", d, r, t, c, None)
    for d in ("float32", "bfloat16") for r, t, c in ((2, 777, 128), (3, 333, 32))
] + [("resblock", d, 2, 1000, 256, 11) for d in ("float32", "bfloat16")]


def worker(tree, build_only, iters):
    sys.path.insert(0, os.path.abspath(tree))
    import torch

    from emotts_torch.ops import _build
    from emotts_torch.ops import mrf as M
    from emotts_torch.ops import resblock as R

    if build_only:
        _build.build_all(["mrf", "resblock"])
        return
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    tol = {"float32": 2e-4, "bfloat16": 2e-2}  # chip_smoke.py TOL, abs = rel

    def ms_of(fn):
        fn()
        torch.cuda.synchronize()
        start, stop = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        start.record()
        for _ in range(iters):
            fn()
        stop.record()
        torch.cuda.synchronize()
        return start.elapsed_time(stop) / iters

    def weights(gen, c, k):
        std = 0.5 / (k * c) ** 0.5
        w1, w2 = (torch.randn(3, k, c, c, generator=gen).mul_(std).to(dev)
                  for _ in range(2))
        b1, b2 = (torch.randn(3, c, generator=gen).mul_(0.1).to(dev) for _ in range(2))
        return w1, b1, w2, b2

    out = []
    for kernel, dtype, rows, t, c, k in CASES:
        gen = torch.Generator().manual_seed(SEED)
        x = torch.randn(rows, t, c, generator=gen).to(dev, getattr(torch, dtype))
        if kernel == "mrf":
            params = [weights(gen, c, kk) for kk in (3, 7, 11)]
            fn = lambda: M.fused_mrf_stage(x, params)  # noqa: E731
            plain = lambda: M.fused_mrf_stage_plain(x, params)  # noqa: E731
        else:
            w = weights(gen, c, k)
            fn = lambda: R.fused_resblock1(x, *w, (1, 3, 5))  # noqa: E731
            plain = lambda: R.fused_resblock1_plain(x, *w, (1, 3, 5))  # noqa: E731
        got, want = fn().float(), plain().float()
        err = (got - want).abs()
        ok = bool(torch.isfinite(got).all()) and bool(
            (err <= tol[dtype] * (1 + want.abs())).all())
        case = dict(kernel=kernel, dtype=dtype, shape=[rows, t, c], k=k,
                    max_abs_err=err.max().item(), within_tolerance=ok)
        del got, want, err
        case["ms"] = ms_of(fn)
        case["plain_ms"] = ms_of(plain)
        out.append(case)
        del x
        torch.cuda.empty_cache()
    print(json.dumps(out), flush=True)


def run(tree, iters):
    res = subprocess.run(
        [sys.executable, __file__, "--worker", tree, "--iters", str(iters)],
        capture_output=True, text=True, timeout=1200,
    )
    if res.returncode != 0:
        raise RuntimeError(f"{tree}: exit {res.returncode}\n{res.stderr[-4000:]}")
    return json.loads(res.stdout.strip().splitlines()[-1])


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("other", nargs="?", help="a second checkout to compare with")
    ap.add_argument("--worker", help=argparse.SUPPRESS)
    ap.add_argument("--build-only", action="store_true", help=argparse.SUPPRESS)
    ap.add_argument("--iters", type=int, default=3)
    args = ap.parse_args()
    if args.worker:
        worker(args.worker, args.build_only, args.iters)
        return 0
    here = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    trees = {"this": here}
    if args.other:
        trees["other"] = os.path.abspath(args.other)
    builds = [subprocess.Popen([sys.executable, __file__, "--worker", t, "--build-only"])
              for t in trees.values()]
    if any(p.wait() != 0 for p in builds):
        raise RuntimeError("a build failed")
    order = ["other", "this", "this", "other"] if args.other else ["this"]
    runs = {}
    for label in order:
        cases = run(trees[label], args.iters)
        print(json.dumps({"run": label, "cases": cases}), flush=True)
        runs.setdefault(label, []).append(cases)
    means = {
        label: [dict(c, ms=sum(r[i]["ms"] for r in rs) / len(rs),
                     plain_ms=sum(r[i]["plain_ms"] for r in rs) / len(rs))
                for i, c in enumerate(rs[0])]
        for label, rs in runs.items()
    }
    print(json.dumps({"means": means}), flush=True)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60).stdout.strip()
    print(card, flush=True)
    bad = [c for rs in runs["this"] for c in rs if not c["within_tolerance"]]
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())
