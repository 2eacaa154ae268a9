#!/usr/bin/env python3
"""Time the port's attention kernels of two checkouts on one GPU, in turns.

    git archive <parent> | tar -x -C _archive_check/parent
    python3 tools/compare_attention_builds.py _archive_check/parent

Each checkout builds its own kernels (both builds started together), then
each runs the attention cases of ``chip_smoke.py``'s kernels phase (bf16 and
fp32, forward and backward) in a process of its own, in the order parent, this, this, parent, on inputs made
from one seed.  A case reports the wall time of a wrapper call (CUDA events
around back-to-back calls: for a short kernel, the wrapper's host time) and
its device time (the calls queued behind a sleep kernel, so that the card
runs them back to back).  Prints one JSON line per run, then one with the
means of both runs of each checkout.  Then one process trains the
full-width rank model in fp32 (``chip_smoke.py``'s corpus and config) and
reads one step at its largest frame bucket under the profiler with each
checkout's backward library in turns (the forward's source is shared):
device ms, the backward kernels' device ms, launches.  Needs one GPU and
nvcc.
"""

import argparse
import glob
import json
import os
import subprocess
import sys

SEED = 1234
ORDER = ("parent", "this", "this", "parent")
# (dtype, kind, b, t, d, rate): chip_smoke.py's attention cases at H = 2
CASES = [
    ("bfloat16", "fwd", 60, 48, 192, 0.0), ("bfloat16", "fwd", 3, 200, 192, 0.0),
    ("bfloat16", "fwd", 60, 1024, 192, 0.0),
    ("bfloat16", "fwd", 8, 250, 64, 0.0), ("bfloat16", "fwd", 8, 250, 256, 0.0),
    ("bfloat16", "fwd", 16, 512, 192, 0.1), ("bfloat16", "fwd", 16, 1024, 192, 0.1),
    ("bfloat16", "bwd", 16, 512, 192, 0.0), ("bfloat16", "bwd", 16, 512, 192, 0.1),
    ("bfloat16", "bwd", 16, 1024, 192, 0.0), ("bfloat16", "bwd", 16, 1024, 192, 0.1),
    ("bfloat16", "bwd", 128, 320, 192, 0.0), ("bfloat16", "bwd", 128, 320, 192, 0.1),
    ("bfloat16", "bwd", 16, 777, 192, 0.0), ("bfloat16", "bwd", 16, 777, 192, 0.1),
    ("bfloat16", "bwd", 8, 250, 64, 0.0), ("bfloat16", "bwd", 8, 250, 256, 0.0),
    ("float32", "fwd", 60, 48, 192, 0.0), ("float32", "fwd", 8, 1024, 192, 0.0),
    ("float32", "fwd", 8, 250, 64, 0.0), ("float32", "fwd", 8, 250, 256, 0.0),
    ("float32", "fwd", 8, 512, 192, 0.1), ("float32", "fwd", 3, 200, 192, 0.1),
    ("float32", "fwd", 8, 250, 64, 0.1), ("float32", "fwd", 8, 250, 256, 0.1),
    ("float32", "bwd", 8, 512, 192, 0.0), ("float32", "bwd", 8, 512, 192, 0.1),
    ("float32", "bwd", 3, 200, 192, 0.0), ("float32", "bwd", 3, 200, 192, 0.1),
    ("float32", "bwd", 16, 1024, 192, 0.0), ("float32", "bwd", 16, 1024, 192, 0.1),
    ("float32", "bwd", 8, 250, 64, 0.0), ("float32", "bwd", 8, 250, 64, 0.1),
    ("float32", "bwd", 8, 250, 256, 0.0), ("float32", "bwd", 8, 250, 256, 0.1),
]
# (dtype, kind, b, t, d, rate) at H = 1: a tensor-parallel rank's fp32
# backward, and (T = 8512) more key tiles of one (b, h) than SMs
H1_CASES = [
    ("float32", "bwd", 8, 512, 192, 0.0), ("float32", "bwd", 8, 512, 192, 0.1),
    ("bfloat16", "bwd", 2, 8512, 192, 0.0), ("bfloat16", "bwd", 2, 8512, 192, 0.1),
    ("float32", "bwd", 2, 8512, 192, 0.0), ("float32", "bwd", 2, 8512, 192, 0.1),
]
ALL_CASES = [(*c[:4], 2, *c[4:]) for c in CASES] + [(*c[:4], 1, *c[4:]) for c in H1_CASES]


def worker(tree, build_only):
    sys.path.insert(0, os.path.abspath(tree))
    import torch

    from emotts_torch.ops import _build
    from emotts_torch.ops import attention as A

    if build_only:
        _build.build_all(["attention", "attention_bwd"])
        return
    dev = torch.device("cuda", 0)

    def wall_ms(fn, iters=20):
        fn()
        torch.cuda.synchronize()
        start, stop = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        start.record()
        for _ in range(iters):
            fn()
        stop.record()
        torch.cuda.synchronize()
        return start.elapsed_time(stop) / iters

    def device_ms(fn, iters=20):
        fn()
        torch.cuda.synchronize()
        start, stop = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        torch.cuda._sleep(2_000_000 * iters)
        start.record()
        for _ in range(iters):
            fn()
        stop.record()
        torch.cuda.synchronize()
        return start.elapsed_time(stop) / iters

    torch.backends.cuda.matmul.allow_tf32 = False
    out = []
    for dtype, kind, b, t, h, d, rate in ALL_CASES:
        gen = torch.Generator().manual_seed(SEED)
        q, k, v, dout = (torch.randn(b, t, h, d, generator=gen).to(dev, getattr(torch, dtype))
                         for _ in range(4))
        lens = torch.randint(1, t + 1, (b,), generator=gen)
        lens[0], lens[1] = t, 0
        bias = ((torch.arange(t)[None, :] >= lens[:, None]).float() * -1e9).to(dev)
        seeds = torch.randint(-2 ** 31, 2 ** 31, (b,), generator=gen).to(dev, torch.int32)
        if kind == "fwd":
            def fn():
                return A.fused_attention(q, k, v, bias, seeds, rate)
        else:
            _, stats = A.attention_forward(q, k, v, bias, seeds, rate, want_stats=True)

            def fn():
                return A.attention_backward(q, k, v, bias, seeds, stats, dout, rate)
        out.append(dict(case=f"{dtype} {kind} ({b},{t},{h},{d}) rate {rate}",
                        wall_ms=wall_ms(fn), device_ms=device_ms(fn)))
        del q, k, v, dout
        torch.cuda.empty_cache()
    print(json.dumps(dict(tree=tree, cases=out)), flush=True)


def rank_step_worker(parent):
    """The fp32 rank step at its largest bucket with each checkout's
    backward library swapped in, in turns."""
    import ctypes
    import tempfile

    import torch

    here = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    sys.path.insert(0, here)
    import chip_smoke as S
    from emotts_torch.ops import _build
    from emotts_torch.train.rank_trainer import RankTrainer

    built = glob.glob(os.path.join(parent, "emotts_torch", "build",
                                   "libemotts_attention_bwd_*.so"))
    libs = {"this": _build.load("attention_bwd"), "parent": ctypes.CDLL(built[0])}
    dev = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    runs = {name: [] for name in libs}
    with tempfile.TemporaryDirectory(prefix="emotts_rank_step_") as root:
        cfg = S.rank_config(root, "float32")
        S.make_rank_corpus(cfg.data.preprocessed_path, cfg, S.SEED)
        trainer = RankTrainer(cfg, device=dev)
        batch = S.dp_batch("rank", trainer, root)
        for name in ORDER:
            _build._loaded["attention_bwd"] = libs[name]
            trainer.train_step(batch)  # the library's first launches
            reading = S.step_reading(trainer, batch)
            reading.pop("metrics")
            runs[name].append(reading)
            print(json.dumps(dict(run=name, rank_step_fp32=reading)), flush=True)
    means = {name: {key: sum(r[key] for r in rs) / len(rs) for key in rs[0]}
             for name, rs in runs.items()}
    shapes = {key: list(x.shape) for key, x in batch.items() if hasattr(x, "shape")}
    print(json.dumps(dict(rank_step_fp32_means=means, batch_shapes=shapes)), flush=True)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("parent", help="a checkout of the commit to compare with")
    ap.add_argument("--worker", help=argparse.SUPPRESS)
    ap.add_argument("--build-only", action="store_true", help=argparse.SUPPRESS)
    ap.add_argument("--rank-step", action="store_true", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.rank_step:
        return rank_step_worker(os.path.abspath(args.parent))
    if args.worker:
        return worker(args.worker, args.build_only)
    here = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    trees = {"parent": os.path.abspath(args.parent), "this": here}
    me = os.path.abspath(__file__)
    builds = [subprocess.Popen([sys.executable, me, "x", "--worker", tree, "--build-only"])
              for tree in trees.values()]
    if any(p.wait() for p in builds):
        sys.exit("a build failed")
    runs = {name: [] for name in trees}
    for name in ORDER:
        res = subprocess.run([sys.executable, me, "x", "--worker", trees[name]],
                             capture_output=True, text=True, check=True)
        line = json.loads(res.stdout.strip().splitlines()[-1])
        print(json.dumps(dict(run=name, **line)), flush=True)
        runs[name].append(line["cases"])
    summary = []
    for i in range(len(ALL_CASES)):
        row = dict(case=runs["this"][0][i]["case"])
        for name in trees:
            for key in ("wall_ms", "device_ms"):
                row[f"{name}_{key}"] = sum(r[i][key] for r in runs[name]) / len(runs[name])
        summary.append(row)
    print(json.dumps({"summary": summary}), flush=True)
    subprocess.run([sys.executable, me, trees["parent"], "--rank-step"], check=True)


if __name__ == "__main__":
    main()
