#!/usr/bin/env python3
"""Where the bf16 attention backward's time goes, on one GPU.

    python3 tools/probe_attention_bwd.py [--variants as_is,no_adds,...]

Builds variants of ``csrc/attention_bwd.cu``, each a copy of this checkout's
``emotts_torch`` under ``emotts_torch/build/probe/<variant>`` with one part
of the fused pass taken out by a text patch, all compilers started together,
then times the bf16 backward of each at chip_smoke.py's main training shapes
in a process of its own, in turns (as_is, the variants, then back again).  A
case reports the call's device time (chip_smoke.py's ``device_ms``) and each
kernel's from a ``torch.profiler`` trace.  Only ``as_is`` computes the
gradients; the others exist to be timed:

    no_waits       the dQ adds without waiting for a turn or handing it on
                   (the order of the sums is then not fixed);
    no_adds        neither the adds nor the turns (dQ is not written);
    no_dq_product  no_adds, and dQ's product not issued;
    no_exp         no_adds, and P formed without the exponential.

Prints one JSON line per run and one with the means.  Needs one GPU and nvcc.
"""

import argparse
import json
import os
import shutil
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SEED = 1234
SHAPES = [(16, 1024, 2), (16, 1024, 1), (128, 320, 2)]  # (B, T, H), D = 192

_NO_TURNS = [
    ("__device__ __forceinline__ void wait_turn(const int* counter, int turn) {\n",
     "__device__ __forceinline__ void wait_turn(const int* counter, int turn) {\n  return;\n"),
    ("__device__ __forceinline__ void red_release_gpu_add(int* p, int v) {\n",
     "__device__ __forceinline__ void red_release_gpu_add(int* p, int v) {\n  return;\n"),
]
_NO_ADDS = _NO_TURNS + [
    ("  auto add_partial = [&](int step, int w, float (&part)[C::NQB][32]) {\n",
     "  auto add_partial = [&](int step, int w, float (&part)[C::NQB][32]) {\n"
     "    if (part[0][0] != 12345.f) return;\n"),
]
VARIANTS = {
    "as_is": [],
    "no_waits": _NO_TURNS,
    "no_adds": _NO_ADDS,
    "no_dq_product": _NO_ADDS + [
        ("        wg::mma_ss_mn_wide<64 * C::NQB>(",
         "        if (kk < 0) wg::mma_ss_mn_wide<64 * C::NQB>("),
        ("        wg::mma_ss_mn_wide<64 * (C::NB - C::NQB)>(",
         "        if (kk < 0) wg::mma_ss_mn_wide<64 * (C::NB - C::NQB)>("),
    ],
    "no_exp": _NO_ADDS + [
        ('  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(e) : "f"(fmaf(s, scale2, bias2 - lse2)));',
         "  e = fmaf(s, scale2, bias2 - lse2);"),
    ],
}


def make_tree(name):
    """A checkout-shaped copy of emotts_torch (and chip_smoke.py) with the
    variant's patches applied to csrc/attention_bwd.cu."""
    tree = os.path.join(ROOT, "emotts_torch", "build", "probe", name)
    shutil.rmtree(tree, ignore_errors=True)
    shutil.copytree(os.path.join(ROOT, "emotts_torch"), os.path.join(tree, "emotts_torch"),
                    ignore=shutil.ignore_patterns("build", "__pycache__"))
    shutil.copy(os.path.join(ROOT, "chip_smoke.py"), tree)
    path = os.path.join(tree, "emotts_torch", "csrc", "attention_bwd.cu")
    with open(path) as f:
        src = f.read()
    for old, new in VARIANTS[name]:
        if src.count(old) != 1:
            raise SystemExit(f"{name}: the source no longer holds the text to patch: {old!r}")
        src = src.replace(old, new)
    with open(path, "w") as f:
        f.write(src)
    return tree


def worker(tree, name):
    sys.path.insert(0, tree)
    sys.path.insert(0, os.path.join(ROOT, "tools"))
    import torch

    import chip_smoke as S
    from emotts_torch.ops import attention as A
    from profile_attention_f32 import kernel_ms

    dev = torch.device("cuda", 0)
    gen = torch.Generator().manual_seed(SEED)
    out = dict(variant=name)
    for b, t, h in SHAPES:
        q, k, v, bias, seeds = S._attention_inputs(gen, dev, torch.bfloat16, b, t, h=h, d=192)
        dout = torch.randn(b, t, h, 192, generator=gen).to(dev, torch.bfloat16)
        for rate in (0.0, 0.1):
            _, stats = A.attention_forward(q, k, v, bias, seeds, rate, want_stats=True)

            def fn():
                return A.attention_backward(q, k, v, bias, seeds, stats, dout, rate)

            kernels = {("delta" if "delta" in key else "fused"): ms
                       for key, ms in kernel_ms(fn).items() if "attention_bwd" in key}
            out[f"({b},{t},{h},192) rate {rate}"] = dict(device_ms=S.device_ms(fn), **kernels)
    print(json.dumps(out), flush=True)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--variants", default=",".join(VARIANTS))
    ap.add_argument("--worker", nargs=2, help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.worker:
        return worker(*args.worker)
    import torch

    if not torch.cuda.is_available():
        sys.exit("needs a GPU")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True)
    print(card.stdout.strip(), flush=True)
    names = args.variants.split(",")
    trees = {name: make_tree(name) for name in names}
    build = "import sys; sys.path.insert(0, sys.argv[1]); from emotts_torch.ops import _build; " \
            "_build.build_all(['attention', 'attention_bwd'])"
    procs = [subprocess.Popen([sys.executable, "-c", build, tree]) for tree in trees.values()]
    if any(p.wait() for p in procs):
        sys.exit("a build failed")
    runs = {name: [] for name in names}
    me = os.path.abspath(__file__)
    for name in names + names[::-1]:
        res = subprocess.run([sys.executable, me, "--worker", trees[name], name],
                             capture_output=True, text=True, check=True)
        line = json.loads(res.stdout.strip().splitlines()[-1])
        print(json.dumps(line), flush=True)
        runs[name].append(line)
    print(json.dumps({"means": means_of(runs)}), flush=True)


def means_of(runs):
    """{variant: {case: {key: mean}}} over the runs that read the key (a
    profiler trace now and then misses a call's kernels)."""
    out = {}
    for name, rs in runs.items():
        cases = [c for c in rs[0] if c != "variant"]
        out[name] = {}
        for case in cases:
            keys = {k for r in rs for k in r[case]}
            out[name][case] = {k: sum(r[case][k] for r in rs if k in r[case])
                               / sum(k in r[case] for r in rs) for k in sorted(keys)}
    return out


if __name__ == "__main__":
    main()
