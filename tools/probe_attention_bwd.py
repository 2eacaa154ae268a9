#!/usr/bin/env python3
"""Where the attention backward's time goes, on one GPU.

    python3 tools/probe_attention_bwd.py [--dtype float32] [--variants as_is,no_adds,...]

Builds variants of ``csrc/attention_bwd.cu``, each a copy of this checkout's
``emotts_torch`` under ``emotts_torch/build/probe/<variant>`` with one part
of the fused pass taken out by a text patch, all compilers started together,
then times the backward of the dtype (bf16 by default) of each at
chip_smoke.py's main training shapes in a process of its own, in turns
(as_is, the variants, then back again).  A case reports the call's device
time (chip_smoke.py's ``device_ms``) and each kernel's from a
``torch.profiler`` trace.  ``as_is``, ``cvt_split`` and ``early_load``
compute the gradients; the others exist to be timed:

    no_waits       the dQ adds without waiting for a turn or handing it on
                   (the order of the sums is then not fixed);
    no_adds        neither the adds nor the turns (dQ is not written);
    no_dq_product  no_adds, and dQ's product not issued;
    no_exp         no_adds, and P formed without the exponential;
    (fp32 only)
    no_handover    the dS^T groups form dS^T without waiting for P^T;
    no_dv_dk       dV's and dK's products not issued;
    cvt_split      computes as as_is, with each value split into TF32 parts by
                   two cvt.rna.tf32.f32 (common.cuh's split_tf32) instead of
                   integer arithmetic;
    no_st          S^T's and dP_d^T's products not issued;
    early_load     computes as as_is, with the next stage's loads issued at
                   the start of a step instead of after dV's product.

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
# (B, T, H), D = 192
SHAPES = {"bfloat16": [(16, 1024, 2), (16, 1024, 1), (128, 320, 2)],
          "float32": [(16, 1024, 2), (8, 512, 2), (8, 512, 1)]}

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
BF16_VARIANTS = {
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

_F32_NO_TURNS = [
    ("__device__ __forceinline__ void wait_count(const int* counter, int at_least) {\n",
     "__device__ __forceinline__ void wait_count(const int* counter, int at_least) {\n"
     "  return;\n"),
    _NO_TURNS[1],
]
_F32_NO_ADDS = _F32_NO_TURNS + [
    ("        if (tq < Tlen) {\n          float* row = dq + base",
     "        if (tq < 0) {\n          float* row = dq + base"),
]
_F32_DV_DK = ("      mma_pb_cols<NTH, NQ, LD>(acc, fh, fl, bq + 8 * NH * half * LD,\n"
              "                               bq + 8 * NH * (1 - half) * LD);\n")
F32_VARIANTS = {
    "as_is": [],
    "no_waits": _F32_NO_TURNS,
    "no_adds": _F32_NO_ADDS,
    "no_dq_product": _F32_NO_ADDS + [
        ("      for (int j = 0; j < C::BKEY / 8; ++j) {\n        const float* aj",
         "      for (int j = 0; j < 0; ++j) {\n        const float* aj"),
    ],
    "no_exp": _F32_NO_ADDS + [BF16_VARIANTS["no_exp"][-1]],
    "no_handover": [
        ("      wg::barrier_arrive(1, 512);  // P^T is in the scratch\n    } else {\n"
         "      wg::barrier_sync(1, 512);\n", "    } else {\n"),
    ],
    "no_dv_dk": [(_F32_DV_DK, "      if (step < 0)\n" + _F32_DV_DK)],
    "cvt_split": [
        ("  hi = (__float_as_uint(v) + 0x1000u) & 0xFFFFE000u;\n"
         "  lo = __float_as_uint(v - __uint_as_float(hi));\n",
         "  split_tf32<true>(v, hi, lo);\n"),
    ],
    "no_st": [
        ("    mma_abt_alu<D, NH>(sc, ka, (role == 0 ? sQs : sDOs) + (8 * NH * half + g) * LD + t);",
         "    if (step < 0)\n"
         "      mma_abt_alu<D, NH>(sc, ka, (role == 0 ? sQs : sDOs) + (8 * NH * half + g) * LD + t);"),
    ],
    "early_load": [
        ("    if (wid == 0 && step + 1 < nqt) load_stage(step + 1, s ^ 1);\n", ""),
        ("    wg::mbar_wait(bar + 8 * s, (step >> 1) & 1);\n    const float* sQs = sQD",
         "    wg::mbar_wait(bar + 8 * s, (step >> 1) & 1);\n"
         "    if (wid == 0 && step + 1 < nqt) load_stage(step + 1, s ^ 1);\n"
         "    const float* sQs = sQD"),
    ],
}
VARIANTS = {"bfloat16": BF16_VARIANTS, "float32": F32_VARIANTS}


def make_tree(name, dtype):
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
    for old, new in VARIANTS[dtype][name]:
        if src.count(old) != 1:
            raise SystemExit(f"{name}: the source no longer holds the text to patch: {old!r}")
        src = src.replace(old, new)
    with open(path, "w") as f:
        f.write(src)
    return tree


def worker(tree, name, dtype):
    sys.path.insert(0, tree)
    sys.path.insert(0, os.path.join(ROOT, "tools"))
    import torch

    import chip_smoke as S
    from emotts_torch.ops import attention as A
    from profile_attention_f32 import kernel_ms

    dev = torch.device("cuda", 0)
    gen = torch.Generator().manual_seed(SEED)
    out = dict(variant=name)
    torch.backends.cuda.matmul.allow_tf32 = False
    td = getattr(torch, dtype)
    for b, t, h in SHAPES[dtype]:
        q, k, v, bias, seeds = S._attention_inputs(gen, dev, td, b, t, h=h, d=192)
        dout = torch.randn(b, t, h, 192, generator=gen).to(dev, td)
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
    ap.add_argument("--dtype", default="bfloat16", choices=sorted(VARIANTS))
    ap.add_argument("--variants", help="comma-separated; default: all of the dtype's")
    ap.add_argument("--worker", nargs=2, help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.worker:
        return worker(*args.worker, args.dtype)
    import torch

    if not torch.cuda.is_available():
        sys.exit("needs a GPU")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True)
    print(card.stdout.strip(), flush=True)
    names = args.variants.split(",") if args.variants else list(VARIANTS[args.dtype])
    trees = {name: make_tree(name, args.dtype) for name in names}
    build = "import sys; sys.path.insert(0, sys.argv[1]); from emotts_torch.ops import _build; " \
            "_build.build_all(['attention', 'attention_bwd'])"
    procs = [subprocess.Popen([sys.executable, "-c", build, tree]) for tree in trees.values()]
    if any(p.wait() for p in procs):
        sys.exit("a build failed")
    runs = {name: [] for name in names}
    me = os.path.abspath(__file__)
    for name in names + names[::-1]:
        res = subprocess.run([sys.executable, me, "--worker", trees[name], name,
                              "--dtype", args.dtype],
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
