#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (emotts_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Needs one CUDA device, the CUDA toolkit (nvcc) and nothing else: no network,
no checkpoint, no corpus (weights and training data are drawn from a seed).
In order, each phase printing one JSON line, any failure ending the run with
a non-zero exit:

 1. card      name and power limit (nvidia-smi), torch and CUDA versions
 2. build     the kernels from emotts_torch/csrc, one nvcc each, together
 3. kernels   each kernel against its plain PyTorch version on the card, at
              the shapes its path gives it, with times, roofline bounds,
              bound_fraction (bound / time) and vs_library (time / library
              call's time): attention forward (rate 0, then with dropout) and
              backward (bf16 on tensor cores at head dim 192, and at 64 and
              256 for the other instances; fp32 on the FMA units; each with
              its device time, launches queued behind a sleep kernel, beside
              the wall time),
              MRF stage, ResBlock (on the tensor cores, 3xTF32 for fp32;
              each case with its tiles and launches, the operations its
              design does and the tensor rate that implies)
 4. serve     the full-width model behind the HTTP server: /health, a cold
              and three warm /synthesize, one /batch
 5. sweep     Synthesizer.intensity_sweep, 60 utterances in one batch
 6. launches  the kernels' launch counters over phases 4-5
 7. parity    the kernel path against the plain path, end to end, in fp32
 8. train     RankTrainer.fit at full width (bf16, dropout 0.1, fused
              attention) on a corpus made from the seed; checkpoint, best/,
              resume
 9. bucketize bucketize() from best/, and the Synthesizer serving with the
              bank it wrote
10. launches  the attention counters over phases 8-9
    (then, uncounted: one request served with that bank, and a profiler
    reading of where a train step's time goes)
11. train parity  one fp32 train step through the kernels against the same
              step through the plain forward and backward

The last line is {"ok": true, "device": {...}}; before it stand the card line
and one {"kernels": [...]} line.  Without a GPU the script exits non-zero and
prints no result.
"""

import base64
import io
import json
import math
import os
import subprocess
import sys
import tempfile
import threading
import time
import urllib.error
import urllib.request
import wave

import numpy as np
import torch
import torch.nn.functional as F

SEED = 1234
# published dense peaks of one H100 SXM (NVIDIA data sheet)
PEAK_BF16 = 989e12  # tensor cores, bf16
PEAK_TF32 = 495e12  # tensor cores, TF32: what fp32 inputs may use if documented
PEAK_BYTES = 3.35e12  # HBM3
KERNEL_CONFIG = dict(fused_mrf=True, use_pallas_resblocks=True)


def emit(phase, **fields):
    print(json.dumps({"phase": phase, **fields}), flush=True)


def card_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def time_ms(fn, iters):
    """Mean device time of ``fn`` over ``iters`` launches, after one warm-up."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / iters


def device_ms(fn, iters=20):
    """Device time of one call of ``fn``: a sleep kernel holds the stream
    while the host enqueues ``iters`` calls between two events, so the card
    then runs them back to back and the host's time between launches (a
    short kernel's wall time is mostly the wrapper's) does not count.  Events,
    not the profiler: this phase runs before the end-to-end phases."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(2_000_000 * iters)  # about 1 ms of the card's clock a call
    start.record()
    for _ in range(iters):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / iters


def with_ratios(case):
    """bound_fraction: the bound's share of the kernel's time (1 = at the
    bound); vs_library: the kernel's time over the library call's."""
    case["bound_fraction"] = case["bound_ms"] / case["ms"]
    lib = case.get("library_ms")
    case["vs_library"] = case["ms"] / lib if lib else None
    return case


def bound(ops, peak_ops, nbytes):
    """(bound_ms, bound_by): the larger of operations over the peak rate and
    bytes (each input read once, each output written once) over HBM rate."""
    t_ops, t_bytes = ops / peak_ops, nbytes / PEAK_BYTES
    return 1e3 * max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes else "bytes")


def compare(got, want, atol, rtol):
    got, want = got.float(), want.float()
    if not torch.isfinite(got).all():
        raise AssertionError("kernel output is not finite")
    err = (got - want).abs()
    tol = atol + rtol * want.abs()
    if not bool((err <= tol).all()):
        raise AssertionError(
            f"kernel disagrees with its plain version: max abs err "
            f"{err.max().item():.3e}, atol {atol}, rtol {rtol}"
        )
    # relative where |want| > 1, absolute below: near zero a relative error
    # says nothing
    rel = (err / want.abs().clamp_min(1.0)).max().item()
    return err.max().item(), rel


# --------------------------------------------------------------------------
# phase 3: every kernel against its plain version
# --------------------------------------------------------------------------

# Tolerances.  fp32: kernel and plain version are both full fp32 (TF32 off)
# and differ in summation order over up to 11*256 products per output.
# bf16: both round at the same points, but to different summation orders, so
# a value near a rounding boundary may land on the neighbouring bf16 value:
# one bf16 step is 2^-8 relative; attention also rounds un-normalised instead
# of normalised probabilities (one more bf16 rounding per term).
TOL = {
    torch.float32: dict(atol=2e-4, rtol=2e-4),
    torch.bfloat16: dict(atol=2e-2, rtol=2e-2),
}


def check_attention(gen, dev):
    from emotts_torch.ops import attention as A

    cases = []
    h = 2
    for dtype, b, t, iters, d in ((torch.bfloat16, 60, 48, 20, 192),
                                  (torch.float32, 60, 48, 20, 192),
                                  (torch.bfloat16, 3, 200, 20, 192),  # ragged last tile
                                  (torch.float32, 8, 1024, 3, 192),
                                  (torch.bfloat16, 60, 1024, 10, 192),
                                  # the other head dims' tensor-core instances
                                  (torch.bfloat16, 8, 250, 10, 64),
                                  (torch.bfloat16, 8, 250, 10, 256)):
        q, k, v = (torch.randn(b, t, h, d, generator=gen).to(dev, dtype)
                   for _ in range(3))
        lens = torch.randint(1, t + 1, (b,), generator=gen)
        lens[0], lens[1] = t, 0  # a full row and a fully padded row
        bias = ((torch.arange(t)[None, :] >= lens[:, None]).float() * -1e9).to(dev)
        got = A.fused_attention(q, k, v, bias)
        torch.cuda.synchronize()
        want = A.fused_attention_plain(q, k, v, bias)
        err, rel = compare(got, want, **TOL[dtype])
        ms = time_ms(lambda: A.fused_attention(q, k, v, bias), iters)
        dev_ms = device_ms(lambda: A.fused_attention(q, k, v, bias))
        plain_ms = time_ms(lambda: A.fused_attention_plain(q, k, v, bias), iters)
        qh, kh, vh = (x.transpose(1, 2) for x in (q, k, v))
        mask = bias[:, None, None, :].to(dtype)
        library_ms = time_ms(
            lambda: F.scaled_dot_product_attention(qh, kh, vh, attn_mask=mask),
            iters)
        peak = PEAK_BF16 if dtype == torch.bfloat16 else PEAK_TF32
        bound_ms, by = bound(4 * b * h * t * t * d, peak,
                             4 * b * t * h * d * q.element_size() + b * t * 4)
        cases.append(dict(
            dtype=str(dtype).split(".")[1], shape=[b, t, h, d], max_abs_err=err,
            max_rel_err=rel, tolerance=TOL[dtype], ms=ms, device_ms=dev_ms,
            plain_ms=plain_ms, library_ms=library_ms, bound_ms=bound_ms, bound_by=by,
        ))
    return cases


def _attention_inputs(gen, dev, dtype, b, t, h=2, d=192):
    """q, k, v, bias and seeds of one case: ragged lengths with one full row
    and one fully padded row, seeds of either sign."""
    q, k, v = (torch.randn(b, t, h, d, generator=gen).to(dev, dtype)
               for _ in range(3))
    lens = torch.randint(1, t + 1, (b,), generator=gen)
    lens[0], lens[1] = t, 0
    bias = ((torch.arange(t)[None, :] >= lens[:, None]).float() * -1e9).to(dev)
    seeds = torch.randint(-2 ** 31, 2 ** 31, (b,), generator=gen).to(dev, torch.int32)
    return q, k, v, bias, seeds


DROPOUT_RATE = 0.1


def check_attention_dropout(gen, dev):
    """The forward kernel at rate 0.1 against the plain forward with the same
    Philox mask, then the mask itself read back out of the kernel."""
    from emotts_torch.ops import attention as A

    cases = []
    rate, h, d = DROPOUT_RATE, 2, 192
    for dtype, b, t, iters in ((torch.bfloat16, 16, 512, 5),
                               (torch.bfloat16, 16, 1024, 3),
                               (torch.float32, 8, 512, 5),
                               (torch.float32, 3, 200, 10)):
        q, k, v, bias, seeds = _attention_inputs(gen, dev, dtype, b, t)
        got = A.fused_attention(q, k, v, bias, seeds, rate)
        torch.cuda.synchronize()
        want = A.fused_attention_plain(q, k, v, bias, seeds, rate)
        err, rel = compare(got, want, **TOL[dtype])
        again = A.fused_attention(q, k, v, bias, seeds, rate)
        if not torch.equal(got, again):
            raise AssertionError("the forward kernel is not repeatable at rate > 0")
        ms = time_ms(lambda: A.fused_attention(q, k, v, bias, seeds, rate), iters)
        dev_ms = device_ms(lambda: A.fused_attention(q, k, v, bias, seeds, rate))
        ms_rate0 = time_ms(lambda: A.fused_attention(q, k, v, bias), iters)
        plain_ms = time_ms(
            lambda: A.fused_attention_plain(q, k, v, bias, seeds, rate), iters)
        peak = PEAK_BF16 if dtype == torch.bfloat16 else PEAK_TF32
        bound_ms, by = bound(4 * b * h * t * t * d, peak,
                             4 * b * t * h * d * q.element_size() + b * t * 4 + b * 4)
        cases.append(dict(
            dtype=str(dtype).split(".")[1], shape=[b, t, h, d], rate=rate,
            max_abs_err=err, max_rel_err=rel, tolerance=TOL[dtype], ms=ms,
            device_ms=dev_ms, ms_rate0=ms_rate0, plain_ms=plain_ms, library_ms=None,
            bound_ms=bound_ms, bound_by=by,
        ))
        del q, k, v, got, want, again
        torch.cuda.empty_cache()
    # With q = k = 0 every probability is 1/T, and with V the identity (T = D)
    # the output is the dropped-out probability matrix itself: the kernel's
    # keep-mask can be read from it and held against the PyTorch Philox.
    b, t = 4, d
    zeros = torch.zeros(b, t, h, d, device=dev)
    eye = torch.eye(t, device=dev)[None, :, None, :].expand(b, t, h, d).contiguous()
    seeds = torch.tensor([7, -7, 7, 2 ** 31 - 1], dtype=torch.int32, device=dev)
    out = A.fused_attention(zeros, zeros, eye, torch.zeros(b, t, device=dev),
                            seeds, rate)
    torch.cuda.synchronize()
    kept = out.permute(0, 2, 1, 3) > 0  # (B, H, query, key)
    want = A.philox_keep_mask(seeds, h, t, rate)
    if not torch.equal(kept, want):
        raise AssertionError("the kernel's keep-mask is not the Philox mask")
    scaled = out[out > 0]
    if not torch.allclose(scaled, torch.full_like(scaled, 1.0 / (t * (1.0 - rate))),
                          rtol=1e-6, atol=0):
        raise AssertionError("kept probabilities are not scaled by 1/(1-rate)")
    fraction = kept.float().mean().item()
    # 4*2*192*192 draws: the standard error of the fraction is 5.5e-4
    if abs(fraction - (1.0 - rate)) > 4e-3:
        raise AssertionError(f"kept fraction {fraction}, expected {1.0 - rate}")
    if torch.equal(kept[0, 0], kept[0, 1]) or torch.equal(kept[0], kept[1]):
        raise AssertionError("two heads or two examples share a mask")
    if not torch.equal(kept[0], kept[2]):
        raise AssertionError("equal seeds in one batch give different masks")
    return cases, dict(kept_fraction=fraction, expected=1.0 - rate,
                       mask_equals_philox=True, draws=int(kept.numel()))


def check_attention_bwd(gen, dev):
    """The backward kernels against the plain backward, rate 0 and 0.1."""
    from emotts_torch.ops import attention as A

    cases = []
    h = 2
    # bf16 over 10 calls: over fewer, the host time of the first call shows
    # in the wall time of a kernel that takes half a millisecond
    for dtype, b, t, iters, d in ((torch.bfloat16, 16, 512, 10, 192),
                                  (torch.bfloat16, 16, 1024, 10, 192),
                                  (torch.float32, 8, 512, 3, 192),
                                  (torch.float32, 3, 200, 5, 192),
                                  (torch.bfloat16, 128, 320, 10, 192),
                                  (torch.bfloat16, 16, 777, 10, 192),
                                  # the other head dims' tensor-core instances
                                  (torch.bfloat16, 8, 250, 10, 64),
                                  (torch.bfloat16, 8, 250, 10, 256)):
        q, k, v, bias, seeds = _attention_inputs(gen, dev, dtype, b, t, d=d)
        dout = torch.randn(b, t, h, d, generator=gen).to(dev, dtype)
        size = q.element_size()
        peak = PEAK_BF16 if dtype == torch.bfloat16 else PEAK_TF32
        # 4 reads (q, k, v, dO) + 3 writes, the row statistics the design
        # reads, the bias and the seeds
        nbytes = (7 * b * t * h * d * size + 2 * b * h * t * 4 + b * t * 4 + b * 4)
        bound_ms, by = bound(10 * b * h * t * t * d, peak, nbytes)
        for rate in (0.0, DROPOUT_RATE):
            _, stats = A.attention_forward(q, k, v, bias, seeds, rate,
                                             want_stats=True)
            got = A.attention_backward(q, k, v, bias, seeds, stats, dout, rate)
            torch.cuda.synchronize()
            want = A.fused_attention_bwd_plain(q, k, v, bias, dout, seeds, rate)
            errs = [compare(g, w, **TOL[dtype]) for g, w in zip(got, want)]
            again = A.attention_backward(q, k, v, bias, seeds, stats, dout, rate)
            if not all(torch.equal(a, g) for a, g in zip(again, got)):
                raise AssertionError("a repeated backward gives other bits")
            del want, again
            ms = time_ms(lambda: A.attention_backward(
                q, k, v, bias, seeds, stats, dout, rate), iters)
            dev_ms = device_ms(lambda: A.attention_backward(
                q, k, v, bias, seeds, stats, dout, rate))
            plain_ms = time_ms(lambda: A.fused_attention_bwd_plain(
                q, k, v, bias, dout, seeds, rate), iters)
            library_ms = None
            if rate == 0.0:
                qh, kh, vh = (x.transpose(1, 2).detach().requires_grad_()
                              for x in (q, k, v))
                mask = bias[:, None, None, :].to(dtype)
                gh = dout.transpose(1, 2)

                def sdpa_fwd():
                    return F.scaled_dot_product_attention(qh, kh, vh, attn_mask=mask)

                def sdpa_both():
                    torch.autograd.grad(sdpa_fwd(), (qh, kh, vh), gh)

                with torch.no_grad():
                    fwd_ms = time_ms(sdpa_fwd, iters)
                library_ms = time_ms(sdpa_both, iters) - fwd_ms
            cases.append(dict(
                dtype=str(dtype).split(".")[1], shape=[b, t, h, d], rate=rate,
                max_abs_err=max(e[0] for e in errs),
                max_rel_err=max(e[1] for e in errs), tolerance=TOL[dtype],
                repeat_equal_bits=True, ms=ms, device_ms=dev_ms, plain_ms=plain_ms,
                library_ms=library_ms, bound_ms=bound_ms, bound_by=by,
                operations_algorithm=10 * b * h * t * t * d,
                operations_as_designed=18 * b * h * t * t * d,
            ))
            del stats, got
        del q, k, v, dout
        torch.cuda.empty_cache()
    return cases


def _block_weights(gen, dev, c, k, n_d=3):
    std = 0.5 / math.sqrt(k * c)
    w1, w2 = (torch.randn(n_d, k, c, c, generator=gen).mul_(std).to(dev)
              for _ in range(2))
    b1, b2 = (torch.randn(n_d, c, generator=gen).mul_(0.1).to(dev) for _ in range(2))
    return w1, b1, w2, b2


def _chain_ops(b, t, c, ks, n_d=3):
    return 2 * b * t * sum(2 * n_d * k for k in ks) * c * c


def _as_designed(b, t, c, chains, split, algorithm_ops, ms):
    """What the vocoder kernels' design computes, beside the algorithm:
    ``chains`` is [(kernel size, dilations, tile), ...], one per chain a tile
    runs (csrc/resblock_common.cuh::resblock_chain); ``split`` is the tensor
    products a term (3 for 3xTF32, 1 for one TF32 product).  halo_ratio:
    rows computed per row kept, weighted by taps; operations_as_designed:
    split x halo_ratio x algorithm operations; tensor_tflops: what those
    take per second at the kernel's time."""
    from emotts_torch.ops.resblock import chain_rows

    rows = sum(-(-t // tile) * chain_rows(k, dil, tile) for k, dil, tile in chains)
    ops = 2 * b * rows * c * c * split
    return dict(halo_ratio=ops / split / algorithm_ops, split=split,
                operations=algorithm_ops, operations_as_designed=ops,
                tensor_tflops=ops / (ms * 1e-3) / 1e12)


def check_resblock(gen, dev, frames, batch):
    from emotts_torch.ops import resblock as R

    cases = []
    c, dil = 256, (1, 3, 5)
    for dtype in (torch.float32, torch.bfloat16):
        # the main path's shape for each kernel size, then a short sequence
        # whose length is a multiple of no tile (edge masks, ragged last tile)
        for k, rows, t in ((3, batch, 8 * frames), (7, batch, 8 * frames),
                            (11, batch, 8 * frames), (11, 2, 1000)):
            x = torch.randn(rows, t, c, generator=gen).to(dev, dtype)
            w = _block_weights(gen, dev, c, k)
            got = R.fused_resblock1(x, *w, dil)
            torch.cuda.synchronize()
            want = R.fused_resblock1_plain(x, *w, dil)
            err, rel = compare(got, want, **TOL[dtype])
            ms = time_ms(lambda: R.fused_resblock1(x, *w, dil), 2)
            plain_ms = time_ms(lambda: R.fused_resblock1_plain(x, *w, dil), 2)
            peak = PEAK_BF16 if dtype == torch.bfloat16 else PEAK_TF32
            nbytes = 2 * x.numel() * x.element_size() + sum(a.numel() * 4 for a in w)
            ops = _chain_ops(rows, t, c, (k,))
            bound_ms, by = bound(ops, peak, nbytes)
            plan = [(first, last, min(tile, -(-t // 8) * 8))
                    for first, last, tile in R.launch_plan(c, k, dil)]
            cases.append(dict(
                dtype=str(dtype).split(".")[1], shape=[rows, t, c], k=k,
                cuda_launches=len(plan), tiles=[p[2] for p in plan],
                max_abs_err=err, max_rel_err=rel, tolerance=TOL[dtype], ms=ms,
                plain_ms=plain_ms, library_ms=None, bound_ms=bound_ms, bound_by=by,
                # 3xTF32 in both instances: the residual is an fp32 sum
                **_as_designed(rows, t, c, [(k, dil[a:b], tile) for a, b, tile in plan],
                               3, ops, ms),
            ))
    return cases


def check_mrf(gen, dev, frames, batch):
    from emotts_torch.ops import mrf as M

    cases = []
    ks, dil = (3, 7, 11), (1, 3, 5)
    for dtype in (torch.float32, torch.bfloat16):
        # the main path's three stages, then short sequences whose lengths
        # are a multiple of no tile (edge masks, ragged last tile)
        for c, rows, t in ((128, batch, 64 * frames), (64, batch, 128 * frames),
                            (32, batch, 256 * frames), (128, 2, 777), (32, 3, 333)):
            x = torch.randn(rows, t, c, generator=gen).to(dev, dtype)
            params = [_block_weights(gen, dev, c, k) for k in ks]
            got = M.fused_mrf_stage(x, params, ks, dil)
            torch.cuda.synchronize()
            want = M.fused_mrf_stage_plain(x, params, ks, dil)
            err, rel = compare(got, want, **TOL[dtype])
            del got, want
            ms = time_ms(lambda: M.fused_mrf_stage(x, params, ks), 2)
            plain_ms = time_ms(lambda: M.fused_mrf_stage_plain(x, params, ks), 2)
            peak = PEAK_BF16 if dtype == torch.bfloat16 else PEAK_TF32
            nbytes = (2 * x.numel() * x.element_size()
                      + sum(a.numel() * 4 for blk in params for a in blk))
            ops = _chain_ops(rows, t, c, ks)
            bound_ms, by = bound(ops, peak, nbytes)
            plan = [(rb, j, min(tile, -(-t // 8) * 8))
                    for rb, j, tile in M.launch_plan(c, ks, dil)]
            chains = ([(k, dil, plan[0][2]) for k in ks] if plan[0][0] is None
                      else [(ks[rb], (dil[j],), tile) for rb, j, tile in plan])
            cases.append(dict(
                dtype=str(dtype).split(".")[1], shape=[rows, t, c],
                cuda_launches=len(plan), tiles=[p[2] for p in plan],
                max_abs_err=err, max_rel_err=rel, tolerance=TOL[dtype], ms=ms,
                plain_ms=plain_ms, library_ms=None, bound_ms=bound_ms, bound_by=by,
                # bf16: operands exact in bf16, one TF32 product a term
                **_as_designed(rows, t, c, chains,
                               1 if dtype == torch.bfloat16 else 3, ops, ms),
            ))
            del x, params
            torch.cuda.empty_cache()
    return cases


# --------------------------------------------------------------------------
# phases 4-7: the model behind its entry points
# --------------------------------------------------------------------------


def full_width_config(compute_dtype="bfloat16", kernels=True):
    from emotts_torch.utils.config import Config

    cfg = Config()  # FS2 6+6 layers, d_model 384, 2 heads; HiFi-GAN V1
    cfg.fastspeech2.fused_attention = kernels
    cfg.train_fs2.compute_dtype = compute_dtype
    return cfg


def vocoder_structure(cfg, kernels=True):
    v = cfg.train_vocoder  # the generator defaults: V1 at 16 kHz
    flags = KERNEL_CONFIG if kernels else {}
    return dict(
        in_channels=cfg.audio.n_mels,
        upsample_initial_channel=v.upsample_initial_channel,
        upsample_rates=tuple(v.upsample_rates),
        upsample_kernel_sizes=tuple(v.upsample_kernel_sizes),
        resblock_kernel_sizes=tuple(v.resblock_kernel_sizes),
        resblock_dilations=tuple(tuple(d) for d in v.resblock_dilations),
        **flags,
    )


def seeded_weights(cfg):
    """state_dicts of a full-width FastSpeech2 and generator from SEED.

    Zero-centred duration weights predict no frames at all, so the duration
    predictor's output bias is set to log1p(4): about four frames a phone.
    That is a choice of weights, not of code."""
    from emotts_torch.infer.synthesize import build_fastspeech2
    from emotts_torch.nn.hifigan import HiFiGANGenerator
    from emotts_torch.nn.init import seeded_init_

    gen = torch.Generator().manual_seed(SEED)
    fs2 = seeded_init_(build_fastspeech2(cfg), gen)
    with torch.no_grad():
        fs2.duration_predictor.out.bias.fill_(math.log1p(4.0))
        fs2.duration_predictor.out.weight.mul_(0.3)
    voc = seeded_init_(HiFiGANGenerator(**vocoder_structure(cfg)), gen)
    with torch.no_grad():
        # a transposed conv of stride u sums k/u of its k taps per output:
        # scale back so the signal keeps its level through the upsampling
        for kernel, u in zip(voc.up_kernels, voc.upsample_rates):
            kernel.mul_(math.sqrt(u))
    bank = np.random.default_rng(SEED).standard_normal(
        (cfg.n_speakers, cfg.n_emotions, cfg.inference.bucket_size, cfg.n_emotions)
    ).astype(np.float32)
    return fs2.state_dict(), voc.state_dict(), bank


class ForwardCounter:
    """Counts forwards of the two models, to say how many launches to expect."""

    def __init__(self, synth):
        self.fs2 = self.vocoder = 0
        self._hooks = [
            synth.model.register_forward_hook(self._count("fs2")),
            synth.vocoder.register_forward_hook(self._count("vocoder")),
        ]

    def _count(self, name):
        def hook(module, args, output):
            setattr(self, name, getattr(self, name) + 1)
        return hook

    def close(self):
        for h in self._hooks:
            h.remove()


def wav_samples(data):
    with wave.open(io.BytesIO(data), "rb") as w:
        assert w.getnchannels() == 1 and w.getsampwidth() == 2
        return np.frombuffer(w.readframes(w.getnframes()), "<i2"), w.getframerate()


def check_audio(pcm, cfg, n_sentences, what):
    hop, sr = cfg.audio.hop_length, cfg.audio.sampling_rate
    gap = int(0.15 * sr) * (n_sentences - 1)
    speech = len(pcm) - gap
    if len(pcm) == 0 or speech <= 0:
        raise AssertionError(f"{what}: empty audio")
    if speech % hop or speech > n_sentences * cfg.fastspeech2.max_mel_len * hop:
        raise AssertionError(
            f"{what}: {len(pcm)} samples is not {n_sentences} sentence(s) of "
            f"whole {hop}-sample frames joined by {gap} samples of silence")
    if np.abs(pcm.astype(np.int32)).max() < 100:
        raise AssertionError(f"{what}: audio is silent")
    return len(pcm) / sr


def post(base, path, obj):
    req = urllib.request.Request(
        base + path, data=json.dumps(obj).encode(),
        headers={"Content-Type": "application/json"},
    )
    t0 = time.perf_counter()
    with urllib.request.urlopen(req, timeout=600) as r:
        body = r.read()
    return body, 1e3 * (time.perf_counter() - t0)


def serve_phase(cfg, synth):
    from emotts_torch.infer.server import make_server

    httpd = make_server(cfg, synth, port=0)
    thread = threading.Thread(target=httpd.serve_forever, daemon=True)
    thread.start()
    base = f"http://127.0.0.1:{httpd.server_address[1]}"
    try:
        with urllib.request.urlopen(base + "/health", timeout=60) as r:
            health = json.loads(r.read())
        if health["status"] != "ok" or not health["vocoder"]:
            raise AssertionError(f"/health: {health}")
        results = []
        for name, n_sent, req in (
            # the first request also pays for cuDNN/cuBLAS start-up
            ("cold", 1, {"text": "Warm up.", "speaker": 0, "emotion": 0}),
            ("plain", 1, {"text": "Gregson was asleep when he re-entered the cabin.",
                          "speaker": "bea", "emotion": "amused", "level": 1}),
            ("emotion_mix", 1, {"text": "That is a fine way to say good morning.",
                                "speaker": "josh", "level": 2,
                                "emotion_mix": {"angry": 0.6, "sleepy": 0.4}}),
            ("multi_sentence", 3, {"text": "The ship was quiet. Nobody had slept "
                                           "for two days. Then the lights came on.",
                                   "speaker": "sam", "emotion": "disgusted",
                                   "level": 0.5, "intensity_scale": 1.2}),
        ):
            body, ms = post(base, "/synthesize", req)
            pcm, sr = wav_samples(body)
            seconds = check_audio(pcm, cfg, n_sent, f"/synthesize {name}")
            results.append(dict(request=name, latency_ms=ms, audio_s=seconds))
        body, ms = post(base, "/batch", {"requests": [
            {"text": "First request of the batch.", "speaker": 0, "emotion": 0},
            {"text": "Second one, angrier.", "speaker": 1, "emotion": "angry",
             "level": 2},
        ]})
        wavs = json.loads(body)["wavs_b64"]
        if len(wavs) != 2:
            raise AssertionError("/batch: expected two waveforms")
        seconds = sum(
            check_audio(wav_samples(base64.b64decode(w))[0], cfg, 1, "/batch")
            for w in wavs)
        results.append(dict(request="batch_of_2", latency_ms=ms, audio_s=seconds))
        # a streaming request must be refused, not answered unstreamed
        try:
            post(base, "/synthesize", {"text": "x", "speaker": 0, "emotion": 0,
                                       "stream": True})
            raise AssertionError("a streaming request was not refused")
        except urllib.error.HTTPError as e:
            if e.code != 501:
                raise AssertionError(f"streaming request: HTTP {e.code}")
    finally:
        httpd.shutdown()
        httpd.server_close()
        thread.join(timeout=30)
    if thread.is_alive():
        raise AssertionError("the server thread did not stop")
    return health, results


def sweep_phase(cfg, synth):
    text = cfg.inference.text
    synth.intensity_sweep(text)  # warm: allocator, cuDNN choices
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = synth.intensity_sweep(text)
    torch.cuda.synchronize()
    wall_ms = 1e3 * (time.perf_counter() - t0)
    n = cfg.n_speakers * cfg.n_emotions * cfg.inference.bucket_size
    if len(out) != n:
        raise AssertionError(f"sweep returned {len(out)} of {n} utterances")
    hop = cfg.audio.hop_length
    for key, wav in out.items():
        if wav.size == 0 or wav.size % hop or not np.isfinite(wav).all():
            raise AssertionError(f"sweep {key}: bad waveform of {wav.size} samples")
        if np.abs(wav).max() < 100 / 32767.0:
            raise AssertionError(f"sweep {key}: silent")
    audio_s = sum(w.size for w in out.values()) / cfg.audio.sampling_rate
    return dict(utterances=n, wall_ms=wall_ms, audio_s=audio_s,
                real_time_factor=wall_ms / 1e3 / audio_s)


def parity_phase(weights):
    """The kernel path against the plain path through the same entry point,
    in fp32 so that durations cannot flip: equal lengths, PCM within a few
    16-bit steps (summation order through 12 FFT blocks and 4 MRF stages)."""
    from emotts_torch.infer.synthesize import Synthesizer

    fs2_sd, voc_sd, bank = weights
    request = [{"text": "A short line for comparison.", "speaker": 2,
                "emotion": 3, "level": 1.5}]
    waves = {}
    for kernels in (True, False):
        cfg = full_width_config("float32", kernels)
        synth = Synthesizer(cfg, fs2_sd, voc_sd, bank,
                            vocoder_structure=vocoder_structure(cfg, kernels))
        waves[kernels] = synth.synthesize_requests(request)[0]
        del synth
    a, b = waves[True], waves[False]
    if a.shape != b.shape or a.size == 0:
        raise AssertionError(f"kernel path {a.shape} vs plain path {b.shape}")
    if np.abs(b).max() < 0.01:
        raise AssertionError("the waveform is too quiet to compare anything")
    steps = float(np.abs(np.round(a * 32767.0) - np.round(b * 32767.0)).max())
    limit = 8.0
    if steps > limit:
        raise AssertionError(f"kernel path differs from plain path by {steps} "
                             f"16-bit steps (limit {limit})")
    return dict(samples=int(a.size), peak=float(np.abs(b).max()),
                max_pcm_steps=steps, limit_pcm_steps=limit)


# --------------------------------------------------------------------------
# phases 8-11: rank-model training, then bucketization
# --------------------------------------------------------------------------

TRAIN_LR = 3e-5  # the default 1e-6 moves nothing in a few tens of steps


def make_rank_corpus(root, cfg, seed, utts_per_cell=6):
    """A preprocessed corpus in the format RankPairDataset reads, made with
    numpy from ``seed``: ``<speaker>/<emotion>_<id>.npz`` with ``mel``
    (n_mels, T), ``pitch`` (T,), ``energy`` (T,), and ``train.txt`` /
    ``test.txt`` lines ``speaker|emotion|emo_id|neu_id``.

    An utterance's length class follows its id, so the pairs spread over the
    frame buckets up to the largest.  An emotional utterance is a neutral-like
    one plus its emotion's seeded channel offset at a per-utterance strength:
    something to rank."""
    rng = np.random.default_rng(seed)
    n_ch = cfg.audio.n_mels + 2
    length_classes = [(150, 190), (250, 318), (420, 510), (600, 760),
                      (800, 1020), (200, 300)]
    offsets = rng.standard_normal((cfg.n_emotions, n_ch)).astype(np.float32)
    os.makedirs(root, exist_ok=True)
    for speaker in cfg.data.speakers:
        os.makedirs(os.path.join(root, speaker), exist_ok=True)
        for ei, emotion in enumerate(cfg.data.emotions):
            for i in range(utts_per_cell):
                lo, hi = length_classes[i % len(length_classes)]
                t = int(rng.integers(lo, hi + 1))
                x = rng.standard_normal((n_ch, t)).astype(np.float32)
                x = (x + np.roll(x, 1, axis=1) + np.roll(x, 2, axis=1)) / np.sqrt(3.0)
                if ei > 0:
                    x += rng.uniform(0.3, 1.0) * offsets[ei][:, None]
                np.savez(os.path.join(root, speaker, f"{emotion}_{i:04d}.npz"),
                         mel=x[:-2], pitch=x[-2], energy=x[-1])
    train, test = [], []
    for speaker in cfg.data.speakers:
        for emotion in cfg.data.emotions[1:]:
            for i in range(utts_per_cell - 1):
                # a partner of the same length class and one of the next
                for neu in (i, (i + 1) % (utts_per_cell - 1)):
                    train.append(f"{speaker}|{emotion}|{i:04d}|{neu:04d}")
            last = utts_per_cell - 1
            test.append(f"{speaker}|{emotion}|{last:04d}|{last:04d}")
    for name, lines in (("train.txt", train), ("test.txt", test)):
        with open(os.path.join(root, name), "w") as f:
            f.write("\n".join(lines) + "\n")
    return dict(train_pairs=len(train), test_pairs=len(test))


def rank_config(root, compute_dtype="bfloat16"):
    """Config() defaults — the full-width rank model — over the seeded corpus."""
    from emotts_torch.utils.config import Config

    cfg = Config()  # 6 FFT layers, hidden 384, 2 heads of 192, conv-FFN 1536
    cfg.data.preprocessed_path = os.path.join(root, "preprocessed")
    cfg.data.experiment_path = os.path.join(root, "experiments")
    cfg.rank_model.fused_attention = True
    t = cfg.train_rank
    t.compute_dtype = compute_dtype
    t.learning_rate = TRAIN_LR
    t.n_epochs = 2
    t.max_iterations = 30  # reached inside the second epoch
    t.selection_metric = "informative"
    return cfg


class ExtractorCounter:
    """Counts forwards of every IntensityExtractor, to say how many attention
    launches to expect."""

    def __init__(self):
        from emotts_torch.nn.intensity import IntensityExtractor

        self.forwards = 0

        def hook(module, args, output):
            if isinstance(module, IntensityExtractor):
                self.forwards += 1

        self._hook = torch.nn.modules.module.register_module_forward_hook(hook)

    def close(self):
        self._hook.remove()


def read_metrics(exp):
    series = {}
    with open(os.path.join(exp, "metrics.jsonl")) as f:
        for line in f:
            rec = json.loads(line)
            series.setdefault(rec["tag"], []).append(rec["value"])
    return series


def train_phase(cfg, dev):
    """RankTrainer.fit on the card, then restore + one step against the step
    the uninterrupted run takes."""
    from emotts_torch.train.rank_trainer import RankTrainer

    trainer = RankTrainer(cfg, device=dev)
    losses, step_ms, buckets = [], [], []
    step = trainer.train_step

    def recorded_step(batch, lambdas=None):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        metrics = step(batch, lambdas)
        torch.cuda.synchronize()
        step_ms.append(1e3 * (time.perf_counter() - t0))
        losses.append(metrics["loss"])
        buckets.append(int(batch["emo_x"].shape[1]))
        return metrics

    trainer.train_step = recorded_step
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    exp = trainer.fit(verbose=False)
    fit_s = time.perf_counter() - t0
    peak_bytes = torch.cuda.max_memory_allocated()
    trainer.train_step = step

    if not losses or not np.isfinite(losses).all():
        raise AssertionError(f"training losses are not all finite: {losses}")
    if len(set(buckets)) < 3 or max(buckets) != max(cfg.bucketing.frame_buckets):
        raise AssertionError(f"the batches cover the buckets {sorted(set(buckets))} only")
    tail = float(np.mean(losses[-5:]))
    if not tail < losses[0]:
        raise AssertionError(f"the training loss did not fall: first {losses[0]}, "
                             f"mean of the last five {tail}")
    series = read_metrics(exp)
    for tag in ("train/loss", "valid/loss", "valid/loss_informative",
                "valid/pair_order_acc"):
        if tag not in series or not np.isfinite(series[tag]).all():
            raise AssertionError(f"metrics.jsonl lacks a finite {tag}")
    checkpoints = sorted(os.listdir(os.path.join(exp, "checkpoints")))
    if not checkpoints or not os.path.isfile(os.path.join(exp, "best", "params.pt")):
        raise AssertionError("fit left no checkpoint or no best/ export")

    # resume: the last checkpoint holds the state fit ended in
    batch = next(iter(trainer._loader("train", shuffle=True).epoch(0)))
    want = trainer.train_step(batch)
    fresh = RankTrainer(cfg, device=dev)
    if not fresh.restore(exp) or fresh.state.step != trainer.state.step - 1:
        raise AssertionError("restore found no checkpoint of the last step")
    got = fresh.train_step(batch)
    # the forward pass is deterministic, so the loss must be the same bits;
    # the library's convolution backward may sum in another order, so the
    # updated parameters are held to 1e-6 (a step moves a weight by ~3e-4)
    if got != want:
        raise AssertionError(f"resumed step {got} differs from the uninterrupted {want}")
    drift = max((a - b).abs().max().item() for a, b in zip(
        fresh.model.state_dict().values(), trainer.model.state_dict().values()))
    if drift > 1e-6:
        raise AssertionError(f"parameters after the resumed step differ by {drift}")
    by_bucket = {str(t): float(np.mean([m for m, b in zip(step_ms[1:], buckets[1:])
                                        if b == t]))
                 for t in sorted(set(buckets[1:]))}
    return exp, dict(
        steps=len(losses), learning_rate=TRAIN_LR, first_loss=losses[0],
        mean_last_five=tail, losses=losses, fit_seconds=fit_s,
        step_ms_mean_after_first=float(np.mean(step_ms[1:])),
        step_ms_by_frame_bucket=by_bucket, first_step_ms=step_ms[0],
        peak_memory_bytes=int(peak_bytes),
        valid={k.split("/")[1]: v for k, v in series.items() if k.startswith("valid/")},
        checkpoints=checkpoints, resumed_step_loss=got["loss"],
        resumed_step_equal_bits=True, resumed_parameter_drift=drift,
    )


def bucketize_phase(cfg, exp, dev):
    from emotts_torch.infer.bucketize import bucketize

    t0 = time.perf_counter()
    path = bucketize(cfg, exp, device=dev)
    seconds = time.perf_counter() - t0
    bank = np.load(path)
    want = (cfg.n_speakers, cfg.n_emotions, cfg.inference.bucket_size, cfg.n_emotions)
    if bank.shape != want or not np.isfinite(bank).all() or not np.abs(bank).max() > 0:
        raise AssertionError(f"bank of shape {bank.shape}, expected a finite {want}")
    with open(os.path.join(exp, "intensity_meta.json")) as f:
        meta = json.load(f)
    return bank, dict(seconds=seconds, shape=list(bank.shape),
                      abs_max=float(np.abs(bank).max()), spread=meta)


def serve_with_bank(weights, bank):
    """The serving path answers one request with the bank bucketize wrote."""
    from emotts_torch.infer.synthesize import Synthesizer

    cfg = full_width_config()
    synth = Synthesizer(cfg, weights[0], weights[1], bank,
                        vocoder_structure=vocoder_structure(cfg))
    wav = synth.synthesize_requests([{"text": "The bank is new.", "speaker": 1,
                                      "emotion": 2, "level": 2}])[0]
    if wav.size == 0 or not np.isfinite(wav).all() or np.abs(wav).max() < 100 / 32767.0:
        raise AssertionError("no audio with the bucketized bank")
    return dict(samples=int(wav.size), peak=float(np.abs(wav).max()))


def train_profile_phase(cfg, dev):
    """Where a train step's time goes, at the smallest and the largest frame
    bucket: wall time of a step, and the device time of its kernels by name
    from a torch.profiler trace of three steps.  A reading, not a check: it
    only fails if a step fails."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from emotts_torch.train.rank_trainer import RankTrainer

    trainer = RankTrainer(cfg, device=dev)
    first = {}
    loader = trainer._loader("train", shuffle=True)
    loader.plan_epoch(0)  # reads every length once; not part of a batch's cost
    t0 = time.perf_counter()
    for batch in loader.epoch(0):
        first.setdefault(int(batch["emo_x"].shape[1]), batch)
    loader_ms = 1e3 * (time.perf_counter() - t0) / loader.batches_per_epoch(0)
    groups = (("attention_forward", "attention_fwd_"),
              ("attention_backward", "attention_bwd_"))
    # the loader alone, nothing else running: its thread shares the
    # interpreter with the step's launches while fit runs
    out = {"loader_host_ms_per_batch": loader_ms}
    for frames in (min(first), max(first)):
        batch = first[frames]
        for _ in range(2):
            trainer.train_step(batch)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(5):
            trainer.train_step(batch)
        torch.cuda.synchronize()
        wall_ms = 1e3 * (time.perf_counter() - t0) / 5
        steps = 3
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(steps):
                trainer.train_step(batch)
            torch.cuda.synchronize()
        # kernels only: an annotation's row (the optimizer's step) spans the
        # kernels under it and would count them twice
        kernels = [e for e in prof.key_averages()
                   if e.device_type == DeviceType.CUDA
                   and not e.key.startswith("Optimizer.")]
        step_ms = sum(e.self_device_time_total for e in kernels) / steps / 1e3
        reading = dict(rows=2 * len(batch["lengths"]), wall_ms_per_step=wall_ms,
                       device_ms_per_step=step_ms or None,
                       kernel_launches_per_step=sum(e.count for e in kernels) // steps)
        if step_ms:
            reading["device_idle_share"] = max(0.0, 1.0 - step_ms / wall_ms)
            rest = step_ms
            for label, needle in groups:
                ms = sum(e.self_device_time_total for e in kernels
                         if needle in e.key) / steps / 1e3
                reading[f"{label}_ms"] = ms
                rest -= ms
            reading["other_kernels_ms"] = rest
            reading["largest_other_kernels"] = [
                [e.key[:60], e.self_device_time_total / steps / 1e3]
                for e in sorted(kernels, key=lambda e: -e.self_device_time_total)
                if not any(n in e.key for _, n in groups)][:4]
        out[str(frames)] = reading
    return out


def train_parity_phase(root, dev):
    """One fp32 train step at full width: loss and every parameter's gradient
    through the kernels against the same step with the plain forward and
    backward put in their place (same weights, batch, λ, dropout masks)."""
    from emotts_torch.losses.rank import rank_loss
    from emotts_torch.ops import attention as A
    from emotts_torch.train.rank_trainer import RankTrainer, batch_to_device

    cfg = rank_config(root, "float32")
    trainer = RankTrainer(cfg, device=dev)
    batch = next(iter(trainer._loader("train", shuffle=True).epoch(0)))
    b = batch_to_device(batch, dev)
    lambdas = torch.rand((2, b["emo_x"].shape[0]),
                         generator=torch.Generator().manual_seed(SEED)).to(dev)
    gen = trainer.state.generators["dropout"]
    start = gen.get_state()

    def step():
        gen.set_state(start)
        trainer.model.zero_grad(set_to_none=True)
        preds = trainer.model(b["emo_x"], b["neu_x"], b["emotions"], b["lengths"],
                              lambdas, deterministic=False, dropout_generator=gen)
        loss, _ = rank_loss(preds, b["emotions"], cfg.rank_model.alpha,
                            cfg.rank_model.beta)
        loss.backward()
        return loss.item(), {n: p.grad.clone()
                             for n, p in trainer.model.named_parameters()}

    before = A.launch_count, A.bwd_launch_count
    loss_k, grads_k = step()
    if (A.launch_count, A.bwd_launch_count) == before:
        raise AssertionError("the kernel step launched no kernel")

    def plain_forward(q, k, v, bias, seeds=None, rate=0.0, want_stats=False):
        return A.fused_attention_plain(q, k, v, bias, seeds, rate), None

    def plain_backward(q, k, v, bias, seeds, stats, dout, rate=0.0):
        return A.fused_attention_bwd_plain(q, k, v, bias, dout, seeds, rate)

    kernels = A.attention_forward, A.attention_backward
    A.attention_forward, A.attention_backward = plain_forward, plain_backward
    try:
        before = A.launch_count, A.bwd_launch_count
        loss_p, grads_p = step()
        if (A.launch_count, A.bwd_launch_count) != before:
            raise AssertionError("the plain step launched a kernel")
    finally:
        A.attention_forward, A.attention_backward = kernels
    # fp32 on both sides; the two differ in summation order through 6 blocks
    # A parameter's gradient is held to a share of its largest entry, but of
    # no less than a thousandth of the model's largest: the key biases have
    # no gradient at all (a softmax row does not see a constant added to
    # every key), so theirs is rounding noise on both sides.
    loss_rtol, grad_rtol = 1e-5, 1e-3
    largest = max(g.abs().max().item() for g in grads_p.values())
    worst, worst_name = 0.0, None
    for name, g in grads_k.items():
        scale = max(grads_p[name].abs().max().item(), 1e-3 * largest)
        if not torch.isfinite(g).all() or largest == 0.0:
            raise AssertionError(f"gradient of {name} is not finite, or all are zero")
        ratio = (g - grads_p[name]).abs().max().item() / scale
        if ratio > worst:
            worst, worst_name = ratio, name
    if abs(loss_k - loss_p) > loss_rtol * abs(loss_p) or worst > grad_rtol:
        raise AssertionError(
            f"kernel step loss {loss_k} vs plain {loss_p}; worst gradient "
            f"difference {worst} of its largest entry at {worst_name}")
    return dict(frames=int(b["emo_x"].shape[1]), rows=int(2 * b["emo_x"].shape[0]),
                loss_kernels=loss_k, loss_plain=loss_p, loss_rtol=loss_rtol,
                parameters=len(grads_k), worst_gradient_difference=worst,
                worst_at=worst_name, gradient_rtol_of_largest_entry=grad_rtol)


def main():
    if not torch.cuda.is_available():
        print("chip_smoke.py needs an NVIDIA GPU: torch.cuda.is_available() "
              "is false", file=sys.stderr)
        return 2
    t_start = time.perf_counter()
    dev = torch.device("cuda", 0)
    card = card_line()
    print(card, flush=True)
    emit("card", nvidia_smi=card, kind=torch.cuda.get_device_name(0),
         python=sys.version.split()[0], torch=torch.__version__,
         cuda=torch.version.cuda)

    from emotts_torch.infer.synthesize import Synthesizer
    from emotts_torch.ops import _build, attention, mrf, resblock

    # -- 2. build ----------------------------------------------------------
    t0 = time.perf_counter()
    log = _build.build_all()
    emit("build", seconds=time.perf_counter() - t0, libraries={
        name: dict(seconds=entry["seconds"], cached=entry["cached"],
                   nvcc=" ".join(entry["cmd"]) if entry["cmd"] else None)
        for name, entry in log.items()})

    # full fp32 for every float32 matmul and convolution, as the port sets it
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    # -- 3. kernels --------------------------------------------------------
    gen = torch.Generator().manual_seed(SEED)
    frames, chunk_rows = 1024, 16  # max_mel_len frames, rows per vocode chunk
    dropout_cases, mask = check_attention_dropout(gen, dev)
    cases = {
        "fused_attention": check_attention(gen, dev),
        "fused_attention_dropout": dropout_cases,
        "fused_attention_bwd": check_attention_bwd(gen, dev),
        "fused_mrf_stage": check_mrf(gen, dev, frames, chunk_rows),
        "fused_resblock1": check_resblock(gen, dev, frames, chunk_rows),
    }
    for group in cases.values():
        for case in group:
            with_ratios(case)
    emit("kernels", cases=cases, dropout_mask=mask)
    torch.cuda.empty_cache()

    # -- 4-6. the main path, counted ----------------------------------------
    cfg = full_width_config()
    weights = seeded_weights(cfg)
    synth = Synthesizer(cfg, weights[0], weights[1], weights[2],
                        vocoder_structure=vocoder_structure(cfg))
    attention.launch_count = mrf.launch_count = resblock.launch_count = 0
    counter = ForwardCounter(synth)
    health, served = serve_phase(cfg, synth)
    emit("serve", health=health, requests=served)
    emit("sweep", **sweep_phase(cfg, synth))
    launches = dict(fused_attention=attention.launch_count,
                    fused_mrf_stage=mrf.launch_count,
                    fused_resblock1=resblock.launch_count)
    counter.close()

    f2, v = cfg.fastspeech2, cfg.train_vocoder
    per_vocode_resblock = sum(
        len(resblock.launch_plan(256, k, d)) for k, d in zip(
            v.resblock_kernel_sizes, v.resblock_dilations))
    # the stages with C = 128, 64, 32; C = 128 takes one launch per dilation
    # step of each ResBlock
    per_vocode_mrf = sum(
        len(mrf.launch_plan(c, v.resblock_kernel_sizes, v.resblock_dilations[0]))
        for c in (128, 64, 32))
    expected = dict(
        fused_attention=(f2.enc_num_layers + f2.dec_num_layers) * counter.fs2,
        fused_mrf_stage=per_vocode_mrf * counter.vocoder,
        # the C = 256 stage: one ResBlock wrapper call per kernel size; k = 7
        # and k = 11 take one CUDA launch per dilation step there
        fused_resblock1=per_vocode_resblock * counter.vocoder,
    )
    emit("launches", counted=launches, expected=expected,
         fs2_forwards=counter.fs2, generator_forwards=counter.vocoder,
         resblock_cuda_launches_per_generator_forward=per_vocode_resblock,
         mrf_cuda_launches_per_generator_forward=per_vocode_mrf)
    if launches != expected or min(launches.values()) == 0:
        raise AssertionError(f"launch counters {launches}, expected {expected}")
    del synth
    torch.cuda.empty_cache()

    # -- 7. parity -----------------------------------------------------------
    emit("parity", **parity_phase(weights))

    # -- 8-10. training, then bucketization, counted ---------------------------
    with tempfile.TemporaryDirectory(prefix="emotts_smoke_") as root:
        rank_cfg = rank_config(root)
        emit("corpus", seed=SEED, **make_rank_corpus(
            rank_cfg.data.preprocessed_path, rank_cfg, SEED))
        attention.launch_count = attention.bwd_launch_count = 0
        extractor = ExtractorCounter()
        exp, trained = train_phase(rank_cfg, dev)
        emit("train", **trained)
        bank, bucketized = bucketize_phase(rank_cfg, exp, dev)
        emit("bucketize", **bucketized)
        train_launches = dict(fused_attention=attention.launch_count,
                              fused_attention_bwd=attention.bwd_launch_count)
        extractor.close()
        layers = rank_cfg.rank_model.n_encoder_layers
        train_steps = trained["steps"] + 2  # fit, then the two resume steps
        train_expected = dict(
            # every extractor forward (train, the two eval passes, bucketize)
            fused_attention=layers * extractor.forwards,
            fused_attention_bwd=layers * attention.BWD_LAUNCHES_PER_CALL * train_steps,
        )
        emit("train_launches", counted=train_launches, expected=train_expected,
             extractor_forwards=extractor.forwards, train_steps=train_steps,
             cuda_launches_per_backward_call=attention.BWD_LAUNCHES_PER_CALL)
        if train_launches != train_expected or min(train_launches.values()) == 0:
            raise AssertionError(
                f"launch counters {train_launches}, expected {train_expected}")
        emit("serve_with_bank", **serve_with_bank(weights, bank))
        emit("train_profile", **train_profile_phase(rank_cfg, dev))
        torch.cuda.empty_cache()

        # -- 11. train parity ---------------------------------------------------
        emit("train_parity", **train_parity_phase(root, dev))

    # -- summary ---------------------------------------------------------------
    # a kernel's launches over both counted paths
    serve_launches = dict(launches)
    launches["fused_attention_bwd"] = train_launches["fused_attention_bwd"]
    launches["fused_attention"] += train_launches["fused_attention"]
    headline = {  # the case that carries most of the serving path's time
        "fused_attention": lambda c: c["dtype"] == "bfloat16" and c["shape"][1] == 1024,
        # the largest bucket of a training step at batch 8 (16 rows), with dropout
        "fused_attention_bwd": lambda c: (c["dtype"] == "bfloat16" and c["rate"] > 0
                                          and c["shape"][:2] == [16, 1024]),
        "fused_mrf_stage": lambda c: c["dtype"] == "float32" and c["shape"][1:] == [65536, 128],
        "fused_resblock1": lambda c: (c["dtype"] == "float32" and c["k"] == 11
                                      and c["shape"][1] == 8192),
    }
    meta = {
        "fused_attention": ("emotts_torch/csrc/attention.cu", "emotts/ops/attention.py:161"),
        "fused_attention_bwd": ("emotts_torch/csrc/attention_bwd.cu",
                                "emotts/ops/attention.py:174"),
        "fused_mrf_stage": ("emotts_torch/csrc/mrf.cu", "emotts/ops/mrf.py:245"),
        "fused_resblock1": ("emotts_torch/csrc/resblock.cu", "emotts/ops/resblock.py:201"),
    }
    kernels = []
    for name, (source, replaces) in meta.items():
        head = next(c for c in cases[name] if headline[name](c))
        kernels.append(dict(
            name=name, route="cuda", source=source, replaces=replaces,
            launches=launches[name],
            launches_by_path=dict(serving=serve_launches.get(name, 0),
                                  training=train_launches.get(name, 0)),
            max_abs_err=max(c["max_abs_err"] for c in cases[name]
                            + (dropout_cases if name == "fused_attention" else [])),
            ms=head["ms"], plain_ms=head["plain_ms"], bound_ms=head["bound_ms"],
            bound_by=head["bound_by"],
            # the library call is timed without dropout: take that case's time
            library_ms=next((c["library_ms"] for c in cases[name]
                             if c["shape"] == head["shape"] and c["dtype"] == head["dtype"]
                             and c["library_ms"] is not None), None),
            at=dict(dtype=head["dtype"], shape=head["shape"]),
        ))
        with_ratios(kernels[-1])
    emit("done", seconds=time.perf_counter() - t_start)
    print(card, flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
