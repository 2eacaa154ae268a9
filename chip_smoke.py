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
              backward (bf16 on wgmma, fp32 on mma.sync as 3xTF32, at head
              dim 192 and at 64 and 256 for the other instances; each with
              its device time, launches queued behind a sleep kernel, beside
              the wall time, the operations its design does and the tensor
              rate they imply; SDPA's backward timed straight),
              MRF stage, ResBlock (wgmma TF32, 3xTF32 for fp32; each case
              with its tiles and launches, the design's name, the ring's
              depth, the wrapper's packing of the weights timed alone, the
              operations the design does and the tensor rate that implies)
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
12. fs2_train FS2Trainer.fit at full width (bf16, dropout 0.1/0.5, fused
              attention) on the same corpus, conditioned on phase 8's best/
              extractor; checkpoint, best/, resume, the attention launches of
              one step and of the phase, a profiler reading of a step at
              every frame bucket
13. fs2_train_parity  one fp32 FS2 train step through the kernels against
              the same step through the plain versions
14. stream    load_synthesizer from the two experiment directories and a
              seeded .npz vocoder: chunked against unchunked vocoding, warm
              time-to-first-audio, a streamed POST /synthesize, launches
15. preprocess  a raw corpus in EmoV-DB's layout made from the seed through
              prepare_corpus and preprocess_all(device_mel=True): the card's
              mel and energy against the numpy golden, the rank pair lists
              and FS2 splits, every .npz read back
16. evaluate  Evaluator.run (both conditionings, F0 rows through the vocoder
              kernels) and evaluate_intensity_efficacy on the experiments of
              phases 8 and 12 over phase 15's corpus: finite reports,
              launches, the eval forward against the all-plain one
17. vocoder_train  VocoderTrainer.fit at the full width of
              Config().train_vocoder (V1 generator, MPD + MSD, batch 16,
              bf16) for 20 steps on phase 15's wavs: finite losses, both
              models changed, checkpoint and vocoder.npz, a resume (state,
              step, sampler seed); a step's wall, profiler reading, parts,
              operations and bound
18. vocoder_train_parity  one fp32 GAN step at narrow widths on the card
              against the same step on the CPU: metrics and gradients
19. vocoder_finetune  condition "fs2": predicted_mel_pairs through the fp32
              Evaluator (attention launches counted), then 5 GAN steps at
              full width from phase 17's checkpoint
20. serve_trained_vocoder  the fine-tune's vocoder.npz through
              load_synthesizer (MRF and ResBlock kernels) against the plain
              generator on the same .npz, launches
21. cli       the emotts-torch command (emotts_torch/cli/main.py) at
              Config() widths with both attention kernel flags on, over phase
              15's raw corpus: prepare-corpus, preprocess (the device mel
              by default on the card),
              fs2-splits, train-rank (one epoch, profile_epoch=0: the trace
              names the attention kernels), bucketize, train-vocoder (5
              steps), train-fs2 (one epoch), the 60-utterance sweep,
              synthesize --text-file --stream, evaluate --conditioning
              prototype, eval-intensity (--plot exits 2 without matplotlib),
              import-reference of full-width reference-layout rank and FS2
              checkpoints and convert-vocoder of a weight-normed V1 .pt made
              from the seed (serving the .pt equals serving its .npz bit for
              bit), each in process with its launches, and its fp32
              attention launches, against the forwards that make them; then
              serve (health, one request) and g2p as
              ``python -m emotts_torch.cli.main`` subprocesses
22. data_parallel  emotts_torch/parallel on the one card: (a) the rank, FS2
              (bucket 1024) and vocoder GAN steps under the DP path, NCCL at
              world size 1 in this process, against the same steps with no
              process group (fp32 losses within 1e-6; bf16 read alone: wall,
              device ms, launches, the all-reduces' extra launches, idle
              share, peak memory); (b) two processes of this script on the
              card over gloo, 3 fp32 steps of the rank and FS2 trainers:
              parameters bit-identical across the ranks after every step,
              losses within 1e-5 and step-1 gradients within 1e-4 of each
              one's largest entry against one process on the global batches;
              (c) a Synthesizer over a two-entry mesh on the card: the
              60-utterance sweep within 1 PCM step of the unsharded one,
              bucketize over the mesh writing the unsharded bank; (d)
              train-rank through torch.distributed.run --nproc-per-node 1
              (NCCL) leaving one experiment directory
23. tensor_parallel  emotts_torch/parallel/tp.py on the one card: (a) two
              processes of this script over gloo as a 1 x 2 grid
              (mesh.model_parallel=2: 1 head of 192 and 768 FFN channels a
              rank), 3 fp32 steps of the rank trainer (largest bucket) and of
              the FS2 trainer (bucket 1024), each against one process's step
              from the same state on the same batch (losses within 1e-5,
              step-1 gradients within 1e-4 of each one's largest entry,
              FastSpeech2's within 5e-2 with its flipped ReLU gates counted),
              the replicated parameters bit-identical across the ranks; per
              rank the step walls, a profiled step, the attention launches
              and the f/g all-reduces and their bytes; (b) the bf16 rank and
              FS2 steps with and without remat (FFTStack(remat=True)): under
              deterministic algorithms losses and gradients bit-identical
              (within 1e-6), generator states equal; in the default mode
              beside it the spread of two plain steps from one state; wall,
              device ms, launches and peak memory of each.  Phase 3
              holds the attention kernels at the grid's H = 1 too.
24. g2p       the neural G2P (emotts_torch/text/neural_g2p.py, g2p_train.py)
              at the bundled architecture (d 256, 3 + 3 layers, 8 heads),
              on tools/train_g2p.py's pairs: (a) the bundled weights through
              G2PTransformer teacher-forced on 64 held-out words against the
              numpy path (logits within 2e-4, the same argmax); (b)
              batched_greedy_decode over the whole held-out set (wall,
              words/s, exact and PER beside the file's recorded ones), its
              ids against np_greedy_decode on 256 of the words; (c) one
              epoch from init_params(0) (batch 512, dropout 0.2, label
              smoothing 0.1): finite losses falling, wall, peak memory, a
              step's median wall, profiler reading and FLOPs with their
              bound; (d) at d 64 on 4,096 pairs under deterministic
              algorithms, 2 epochs straight against 1 + a resume (bit for
              bit), then tools/train_g2p_torch.py as a subprocess (1 epoch,
              its weights decoded by NeuralG2P).  None of the four kernels
              runs on this path (its counters stay at 0).

The last line is {"ok": true, "device": {...}}; before it stand the card line
and one {"kernels": [...]} line.  Without a GPU the script exits non-zero and
prints no result.
"""

import base64
import contextlib
import copy
import glob
import inspect
import io
import json
import math
import os
import subprocess
import sys
import tempfile
import threading
import time
import types
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
    bound); vs_library: the kernel's time over the library call's, and
    vs_library_device the same of their device times where both exist."""
    case["bound_fraction"] = case["bound_ms"] / case["ms"]
    lib = case.get("library_ms")
    case["vs_library"] = case["ms"] / lib if lib else None
    if case.get("library_device_ms"):
        case["vs_library_device"] = case["device_ms"] / case["library_device_ms"]
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
                                  (torch.bfloat16, 8, 250, 10, 256),
                                  (torch.float32, 8, 250, 10, 64),
                                  (torch.float32, 8, 250, 10, 256)):
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
        def sdpa():
            return F.scaled_dot_product_attention(qh, kh, vh, attn_mask=mask)

        library_ms = time_ms(sdpa, iters)
        library_device_ms = device_ms(sdpa)
        peak = PEAK_BF16 if dtype == torch.bfloat16 else PEAK_TF32
        ops = 4 * b * h * t * t * d
        bound_ms, by = bound(ops, peak, 4 * b * t * h * d * q.element_size() + b * t * 4)
        cases.append(dict(
            dtype=str(dtype).split(".")[1], shape=[b, t, h, d], max_abs_err=err,
            max_rel_err=rel, tolerance=TOL[dtype], ms=ms, device_ms=dev_ms,
            plain_ms=plain_ms, library_ms=library_ms, library_device_ms=library_device_ms,
            bound_ms=bound_ms, bound_by=by, **_attention_design(dtype, ops, dev_ms),
        ))
    return cases


def _attention_design(dtype, ops, dev_ms):
    """What an attention case's design computes on the tensor cores beside
    the algorithm's ``ops``: fp32 takes three TF32 products a term (3xTF32),
    bf16 one; tensor_tflops is that work over the kernel's device time."""
    split = 3 if dtype == torch.float32 else 1
    return dict(operations=ops, split=split, operations_as_designed=split * ops,
                tensor_tflops=split * ops / (dev_ms * 1e-3) / 1e12)


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
    rate, h = DROPOUT_RATE, 2
    for dtype, b, t, iters, d in ((torch.bfloat16, 16, 512, 5, 192),
                                  (torch.bfloat16, 16, 1024, 3, 192),
                                  (torch.float32, 8, 512, 5, 192),
                                  (torch.float32, 3, 200, 10, 192),
                                  # FastSpeech2's encoder at batch 8 (phone buckets)
                                  (torch.bfloat16, 8, 48, 20, 192),
                                  (torch.bfloat16, 8, 144, 20, 192),
                                  # the fp32 instances of the other head dims
                                  (torch.float32, 8, 250, 10, 64),
                                  (torch.float32, 8, 250, 10, 256)):
        q, k, v, bias, seeds = _attention_inputs(gen, dev, dtype, b, t, d=d)
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
        ops = 4 * b * h * t * t * d
        bound_ms, by = bound(ops, peak,
                             4 * b * t * h * d * q.element_size() + b * t * 4 + b * 4)
        cases.append(dict(
            dtype=str(dtype).split(".")[1], shape=[b, t, h, d], rate=rate,
            max_abs_err=err, max_rel_err=rel, tolerance=TOL[dtype], ms=ms,
            device_ms=dev_ms, ms_rate0=ms_rate0, plain_ms=plain_ms, library_ms=None,
            bound_ms=bound_ms, bound_by=by, **_attention_design(dtype, ops, dev_ms),
        ))
        del q, k, v, got, want, again
        torch.cuda.empty_cache()
    # With q = k = 0 every probability is 1/T, and with V the identity (T = D)
    # the output is the dropped-out probability matrix itself: the kernel's
    # keep-mask can be read from it and held against the PyTorch Philox.
    b, d = 4, 192
    t = d
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
    cases = []
    # bf16 over 10 calls: over fewer, the host time of the first call shows
    # in the wall time of a kernel that takes half a millisecond
    for dtype, b, t, iters, d in ((torch.bfloat16, 16, 512, 10, 192),
                                  (torch.bfloat16, 16, 1024, 10, 192),
                                  (torch.float32, 8, 512, 3, 192),
                                  (torch.float32, 3, 200, 5, 192),
                                  # fp32 training's largest bucket at batch 8
                                  (torch.float32, 16, 1024, 3, 192),
                                  (torch.bfloat16, 128, 320, 10, 192),
                                  (torch.bfloat16, 16, 777, 10, 192),
                                  # FastSpeech2's encoder at batch 8 (phone buckets)
                                  (torch.bfloat16, 8, 48, 20, 192),
                                  (torch.bfloat16, 8, 144, 20, 192),
                                  # the other head dims' tensor-core instances
                                  (torch.bfloat16, 8, 250, 10, 64),
                                  (torch.bfloat16, 8, 250, 10, 256),
                                  (torch.float32, 8, 250, 5, 64),
                                  (torch.float32, 8, 250, 5, 256)):
        cases += _bwd_cases(gen, dev, dtype, b, t, iters, d)
    # rows that attend to one or two keys, where delta = rowsum(dP * P)
    # cancels against dP exactly only when taken from the same rounded P
    cases += _bwd_cases(gen, dev, torch.bfloat16, 16, 1024, 10, 192, few_keys=True)
    cases += _bwd_cases(gen, dev, torch.float32, 8, 512, 3, 192, few_keys=True)
    # more key tiles of one (b, h) than the card has SMs (64 keys a block in
    # either fused pass): the dQ adds take the key-tile order, not the
    # rotated one
    for dtype in (torch.bfloat16, torch.float32):
        cases += _bwd_cases(gen, dev, dtype, 2, LONG_T, 3, 192, h=1)
    return cases


# past 132 SMs x 64 keys: the fused passes' key-tile order of the dQ adds
LONG_T = 8512


def _dq_order(dev, t):
    """The order of the fused passes' dQ adds that the host picks at length
    t: rotated where a (b, h)'s key tiles (64 keys each) fit on the card's
    SMs together, else the key-tile order."""
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    return "rotated" if -(-t // 64) <= sms else "key-tile"


def _few_keys_bias(gen, dev, b, t):
    """A key bias whose examples 2.. keep one or two keys each (example 0
    keeps all, example 1 none): every query row of such an example attends
    to those keys alone."""
    bias = torch.full((b, t), -1e9)
    bias[0] = 0.0
    for i in range(2, b):
        bias[i, torch.randint(0, t, (1 + i % 2,), generator=gen)] = 0.0
    return bias.to(dev)


def _bwd_cases(gen, dev, dtype, b, t, iters, d, h=2, first_head=0, few_keys=False):
    """The backward kernels at one shape, rate 0 and 0.1, against the plain
    backward; ``first_head``: the seeds offset to that head, as a
    tensor-parallel rank passes them (``parallel.tp.offset_seeds``);
    ``few_keys``: the bias of ``_few_keys_bias``.  At rate 0 SDPA's backward
    is the library call; at rate 0.1 SDPA's backward with its own dropout
    (other mask bits, the same work) is read beside the case as a yardstick,
    not as the library call."""
    from emotts_torch.ops import attention as A
    from emotts_torch.parallel.tp import offset_seeds

    cases = []
    q, k, v, bias, seeds = _attention_inputs(gen, dev, dtype, b, t, h=h, d=d)
    if few_keys:
        bias = _few_keys_bias(gen, dev, b, t)
    seeds = offset_seeds(seeds, first_head)
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
        if stats.shape != (2, b, h, t):
            raise AssertionError(f"row statistics {tuple(stats.shape)} at H = {h}")
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
        # the library's backward alone: gradients of one retained forward,
        # taken again and again
        qh, kh, vh = (x.transpose(1, 2).detach().requires_grad_()
                      for x in (q, k, v))
        mask = bias[:, None, None, :].to(dtype)
        gh = dout.transpose(1, 2)
        sdpa_out = F.scaled_dot_product_attention(qh, kh, vh, attn_mask=mask,
                                                  dropout_p=rate)

        def sdpa_bwd():
            torch.autograd.grad(sdpa_out, (qh, kh, vh), gh, retain_graph=True)

        lib = (time_ms(sdpa_bwd, iters), device_ms(sdpa_bwd))
        del sdpa_out, qh, kh, vh
        library_ms, library_device_ms = lib if rate == 0.0 else (None, None)
        yardstick = {} if rate == 0.0 else dict(
            sdpa_dropout_ms=lib[0], sdpa_dropout_device_ms=lib[1])
        # the delta pass's two T x T x D products and the fused pass's five
        # (14 against the algorithm's 10 B*H*T^2*D operations), in either
        # dtype; fp32 does each as three
        design = _attention_design(dtype, 14 * b * h * t * t * d, dev_ms)
        cases.append(dict(
            dtype=str(dtype).split(".")[1], shape=[b, t, h, d], rate=rate,
            max_abs_err=max(e[0] for e in errs),
            max_rel_err=max(e[1] for e in errs), tolerance=TOL[dtype],
            repeat_equal_bits=True, ms=ms, device_ms=dev_ms, plain_ms=plain_ms,
            library_ms=library_ms, library_device_ms=library_device_ms,
            bound_ms=bound_ms, bound_by=by,
            operations_algorithm=10 * b * h * t * t * d,
            products_as_designed=design["operations"], split=design["split"],
            operations_as_designed=design["operations_as_designed"],
            tensor_tflops=design["tensor_tflops"], **yardstick,
            dq_order=_dq_order(dev, t),
            **({"first_head": first_head} if first_head else {}),
            **({"bias": "one or two keys a row"} if few_keys else {}),
        ))
        del stats, got
    del q, k, v, dout
    torch.cuda.empty_cache()
    return cases


# a tensor-parallel rank's attention: 1 of Config()'s 2 heads of 192 at
# mesh.model_parallel=2, the seeds offset to head 1 (the second rank)
TP_ATTENTION_FWD = ((torch.bfloat16, 60, 1024, 10), (torch.float32, 8, 1024, 3))
TP_ATTENTION_BWD = ((torch.bfloat16, 16, 1024, 10), (torch.float32, 8, 512, 3))


def check_attention_tp(gen, dev):
    """The attention kernels at a tensor-parallel rank's shape (H = 1), rate
    0 and 0.1 with the seeds offset to the rank's first head, each against
    its plain version at the tolerances above; SDPA timed at the same shape
    (rate 0).  Returns (forward cases, backward cases)."""
    from emotts_torch.ops import attention as A
    from emotts_torch.parallel.tp import offset_seeds

    fwd, h, d = [], 1, 192
    for dtype, b, t, iters in TP_ATTENTION_FWD:
        q, k, v, bias, seeds = _attention_inputs(gen, dev, dtype, b, t, h=h, d=d)
        seeds = offset_seeds(seeds, 1)
        peak = PEAK_BF16 if dtype == torch.bfloat16 else PEAK_TF32
        ops = 4 * b * h * t * t * d
        bound_ms, by = bound(ops, peak,
                             4 * b * t * h * d * q.element_size() + b * t * 4 + b * 4)
        for rate in (0.0, DROPOUT_RATE):
            s = seeds if rate else None
            got = A.fused_attention(q, k, v, bias, s, rate)
            torch.cuda.synchronize()
            err, rel = compare(got, A.fused_attention_plain(q, k, v, bias, s, rate),
                               **TOL[dtype])
            ms = time_ms(lambda: A.fused_attention(q, k, v, bias, s, rate), iters)
            dev_ms = device_ms(lambda: A.fused_attention(q, k, v, bias, s, rate))
            plain_ms = time_ms(lambda: A.fused_attention_plain(q, k, v, bias, s, rate),
                               iters)
            library_ms = library_device_ms = None
            if rate == 0.0:
                qh, kh, vh = (x.transpose(1, 2) for x in (q, k, v))
                mask = bias[:, None, None, :].to(dtype)

                def sdpa():
                    return F.scaled_dot_product_attention(qh, kh, vh, attn_mask=mask)

                library_ms, library_device_ms = time_ms(sdpa, iters), device_ms(sdpa)
            fwd.append(dict(
                dtype=str(dtype).split(".")[1], shape=[b, t, h, d], rate=rate,
                first_head=1, max_abs_err=err, max_rel_err=rel, tolerance=TOL[dtype],
                ms=ms, device_ms=dev_ms, plain_ms=plain_ms, library_ms=library_ms,
                library_device_ms=library_device_ms, bound_ms=bound_ms, bound_by=by,
                **_attention_design(dtype, ops, dev_ms)))
            del got
        del q, k, v
        torch.cuda.empty_cache()
    bwd = []
    for dtype, b, t, iters in TP_ATTENTION_BWD:
        bwd += _bwd_cases(gen, dev, dtype, b, t, iters, d, h=h, first_head=1)
    return fwd, bwd


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
    rows computed per row kept, weighted by taps, each conv in the whole m64
    tiles the core computes (chain_cost to M_TILE); operations_as_designed:
    split x halo_ratio x algorithm operations; tensor_tflops: what those
    take per second at the kernel's time."""
    from emotts_torch.ops.resblock import M_TILE, chain_cost

    rows = sum(-(-t // tile) * chain_cost(k, dil, tile, M_TILE) for k, dil, tile in chains)
    ops = 2 * b * rows * c * c * split
    return dict(halo_ratio=ops / split / algorithm_ops, split=split,
                operations=algorithm_ops, operations_as_designed=ops,
                tensor_tflops=ops / (ms * 1e-3) / 1e12)


# the vocoder kernels' conv core (csrc/resblock_common.cuh)
VOCODER_DESIGN = ("wgmma.m64nNk8 TF32, A from registers, B packed by the wrapper "
                  "(pack_weights) through a bulk-copy ring on mbarriers")


def _packing(R, weights, parts, dtype, c):
    """The design's fields of a vocoder case: its name, the ring's depth, and
    the wrapper's packing of the case's weights (``weights``: the conv
    weight tensors it packs, in ``parts`` parts) timed alone."""
    def pack():
        return [R.pack_weights(w.to(dtype), parts) for w in weights]
    return dict(design=VOCODER_DESIGN, ring_stages=R.ring_stages(c), weight_parts=parts,
                pack_ms=time_ms(pack, 5))


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
            dev_ms = device_ms(lambda: R.fused_resblock1(x, *w, dil), 3)
            plain_ms = time_ms(lambda: R.fused_resblock1_plain(x, *w, dil), 2)
            peak = PEAK_BF16 if dtype == torch.bfloat16 else PEAK_TF32
            nbytes = 2 * x.numel() * x.element_size() + sum(a.numel() * 4 for a in w)
            ops = _chain_ops(rows, t, c, (k,))
            bound_ms, by = bound(ops, peak, nbytes)
            plan = [(first, last, min(tile, -(-t // 8) * 8)) for first, last, tile
                    in R.launch_plan(c, k, dil, rows, t, R.device_sms(dev.index or 0))]
            cases.append(dict(
                dtype=str(dtype).split(".")[1], shape=[rows, t, c], k=k,
                cuda_launches=len(plan), tiles=[p[2] for p in plan],
                max_abs_err=err, max_rel_err=rel, tolerance=TOL[dtype], ms=ms,
                device_ms=dev_ms, plain_ms=plain_ms, library_ms=None, bound_ms=bound_ms,
                bound_by=by,
                # 3xTF32 in both instances: the residual is an fp32 sum
                **_as_designed(rows, t, c, [(k, dil[a:b], tile) for a, b, tile in plan],
                               3, ops, ms),
                **_packing(R, (w[0], w[2]), 2, torch.float32, c),
            ))
    return cases


def check_mrf(gen, dev, frames, batch):
    from emotts_torch.ops import mrf as M
    from emotts_torch.ops import resblock as R

    cases = []
    v1 = (3, 7, 11), (1, 3, 5)  # the generator's kernel sizes and dilations
    for dtype in (torch.float32, torch.bfloat16):
        # the main path's three stages (C = 128 and 64 one launch per
        # dilation step of each ResBlock, C = 32 one launch: launch_plan),
        # then short sequences whose lengths are a multiple of no tile (edge
        # masks, ragged last tile; one launch of short tiles), then a stage
        # of two ResBlocks and two dilations
        for c, rows, t, (ks, dil) in (
                (128, batch, 64 * frames, v1), (64, batch, 128 * frames, v1),
                (32, batch, 256 * frames, v1), (128, 2, 777, v1), (32, 3, 333, v1),
                (64, 2, 1000, ((3, 5), (1, 2)))):
            x = torch.randn(rows, t, c, generator=gen).to(dev, dtype)
            params = [_block_weights(gen, dev, c, k, len(dil)) for k in ks]
            got = M.fused_mrf_stage(x, params, ks, dil)
            torch.cuda.synchronize()
            want = M.fused_mrf_stage_plain(x, params, ks, dil)
            err, rel = compare(got, want, **TOL[dtype])
            del got, want
            ms = time_ms(lambda: M.fused_mrf_stage(x, params, ks, dil), 2)
            dev_ms = device_ms(lambda: M.fused_mrf_stage(x, params, ks, dil), 3)
            plain_ms = time_ms(lambda: M.fused_mrf_stage_plain(x, params, ks, dil), 2)
            peak = PEAK_BF16 if dtype == torch.bfloat16 else PEAK_TF32
            nbytes = (2 * x.numel() * x.element_size()
                      + sum(a.numel() * 4 for blk in params for a in blk))
            ops = _chain_ops(rows, t, c, ks, len(dil))
            bound_ms, by = bound(ops, peak, nbytes)
            parts = 1 if dtype == torch.bfloat16 else 2
            plan = [(rb, j, min(tile, -(-t // 8) * 8)) for rb, j, tile
                    in M.launch_plan(c, ks, dil, parts, rows, t, R.device_sms(dev.index or 0))]
            chains = ([(k, dil, plan[0][2]) for k in ks] if plan[0][0] is None
                      else [(ks[rb], (dil[j],), tile) for rb, j, tile in plan])
            cases.append(dict(
                dtype=str(dtype).split(".")[1], shape=[rows, t, c], kernel_sizes=ks,
                dilations=dil, cuda_launches=len(plan), tiles=[p[2] for p in plan],
                max_abs_err=err, max_rel_err=rel, tolerance=TOL[dtype], ms=ms,
                device_ms=dev_ms, plain_ms=plain_ms, library_ms=None, bound_ms=bound_ms,
                bound_by=by,
                # bf16: operands exact in bf16, one TF32 product a term
                **_as_designed(rows, t, c, chains,
                               1 if dtype == torch.bfloat16 else 3, ops, ms),
                **_packing(R, [blk[i] for blk in params for i in (0, 2)],
                           1 if dtype == torch.bfloat16 else 2, dtype, c),
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
    """Counts forwards of the two models, to say how many launches to expect;
    ``launched`` lists each generator forward's (MRF, ResBlock) launches
    (vocoder_launches: they follow the mel's shape)."""

    def __init__(self, synth):
        self.fs2 = self.vocoder = 0
        self.launched = []
        self._hooks = [
            synth.model.register_forward_hook(self._count("fs2")),
            synth.vocoder.register_forward_hook(self._count("vocoder")),
        ]

    def _count(self, name):
        def hook(module, args, output):
            setattr(self, name, getattr(self, name) + 1)
            if name == "vocoder":
                self.launched.append(vocoder_launches(module, *args))
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
    16-bit steps (summation order through 12 FFT blocks and 4 MRF stages).
    The kernel path's attention launches are all fp32, one per layer of each
    FastSpeech2 forward."""
    from emotts_torch.infer.synthesize import Synthesizer
    from emotts_torch.nn.fastspeech2 import FastSpeech2
    from emotts_torch.ops import attention

    fs2_sd, voc_sd, bank = weights
    request = [{"text": "A short line for comparison.", "speaker": 2,
                "emotion": 3, "level": 1.5}]
    waves = {}
    for kernels in (True, False):
        cfg = full_width_config("float32", kernels)
        synth = Synthesizer(cfg, fs2_sd, voc_sd, bank,
                            vocoder_structure=vocoder_structure(cfg, kernels))
        if kernels:
            zero_counts(attention)
            fs2 = ModuleCounter(FastSpeech2)
        waves[kernels] = synth.synthesize_requests(request)[0]
        if kernels:
            fs2.close()
            f2 = cfg.fastspeech2
            fp32 = dict(counted=fp32_attention_launches(), expected=expected_fp32_launches(
                {"fs2": fs2}, {"fs2": f2.enc_num_layers + f2.dec_num_layers}))
            if (fp32["counted"] != fp32["expected"] or fp32["counted"]["fused_attention"] == 0
                    or attention.launch_count != fp32["counted"]["fused_attention"]):
                raise AssertionError(f"fp32 parity path's attention launches {fp32}, "
                                     f"all launches {attention.launch_count}")
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
                max_pcm_steps=steps, limit_pcm_steps=limit, fp32_launches=fp32)


# --------------------------------------------------------------------------
# phases 8-11: rank-model training, then bucketization
# --------------------------------------------------------------------------

TRAIN_LR = 3e-5  # the default 1e-6 moves nothing in a few tens of steps


def make_rank_corpus(root, cfg, seed, utts_per_cell=6):
    """A preprocessed corpus in the format RankPairDataset and FS2Dataset
    read, made with numpy from ``seed``: ``<speaker>/<emotion>_<id>.npz``
    with ``mel`` (n_mels, T), ``pitch`` (T,), ``energy`` (T,), ``phones``
    (P,) ARPABET symbols with ``durations`` (P,) of at least one frame
    summing to T (about six frames a phone), ``speaker``, ``emotion``,
    ``transcript`` and ``audio_path``; ``train.txt`` / ``test.txt`` lines
    ``speaker|emotion|emo_id|neu_id``, and ``fs2_train.txt`` /
    ``fs2_valid.txt`` from the port's ``build_fs2_splits``.

    An utterance's length class follows its id, so the pairs spread over the
    frame buckets up to the largest.  An emotional utterance is a neutral-like
    one plus its emotion's seeded channel offset at a per-utterance strength:
    something to rank."""
    from emotts_torch.data.splits import build_fs2_splits
    from emotts_torch.text.vocab import VALID_SYMBOLS

    rng = np.random.default_rng(seed)
    text_rng = np.random.default_rng(seed + 1)  # leaves the features as they were
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
                p = min(t // 6, max(cfg.bucketing.phone_buckets))
                durations = text_rng.multinomial(t - p, np.full(p, 1.0 / p)) + 1
                phones = text_rng.choice(VALID_SYMBOLS, size=p)
                np.savez(os.path.join(root, speaker, f"{emotion}_{i:04d}.npz"),
                         mel=x[:-2], pitch=x[-2], energy=x[-1], phones=phones,
                         durations=durations.astype(np.int32), speaker=speaker,
                         emotion=emotion, transcript=" ".join(phones).lower(),
                         audio_path=f"{speaker}/{emotion}_{i:04d}.wav")
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
    fs2_train, fs2_valid = build_fs2_splits(cfg)
    return dict(train_pairs=len(train), test_pairs=len(test),
                fs2_train=len(fs2_train), fs2_valid=len(fs2_valid))


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


class ModuleCounter:
    """Counts forwards of every module of a class (every IntensityExtractor,
    every FastSpeech2), to say how many attention launches to expect;
    ``training_forwards`` are those called with ``deterministic=False`` (by
    keyword or position), each followed by one backward in a train step.
    ``fp32_forwards`` and ``fp32_training_forwards`` count those of modules
    that compute in fp32, whose attention takes the kernels' fp32 instances.
    With ``launches``, ``launched`` lists ``launches(module, *args)`` of
    every forward (a generator's MRF and ResBlock launches by its structure
    and its input's shape)."""

    def __init__(self, cls, launches=None):
        self.forwards = self.training_forwards = 0
        self.fp32_forwards = self.fp32_training_forwards = 0
        self.launched = []
        signature = inspect.signature(cls.forward)

        def hook(module, args, kwargs, output):
            if isinstance(module, cls):
                called = signature.bind(module, *args, **kwargs).arguments
                training = called.get("deterministic") is False
                fp32 = getattr(module, "dtype", None) == torch.float32
                self.forwards += 1
                self.training_forwards += training
                self.fp32_forwards += fp32
                self.fp32_training_forwards += fp32 and training
                if launches is not None:
                    self.launched.append(launches(module, *args, **kwargs))

        self._hook = torch.nn.modules.module.register_module_forward_hook(
            hook, with_kwargs=True)

    def close(self):
        self._hook.remove()


def zero_counts(*modules):
    """Set every launch counter of the kernel modules to 0."""
    for module in modules:
        for name in list(vars(module)):
            if name.endswith("launch_count"):
                setattr(module, name, 0)


def fp32_attention_launches():
    """The attention kernels' fp32 launches since the counters were set to 0."""
    from emotts_torch.ops import attention as A

    return dict(fused_attention=A.fp32_launch_count,
                fused_attention_bwd=A.fp32_bwd_launch_count)


def expected_fp32_launches(counters, layers):
    """The fp32 attention launches that the counted forwards make:
    ``counters`` and ``layers`` map a name to a ModuleCounter and to the
    attention layers of one of its forwards."""
    from emotts_torch.ops import attention as A

    return dict(
        fused_attention=sum(layers[n] * c.fp32_forwards for n, c in counters.items()),
        fused_attention_bwd=sum(layers[n] * A.BWD_LAUNCHES_PER_CALL
                                * c.fp32_training_forwards for n, c in counters.items()))


def same_bits(a, b):
    """Nested dicts, lists and tensors equal bit for bit."""
    if isinstance(a, dict):
        return a.keys() == b.keys() and all(same_bits(a[k], b[k]) for k in a)
    if isinstance(a, (list, tuple)):
        return len(a) == len(b) and all(same_bits(x, y) for x, y in zip(a, b))
    if isinstance(a, torch.Tensor):
        return (a.dtype == b.dtype and a.shape == b.shape
                and torch.equal(a.cpu(), b.cpu()))
    return a == b


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


ATTENTION_GROUPS = (("attention_forward", "attention_fwd_"),
                    ("attention_backward", "attention_bwd_"))


def profile_steps(trainer, batches, rows, timed=5, traced=3, host_ops=True,
                  groups=ATTENTION_GROUPS):
    """Where a train step's time goes, for each of ``batches`` (keyed by
    frame bucket): wall time of a step, and the device time of its kernels
    by name from a torch.profiler trace of ``traced`` steps (``host_ops``:
    the host's operators traced too), summed by ``groups`` (label, kernel
    name part).  A reading, not a check: it only fails if a step fails."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    out = {}
    for frames, batch in batches.items():
        for _ in range(2):
            trainer.train_step(batch)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(timed):
            trainer.train_step(batch)
        torch.cuda.synchronize()
        wall_ms = 1e3 * (time.perf_counter() - t0) / timed
        steps = traced
        activities = [ProfilerActivity.CUDA]
        if host_ops:
            activities.append(ProfilerActivity.CPU)
        with profile(activities=activities) as prof:
            for _ in range(steps):
                trainer.train_step(batch)
            torch.cuda.synchronize()
        # kernels only: an annotation's row (the optimizer's step) spans the
        # kernels under it and would count them twice
        kernels = [e for e in prof.key_averages()
                   if e.device_type == DeviceType.CUDA
                   and not e.key.startswith("Optimizer.")]
        step_ms = sum(e.self_device_time_total for e in kernels) / steps / 1e3
        reading = dict(rows=rows(batch), wall_ms_per_step=wall_ms,
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


def first_batch_by_bucket(loader):
    """The first batch of each frame bucket in epoch 0, and the loader's
    host ms per batch (read alone: its thread shares the interpreter with the
    step's launches while fit runs)."""
    loader.plan_epoch(0)  # reads every length once; not part of a batch's cost
    first = {}
    t0 = time.perf_counter()
    for batch in loader.epoch(0):
        frames = batch["mel" if "mel" in batch else "emo_x"].shape[1]
        first.setdefault(int(frames), batch)
    return first, 1e3 * (time.perf_counter() - t0) / loader.batches_per_epoch(0)


def train_profile_phase(cfg, dev):
    """The rank model's train step at the smallest and the largest frame
    bucket (profile_steps), and the loader's host time per batch."""
    from emotts_torch.train.rank_trainer import RankTrainer

    trainer = RankTrainer(cfg, device=dev)
    first, loader_ms = first_batch_by_bucket(trainer._loader("train", shuffle=True))
    out = {"loader_host_ms_per_batch": loader_ms}
    out.update(profile_steps(trainer, {f: first[f] for f in (min(first), max(first))},
                             lambda b: 2 * len(b["lengths"])))
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

    layers = cfg.rank_model.n_encoder_layers
    return _kernels_against_plain(step, dict(
        frames=int(b["emo_x"].shape[1]), rows=int(2 * b["emo_x"].shape[0])),
        dict(fused_attention=layers,
             fused_attention_bwd=A.BWD_LAUNCHES_PER_CALL * layers))


def _gradient_ratios(grads, ref):
    """Each parameter's largest gradient difference from ``ref``'s, as a
    share of ref's largest entry for that parameter but of no less than a
    thousandth of the model's largest: the key biases have no gradient at
    all (a softmax row does not see a constant added to every key), nor
    have FastSpeech2's PostNet conv biases (BatchNorm on batch statistics
    removes a constant), so theirs is rounding noise on both sides."""
    largest = max(g.abs().max().item() for g in ref.values())
    ratios = {}
    for name, g in grads.items():
        if not torch.isfinite(g).all() or largest == 0.0:
            raise AssertionError(f"gradient of {name} is not finite, or all are zero")
        scale = max(ref[name].abs().max().item(), 1e-3 * largest)
        ratios[name] = (g - ref[name]).abs().max().item() / scale
    return ratios


def _worst_gradient(grads, ref):
    """(the largest of :func:`_gradient_ratios`, its parameter)."""
    ratios = _gradient_ratios(grads, ref)
    worst = max(ratios, key=ratios.get)
    return ratios[worst], worst


def _kernels_against_plain(step, info, launches, relu_gates=False):
    """Run ``step`` (→ loss, {name: gradient}) through the kernels, then with
    the plain forward and backward put in their place, and hold the two to
    the fp32 tolerances below (both sides fp32, other summation orders).
    ``launches``: the attention launches of the kernel step, every one of
    them an fp32 instance's.

    ``relu_gates``: the model gates with ReLUs (FastSpeech2's convolutions),
    so a forward that differs at the rounding level can flip a gate at a
    value near zero and move a gradient sum by one or more of its terms:
    how far depends on how many gates sit that close to zero (2.3e-3 to
    3.3e-2 of the largest entry in four runs on the card), not on the
    kernels.  Its gradients are then held at 1e-3 to a third step, the plain
    backward behind the kernels' own forward (the same gates); the
    all-plain step's are reported, and its loss held at 1e-5."""
    from emotts_torch.ops import attention as A

    zero_counts(A)
    loss_k, grads_k = step()
    fp32 = dict(counted=fp32_attention_launches(), expected=launches)
    if fp32["counted"] != launches or (A.launch_count, A.bwd_launch_count) != (
            launches["fused_attention"], launches["fused_attention_bwd"]):
        raise AssertionError(f"the kernel step's attention launches: {fp32}, all "
                             f"{A.launch_count} and {A.bwd_launch_count}")

    def plain_forward(q, k, v, bias, seeds=None, rate=0.0, want_stats=False):
        return A.fused_attention_plain(q, k, v, bias, seeds, rate), None

    def plain_backward(q, k, v, bias, seeds, stats, dout, rate=0.0):
        return A.fused_attention_bwd_plain(q, k, v, bias, dout, seeds, rate)

    def plain_step(forward, backward):
        kernels = A.attention_forward, A.attention_backward
        A.attention_forward, A.attention_backward = forward, backward
        try:
            return step()
        finally:
            A.attention_forward, A.attention_backward = kernels

    before = A.launch_count, A.bwd_launch_count
    loss_p, grads_p = plain_step(plain_forward, plain_backward)
    if (A.launch_count, A.bwd_launch_count) != before:
        raise AssertionError("the plain step launched a kernel")
    loss_rtol, grad_rtol = 1e-5, 1e-3
    worst_all, worst_all_name = _worst_gradient(grads_k, grads_p)
    out = dict(**info, fp32_launches=fp32, loss_kernels=loss_k, loss_plain=loss_p,
               loss_rtol=loss_rtol,
               parameters=len(grads_k), worst_gradient_difference=worst_all,
               worst_at=worst_all_name, gradient_rtol_of_largest_entry=grad_rtol)
    worst, worst_name = worst_all, worst_all_name
    if relu_gates:
        _, grads_b = plain_step(A.attention_forward, plain_backward)
        worst, worst_name = _worst_gradient(grads_k, grads_b)
        out.update(worst_gradient_difference_same_forward=worst,
                   worst_same_forward_at=worst_name)
    if abs(loss_k - loss_p) > loss_rtol * abs(loss_p) or worst > grad_rtol:
        raise AssertionError(
            f"kernel step loss {loss_k} vs plain {loss_p}; worst gradient "
            f"difference {worst} of its largest entry at {worst_name}")
    return out


# --------------------------------------------------------------------------
# phases 12-14: FastSpeech2 training, then streamed serving from the
# experiment directories
# --------------------------------------------------------------------------

FS2_STEPS = 30  # about three epochs over the corpus' FS2 split


def fs2_config(root, compute_dtype="bfloat16"):
    """Config() defaults — FS2 6+6 layers, d_model 384, 2 heads of 192, FFN
    1536 with kernels (9, 1), dropout 0.1, variance/PostNet dropout 0.5,
    batch 8 — over the seeded corpus, with the fused attention kernels and
    the default learning rate 1e-4.  Cut: FS2_STEPS steps."""
    cfg = rank_config(root, compute_dtype)
    cfg.fastspeech2.fused_attention = True
    t = cfg.train_fs2
    t.compute_dtype = compute_dtype
    t.n_epochs = 10
    t.max_iterations = FS2_STEPS
    return cfg


def fs2_trainer(cfg, rank_exp, dev, mesh=None):
    """An FS2Trainer conditioned on the rank experiment's best/ extractor
    (on ``mesh``, default ``make_mesh(cfg.mesh)``).
    The duration predictor starts at about four frames a phone (output bias
    log1p(4), output weights scaled by 0.3), as the seeded serving weights
    do, so that the trained model makes audio to stream: a choice of
    starting weights."""
    from emotts_torch.train.checkpoint import load_best_params
    from emotts_torch.train.fs2_trainer import FS2Trainer, extractor_params_from_rank

    trainer = FS2Trainer(
        cfg, extractor_params_from_rank(load_best_params(rank_exp)), device=dev,
        mesh=mesh)
    with torch.no_grad():
        trainer.model.duration_predictor.out.bias.fill_(math.log1p(4.0))
        trainer.model.duration_predictor.out.weight.mul_(0.3)
    return trainer


def fs2_train_phase(cfg, rank_exp, dev):
    """FS2Trainer.fit on the card; checkpoints, best/, then restore + one
    step against the step the uninterrupted run takes; the attention
    launches of one step; where a step's time goes at the smallest and the
    largest frame bucket."""
    from emotts_torch.ops import attention as A

    trainer = fs2_trainer(cfg, rank_exp, dev)
    losses, step_ms, buckets = [], [], []
    step = trainer.train_step

    def recorded_step(batch):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        metrics = step(batch)
        torch.cuda.synchronize()
        step_ms.append(1e3 * (time.perf_counter() - t0))
        losses.append(metrics["total_loss"])
        buckets.append(int(batch["mel"].shape[1]))
        return metrics

    trainer.train_step = recorded_step
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    exp = trainer.fit(verbose=False)
    fit_s = time.perf_counter() - t0
    peak_bytes = torch.cuda.max_memory_allocated()
    trainer.train_step = step

    if not losses or not np.isfinite(losses).all():
        raise AssertionError(f"FS2 training losses are not all finite: {losses}")
    if len(set(buckets)) < 3:
        raise AssertionError(f"the batches cover the buckets {sorted(set(buckets))} only")
    head, tail = float(np.mean(losses[:5])), float(np.mean(losses[-5:]))
    if not tail < head:
        raise AssertionError(f"the FS2 loss did not fall: mean of the first five "
                             f"{head}, of the last five {tail}")
    series = read_metrics(exp)
    for tag in ("Loss/total_loss", "Valid/Loss/total_loss", "Valid/Loss/ssim_loss"):
        if tag not in series or not np.isfinite(series[tag]).all():
            raise AssertionError(f"metrics.jsonl lacks a finite {tag}")
    checkpoints = sorted(os.listdir(os.path.join(exp, "checkpoints")))
    if not checkpoints or not os.path.isfile(os.path.join(exp, "best", "params.pt")):
        raise AssertionError("fit left no checkpoint or no best/ export")

    # one step's attention launches, then resume
    batch = next(iter(trainer._loader("train", shuffle=True).epoch(0)))
    saved = copy.deepcopy(trainer.state.state_dict())  # what the checkpoint holds
    before = A.launch_count, A.bwd_launch_count
    want = trainer.train_step(batch)
    per_step = dict(fused_attention=A.launch_count - before[0],
                    fused_attention_bwd=A.bwd_launch_count - before[1])
    f2, rm = cfg.fastspeech2, cfg.rank_model
    fs2_layers = f2.enc_num_layers + f2.dec_num_layers
    per_step_expected = dict(
        fused_attention=fs2_layers + rm.n_encoder_layers,
        fused_attention_bwd=fs2_layers * A.BWD_LAUNCHES_PER_CALL)
    if per_step != per_step_expected:
        raise AssertionError(f"attention launches of one FS2 step {per_step}, "
                             f"expected {per_step_expected}")
    fresh = fs2_trainer(cfg, rank_exp, dev)
    if not fresh.restore(exp) or fresh.state.step != trainer.state.step - 1:
        raise AssertionError("restore found no checkpoint of the last step")
    if not same_bits(fresh.state.state_dict(), saved):
        raise AssertionError("the restored FS2 state (parameters, BatchNorm statistics, "
                             "moments, generator) is not the saved one")
    got = fresh.train_step(batch)
    if got != want:
        raise AssertionError(f"resumed FS2 step {got} differs from the uninterrupted {want}")
    # the library's convolution and gather backward sum in no fixed order, and
    # Adam turns a last-bit difference of a gradient near zero into a step of
    # up to lr: after the step the two states agree within 2 lr
    drift = max((a - b).abs().max().item() for a, b in zip(
        fresh.model.state_dict().values(), trainer.model.state_dict().values()))
    if drift > 2 * cfg.train_fs2.learning_rate:
        raise AssertionError(f"FS2 state after the resumed step differs by {drift}")
    by_bucket = {str(t): float(np.mean([m for m, b in zip(step_ms[1:], buckets[1:])
                                        if b == t]))
                 for t in sorted(set(buckets[1:]))}
    resume_s = time.perf_counter() - t0 - fit_s
    first, loader_ms = first_batch_by_bucket(trainer._loader("train", shuffle=True))
    # the kernels only (a step's 4000 host operators slow the trace's reading)
    profile = profile_steps(trainer, {f: first[f] for f in sorted(first)},
                            lambda b: len(b["mel_len"]), timed=3, traced=2,
                            host_ops=False)
    profile["loader_host_ms_per_batch"] = loader_ms
    profile["seconds"] = time.perf_counter() - t0 - fit_s - resume_s
    return exp, dict(
        cuts=dict(steps=cfg.train_fs2.max_iterations,
                  learning_rate=cfg.train_fs2.learning_rate,
                  duration_bias=math.log1p(4.0), duration_weight_scale=0.3,
                  note="full width and depth; the learning rate is the "
                       "configured default, not raised"),
        steps=len(losses), learning_rate=cfg.train_fs2.learning_rate,
        mean_first_five=head, mean_last_five=tail, losses=losses,
        fit_seconds=fit_s, resume_seconds=resume_s, step_ms_mean_after_first=float(np.mean(step_ms[1:])),
        step_ms_by_frame_bucket=by_bucket, first_step_ms=step_ms[0],
        peak_memory_bytes=int(peak_bytes),
        valid={k.split("/")[-1]: v for k, v in series.items()
               if k.startswith("Valid/")},
        checkpoints=checkpoints, restored_state_equal_bits=True,
        resumed_step_equal_bits=True, state_drift_after_resumed_step=drift, attention_launches_per_step=per_step,
        profile=profile,
    )


def fs2_parity_phase(root, rank_exp, dev):
    """One fp32 FS2 train step at full width: loss and every parameter's
    gradient through the kernels (FS2 and the frozen extractor) against the
    same step with the plain forward and backward put in their place (same
    weights, batch, dropout draws and BatchNorm statistics)."""
    from emotts_torch.losses.fs2 import fs2_loss
    from emotts_torch.ops import attention as A
    from emotts_torch.train.fs2_trainer import batch_to_device

    cfg = fs2_config(root, "float32")
    trainer = fs2_trainer(cfg, rank_exp, dev)
    batch = next(iter(trainer._loader("train", shuffle=True).epoch(0)))
    b = batch_to_device(batch, dev)
    gen = trainer.state.generators["dropout"]
    start = gen.get_state()
    buffers = {n: t.clone() for n, t in trainer.model.named_buffers()}

    def step():
        gen.set_state(start)
        for n, t in trainer.model.named_buffers():
            t.copy_(buffers[n])
        trainer.model.zero_grad(set_to_none=True)
        preds = trainer._forward(b, deterministic=False)
        loss, _ = fs2_loss(preds, b["mel"], b["durations"], b["mel_len"],
                           b["phon_len"], cfg.loss)
        loss.backward()
        return loss.item(), {n: p.grad.clone()
                             for n, p in trainer.model.named_parameters()}

    f2 = cfg.fastspeech2
    fs2_layers = f2.enc_num_layers + f2.dec_num_layers
    return _kernels_against_plain(step, dict(
        frames=int(b["mel"].shape[1]), phones=int(b["phonemes"].shape[1]),
        rows=int(b["mel"].shape[0])),
        dict(fused_attention=fs2_layers + cfg.rank_model.n_encoder_layers,
             fused_attention_bwd=A.BWD_LAUNCHES_PER_CALL * fs2_layers), relu_gates=True)


STREAM_CHUNK = 32  # mel frames a chunk: 512 ms of audio


def vocoder_launches(gen, mel):
    """(MRF, ResBlock) CUDA launches of one forward of ``gen`` on ``mel``
    (B, frames, n_mels), from its structure: a stage the MRF kernel takes
    launches its plan, the others launch each ResBlock's plan, each plan
    for the stage's rows and length on the mel's card (launch_plan)."""
    from emotts_torch.ops import mrf, resblock

    rows, t = mel.shape[0], mel.shape[1]
    sms = (resblock.device_sms(mel.device.index) if mel.device.type == "cuda"
           else resblock.SMS)
    # the reference's type promotion: x takes the first conv's bias's type
    bf16 = torch.promote_types(mel.dtype, gen.conv_pre_bias.dtype) == torch.bfloat16
    ch = gen.conv_pre_kernel.shape[2]
    per_mrf = per_resblock = 0
    for u in gen.upsample_rates:
        ch //= 2
        t *= u
        if gen._stage_is_fused(ch):
            per_mrf += len(mrf.launch_plan(ch, gen.resblock_kernel_sizes,
                                           gen.resblock_dilations[0], 1 if bf16 else 2,
                                           rows, t, sms))
        elif gen.use_pallas_resblocks:
            per_resblock += sum(len(resblock.launch_plan(ch, k, d, rows, t, sms))
                                for k, d in zip(gen.resblock_kernel_sizes,
                                                gen.resblock_dilations))
    return per_mrf, per_resblock


def launches_by_forward(launched):
    """The (MRF, ResBlock) launches of the generator forwards ``launched``
    (vocoder_launches of each) in all, and the distinct counts a forward."""
    return (sum(m for m, _ in launched), sum(r for _, r in launched),
            sorted(set(launched)))


def stream_phase(root, fs2_exp, rank_exp, voc_sd, dev):
    """load_synthesizer from the two experiment directories and a seeded
    .npz vocoder, then: a streamed POST /synthesize over HTTP; chunked
    against unchunked vocoding of one content-trimmed mel; warm
    time-to-first-audio and total (median of 10 after one warm-up, as
    bench.py's bench_ttfa); the launches of one stream."""
    from emotts_torch.infer.server import make_server
    from emotts_torch.infer.streaming import (generator_halo_frames, stream_text,
                                              vocode_streaming)
    from emotts_torch.infer.synthesize import load_synthesizer, save_vocoder_params_npz
    from emotts_torch.nn.convert import hifigan_to_flax
    from emotts_torch.ops import attention, mrf, resblock

    cfg = full_width_config()
    npz = os.path.join(root, "vocoder.npz")
    save_vocoder_params_npz(hifigan_to_flax(voc_sd), npz)
    cfg.inference.vocoder_checkpoint = npz
    synth = load_synthesizer(cfg, fs2_exp, rank_exp, device=dev)
    if not (synth.vocoder.fused_mrf and synth.vocoder.use_pallas_resblocks
            and synth.intensity_bank is not None):
        raise AssertionError("load_synthesizer did not load the kernels' "
                             "generator and the bank")
    text, hop = cfg.inference.text, cfg.audio.hop_length
    halo = generator_halo_frames(synth.vocoder)

    # chunked against unchunked vocoding of the same content-trimmed mel
    ids = synth.text_to_phoneme_ids(text)
    inten = synth.intensity_for(1, 2, 1, len(ids))[None]
    mel, lens = synth.synthesize_mels(ids, np.array([1], np.int32), inten)
    n = int(lens[0])
    whole = synth.vocode(mel[:, :n])[0].cpu().numpy().astype(np.int64)
    chunked = np.concatenate(list(vocode_streaming(
        synth._vocode, mel[:, :n], hop, STREAM_CHUNK, halo)), axis=1)[0].astype(np.int64)
    if whole.shape != chunked.shape or n < 2 * STREAM_CHUNK:
        raise AssertionError(f"{n} frames: chunked {chunked.shape}, whole {whole.shape}")
    steps = int(np.abs(whole - chunked).max())
    if steps > 8:
        raise AssertionError(f"streamed PCM differs from unchunked by {steps} steps")
    if np.abs(whole).max() < 100:
        raise AssertionError("the streamed sentence is silent")

    def run_once():
        t0 = time.perf_counter()
        gen = stream_text(synth, text, 1, 2, level=1, chunk_frames=STREAM_CHUNK)
        first = next(gen)
        ttfa = time.perf_counter() - t0
        samples = first.size + sum(piece.size for piece in gen)
        return ttfa, time.perf_counter() - t0, samples

    run_once()  # warm: allocator, cuDNN choices for every window shape
    zero_counts(attention, mrf, resblock)
    counter = ForwardCounter(synth)
    runs = [run_once() for _ in range(10)]
    counter.close()
    per_stream = dict(fused_attention=attention.launch_count / 10,
                      fused_mrf_stage=mrf.launch_count / 10,
                      fused_resblock1=resblock.launch_count / 10,
                      fs2_forwards=counter.fs2 / 10,
                      generator_forwards=counter.vocoder / 10)
    if min(per_stream.values()) == 0:
        raise AssertionError(f"a stream launched no kernel of a kind: {per_stream}")
    ttfas = sorted(r[0] for r in runs)
    totals = sorted(r[1] for r in runs)

    # the HTTP path, counted with the serving counters' rule
    zero_counts(attention, mrf, resblock)
    counter = ForwardCounter(synth)
    httpd = make_server(cfg, synth, port=0, device=dev.type)
    thread = threading.Thread(target=httpd.serve_forever, daemon=True)
    thread.start()
    try:
        req = urllib.request.Request(
            f"http://127.0.0.1:{httpd.server_address[1]}/synthesize",
            data=json.dumps({"text": "The ship was quiet. Then the lights came on.",
                             "speaker": "jenie", "emotion": "angry", "level": 2,
                             "stream": True}).encode(),
            headers={"Content-Type": "application/json"})
        t0 = time.perf_counter()
        with urllib.request.urlopen(req, timeout=600) as r:
            kind, rate = r.headers["Content-Type"], r.headers["X-Sample-Rate"]
            body = r.read()
        http_ms = 1e3 * (time.perf_counter() - t0)
    finally:
        httpd.shutdown()
        httpd.server_close()
        thread.join(timeout=30)
    counter.close()
    if thread.is_alive():
        raise AssertionError("the server thread did not stop")
    if kind != "audio/L16" or rate != str(cfg.audio.sampling_rate):
        raise AssertionError(f"streamed response {kind}, rate {rate}")
    seconds = check_audio(np.frombuffer(body, "<i2"), cfg, 2, "streamed /synthesize")
    launches = dict(fused_attention=attention.launch_count,
                    fused_mrf_stage=mrf.launch_count,
                    fused_resblock1=resblock.launch_count)
    n_mrf, n_resblock, _ = launches_by_forward(counter.launched)
    expected = dict(
        fused_attention=(cfg.fastspeech2.enc_num_layers
                         + cfg.fastspeech2.dec_num_layers) * counter.fs2,
        fused_mrf_stage=n_mrf, fused_resblock1=n_resblock)
    if launches != expected or min(launches.values()) == 0:
        raise AssertionError(f"streamed request's launches {launches}, "
                             f"expected {expected}")
    return launches, dict(
        frames=n, chunk_frames=STREAM_CHUNK, halo_frames=halo,
        max_pcm_steps_streamed_vs_whole=steps, streamed_equals_whole=steps == 0,
        limit_pcm_steps=8, ttfa_ms_median=1e3 * ttfas[5],
        ttfa_ms_runs=[1e3 * t for t in ttfas],
        total_ms_median=1e3 * totals[5],
        audio_s=runs[0][2] / cfg.audio.sampling_rate,
        launches_per_stream=per_stream, http=dict(
            latency_ms=http_ms, audio_s=seconds, launches=launches,
            fs2_forwards=counter.fs2, generator_forwards=counter.vocoder))


def fs2_phases(root, rank_exp, voc_sd, dev):
    """Phases 12-14 on the corpus under ``root`` and the rank experiment
    ``rank_exp``: FS2 training (its attention launches counted against the
    forwards that make them), the FS2 train parity, and the streamed path
    (counted likewise).  Returns the FS2 experiment, the two paths' launch
    counts, and the fp32 attention launches of the three phases."""
    from emotts_torch.nn.fastspeech2 import FastSpeech2
    from emotts_torch.nn.intensity import IntensityExtractor
    from emotts_torch.ops import attention

    t0 = time.perf_counter()
    fs2_cfg = fs2_config(root)
    zero_counts(attention)
    extractor, fs2_forwards = ModuleCounter(IntensityExtractor), ModuleCounter(FastSpeech2)
    fs2_exp, fs2_trained = fs2_train_phase(fs2_cfg, rank_exp, dev)
    extractor.close()
    fs2_forwards.close()
    fs2_launches = dict(fused_attention=attention.launch_count,
                        fused_attention_bwd=attention.bwd_launch_count)
    f2 = fs2_cfg.fastspeech2
    fs2_layers = f2.enc_num_layers + f2.dec_num_layers
    fs2_expected = dict(
        fused_attention=fs2_layers * fs2_forwards.forwards
        + fs2_cfg.rank_model.n_encoder_layers * extractor.forwards,
        fused_attention_bwd=fs2_layers * attention.BWD_LAUNCHES_PER_CALL
        * fs2_forwards.training_forwards)
    fp32 = dict(counted=fp32_attention_launches(), expected=expected_fp32_launches(
        {"fs2": fs2_forwards, "extractor": extractor},
        {"fs2": fs2_layers, "extractor": fs2_cfg.rank_model.n_encoder_layers}))
    if (fs2_launches != fs2_expected or min(fs2_launches.values()) == 0
            or fp32["counted"] != fp32["expected"]):
        raise AssertionError(f"launch counters {fs2_launches}, expected {fs2_expected}; "
                             f"fp32 {fp32}")
    emit("fs2_train", seconds=time.perf_counter() - t0, **fs2_trained,
         launches=dict(counted=fs2_launches, expected=fs2_expected,
                       fs2_forwards=fs2_forwards.forwards,
                       fs2_train_steps=fs2_forwards.training_forwards,
                       extractor_forwards=extractor.forwards, fp32=fp32))
    torch.cuda.empty_cache()

    t0 = time.perf_counter()
    parity = fs2_parity_phase(root, rank_exp, dev)
    emit("fs2_train_parity", seconds=time.perf_counter() - t0, **parity)

    t0 = time.perf_counter()
    stream_launches, streamed = stream_phase(root, fs2_exp, rank_exp, voc_sd, dev)
    # the streamed request's, counted from 0 before it
    streamed["http"]["fp32_launches"] = fp32_attention_launches()
    emit("stream", seconds=time.perf_counter() - t0, **streamed)
    return fs2_exp, fs2_launches, stream_launches, dict(
        fs2_training=fp32["counted"], fs2_train_parity=parity["fp32_launches"]["counted"],
        streaming=streamed["http"]["fp32_launches"])


# --------------------------------------------------------------------------
# phases 15-16: raw audio to features on the card, then the evaluation
# reports through the attention and vocoder kernels
# --------------------------------------------------------------------------

RAW_UTTS = 3  # utterances per (speaker, emotion); EmoV-DB has about 70-400
RAW_SR = 44100  # EmoV-DB's recordings are not at the model's 16 kHz
EVAL_F0_UTTS = 4  # F0 rows through the vocoder per evaluation run
_RAW_PHONES = ("HH", "AH0", "L", "OW1", "W", "ER1", "D", "K", "AE1", "T", "S",
               "IY1", "N", "M", "EY1", "R")
_UNVOICED = {"HH", "K", "T", "S"}
_SPEAKER_F0 = (210.0, 230.0, 115.0, 125.0)  # bea, jenie, josh, sam


def raw_config(root):
    """Config() defaults (16 kHz, n_fft 1024, hop 256, 80 mels; the five
    frame buckets) over a raw corpus under ``root``: ``raw/`` in EmoV-DB's
    layout, ``aligned/`` its TextGrids, ``corpus/`` and ``features/`` what
    prepare_corpus and preprocess_all write, and the experiments of the
    training phases.  One test utterance per (speaker, emotion) so that the
    rank pair lists have both splits at this corpus size."""
    from emotts_torch.utils.config import Config

    cfg = Config()
    d = cfg.data
    d.data_path = os.path.join(root, "raw")
    d.corpus_path = os.path.join(root, "corpus")
    d.textgrid_path = os.path.join(root, "aligned")
    d.preprocessed_path = os.path.join(root, "features")
    d.experiment_path = os.path.join(root, "experiments")
    d.test_utts_per_emotion = 1
    return cfg


def make_raw_corpus(cfg, seed, utts=RAW_UTTS):
    """A raw corpus in EmoV-DB's layout, made with numpy from ``seed``:
    ``<speaker>/<emotion>/<emotion>_1-28_<id>.wav`` (16-bit, 44.1 kHz) and
    ``cmuarctic.data``, plus the aligner's TextGrids, written by the port's
    write_textgrid.  An utterance is 1.5-6 s: silence, then phones of about
    120 ms (voiced: four harmonics of an F0 that drifts by ±10 % around the
    speaker's and emotion's own; unvoiced: noise), then silence, and noise
    under all of it.  Returns (utterances, seconds of audio)."""
    from emotts_torch.audio.textgrid import Interval, write_textgrid
    from emotts_torch.audio.wavio import write_wav

    rng = np.random.default_rng(seed)
    lines, seconds, n = [], 0.0, 0
    for i in range(1, utts + 1):
        lines.append(f'( arctic_a{i:04d} "Sentence number {i} of the made corpus." )')
    for si, speaker in enumerate(cfg.data.speakers):
        os.makedirs(os.path.join(cfg.data.textgrid_path, speaker), exist_ok=True)
        for ei, emotion in enumerate(cfg.data.emotions):
            out = os.path.join(cfg.data.data_path, speaker, emotion)
            os.makedirs(out, exist_ok=True)
            for i in range(1, utts + 1):
                total = float(rng.uniform(1.5, 6.0))
                lead, tail = rng.uniform(0.1, 0.3, size=2)
                speech = total - lead - tail
                n_ph = max(3, int(speech / 0.12))
                durs = rng.dirichlet(np.full(n_ph, 4.0)) * speech
                phones = rng.choice(_RAW_PHONES, size=n_ph)
                t = np.arange(int(total * RAW_SR)) / RAW_SR
                f0 = (_SPEAKER_F0[si % 4] * (1.0 + 0.06 * ei)
                      * (1.0 + 0.1 * np.sin(2 * np.pi * rng.uniform(0.3, 1.2) * t
                                            + rng.uniform(0, 2 * np.pi))))
                phase = 2 * np.pi * np.cumsum(f0) / RAW_SR
                voiced = sum(np.sin(k * phase) / k for k in range(1, 5))
                y = 0.005 * rng.standard_normal(len(t))
                intervals = [Interval(0.0, float(lead), "")]
                start = float(lead)
                for d, ph in zip(durs, phones):
                    s, e = int(start * RAW_SR), int((start + d) * RAW_SR)
                    y[s:e] += (0.05 * rng.standard_normal(e - s) if ph in _UNVOICED
                               else 0.35 * voiced[s:e])
                    intervals.append(Interval(start, start + float(d), str(ph)))
                    start += float(d)
                intervals.append(Interval(start, total, "sil"))
                write_wav(os.path.join(out, f"{emotion}_1-28_{i:04d}.wav"),
                          y.astype(np.float32), RAW_SR)
                write_textgrid(os.path.join(cfg.data.textgrid_path, speaker,
                                            f"{emotion}_{i:04d}.TextGrid"),
                               intervals, total)
                seconds += total
                n += 1
    with open(os.path.join(cfg.data.data_path, "cmuarctic.data"), "w") as f:
        f.write("\n".join(lines) + "\n")
    return n, seconds


def event_ms(dev, fn, *args):
    """(result, ms) of one call of ``fn`` on ``dev``, between two CUDA events
    (where the host launches slower than the card runs, its gaps count
    too); the host's clock elsewhere (the phases also run on the CPU to
    rehearse them)."""
    if dev.type != "cuda":
        t0 = time.perf_counter()
        return fn(*args), 1e3 * (time.perf_counter() - t0)
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    out = fn(*args)
    stop.record()
    torch.cuda.synchronize()
    return out, start.elapsed_time(stop)


def preprocess_phase(root, dev):
    """prepare_corpus (44.1 → 16 kHz) and preprocess_all(device_mel=True)
    on ``dev`` over a raw corpus made from SEED; every mel batch held
    against mel_energy_np at the JAX package's tolerances
    (tests/test_audio_mel.py:96-100); the rank pair lists and the FS2 splits
    over the result, and every written .npz read back through
    RankPairDataset and FS2Dataset."""
    from emotts_torch.audio import mel as mel_mod
    from emotts_torch.audio.native import have_native
    from emotts_torch.cli.prepare_corpus import prepare_corpus
    from emotts_torch.data import (FS2Dataset, RankPairDataset, build_fs2_splits,
                                   build_rank_pair_lists)
    from emotts_torch.data.preprocess import preprocess_all

    cfg = raw_config(root)
    t0 = time.perf_counter()
    n_raw, audio_s = make_raw_corpus(cfg, SEED, RAW_UTTS)
    made_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    prepared = prepare_corpus(cfg, verbose=False)
    prepare_s = time.perf_counter() - t0
    if prepared != n_raw:
        raise AssertionError(f"prepare_corpus wrote {prepared} of {n_raw} utterances")

    batches = []
    inner = mel_mod.mel_energy

    def recorded(y, lengths, audio_cfg, floor="hard"):
        if y.device.type != dev.type:
            raise AssertionError(f"device_mel computed on {y.device}, not {dev}")
        out, ms = event_ms(dev, inner, y, lengths, audio_cfg, floor)
        batches.append(dict(ms=ms, y=y.cpu().numpy(), lengths=lengths.cpu().numpy(),
                            mel=out[0].cpu().numpy(), energy=out[1].cpu().numpy()))
        return out

    mel_mod.mel_energy = recorded
    t0 = time.perf_counter()
    try:
        counts = preprocess_all(cfg, verbose=False, device_mel=True, device=dev)
    finally:
        mel_mod.mel_energy = inner
    preprocess_s = time.perf_counter() - t0
    utterances = sum(counts.values())
    if utterances != n_raw or not batches:
        raise AssertionError(f"preprocess_all kept {utterances} of {n_raw} utterances "
                             f"in {len(batches)} mel batches")

    # the card's mel and energy against the numpy golden, row by row
    worst = dict(exp_mel=0.0, mean_log_mel=0.0, energy=0.0)
    for b in batches:
        for row, n in enumerate(b["lengths"]):
            ref_mel, ref_energy = mel_mod.mel_energy_np(b["y"][row, :n], cfg.audio)
            t = ref_mel.shape[1]
            mel, energy = b["mel"][row, :, :t], b["energy"][row, :t]
            np.testing.assert_allclose(np.exp(mel), np.exp(ref_mel), rtol=5e-3, atol=5e-4)
            np.testing.assert_allclose(energy, ref_energy, rtol=1e-3, atol=1e-3)
            mean_log = float(np.abs(mel - ref_mel).mean())
            if mean_log >= 5e-3:
                raise AssertionError(f"mean |log-mel - golden| {mean_log} >= 5e-3")
            worst["exp_mel"] = max(worst["exp_mel"],
                                   float(np.abs(np.exp(mel) - np.exp(ref_mel)).max()))
            worst["mean_log_mel"] = max(worst["mean_log_mel"], mean_log)
            worst["energy"] = max(worst["energy"], float(np.abs(energy - ref_energy).max()))

    train, test = build_rank_pair_lists(cfg)
    fs2_train, fs2_valid = build_fs2_splits(cfg)
    if not (train and test and fs2_train and fs2_valid):
        raise AssertionError("an empty split list")
    if len(fs2_train) + len(fs2_valid) != utterances:
        raise AssertionError("the FS2 splits do not cover every utterance")
    read = dict(rank_pairs=0, fs2=0)
    for split in ("train", "test"):
        ds = RankPairDataset(cfg, split)
        for i in range(len(ds)):
            ex = ds[i]
            if ex.emo_x.shape != (ex.length, cfg.audio.n_mels + 2) or not (
                    np.isfinite(ex.emo_x).all() and np.isfinite(ex.neu_x).all()):
                raise AssertionError(f"rank pair {split}/{i} reads back wrong")
            read["rank_pairs"] += 1
    for split in ("train", "valid"):
        ds = FS2Dataset(cfg, split)
        for i in range(len(ds)):
            ex = ds[i]
            if (ex.mel.shape != (int(ex.durations.sum()), cfg.audio.n_mels)
                    or len(ex.phonemes) != len(ex.durations)
                    or not np.isfinite(ex.rank_x).all()):
                raise AssertionError(f"FS2 example {split}/{i} reads back wrong")
            read["fs2"] += 1
    if read["rank_pairs"] != len(train) + len(test) or read["fs2"] != utterances:
        raise AssertionError(f"read back {read}")
    ms = [b["ms"] for b in batches]
    # an event pair around a batch also holds the host's launch gaps: the
    # device's own time of the largest and the smallest batch, calls queued
    # behind a sleep kernel
    device_only = {}
    if dev.type == "cuda":
        for b in (max(batches, key=lambda b: b["y"].size),
                  min(batches, key=lambda b: b["y"].size)):
            y, lengths = torch.from_numpy(b["y"]).to(dev), torch.from_numpy(b["lengths"]).to(dev)
            device_only[f"{b['y'].shape[0]}x{b['y'].shape[1]}"] = device_ms(
                lambda: inner(y, lengths, cfg.audio))
    return cfg, dict(
        cuts=dict(utterances_per_speaker_emotion=RAW_UTTS, raw_sample_rate=RAW_SR,
                  note="4 speakers x 5 emotions as EmoV-DB; a few utterances each"),
        utterances=utterances, audio_seconds=audio_s, make_seconds=made_s,
        prepare_seconds=prepare_s, preprocess_wall_seconds=preprocess_s,
        mel_batches=len(batches),
        mel_batch_rows=[int(b["y"].shape[0]) for b in batches],
        mel_batch_samples=[int(b["y"].shape[1]) for b in batches],
        event_ms_per_mel_batch=ms, event_ms_per_mel_batch_mean=float(np.mean(ms)),
        device_ms_behind_sleep=device_only,
        native_library_loaded=have_native(),
        max_err_vs_numpy_golden=worst,
        tolerance=dict(exp_mel=dict(rtol=5e-3, atol=5e-4), mean_log_mel=5e-3,
                       energy=dict(rtol=1e-3, atol=1e-3)),
        rank_pairs=dict(train=len(train), test=len(test)),
        fs2_split=dict(train=len(fs2_train), valid=len(fs2_valid)), read_back=read)


def _finite_report(report, what):
    """Every number in a report (nested dicts and lists) is finite."""
    def walk(node, path):
        if isinstance(node, dict):
            for k, v in node.items():
                walk(v, f"{path}/{k}")
        elif isinstance(node, (list, tuple)):
            for i, v in enumerate(node):
                walk(v, f"{path}/{i}")
        elif isinstance(node, float) and not math.isfinite(node):
            raise AssertionError(f"{what}: {path} is {node}")

    walk(report, what)


def evaluate_phase(cfg, fs2_exp, rank_exp, dev):
    """Evaluator.run over the preprocessed corpus's valid split, with the
    seeded vocoder, under both conditionings, then
    evaluate_intensity_efficacy for one text: the FS2 and rank experiments
    of the training phases (fp32 for the evaluator and the scorer, the
    sweep's Synthesizer in the configured bf16).  The kernels' counters
    against the forwards that make them; the first batch's teacher-forced
    PostNet mel through the kernels against the all-plain forward."""
    from emotts_torch.eval import Evaluator, evaluate_intensity_efficacy
    from emotts_torch.infer.synthesize import maybe_load_vocoder
    from emotts_torch.nn.fastspeech2 import FastSpeech2
    from emotts_torch.nn.hifigan import HiFiGANGenerator
    from emotts_torch.nn.intensity import IntensityExtractor
    from emotts_torch.ops import attention, mrf, resblock

    cfg.fastspeech2.fused_attention = cfg.rank_model.fused_attention = True
    bank = np.load(os.path.join(rank_exp, "intensity.npy"))
    zero_counts(attention, mrf, resblock)
    counters = dict(fs2=ModuleCounter(FastSpeech2),
                    extractor=ModuleCounter(IntensityExtractor),
                    generator=ModuleCounter(HiFiGANGenerator, launches=vocoder_launches))
    t0 = time.perf_counter()
    ev = Evaluator(cfg, fs2_exp, rank_exp, vocoder_params=maybe_load_vocoder(cfg),
                   device=dev)
    if not (ev.vocoder.fused_mrf and ev.vocoder.use_pallas_resblocks):
        raise AssertionError("the evaluator's vocoder does not take the kernels")
    batch_ms, infer = [], ev.infer

    def timed(batch, rep=None):
        t = time.perf_counter()
        out = infer(batch, rep)  # ends in copies to the host: synchronised
        batch_ms.append(1e3 * (time.perf_counter() - t))
        return out

    ev.infer = timed
    reports = {}
    for conditioning in ("own", "prototype"):
        path = os.path.join(fs2_exp, f"eval_{conditioning}.json")
        reports[conditioning] = ev.run(
            split="valid", out_path=path, f0_max_utts=EVAL_F0_UTTS,
            conditioning=conditioning,
            intensity_bank=bank if conditioning == "prototype" else None)
        with open(path) as f:
            written = json.load(f)
        _finite_report(written, f"eval_{conditioning}.json")
        overall = written["overall"]
        if written["n_utterances"] == 0 or "f0_rmse_hz" not in overall \
                or "mcd_dtw_free_running" not in overall:
            raise AssertionError(f"eval_{conditioning}.json lacks rows: {overall}")
    eval_s = time.perf_counter() - t0
    ev.infer = infer

    t0 = time.perf_counter()
    sweep_path = os.path.join(fs2_exp, "intensity_eval.json")
    sweep = evaluate_intensity_efficacy(cfg, fs2_exp, rank_exp,
                                        texts=[cfg.inference.text],
                                        out_path=sweep_path, device=dev)
    sweep_s = time.perf_counter() - t0
    launches = dict(fused_attention=attention.launch_count,
                    fused_mrf_stage=mrf.launch_count,
                    fused_resblock1=resblock.launch_count)
    forwards = {name: c.forwards for name, c in counters.items()}
    fp32_forwards = {name: c.fp32_forwards for name, c in counters.items()}
    for c in counters.values():
        c.close()
    with open(sweep_path) as f:
        written = json.load(f)
    _finite_report(written, "intensity_eval.json")
    n_combos = cfg.n_speakers * (1 + (cfg.n_emotions - 1) * cfg.inference.bucket_size)
    for key in ("monotonic_fraction_strict", "pairwise_order_accuracy"):
        if not isinstance(written[key], float):
            raise AssertionError(f"intensity_eval.json: {key} = {written[key]}")
    if written["n_synthesized"] != n_combos or written["feature_path"] != "vocoded_audio":
        raise AssertionError(f"the sweep scored {written['n_synthesized']} of {n_combos} "
                             f"utterances from {written['feature_path']}")

    f2 = cfg.fastspeech2
    n_mrf, n_resblock, by_forward = launches_by_forward(counters["generator"].launched)
    expected = dict(
        fused_attention=(f2.enc_num_layers + f2.dec_num_layers) * forwards["fs2"]
        + cfg.rank_model.n_encoder_layers * forwards["extractor"],
        fused_mrf_stage=n_mrf, fused_resblock1=n_resblock)
    if launches != expected or min(launches.values()) == 0:
        raise AssertionError(f"evaluation launches {launches}, expected {expected}")
    # the evaluator's and the scorer's models are fp32, the sweep's
    # Synthesizer bf16
    fp32 = dict(counted=fp32_attention_launches(), expected=expected_fp32_launches(
        {"fs2": counters["fs2"], "extractor": counters["extractor"]},
        {"fs2": f2.enc_num_layers + f2.dec_num_layers,
         "extractor": cfg.rank_model.n_encoder_layers}))
    if fp32["counted"] != fp32["expected"] or fp32["counted"]["fused_attention"] == 0:
        raise AssertionError(f"evaluation's fp32 attention launches {fp32}")

    # the kernels' eval forward against the all-plain one, uncounted
    plain_cfg = copy.deepcopy(cfg)
    plain_cfg.fastspeech2.fused_attention = plain_cfg.rank_model.fused_attention = False
    plain = Evaluator(plain_cfg, fs2_exp, rank_exp, device=dev)
    batch = next(iter(ev.loader("valid").epoch(0)))
    got, want = ev.infer(batch), plain.infer(batch)
    tf_err, tf_rel = compare(torch.from_numpy(got[0]), torch.from_numpy(want[0]),
                             **TOL[torch.float32])
    same = np.flatnonzero(got[3] == want[3])
    fr_err = 0.0
    for i in same:
        n = int(got[3][i])
        fr_err = max(fr_err, compare(torch.from_numpy(got[2][i, :n]),
                                     torch.from_numpy(want[2][i, :n]),
                                     **TOL[torch.float32])[0])
    del ev, plain
    return launches, dict(
        conditionings={k: dict(n_utterances=r["n_utterances"], overall=r["overall"])
                       for k, r in reports.items()},
        eval_seconds=eval_s, eval_batches=len(batch_ms), wall_ms_per_eval_batch=batch_ms,
        wall_ms_per_eval_batch_mean=float(np.mean(batch_ms)),
        intensity_sweep=dict(
            seconds=sweep_s, n_synthesized=written["n_synthesized"],
            monotonic_fraction_strict=written["monotonic_fraction_strict"],
            pairwise_order_accuracy=written["pairwise_order_accuracy"],
            emotion_silhouette_h=written["emotion_silhouette_h"],
            verdict=written["verdict"]),
        launches=dict(counted=launches, expected=expected, forwards=forwards,
                      fp32=fp32, fp32_forwards=fp32_forwards,
                      mrf_and_resblock_launches_by_generator_forward=by_forward),
        kernels_vs_plain=dict(
            frames=int(batch["mel"].shape[1]), rows=int(batch["mel"].shape[0]),
            teacher_forced_postnet_max_abs_err=tf_err,
            teacher_forced_postnet_max_rel_err=tf_rel,
            free_running_rows_equal_length=int(len(same)),
            free_running_max_abs_err=fr_err, tolerance=TOL[torch.float32]))


# --------------------------------------------------------------------------
# phases 17-20: HiFi-GAN training on the raw corpus, its parity, the
# FS2-conditioned fine-tune, and serving the exported vocoder through the
# kernels
# --------------------------------------------------------------------------

PEAK_FP32 = 67e12  # float32 outside the tensor cores: the generator's convs, TF32 off
VOC_STEPS = 20  # full-width GAN steps (the configured run: 500,000)
VOC_RESUME_STEPS = 2
VOC_FINETUNE_STEPS = 5
# narrow fp32 widths for the card-against-CPU step
VOC_PARITY = dict(upsample_initial_channel=64, disc_channel_mult=0.125, batch_size=4,
                  compute_dtype="float32")
VOC_PARITY_TOL = dict(metrics_rtol=1e-4, gradient_rtol_of_largest_entry=1e-3)
SERVE_TEXTS = ("The new voice was trained here.", "It speaks through the kernels.",
               "One more line for the vocoder.")


def vocoder_config(root, **overrides):
    """Config().train_vocoder as it stands — HiFi-GAN V1 (512 channels,
    rates 8·8·2·2), MPD periods 2/3/5/7/11 and MSD 3 scales at full
    channels, batch 16, 32-frame segments, bf16, condition "gt", lr 2e-4
    with b1 0.8, b2 0.99 — over phase 15's raw corpus (prepare_corpus's
    16 kHz wavs under ``<root>/corpus``), with ``overrides`` of
    ``train_vocoder``."""
    cfg = raw_config(root)
    cfg.fastspeech2.fused_attention = cfg.rank_model.fused_attention = True
    for key, value in overrides.items():
        setattr(cfg.train_vocoder, key, value)
    return cfg


def recorded_steps(trainer):
    """Wrap ``trainer.train_step``: each step's synchronised wall ms and
    metrics are appended to the lists returned."""
    step, step_ms, metrics = trainer.train_step, [], []

    def recorded(batch):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = step(batch)
        torch.cuda.synchronize()
        step_ms.append(1e3 * (time.perf_counter() - t0))
        metrics.append(out)
        return out

    trainer.train_step = recorded
    return step_ms, metrics


def models_changed(before, trainer):
    """Whether the generator and the discriminators differ from ``before``."""
    now = dict(gen=trainer.gen.state_dict(), disc=trainer.disc.state_dict())
    return {name: not same_bits(before[name], now[name]) for name in before}


def model_states(trainer):
    return dict(gen=copy.deepcopy(trainer.gen.state_dict()),
                disc=copy.deepcopy(trainer.disc.state_dict()))


def check_finite(metrics, what):
    values = [v for m in metrics for v in m.values()]
    if not metrics or not np.isfinite(values).all():
        raise AssertionError(f"{what}: losses are not all finite: {metrics}")


def traced_device_ms(fn, runs=3):
    """(device ms, kernel launches, the three largest kernels by device ms)
    of one call of ``fn``: kernel rows of a torch.profiler trace of
    ``runs`` calls after one warm-up."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(runs):
            fn()
        torch.cuda.synchronize()
    kernels = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    largest = sorted(kernels, key=lambda e: -e.self_device_time_total)[:3]
    return (sum(e.self_device_time_total for e in kernels) / runs / 1e3,
            sum(e.count for e in kernels) // runs,
            [[e.key[:60], e.self_device_time_total / runs / 1e3, e.count // runs]
             for e in largest])


def vocoder_step_parts(trainer, batch, dev):
    """The device time, launches and operations of each part of a GAN step,
    each run alone at the step's shapes as the step runs it: the generator
    forward and backward; MPD and MSD each (real and fake forward with the
    update's backward, then the fake forward with the backward into ŷ and
    the real forward without gradient); the three mel computations with the
    mel loss's backward."""
    from torch.utils.flop_counter import FlopCounterMode

    from emotts_torch.losses.gan import (discriminator_loss, feature_matching_loss,
                                         generator_adversarial_loss, mel_l1_loss)

    y = torch.from_numpy(batch["y"]).to(dev)
    with torch.no_grad():
        mel_in = trainer._device_mel(y).transpose(1, 2)
        mel_soft = trainer._device_mel(y, floor="soft")
        y_hat = trainer._gen_forward(mel_in)
    upstream = (1e-3 * torch.randn(y_hat.shape, generator=torch.Generator().manual_seed(SEED))
                ).to(dev)

    def generator():
        trainer._gen_forward(mel_in).backward(upstream)

    def discriminator(d):
        def run():
            real, _ = d(y)
            fake, _ = d(y_hat)
            discriminator_loss(real, fake).backward()
            leaf = y_hat.detach().requires_grad_()
            d.requires_grad_(False)
            try:
                fake, fake_feats = d(leaf)
                with torch.no_grad():
                    _, real_feats = d(y)
                (generator_adversarial_loss(fake)
                 + feature_matching_loss(real_feats, fake_feats)).backward()
            finally:
                d.requires_grad_(True)
        return run

    def mel_loss():
        with torch.no_grad():
            trainer._device_mel(y)
            trainer._device_mel(y, floor="soft")
        leaf = y_hat.detach().requires_grad_()
        mel_l1_loss(trainer._device_mel(leaf, floor="soft"), mel_soft).backward()

    parts = dict(generator=generator, mpd=discriminator(trainer.disc.mpd),
                 msd=discriminator(trainer.disc.msd), mel_loss=mel_loss)
    out = {}
    for name, fn in parts.items():
        with FlopCounterMode(display=False) as counter:
            fn()
        ms, launches, largest = traced_device_ms(fn) if dev.type == "cuda" else (None,) * 3
        out[name] = dict(device_ms=ms, launches=launches, flops=counter.get_total_flops(),
                         largest_kernels=largest)
    trainer.gen.zero_grad(set_to_none=True)
    trainer.disc.zero_grad(set_to_none=True)
    return out


def vocoder_train_phase(cfg, dev):
    """VocoderTrainer.fit at full width for VOC_STEPS steps on the raw
    corpus; losses finite, both models changed, metrics, checkpoint and
    vocoder.npz written; a resume from the last checkpoint restores both
    states and runs VOC_RESUME_STEPS more with the step counter and the
    sampler seed (seed + step) as the reference sets them.  Then readings
    of a step: wall, a profiler trace (device ms, launches, idle share), the
    parts (vocoder_step_parts), its operations (FlopCounterMode) and the
    bound they imply."""
    from torch.utils.flop_counter import FlopCounterMode

    import emotts_torch.train.vocoder_trainer as vt

    vc = cfg.train_vocoder
    trainer = vt.VocoderTrainer(cfg, device=dev)
    start = model_states(trainer)
    step_ms, metrics = recorded_steps(trainer)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    exp = trainer.fit(n_steps=VOC_STEPS,
                      exp_path=os.path.join(cfg.data.experiment_path, "vocoder", "gt"))
    fit_s = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    del trainer.train_step  # the recording wrapper
    check_finite(metrics, "vocoder_train")
    changed = models_changed(start, trainer)
    del start
    if len(metrics) != VOC_STEPS or not all(changed.values()):
        raise AssertionError(f"{len(metrics)} steps; changed {changed}")
    series = read_metrics(exp)
    for tag in ("train/d_loss", "train/mel_l1", "train/g_adv", "train/feature_match",
                "train/g_total", "train/step_time_s"):
        if tag not in series or not np.isfinite(series[tag]).all():
            raise AssertionError(f"metrics.jsonl lacks a finite {tag}")
    checkpoints = sorted(os.listdir(os.path.join(exp, "checkpoints")))
    if checkpoints != [f"step_{VOC_STEPS}.pt"] or not os.path.isfile(
            os.path.join(exp, "vocoder.npz")):
        raise AssertionError(f"checkpoints {checkpoints}, or no vocoder.npz")

    # resume: a fresh trainer from the last checkpoint
    saved = model_states(trainer)
    fresh = vt.VocoderTrainer(cfg, device=dev)
    if not fresh.restore(exp) or not same_bits(model_states(fresh), saved):
        raise AssertionError("the restored vocoder states are not the saved ones")
    del saved
    seeds, sampler = [], vt.SegmentSampler

    class Recording(sampler):
        def __init__(self, *args, seed=0):
            seeds.append(seed)
            super().__init__(*args, seed=seed)

    vt.SegmentSampler = Recording
    try:
        fresh.fit(n_steps=VOC_STEPS + VOC_RESUME_STEPS, exp_path=exp, resume=True)
    finally:
        vt.SegmentSampler = sampler
    resumed = dict(gen_step=fresh.state.step, disc_step=fresh.state.disc.step,
                   sampler_seed=seeds, expected_sampler_seed=[vc.seed + VOC_STEPS])
    if (fresh.state.step, fresh.state.disc.step) != (VOC_STEPS + VOC_RESUME_STEPS,) * 2 \
            or seeds != [vc.seed + VOC_STEPS]:
        raise AssertionError(f"resume: {resumed}")
    del fresh

    # readings of a step, on the fitted trainer (these steps are not fit's)
    t0 = time.perf_counter()
    wavs = sorted(glob.glob(os.path.join(cfg.data.corpus_path, "*", "*.wav")))
    batch = {"y": vt.SegmentSampler(wavs, cfg.audio.sampling_rate, trainer.segment_samples,
                                    seed=SEED).batch(vc.batch_size)}
    profile = profile_steps(trainer, {vc.segment_frames: batch}, lambda b: len(b["y"]),
                            timed=5, traced=3, host_ops=False, groups=())
    with FlopCounterMode(display=False) as counter:
        trainer.train_step(batch)
    flops = counter.get_total_flops()
    parts = vocoder_step_parts(trainer, batch, dev)
    fp32_flops = parts["generator"]["flops"] + parts["mel_loss"]["flops"]
    bound_ms = 1e3 * flops / PEAK_BF16
    reading = dict(
        step_wall_ms_median=float(np.median(step_ms[1:])),
        step_wall_ms=step_ms, fit_step_time_s=series["train/step_time_s"][-1],
        profile=profile[str(vc.segment_frames)], parts=parts, step_flops=flops,
        bound_ms_at_bf16_peak=bound_ms,
        bound_ms_by_dtype=1e3 * (fp32_flops / PEAK_FP32
                                 + max(0, flops - fp32_flops) / PEAK_BF16),
        note_bound="the generator and the mel run in fp32 with TF32 off (CUDA cores, "
                   "67 TFLOP/s), the discriminators in bf16 (989 TFLOP/s)",
        seconds=time.perf_counter() - t0)
    return exp, trainer, dict(
        cuts=dict(steps=VOC_STEPS, note="Config().train_vocoder at full width; "
                  "500,000 steps configured"),
        steps=len(metrics), fit_seconds=fit_s, first_step_ms=step_ms[0],
        first=metrics[0], last=metrics[-1], peak_memory_bytes=peak,
        gen_parameters=sum(p.numel() for p in trainer.gen.parameters()),
        disc_parameters=sum(p.numel() for p in trainer.disc.parameters()),
        changed=changed, checkpoints=checkpoints, resumed=resumed, reading=reading)


def vocoder_parity_phase(root, dev):
    """One adversarial fp32 step at narrow widths (VOC_PARITY) from the same
    seeded weights and batch on the card and on the CPU: the five metrics at
    1e-4 relative, every gradient of the generator and the discriminators
    within 1e-3 of its own largest entry (both sides fp32 with TF32 off, in
    other summation orders; the updated parameters are not compared: Adam
    turns rounding-level gradients into steps of size lr)."""
    import emotts_torch.train.vocoder_trainer as vt

    cfg = vocoder_config(root, **VOC_PARITY)
    vc = cfg.train_vocoder
    wavs = sorted(glob.glob(os.path.join(cfg.data.corpus_path, "*", "*.wav")))
    batch = {"y": vt.SegmentSampler(wavs, cfg.audio.sampling_rate,
                                    vc.segment_frames * cfg.audio.hop_length,
                                    seed=SEED).batch(vc.batch_size)}
    runs = {}
    for side, where in (("card", dev), ("cpu", torch.device("cpu"))):
        t0 = time.perf_counter()
        trainer = vt.VocoderTrainer(cfg, device=where)
        metrics = trainer.train_step(batch)
        grads = {f"{part}.{n}": p.grad.detach().cpu()
                 for part, model in (("gen", trainer.gen), ("disc", trainer.disc))
                 for n, p in model.named_parameters()}
        runs[side] = (metrics, grads, time.perf_counter() - t0)
    (m_card, g_card, s_card), (m_cpu, g_cpu, s_cpu) = runs["card"], runs["cpu"]
    worst_metric = max(abs(m_card[k] - m_cpu[k]) / abs(m_cpu[k]) for k in m_cpu)
    worst, worst_at = 0.0, None
    for name, ref in g_cpu.items():
        scale = ref.abs().max().item()
        if not torch.isfinite(g_card[name]).all() or scale == 0.0:
            raise AssertionError(f"gradient of {name} is not finite, or zero")
        ratio = (g_card[name] - ref).abs().max().item() / scale
        if ratio > worst:
            worst, worst_at = ratio, name
    out = dict(widths=VOC_PARITY, segment_frames=vc.segment_frames, metrics_card=m_card,
               metrics_cpu=m_cpu, worst_metric_rel=worst_metric, parameters=len(g_cpu),
               worst_gradient_difference=worst, worst_at=worst_at, tolerance=VOC_PARITY_TOL,
               card_seconds=s_card, cpu_seconds=s_cpu)
    if m_card.keys() != m_cpu.keys() or len(m_cpu) != 5 \
            or worst_metric > VOC_PARITY_TOL["metrics_rtol"] \
            or worst > VOC_PARITY_TOL["gradient_rtol_of_largest_entry"]:
        raise AssertionError(f"vocoder step on the card against the CPU: {out}")
    return out


def vocoder_finetune_phase(cfg, fs2_exp, rank_exp, gt_exp, dev):
    """condition "fs2": predicted_mel_pairs over the raw corpus's train
    split through the fp32 Evaluator (the attention forward's fp32
    launches counted against the FS2 and extractor forwards that make
    them), then VOC_FINETUNE_STEPS GAN steps at full width on
    PairedSegmentSampler, continuing the gt run's last checkpoint."""
    import emotts_torch.train.vocoder_trainer as vt
    from emotts_torch.nn.fastspeech2 import FastSpeech2
    from emotts_torch.nn.intensity import IntensityExtractor
    from emotts_torch.ops import attention

    cfg = copy.deepcopy(cfg)
    cfg.train_vocoder.condition = "fs2"
    before, before_all = fp32_attention_launches(), attention.launch_count
    counters = dict(fs2=ModuleCounter(FastSpeech2), extractor=ModuleCounter(IntensityExtractor))
    t0 = time.perf_counter()
    pairs = vt.predicted_mel_pairs(cfg, fs2_exp, rank_exp, device=dev)
    pairs_s = time.perf_counter() - t0
    for c in counters.values():
        c.close()
    f2 = cfg.fastspeech2
    fp32 = dict(counted={k: v - before[k] for k, v in fp32_attention_launches().items()},
                expected=expected_fp32_launches(
                    counters, {"fs2": f2.enc_num_layers + f2.dec_num_layers,
                               "extractor": cfg.rank_model.n_encoder_layers}),
                forwards={name: c.forwards for name, c in counters.items()},
                all_forward_launches=attention.launch_count - before_all)
    if (fp32["counted"] != fp32["expected"] or fp32["counted"]["fused_attention"] == 0
            or fp32["all_forward_launches"] != fp32["counted"]["fused_attention"]):
        raise AssertionError(f"predicted_mel_pairs' attention launches {fp32}")
    frames = [int(m.shape[0]) for m, _ in pairs]
    if not pairs or any(w.size != n * cfg.audio.hop_length for n, (_, w) in zip(frames, pairs)):
        raise AssertionError(f"{len(pairs)} pairs of {frames} frames")

    trainer = vt.VocoderTrainer(cfg, device=dev)
    if not trainer.restore(gt_exp):
        raise AssertionError("no checkpoint of the gt run to fine-tune")
    start_step = trainer.state.step
    start = model_states(trainer)
    step_ms, metrics = recorded_steps(trainer)
    t0 = time.perf_counter()
    exp = trainer.fit(n_steps=start_step + VOC_FINETUNE_STEPS, pairs=pairs,
                      exp_path=os.path.join(cfg.data.experiment_path, "vocoder", "fs2"))
    fit_s = time.perf_counter() - t0
    del trainer.train_step
    check_finite(metrics, "vocoder_finetune")
    changed = models_changed(start, trainer)
    if len(metrics) != VOC_FINETUNE_STEPS or not all(changed.values()) \
            or trainer.state.step != start_step + VOC_FINETUNE_STEPS:
        raise AssertionError(f"{len(metrics)} fine-tune steps; changed {changed}")
    npz = os.path.join(exp, "vocoder.npz")
    if not os.path.isfile(npz):
        raise AssertionError("the fine-tune exported no vocoder.npz")
    return npz, dict(
        pairs=len(pairs), pair_frames=frames, pairs_seconds=pairs_s,
        fp32_launches=fp32, start_step=start_step, steps=len(metrics),
        fit_seconds=fit_s, step_wall_ms_median=float(np.median(step_ms[1:])),
        first=metrics[0], last=metrics[-1], changed=changed)


def serve_trained_vocoder_phase(npz, fs2_exp, rank_exp, dev):
    """The exported vocoder.npz through load_synthesizer (the kernels'
    generator): a batch of requests served, and a few utterances' mels
    vocoded through the MRF and ResBlock kernels against the plain
    generator on the same .npz, within 8 PCM steps; launches against the
    forwards that make them."""
    from emotts_torch.infer.synthesize import build_vocoder, load_synthesizer
    from emotts_torch.nn.convert import load_vocoder_checkpoint
    from emotts_torch.ops import attention, mrf, resblock

    cfg = full_width_config()
    cfg.inference.vocoder_checkpoint = npz
    synth = load_synthesizer(cfg, fs2_exp, rank_exp, device=dev)
    if dev.type == "cuda" and not (synth.vocoder.fused_mrf
                                   and synth.vocoder.use_pallas_resblocks):
        raise AssertionError("load_synthesizer did not build the kernels' generator")
    plain = build_vocoder(cfg, load_vocoder_checkpoint(npz), device=dev)

    def counts():
        return dict(fused_attention=attention.launch_count,
                    fused_mrf_stage=mrf.launch_count, fused_resblock1=resblock.launch_count)

    before = counts()
    counter = ForwardCounter(synth)
    t0 = time.perf_counter()
    waves = synth.synthesize_requests([
        {"text": text, "speaker": i, "emotion": 1 + i, "level": 1}
        for i, text in enumerate(SERVE_TEXTS)])
    served_ms = 1e3 * (time.perf_counter() - t0)
    steps, frames = 0, []
    for i, text in enumerate(SERVE_TEXTS):
        ids = synth.text_to_phoneme_ids(text)
        mel, lens = synth.synthesize_mels(ids, np.array([i], np.int32),
                                          synth.intensity_for(i, 1 + i, 1, len(ids))[None])
        n = int(lens[0])
        with torch.inference_mode():
            got = synth.vocode(mel[:, :n])[0].cpu().numpy().astype(np.int64)
            want = torch.clamp(plain(mel[:, :n]).float() * 32767.0, -32768.0, 32767.0
                               ).to(torch.int16)[0].cpu().numpy().astype(np.int64)
        steps = max(steps, int(np.abs(got - want).max()))
        frames.append(n)
    counter.close()
    launches = {k: v - before[k] for k, v in counts().items()}
    n_mrf, n_resblock, by_forward = launches_by_forward(counter.launched)
    f2 = cfg.fastspeech2
    expected = dict(fused_attention=(f2.enc_num_layers + f2.dec_num_layers) * counter.fs2,
                    fused_mrf_stage=n_mrf, fused_resblock1=n_resblock)
    if dev.type == "cuda" and (launches != expected or min(launches.values()) == 0):
        raise AssertionError(f"serving the trained vocoder: launches {launches}, "
                             f"expected {expected}")
    if any(w.size == 0 or not np.isfinite(w).all() for w in waves) or steps > 8:
        raise AssertionError(f"served {[w.size for w in waves]} samples; kernels "
                             f"against the plain generator {steps} PCM steps")
    return dict(
        requests=len(waves), samples=[int(w.size) for w in waves],
        peak=[float(np.abs(w).max()) for w in waves], served_ms=served_ms,
        compared_frames=frames, max_pcm_steps_kernels_vs_plain=steps, limit_pcm_steps=8,
        launches=launches, expected=expected, fs2_forwards=counter.fs2,
        generator_forwards=counter.vocoder,
        mrf_and_resblock_launches_by_generator_forward=by_forward)


def vocoder_phases(root, fs2_exp, rank_exp, dev):
    """Phases 17-20 over phase 15's corpus, the kernels' counters set to 0
    before them and read after: the path's launches (the fine-tune's fp32
    attention, the trained vocoder's MRF and ResBlock) and its fp32
    attention launches."""
    from emotts_torch.ops import attention, mrf, resblock

    zero_counts(attention, mrf, resblock)
    cfg = vocoder_config(root)
    t0 = time.perf_counter()
    gt_exp, trainer, trained = vocoder_train_phase(cfg, dev)
    emit("vocoder_train", seconds=time.perf_counter() - t0, **trained)
    del trainer
    torch.cuda.empty_cache()

    t0 = time.perf_counter()
    parity = vocoder_parity_phase(root, dev)
    emit("vocoder_train_parity", seconds=time.perf_counter() - t0, **parity)

    t0 = time.perf_counter()
    npz, tuned = vocoder_finetune_phase(cfg, fs2_exp, rank_exp, gt_exp, dev)
    emit("vocoder_finetune", seconds=time.perf_counter() - t0, **tuned)
    torch.cuda.empty_cache()

    t0 = time.perf_counter()
    served = serve_trained_vocoder_phase(npz, fs2_exp, rank_exp, dev)
    emit("serve_trained_vocoder", seconds=time.perf_counter() - t0, **served)
    launches = dict(fused_attention=attention.launch_count,
                    fused_mrf_stage=mrf.launch_count,
                    fused_resblock1=resblock.launch_count)
    return launches, fp32_attention_launches()


# --------------------------------------------------------------------------
# phase 21: the emotts-torch command over phase 15's raw corpus
# --------------------------------------------------------------------------

KERNELS = ("fused_attention", "fused_attention_bwd", "fused_mrf_stage",
           "fused_resblock1")
CLI_TEXT = "The ship was quiet tonight. Nobody had slept for two days."
SWEEP_TEXT = "Good morning."


def cli_config(root):
    """Config() widths (FS2 6+6 layers, d_model 384, 2 heads; the rank
    model's 6 layers; HiFi-GAN V1) with both attention kernel flags on, over
    phase 15's raw corpus (``raw/``, ``aligned/``) and a fresh
    ``cli/{corpus,features,experiments,demo}``: ``data.device_mel`` left
    off (``preprocess`` on the card takes the device mel by itself), one
    epoch of each trainer, the vocoder the chain trains."""
    cfg = raw_config(root)
    base = os.path.join(root, "cli")
    d = cfg.data
    d.corpus_path = os.path.join(base, "corpus")
    d.preprocessed_path = os.path.join(base, "features")
    d.experiment_path = os.path.join(base, "experiments")
    cfg.fastspeech2.fused_attention = cfg.rank_model.fused_attention = True
    cfg.train_rank.n_epochs = cfg.train_fs2.n_epochs = 1
    cfg.inference.rank_exp = cfg.inference.fs2_exp = "exp_1"
    cfg.inference.output_path = os.path.join(base, "demo")
    cfg.inference.vocoder_checkpoint = os.path.join(
        d.experiment_path, "vocoder", "exp_1", "vocoder.npz")
    return cfg


def _normal(rng, *shape, scale=0.02):
    return torch.from_numpy(rng.standard_normal(shape, dtype=np.float32) * np.float32(scale))


def reference_rank_state_dict(cfg, rng):
    """A rank model's state_dict in the reference's key layout
    (``intensity_extractor.fft_block.layers.N.self_attn`` packed in_proj,
    ``conv1``/``conv2``, ``norm1``/``norm2``; ``projector`` without bias) at
    ``cfg``'s widths, values from ``rng``."""
    rm = cfg.rank_model
    h, ffn, k, n_emo = rm.hidden_dim, rm.hidden_dim * rm.ffn_mult, rm.kernel_size, cfg.n_emotions
    ext = "intensity_extractor"
    sd = {f"{ext}.input_proj.weight": _normal(rng, h, cfg.audio.n_mels + 2),
          f"{ext}.input_proj.bias": _normal(rng, h)}
    for i in range(rm.n_encoder_layers):
        lp = f"{ext}.fft_block.layers.{i}"
        sd.update({
            f"{lp}.self_attn.in_proj_weight": _normal(rng, 3 * h, h),
            f"{lp}.self_attn.in_proj_bias": _normal(rng, 3 * h),
            f"{lp}.self_attn.out_proj.weight": _normal(rng, h, h),
            f"{lp}.self_attn.out_proj.bias": _normal(rng, h),
            f"{lp}.conv1.weight": _normal(rng, ffn, h, k),
            f"{lp}.conv1.bias": _normal(rng, ffn),
            f"{lp}.conv2.weight": _normal(rng, h, ffn, k),
            f"{lp}.conv2.bias": _normal(rng, h)})
        for norm in ("norm1", "norm2"):
            sd[f"{lp}.{norm}.weight"] = 1.0 + _normal(rng, h)
            sd[f"{lp}.{norm}.bias"] = _normal(rng, h)
    sd.update({f"{ext}.emotion_embedding.weight": _normal(rng, n_emo, h),
               f"{ext}.classifier.weight": _normal(rng, n_emo, h),
               f"{ext}.classifier.bias": _normal(rng, n_emo),
               "projector.weight": _normal(rng, 1, n_emo)})
    return sd


def reference_fs2_state_dict(cfg, rng):
    """A FastSpeech2 state_dict in the reference's SpeechBrain key layout
    (``.w`` linears, ``.conv`` convs, ``.Embedding``, ``self_att.att``,
    ``pos_ffn.{0,2}``, ``.norm`` LayerNorms; plain LayerNorms in the
    predictors and the PostNet, ``convs_intermedite``) at ``cfg``'s widths,
    values from ``rng``.  The duration predictor's output bias is log1p(4):
    about four frames a phone, a choice of weights as in seeded_weights."""
    f = cfg.fastspeech2
    sd = {}

    def conv(name, cout, cin, k):
        sd[f"{name}.conv.weight"] = _normal(rng, cout, cin, k)
        sd[f"{name}.conv.bias"] = _normal(rng, cout)

    def norm(name, n):
        sd[f"{name}.weight"] = 1.0 + _normal(rng, n)
        sd[f"{name}.bias"] = _normal(rng, n)

    def stack(prefix, layers, d, ffn):
        for i in range(layers):
            lp = f"{prefix}.layers.{i}"
            sd[f"{lp}.self_att.att.in_proj_weight"] = _normal(rng, 3 * d, d)
            sd[f"{lp}.self_att.att.in_proj_bias"] = _normal(rng, 3 * d)
            sd[f"{lp}.self_att.att.out_proj.weight"] = _normal(rng, d, d)
            sd[f"{lp}.self_att.att.out_proj.bias"] = _normal(rng, d)
            conv(f"{lp}.pos_ffn.0", ffn, d, f.ffn_kernel_sizes[0])
            conv(f"{lp}.pos_ffn.2", d, ffn, f.ffn_kernel_sizes[1])
            norm(f"{lp}.norm1.norm", d)
            norm(f"{lp}.norm2.norm", d)
        norm(f"{prefix}.norm.norm", d)

    d = f.enc_d_model
    sd["encPreNet.token_embedding.Embedding.weight"] = _normal(rng, f.n_char, d, scale=1.0)
    stack("encoder", f.enc_num_layers, d, f.enc_ffn_dim)
    stack("decoder", f.dec_num_layers, f.dec_d_model, f.dec_ffn_dim)
    sd["speaker_emb.Embedding.weight"] = _normal(rng, cfg.n_speakers, d, scale=1.0)
    sd["concat_proj.w.weight"] = _normal(rng, d, 2 * d + cfg.n_emotions, scale=0.05)
    for name, k in (("durPred", f.dur_pred_kernel_size),
                    ("pitchPred", f.pitch_pred_kernel_size),
                    ("energyPred", f.energy_pred_kernel_size)):
        conv(f"{name}.conv1", d, d, k)
        conv(f"{name}.conv2", d, d, k)
        norm(f"{name}.ln1", d)
        norm(f"{name}.ln2", d)
        sd[f"{name}.linear.w.weight"] = _normal(rng, 1, d)
        sd[f"{name}.linear.w.bias"] = _normal(rng, 1)
    sd["durPred.linear.w.bias"].fill_(math.log1p(4.0))
    conv("pitchEmbed", d, 1, f.pitch_pred_kernel_size)
    conv("energyEmbed", d, 1, f.energy_pred_kernel_size)
    sd["linear.w.weight"] = _normal(rng, f.n_mels, f.dec_d_model, scale=0.05)
    sd["linear.w.bias"] = _normal(rng, f.n_mels)
    p, k = f.postnet_embedding_dim, f.postnet_kernel_size
    conv("postnet.conv_pre", p, f.n_mels, k)
    for i in range(f.postnet_n_convolutions - 2):
        conv(f"postnet.convs_intermedite.{i}", p, p, k)
    conv("postnet.conv_post", f.n_mels, p, k)
    norm("postnet.ln1", p)
    norm("postnet.ln2", p)
    norm("postnet.ln3", f.n_mels)
    return sd


def weight_normed_generator(rng, n_mels, ch0, upsample_kernel_sizes,
                            resblock_kernel_sizes, resblock_dilations,
                            v_scale=1.0, g_scale=0.1):
    """A torch HiFi-GAN generator state_dict in the official weight-normed
    layout (``conv_pre``, ``ups.N``, ``resblocks.M.convs{1,2}.D``,
    ``conv_post``, each as ``weight_g``/``weight_v`` and ``bias``) of the
    given structure, values from ``rng``: ``weight_v`` N(0, v_scale²),
    ``weight_g`` 0.5 + |N(0, g_scale²)|, biases N(0, 0.01²).  The port's
    tests build their small generators here too."""
    sd = {}

    def add(name, out_ch, in_ch, k, transpose=False):
        shape = (in_ch, out_ch, k) if transpose else (out_ch, in_ch, k)
        sd[f"{name}.weight_v"] = _normal(rng, *shape, scale=v_scale)
        sd[f"{name}.weight_g"] = 0.5 + _normal(rng, shape[0], 1, 1, scale=g_scale).abs()
        sd[f"{name}.bias"] = _normal(rng, out_ch, scale=0.01)

    ch = ch0
    add("conv_pre", ch, n_mels, 7)
    n_k = len(resblock_kernel_sizes)
    for i, ku in enumerate(upsample_kernel_sizes):
        add(f"ups.{i}", ch // 2, ch, ku, transpose=True)
        ch //= 2
        for j, (k, dils) in enumerate(zip(resblock_kernel_sizes, resblock_dilations)):
            for d in range(len(dils)):
                for conv in ("convs1", "convs2"):
                    add(f"resblocks.{i * n_k + j}.{conv}.{d}", ch, ch, k)
    add("conv_post", 1, ch, 7)
    return sd


def read_pcm(path):
    with wave.open(path, "rb") as w:
        return np.frombuffer(w.readframes(w.getnframes()), "<i2")


def wait_for_line(proc, marker, seconds):
    """The first line of ``proc``'s standard output that holds ``marker``;
    fails if the process ends or the time runs out first."""
    import select

    deadline = time.monotonic() + seconds
    while True:
        if proc.poll() is not None or time.monotonic() > deadline:
            raise AssertionError(f"no {marker!r} line (exit code {proc.poll()})")
        ready, _, _ = select.select([proc.stdout], [], [], 1.0)
        if ready:
            line = proc.stdout.readline()
            if marker in line:
                return line


def cli_serve(cfg_path, dev, log_path):
    """``python -m emotts_torch.cli.main serve --port 0`` as a subprocess:
    the time to its listening line (the kernels built already), /health
    and one POST /synthesize; the process is stopped in every case."""
    here = os.path.dirname(os.path.abspath(__file__))
    with open(log_path, "w") as log:
        t0 = time.perf_counter()
        proc = subprocess.Popen(
            [sys.executable, "-m", "emotts_torch.cli.main", "serve", "--config",
             cfg_path, "--device", dev.type, "--port", "0"],
            cwd=here, stdout=subprocess.PIPE, stderr=log, text=True)
        try:
            line = wait_for_line(proc, "[serve] listening on", 300)
            cold_s = time.perf_counter() - t0
            base = line.split("listening on ")[1].split()[0]
            with urllib.request.urlopen(base + "/health", timeout=60) as r:
                health = json.loads(r.read())
            if health["status"] != "ok" or not health["vocoder"]:
                raise AssertionError(f"serve /health: {health}")
            body, ms = post(base, "/synthesize", {"text": CLI_TEXT, "speaker": "bea",
                                                  "emotion": "amused", "level": 1})
            pcm, sr = wav_samples(body)
            if pcm.size == 0 or np.abs(pcm.astype(np.int32)).max() == 0:
                raise AssertionError("serve: empty or silent audio")
        finally:
            proc.terminate()
            try:
                proc.wait(timeout=30)
            except subprocess.TimeoutExpired:
                proc.kill()
                proc.wait(timeout=30)
    return dict(cold_start_s=cold_s, first_request_ms=ms, samples=int(pcm.size),
                sample_rate=sr, exit_code=proc.returncode)


def cli_phase(root, dev, sweep_wall_ms):
    """The emotts-torch command over phase 15's raw corpus at Config()
    widths: the training chain and the serving and evaluation commands in
    process through ``main([...])`` (each with the counters set to 0 just
    before it and read just after, against the launches its forwards make),
    the importers on full-width reference checkpoints made from SEED, then
    ``serve`` and ``g2p`` as subprocesses.  Returns the path's launches,
    its fp32 attention launches and the report."""
    import contextlib

    import emotts_torch.data.preprocess as prep
    from emotts_torch.cli.main import main as cli
    from emotts_torch.infer.synthesize import Synthesizer
    from emotts_torch.nn.fastspeech2 import FastSpeech2
    from emotts_torch.nn.hifigan import HiFiGANGenerator
    from emotts_torch.nn.intensity import IntensityExtractor
    from emotts_torch.ops import attention, mrf, resblock
    from emotts_torch.utils.config import save_config
    from emotts_torch.utils.plotting import have_matplotlib

    t_phase = time.perf_counter()
    cfg = cli_config(root)
    base = os.path.dirname(cfg.data.corpus_path)
    os.makedirs(base, exist_ok=True)
    cfg_path = os.path.join(base, "cli.yaml")
    save_config(cfg, cfg_path)
    with open(os.path.join(base, "story.txt"), "w") as f:
        f.write(CLI_TEXT)
    exp = cfg.data.experiment_path
    rank_exp = os.path.join(exp, "rank_model", "exp_1")
    fs2_exp = os.path.join(exp, "fastspeech2", "exp_1")
    demo = cfg.inference.output_path
    common = ["--config", cfg_path, "--device", dev.type]
    longform = ["--text-file", os.path.join(base, "story.txt"), "--speaker", "josh",
                "--emotion", "angry", "--level", "1.5"]
    imported = ["inference.rank_exp=imported", "inference.fs2_exp=imported",
                "fastspeech2.prenet_style=embedding",
                "fastspeech2.postnet_style=speechbrain"]
    plot_rc = 0 if have_matplotlib() else 2
    f2 = cfg.fastspeech2
    layers = dict(fs2=f2.enc_num_layers + f2.dec_num_layers,
                  extractor=cfg.rank_model.n_encoder_layers)
    totals = dict.fromkeys(KERNELS, 0)
    fp32 = dict(fused_attention=0, fused_attention_bwd=0)
    commands = []
    sweep_ms = []
    inner_sweep = Synthesizer.intensity_sweep

    def timed_sweep(self, *args, **kwargs):
        t = time.perf_counter()
        out = inner_sweep(self, *args, **kwargs)
        if dev.type == "cuda":
            torch.cuda.synchronize()
        sweep_ms.append(1e3 * (time.perf_counter() - t))
        return out

    def run(name, argv, want_rc=0):
        """One command in process, its launches against those its forwards
        make: the attention forward a layer per FastSpeech2 and extractor
        forward, the backward BWD_LAUNCHES_PER_CALL a layer per training
        forward, MRF and ResBlock by ``vocoder_launches`` per generator
        forward (a plain generator's come to 0); the fp32 ones apart."""
        zero_counts(attention, mrf, resblock)
        counters = dict(fs2=ModuleCounter(FastSpeech2),
                        extractor=ModuleCounter(IntensityExtractor))
        generator = ModuleCounter(HiFiGANGenerator, launches=vocoder_launches)
        out = io.StringIO()
        t0 = time.perf_counter()
        try:
            with contextlib.redirect_stdout(out):
                rc = cli(argv)
        finally:
            for c in (*counters.values(), generator):
                c.close()
        if dev.type == "cuda":
            torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        counted = dict(fused_attention=attention.launch_count,
                       fused_attention_bwd=attention.bwd_launch_count,
                       fused_mrf_stage=mrf.launch_count,
                       fused_resblock1=resblock.launch_count)
        expected = dict(
            fused_attention=sum(layers[n] * c.forwards for n, c in counters.items()),
            fused_attention_bwd=attention.BWD_LAUNCHES_PER_CALL * sum(
                layers[n] * c.training_forwards for n, c in counters.items()),
            fused_mrf_stage=sum(m for m, _ in generator.launched),
            fused_resblock1=sum(r for _, r in generator.launched))
        fp32_here = dict(counted=fp32_attention_launches(),
                         expected=expected_fp32_launches(counters, layers))
        for k, v in fp32_here["counted"].items():
            fp32[k] += v
        for k in KERNELS:
            totals[k] += counted[k]
        lines = out.getvalue().strip().splitlines()
        commands.append(dict(name=name, argv=argv[0], rc=rc, seconds=seconds,
                             launches=counted, expected=expected, fp32=fp32_here,
                             last_line=lines[-1] if lines else ""))
        if rc != want_rc:
            raise AssertionError(f"cli {name}: exit code {rc}, expected {want_rc}; "
                                 f"output: {out.getvalue()[-2000:]}")
        if dev.type == "cuda" and (counted != expected
                                   or fp32_here["counted"] != fp32_here["expected"]):
            raise AssertionError(f"cli {name}: launches {counted}, expected {expected}; "
                                 f"fp32 {fp32_here}")

    # the training chain
    rng = np.random.default_rng(SEED)
    mel_devices = []  # preprocess's mel batches, by device
    inner_mel = prep._device_mel_batch

    def device_mel_batch(cfg_, extracted, device):
        mel_devices.append(device.type)
        return inner_mel(cfg_, extracted, device)

    run("prepare-corpus", ["prepare-corpus", *common])
    prep._device_mel_batch = device_mel_batch
    try:
        run("preprocess", ["preprocess", *common])
    finally:
        prep._device_mel_batch = inner_mel
    if dev.type == "cuda" and (not mel_devices or set(mel_devices) != {"cuda"}):
        raise AssertionError(f"preprocess without data.device_mel took the mel on "
                             f"{sorted(set(mel_devices))}, not on the card")
    run("fs2-splits", ["fs2-splits", *common])
    run("train-rank", ["train-rank", *common, "train_rank.max_iterations=8",
                       "train_rank.profile_epoch=0"])
    run("bucketize", ["bucketize", *common])
    run("train-vocoder", ["train-vocoder", *common, "train_vocoder.n_steps=5"])
    run("train-fs2", ["train-fs2", *common, "train_fs2.max_iterations=5"])
    # serving and evaluation
    Synthesizer.intensity_sweep = timed_sweep
    try:
        run("synthesize", ["synthesize", *common])
    finally:
        Synthesizer.intensity_sweep = inner_sweep
    run("synthesize --stream", ["synthesize", *common, *longform, "--stream"])
    # the intensity sweeps on a short sentence: one epoch of FS2 training
    # leaves its durations long, and the sweep's F0 runs on the host
    run("evaluate", ["evaluate", *common, "--conditioning", "prototype",
                     f"inference.text={SWEEP_TEXT}"])
    run("eval-intensity", ["eval-intensity", *common, "--text", SWEEP_TEXT])
    run("eval-intensity --plot", ["eval-intensity", *common, "--text", SWEEP_TEXT,
                                  "--plot", os.path.join(base, "sweep.png")], plot_rc)
    # the importers at full width, then synthesis from what they wrote
    files = {name: os.path.join(base, name) for name in (
        "rank_best.pth", "fs2_best.pth", "intensity.npy", "generator_v1.pt",
        "generator_v1.npz")}
    torch.save(reference_rank_state_dict(cfg, rng), files["rank_best.pth"])
    torch.save(reference_fs2_state_dict(cfg, rng), files["fs2_best.pth"])
    np.save(files["intensity.npy"], rng.standard_normal(
        (cfg.n_speakers, cfg.n_emotions, cfg.inference.bucket_size,
         cfg.n_emotions)).astype(np.float32))
    v = cfg.train_vocoder
    torch.save(weight_normed_generator(
        rng, cfg.audio.n_mels, v.upsample_initial_channel, v.upsample_kernel_sizes,
        v.resblock_kernel_sizes, v.resblock_dilations), files["generator_v1.pt"])
    run("import-reference", ["import-reference", *common, *imported,
                             "--rank-checkpoint", files["rank_best.pth"],
                             "--fs2-checkpoint", files["fs2_best.pth"],
                             "--intensity", files["intensity.npy"]])
    run("convert-vocoder", ["convert-vocoder", *common, "--checkpoint",
                            files["generator_v1.pt"], "--output",
                            files["generator_v1.npz"]])
    wavs = {}
    for ext in (".pt", ".npz"):
        out = os.path.join(base, f"imported{ext.replace('.', '_')}")
        run(f"synthesize --text-file (imported, {ext})",
            ["synthesize", *common, *longform, *imported,
             f"inference.vocoder_checkpoint={files['generator_v1' + ext]}",
             f"inference.output_path={out}"])
        wavs[ext] = read_pcm(os.path.join(out, "longform_josh_angry_1.5.wav"))

    # what the commands wrote
    trace_path = os.path.join(rank_exp, "profile", "trace.json")
    with open(trace_path) as f:
        trace = f.read()
    kernel_names = sorted({n for n in ("attention_fwd_", "attention_bwd_") if n in trace})
    if dev.type == "cuda" and len(kernel_names) != 2:
        raise AssertionError(f"the train-rank profile names {kernel_names} of the "
                             "attention kernels")
    for path in (os.path.join(rank_exp, "best"), os.path.join(rank_exp, "intensity.npy"),
                 os.path.join(fs2_exp, "best"), cfg.inference.vocoder_checkpoint):
        if not os.path.exists(path):
            raise AssertionError(f"cli: {path} was not written")
    n_sweep = cfg.n_speakers * cfg.n_emotions * cfg.inference.bucket_size
    sweep_wavs = glob.glob(os.path.join(demo, "*.wav"))
    # the sweep's files and the streamed long-form file
    if len(sweep_wavs) != n_sweep + 1:
        raise AssertionError(f"cli synthesize wrote {len(sweep_wavs)} wavs, "
                             f"expected {n_sweep} and the long-form one")
    with open(os.path.join(fs2_exp, "eval.json")) as f:
        report = json.load(f)
    _finite_report(report, "cli eval.json")
    if "intensity_efficacy" not in report or report["n_utterances"] == 0:
        raise AssertionError("cli eval.json lacks its rows or the intensity report")
    pt, npz = wavs[".pt"], wavs[".npz"]
    if pt.size == 0 or np.abs(pt.astype(np.int32)).max() == 0:
        raise AssertionError("the imported models synthesized empty or silent audio")
    if pt.shape != npz.shape or not np.array_equal(pt, npz):
        raise AssertionError("the .pt vocoder does not serve as its .npz bit for bit")

    # two subprocesses
    serve = cli_serve(cfg_path, dev, os.path.join(base, "serve.log"))
    t0 = time.perf_counter()
    g2p = subprocess.run(
        [sys.executable, "-m", "emotts_torch.cli.main", "g2p", "--config", cfg_path,
         "--text", CLI_TEXT], cwd=os.path.dirname(os.path.abspath(__file__)),
        capture_output=True, text=True, timeout=300)
    g2p_s = time.perf_counter() - t0
    if g2p.returncode != 0 or not g2p.stdout.strip().splitlines()[-1].startswith("[g2p] "):
        raise AssertionError(f"g2p: exit code {g2p.returncode}: {g2p.stderr[-2000:]}")

    if dev.type == "cuda" and min(totals.values()) == 0:
        raise AssertionError(f"the cli path launched a kernel no time: {totals}")
    return totals, fp32, dict(
        seconds=time.perf_counter() - t_phase, commands=commands,
        sweep=dict(utterances=n_sweep, intensity_sweep_ms=sweep_ms[0],
                   command_s=next(c["seconds"] for c in commands
                                  if c["name"] == "synthesize"),
                   phase_5_sweep_ms=sweep_wall_ms),
        preprocess=dict(device_mel_batches=len(mel_devices)),
        profile=dict(trace_bytes=len(trace), attention_kernels_named=kernel_names),
        imported=dict(samples=int(pt.size), pt_equals_npz=True),
        eval_intensity_plot=dict(have_matplotlib=plot_rc == 0, exit_code=plot_rc),
        serve=serve, g2p=dict(seconds=g2p_s, last_line=g2p.stdout.strip().splitlines()[-1]),
        launches=totals, fp32_launches=fp32)


# --------------------------------------------------------------------------
# phase 22: data parallelism (emotts_torch/parallel) on the one card
# --------------------------------------------------------------------------

DP_STEPS = 3  # steps of each trainer in the two-process run
DP_LOSS_RTOL = 1e-6  # fp32, world size 1: the DP path against the plain step
DP_TWO_RTOL = 1e-5  # two processes against one on the global batch
DP_GRAD_RTOL = 1e-4  # of each gradient's largest entry
# FastSpeech2 gates with ReLUs: a forward that differs at the rounding level
# (the batch split changes cuBLAS's and cuDNN's sums) can flip a gate at a
# value near zero and move a gradient sum by one or more of its terms, as in
# phase 13 (2.3e-3 to 3.3e-2 of the largest entry); the rank model's GELU
# does not
DP_GRAD_RTOL_RELU = 5e-2


def digest(model):
    """sha1 of a model's state (parameters and buffers), for bit-identity."""
    import hashlib

    h = hashlib.sha1()
    for name, t in sorted(model.state_dict().items()):
        h.update(name.encode())
        h.update(t.detach().cpu().contiguous().reshape(-1).view(torch.uint8).numpy().tobytes())
    return h.hexdigest()


def wall_ms(trainer, batch, steps=2):
    """The mean wall ms of ``steps`` synchronised train steps."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(steps):
        trainer.train_step(batch)
    torch.cuda.synchronize()
    return 1e3 * (time.perf_counter() - t0) / steps


def step_reading(trainer, batch):
    """One train step under the profiler: device ms, kernel launches, the
    NCCL kernels among them, the attention backward's kernels' device ms, the
    memory the step allocates above what was allocated before it, and the
    step's metrics."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        metrics = trainer.train_step(batch)
        torch.cuda.synchronize()
    kernels = [e for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA and not e.key.startswith("Optimizer.")]
    return dict(device_ms=sum(e.self_device_time_total for e in kernels) / 1e3,
                launches=sum(e.count for e in kernels),
                nccl_launches=sum(e.count for e in kernels if "nccl" in e.key.lower()),
                attention_bwd_device_ms=sum(e.self_device_time_total for e in kernels
                                            if "attention_bwd_" in e.key) / 1e3,
                step_peak_bytes=torch.cuda.max_memory_allocated() - base, metrics=metrics)


def dp_batch(name, trainer, root):
    """The batch of phase 22 (a) for trainer ``name``: the rank model's
    first batch at its largest frame bucket, FS2's at bucket 1024, the
    vocoder's 16 segments of the raw corpus."""
    from emotts_torch.train.vocoder_trainer import SegmentSampler

    if name == "vocoder":
        cfg = trainer.cfg
        wavs = sorted(glob.glob(os.path.join(cfg.data.corpus_path, "*", "*.wav")))
        return {"y": SegmentSampler(wavs, cfg.audio.sampling_rate, trainer.segment_samples,
                                    seed=SEED).batch(cfg.train_vocoder.batch_size)}
    first, _ = first_batch_by_bucket(trainer._loader("train", shuffle=True))
    return first[max(first)]


def dp_trainer_makers(root, rank_exp, dtype, dev):
    """(name, loss key, build(mesh)) of the three trainers at full width in
    ``dtype``."""
    from emotts_torch.train.rank_trainer import RankTrainer
    from emotts_torch.train.vocoder_trainer import VocoderTrainer

    rank_cfg, fs2_cfg = rank_config(root, dtype), fs2_config(root, dtype)
    voc_cfg = vocoder_config(root, compute_dtype=dtype)
    return [
        ("rank", "loss", lambda mesh: RankTrainer(rank_cfg, device=dev, mesh=mesh)),
        ("fs2", "total_loss", lambda mesh: fs2_trainer(fs2_cfg, rank_exp, dev, mesh)),
        ("vocoder", "g_total", lambda mesh: VocoderTrainer(voc_cfg, device=dev, mesh=mesh)),
    ]


def dp_nccl_phase(root, rank_exp, dev):
    """(a) The three train steps under the DP path in this process, NCCL at
    world size 1 (DDP for the rank and FS2 trainers, the explicit gradient
    all-reduce for the GAN step, the loss and BatchNorm sums all-reduced),
    against the same step with no process group, both built from the same
    seed: first-step losses at fp32 within DP_LOSS_RTOL, bf16 recorded, and
    one profiled fp32 rank step without a process group (device ms, the
    attention backward's kernels' share); in bf16 the wall of two steps read
    in turns (plain, DP, DP, plain), then one profiled step each: device ms,
    launches, idle share, the memory each holds after its first step and the
    step's peak above it."""
    import torch.distributed as dist

    from emotts_torch.parallel.mesh import Mesh

    torch.cuda.set_device(dev)
    dist.init_process_group("nccl", init_method=f"file://{root}/nccl_store_{time.time_ns()}",
                            world_size=1, rank=0)
    plain = Mesh(1, (dev,))
    out, batches = {}, {}
    try:
        for dtype in ("float32", "bfloat16"):
            for name, key, build in dp_trainer_makers(root, rank_exp, dtype, dev):
                trainers, runs = {}, {}
                for path, mesh in (("plain", plain), ("dp", None)):
                    torch.cuda.empty_cache()
                    before = torch.cuda.memory_allocated()
                    trainers[path] = build(mesh)
                    if name not in batches:
                        batches[name] = dp_batch(name, trainers[path], root)
                    runs[path] = dict(first_step=trainers[path].train_step(batches[name]))
                    runs[path]["held_bytes"] = torch.cuda.memory_allocated() - before
                if not trainers["dp"].mesh.distributed or trainers["plain"].mesh.distributed:
                    raise AssertionError(f"(a) {name}: the two paths' meshes are wrong")
                a, b = runs["dp"]["first_step"][key], runs["plain"]["first_step"][key]
                rel = abs(a - b) / abs(b)
                res = dict(dtype=dtype, loss_key=key, loss_rel_difference=rel)
                if dtype == "float32":
                    res["loss_rtol"] = DP_LOSS_RTOL
                    if not np.isfinite(a) or rel > DP_LOSS_RTOL:
                        raise AssertionError(f"(a) {name} fp32: DP loss {a} against {b}")
                    if name == "rank":  # the fp32 attention backward's share of a step
                        reading = step_reading(trainers["plain"], batches[name])
                        reading.pop("metrics")
                        res["plain_step"] = reading
                else:
                    walls = {"plain": [], "dp": []}
                    for path in ("plain", "dp", "dp", "plain"):
                        walls[path].append(wall_ms(trainers[path], batches[name]))
                    for path in runs:
                        runs[path].update(step_reading(trainers[path], batches[name]),
                                          wall_ms=sum(walls[path]) / 2)
                        runs[path]["idle_share"] = max(
                            0.0, 1.0 - runs[path]["device_ms"] / runs[path]["wall_ms"])
                    res.update(
                        extra_launches=runs["dp"]["launches"] - runs["plain"]["launches"],
                        extra_held_bytes=runs["dp"]["held_bytes"] - runs["plain"]["held_bytes"],
                        extra_step_peak_bytes=(runs["dp"]["step_peak_bytes"]
                                               - runs["plain"]["step_peak_bytes"]))
                res.update(dp=runs["dp"], plain=runs["plain"])
                out[f"{name}_{dtype}"] = res
                del trainers
    finally:
        dist.destroy_process_group()
    return out


# the gate inputs of FastSpeech2's ReLUs: the prenet's norms, the variance
# predictors' convs, the FFT blocks' first FFN conv
RELU_GATES = ("prenet.norms.", "predictor.conv1", "predictor.conv2", "ffn.conv1")


def gate_recorder(model, rows, seen=None, part=0):
    """Forward hooks on the modules whose output a ReLU gates: each output's
    first ``rows`` rows are kept (``seen`` empty) or compared with the kept
    ones (``seen`` given: the count of entries on the other side of zero
    goes into ``seen['flips']``).  Where ``model``'s layer is a
    tensor-parallel shard, its output is compared with slice ``part`` of the
    kept channels.  Returns the hooks' handles."""
    kept = {} if seen is None else seen

    def hook(name):
        def record(module, args, out):
            out = out.detach()[:rows].float()
            if seen is None:
                kept[name] = out
            else:
                ref = kept[name]
                n = out.shape[-1]
                if ref.shape[-1] != n:
                    ref = ref[..., part * n:(part + 1) * n]
                kept["flips"] = kept.get("flips", 0) + int(((out > 0) != (ref > 0)).sum())
        return record

    handles = [m.register_forward_hook(hook(n)) for n, m in model.named_modules()
               if any(g in n for g in RELU_GATES) and not list(m.children())]
    return kept, handles


def dp_gloo_worker(argv):
    """(b) One of two processes on the one card over ``gloo``: DP_STEPS fp32
    steps of the rank and FS2 trainers at full width on its rows of the
    global batches; the parameters' digests after every step are gathered.
    Before each step rank 0 copies the state into a trainer with no process
    group and takes that step on the global batch: the losses within
    DP_TWO_RTOL, the step-1 gradients within DP_GRAD_RTOL of each one's
    largest entry (FastSpeech2's within DP_GRAD_RTOL_RELU), the parameters
    bit-identical across the ranks.  Writes rank 0's report to ``out``."""
    import torch.distributed as dist

    from emotts_torch.parallel.mesh import Mesh
    from emotts_torch.train.rank_trainer import RankTrainer

    store, rank, root, rank_exp, out_path, dev = argv
    rank, dev = int(rank), torch.device(dev)
    torch.cuda.set_device(dev)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dist.init_process_group("gloo", init_method=store, world_size=2, rank=rank)
    report = {}
    try:
        jobs = (("rank", "loss", DP_GRAD_RTOL, lambda mesh: RankTrainer(
                    rank_config(root, "float32"), device=dev, mesh=mesh)),
                ("fs2", "total_loss", DP_GRAD_RTOL_RELU, lambda mesh: fs2_trainer(
                    fs2_config(root, "float32"), rank_exp, dev, mesh)))
        for name, key, grad_rtol, build in jobs:
            trainer = build(None)
            local = iter(trainer._loader("train", shuffle=True).epoch(0))
            if rank == 0:
                one = build(Mesh(1, (dev,)))
                whole = iter(one._loader("train", shuffle=True).epoch(0))
            losses, one_losses, digests, step_ms = [], [], [], []
            gates = None
            for i in range(DP_STEPS):
                batch = next(local)
                rows = len(batch["row_valid"])
                if rank == 0:  # the same step from the same state, one process
                    one.state.load_state_dict(copy.deepcopy(trainer.state.state_dict()))
                    if i == 0 and name == "fs2":
                        # rank 0's rows lead the global batch
                        gates, handles = gate_recorder(one.model, rows)
                    one_losses.append(one.train_step(next(whole)))
                    if i == 0:
                        ref = {n: p.grad.detach().clone()
                               for n, p in one.model.named_parameters()}
                    if gates is not None and i == 0:
                        for h in handles:
                            h.remove()
                        _, handles = gate_recorder(trainer.model, rows, gates)
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                losses.append(trainer.train_step(batch))
                torch.cuda.synchronize()
                if gates is not None and i == 0:
                    for h in handles:
                        h.remove()
                step_ms.append(1e3 * (time.perf_counter() - t0))
                digests.append(digest(trainer.model))
                if i == 0:
                    grads = {n: p.grad.detach().clone()
                             for n, p in trainer.model.named_parameters()}
            everyone = [None, None]
            dist.all_gather_object(everyone, (digests, losses))
            if rank == 0:
                ratios = _gradient_ratios(grads, ref)
                worst = sorted(ratios, key=ratios.get, reverse=True)
                rel = max(abs(a[key] - b[key]) / abs(b[key])
                          for a, b in zip(losses, one_losses))
                same = everyone[0][0] == everyone[1][0]
                report[name] = dict(
                    rows_per_rank=rows, step_ms=step_ms,
                    losses_two=[m[key] for m in losses],
                    losses_one=[m[key] for m in one_losses],
                    ranks_equal_losses=everyone[0][1] == everyone[1][1],
                    parameters_bit_identical=same, loss_rel_difference=rel,
                    loss_rtol=DP_TWO_RTOL, worst_gradient_difference=ratios[worst[0]],
                    worst_gradients=[[n, ratios[n]] for n in worst[:8]],
                    parameters=len(ratios),
                    parameters_over_strict_rtol=sum(r > DP_GRAD_RTOL for r in ratios.values()),
                    gradient_rtol_of_largest_entry=grad_rtol,
                    relu_gate_flips_rank0_rows=None if gates is None else gates.get("flips", 0))
                del one, ref, gates
                if not same or not report[name]["ranks_equal_losses"] \
                        or rel > DP_TWO_RTOL or ratios[worst[0]] > grad_rtol:
                    raise AssertionError(f"(b) {name}: {report[name]}")
            del trainer, grads
            torch.cuda.empty_cache()
            dist.barrier()
        if rank == 0:
            with open(out_path, "w") as f:
                json.dump(report, f)
    finally:
        dist.destroy_process_group()
    return 0


def dp_gloo_phase(root, rank_exp, dev):
    """(b) Two processes of this script on the one card over ``gloo``
    (NCCL takes no two ranks on one device); the kernels are the parent's
    build."""
    store = f"file://{root}/gloo_store_{time.time_ns()}"  # a new file store
    out = os.path.join(root, "dp_gloo.json")
    env = dict(os.environ, PYTHONPATH=os.path.dirname(os.path.abspath(__file__)))
    procs = [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), "--dp-worker", store, str(rank),
         root, rank_exp, out, str(dev)], env=env, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True) for rank in range(2)]
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=300)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for rank, p in enumerate(procs):
        if p.returncode != 0:
            raise AssertionError(f"(b) rank {rank} exited {p.returncode}:\n{logs[rank][-4000:]}")
    with open(out) as f:
        return json.load(f)


def dp_serving_phase(root, rank_exp, weights, dev):
    """(c) A Synthesizer over a two-entry mesh on this card (fp32, every
    kernel) against the unsharded one: the 60-utterance sweep within one PCM
    step, its launches against the replicas' forwards; bucketize over the
    same mesh writes the unsharded bank."""
    import shutil

    from emotts_torch.infer.bucketize import bucketize, compute_intensity_prototypes
    from emotts_torch.infer.synthesize import Synthesizer
    from emotts_torch.ops import attention, mrf, resblock
    from emotts_torch.parallel.mesh import Mesh
    from emotts_torch.train.checkpoint import load_best_params

    mesh = Mesh(2, (dev, dev))
    cfg = full_width_config("float32")
    synths = {name: Synthesizer(cfg, weights[0], weights[1], weights[2],
                                vocoder_structure=vocoder_structure(cfg), device=dev,
                                mesh=m)
              for name, m in (("one", None), ("two", mesh))}
    if len(synths["two"]._replicas) != 2:
        raise AssertionError("the sharded Synthesizer has no second replica")
    sweeps, out = {}, {}
    for name, synth in synths.items():
        zero_counts(attention, mrf, resblock)
        counters = [ForwardCounter(types.SimpleNamespace(model=m, vocoder=v))
                    for m, v in synth._replicas]
        sweeps[name] = sweep_phase(cfg, synth)  # one warm sweep, one timed
        sweeps[name]["wavs"] = synth.intensity_sweep(cfg.inference.text)
        fs2 = sum(c.fs2 for c in counters)
        voc = sum(c.vocoder for c in counters)
        for c in counters:
            c.close()
        n_mrf, n_resblock, _ = launches_by_forward([n for c in counters for n in c.launched])
        f2 = cfg.fastspeech2
        counted = dict(fused_attention=attention.launch_count,
                       fused_mrf_stage=mrf.launch_count,
                       fused_resblock1=resblock.launch_count)
        expected = dict(fused_attention=(f2.enc_num_layers + f2.dec_num_layers) * fs2,
                        fused_mrf_stage=n_mrf, fused_resblock1=n_resblock)
        if counted != expected or min(counted.values()) == 0:
            raise AssertionError(f"(c) {name}: launches {counted}, expected {expected}")
        out[name] = dict(wall_ms=sweeps[name]["wall_ms"], fs2_forwards=fs2,
                         generator_forwards=voc, launches=counted)
    one, two = sweeps["one"]["wavs"], sweeps["two"]["wavs"]
    worst = 0
    for key, wav in one.items():
        a = np.round(np.asarray(two[key], np.float64) * 32767.0)
        b = np.round(np.asarray(wav, np.float64) * 32767.0)
        if a.shape != b.shape:
            raise AssertionError(f"(c) {key}: {a.shape} samples sharded, {b.shape} not")
        worst = max(worst, int(np.abs(a - b).max()))
    out["sweep_worst_pcm_steps"] = worst
    if worst > 1:
        raise AssertionError(f"(c) sharded sweep {worst} PCM steps from the unsharded")
    del synths
    torch.cuda.empty_cache()

    rank_cfg = rank_config(root)
    params = load_best_params(rank_exp)
    t0 = time.perf_counter()
    want = compute_intensity_prototypes(rank_cfg, params, device=dev)
    t1 = time.perf_counter()
    copy_exp = os.path.join(root, "dp_bucketize")
    shutil.copytree(os.path.join(rank_exp, "best"), os.path.join(copy_exp, "best"))
    written = np.load(bucketize(rank_cfg, copy_exp, device=dev, mesh=mesh))
    t2 = time.perf_counter()
    diff = float(np.abs(written - want).max())
    out["bucketize"] = dict(unsharded_s=t1 - t0, sharded_s=t2 - t1,
                            max_abs_difference=diff, scale=float(np.abs(want).max()))
    if written.shape != want.shape or not np.allclose(written, want, rtol=1e-5, atol=1e-6):
        raise AssertionError(f"(c) the sharded bank differs by {diff}")
    return out


def dp_launcher_phase(root):
    """(d) ``train-rank`` through ``torch.distributed.run --nproc-per-node
    1`` (NCCL): one short epoch at full width; one experiment directory."""
    from emotts_torch.utils.config import save_config

    cfg = rank_config(root)
    cfg.data.experiment_path = os.path.join(root, "dp_cli", "experiments")
    cfg.train_rank.n_epochs = 1
    cfg.train_rank.max_iterations = 4
    path = os.path.join(root, "dp_cli.yaml")
    save_config(cfg, path)
    here = os.path.dirname(os.path.abspath(__file__))
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         "--nproc-per-node", "1", "-m", "emotts_torch.cli.main", "train-rank",
         "--config", path],
        cwd=here, env=dict(os.environ, PYTHONPATH=here), capture_output=True,
        text=True, timeout=300)
    seconds = time.perf_counter() - t0
    if proc.returncode != 0:
        raise AssertionError(f"(d) exit {proc.returncode}:\n{proc.stdout[-3000:]}\n"
                             f"{proc.stderr[-3000:]}")
    runs = os.path.join(cfg.data.experiment_path, "rank_model")
    exps = sorted(os.listdir(runs))
    exp = os.path.join(runs, "exp_1")
    announced = [ln for ln in proc.stdout.splitlines()
                 if ln.startswith("[train-rank] experiment:")]
    if exps != ["exp_1"] or not os.path.exists(os.path.join(exp, "best", "params.pt")) \
            or len(announced) != 1:
        raise AssertionError(f"(d) experiments {exps}, announced {announced}")
    return dict(seconds=seconds, experiments=exps,
                train_loss_epochs=len(read_metrics(exp).get("train/loss", [])))


def dp_phase(root, rank_exp, weights, dev):
    """Phase 22: (a)-(d), the in-process parts' kernel launches counted from
    0; returns them and the phase's report."""
    from emotts_torch.ops import attention, mrf, resblock

    t0 = time.perf_counter()
    zero_counts(attention, mrf, resblock)
    nccl = dp_nccl_phase(root, rank_exp, dev)
    trained = dict(fused_attention=attention.launch_count,
                   fused_attention_bwd=attention.bwd_launch_count)
    fp32 = fp32_attention_launches()
    t1 = time.perf_counter()
    gloo = dp_gloo_phase(root, rank_exp, dev)
    t2 = time.perf_counter()
    serving = dp_serving_phase(root, rank_exp, weights, dev)
    t3 = time.perf_counter()
    launched = dp_launcher_phase(root)
    launches = dict(trained, fused_mrf_stage=serving["two"]["launches"]["fused_mrf_stage"],
                    fused_resblock1=serving["two"]["launches"]["fused_resblock1"])
    launches["fused_attention"] += serving["two"]["launches"]["fused_attention"]
    if min(launches.values()) == 0:
        raise AssertionError(f"data_parallel: a kernel was not launched: {launches}")
    return launches, dict(
        seconds=time.perf_counter() - t0,
        part_seconds=dict(a=t1 - t0, b=t2 - t1, c=t3 - t2, d=time.perf_counter() - t3),
        nccl_world_size_1=nccl, gloo_two_processes=gloo, sharded_serving=serving,
        launcher=launched, launches=launches, fp32_launches=fp32)


TP_STEPS = 3  # fp32 steps of each trainer on the 1 x 2 grid
REMAT_GRAD_RTOL = 1e-6  # of each gradient's largest entry, remat against none


def _replicated_digests(model):
    """sha1 of each entry of a model's state that no rank shards."""
    import hashlib

    from emotts_torch.parallel.tp import shard_dim

    return {n: hashlib.sha1(t.detach().cpu().contiguous().reshape(-1).view(torch.uint8)
                            .numpy().tobytes()).hexdigest()
            for n, t in model.state_dict().items() if shard_dim(n) is None}


def _tp_jobs(root, rank_exp, dev):
    """(name, loss key, gradient tolerance, build(mesh_model, mesh), FFT
    blocks) of phase 23's trainers at full width, fp32."""
    from emotts_torch.train.rank_trainer import RankTrainer

    def config(make, model):
        cfg = make(root, "float32")
        cfg.mesh.model_parallel = model
        return cfg

    rank_blocks = rank_config(root).rank_model.n_encoder_layers
    f2 = fs2_config(root).fastspeech2
    return (("rank", "loss", DP_GRAD_RTOL, rank_blocks,
             lambda model, mesh: RankTrainer(config(rank_config, model), device=dev, mesh=mesh)),
            ("fs2", "total_loss", DP_GRAD_RTOL_RELU, f2.enc_num_layers + f2.dec_num_layers,
             lambda model, mesh: fs2_trainer(config(fs2_config, model), rank_exp, dev, mesh)))


def tp_gloo_worker(argv):
    """(a) One of two processes on the one card over ``gloo`` forming a 1 x 2
    grid (``mesh.model_parallel=2``): each holds 1 of the 2 heads of 192 and
    768 of the 1536 FFN channels of every FFT block.  TP_STEPS fp32 steps of
    the rank trainer (its largest frame bucket) and of the FS2 trainer
    (bucket 1024).  Before each step rank 0 loads the grid's full state
    (gathered over the model group) into a trainer with no process group and
    takes the same step on the same batch: losses within DP_TWO_RTOL, step-1
    gradients within DP_GRAD_RTOL of each one's largest entry
    (FastSpeech2's within DP_GRAD_RTOL_RELU, its flipped ReLU gates
    counted), the replicated parameters and buffers bit-identical across
    the ranks after every step (their gradients are averaged over the
    model group: the FS2 step's backward adds with atomics on the card, so
    two ranks' gradients differ in their last bits).  Each rank writes its report to ``out.<rank>``: step
    walls, the last step's profiler reading, and per step the attention
    launches and the model axis's all-reduces and the bytes they reduce."""
    import torch.distributed as dist

    from emotts_torch.ops import attention
    from emotts_torch.parallel import tp
    from emotts_torch.parallel.mesh import Mesh

    store, rank, root, rank_exp, out_path, dev = argv
    rank, dev = int(rank), torch.device(dev)
    torch.cuda.set_device(dev)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dist.init_process_group("gloo", init_method=store, world_size=2, rank=rank)
    report = {}
    try:
        for name, key, grad_rtol, blocks, build in _tp_jobs(root, rank_exp, dev):
            trainer = build(2, None)
            mesh = trainer.mesh
            if (mesh.data, mesh.model, mesh.model_rank) != (1, 2, rank):
                raise AssertionError(f"(a) {name}: grid {mesh}")
            heads = trainer.model.modules()
            local_heads = {m.n_heads // m.model_axis.size for m in heads
                           if getattr(m, "model_axis", None) is not None and hasattr(m, "n_heads")}
            batch = dp_batch(name, trainer, root)
            rows = len(batch["row_valid"])
            one = build(1, Mesh(1, (dev,))) if rank == 0 else None
            res = dict(rows=rows, local_heads=sorted(local_heads), step_ms=[], losses=[],
                       one_losses=[], replicated_bit_identical=[], launches=[],
                       all_reduces=[], all_reduce_bytes=[])
            gates = None
            for i in range(TP_STEPS):
                full = trainer.state.state_dict()  # gathered: every rank calls it
                if rank == 0:
                    one.state.load_state_dict(copy.deepcopy(full))
                    if i == 0 and name == "fs2":
                        gates, handles = gate_recorder(one.model, rows)
                    res["one_losses"].append(one.train_step(batch)[key])
                    if i == 0:
                        ref = {n: p.grad.detach().clone() for n, p in one.model.named_parameters()}
                        if gates is not None:
                            for h in handles:
                                h.remove()
                del full
                if gates is not None and i == 0:
                    _, handles = gate_recorder(trainer.model, rows, gates, part=rank)
                zero_counts(attention)
                tp.all_reduce_count = tp.all_reduce_bytes = 0
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                if i == TP_STEPS - 1:  # the last step under the profiler
                    reading = step_reading(trainer, batch)
                    loss = reading.pop("metrics")[key]
                else:
                    loss = trainer.train_step(batch)[key]
                torch.cuda.synchronize()
                res["step_ms"].append(1e3 * (time.perf_counter() - t0))
                res["losses"].append(loss)
                res["launches"].append(dict(fused_attention=attention.launch_count,
                                            fused_attention_bwd=attention.bwd_launch_count))
                res["all_reduces"].append(tp.all_reduce_count)
                res["all_reduce_bytes"].append(tp.all_reduce_bytes)
                if gates is not None and i == 0:
                    for h in handles:
                        h.remove()
                everyone = [None, None]
                dist.all_gather_object(everyone, _replicated_digests(trainer.model))
                differ = sorted(n for n in everyone[0] if everyone[0][n] != everyone[1][n])
                res["replicated_bit_identical"].append(not differ)
                if differ:
                    raise AssertionError(f"(a) {name} step {i + 1}: replicated entries "
                                         f"differ across the ranks: {differ[:8]}")
                if i == 0:
                    grads = tp.gather_state_dict(
                        {n: p.grad.detach() for n, p in trainer.model.named_parameters()}, mesh)
            res["reading"] = reading
            res["expected_all_reduces"] = 4 * blocks  # f and g twice a block
            if res["all_reduces"] != [4 * blocks] * TP_STEPS:
                raise AssertionError(f"(a) {name}: all-reduces {res['all_reduces']}")
            if rank == 0:
                ratios = _gradient_ratios(grads, ref)
                worst = sorted(ratios, key=ratios.get, reverse=True)
                rel = max(abs(a - b) / abs(b) for a, b in zip(res["losses"], res["one_losses"]))
                res.update(loss_rel_difference=rel, loss_rtol=DP_TWO_RTOL,
                           worst_gradient_difference=ratios[worst[0]],
                           worst_gradients=[[n, ratios[n]] for n in worst[:8]],
                           parameters=len(ratios),
                           parameters_over_strict_rtol=sum(
                               r > DP_GRAD_RTOL for r in ratios.values()),
                           gradient_rtol_of_largest_entry=grad_rtol,
                           relu_gate_flips=None if gates is None else gates.get("flips", 0))
                if rel > DP_TWO_RTOL or ratios[worst[0]] > grad_rtol:
                    raise AssertionError(f"(a) {name}: {res}")
            report[name] = res
            del trainer, one, grads, gates
            torch.cuda.empty_cache()
            dist.barrier()
        with open(f"{out_path}.{rank}", "w") as f:
            json.dump(report, f)
    finally:
        dist.destroy_process_group()
    return 0


def tp_gloo_phase(root, rank_exp, dev):
    """(a) Two processes of this script on the one card over ``gloo`` (NCCL
    takes no two ranks on one device); their reports, by rank."""
    store = f"file://{root}/tp_store_{time.time_ns()}"  # a new file store
    out = os.path.join(root, "tp_gloo.json")
    env = dict(os.environ, PYTHONPATH=os.path.dirname(os.path.abspath(__file__)))
    procs = [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), "--tp-worker", store, str(rank),
         root, rank_exp, out, str(dev)], env=env, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True) for rank in range(2)]
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=400)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for rank, p in enumerate(procs):
        if p.returncode != 0:
            raise AssertionError(f"(a) rank {rank} exited {p.returncode}:\n{logs[rank][-4000:]}")
    reports = []
    for rank in range(2):
        with open(f"{out}.{rank}") as f:
            reports.append(json.load(f))
    return reports


@contextlib.contextmanager
def deterministic_algorithms():
    """``torch.use_deterministic_algorithms`` and cuDNN's deterministic
    algorithms on inside, restored after: the FS2 step's backward on the
    card otherwise adds with atomics (the length regulator's ``gather``),
    so two steps from one state differ in their last bits."""
    import warnings

    before = (torch.are_deterministic_algorithms_enabled(),
              torch.is_deterministic_algorithms_warn_only_enabled(),
              torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark)
    torch.use_deterministic_algorithms(True, warn_only=True)
    torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = True, False
    try:
        with warnings.catch_warnings():
            # warn_only's notes (cuBLAS's workspace setting): the bits are checked
            warnings.simplefilter("ignore", UserWarning)
            yield
    finally:
        torch.use_deterministic_algorithms(before[0], warn_only=before[1])
        torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = before[2:]


def _step_record(trainer, batch, key):
    loss = trainer.train_step(batch)[key]
    return dict(loss=loss,
                grads={n: p.grad.detach().clone() for n, p in trainer.model.named_parameters()},
                generators={k: g.get_state() for k, g in trainer.state.generators.items()})


def _against(got, want):
    """remat (or a second plain step) against the plain step: losses and
    generator states bit for bit, the gradients' worst ratio and how many
    differ at all."""
    ratios = _gradient_ratios(got["grads"], want["grads"])
    return dict(losses_bit_identical=got["loss"] == want["loss"],
                generators_equal=same_bits(got["generators"], want["generators"]),
                gradients_bit_identical=same_bits(got["grads"], want["grads"]),
                gradients_differing=sum(r > 0 for r in ratios.values()),
                parameters=len(ratios), worst_gradient_difference=max(ratios.values()))


def remat_phase(root, rank_exp, dev):
    """(b) The rank step (its largest frame bucket, 16 rows) and the FS2 step
    (bucket 1024) in bf16 with and without ``remat``, in this process, from
    the same seed on the same batch.  Held under deterministic algorithms:
    losses and gradients bit-identical (gradients within REMAT_GRAD_RTOL of
    each one's largest entry), generator states equal.  Read in the default
    mode beside it: a second plain step from the same state against the
    first (the card's own spread) and remat against plain.  Then each one's
    wall over two steps in turns (plain, remat, remat, plain) and one
    profiled step: device ms, launches, the step's peak memory above what
    the trainer holds, and that peak up to the optimizer's step."""
    from emotts_torch.train.rank_trainer import RankTrainer

    out = {}
    for name, key, make in (
            ("rank", "loss", lambda cfg: RankTrainer(cfg, device=dev)),
            ("fs2", "total_loss", lambda cfg: fs2_trainer(cfg, rank_exp, dev))):
        trainers = {}
        for path in ("plain", "plain_again", "remat"):
            cfg = (rank_config if name == "rank" else fs2_config)(root, "bfloat16")
            cfg.rank_model.remat = cfg.fastspeech2.remat = path == "remat"
            trainers[path] = make(cfg)
        start = copy.deepcopy(trainers["plain"].state.state_dict())
        batch = dp_batch(name, trainers["plain"], root)
        default = {path: _step_record(t, batch, key) for path, t in trainers.items()}
        for t in trainers.values():
            t.state.load_state_dict(copy.deepcopy(start))
        with deterministic_algorithms():
            held = {path: _step_record(trainers[path], batch, key)
                    for path in ("plain", "remat")}
        res = dict(rows=len(batch["row_valid"]),
                   frames=int(batch["mel" if name == "fs2" else "emo_x"].shape[1]),
                   loss=held["plain"]["loss"],
                   deterministic=_against(held["remat"], held["plain"]),
                   gradient_rtol_of_largest_entry=REMAT_GRAD_RTOL,
                   default_plain_again=_against(default["plain_again"], default["plain"]),
                   default_remat=_against(default["remat"], default["plain"]))
        d = res["deterministic"]
        if not (d["losses_bit_identical"] and d["generators_equal"]
                and d["worst_gradient_difference"] <= REMAT_GRAD_RTOL
                and res["default_remat"]["losses_bit_identical"]
                and res["default_remat"]["generators_equal"]):
            raise AssertionError(f"(b) {name}: {res}")
        del default, held, start, trainers["plain_again"]
        walls = {"plain": [], "remat": []}
        for path in ("plain", "remat", "remat", "plain"):
            walls[path].append(wall_ms(trainers[path], batch))
        for path in ("plain", "remat"):
            # the peak up to the optimizer's step: forward and backward alone
            # (AdamW's fp32 temporaries, four of the parameters' size, come after)
            peaks = []
            base = torch.cuda.memory_allocated()
            hook = trainers[path].state.optimizer.register_step_pre_hook(
                lambda *_: peaks.append(torch.cuda.max_memory_allocated() - base))
            try:
                reading = step_reading(trainers[path], batch)
            finally:
                hook.remove()
            reading.pop("metrics")
            res[path] = dict(reading, wall_ms=sum(walls[path]) / 2,
                             backward_peak_bytes=peaks[0])
        for what in ("step_peak_bytes", "backward_peak_bytes"):
            res[f"{what}_saved"] = res["plain"][what] - res["remat"][what]
        out[name] = res
        del trainers
        torch.cuda.empty_cache()
    return out


def tp_phase(root, rank_exp, dev):
    """Phase 23: (a) the two-process grid and (b) remat; the kernels'
    launches of the grid's steps (both ranks) and of the remat steps,
    counted from 0 around each; returns them and the phase's report."""
    from emotts_torch.ops import attention

    t0 = time.perf_counter()
    grid = tp_gloo_phase(root, rank_exp, dev)
    t1 = time.perf_counter()
    zero_counts(attention)
    remat = remat_phase(root, rank_exp, dev)
    launches = dict(fused_attention=attention.launch_count,
                    fused_attention_bwd=attention.bwd_launch_count)
    for report in grid:
        for job in report.values():
            for step in job["launches"]:
                for k, n in step.items():
                    launches[k] += n
    if min(launches.values()) == 0:
        raise AssertionError(f"tensor_parallel: a kernel was not launched: {launches}")
    return launches, dict(
        seconds=time.perf_counter() - t0, part_seconds=dict(a=t1 - t0, b=time.perf_counter() - t1),
        grid_two_processes=grid, remat=remat, launches=launches)

# --------------------------------------------------------------------------
# 24. the neural G2P's training and batched decode
# --------------------------------------------------------------------------

PEAK_FP32 = 67e12  # CUDA cores, float32: the G2P multiplies with TF32 off
G2P_FORWARD_WORDS = 64  # held-out words teacher-forced through both forwards
G2P_LOGIT_TOL = 2e-4  # atol and rtol, as tests/test_neural_g2p.py holds numpy and JAX
G2P_SAMPLE = 256  # held-out words decoded by np_greedy_decode beside the sweep
G2P_SPLIT_GAP = 1e-4  # a row may split from numpy's only at a near-tie
G2P_TRAIN = dict(batch=512, dropout=0.2, label_smoothing=0.1, lr=1e-3, epochs=1)
G2P_STEP_TIMES = 20  # synchronised steps for the median
G2P_RESUME = dict(d_model=64, d_ff=256, layers=2, heads=4, batch=512, epochs=2,
                  dropout=0.2, label_smoothing=0.1, lr=1e-3, checkpoint_every=1)
G2P_RESUME_PAIRS = 4096


def g2p_args(dev, out, **flags):
    """tools/train_g2p_torch.py's arguments, with ``flags``."""
    from emotts_torch.text import g2p_train

    argv = ["--device", str(dev), "--out", str(out)]
    for key, value in flags.items():
        argv += [f"--{key.replace('_', '-')}", str(value)]
    return g2p_train.build_parser().parse_args(argv)


def np_teacher_forced(p, chars, prev, heads):
    """The numpy path's logits (len(prev), V) for one word teacher-forced
    over ``prev`` (tests/test_neural_g2p.py's mirror of the decoder stack)."""
    from emotts_torch.text import neural_g2p as ng

    enc = ng._np_encode(p, chars, heads)
    tp = len(prev)
    x = p["phon_emb"][np.asarray(prev)] + p["phon_pos"][:tp]
    causal = np.triu(np.full((tp, tp), -1e9, dtype=np.float32), k=1)
    enc_mask = np.zeros((tp, enc.shape[0]), dtype=np.float32)
    for i in range(ng.arch_of(p, heads)["n_dec"]):
        x = ng._dec_layer(x, enc, p, f"dec{i}_", causal, enc_mask, heads)
    return ng._ln(x, p["dec_ln_g"], p["dec_ln_b"]) @ p["out_proj"]


def g2p_forward_check(p, heads, eval_pairs, dev):
    """(a) The bundled weights through G2PTransformer on the card, teacher-
    forced on held-out words over their numpy greedy outputs, against the
    numpy path: logits within G2P_LOGIT_TOL, the same argmax."""
    from emotts_torch.text import neural_g2p as ng

    pick = np.random.default_rng(SEED).permutation(len(eval_pairs))[:G2P_FORWARD_WORDS]
    chars = np.stack([ng.encode_word(eval_pairs[i][0]) for i in pick])
    prefixes = [([ng.PHON_BOS] + ng.np_greedy_decode(p, c, heads))[:ng.MAX_PHON_LEN]
                for c in chars]
    phon = np.zeros((len(chars), ng.MAX_PHON_LEN), np.int64)
    for i, prev in enumerate(prefixes):
        phon[i, :len(prev)] = prev
    model = ng.G2PTransformer.from_flat(p, heads, dev)
    with torch.inference_mode():
        got = model(torch.from_numpy(chars).long().to(dev),
                    torch.from_numpy(phon).to(dev)).cpu().numpy()
    worst, max_abs, same_argmax = 0.0, 0.0, True
    for i, prev in enumerate(prefixes):
        want = np_teacher_forced(p, chars[i], prev, heads)
        diff = np.abs(got[i, :len(prev)] - want)
        max_abs = max(max_abs, float(diff.max()))
        worst = max(worst, float((diff / (G2P_LOGIT_TOL + G2P_LOGIT_TOL * np.abs(want))).max()))
        same_argmax &= bool((got[i, :len(prev)].argmax(-1) == want.argmax(-1)).all())
    res = dict(words=len(chars), positions=sum(map(len, prefixes)), max_abs_err=max_abs,
               worst_of_tolerance=worst, tolerance=G2P_LOGIT_TOL, same_argmax=same_argmax)
    if worst > 1.0 or not same_argmax:
        raise AssertionError(f"g2p (a) forward: {res}")
    return res


def _ids_before_eos(row):
    from emotts_torch.text import neural_g2p as ng

    out = []
    for i in row:
        if int(i) in (ng.PHON_EOS, ng.PHON_PAD):
            break
        out.append(int(i))
    return out


def g2p_sweep(p, heads, eval_pairs, recorded, dev):
    """(b) batched_greedy_decode of the bundled weights over the whole
    held-out set on the card: wall, words/s, exact and PER beside the
    file's recorded metrics; the ids against np_greedy_decode on a seeded
    sample, where a row may differ only at a top-two logit gap under
    G2P_SPLIT_GAP of numpy's at the step where it splits."""
    from emotts_torch.text import g2p_train as gt
    from emotts_torch.text import neural_g2p as ng

    chars = np.stack([ng.encode_word(w) for w, _ in eval_pairs])
    ng.batched_greedy_decode(p, chars[:512], heads, device=dev)  # warm
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    rows = ng.batched_greedy_decode(p, chars, heads, device=dev)
    wall = time.perf_counter() - t0
    hyps = [ng.decode_phoneme_ids(r) for r in rows]
    exact = sum(h == ref for h, (_, ref) in zip(hyps, eval_pairs)) / len(eval_pairs)
    per = (sum(gt._edit(h, ref) for h, (_, ref) in zip(hyps, eval_pairs))
           / sum(len(ref) for _, ref in eval_pairs))
    pick = np.random.default_rng(SEED + 1).permutation(len(eval_pairs))[:G2P_SAMPLE]
    gaps, never_end = [], 0
    for i in pick:
        want = ng.np_greedy_decode(p, chars[i], heads)
        got = _ids_before_eos(rows[i])
        if got == want:
            continue
        if got == want[:ng.MAX_PHON_LEN - 1]:
            # no EOS in MAX_PHON_LEN - 1 steps: the numpy decoder takes one
            # step more (emotts/text/neural_g2p.py::jax_batched_greedy_decode)
            never_end += 1
            continue
        k = next((j for j, (a, b) in enumerate(zip(got, want)) if a != b),
                 min(len(got), len(want)))
        enc = ng._np_encode(p, chars[i], heads)
        top = np.sort(ng._np_step_logits(p, enc, [ng.PHON_BOS] + want[:k], heads))
        gaps.append(float(top[-1] - top[-2]))
    res = dict(words=len(chars), wall_s=wall, words_per_s=len(chars) / wall,
               chunk=512, steps_per_chunk=ng.MAX_PHON_LEN - 1, exact=exact, per=per,
               recorded_exact=recorded.get("exact"), recorded_per=recorded.get("per"),
               numpy_sample=len(pick), rows_differing_from_numpy=len(gaps),
               rows_without_eos=never_end,
               split_gaps=gaps, split_gap_limit=G2P_SPLIT_GAP)
    if any(g >= G2P_SPLIT_GAP for g in gaps):
        raise AssertionError(f"g2p (b) sweep: rows split from numpy's above the gap limit: {res}")
    return res


class G2PStepper:
    """One G2P train step in the trainers' shape (``train_step(batch)``),
    for profile_steps: a fresh model and AdamW at ``args``' sizes."""

    def __init__(self, args, dev):
        from emotts_torch.text import neural_g2p as ng
        from emotts_torch.train.state import AdamW

        self.args, self.n = args, 0
        self.model = ng.G2PTransformer.from_flat(ng.init_params(
            0, d_model=args.d_model, d_ff=args.d_ff, n_enc=args.layers,
            n_dec=args.layers), args.heads, dev)
        self.opt = AdamW(self.model.parameters(), lr=args.lr, weight_decay=1e-4)
        self.gen = torch.Generator(device=dev)

    def train_step(self, batch):
        from emotts_torch.text import g2p_train as gt

        self.gen.manual_seed(gt.step_seed(0, self.n))
        self.n += 1
        return gt.train_step(self.model, self.opt, *batch, dropout_rate=self.args.dropout,
                             smoothing=self.args.label_smoothing, generator=self.gen)


def g2p_train_epoch(p, heads, pairs, root, dev):
    """(c) One full epoch at the bundled architecture from init_params(0)
    on the whole training set: finite losses, the epoch's mean below its
    first step's, wall, peak memory; then a fresh step's median wall over
    G2P_STEP_TIMES synchronised steps, a profiler reading of three steps
    and its matmul operations (FlopCounterMode) with their bound on the CUDA
    cores' fp32 peak."""
    from torch.utils.flop_counter import FlopCounterMode

    from emotts_torch.text import g2p_train as gt
    from emotts_torch.text import neural_g2p as ng

    arch = ng.arch_of(p, heads)
    assert arch["n_enc"] == arch["n_dec"]
    args = g2p_args(dev, os.path.join(root, "g2p_epoch.npz"), d_model=arch["d_model"],
                    d_ff=arch["d_ff"], layers=arch["n_enc"], heads=heads, **G2P_TRAIN)
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    history = []
    gt.train(args, pairs=pairs, history=history)
    losses = history[0]["losses"]
    res = dict(arch=arch, parameters=sum(v.size for v in p.values()),
               pairs=len(pairs[0]), steps=len(losses), epoch_s=history[0]["seconds"],
               first_loss=float(losses[0]), mean_loss=float(losses.mean()),
               last_loss=float(losses[-1]), finite=bool(np.isfinite(losses).all()),
               peak_bytes=torch.cuda.max_memory_allocated() - base)
    if not res["finite"] or not res["mean_loss"] < res["first_loss"]:
        raise AssertionError(f"g2p (c) training: {res}")

    stepper = G2PStepper(args, dev)
    batch = tuple(torch.from_numpy(a).long().to(dev) for a in gt.vectorize(pairs[0][:args.batch]))
    for _ in range(3):
        stepper.train_step(batch)
    walls = []
    for _ in range(G2P_STEP_TIMES):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        stepper.train_step(batch)
        torch.cuda.synchronize()
        walls.append(1e3 * (time.perf_counter() - t0))
    reading = profile_steps(stepper, {args.batch: batch}, rows=lambda b: len(b[0]),
                            timed=5, traced=3, host_ops=False,
                            groups=(("gemm", "gemm"),))[str(args.batch)]
    with FlopCounterMode(display=False) as counter:
        stepper.train_step(batch)
    flops = counter.get_total_flops()
    res.update(step_ms_median=float(np.median(walls)), step_ms_min=min(walls),
               step_reading=reading, step_flops=flops,
               step_bound_ms=1e3 * flops / PEAK_FP32, bound_by="operations",
               epoch_bound_s=flops * len(losses) / PEAK_FP32)
    return res


def g2p_resume(pairs, root, dev):
    """(d) At d_model 64 on G2P_RESUME_PAIRS pairs under deterministic
    algorithms: 2 epochs straight, checkpointing after the first, against a
    fresh trainer resuming the second from that checkpoint (weights and SWA
    weights bit-identical); then the tool as a subprocess (1 epoch on the
    whole set at the same widths, --final-eval-limit 512): its weight file
    loads in the port's NeuralG2P and decodes."""
    import shutil

    from emotts_torch.text import g2p_train as gt
    from emotts_torch.text import neural_g2p as ng

    sub = (pairs[0][:G2P_RESUME_PAIRS], pairs[1])
    straight_out = os.path.join(root, "g2p_straight.npz")
    kept = os.path.join(root, "g2p_epoch1.resume.npz")
    with deterministic_algorithms():
        straight, straight_swa, _, _ = gt.train(g2p_args(dev, straight_out, **G2P_RESUME),
                                                pairs=sub)
        shutil.copy(os.path.join(root, "g2p_straight.resume.npz"), kept)
        resumed, resumed_swa, _, _ = gt.train(g2p_args(
            dev, os.path.join(root, "g2p_resumed.npz"), resume_from=kept, **G2P_RESUME),
            pairs=sub)
    res = dict(pairs=len(sub[0]), widths=G2P_RESUME,
               weights_bit_identical=all(np.array_equal(straight[k], resumed[k])
                                         for k in straight),
               swa_bit_identical=straight_swa is not None and all(
                   np.array_equal(straight_swa[k], resumed_swa[k]) for k in straight_swa))
    if not (res["weights_bit_identical"] and res["swa_bit_identical"]):
        raise AssertionError(f"g2p (d) resume: {res}")

    out = os.path.join(root, "g2p_tool.npz")
    small = {k: G2P_RESUME[k] for k in ("d_model", "d_ff", "layers", "heads")}
    cmd = [sys.executable, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                        "tools", "train_g2p_torch.py"),
           "--device", "cuda", "--epochs", "1", "--final-eval-limit", "512", "--out", out]
    for key, value in small.items():
        cmd += [f"--{key.replace('_', '-')}", str(value)]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True, timeout=600)
    tool_s = time.perf_counter() - t0
    if proc.returncode != 0:
        raise AssertionError(f"g2p (d) tool exited {proc.returncode}:\n"
                             f"{proc.stdout[-3000:]}\n{proc.stderr[-3000:]}")
    g2p = ng.NeuralG2P(out)
    words = ["zembla", "blorptastic", "crystalline", "thunderous"]
    decoded = {w: g2p.word_to_phonemes(w) for w in words}
    data = np.load(out)
    res["tool"] = dict(seconds=tool_s, argv=cmd[2:], decoded=decoded,
                       eval_exact=float(data["__eval_exact__"][0]),
                       eval_per=float(data["__eval_per__"][0]),
                       log_tail=[ln for ln in proc.stdout.splitlines()
                                 if ln.startswith(("epoch", "selected", "saved", "[held-out]"))])
    if not any(decoded.values()):
        raise AssertionError(f"g2p (d) tool weights decode nothing: {res}")
    return res


def g2p_phase(root, dev):
    """Phase 24: the pairs (tools/train_g2p.py's split), then (a)-(d); one
    JSON line a part."""
    from emotts_torch.text import g2p_train as gt
    from emotts_torch.text import neural_g2p as ng

    t0 = time.perf_counter()
    pairs = gt.build_pairs(seed=0, holdout_frac=0.1)
    pairs_s = time.perf_counter() - t0
    p, heads = gt.load_weights(ng.BUNDLED_WEIGHTS)
    data = np.load(ng.BUNDLED_WEIGHTS)
    recorded = dict(exact=float(data["__eval_exact__"][0]), per=float(data["__eval_per__"][0]))
    seconds = dict(pairs=pairs_s)
    for part, run in (("forward", lambda: g2p_forward_check(p, heads, pairs[1], dev)),
                      ("sweep", lambda: g2p_sweep(p, heads, pairs[1], recorded, dev)),
                      ("train_epoch", lambda: g2p_train_epoch(p, heads, pairs, root, dev)),
                      ("resume", lambda: g2p_resume(pairs, root, dev))):
        t1 = time.perf_counter()
        res = run()
        seconds[part] = res["seconds"] = time.perf_counter() - t1
        emit(f"g2p_{part}", **res)
        torch.cuda.empty_cache()
    return dict(seconds=time.perf_counter() - t0, part_seconds=seconds,
                train_pairs=len(pairs[0]), eval_pairs=len(pairs[1]))



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
    from emotts_torch.nn.intensity import IntensityExtractor
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
    tp_fwd, tp_bwd = check_attention_tp(gen, dev)
    cases = {
        "fused_attention": check_attention(gen, dev),
        "fused_attention_dropout": dropout_cases,
        "fused_attention_bwd": check_attention_bwd(gen, dev),
        "fused_attention_tp_rank": tp_fwd,
        "fused_attention_bwd_tp_rank": tp_bwd,
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
    zero_counts(attention, mrf, resblock)
    counter = ForwardCounter(synth)
    health, served = serve_phase(cfg, synth)
    emit("serve", health=health, requests=served)
    sweep = sweep_phase(cfg, synth)
    emit("sweep", **sweep)
    launches = dict(fused_attention=attention.launch_count,
                    fused_mrf_stage=mrf.launch_count,
                    fused_resblock1=resblock.launch_count)
    fp32_by_path = dict(serving=fp32_attention_launches())  # bf16: none
    counter.close()

    f2 = cfg.fastspeech2
    # V1: the MRF kernel takes the stages with C = 128, 64, 32; the C = 256
    # stage one ResBlock wrapper call per kernel size; each wrapper call one
    # CUDA launch or one per dilation step (of each ResBlock), as its
    # launch_plan gives for the forward's rows and length
    n_mrf, n_resblock, by_forward = launches_by_forward(counter.launched)
    expected = dict(
        fused_attention=(f2.enc_num_layers + f2.dec_num_layers) * counter.fs2,
        fused_mrf_stage=n_mrf, fused_resblock1=n_resblock,
    )
    emit("launches", counted=launches, expected=expected,
         fs2_forwards=counter.fs2, generator_forwards=counter.vocoder,
         mrf_and_resblock_cuda_launches_by_generator_forward=by_forward)
    if launches != expected or min(launches.values()) == 0:
        raise AssertionError(f"launch counters {launches}, expected {expected}")
    del synth
    torch.cuda.empty_cache()

    # -- 7. parity -----------------------------------------------------------
    parity = parity_phase(weights)
    emit("parity", **parity)
    fp32_by_path["parity"] = parity["fp32_launches"]["counted"]

    # -- 8-10. training, then bucketization, counted ---------------------------
    with tempfile.TemporaryDirectory(prefix="emotts_smoke_") as root:
        rank_cfg = rank_config(root)
        emit("corpus", seed=SEED, **make_rank_corpus(
            rank_cfg.data.preprocessed_path, rank_cfg, SEED))
        zero_counts(attention)
        extractor = ModuleCounter(IntensityExtractor)
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
        # bucketize builds the rank model in fp32; training is bf16
        fp32_steps = train_steps if rank_cfg.train_rank.compute_dtype == "float32" else 0
        train_fp32 = dict(counted=fp32_attention_launches(), expected=dict(
            fused_attention=layers * extractor.fp32_forwards,
            fused_attention_bwd=layers * attention.BWD_LAUNCHES_PER_CALL * fp32_steps))
        emit("train_launches", counted=train_launches, expected=train_expected,
             extractor_forwards=extractor.forwards, train_steps=train_steps,
             cuda_launches_per_backward_call=attention.BWD_LAUNCHES_PER_CALL,
             fp32=train_fp32, extractor_fp32_forwards=extractor.fp32_forwards)
        if train_launches != train_expected or min(train_launches.values()) == 0:
            raise AssertionError(
                f"launch counters {train_launches}, expected {train_expected}")
        if (train_fp32["counted"] != train_fp32["expected"]
                or train_fp32["counted"]["fused_attention"] == 0):
            raise AssertionError(f"fp32 launches of training and bucketize {train_fp32}")
        fp32_by_path["training"] = train_fp32["counted"]
        emit("serve_with_bank", **serve_with_bank(weights, bank))
        emit("train_profile", **train_profile_phase(rank_cfg, dev))
        torch.cuda.empty_cache()

        # -- 11. train parity ---------------------------------------------------
        train_parity = train_parity_phase(root, dev)
        emit("train_parity", **train_parity)
        fp32_by_path["train_parity"] = train_parity["fp32_launches"]["counted"]

        # -- 12-14. FastSpeech2 training, its parity, streamed serving ---------
        fs2_exp, fs2_launches, stream_launches, fs2_fp32 = fs2_phases(
            root, exp, weights[1], dev)
        fp32_by_path.update(fs2_fp32)
        torch.cuda.empty_cache()

        # -- 15-16. raw audio to features on the card, then evaluation ---------
        t0 = time.perf_counter()
        eval_cfg, prepared = preprocess_phase(root, dev)
        emit("preprocess", seconds=time.perf_counter() - t0, **prepared)
        eval_cfg.inference.vocoder_checkpoint = os.path.join(root, "vocoder.npz")
        t0 = time.perf_counter()
        eval_launches, evaluated = evaluate_phase(eval_cfg, fs2_exp, exp, dev)
        emit("evaluate", seconds=time.perf_counter() - t0, **evaluated)
        fp32_by_path["evaluation"] = evaluated["launches"]["fp32"]["counted"]
        torch.cuda.empty_cache()

        # -- 17-20. vocoder training, its parity, the fine-tune, serving it ----
        voc_launches, fp32_by_path["vocoder_training"] = vocoder_phases(
            root, fs2_exp, exp, dev)
        torch.cuda.empty_cache()

        # -- 21. the emotts-torch command --------------------------------------
        cli_launches, fp32_by_path["cli"], cli_report = cli_phase(
            root, dev, sweep["wall_ms"])
        emit("cli", **cli_report)
        torch.cuda.empty_cache()

        # -- 22. data parallelism ------------------------------------------------
        dp_launches, dp_report = dp_phase(root, exp, weights, dev)
        emit("data_parallel", card=card, **dp_report)
        fp32_by_path["data_parallel"] = dp_report["fp32_launches"]
        torch.cuda.empty_cache()

        # -- 23. tensor parallelism and remat ---------------------------------
        tp_launches, tp_report = tp_phase(root, exp, dev)
        emit("tensor_parallel", card=card, **tp_report)
        torch.cuda.empty_cache()

        # -- 24. the neural G2P: training and batched decode --------------------
        zero_counts(attention, mrf, resblock)
        g2p_report = g2p_phase(root, dev)
        g2p_launches = dict(fused_attention=attention.launch_count,
                            fused_attention_bwd=attention.bwd_launch_count,
                            fused_mrf_stage=mrf.launch_count,
                            fused_resblock1=resblock.launch_count)
        emit("g2p", card=card, kernel_launches=g2p_launches, **g2p_report)
        if any(g2p_launches.values()):  # its products are torch.matmul alone
            raise AssertionError(f"g2p: a kernel of another path ran: {g2p_launches}")

    # -- summary ---------------------------------------------------------------
    # a kernel's launches over the counted paths
    serve_launches = dict(launches)
    by_path = dict(serving=serve_launches, training=train_launches,
                   fs2_training=fs2_launches, streaming=stream_launches,
                   evaluation=eval_launches, vocoder_training=voc_launches,
                   cli=cli_launches, data_parallel=dp_launches,
                   tensor_parallel=tp_launches, g2p=g2p_launches)
    launches = {name: sum(path.get(name, 0) for path in by_path.values())
                for name in ("fused_attention", "fused_attention_bwd",
                             "fused_mrf_stage", "fused_resblock1")}
    headline = {  # the case that carries most of the serving path's time
        "fused_attention": lambda c: c["dtype"] == "bfloat16" and c["shape"][1] == 1024,
        # the largest bucket of a training step at batch 8 (16 rows), with dropout
        "fused_attention_bwd": lambda c: (c["dtype"] == "bfloat16" and c["rate"] > 0
                                          and c["shape"][:2] == [16, 1024]
                                          and "bias" not in c),
        "fused_mrf_stage": lambda c: c["dtype"] == "float32" and c["shape"][1:] == [65536, 128],
        "fused_resblock1": lambda c: (c["dtype"] == "float32" and c["k"] == 11
                                      and c["shape"][1] == 8192),
    }
    fp32_headline = {  # fp32's largest evaluation and training cases
        "fused_attention": lambda c: c["dtype"] == "float32" and c["shape"] == [8, 1024, 2, 192],
        "fused_attention_bwd": lambda c: (c["dtype"] == "float32" and c["rate"] == 0.0
                                          and c["shape"] == [8, 512, 2, 192]
                                          and "bias" not in c),
    }
    meta = {
        "fused_attention": ("emotts_torch/csrc/attention.cu", "emotts/ops/attention.py:161"),
        "fused_attention_bwd": ("emotts_torch/csrc/attention_bwd.cu",
                                "emotts/ops/attention.py:174"),
        "fused_mrf_stage": ("emotts_torch/csrc/mrf.cu", "emotts/ops/mrf.py:245"),
        "fused_resblock1": ("emotts_torch/csrc/resblock.cu", "emotts/ops/resblock.py:201"),
    }
    # the tensor-parallel rank's shape (H = 1), bf16 at rate 0.1
    tp_cases = {"fused_attention": tp_fwd, "fused_attention_bwd": tp_bwd}
    kernels = []
    for name, (source, replaces) in meta.items():
        head = next(c for c in cases[name] if headline[name](c))
        kernels.append(dict(
            name=name, route="cuda", source=source, replaces=replaces,
            launches=launches[name],
            launches_by_path={path: counts.get(name, 0)
                              for path, counts in by_path.items()},
            max_abs_err=max(c["max_abs_err"] for c in cases[name]
                            + (dropout_cases if name == "fused_attention" else [])
                            + tp_cases.get(name, [])),
            ms=head["ms"], plain_ms=head["plain_ms"], bound_ms=head["bound_ms"],
            bound_by=head["bound_by"],
            # the library call is timed without dropout: take that case's time
            library_ms=next((c["library_ms"] for c in cases[name]
                             if c["shape"] == head["shape"] and c["dtype"] == head["dtype"]
                             and c["library_ms"] is not None and "bias" not in c), None),
            at=dict(dtype=head["dtype"], shape=head["shape"]),
        ))
        with_ratios(kernels[-1])
        if name in tp_cases:
            c = next(c for c in tp_cases[name] if c["dtype"] == "bfloat16" and c["rate"] > 0)
            lib = next(x["library_ms"] for x in tp_cases[name]
                       if x["shape"] == c["shape"] and x["dtype"] == c["dtype"]
                       and x["library_ms"] is not None)
            kernels[-1]["tp_rank"] = dict(
                {key: c[key] for key in ("ms", "device_ms", "plain_ms", "bound_ms",
                                         "bound_by", "max_abs_err")},
                library_ms=lib, at=dict(shape=c["shape"], rate=c["rate"]))
        if name in fp32_headline:
            # the fp32 instance's own case and launches, beside the headline's
            c = next(c for c in cases[name] if fp32_headline[name](c))
            fp32 = {key: c[key] for key in (
                "ms", "device_ms", "library_ms", "library_device_ms", "bound_ms",
                "bound_by", "bound_fraction", "vs_library", "vs_library_device",
                "tensor_tflops")}
            kernels[-1]["fp32"] = dict(
                **fp32, at=dict(shape=c["shape"], rate=c.get("rate", 0.0)),
                launches_by_path={path: counts[name] for path, counts in fp32_by_path.items()})
    emit("done", seconds=time.perf_counter() - t_start)
    print(card, flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--dp-worker"]:  # phase 22 (b): one of its processes
        sys.exit(dp_gloo_worker(sys.argv[2:]))
    if sys.argv[1:2] == ["--tp-worker"]:  # phase 23 (a): one of its processes
        sys.exit(tp_gloo_worker(sys.argv[2:]))
    sys.exit(main())
