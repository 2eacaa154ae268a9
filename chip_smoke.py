#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (emotts_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Needs one CUDA device, the CUDA toolkit (nvcc) and nothing else: no network,
no checkpoint (all weights are drawn from a seed).  In order, each phase
printing one JSON line, any failure ending the run with a non-zero exit:

1. card     name and power limit (nvidia-smi), torch and CUDA versions
2. build    the three kernels from emotts_torch/csrc, one nvcc each, together
3. kernels  each kernel against its plain PyTorch version on the card, at the
            shapes the serving path gives it, with times and roofline bounds
4. serve    the full-width model behind the HTTP server: /health, a cold and
            three warm /synthesize, one /batch
5. sweep    Synthesizer.intensity_sweep, 60 utterances in one batch
6. launches the kernels' launch counters over phases 4-5
7. parity   the kernel path against the plain path, end to end, in fp32

The last line is {"ok": true, "device": {...}}; before it stand the card line
and one {"kernels": [...]} line.  Without a GPU the script exits non-zero and
prints no result.
"""

import base64
import io
import json
import math
import subprocess
import sys
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
    h, d = 2, 192
    for dtype, b, t, iters in ((torch.bfloat16, 60, 48, 20),
                               (torch.float32, 60, 48, 20),
                               (torch.bfloat16, 3, 200, 20),  # ragged last tile
                               (torch.float32, 8, 1024, 3),
                               (torch.bfloat16, 60, 1024, 3)):
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
            max_rel_err=rel, tolerance=TOL[dtype], ms=ms, plain_ms=plain_ms,
            library_ms=library_ms, bound_ms=bound_ms, bound_by=by,
        ))
    return cases


def _block_weights(gen, dev, c, k, n_d=3):
    std = 0.5 / math.sqrt(k * c)
    w1, w2 = (torch.randn(n_d, k, c, c, generator=gen).mul_(std).to(dev)
              for _ in range(2))
    b1, b2 = (torch.randn(n_d, c, generator=gen).mul_(0.1).to(dev) for _ in range(2))
    return w1, b1, w2, b2


def _chain_ops(b, t, c, ks, n_d=3):
    return 2 * b * t * sum(2 * n_d * k for k in ks) * c * c


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
            bound_ms, by = bound(_chain_ops(rows, t, c, (k,)), peak, nbytes)
            cases.append(dict(
                dtype=str(dtype).split(".")[1], shape=[rows, t, c], k=k,
                cuda_launches=len(R.launch_plan(c, k, dil)), max_abs_err=err,
                max_rel_err=rel, tolerance=TOL[dtype], ms=ms, plain_ms=plain_ms,
                library_ms=None, bound_ms=bound_ms, bound_by=by,
            ))
    return cases


def check_mrf(gen, dev, frames, batch):
    from emotts_torch.ops import mrf as M

    cases = []
    ks = (3, 7, 11)
    for dtype in (torch.float32, torch.bfloat16):
        # the main path's three stages, then short sequences whose lengths
        # are a multiple of no tile (edge masks, ragged last tile)
        for c, rows, t in ((128, batch, 64 * frames), (64, batch, 128 * frames),
                            (32, batch, 256 * frames), (128, 2, 777), (32, 3, 333)):
            x = torch.randn(rows, t, c, generator=gen).to(dev, dtype)
            params = [_block_weights(gen, dev, c, k) for k in ks]
            got = M.fused_mrf_stage(x, params, ks)
            torch.cuda.synchronize()
            want = M.fused_mrf_stage_plain(x, params, ks)
            err, rel = compare(got, want, **TOL[dtype])
            del got, want
            ms = time_ms(lambda: M.fused_mrf_stage(x, params, ks), 2)
            plain_ms = time_ms(lambda: M.fused_mrf_stage_plain(x, params, ks), 2)
            peak = PEAK_BF16 if dtype == torch.bfloat16 else PEAK_TF32
            nbytes = (2 * x.numel() * x.element_size()
                      + sum(a.numel() * 4 for blk in params for a in blk))
            bound_ms, by = bound(_chain_ops(rows, t, c, ks), peak, nbytes)
            cases.append(dict(
                dtype=str(dtype).split(".")[1], shape=[rows, t, c],
                tile=M.stage_tile(c, ks, (1, 3, 5)), max_abs_err=err,
                max_rel_err=rel, tolerance=TOL[dtype], ms=ms, plain_ms=plain_ms,
                library_ms=None, bound_ms=bound_ms, bound_by=by,
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
    cases = {
        "fused_attention": check_attention(gen, dev),
        "fused_mrf_stage": check_mrf(gen, dev, frames, chunk_rows),
        "fused_resblock1": check_resblock(gen, dev, frames, chunk_rows),
    }
    emit("kernels", cases=cases)
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

    f2 = cfg.fastspeech2
    per_vocode_resblock = sum(
        len(resblock.launch_plan(256, k, d)) for k, d in zip(
            cfg.train_vocoder.resblock_kernel_sizes,
            cfg.train_vocoder.resblock_dilations))
    expected = dict(
        fused_attention=(f2.enc_num_layers + f2.dec_num_layers) * counter.fs2,
        fused_mrf_stage=3 * counter.vocoder,  # the stages with C = 128, 64, 32
        # the C = 256 stage: one ResBlock wrapper call per kernel size; k = 7
        # and k = 11 take one CUDA launch per dilation step there
        fused_resblock1=per_vocode_resblock * counter.vocoder,
    )
    emit("launches", counted=launches, expected=expected,
         fs2_forwards=counter.fs2, generator_forwards=counter.vocoder,
         resblock_cuda_launches_per_generator_forward=per_vocode_resblock)
    if launches != expected or min(launches.values()) == 0:
        raise AssertionError(f"launch counters {launches}, expected {expected}")
    del synth
    torch.cuda.empty_cache()

    # -- 7. parity -----------------------------------------------------------
    emit("parity", **parity_phase(weights))

    # -- summary ---------------------------------------------------------------
    headline = {  # the case that carries most of the serving path's time
        "fused_attention": lambda c: c["dtype"] == "bfloat16" and c["shape"][1] == 1024,
        "fused_mrf_stage": lambda c: c["dtype"] == "float32" and c["shape"][1:] == [65536, 128],
        "fused_resblock1": lambda c: (c["dtype"] == "float32" and c["k"] == 11
                                      and c["shape"][1] == 8192),
    }
    meta = {
        "fused_attention": ("emotts_torch/csrc/attention.cu", "emotts/ops/attention.py:161"),
        "fused_mrf_stage": ("emotts_torch/csrc/mrf.cu", "emotts/ops/mrf.py:245"),
        "fused_resblock1": ("emotts_torch/csrc/resblock.cu", "emotts/ops/resblock.py:201"),
    }
    kernels = []
    for name, (source, replaces) in meta.items():
        head = next(c for c in cases[name] if headline[name](c))
        kernels.append(dict(
            name=name, route="cuda", source=source, replaces=replaces,
            launches=launches[name],
            max_abs_err=max(c["max_abs_err"] for c in cases[name]),
            ms=head["ms"], plain_ms=head["plain_ms"], bound_ms=head["bound_ms"],
            bound_by=head["bound_by"], library_ms=head["library_ms"],
            at=dict(dtype=head["dtype"], shape=head["shape"]),
        ))
    emit("done", seconds=time.perf_counter() - t_start)
    print(card, flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
