"""The served pipeline as ``configs/fs2-hifigan-v1.json`` states it:
``emotts_torch``'s ``Synthesizer`` (G2P, FastSpeech2 in bfloat16 through
the attention kernel, HiFi-GAN V1 in float32 through the MRF and ResBlock
kernels) on seeded weights, behind ``TTSService`` where a cell serves.

The benchmark wraps ``synthesize_requests`` on the instance and hooks the
two models, to count rows and frames, to keep the outputs of a sample of
requests for the comparison, and to open its ranges while it traces.

The comparison, for each request of the sample (drawn from the seed) and
the longest request of the window:

* ``phone_mismatch``: requests whose phone ids (FastSpeech2's input) are
  not the word list's pronunciations; limit 0.
* ``length_mismatch``: requests whose mel length is not the sum of the
  durations their log-durations round to, or whose waveform is not that
  many hops long; limit 0.
* ``duration_gap_frames``: the widest gap by which a duration the program
  chose lies outside the reference's rounding interval (|d − e| − ½, e
  the reference's expm1 of its log-duration), over every phone.
* ``mel_rel_rms``: the RMS error of the mel handed to the vocoder over the
  reference's RMS, pooled over the requests compared (every frame of every
  request weighs alike), the reference taught the program's durations so
  that both mels have one length.
* ``pcm_max_step``: the widest gap, in 16-bit steps, between the PCM
  returned to a request and the reference generator's PCM of the mel the
  program vocoded (the program's own state: this judges the vocoder stage
  by itself).
* ``pcm_rel_rms``: the median over the requests of the RMS error of the
  PCM returned to a request against the reference's PCM of the reference's
  own mel (text to PCM), over that PCM's RMS.  The reference takes the
  program's durations, which ``duration_gap_frames`` judges;
  ``same_durations`` counts the requests whose durations the reference
  rounds alike, for which it is the reference's text to PCM with nothing
  of the program's.

A request's own relative error (``mel_rel_rms_worst``,
``pcm_rel_rms_worst``: the worst request's, reported) follows the worst
bf16 mel of the sample and swings from seed to seed; the control's errs on
every request.  So the mel's is pooled, where one request gone wrong (a row
left out reads 1 alone) still reads about a third among eight sound ones,
and the PCM's is the median, the steadier of the two, since
``pcm_max_step`` already holds every request's vocoder stage.
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional

import numpy as np
import torch

from harness.sentences import Request
from harness.trace import Range
from harness.weights import card_generator, seeded_state
from reference.fs2 import FastSpeech2 as ReferenceFS2
from reference.g2p import phone_ids, pronunciations
from reference.hifigan import Generator as ReferenceGenerator
from reference.hifigan import pcm16
from reference.precision import FP8, FP32, TF32
from roofline import attention_fwd, model_flops, peaks, vocoder_kernels



def pick_bucket(n: int, buckets) -> int:
    return next((b for b in buckets if n <= b), n)


def port_config(c: dict):
    """The port's ``Config`` as the configuration file states it."""
    from emotts_torch.utils.config import Config

    cfg = Config()
    f, fc, h = cfg.fastspeech2, c["fastspeech2"], c["hifigan"]
    cfg.audio.sampling_rate, cfg.audio.hop_length = c["audio"]["sampling_rate"], c["audio"]["hop_length"]
    cfg.audio.n_mels = f.n_mels = c["audio"]["n_mels"]
    f.enc_num_layers, f.dec_num_layers = fc["enc_num_layers"], fc["dec_num_layers"]
    f.enc_d_model = f.dec_d_model = fc["d_model"]
    f.enc_num_head = f.dec_num_head = fc["heads"]
    f.enc_ffn_dim = f.dec_ffn_dim = fc["ffn_dim"]
    f.ffn_kernel_sizes = list(fc["ffn_kernel_sizes"])
    f.postnet_embedding_dim, f.postnet_kernel_size = fc["postnet_embedding_dim"], fc["postnet_kernel_size"]
    f.postnet_n_convolutions, f.n_char = fc["postnet_n_convolutions"], fc["n_char"]
    f.max_mel_len, f.fused_attention = fc["max_mel_len"], fc["fused_attention"]
    f.prenet_style, f.postnet_style = fc["prenet_style"], fc["postnet_style"]
    cfg.bucketing.phone_buckets = list(fc["phone_buckets"])
    cfg.train_fs2.compute_dtype = fc["compute_dtype"]
    cfg.inference.vocode_row_frames = h["vocode_row_frames"]
    b = c["bank"]
    cfg.data.speakers = [f"speaker{i}" for i in range(b["speakers"])]
    cfg.data.emotions = ["neutral"] + [f"emotion{i}" for i in range(1, b["emotions"])]
    cfg.inference.bucket_size = b["levels"]
    return cfg


def vocoder_structure(c: dict, kernels: bool = True) -> dict:
    h = c["hifigan"]
    return dict(in_channels=c["audio"]["n_mels"],
                upsample_initial_channel=h["upsample_initial_channel"],
                upsample_rates=tuple(h["upsample_rates"]),
                upsample_kernel_sizes=tuple(h["upsample_kernel_sizes"]),
                resblock_kernel_sizes=tuple(h["resblock_kernel_sizes"]),
                resblock_dilations=tuple(tuple(d) for d in h["resblock_dilations"]),
                fused_mrf=kernels and h["fused_mrf"],
                use_pallas_resblocks=kernels and h["resblock_kernel"])


def _fs2_rule(name, shape):
    if len(shape) >= 2:
        return "normal", int(np.prod(shape[1:]))
    if name.endswith("running_var") or name.endswith(".weight"):
        return "ones", 0
    return "zeros", 0


def _vocoder_rule(name, shape):
    if len(shape) >= 3:
        return "normal", int(shape[-2] * shape[-3])
    return "zeros", 0


FRAMES_PER_PHONE = 4.0
CALIBRATION_SENTENCES = 1024


def calibrate_durations(c: dict, fs2: dict, bank: torch.Tensor, seed: int) -> None:
    """Set the duration head's bias so that the plain reference gives
    FRAMES_PER_PHONE frames a phone on average, after rounding, over
    CALIBRATION_SENTENCES requests drawn from the seed as the traffic draws
    them (sentences, speakers, emotions and levels; each padded to its
    phone bucket): every seed's weights then speak at one rate.  The
    log-duration is linear in the bias, so the bias is found by bisection
    on the rounded mean."""
    from harness.sentences import Sentences

    f, b = c["fastspeech2"], c["bank"]
    sentences = Sentences({"sentence": dict(median_words=9, sigma=0.5, min_words=3, max_words=40,
                                            max_phones=max(f["phone_buckets"]))},
                          np.random.default_rng([seed, 7]), {},
                          (b["speakers"], b["emotions"], b["levels"]))
    prons = pronunciations()
    bias = fs2["duration_predictor.out.bias"]
    dev = bias.device
    ref = ReferenceFS2(fs2, dict(layers=f["enc_num_layers"], heads=f["heads"], ln_eps=f["ln_eps"]))
    groups: Dict[int, list] = {}
    for q in sentences.requests(CALIBRATION_SENTENCES):
        ids = phone_ids(q.text, prons)
        groups.setdefault(pick_bucket(len(ids), f["phone_buckets"]), []).append((q, ids))
    free = []  # log-durations less the bias, over every phone
    for p, rows in groups.items():
        for at in range(0, len(rows), 128):
            chunk = rows[at:at + 128]
            tokens = torch.zeros((len(chunk), p), dtype=torch.long, device=dev)
            for i, (_, ids) in enumerate(chunk):
                tokens[i, :len(ids)] = torch.tensor(ids, device=dev)
            spk = torch.tensor([q.speaker for q, _ in chunk], device=dev)
            inten = torch.stack([_intensity(bank, q, len(ids), p) for q, ids in chunk])
            log_dur = ref.log_durations(tokens, spk, inten)
            free.append(log_dur[tokens != 0] - bias)
    free = torch.cat(free)
    lo, hi = -10.0, 10.0
    for _ in range(60):
        mid = 0.5 * (lo + hi)
        frames = torch.round(torch.clamp(torch.expm1(free + mid), min=0.0)).mean()
        lo, hi = (mid, hi) if frames < FRAMES_PER_PHONE else (lo, mid)
    bias.fill_(hi)


def make_weights(c: dict, seed: int, device) -> dict:
    """The FastSpeech2 and generator state dicts and the intensity bank,
    from the seed, on the card (every configuration choice in ``assumed``)."""
    from emotts_torch.nn.hifigan import HiFiGANGenerator
    from emotts_torch.train.fs2_trainer import build_fastspeech2

    with torch.device("meta"):
        fs2_shapes = {k: v.shape for k, v in build_fastspeech2(port_config(c)).state_dict().items()}
        voc_shapes = {k: v.shape for k, v in
                      HiFiGANGenerator(**vocoder_structure(c, kernels=False)).state_dict().items()}
    gen = card_generator(seed, device)
    fs2 = seeded_state(fs2_shapes, _fs2_rule, gen, device)
    fs2["duration_predictor.out.weight"].mul_(0.3)
    voc = seeded_state(voc_shapes, _vocoder_rule, gen, device)
    for i, u in enumerate(c["hifigan"]["upsample_rates"]):
        voc[f"up_kernels.{i}"].mul_(math.sqrt(u))
    b = c["bank"]
    bank = torch.randn((b["speakers"], b["emotions"], b["levels"], b["emotions"]),
                       generator=gen, device=device)
    calibrate_durations(c, fs2, bank, seed)
    return {"fs2": fs2, "vocoder": voc, "bank": bank}


class Record:
    """What the comparison reads of one request."""

    def __init__(self):
        self.tokens = self.log_dur = self.mel = self.mel_len = self.wave = None


class Served:
    """The program under test, with the benchmark's counters and captures."""

    def __init__(self, config: dict, seed: int, device, registry: Dict[str, Request]):
        from emotts_torch.infer.synthesize import Synthesizer

        self.c, self.device, self.registry = config, torch.device(device), registry
        self.buckets = config["fastspeech2"]["phone_buckets"]
        self.cfg = port_config(config)
        self.weights = make_weights(config, seed, device)
        w = self.weights
        self.synth = Synthesizer(self.cfg, w["fs2"], vocoder_params=w["vocoder"],
                                 intensity_bank=w["bank"].cpu().numpy(),
                                 vocoder_structure=vocoder_structure(
                                     config, kernels=self.device.type == "cuda"),
                                 device=str(self.device))
        self.want: set = set()
        self.records: Dict[int, Record] = {}
        self.longest: Optional[Request] = None
        self.fs2_calls: List[tuple] = []  # (phones per row, mel lengths on the card)
        self.engine_calls = self.dispatched = self.vocoded_frames = self.traced_calls = 0
        self.tracing = False
        self.traced_span = None  # [first, end) of fs2_calls inside the stretch
        self.traced_fs2: List[tuple] = []  # (rows, phone bucket, phones, mel lengths)
        self.traced_vocoder: List[tuple] = []  # (rows, frames)
        self._groups: List[List[Request]] = []
        self._keep: set = set()
        self._ranges: list = []
        self._entry = self.synth.synthesize_requests
        self.synth.synthesize_requests = self._synthesize_requests
        self.synth.model.register_forward_pre_hook(self._open("fs2"))
        self.synth.model.register_forward_hook(self._fs2_done)
        self.synth.vocoder.register_forward_pre_hook(self._vocoder_in)
        self.synth.vocoder.register_forward_hook(self._close)

    # -- the program's entry, wrapped ----------------------------------------
    def _synthesize_requests(self, requests, **kwargs):
        reqs = [self.registry[r["text"]] for r in requests]
        groups: Dict[int, List[Request]] = {}
        for q in reqs:
            groups.setdefault(pick_bucket(q.phones, self.buckets), []).append(q)
        self._groups = [groups[b] for b in sorted(groups)]
        self._keep = {q.id for q in reqs if q.id in self.want}
        top = max(reqs, key=lambda q: q.phones)
        if self.longest is None or top.phones > self.longest.phones:
            if self.longest is not None and self.longest.id not in self.want:
                self.records.pop(self.longest.id, None)
            self.longest = top
            self._keep.add(top.id)
        waves = self._entry(requests, **kwargs)
        for q, wave in zip(reqs, waves):
            if q.id in self._keep:
                self.records[q.id].wave = wave
        self.engine_calls += 1
        self.dispatched += len(reqs)
        self.traced_calls += self.tracing
        return waves

    def _open(self, name):
        def hook(module, args):
            if self.tracing:
                r = Range(name)
                r.__enter__()
                self._ranges.append(r)
        return hook

    def _close(self, module, args, output):
        if self._ranges:
            self._ranges.pop().__exit__(None, None, None)

    def _fs2_done(self, module, args, output):
        self._close(module, args, output)
        if not self._groups:  # a forward of the warm-up, outside any request
            return
        group, self._groups = self._groups[0], self._groups[1:]
        tokens = args[0]
        phones = np.array([q.phones for q in group])
        self.fs2_calls.append((phones, output[7]))
        if self.tracing:
            self.traced_fs2.append((tokens.shape[0], tokens.shape[1], phones, output[7]))
        for row, q in enumerate(group):
            if q.id in self._keep:
                rec = self.records.setdefault(q.id, Record())
                rec.tokens, rec.log_dur = tokens[row].clone(), output[2][row].clone()
                rec.mel, rec.mel_len = output[0][row].clone(), output[7][row].clone()

    def _vocoder_in(self, module, args):
        rows, frames = args[0].shape[0], args[0].shape[1]
        self.vocoded_frames += rows * frames
        if self.tracing:
            self.traced_vocoder.append((rows, frames))
            self._open("vocoder")(module, args)

    # -- what the harness asks of it -----------------------------------------
    def service(self, window_ms: float):
        from emotts_torch.infer.server import TTSService

        return TTSService(self.cfg, self.synth, microbatch_window_ms=window_ms,
                          device=self.device.type)

    def warm(self, vocode_rows: int, fs2_rows) -> None:
        """The shapes a cell's dispatches reach: the vocoder at every chunk
        of 1 to ``vocode_rows`` rows (each a launch plan of its own),
        FastSpeech2 at each phone bucket for the row counts ``fs2_rows``
        (between them a new batch size takes only the libraries'
        heuristics: warming all 64 measured no change in the serve cell's
        tail and cost 17 s of set-up)."""
        t = self.cfg.fastspeech2.max_mel_len
        n_mels = self.cfg.audio.n_mels
        for rows in range(1, vocode_rows + 1):
            self.synth.vocode(torch.zeros((rows, t, n_mels), device=self.device))
        for rows in fs2_rows:
            for p in self.buckets:
                ids = np.full(p, 5, np.int32)
                self.synth.synthesize_mels(ids, np.zeros(rows, np.int32),
                                           np.zeros((rows, p, self.cfg.n_emotions), np.float32))
        if self.device.type == "cuda":
            torch.cuda.synchronize()

    def trace(self, on: bool) -> None:
        """The stretch opens or closes: ranges and shapes are recorded inside."""
        if on:
            self.traced_span = [len(self.fs2_calls), None]
        elif self.tracing:
            self.traced_span[1] = len(self.fs2_calls)
        self.tracing = on

    def reset(self) -> None:
        """Forget what the warm-up counted and kept: the window starts."""
        self.records, self.longest, self.fs2_calls = {}, None, []
        self.engine_calls = self.dispatched = self.vocoded_frames = 0

    def counters(self) -> dict:
        """Content frames, and the least time of the delivered work outside
        the traced stretch (read once the window has closed)."""
        c, f = self.c, self.c["fastspeech2"]
        skip = range(*self.traced_span) if self.traced_span else range(0)
        content, least = 0, 0.0
        for i, (phones, lens) in enumerate(self.fs2_calls):
            lens = lens.cpu().numpy()
            content += int(lens.sum())
            if i in skip:
                continue
            for n, frames in zip(phones, lens):
                least += (model_flops.fastspeech2(f, c["bank"]["emotions"], c["audio"]["n_mels"],
                                                  n, frames) / peaks.PEAK_FLOPS[f["compute_dtype"]]
                          + model_flops.hifigan(c["hifigan"], c["audio"]["n_mels"], frames)
                          / peaks.PEAK_FLOPS[c["hifigan"]["dtype"]])
        return {"content_frames": content, "vocoded_frames": self.vocoded_frames,
                "engine_calls": self.engine_calls, "dispatched": self.dispatched,
                "least_time_s": least}

    def kernel_bounds(self) -> dict:
        """The traced stretch's kernel calls as the roofline counts them."""
        f, h = self.c["fastspeech2"], self.c["hifigan"]
        heads, hd, dt = f["heads"], f["head_dim"], f["compute_dtype"]
        fwd = 0.0
        for rows, p, phones, lens in self.traced_fs2:
            lens = lens.cpu().tolist()
            fwd += f["enc_num_layers"] * attention_fwd.bound(rows, p, heads, hd, phones, dt)
            fwd += f["dec_num_layers"] * attention_fwd.bound(
                rows, f["max_mel_len"], heads, hd, lens, dt)
        voc = sum(vocoder_kernels.bound(h, rows, frames, h["dtype"])
                  for rows, frames in self.traced_vocoder)
        return {"attention_fwd": fwd, "vocoder_kernels": voc, "engine_calls": self.traced_calls,
                "fs2_forwards": len(self.traced_fs2),
                "vocoder_forwards": len(self.traced_vocoder)}

    def release(self) -> None:
        """Free the program's state on the card; the captured outputs stay."""
        self.synth = None
        if self.device.type == "cuda":
            torch.cuda.empty_cache()


# -- the comparison ------------------------------------------------------------


def _intensity(bank, q: Request, n: int, p: int) -> torch.Tensor:
    out = torch.zeros((p, bank.shape[-1]), device=bank.device)
    if q.emotion != 0:
        out[:n] = bank[q.speaker, q.emotion, q.level]
    return out


class Reference:
    def __init__(self, config: dict, weights: dict, fs2_precision=FP32, vocoder_precision=FP32):
        f = config["fastspeech2"]
        self.c, self.w = config, weights
        self.fs2 = ReferenceFS2(weights["fs2"], dict(layers=f["enc_num_layers"], heads=f["heads"],
                                                     ln_eps=f["ln_eps"]), fs2_precision)
        self.gen = ReferenceGenerator(weights["vocoder"], config["hifigan"], vocoder_precision)
        self.prons = pronunciations()

    def inputs(self, q: Request):
        ids = phone_ids(q.text, self.prons)
        p = pick_bucket(len(ids), self.c["fastspeech2"]["phone_buckets"])
        dev = self.w["bank"].device
        tokens = torch.zeros(p, dtype=torch.long, device=dev)
        tokens[:len(ids)] = torch.tensor(ids, device=dev)
        return tokens, _intensity(self.w["bank"], q, len(ids), p)

    def run(self, q: Request, durations=None):
        tokens, inten = self.inputs(q)
        spk = torch.tensor([q.speaker], device=tokens.device)
        dur = None if durations is None else durations[None]
        mel, log_dur, lens = self.fs2(tokens[None], spk, inten[None], dur,
                                      self.c["fastspeech2"]["max_mel_len"])
        return tokens, mel[0], log_dur[0], lens[0]


def control_record(ref_ctrl: Reference, q: Request) -> Record:
    """The control in the program's place: the reference one precision
    below the configuration (FastSpeech2 in fp8, the generator in TF32)."""
    rec = Record()
    rec.tokens, rec.mel, rec.log_dur, rec.mel_len = ref_ctrl.run(q)
    pcm = pcm16(ref_ctrl.gen(rec.mel[None]))[0]
    hop = ref_ctrl.c["audio"]["hop_length"]
    rec.wave = (pcm[:int(rec.mel_len) * hop].float() / 32767.0).cpu().numpy()
    return rec


def judge(config: dict, weights: dict, requests: List[Request], records: Dict[int, Record]) -> dict:
    """The readings of the comparison (see the module's notes)."""
    ref = Reference(config, weights)
    hop = config["audio"]["hop_length"]
    out = dict(missing=0, phone_mismatch=0, length_mismatch=0, duration_gap_frames=0.0,
               pcm_max_step=0, same_durations=0)
    mel_err, pcm_rel = [], []  # per request: the mel's (squared error, squared reference); PCM's error
    for q in requests:
        rec = records.get(q.id)
        if rec is None or rec.wave is None or rec.mel is None:
            out["missing"] += 1
            continue
        tokens, _ = ref.inputs(q)
        if tokens.shape != rec.tokens.shape or not torch.equal(tokens, rec.tokens.long()):
            out["phone_mismatch"] += 1
            continue
        valid = tokens != 0
        d_prog = torch.round(torch.clamp(torch.expm1(rec.log_dur.float()), min=0.0)).long() * valid
        _, mel_ref, log_dur_ref, len_ref = ref.run(q, d_prog)
        e_ref = torch.clamp(torch.expm1(log_dur_ref), min=0.0)
        gap = ((d_prog - e_ref).abs() - 0.5).clamp(min=0.0)[valid].max()
        out["duration_gap_frames"] = max(out["duration_gap_frames"], float(gap))
        out["same_durations"] += int(torch.equal(torch.round(e_ref).long() * valid, d_prog))
        n = int(rec.mel_len)
        wave = np.asarray(rec.wave)
        if n != int(len_ref) or wave.shape[0] != n * hop:
            out["length_mismatch"] += 1
        n = min(n, int(len_ref), wave.shape[0] // hop)
        diff = rec.mel[:n].float() - mel_ref[:n]
        mel_err.append((float(diff.pow(2).sum()), float(mel_ref[:n].pow(2).sum())))
        pcm_ref = pcm16(ref.gen(rec.mel[None].float()))[0, :n * hop].cpu().numpy().astype(np.int64)
        pcm_prog = np.rint(wave[:n * hop].astype(np.float64) * 32767.0).astype(np.int64)
        out["pcm_max_step"] = max(out["pcm_max_step"], int(np.abs(pcm_ref - pcm_prog).max()))
        pcm_text = pcm16(ref.gen(mel_ref[None]))[0, :n * hop].cpu().numpy().astype(np.float64)
        pcm_rel.append(np.sqrt(np.sum((pcm_prog - pcm_text) ** 2) / max(np.sum(pcm_text ** 2), 1e-12)))
    e, r = np.array(mel_err).reshape(-1, 2).T
    out["mel_rel_rms"] = float(np.sqrt(e.sum() / max(r.sum(), 1e-12)))
    out["mel_rel_rms_worst"] = float(np.sqrt(e / np.maximum(r, 1e-12)).max(initial=0.0))
    out["pcm_rel_rms"] = float(np.median(pcm_rel)) if pcm_rel else 0.0
    out["pcm_rel_rms_worst"] = float(max(pcm_rel, default=0.0))
    out["compared"] = len(requests) - out["missing"]
    return out


def control_records(config: dict, weights: dict, requests: List[Request]) -> Dict[int, Record]:
    ctrl = Reference(config, weights, FP8, TF32)
    return {q.id: control_record(ctrl, q) for q in requests}


def check(cell, out) -> dict:
    served = out["system"]
    return judge(cell.config, served.weights, out["compare"], served.records)


def control_check(cell, seed: int, seconds: float, device) -> dict:
    """The control in the program's place over the requests a window of the
    cell would compare."""
    requests = cell.kind().control_requests(cell, seed, seconds)
    weights = make_weights(cell.config, seed, device)
    return judge(cell.config, weights, requests, control_records(cell.config, weights, requests))
