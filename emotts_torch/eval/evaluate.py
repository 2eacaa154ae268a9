"""Objective evaluation of a trained FastSpeech2 experiment on the held-out
split: teacher-forced MCD, free-running (predicted-duration) DTW-MCD,
duration accuracy, and optional F0 accuracy through the vocoder.

Counterpart of ``emotts/eval/evaluate.py`` (the reference's only evaluation
is visual, SURVEY.md §4).  The models run in fp32 on the device, batched and
bucketed like the trainers: on a CUDA device FastSpeech2 and the frozen
intensity extractor go through the fused attention kernel
(``resolve_fused_attention``) and the vocoder through the MRF and ResBlock
kernels, as ``load_synthesizer`` builds it.  Metrics are computed on the
host per utterance and aggregated per (speaker, emotion) into eval.json.
"""

from __future__ import annotations

import json
import os
from collections import defaultdict
from typing import Dict, Mapping, Optional

import numpy as np
import torch

from emotts_torch.data.datasets import FS2Dataset, collate_fs2
from emotts_torch.data.loader import BucketLoader
from emotts_torch.eval.metrics import (
    dtw_alignment,
    duration_metrics,
    f0_metrics,
    mcd,
    mel_cepstra,
)
from emotts_torch.infer.synthesize import build_vocoder, kernel_vocoder_structure
from emotts_torch.nn.length_regulator import segment_mean
from emotts_torch.train.checkpoint import load_best_params
from emotts_torch.train.fs2_trainer import (
    batch_to_device,
    build_fastspeech2,
    build_intensity_extractor,
    extractor_params_from_rank,
)
from emotts_torch.train.rank_trainer import resolve_device
from emotts_torch.utils.config import Config


class Evaluator:
    """``vocoder_params``: the reference's params tree (e.g. from
    ``maybe_load_vocoder``) or a state_dict with ``vocoder_structure``;
    enables the F0 rows.  ``fs2_exp`` / ``rank_exp`` default to the
    experiment directories ``load_synthesizer`` reads; their ``best/``
    exports supply FastSpeech2 and the extractor."""

    def __init__(self, cfg: Config, fs2_exp: Optional[str] = None,
                 rank_exp: Optional[str] = None,
                 vocoder_params: Optional[Mapping] = None,
                 vocoder_structure: Optional[Dict] = None, device="cuda"):
        self.cfg = cfg
        self.device = resolve_device(device)
        # fp32 means fp32: no TF32 in the library's products and convs
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        self.vocoder = None
        if vocoder_params is not None:
            if vocoder_structure is None:
                vocoder_structure = kernel_vocoder_structure(
                    cfg, vocoder_params, self.device)
            self.vocoder = build_vocoder(cfg, vocoder_params, vocoder_structure,
                                         self.device)
        fs2_exp = fs2_exp or os.path.join(
            cfg.data.experiment_path, "fastspeech2", cfg.inference.fs2_exp
        )
        rank_exp = rank_exp or os.path.join(
            cfg.data.experiment_path, "rank_model", cfg.inference.rank_exp
        )
        self.fs2_exp = fs2_exp
        self.model = build_fastspeech2(cfg, dtype=torch.float32, device=self.device)
        self.model.load_state_dict(load_best_params(fs2_exp))
        self.model.to(self.device).eval()
        self.extractor = build_intensity_extractor(cfg, dtype=torch.float32,
                                                   device=self.device)
        self.extractor.load_state_dict(
            extractor_params_from_rank(load_best_params(rank_exp)))
        self.extractor.to(self.device).eval()

    # ------------------------------------------------------------------

    def _conditioned(self, batch: Dict, rep: Optional[np.ndarray]):
        """(device batch, the FS2 keyword arguments): conditioning is ``rep``
        (B, P, dim), or else each utterance's own extracted representation
        (the extractor's frames averaged over its phones, ``segment_mean``)."""
        b = batch_to_device(batch, self.device)
        if rep is None:
            frames = self.extractor(b["rank_x"], b["mel_len"], b["emotions"])
            cond = segment_mean(frames, b["durations"])
        else:
            cond = torch.from_numpy(np.asarray(rep, np.float32)).to(self.device)
        return b, dict(intensity=cond, max_mel_len=b["mel"].shape[1])

    def _tf(self, b: Dict, common: Dict):
        return self.model(b["phonemes"], b["speakers"], b["durations"], b["pitch"],
                          b["energy"], **common)

    @torch.inference_mode()
    def teacher_forced(self, batch: Dict, rep: Optional[np.ndarray] = None):
        """The teacher-forced pass over one collated batch, as host arrays:
        (PostNet mel, log-durations, mel lengths)."""
        b, common = self._conditioned(batch, rep)
        tf = self._tf(b, common)
        return tf[1].cpu().numpy(), tf[2].cpu().numpy(), tf[7].cpu().numpy()

    @torch.inference_mode()
    def infer(self, batch: Dict, rep: Optional[np.ndarray] = None):
        """Teacher-forced and free-running passes over one collated batch:
        host arrays (tf PostNet mel, tf log-durations, free PostNet mel,
        free mel lengths), conditioned as :meth:`_conditioned` says."""
        b, common = self._conditioned(batch, rep)
        tf = self._tf(b, common)
        free = self.model(b["phonemes"], b["speakers"], **common)
        return (tf[1].cpu().numpy(), tf[2].cpu().numpy(),
                free[1].cpu().numpy(), free[7].cpu().numpy())

    # ------------------------------------------------------------------

    def _f0_row(self, batch, i: int, fr_mel, n_free: int,
                path_ref: np.ndarray, path_syn: np.ndarray) -> Dict:
        """F0 accuracy of the free-running synthesis through the vocoder vs
        the ground-truth waveform, DTW-ALIGNED via the mel cepstral path
        (frame-by-frame comparison would mostly measure duration drift —
        same reason the free-running MCD uses DTW).  Both tracks use the
        in-repo DIO chain; the GT audio is trimmed to its TextGrid speech
        span like the features were.  The vocoder runs on the full
        bucket-padded mel."""
        from pathlib import Path

        from emotts_torch.audio.f0 import dio, stonemask
        from emotts_torch.audio.textgrid import process_textgrid
        from emotts_torch.audio.wavio import load_wav, trim_audio

        cfg = self.cfg
        sr, hop = cfg.audio.sampling_rate, cfg.audio.hop_length
        wav_path = Path(str(batch["wavs"][i]))
        tg = (Path(cfg.data.textgrid_path) / wav_path.parent.name
              / f"{wav_path.stem}.TextGrid")
        if not tg.exists():
            return {}
        _, _, t0, t1 = process_textgrid(str(tg), sr, hop, cfg.data.sil_phones)
        ref = trim_audio(load_wav(str(wav_path), sr), t0, t1, sr)
        with torch.inference_mode():
            mel = torch.from_numpy(np.ascontiguousarray(fr_mel[None])).to(self.device)
            syn = self.vocoder(mel).float().cpu().numpy().reshape(-1)[: n_free * hop]

        def track(y):
            f0, times = dio(y.astype(np.float64), sr,
                            frame_period=hop / sr * 1000.0)
            return stonemask(y.astype(np.float64), f0, times, sr)

        f0_ref, f0_syn = track(ref), track(syn)
        if len(f0_ref) == 0 or len(f0_syn) == 0:
            return {}
        pi = np.clip(path_ref, 0, len(f0_ref) - 1)
        pj = np.clip(path_syn, 0, len(f0_syn) - 1)
        rmse, vuv = f0_metrics(f0_ref[pi], f0_syn[pj])
        return {"f0_rmse_hz": rmse, "vuv_error_rate": vuv}

    def _prototype_rep(self, batch, intensity_bank: np.ndarray,
                       contrast: float, level: Optional[int]) -> np.ndarray:
        """Phone-level conditioning from the bucketizer's prototype bank —
        the same mechanism synthesis uses (reference
        fastspeech2/inference.py:12-21; neutral → zeros), with the
        prototypes exaggerated around their per-cell level-mean as
        ``m + contrast·(p − m)`` (``--intensity-scale``'s mechanism).
        Returns (B, T_phon, dim) float32."""
        bank = np.asarray(intensity_bank, np.float32)
        lv = bank.shape[2] // 2 if level is None else int(level)
        b, t_phon = batch["phonemes"].shape[:2]
        rep = np.zeros((b, t_phon, bank.shape[-1]), np.float32)
        for i in range(b):
            e = int(batch["emotions"][i])
            if e == 0:
                continue
            s = int(batch["speakers"][i])
            p = bank[s, e, lv]
            m = bank[s, e].mean(0)
            rep[i, : int(batch["phon_len"][i])] = m + contrast * (p - m)
        return rep

    def loader(self, split: str = "valid") -> BucketLoader:
        """The split in frame buckets of ``train_fs2.batch_size``, in file
        order, every utterance kept."""
        cfg = self.cfg
        return BucketLoader(
            FS2Dataset(cfg, split),
            buckets=cfg.bucketing.frame_buckets,
            batch_size=cfg.train_fs2.batch_size,
            collate=lambda ex, fb: collate_fs2(
                ex, pick_phone_bucket(ex, cfg), fb
            ),
            shuffle=False,
            seed=0,
            drop_last=False,
        )

    def run(self, split: str = "valid", max_batches: Optional[int] = None,
            out_path: Optional[str] = None, f0_max_utts: int = 32,
            conditioning: str = "own",
            intensity_bank: Optional[np.ndarray] = None,
            contrast: float = 1.0,
            proto_level: Optional[int] = None) -> Dict:
        """``conditioning="own"`` (default) conditions each utterance on its
        own extracted intensity representation (the training-time bridge);
        ``conditioning="prototype"`` conditions on the intensity-bank
        prototype for the utterance's (speaker, emotion) at ``proto_level``
        (default: middle level) exaggerated by ``contrast`` — measuring the
        objective quality (MCD/F0/VUV vs ground truth) of the USER-facing
        synthesis path at a given contrast operating point."""
        cfg = self.cfg
        if conditioning not in ("own", "prototype"):
            raise ValueError(f"unknown conditioning mode {conditioning!r}")
        if conditioning == "prototype" and intensity_bank is None:
            raise ValueError("conditioning='prototype' needs intensity_bank")
        per_utt = []
        n_f0 = 0  # F0 rows actually produced (the f0_max_utts budget)
        for bi, batch in enumerate(self.loader(split).epoch(0)):
            if max_batches is not None and bi >= max_batches:
                break
            rep = (self._prototype_rep(batch, intensity_bank, contrast,
                                       proto_level)
                   if conditioning == "prototype" else None)
            tf_mel, tf_logdur, fr_mel, fr_lens = self.infer(batch, rep)
            b = batch["mel"].shape[0]
            for i in range(b):
                t = int(batch["mel_len"][i])
                p = int(batch["phon_len"][i])
                if t == 0 or p == 0:
                    continue
                ref = np.asarray(batch["mel"][i, :t])
                valid = np.zeros(batch["durations"].shape[1], np.float32)
                valid[:p] = 1.0
                mae, rel = duration_metrics(
                    np.asarray(batch["durations"][i], np.float32),
                    np.asarray(tf_logdur[i], np.float32),
                    valid,
                )
                n_free = int(fr_lens[i])
                row = {
                    "speaker": cfg.data.speakers[int(batch["speakers"][i])],
                    "emotion": cfg.data.emotions[int(batch["emotions"][i])],
                    "mcd_teacher_forced": mcd(
                        mel_cepstra(ref), mel_cepstra(np.asarray(tf_mel[i, :t]))
                    ),
                    "duration_mae_frames": mae,
                    "duration_total_rel_err": rel,
                }
                if n_free > 0:
                    path_ref, path_syn, dtw_val = dtw_alignment(
                        ref, np.asarray(fr_mel[i, :n_free])
                    )
                    row["mcd_dtw_free_running"] = dtw_val
                    if self.vocoder is not None and n_f0 < f0_max_utts:
                        f0_row = self._f0_row(
                            batch, i, np.asarray(fr_mel[i]), n_free,
                            path_ref, path_syn,
                        )
                        if f0_row:
                            n_f0 += 1
                        row.update(f0_row)
                per_utt.append(row)

        report = aggregate(per_utt)
        report["conditioning"] = conditioning
        if conditioning == "prototype":
            report["contrast"] = contrast
            report["proto_level"] = (proto_level if proto_level is not None
                                     else int(intensity_bank.shape[2] // 2))
        if out_path is None:
            out_path = os.path.join(self.fs2_exp, "eval.json")
        with open(out_path, "w") as f:
            json.dump(report, f, indent=2)
        report["path"] = out_path
        return report


def pick_phone_bucket(examples, cfg: Config) -> int:
    from emotts_torch.data.datasets import pick_bucket

    need = max(len(e.phonemes) for e in examples)
    pb = pick_bucket(need, cfg.bucketing.phone_buckets)
    return pb if pb > 0 else need


def aggregate(per_utt, n_boot: int = 1000, seed: int = 0) -> Dict:
    """Mean of every numeric metric overall and per (speaker, emotion),
    plus a bootstrap 95% CI of each overall mean — so "within eval noise"
    is a number, not a shrug (campaign stage-to-stage deltas are judged
    against these intervals)."""
    def means(rows):
        keys = sorted({k for r in rows for k in r if isinstance(r[k], float)})
        return {
            k: float(np.mean([r[k] for r in rows if k in r])) for k in keys
        }

    groups = defaultdict(list)
    for r in per_utt:
        groups[f"{r['speaker']}/{r['emotion']}"].append(r)
    return {
        "n_utterances": len(per_utt),
        "overall": means(per_utt) if per_utt else {},
        "overall_ci95": bootstrap_ci(per_utt, n_boot, seed) if per_utt else {},
        "by_speaker_emotion": {k: means(v) for k, v in sorted(groups.items())},
    }


def bootstrap_ci(per_utt, n_boot: int = 1000, seed: int = 0) -> Dict:
    """{metric: [lo, hi]} — percentile-bootstrap 95% CI of the mean over
    utterances, per numeric metric (metrics present on a subset of rows,
    e.g. the F0 budget, bootstrap over that subset)."""
    rng = np.random.default_rng(seed)
    keys = sorted({k for r in per_utt for k in r if isinstance(r[k], float)})
    out = {}
    for k in keys:
        vals = np.asarray([r[k] for r in per_utt if k in r], np.float64)
        if len(vals) < 2:
            continue
        idx = rng.integers(0, len(vals), size=(n_boot, len(vals)))
        boot_means = vals[idx].mean(axis=1)
        lo, hi = np.percentile(boot_means, [2.5, 97.5])
        out[k] = [float(lo), float(hi)]
    return out


def evaluate_f0_through_vocoder(
    cfg: Config, ref_wav: np.ndarray, syn_wav: np.ndarray
) -> Dict:
    """Optional F0 comparison between a reference and a synthesized waveform
    using the framework's own DIO+StoneMask chain (emotts_torch/audio/f0.py)."""
    from emotts_torch.audio.f0 import dio, stonemask

    def track(y):
        f0, times = dio(
            y.astype(np.float64), cfg.audio.sampling_rate,
            frame_period=cfg.audio.hop_length / cfg.audio.sampling_rate * 1000.0,
        )
        return stonemask(y.astype(np.float64), f0, times,
                         cfg.audio.sampling_rate)

    rmse, vuv = f0_metrics(track(ref_wav), track(syn_wav))
    return {"f0_rmse_hz": rmse, "vuv_error_rate": vuv}
