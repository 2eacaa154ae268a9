"""Intensity-control efficacy evaluation — measuring the TITLE capability.

The reference's one demonstrated deliverable is that bucketized intensity
control *works* (assets/intensities.png, readme.md:102-125; prototypes built
at rank_model/inference.py:92-118) — but it never measures it.  This module
closes the loop quantitatively:

  1. synthesize the full (speaker × emotion × level) sweep for one or more
     sentences with the trained FastSpeech2 + intensity-prototype bank;
  2. vocode and re-extract mel+pitch+energy from the SYNTHESIZED audio with
     the framework's own feature chain (emotts/audio/{mel,f0}.py), z-normed
     with the training-corpus stats.json — i.e. exactly the 82-channel input
     the rank model was trained on;
  3. score every synthesized utterance with the FROZEN rank model (λ≡1, the
     bucketizer's convention) and report:
       * **intensity monotonicity** — the fraction of (text, speaker,
         emotion) cells whose level-0/1/2 rank scores are strictly
         increasing, plus pairwise order accuracy (the probability that a
         higher requested level scores higher);
       * **emotion separation** — silhouette of the pooled intensity
         embeddings h over emotion classes on synthesized audio (the
         measurable counterpart of the reference's t-SNE figures).

If the synthesizer has no vocoder, the synthesized MEL feeds the rank model
directly with pitch/energy channels zeroed (= their z-scored training mean);
the report labels which path produced it (``feature_path``).

Counterpart of ``emotts/eval/intensity_eval.py``.  The sweep runs through
the port's ``Synthesizer`` (its attention and vocoder kernels on a CUDA
device, as it is built) and the scorer runs the rank model in fp32 through
the attention kernel there; feature re-extraction and the metrics are the
reference's host numpy.  The silhouette needs scikit-learn and reads None
where it is not installed, as in the reference.
"""

from __future__ import annotations

import json
import os
from collections import defaultdict
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from emotts_torch.audio.f0 import extract_f0, interpolate_unvoiced
from emotts_torch.audio.mel import mel_energy_np
from emotts_torch.data.datasets import pick_bucket
from emotts_torch.train.rank_trainer import build_rank_model, resolve_device
from emotts_torch.utils.config import Config

# Minimum prototype spread (mean pairwise L2 between a cell's level
# prototypes as a fraction of their mean norm — ``_prototype_spread``) below
# which the ordering metrics measure nothing: when the bucketizer found no
# intensity axis in the training corpus, level prototypes are near-identical
# and strict monotonicity / pairwise order accuracy sit at their chance
# levels (1/6 and 0.5 for 3 levels) REGARDLESS of FS2 conditioning quality.
# A corpus with no intra-class intensity variation collapses to a few
# percent; a usable axis sits well above this floor.
PROTOTYPE_SPREAD_FLOOR = 0.05


def load_feature_stats(cfg: Config) -> Dict:
    """stats.json written by preprocessing: per (speaker, emotion)
    ``{"pitch": [min, max, mean, std], "energy": [...]}``."""
    path = os.path.join(cfg.data.preprocessed_path, "stats.json")
    with open(path) as f:
        return json.load(f)


def prototype_spread(bank) -> Optional[Dict]:
    """How distinguishable the level prototypes are, per the bank itself:
    mean pairwise L2 distance between a cell's level prototypes, as a
    fraction of the cell's mean prototype norm (averaged over all
    non-neutral (speaker, emotion) cells).  A spread of a few percent
    means the bucketizer found no usable intensity axis in the training
    corpus — ordering metrics are then capped at chance regardless of
    FS2 quality (the --contrast diagnostic separates the two)."""
    if bank is None:
        return None
    bank = np.asarray(bank, np.float64)  # (n_spk, n_emo, n_lv, dim)
    fracs = []
    for s in range(bank.shape[0]):
        for e in range(1, bank.shape[1]):
            protos = bank[s, e]  # (n_lv, dim)
            if protos.shape[0] < 2:
                continue  # single level: no pairwise distances to take
            norms = np.linalg.norm(protos, axis=-1)
            if norms.mean() < 1e-12:
                continue
            d = [np.linalg.norm(protos[i] - protos[j])
                 for i in range(len(protos))
                 for j in range(i + 1, len(protos))]
            fracs.append(float(np.mean(d) / norms.mean()))
    if not fracs:
        return None
    return {
        "mean_pairwise_over_norm": round(float(np.mean(fracs)), 5),
        "min": round(float(np.min(fracs)), 5),
        "max": round(float(np.max(fracs)), 5),
    }


def spread_verdict(
    spread: Optional[Dict], significance: Optional[Dict] = None
) -> tuple:
    """Gate the ordering metrics on prototype distinguishability: returns
    ``("measured", None)`` when the bank's level prototypes are far enough
    apart to condition on, else ``("no-intensity-axis", <explanation>)`` —
    chance-level ordering numbers must not read as a measurement of the
    conditioning path.

    When the bucketizer's ``intensity_meta.json`` sidecar is available
    (``significance``, emotts_torch/infer/bucketize.py::spread_significance), the
    gate additionally requires the OBSERVED sorted-bank spread to exceed the
    95th percentile of the random-bucketing null — absolute spread alone is
    scale-dependent (small cells produce large incidental spread under any
    ordering)."""
    no_axis = "no-intensity-axis"
    chance_note = (
        "the training corpus gave the bucketizer no usable intensity "
        "axis, so the ordering metrics are expected to sit at chance and "
        "do NOT measure the conditioning path (use --contrast to probe "
        "the path itself)"
    )
    if spread is None or (
        spread["mean_pairwise_over_norm"] < PROTOTYPE_SPREAD_FLOOR
    ):
        val = None if spread is None else spread["mean_pairwise_over_norm"]
        return no_axis, (
            f"level prototypes are near-identical (spread {val} < floor "
            f"{PROTOTYPE_SPREAD_FLOOR}): " + chance_note
        )
    if (
        significance is not None
        and significance.get("observed") is not None
        and significance.get("null_p95") is not None
        and significance["observed"] <= significance["null_p95"]
    ):
        return no_axis, (
            f"sorted-bank spread {significance['observed']} does not exceed "
            f"the random-bucketing null (p95 {significance['null_p95']}): "
            + chance_note
        )
    return "measured", None


class RankScorer:
    """Frozen rank-model scorer for arbitrary 82-channel feature rows.

    Runs the rank model in fp32 with λ≡1 (the bucketizer's convention,
    reference rank_model/inference.py:73) over variable-length rows,
    bucketed and batched like training.  ``rank_params``: the RankModel
    state_dict (a rank experiment's ``best/`` export)."""

    def __init__(self, cfg: Config, rank_params: Dict[str, torch.Tensor],
                 device="cuda"):
        self.cfg = cfg
        self.device = resolve_device(device)
        self.rank_model = build_rank_model(cfg, dtype=torch.float32,
                                           device=self.device)
        self.rank_model.load_state_dict(rank_params)
        self.rank_model.to(self.device).eval()

    @torch.inference_mode()
    def _rank_fn(self, x: np.ndarray, emotions: np.ndarray, lengths: np.ndarray):
        x = torch.from_numpy(x).to(self.device)
        emotions = torch.from_numpy(emotions).long().to(self.device)
        lengths = torch.from_numpy(lengths).long().to(self.device)
        lambdas = torch.ones((2, x.shape[0]), device=self.device)
        preds = self.rank_model(x, x, emotions, lengths, lambdas)
        # with λ≡1 branch i consumes the pure input: I_i, h_i, r_i
        return preds[2].cpu().numpy(), preds[4].cpu().numpy(), preds[6].cpu().numpy()

    def score_rows(self, xs: List[np.ndarray], emotions: List[int]):
        """Returns (scores (N,), pooled_h (N, n_emo))."""
        cfg = self.cfg
        order = sorted(range(len(xs)), key=lambda i: len(xs[i]))
        scores = np.zeros((len(xs),), np.float32)
        pooled = np.zeros((len(xs), cfg.n_emotions), np.float32)
        max_bucket = max(cfg.bucketing.frame_buckets)
        batch_size = max(1, cfg.train_rank.batch_size)
        groups: Dict[int, List[int]] = defaultdict(list)
        for i in order:
            t = min(len(xs[i]), max_bucket)
            fb = pick_bucket(t, cfg.bucketing.frame_buckets)
            groups[fb if fb > 0 else t].append(i)
        for fb, idxs in sorted(groups.items()):
            for s in range(0, len(idxs), batch_size):
                chunk = idxs[s : s + batch_size]
                x = np.zeros((batch_size, fb, cfg.audio.n_mels + 2),
                             np.float32)
                lens = np.zeros((batch_size,), np.int32)
                emos = np.zeros((batch_size,), np.int32)
                for row, i in enumerate(chunk):
                    t = min(len(xs[i]), fb)
                    x[row, :t] = xs[i][:t]
                    lens[row] = t
                    emos[row] = emotions[i]
                _, h, r = self._rank_fn(x, emos, lens)
                for row, i in enumerate(chunk):
                    scores[i] = float(r[row])
                    pooled[i] = np.asarray(h[row], np.float32)
        return scores, pooled


class IntensityEfficacyEvaluator:
    """Scores synthesized audio with the frozen rank model.

    ``synthesizer`` is an ``emotts_torch.infer.synthesize.Synthesizer`` with
    the intensity bank loaded; ``rank_params`` the frozen rank-model
    state_dict (the same checkpoint the bucketizer used), scored on the
    synthesizer's device; ``stats`` the training stats.json dict
    (``load_feature_stats``).
    """

    def __init__(self, cfg: Config, synthesizer, rank_params, stats: Dict,
                 bank_meta: Optional[Dict] = None):
        self.cfg = cfg
        self.synth = synthesizer
        self.stats = stats
        self.bank_meta = bank_meta  # bucketizer's intensity_meta.json
        self._scorer = RankScorer(cfg, rank_params, device=synthesizer.device)

    # -- feature re-extraction from synthesized outputs -------------------

    def _znorm(self, values: np.ndarray, spk: str, emo: str, field: str
               ) -> np.ndarray:
        _, _, mean, std = self.stats[spk][emo][field]
        return (values - mean) / (std if std > 0 else 1.0)

    def _x_from_wav(self, wav: np.ndarray, spk: str, emo: str) -> np.ndarray:
        """82-channel rank input from a synthesized float waveform, through
        the SAME chain preprocessing uses on real recordings."""
        cfg = self.cfg
        mel, energy = mel_energy_np(wav.astype(np.float32), cfg.audio)
        pitch = interpolate_unvoiced(
            extract_f0(
                wav.astype(np.float64), cfg.audio.hop_length,
                cfg.audio.sampling_rate,
            )
        )
        t = min(mel.shape[1], len(pitch), len(energy))  # mel is (n_mels, T)
        if t == 0:
            return np.zeros((0, cfg.audio.n_mels + 2), np.float32)
        pitch = self._znorm(pitch[:t].astype(np.float32), spk, emo, "pitch")
        energy = self._znorm(energy[:t].astype(np.float32), spk, emo, "energy")
        return np.concatenate(
            [mel[:, :t].T, pitch[:, None], energy[:, None]], axis=1
        ).astype(np.float32)

    def _x_from_mel(self, mel: np.ndarray) -> np.ndarray:
        """Vocoder-less fallback: synthesized mel + zeroed (= mean-valued)
        pitch/energy channels."""
        t = len(mel)
        pad = np.zeros((t, 2), np.float32)
        return np.concatenate([mel, pad], axis=1).astype(np.float32)

    # -- rank-model scoring ------------------------------------------------

    def _score_rows(self, xs: List[np.ndarray], emotions: List[int]):
        """Batch variable-length rows through the rank forward, bucketed
        like training.  Returns (scores (N,), pooled_h (N, n_emo))."""
        return self._scorer.score_rows(xs, emotions)

    # -- the sweep ----------------------------------------------------------

    def _conditioning(
        self, s: int, e: int, lv: float, n_phones: int, contrast: float
    ) -> np.ndarray:
        """Level conditioning for one combo.  ``contrast`` exaggerates the
        prototypes around their per-(speaker, emotion) level-mean:
        ``m + contrast * (p_lv - m)`` — a DIAGNOSTIC separating "the FS2
        conditioning path does not respond" from "the rank model's buckets
        are too close to measure" (a shallow-trained rank model yields
        near-identical level prototypes — the condition ``_prototype_spread``
        quantifies and the report's ``verdict`` field gates on).
        ``contrast=1`` is exactly the production prototype bank."""
        if contrast == 1.0 or e == 0 or self.synth.intensity_bank is None:
            return self.synth.intensity_for(s, e, lv, n_phones)
        p = self.synth._proto(s, e, lv)
        m = np.asarray(self.synth.intensity_bank[s, e], np.float32).mean(0)
        amp = m + contrast * (p - m)
        return np.broadcast_to(
            amp, (n_phones, len(amp))
        ).astype(np.float32)

    def run(
        self,
        texts: Optional[Sequence[str]] = None,
        levels: Optional[Sequence[float]] = None,
        out_path: Optional[str] = None,
        include_neutral: bool = True,
        contrast: float = 1.0,
    ) -> Dict:
        cfg = self.cfg
        texts = list(texts) if texts else [cfg.inference.text]
        if levels is None:
            levels = list(range(cfg.inference.bucket_size))
        levels = [float(v) for v in levels]
        speakers = list(cfg.data.speakers)
        emotions = list(cfg.data.emotions)
        use_vocoder = self.synth.vocoder_params is not None
        hop = cfg.audio.hop_length

        rows = []  # dicts: text_i, spk, emo, level, x
        for text_i, text in enumerate(texts):
            ids = self.synth.text_to_phoneme_ids(text)
            combos = []
            for s in range(len(speakers)):
                for e in range(len(emotions)):
                    if e == 0:
                        if include_neutral:
                            combos.append((s, e, 0.0))
                        continue
                    combos.extend((s, e, lv) for lv in levels)
            spk_arr = np.array([s for s, _, _ in combos], np.int32)
            inten = np.stack(
                [
                    self._conditioning(s, e, lv, len(ids), contrast)
                    for s, e, lv in combos
                ]
            )
            mel, lens = self.synth.synthesize_mels(ids, spk_arr, inten)
            lens = lens.cpu().numpy()
            if use_vocoder:
                pcm = self.synth.vocode(mel)
                t_max = max(1, int(lens.max())) * hop
                wav_np = pcm[:, :t_max].cpu().numpy().astype(np.float32) / 32767.0
            else:
                mel_np = mel.float().cpu().numpy()
            for i, (s, e, lv) in enumerate(combos):
                n = int(lens[i])
                if n <= 0:
                    continue
                if use_vocoder:
                    x = self._x_from_wav(
                        wav_np[i, : n * hop], speakers[s], emotions[e]
                    )
                else:
                    x = self._x_from_mel(mel_np[i, :n])
                if len(x) == 0:
                    continue
                rows.append(
                    dict(text_i=text_i, spk=s, emo=e, level=lv, x=x)
                )

        scores, pooled = self._score_rows(
            [r["x"] for r in rows], [r["emo"] for r in rows]
        )
        for r, sc in zip(rows, scores):
            r["score"] = float(sc)

        report = self._metrics(rows, pooled, levels)
        report["n_texts"] = len(texts)
        report["levels"] = levels
        report["contrast"] = contrast
        report["prototype_spread"] = self._prototype_spread()
        report["prototype_spread_floor"] = PROTOTYPE_SPREAD_FLOOR
        report["prototype_spread_significance"] = self.bank_meta
        verdict, note = spread_verdict(
            report["prototype_spread"], self.bank_meta
        )
        report["verdict"] = verdict
        if note:
            report["verdict_note"] = note
        report["feature_path"] = (
            "vocoded_audio" if use_vocoder else "mel_only(pitch/energy zeroed)"
        )
        if out_path:
            with open(out_path, "w") as f:
                json.dump(report, f, indent=2)
            report["path"] = out_path
        return report

    def _prototype_spread(self) -> Optional[Dict]:
        return prototype_spread(self.synth.intensity_bank)

    # -- metrics -------------------------------------------------------------

    def _metrics(self, rows, pooled: np.ndarray, levels) -> Dict:
        cfg = self.cfg
        speakers = list(cfg.data.speakers)
        emotions = list(cfg.data.emotions)

        # (text, spk, emo) -> {level: score}
        cells: Dict = defaultdict(dict)
        for r in rows:
            if r["emo"] == 0:
                continue
            cells[(r["text_i"], r["spk"], r["emo"])][r["level"]] = r["score"]

        strict = 0
        n_cells = 0
        pair_ok = pair_tot = 0
        cell_strict_flags: List[float] = []
        cell_pair_acc: List[float] = []
        for key, by_level in cells.items():
            if len(by_level) < 2:
                continue
            seq = [by_level[lv] for lv in sorted(by_level)]
            n_cells += 1
            is_mono = all(a < b for a, b in zip(seq, seq[1:]))
            strict += is_mono
            cell_strict_flags.append(float(is_mono))
            ok = tot = 0
            for i in range(len(seq)):
                for j in range(i + 1, len(seq)):
                    pair_tot += 1
                    tot += 1
                    pair_ok += seq[i] < seq[j]
                    ok += seq[i] < seq[j]
            cell_pair_acc.append(ok / tot)

        # per-(spk,emo) mean score per level across texts
        agg: Dict = defaultdict(lambda: defaultdict(list))
        for (_, s, e), by_level in cells.items():
            for lv, sc in by_level.items():
                agg[(s, e)][lv].append(sc)
        by_cell = {}
        cell_strict = 0
        for (s, e), by_level in sorted(agg.items()):
            cell_levels = sorted(by_level)
            means = [float(np.mean(by_level[lv])) for lv in cell_levels]
            mono = bool(all(a < b for a, b in zip(means, means[1:])))
            cell_strict += mono
            by_cell[f"{speakers[s]}/{emotions[e]}"] = {
                # the level values that actually survived synthesis for this
                # cell (a degenerate combo can drop a MIDDLE level, so the
                # plot must not assume the missing one is trailing)
                "levels": [float(lv) for lv in cell_levels],
                "score_mean_per_level": [round(m, 4) for m in means],
                "monotone_strict": mono,
            }

        # emotion separation on pooled h (synthesized audio)
        labels = np.array([r["emo"] for r in rows], np.int32)
        silhouette = None
        if len(set(labels.tolist())) >= 2 and len(labels) > len(set(labels.tolist())):
            try:
                from sklearn.metrics import silhouette_score

                silhouette = float(silhouette_score(pooled, labels))
            except Exception:  # sklearn genuinely unavailable
                silhouette = None

        def boot_ci(vals: List[float], n_boot: int = 2000) -> Optional[list]:
            """Bootstrap 95% CI over (text, spk, emo) cells — the unit of
            independence for the ordering metrics."""
            if len(vals) < 2:
                return None
            arr = np.asarray(vals, np.float64)
            rng = np.random.default_rng(0)
            means = rng.choice(arr, size=(n_boot, len(arr))).mean(axis=1)
            lo, hi = np.percentile(means, [2.5, 97.5])
            return [round(float(lo), 4), round(float(hi), 4)]

        report = {
            "n_synthesized": len(rows),
            "n_level_cells": n_cells,
            "monotonic_fraction_strict": (
                strict / n_cells if n_cells else None
            ),
            "monotonic_fraction_strict_ci95": boot_ci(cell_strict_flags),
            "pairwise_order_accuracy": (
                pair_ok / pair_tot if pair_tot else None
            ),
            "pairwise_order_accuracy_ci95": boot_ci(cell_pair_acc),
            "monotonic_fraction_cell_mean": (
                cell_strict / len(agg) if agg else None
            ),
            "emotion_silhouette_h": silhouette,
            "by_cell": by_cell,
        }
        return report


def _spearman(a: np.ndarray, b: np.ndarray) -> float:
    """Spearman rank correlation (no scipy dependency; ties are vanishingly
    rare for the continuous inputs this is used on)."""
    ra = np.argsort(np.argsort(a)).astype(np.float64)
    rb = np.argsort(np.argsort(b)).astype(np.float64)
    ra -= ra.mean()
    rb -= rb.mean()
    denom = float(np.sqrt((ra ** 2).sum() * (rb ** 2).sum()))
    return float((ra * rb).sum() / denom) if denom > 0 else 0.0


def rank_strength_correlation(
    cfg: Config,
    rank_params,
    strengths: Dict[str, float],
    split: str = "train",
    device="cuda",
) -> Dict:
    """Correlate the frozen rank model's λ≡1 utterance scores against known
    ground-truth emotion strengths.

    ``strengths`` maps ``"<speaker>/<emotion>_<id>"`` to the per-utterance
    strength (the synthetic graded corpus records this to
    ``strengths.json``; see tests/synthetic_corpus.py).  Returns per-
    (speaker, emotion) Spearman correlations plus their mean — the direct
    check that the rank model actually learned the corpus's intensity axis
    (the precondition for the bucketizer's prototypes, reference
    rank_model/inference.py:92-118, to encode usable levels)."""
    from emotts_torch.data.datasets import RankPairDataset

    ds = RankPairDataset(cfg, split)
    seen = {}
    for speaker, emotion, emo_id, _ in ds.entries:
        key = f"{speaker}/{emotion}_{emo_id}"
        if key in seen or key not in strengths:
            continue
        npz = np.load(
            os.path.join(cfg.data.preprocessed_path, speaker,
                         f"{emotion}_{emo_id}.npz"),
            allow_pickle=True,
        )
        seen[key] = (
            RankPairDataset._features(npz),
            ds.speakers.index(speaker),
            ds.emotions.index(emotion),
        )
    keys = sorted(seen)
    if not keys:
        return {"n_utts": 0, "mean_spearman": None, "by_cell": {}}
    xs = [seen[k][0] for k in keys]
    emos = [seen[k][2] for k in keys]
    scores, _ = RankScorer(cfg, rank_params, device).score_rows(xs, emos)

    cells: Dict = defaultdict(lambda: ([], []))
    for k, sc in zip(keys, scores):
        s_true, spk_i, emo_i = strengths[k], seen[k][1], seen[k][2]
        cells[(spk_i, emo_i)][0].append(s_true)
        cells[(spk_i, emo_i)][1].append(float(sc))
    by_cell = {}
    vals = []
    for (spk_i, emo_i), (s_list, r_list) in sorted(cells.items()):
        if len(s_list) < 3:
            continue
        rho = _spearman(np.asarray(s_list), np.asarray(r_list))
        by_cell[f"{cfg.data.speakers[spk_i]}/{cfg.data.emotions[emo_i]}"] = (
            round(rho, 4)
        )
        vals.append(rho)
    return {
        "n_utts": len(keys),
        "mean_spearman": round(float(np.mean(vals)), 4) if vals else None,
        "by_cell": by_cell,
    }


def evaluate_intensity_efficacy(
    cfg: Config,
    fs2_exp: Optional[str] = None,
    rank_exp: Optional[str] = None,
    texts: Optional[Sequence[str]] = None,
    out_path: Optional[str] = None,
    contrast: float = 1.0,
    device="cuda",
) -> Dict:
    """Assemble everything from experiment artifacts and run the eval.

    Mirrors ``emotts_torch.infer.synthesize.load_synthesizer``'s artifact
    contract: best FS2 checkpoint + ``intensity.npy`` from the rank
    experiment + optional ``.npz`` vocoder; the rank checkpoint itself
    provides the frozen scorer."""
    from emotts_torch.infer.synthesize import load_synthesizer
    from emotts_torch.train.checkpoint import load_best_params

    fs2_exp = fs2_exp or os.path.join(
        cfg.data.experiment_path, "fastspeech2", cfg.inference.fs2_exp
    )
    rank_exp = rank_exp or os.path.join(
        cfg.data.experiment_path, "rank_model", cfg.inference.rank_exp
    )
    synth = load_synthesizer(cfg, fs2_exp=fs2_exp, rank_exp=rank_exp,
                             device=device)
    if synth.intensity_bank is None:
        raise FileNotFoundError(
            f"no intensity.npy under {rank_exp} — run `bucketize` first"
        )
    rank_params = load_best_params(rank_exp)
    stats = load_feature_stats(cfg)
    meta_path = os.path.join(rank_exp, "intensity_meta.json")
    bank_meta = None
    if os.path.exists(meta_path):
        with open(meta_path) as f:
            bank_meta = json.load(f)
    ev = IntensityEfficacyEvaluator(cfg, synth, rank_params, stats,
                                    bank_meta=bank_meta)
    if out_path is None:
        out_path = os.path.join(fs2_exp, "intensity_eval.json")
    return ev.run(texts=texts, out_path=out_path, contrast=contrast)
