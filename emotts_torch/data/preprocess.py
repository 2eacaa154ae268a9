"""Feature-extraction pipeline: corpus wav + TextGrid → per-utterance .npz.

Same artifact contract as the reference (rank_model/preprocess.py:50-168):
``preprocessed/<speaker>/<emotion>_<id>.npz`` with keys {phones, emotion,
speaker, audio_id, audio_path, transcript, textgrid_path, mel, pitch, energy,
durations}, per-(speaker,emotion) z-normalization of pitch/energy, and a
merged ``stats.json`` of [min, max, mean, std] per field.

Counterpart of ``emotts/data/preprocess.py``; the same files come out.
Differences from the reference script:
* mel/energy can be computed **on the GPU in bucketed batches**
  (``device_mel=True``) with emotts_torch.audio.mel.mel_energy instead of
  one utterance at a time on the host;
* normalization runs in a single pass (features held in memory per
  speaker/emotion group) instead of rewriting every .npz a second time
  (reference: normalize_field, rank_model/preprocess.py:35-46,153-159);
* robust duration clamping instead of a hard assert when rounding makes
  Σdurations exceed the available frames.
"""

from __future__ import annotations

import json
import os
from dataclasses import dataclass
from glob import glob
from pathlib import Path
from typing import Dict, List, Optional

import numpy as np
import torch

from emotts_torch.audio.f0 import extract_f0 as extract_f0_np, interpolate_unvoiced
from emotts_torch.audio.native import extract_f0_native, have_native
from emotts_torch.audio.mel import mel_energy_np, num_frames
from emotts_torch.audio.normalize import RunningStats, remove_outliers
from emotts_torch.audio.textgrid import process_textgrid
from emotts_torch.audio.wavio import load_wav, trim_audio
from emotts_torch.utils.config import Config


def average_by_duration(values: np.ndarray, durations: np.ndarray) -> np.ndarray:
    """Per-phone mean of a frame-level track (vectorized; zero-length → 0)."""
    durations = np.asarray(durations, dtype=np.int64)
    ends = np.cumsum(np.maximum(durations, 0))
    starts = ends - np.maximum(durations, 0)
    csum = np.concatenate([[0.0], np.cumsum(values, dtype=np.float64)])
    ends = np.minimum(ends, len(values))
    starts = np.minimum(starts, len(values))
    sums = csum[ends] - csum[starts]
    counts = (ends - starts).astype(np.float64)
    out = np.where(counts > 0, sums / np.maximum(counts, 1.0), 0.0)
    return out.astype(np.float32)


def expand_by_duration(values: np.ndarray, durations: np.ndarray) -> np.ndarray:
    """Length regulation on host (reference: expand, rank_model/audio_util.py:78)."""
    return np.repeat(values, np.maximum(durations, 0))


@dataclass
class _Extracted:
    """One utterance's features before normalization."""

    speaker: str
    emotion: str
    audio_id: str
    audio_path: str
    textgrid_path: str
    transcript: str
    phones: List[str]
    durations: np.ndarray
    mel: Optional[np.ndarray]  # (n_mels, T); None when deferred to device
    pitch: np.ndarray  # (T,)
    energy: Optional[np.ndarray]  # (T,)
    audio: Optional[np.ndarray] = None  # trimmed waveform (deferred-mel mode)


def _extract_one(
    cfg: Config, speaker: str, emotion: str, audio_path: str,
    defer_mel: bool = False,
) -> Optional[_Extracted]:
    audio = cfg.audio
    data = cfg.data
    audio_id = Path(audio_path).stem.split("_")[-1]
    tgt_path = os.path.join(
        data.textgrid_path, speaker, f"{emotion}_{audio_id}.TextGrid"
    )
    lab_path = Path(data.corpus_path) / speaker / f"{emotion}_{audio_id}.lab"
    if not os.path.exists(tgt_path):
        return None

    phones, durations, start_t, end_t = process_textgrid(
        tgt_path, audio.sampling_rate, audio.hop_length, data.sil_phones
    )
    if start_t >= end_t or len(phones) == 0:
        return None

    y = load_wav(audio_path, audio.sampling_rate)
    y = trim_audio(y, start_t, end_t, audio.sampling_rate)
    if len(y) < audio.n_fft:
        return None

    transcript = (
        lab_path.read_text().strip().replace(data.noise_symbol, "")
        if lab_path.exists()
        else ""
    )

    # F0 (hop-aligned) with unvoiced interpolation: the C++ library where
    # it is built, its numpy mirror where not (both on the host)
    if have_native():
        pitch = extract_f0_native(y, audio.hop_length, audio.sampling_rate)
    else:
        pitch = extract_f0_np(y, audio.hop_length, audio.sampling_rate)
    if np.count_nonzero(pitch) <= 1:
        return None

    # guard: Σdurations must fit in the available frames (both the F0 track
    # and the mel have ~len(y)/hop + 1 frames); clamp the tail phone instead
    # of crashing (the reference asserts, rank_model/preprocess.py:133)
    total = int(durations.sum())
    available = min(len(pitch), num_frames(len(y), audio.hop_length))
    if total > available:
        overflow = total - available
        d = durations.astype(np.int64).copy()
        for i in range(len(d) - 1, -1, -1):
            take = min(overflow, d[i])
            d[i] -= take
            overflow -= take
            if overflow == 0:
                break
        durations = d
        total = int(durations.sum())
    if total <= 0:
        return None

    pitch = interpolate_unvoiced(pitch[:total]).astype(np.float32)

    if defer_mel:
        # mel/energy computed on device in bucketed batches later
        mel = energy = None
    else:
        mel, energy = mel_energy_np(y, audio)
        mel = mel[:, :total].astype(np.float32)
        energy = energy[:total].astype(np.float32)
        if cfg.data.energy_averaging:
            energy = expand_by_duration(
                average_by_duration(energy, durations), durations
            )

    if cfg.data.pitch_averaging:
        pitch = expand_by_duration(average_by_duration(pitch, durations), durations)

    return _Extracted(
        speaker=speaker,
        emotion=emotion,
        audio_id=audio_id,
        audio_path=audio_path,
        textgrid_path=tgt_path,
        transcript=transcript,
        phones=phones,
        durations=durations.astype(np.int64),
        mel=mel,
        pitch=pitch,
        energy=energy,
        audio=y if defer_mel else None,
    )


def _device_mel_batch(cfg: Config, extracted: List["_Extracted"],
                      device: torch.device) -> None:
    """Fill in mel/energy for deferred items with
    :func:`emotts_torch.audio.mel.mel_energy` on ``device``, in buckets of
    ``frame_buckets × hop`` samples and chunks of at most 64 rows, so that
    a bucket's batches share one shape (emotts/data/preprocess.py:169-215)."""
    from emotts_torch.audio import mel as mel_mod

    hop = cfg.audio.hop_length
    sample_buckets = sorted(b * hop for b in cfg.bucketing.frame_buckets)

    def bucket_of(n):
        for sb in sample_buckets:
            if n <= sb:
                return sb
        return ((n + hop - 1) // hop) * hop  # rare overflow: exact multiple

    groups: dict = {}
    for idx, ex in enumerate(extracted):
        if ex.mel is not None:
            continue
        groups.setdefault(bucket_of(len(ex.audio)), []).append(idx)

    for sb, idxs in groups.items():
        for chunk_start in range(0, len(idxs), 64):
            chunk = idxs[chunk_start : chunk_start + 64]
            batch = np.zeros((len(chunk), sb), np.float32)
            lengths = np.zeros((len(chunk),), np.int64)
            for j, idx in enumerate(chunk):
                y = extracted[idx].audio
                batch[j, : len(y)] = y
                lengths[j] = len(y)
            with torch.inference_mode():
                mel_b, energy_b, _ = mel_mod.mel_energy(
                    torch.from_numpy(batch).to(device),
                    torch.from_numpy(lengths).to(device), cfg.audio)
                mel_b = mel_b.cpu().numpy()
                energy_b = energy_b.cpu().numpy()
            for j, idx in enumerate(chunk):
                ex = extracted[idx]
                total = int(ex.durations.sum())
                ex.mel = mel_b[j, :, :total].astype(np.float32)
                energy = energy_b[j, :total].astype(np.float32)
                if cfg.data.energy_averaging:
                    energy = expand_by_duration(
                        average_by_duration(energy, ex.durations), ex.durations
                    )
                ex.energy = energy
                ex.audio = None


def feature_extraction(
    cfg: Config, speaker: str, emotion: str, device_mel: bool = False,
    device="cuda",
) -> int:
    """Process one (speaker, emotion) group; returns #utterances written.

    Normalization: z-score pitch/energy with per-group Welford stats over
    IQR-cleaned values (matching StandardScaler.partial_fit over cleaned
    frames, reference rank_model/preprocess.py:128-131,153-159), then write
    .npz once and merge stats.json.
    """
    data = cfg.data
    wav_paths = sorted(glob(os.path.join(data.corpus_path, speaker, f"{emotion}_*.wav")))
    pitch_stats, energy_stats = RunningStats(), RunningStats()
    extracted: List[_Extracted] = []
    # thread-pool parallel feature extraction: the hot inner loops (native
    # F0 via ctypes, numpy FFTs) release the GIL, so threads scale on host
    # cores (replaces the reference's serial loop + DataLoader workers)
    import concurrent.futures as cf

    workers = max(1, (os.cpu_count() or 2) - 1)
    with cf.ThreadPoolExecutor(max_workers=workers) as pool:
        results = pool.map(
            lambda p: _extract_one(cfg, speaker, emotion, p, defer_mel=device_mel),
            wav_paths,
        )
        extracted = [ex for ex in results if ex is not None]
    if device_mel:
        _device_mel_batch(cfg, extracted, torch.device(device))
    for ex in extracted:
        pitch_stats.update(remove_outliers(ex.pitch))
        energy_stats.update(remove_outliers(ex.energy))

    if not extracted:
        return 0

    p_mean, p_std = pitch_stats.mean, pitch_stats.std
    e_mean, e_std = energy_stats.mean, energy_stats.std

    out_dir = Path(data.preprocessed_path) / speaker
    out_dir.mkdir(parents=True, exist_ok=True)
    p_min = e_min = np.inf
    p_max = e_max = -np.inf
    for ex in extracted:
        pitch = (ex.pitch - p_mean) / p_std
        energy = (ex.energy - e_mean) / e_std
        p_min, p_max = min(p_min, pitch.min()), max(p_max, pitch.max())
        e_min, e_max = min(e_min, energy.min()), max(e_max, energy.max())
        np.savez(
            out_dir / f"{emotion}_{ex.audio_id}.npz",
            phones=np.array(ex.phones),
            emotion=ex.emotion,
            speaker=ex.speaker,
            audio_id=ex.audio_id,
            audio_path=ex.audio_path,
            transcript=ex.transcript,
            textgrid_path=ex.textgrid_path,
            mel=ex.mel,
            pitch=pitch.astype(np.float32),
            energy=energy.astype(np.float32),
            durations=ex.durations,
        )

    stats_file = Path(data.preprocessed_path) / "stats.json"
    stats = json.loads(stats_file.read_text()) if stats_file.exists() else {}
    stats.setdefault(speaker, {})[emotion] = {
        "pitch": [float(p_min), float(p_max), float(p_mean), float(p_std)],
        "energy": [float(e_min), float(e_max), float(e_mean), float(e_std)],
    }
    stats_file.write_text(json.dumps(stats, indent=4))
    return len(extracted)


def preprocess_all(
    cfg: Config, verbose: bool = True, device_mel: Optional[bool] = None,
    device="cuda",
) -> Dict[str, int]:
    """Run feature extraction for every (speaker, emotion) present on disk.

    ``device_mel=True`` computes mel/energy on ``device`` in bucketed
    batches instead of per-utterance numpy FFTs on the host; None takes
    ``cfg.data.device_mel``.  Asking for the GPU where there is none
    raises: the host never stands in for it."""
    if device_mel is None:
        device_mel = cfg.data.device_mel
    if device_mel:
        device = torch.device(device)
        if device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(
                "device_mel on device='cuda' needs a GPU and none is visible; "
                "pass device='cpu' or device_mel=False")
    counts: Dict[str, int] = {}
    for speaker in cfg.data.speakers:
        for emotion in cfg.data.emotions:
            n = feature_extraction(cfg, speaker, emotion, device_mel=device_mel,
                                   device=device)
            if n:
                counts[f"{speaker}/{emotion}"] = n
                if verbose:
                    print(f"[preprocess] {speaker}/{emotion}: {n} utterances")
    return counts
