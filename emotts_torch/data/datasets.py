"""Dataset views over the preprocessed ``.npz`` artifacts (numpy only).

Own copy of ``emotts/data/datasets.py``: pairs of (emotional, neutral)
utterances for the rank model, and single utterances with phones and
durations for FastSpeech2, each zero-padded into statically shaped, bucketed
batches.  The FastSpeech2 batch carries ``rank_x`` in the (B, T, n_mels + 2)
layout the intensity extractor reads.
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from typing import Dict, List, Sequence

import numpy as np

from emotts_torch.text.vocab import phoneme_to_sequence
from emotts_torch.utils.config import Config


def pick_bucket(value: int, buckets: Sequence[int]) -> int:
    """Smallest bucket ≥ value, or -1 if it overflows the largest."""
    for b in buckets:
        if value <= b:
            return b
    return -1


@dataclass
class RankPairExample:
    emo_x: np.ndarray  # (T, n_mels + 2)
    neu_x: np.ndarray  # (T, n_mels + 2)
    speaker: int
    emotion: int
    length: int


class RankPairDataset:
    """Pairs of (emotional, neutral) utterances for mixup ranking training.

    Pair lists come from ``train.txt``/``test.txt`` (lines
    ``speaker|emotion|emo_id|neu_id``); the features from
    ``<speaker>/<emotion>_<id>.npz`` with ``mel`` (n_mels, T), ``pitch`` (T,)
    and ``energy`` (T,).  Each example's two inputs are truncated to the
    shorter of the pair so that mixup operands align frame-wise."""

    def __init__(self, cfg: Config, split: str = "train"):
        self.cfg = cfg
        self.preprocessed_path = cfg.data.preprocessed_path
        self.speakers = list(cfg.data.speakers)
        self.emotions = list(cfg.data.emotions)
        path = os.path.join(self.preprocessed_path, f"{split}.txt")
        self.entries: List[tuple] = []
        with open(path) as f:
            for line in f:
                line = line.strip()
                if not line:
                    continue
                speaker, emotion, emo_id, neu_id = line.split("|")
                self.entries.append((speaker, emotion, emo_id, neu_id))

    def __len__(self) -> int:
        return len(self.entries)

    @staticmethod
    def _features(npz) -> np.ndarray:
        """(T, n_mels + 2) input: mel ⊕ pitch ⊕ energy."""
        mel = npz["mel"]  # (n_mels, T)
        pitch = npz["pitch"][None, :]
        energy = npz["energy"][None, :]
        return np.concatenate([mel, pitch, energy], axis=0).T.astype(np.float32)

    def _pair(self, idx: int):
        speaker, emotion, emo_id, neu_id = self.entries[idx]
        base = os.path.join(self.preprocessed_path, speaker)
        emo = np.load(os.path.join(base, f"{emotion}_{emo_id}.npz"), allow_pickle=True)
        neu = np.load(os.path.join(base, f"neutral_{neu_id}.npz"), allow_pickle=True)
        return speaker, emotion, emo, neu

    def __getitem__(self, idx: int) -> RankPairExample:
        speaker, emotion, emo, neu = self._pair(idx)
        emo_x = self._features(emo)
        neu_x = self._features(neu)
        t = min(len(emo_x), len(neu_x))
        return RankPairExample(
            emo_x=emo_x[:t],
            neu_x=neu_x[:t],
            speaker=self.speakers.index(speaker),
            emotion=self.emotions.index(emotion),
            length=t,
        )

    def length_of(self, idx: int) -> int:
        """Length probe used by the bucketing sampler."""
        _, _, emo, neu = self._pair(idx)
        return min(emo["pitch"].shape[0], neu["pitch"].shape[0])


def collate_rank_pairs(
    examples: List[RankPairExample], frame_bucket: int
) -> Dict[str, np.ndarray]:
    """Zero-pad a list of pair examples to (B, frame_bucket, C)."""
    b = len(examples)
    c = examples[0].emo_x.shape[1]
    emo_x = np.zeros((b, frame_bucket, c), dtype=np.float32)
    neu_x = np.zeros((b, frame_bucket, c), dtype=np.float32)
    lengths = np.zeros((b,), dtype=np.int32)
    speakers = np.zeros((b,), dtype=np.int32)
    emotions = np.zeros((b,), dtype=np.int32)
    for i, ex in enumerate(examples):
        t = min(ex.length, frame_bucket)
        emo_x[i, :t] = ex.emo_x[:t]
        neu_x[i, :t] = ex.neu_x[:t]
        lengths[i] = t
        speakers[i] = ex.speaker
        emotions[i] = ex.emotion
    return {
        "emo_x": emo_x,
        "neu_x": neu_x,
        "lengths": lengths,
        "speakers": speakers,
        "emotions": emotions,
    }


@dataclass
class FS2Example:
    phonemes: np.ndarray  # (P,) int
    durations: np.ndarray  # (P,) int
    mel: np.ndarray  # (T, n_mels)
    pitch: np.ndarray  # (T,)
    energy: np.ndarray  # (T,)
    rank_x: np.ndarray  # (T, n_mels + 2)
    speaker: int
    emotion: int
    text: str
    audio_path: str


class FS2Dataset:
    """The acoustic model's training view: ``fs2_<split>.txt`` lists one
    preprocessed ``.npz`` per line (``mel`` (n_mels, T), ``pitch``,
    ``energy``, ``phones``, ``durations``, ``speaker``, ``emotion``,
    ``transcript``, ``audio_path``)."""

    def __init__(self, cfg: Config, split: str = "train"):
        self.cfg = cfg
        self.speakers = list(cfg.data.speakers)
        self.emotions = list(cfg.data.emotions)
        self.noise_symbol = cfg.data.noise_symbol
        path = os.path.join(cfg.data.preprocessed_path, f"fs2_{split}.txt")
        with open(path) as f:
            self.data_paths = [ln.strip() for ln in f if ln.strip()]

    def __len__(self) -> int:
        return len(self.data_paths)

    def __getitem__(self, idx: int) -> FS2Example:
        npz = np.load(self.data_paths[idx], allow_pickle=True)
        mel = npz["mel"].T.astype(np.float32)  # (T, n_mels)
        pitch = npz["pitch"].astype(np.float32)
        energy = npz["energy"].astype(np.float32)
        rank_x = np.concatenate(
            [mel, pitch[:, None], energy[:, None]], axis=1
        ).astype(np.float32)
        phones = [str(p) for p in npz["phones"].tolist()]
        return FS2Example(
            phonemes=np.asarray(phoneme_to_sequence(phones), dtype=np.int32),
            durations=npz["durations"].astype(np.int32),
            mel=mel,
            pitch=pitch,
            energy=energy,
            rank_x=rank_x,
            speaker=self.speakers.index(str(npz["speaker"])),
            emotion=self.emotions.index(str(npz["emotion"])),
            text=str(npz["transcript"]).replace(self.noise_symbol.strip(), "").strip(),
            audio_path=str(npz["audio_path"]),
        )

    def length_of(self, idx: int) -> int:
        npz = np.load(self.data_paths[idx], allow_pickle=True)
        return int(npz["pitch"].shape[0])

    def phone_count_of(self, idx: int) -> int:
        """The utterance's phone count (read once, then remembered)."""
        counts = self.__dict__.setdefault("_phone_counts", {})
        if idx not in counts:
            npz = np.load(self.data_paths[idx], allow_pickle=True)
            counts[idx] = len(npz["phones"])
        return counts[idx]


def collate_fs2(
    examples: List[FS2Example], phone_bucket: int, frame_bucket: int
) -> Dict[str, np.ndarray]:
    """Zero-pad FS2 examples to static (B, phone_bucket) / (B, frame_bucket).

    Durations are clamped from the last phone backwards so that Σdurations ≤
    frame_bucket stays consistent with the truncated mel (keeps the length
    regulator's frame grid in range)."""
    b = len(examples)
    n_mels = examples[0].mel.shape[1]
    phonemes = np.zeros((b, phone_bucket), dtype=np.int32)
    durations = np.zeros((b, phone_bucket), dtype=np.int32)
    mel = np.zeros((b, frame_bucket, n_mels), dtype=np.float32)
    pitch = np.zeros((b, frame_bucket), dtype=np.float32)
    energy = np.zeros((b, frame_bucket), dtype=np.float32)
    rank_x = np.zeros((b, frame_bucket, n_mels + 2), dtype=np.float32)
    phon_len = np.zeros((b,), dtype=np.int32)
    mel_len = np.zeros((b,), dtype=np.int32)
    speakers = np.zeros((b,), dtype=np.int32)
    emotions = np.zeros((b,), dtype=np.int32)
    texts, wavs = [], []

    for i, ex in enumerate(examples):
        p = min(len(ex.phonemes), phone_bucket)
        d = ex.durations[:p].astype(np.int64).copy()
        overflow = int(d.sum()) - frame_bucket
        j = len(d) - 1
        while overflow > 0 and j >= 0:
            take = min(overflow, int(d[j]))
            d[j] -= take
            overflow -= take
            j -= 1
        t = min(int(d.sum()), ex.mel.shape[0], frame_bucket)

        phonemes[i, :p] = ex.phonemes[:p]
        durations[i, :p] = d
        mel[i, :t] = ex.mel[:t]
        pitch[i, :t] = ex.pitch[:t]
        energy[i, :t] = ex.energy[:t]
        rank_x[i, :t] = ex.rank_x[:t]
        phon_len[i] = p
        mel_len[i] = t
        speakers[i] = ex.speaker
        emotions[i] = ex.emotion
        texts.append(ex.text)
        wavs.append(ex.audio_path)

    return {
        "phonemes": phonemes,
        "durations": durations,
        "mel": mel,
        "pitch": pitch,
        "energy": energy,
        "rank_x": rank_x,
        "phon_len": phon_len,
        "mel_len": mel_len,
        "speakers": speakers,
        "emotions": emotions,
        "texts": texts,
        "wavs": wavs,
    }
