"""Dataset views over the preprocessed ``.npz`` artifacts (numpy only).

Own copy of the rank-model part of ``emotts/data/datasets.py``: pairs of
(emotional, neutral) utterances, zero-padded into statically shaped, bucketed
batches.  The FastSpeech2 view comes with that trainer.
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from typing import Dict, List, Sequence

import numpy as np

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
