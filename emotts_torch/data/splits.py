"""Deterministic dataset splits over the preprocessed corpus.

Own copy of ``emotts/data/splits.py``; the same artifact contract as the
reference:
* rank-model pair lists ``train.txt``/``test.txt`` with lines
  ``speaker|emotion|emo_audio_id|neu_audio_id``
  (rank_model/preprocess.py:172-231), which :class:`RankPairDataset` reads;
* FastSpeech2 80/20 per-speaker splits ``fs2_train.txt``/``fs2_valid.txt``
  of absolute .npz paths (fastspeech2/preprocess.py:7-28), which
  :class:`FS2Dataset` reads.

Unlike the reference, sampling is seeded (``data.split_seed``).
"""

from __future__ import annotations

import os
import random
from glob import glob
from pathlib import Path
from typing import List, Tuple

from emotts_torch.utils.config import Config


def _ids_for(preprocessed_path: str, speaker: str, emotion: str) -> List[str]:
    paths = glob(os.path.join(preprocessed_path, speaker, f"{emotion}_*.npz"))
    return sorted(os.path.basename(p)[:-4].split("_")[-1] for p in paths)


def build_rank_pair_lists(cfg: Config) -> Tuple[List[str], List[str]]:
    """Emotional↔neutral pairings: per (speaker, non-neutral emotion), the
    last `test_utts_per_emotion` emotional utterances go to test, the rest to
    train; each is paired with `neutral_pairs_per_utt` sampled neutral
    utterances.  With match_transcript=True, identical sentence ids pair."""
    data = cfg.data
    rng = random.Random(data.split_seed)
    train_list: List[str] = []
    test_list: List[str] = []
    n_test = data.test_utts_per_emotion
    k = data.neutral_pairs_per_utt

    for speaker in data.speakers:
        neu_ids = _ids_for(data.preprocessed_path, speaker, "neutral")
        if not neu_ids:
            continue
        for emotion in data.emotions:
            if emotion == "neutral":
                continue
            emo_ids = _ids_for(data.preprocessed_path, speaker, emotion)
            if not emo_ids:
                continue
            if data.match_transcript:
                common = sorted(set(neu_ids) & set(emo_ids))
                for audio_id in common[:-n_test]:
                    train_list.append(f"{speaker}|{emotion}|{audio_id}|{audio_id}")
                for audio_id in common[-n_test:]:
                    test_list.append(f"{speaker}|{emotion}|{audio_id}|{audio_id}")
            else:
                k_eff = min(k, len(neu_ids))
                for emo_id in emo_ids[:-n_test]:
                    for neu_id in rng.sample(neu_ids, k=k_eff):
                        train_list.append(f"{speaker}|{emotion}|{emo_id}|{neu_id}")
                for emo_id in emo_ids[-n_test:]:
                    for neu_id in rng.sample(neu_ids, k=k_eff):
                        test_list.append(f"{speaker}|{emotion}|{emo_id}|{neu_id}")

    base = Path(data.preprocessed_path)
    (base / "train.txt").write_text("\n".join(train_list) + "\n")
    (base / "test.txt").write_text("\n".join(test_list) + "\n")
    return train_list, test_list


def build_fs2_splits(cfg: Config) -> Tuple[List[str], List[str]]:
    """Per-speaker shuffled ``fs2_train_fraction`` split over all .npz files
    into ``fs2_train.txt`` / ``fs2_valid.txt``; skipped if the split files
    already exist (so that a rerun does not scramble an ongoing run)."""
    data = cfg.data
    base = Path(data.preprocessed_path)
    train_file, valid_file = base / "fs2_train.txt", base / "fs2_valid.txt"
    if train_file.exists():
        return (train_file.read_text().splitlines(),
                valid_file.read_text().splitlines())

    rng = random.Random(data.split_seed)
    train_list: List[str] = []
    valid_list: List[str] = []
    for speaker in data.speakers:
        paths = sorted(glob(os.path.join(data.preprocessed_path, speaker, "*.npz")))
        rng.shuffle(paths)
        n_train = int(len(paths) * data.fs2_train_fraction)
        train_list.extend(paths[:n_train])
        valid_list.extend(paths[n_train:])

    train_file.write_text("\n".join(train_list) + "\n")
    valid_file.write_text("\n".join(valid_list) + "\n")
    return train_list, valid_list
