"""Split lists over the preprocessed corpus.

Own copy of ``build_fs2_splits`` from ``emotts/data/splits.py``: the
FastSpeech2 train/valid file lists that :class:`FS2Dataset` reads.  The rank
model's pair lists are not ported yet.
"""

from __future__ import annotations

import os
import random
from glob import glob
from pathlib import Path
from typing import List, Tuple

from emotts_torch.utils.config import Config


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
