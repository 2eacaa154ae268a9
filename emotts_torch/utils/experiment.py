"""Experiment-directory management and determinism helpers.

Own copy of ``emotts/utils/experiment.py``: auto-incrementing ``exp_N``
directories and one seeding entry point for the host-side numpy/python
generators the data pipeline uses.  The models' randomness comes from the
explicit ``torch.Generator``s the trainers own, not from here.
"""

from __future__ import annotations

import os
import random
from pathlib import Path

import numpy as np


def set_seed(seed: int = 42) -> None:
    random.seed(seed)
    np.random.seed(seed)
    os.environ["PYTHONHASHSEED"] = str(seed)


def increment_path(base_path: str, subdirs: tuple = ()) -> str:
    """Create and return the next free ``<base_path>/exp_N`` directory, with
    ``subdirs`` inside it."""
    exp_num = 1
    while True:
        path = Path(base_path) / f"exp_{exp_num}"
        if not path.exists():
            path.mkdir(parents=True)
            for sub in subdirs:
                (path / sub).mkdir()
            return str(path)
        exp_num += 1
