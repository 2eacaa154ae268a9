"""Checkpointing over ``torch.save``/``torch.load``: full train state plus a
best-params export.

The directory contract of ``emotts/train/checkpoint.py`` in this package's own
file format: step-indexed full states under ``<exp>/checkpoints`` (the last
``keep`` are retained) and one params-only export under ``<exp>/best``, which
bucketization and synthesis read.  ``save_best_export`` writes that export
without a train state (the reference-checkpoint importer's experiments).
"""

from __future__ import annotations

import os
import re
import shutil
from pathlib import Path
from typing import Dict, List, Optional

import torch

from emotts_torch.train.state import TrainState

_STEP_FILE = re.compile(r"^step_(\d+)\.pt$")
BEST_FILE = "params.pt"


def _save_atomically(obj, path: Path) -> None:
    tmp = path.with_suffix(f".tmp{os.getpid()}")
    torch.save(obj, tmp)
    os.replace(tmp, path)


class CheckpointManager:
    """Step-indexed full-state checkpoints under <exp>/checkpoints plus a
    single 'best' params-only export under <exp>/best."""

    def __init__(self, exp_path: str, keep: int = 3):
        self.exp_path = Path(exp_path)
        self.ckpt_dir = (self.exp_path / "checkpoints").absolute()
        self.ckpt_dir.mkdir(parents=True, exist_ok=True)
        self.keep = keep

    def steps(self) -> List[int]:
        found = (_STEP_FILE.match(p.name) for p in self.ckpt_dir.iterdir())
        return sorted(int(m.group(1)) for m in found if m)

    def latest_step(self) -> Optional[int]:
        steps = self.steps()
        return steps[-1] if steps else None

    def save(self, state: TrainState) -> None:
        _save_atomically(state.state_dict(), self.ckpt_dir / f"step_{state.step}.pt")
        for old in self.steps()[:-self.keep] if self.keep > 0 else []:
            (self.ckpt_dir / f"step_{old}.pt").unlink()

    def restore(self, state: TrainState) -> bool:
        """Load the latest checkpoint into ``state``; False if there is none."""
        step = self.latest_step()
        if step is None:
            return False
        device = next(state.model.parameters()).device
        state.load_state_dict(torch.load(
            self.ckpt_dir / f"step_{step}.pt", map_location=device,
            weights_only=True))
        return True

    def save_best(self, params: Dict[str, torch.Tensor]) -> None:
        """Export best-on-validation parameters (a ``state_dict``)."""
        save_best_export(str(self.exp_path), params)


def save_best_export(exp_path: str, state_dict: Dict[str, torch.Tensor]) -> str:
    """Write the ``best/`` export that :func:`load_best_params` reads into an
    experiment directory, replacing any earlier one; returns its directory."""
    best_dir = (Path(exp_path) / "best").absolute()
    if best_dir.exists():
        shutil.rmtree(best_dir)
    best_dir.mkdir(parents=True)
    _save_atomically({k: v.detach().cpu() for k, v in state_dict.items()},
                     best_dir / BEST_FILE)
    return str(best_dir)


def load_best_params(exp_path: str, device="cpu") -> Dict[str, torch.Tensor]:
    """The best-params export of an experiment directory, as a state_dict."""
    path = (Path(exp_path) / "best" / BEST_FILE).absolute()
    return torch.load(path, map_location=device, weights_only=True)
