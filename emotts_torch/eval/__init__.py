"""Objective evaluation: MCD/F0/duration metrics, the experiment evaluator
and the intensity-efficacy report (counterpart of ``emotts/eval``)."""

from emotts_torch.eval.evaluate import Evaluator
from emotts_torch.eval.intensity_eval import (
    IntensityEfficacyEvaluator,
    RankScorer,
    evaluate_intensity_efficacy,
)
from emotts_torch.eval.metrics import (
    dtw_alignment,
    dtw_path,
    duration_metrics,
    f0_metrics,
    mcd,
    mcd_dtw,
    mel_cepstra,
)

__all__ = [
    "Evaluator", "IntensityEfficacyEvaluator", "RankScorer",
    "dtw_alignment", "dtw_path", "duration_metrics",
    "evaluate_intensity_efficacy", "f0_metrics", "mcd", "mcd_dtw", "mel_cepstra",
]
