from emotts_torch.train.checkpoint import CheckpointManager, load_best_params
from emotts_torch.train.metrics import EpochAverager, MetricsWriter, StepTimer
from emotts_torch.train.rank_trainer import RankTrainer, build_rank_model
from emotts_torch.train.state import AdamW, TrainState, make_optimizer

__all__ = [
    "AdamW",
    "CheckpointManager",
    "EpochAverager",
    "MetricsWriter",
    "RankTrainer",
    "StepTimer",
    "TrainState",
    "build_rank_model",
    "load_best_params",
    "make_optimizer",
]
