from emotts_torch.train.checkpoint import CheckpointManager, load_best_params
from emotts_torch.train.fs2_trainer import (FS2Trainer, build_fastspeech2,
                                            build_intensity_extractor,
                                            extractor_params_from_rank,
                                            init_fs2_variables)
from emotts_torch.train.metrics import EpochAverager, MetricsWriter, StepTimer
from emotts_torch.train.rank_trainer import RankTrainer, build_rank_model
from emotts_torch.train.state import AdamW, TrainState, make_optimizer
from emotts_torch.train.vocoder_trainer import (VocoderTrainer, build_discriminators,
                                                build_vocoder_generator)

__all__ = [
    "AdamW",
    "CheckpointManager",
    "EpochAverager",
    "FS2Trainer",
    "MetricsWriter",
    "RankTrainer",
    "StepTimer",
    "TrainState",
    "VocoderTrainer",
    "build_discriminators",
    "build_fastspeech2",
    "build_intensity_extractor",
    "build_rank_model",
    "build_vocoder_generator",
    "extractor_params_from_rank",
    "init_fs2_variables",
    "load_best_params",
    "make_optimizer",
]
