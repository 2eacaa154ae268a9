from emotts_torch.nn.blocks import (
    ConvFFN,
    FFTBlock,
    FFTStack,
    MultiHeadSelfAttention,
    sequence_mask,
    sinusoidal_positional_encoding,
)
from emotts_torch.nn.convert import (
    disc_from_flax,
    fs2_from_flax,
    hifigan_from_flax,
    hifigan_to_flax,
    load_vocoder_checkpoint,
    rank_from_flax,
)
from emotts_torch.nn.fastspeech2 import (
    EncoderPreNet,
    FastSpeech2,
    PostNet,
    SpeechBrainPostNet,
    VariancePredictor,
)
from emotts_torch.nn.hifigan import (
    HiFiGANGenerator,
    ResBlock1,
    generator_structure_from_params,
)
from emotts_torch.nn.hifigan_disc import (
    Discriminators,
    MultiPeriodDiscriminator,
    MultiScaleDiscriminator,
    PeriodDiscriminator,
    ScaleDiscriminator,
)
from emotts_torch.nn.intensity import IntensityExtractor, RankModel
from emotts_torch.nn.length_regulator import (
    average_over_durations,
    length_regulate,
    phone_index_map,
    segment_mean,
)

__all__ = [
    "ConvFFN",
    "FFTBlock",
    "FFTStack",
    "MultiHeadSelfAttention",
    "sequence_mask",
    "sinusoidal_positional_encoding",
    "disc_from_flax",
    "fs2_from_flax",
    "hifigan_from_flax",
    "hifigan_to_flax",
    "load_vocoder_checkpoint",
    "rank_from_flax",
    "IntensityExtractor",
    "RankModel",
    "EncoderPreNet",
    "FastSpeech2",
    "PostNet",
    "SpeechBrainPostNet",
    "VariancePredictor",
    "HiFiGANGenerator",
    "ResBlock1",
    "generator_structure_from_params",
    "Discriminators",
    "MultiPeriodDiscriminator",
    "MultiScaleDiscriminator",
    "PeriodDiscriminator",
    "ScaleDiscriminator",
    "average_over_durations",
    "length_regulate",
    "phone_index_map",
    "segment_mean",
]
