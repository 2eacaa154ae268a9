from emotts_torch.audio.f0 import dio, extract_f0, interpolate_unvoiced, stonemask
from emotts_torch.audio.mel import (
    mel_energy,
    mel_energy_np,
    mel_filterbank,
    mel_full,
    num_frames,
    stft_magnitude_np,
)
from emotts_torch.audio.normalize import RunningStats, remove_outliers
from emotts_torch.audio.textgrid import (
    Interval,
    parse_textgrid,
    process_textgrid,
    write_textgrid,
)
from emotts_torch.audio.wavio import load_wav, read_wav, resample, trim_audio, write_wav

__all__ = [
    "dio",
    "extract_f0",
    "interpolate_unvoiced",
    "stonemask",
    "mel_energy",
    "mel_energy_np",
    "mel_full",
    "mel_filterbank",
    "num_frames",
    "stft_magnitude_np",
    "RunningStats",
    "remove_outliers",
    "Interval",
    "parse_textgrid",
    "process_textgrid",
    "write_textgrid",
    "load_wav",
    "read_wav",
    "resample",
    "trim_audio",
    "write_wav",
]
