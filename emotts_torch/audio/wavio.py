"""WAV file IO and resampling.

Own copy of ``emotts/audio/wavio.py``.  Replaces the reference's
librosa.load / scipy write / torchaudio.save triplet
(rank_model/prepare_mfa.py:45-53, rank_model/preprocess.py:93,
fastspeech2/inference.py:84) without the librosa/torchaudio dependencies:
scipy WAV IO + polyphase resampling.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
from scipy.io import wavfile

_INT_SCALES = {np.dtype(np.int16): 32768.0, np.dtype(np.int32): 2147483648.0}


def read_wav(path: str) -> Tuple[np.ndarray, int]:
    """Read a WAV file to float32 in [-1, 1]; stereo is averaged to mono."""
    sr, data = wavfile.read(path)
    if data.dtype in _INT_SCALES:
        data = data.astype(np.float32) / _INT_SCALES[data.dtype]
    elif data.dtype == np.uint8:
        data = (data.astype(np.float32) - 128.0) / 128.0
    else:
        data = data.astype(np.float32)
    if data.ndim == 2:
        data = data.mean(axis=1)
    return data, int(sr)


def write_wav(path: str, y: np.ndarray, sr: int) -> None:
    """Write audio as 16-bit PCM: float input in [-1, 1], or int16
    passthrough (already-quantized device output from Synthesizer.vocode)."""
    y = np.asarray(y)
    if y.dtype == np.int16:
        wavfile.write(path, sr, y)
        return
    y = np.clip(y.astype(np.float32), -1.0, 1.0)
    wavfile.write(path, sr, (y * 32767.0).astype(np.int16))


def resample(y: np.ndarray, orig_sr: int, target_sr: int) -> np.ndarray:
    """Polyphase resampling (band-limited, anti-aliased)."""
    # imported here: scipy.signal takes seconds to import, and serving never
    # resamples
    from scipy.signal import resample_poly

    if orig_sr == target_sr:
        return y.astype(np.float32)
    g = np.gcd(int(orig_sr), int(target_sr))
    return resample_poly(y, target_sr // g, orig_sr // g).astype(np.float32)


def load_wav(path: str, target_sr: int) -> np.ndarray:
    """Read + resample to target_sr (reference: librosa.load(path, sr=16000))."""
    y, sr = read_wav(path)
    return resample(y, sr, target_sr)


def trim_audio(y: np.ndarray, start_time: float, end_time: float, sr: int) -> np.ndarray:
    """Sample-index crop by times (reference: rank_model/audio_util.py:9-12)."""
    s = int(np.round(start_time * sr))
    e = int(np.round(end_time * sr))
    return y[s:e].astype(np.float32)
