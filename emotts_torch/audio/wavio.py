"""WAV file output (counterpart of ``emotts/audio/wavio.py``; this package
only writes audio so far)."""

from __future__ import annotations

import numpy as np
from scipy.io import wavfile


def write_wav(path: str, y: np.ndarray, sr: int) -> None:
    """Write audio as 16-bit PCM: float input in [-1, 1], or int16
    passthrough (already-quantized device output from Synthesizer.vocode)."""
    y = np.asarray(y)
    if y.dtype == np.int16:
        wavfile.write(path, sr, y)
        return
    y = np.clip(y.astype(np.float32), -1.0, 1.0)
    wavfile.write(path, sr, (y * 32767.0).astype(np.int16))
