"""Mel-spectrogram + energy frontend.

Counterpart of ``emotts/audio/mel.py`` (the reference feature extractor is
rank_model/audio_util.py:24-42, which wraps SpeechBrain/torchaudio): 16 kHz
audio → framed STFT (as matrix products) → magnitude (power=1) →
Slaney-normalized Slaney-scale mel filterbank → log compression, plus the
per-utterance min-max-normalized L2 frame energy.

Conventions matched to the torchaudio/SpeechBrain behavior the reference
relies on:

* center=True with reflect padding of ``n_fft // 2`` samples on both sides,
* periodic Hann window of ``win_length`` (zero-padded to ``n_fft`` if shorter),
* one-sided spectrum (``n_fft // 2 + 1`` bins), ``normalized=False``,
* magnitude spectrogram (power=1),
* mel filterbank with Slaney mel scale + Slaney area normalization,
* log compression ``log(clamp(x, min=1e-5))``,
* energy = per-frame L2 norm over frequency bins of the magnitude
  spectrogram, min-max normalized per utterance.

Two implementations with one shared math core:

* :func:`mel_energy_np` — numpy, per-utterance (own copy of the reference's,
  bit for bit), used by host preprocessing and as the golden reference.
* :func:`mel_energy` / :func:`mel_full` — tensors on an explicit device,
  padded batches with a length vector: batched preprocessing on the GPU
  (``device_mel``) and, with ``floor="soft"``, the vocoder trainer's mel
  loss.  The DFT is two products with the window-folded basis, as in the
  reference, in full fp32: both TF32 switches are turned off for the
  process, as ``Synthesizer`` does.
"""

from __future__ import annotations

import functools
from typing import Tuple

import numpy as np
import torch

from emotts_torch.utils.config import AudioConfig

# ---------------------------------------------------------------------------
# Slaney mel filterbank (numpy; computed once, used as a constant on device)
# ---------------------------------------------------------------------------

_MIN_LOG_HZ = 1000.0
_MIN_LOG_MEL = 15.0
_LOG_STEP = np.log(6.4) / 27.0
_F_SP = 200.0 / 3.0


def hz_to_mel_slaney(freq):
    freq = np.asarray(freq, dtype=np.float64)
    mels = freq / _F_SP
    log_region = freq >= _MIN_LOG_HZ
    mels = np.where(
        log_region,
        _MIN_LOG_MEL + np.log(np.maximum(freq, _MIN_LOG_HZ) / _MIN_LOG_HZ) / _LOG_STEP,
        mels,
    )
    return mels


def mel_to_hz_slaney(mels):
    mels = np.asarray(mels, dtype=np.float64)
    freqs = _F_SP * mels
    log_region = mels >= _MIN_LOG_MEL
    freqs = np.where(
        log_region,
        _MIN_LOG_HZ * np.exp(_LOG_STEP * (np.maximum(mels, _MIN_LOG_MEL) - _MIN_LOG_MEL)),
        freqs,
    )
    return freqs


def mel_filterbank(
    sr: int, n_fft: int, n_mels: int, f_min: float, f_max: float
) -> np.ndarray:
    """Slaney-scale, Slaney-normalized triangular filterbank, shape (n_mels, n_bins)."""
    n_bins = n_fft // 2 + 1
    fft_freqs = np.linspace(0.0, sr / 2.0, n_bins)
    mel_pts = np.linspace(hz_to_mel_slaney(f_min), hz_to_mel_slaney(f_max), n_mels + 2)
    hz_pts = mel_to_hz_slaney(mel_pts)  # (n_mels + 2,)

    fdiff = np.diff(hz_pts)  # (n_mels + 1,)
    ramps = hz_pts[:, None] - fft_freqs[None, :]  # (n_mels + 2, n_bins)

    lower = -ramps[:-2] / fdiff[:-1, None]
    upper = ramps[2:] / fdiff[1:, None]
    weights = np.maximum(0.0, np.minimum(lower, upper))  # (n_mels, n_bins)

    # Slaney area normalization: each filter integrates to ~2/bandwidth
    enorm = 2.0 / (hz_pts[2 : n_mels + 2] - hz_pts[:n_mels])
    weights *= enorm[:, None]
    return weights.astype(np.float32)


def hann_window_periodic(win_length: int, n_fft: int) -> np.ndarray:
    """Periodic Hann window, zero-padded (centered) to n_fft — torch.stft behavior."""
    w = 0.5 * (1.0 - np.cos(2.0 * np.pi * np.arange(win_length) / win_length))
    if win_length < n_fft:
        pad_left = (n_fft - win_length) // 2
        w = np.pad(w, (pad_left, n_fft - win_length - pad_left))
    return w.astype(np.float32)


def num_frames(n_samples: int, hop_length: int) -> int:
    """Frame count with center padding: 1 + n_samples // hop."""
    return 1 + n_samples // hop_length


# ---------------------------------------------------------------------------
# numpy reference implementation
# ---------------------------------------------------------------------------


def stft_magnitude_np(y: np.ndarray, cfg: AudioConfig) -> np.ndarray:
    """Magnitude STFT, shape (n_bins, T)."""
    n_fft, hop = cfg.n_fft, cfg.hop_length
    pad = n_fft // 2
    y = np.pad(y.astype(np.float64), pad, mode="reflect")
    t = num_frames(len(y) - 2 * pad, hop)
    window = hann_window_periodic(cfg.win_length, n_fft).astype(np.float64)
    idx = np.arange(t)[:, None] * hop + np.arange(n_fft)[None, :]
    frames = y[idx] * window  # (T, n_fft)
    spec = np.fft.rfft(frames, n=n_fft, axis=-1)  # (T, n_bins)
    return np.abs(spec).T.astype(np.float32)  # (n_bins, T)


def mel_energy_np(y: np.ndarray, cfg: AudioConfig) -> Tuple[np.ndarray, np.ndarray]:
    """Log-mel (n_mels, T) and min-max-normalized energy (T,) of one utterance."""
    spec = stft_magnitude_np(y, cfg)  # (n_bins, T)
    fb = mel_filterbank(cfg.sampling_rate, cfg.n_fft, cfg.n_mels, cfg.f_min, cfg.f_max)
    mel = fb @ spec  # (n_mels, T)
    mel = np.log(np.maximum(mel, cfg.clip_val))
    energy = np.linalg.norm(spec, axis=0)  # (T,)
    e_min, e_max = energy.min(), energy.max()
    energy = (energy - e_min) / max(e_max - e_min, 1e-10)
    return mel.astype(np.float32), energy.astype(np.float32)


# ---------------------------------------------------------------------------
# torch implementation (padded batches on a device)
# ---------------------------------------------------------------------------


@functools.lru_cache(maxsize=8)
def _device_constants(cfg: AudioConfig, device: torch.device):
    """Window-folded DFT basis (n_fft, n_bins) ×2 and the mel filterbank
    transposed (n_bins, n_mels), fp32 tensors on ``device``
    (emotts/audio/mel.py:147-160)."""
    window = hann_window_periodic(cfg.win_length, cfg.n_fft)  # (n_fft,)
    n_bins = cfg.n_fft // 2 + 1
    k = np.arange(n_bins)[None, :]  # (1, n_bins)
    n = np.arange(cfg.n_fft)[:, None]  # (n_fft, 1)
    angle = -2.0 * np.pi * n * k / cfg.n_fft
    dft_real = (np.cos(angle) * window[:, None]).astype(np.float32)
    dft_imag = (np.sin(angle) * window[:, None]).astype(np.float32)
    fb = mel_filterbank(cfg.sampling_rate, cfg.n_fft, cfg.n_mels, cfg.f_min,
                        cfg.f_max).T  # (n_bins, n_mels)
    # normal tensors even where the first call runs under inference_mode
    # (preprocessing): the cached constants also serve the vocoder trainer's
    # differentiable mel, and inference tensors cannot be saved for backward
    with torch.inference_mode(False):
        return tuple(torch.from_numpy(np.ascontiguousarray(a)).to(device)
                     for a in (dft_real, dft_imag, fb))


def _full_fp32(device: torch.device) -> None:
    """Float32 products in full fp32 (no TF32): the feature contract is
    held against the float64 numpy golden near the log floor."""
    if device.type == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False


def _log_floor(mel: torch.Tensor, clip_val: float, floor: str) -> torch.Tensor:
    if floor == "soft":
        return torch.log(mel + clip_val)
    if floor == "hard":
        return torch.log(torch.clamp(mel, min=clip_val))
    raise ValueError(f"floor must be 'hard' or 'soft', got {floor!r}")


def _spectrum(frames: torch.Tensor, cfg: AudioConfig) -> torch.Tensor:
    """(B, T, n_fft) frames → (B, T, n_bins) magnitude."""
    dft_real, dft_imag, _ = _device_constants(cfg, frames.device)
    re = torch.matmul(frames, dft_real)
    im = torch.matmul(frames, dft_imag)
    return torch.sqrt(re * re + im * im + 1e-30)


def _mel_of(spec: torch.Tensor, cfg: AudioConfig) -> torch.Tensor:
    """(B, T, n_bins) → (B, n_mels, T) linear mel."""
    fb = _device_constants(cfg, spec.device)[2]
    return torch.matmul(spec, fb).transpose(1, 2)


def mel_full(y: torch.Tensor, cfg: AudioConfig, floor: str = "hard") -> torch.Tensor:
    """Log-mel (B, n_mels, T) of a batch whose rows are ALL full length.

    Equal to ``mel_energy(y, full_lengths, cfg, floor)[0]``: a static
    reflect pad and ``n_fft // hop`` shifted hop-chunks make the same frames
    as the per-row reflect indices do when every row is full, and no index
    tensor is built (emotts/audio/mel.py:162-209, the vocoder trainer's mel
    loss, where segments are always ``segment_samples`` long).
    Differentiable in ``y``."""
    _full_fp32(y.device)
    n_fft, hop = cfg.n_fft, cfg.hop_length
    b, s = y.shape
    pad = n_fft // 2
    t = num_frames(s, hop)
    ypad = torch.nn.functional.pad(y[:, None, :], (pad, pad), mode="reflect")[:, 0]
    if n_fft % hop == 0:
        # right-pad (zeros, never read: (t-1)*hop + n_fft <= s + 2*pad) to a
        # whole number of hop-chunks, then frame t = chunks[t : t + r]
        r = n_fft // hop
        extra = (-ypad.shape[1]) % hop
        if extra:
            ypad = torch.nn.functional.pad(ypad, (0, extra))
        chunks = ypad.reshape(b, -1, hop)
        frames = torch.cat([chunks[:, i:i + t] for i in range(r)], dim=-1)
    else:
        frames = ypad.unfold(1, n_fft, hop)[:, :t]
    return _log_floor(_mel_of(_spectrum(frames, cfg), cfg), cfg.clip_val, floor)


def mel_energy(
    y: torch.Tensor, lengths: torch.Tensor, cfg: AudioConfig,
    floor: str = "hard",
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Batched log-mel + energy on ``y``'s device.

    Args:
      y: (B, S) zero-padded float32 audio batch.
      lengths: (B,) valid sample counts (any integer dtype, any device).
      cfg: audio config.
      floor: "hard" = log(max(mel, clip_val)), the torchaudio-compatible
        feature contract; "soft" = log(mel + clip_val), differentiable
        everywhere (the vocoder GAN trainer's mel loss).

    Returns:
      mel: (B, n_mels, T) log-mel; frames past each utterance's frame count
        hold the log-floor value.
      energy: (B, T) per-utterance min-max-normalized energy (0 on pad).
      n_frames: (B,) valid frame counts (1 + length // hop), int64.

    Each row is reflect-padded around its OWN valid span by index
    arithmetic (emotts/audio/mel.py:250-262), so a row equals
    :func:`mel_energy_np` of the unpadded utterance.
    """
    device = y.device
    _full_fp32(device)
    n_fft, hop = cfg.n_fft, cfg.hop_length
    b, s = y.shape
    pad = n_fft // 2
    t = num_frames(s, hop)
    lengths = lengths.to(device=device, dtype=torch.int64)

    frame_starts = torch.arange(t, device=device) * hop  # (T,)
    offsets = torch.arange(n_fft, device=device) - pad  # [-pad, n_fft - pad)
    raw_idx = (frame_starts[:, None] + offsets[None, :]).abs()  # (T, n_fft)
    # reflect into [0, length) per row: standard 'reflect' (no edge repeat)
    period = torch.clamp(2 * (lengths - 1), min=1)[:, None, None]  # (B, 1, 1)
    idx = raw_idx[None] % period
    idx = torch.where(idx >= lengths[:, None, None], period - idx, idx)
    frames = torch.gather(y, 1, idx.reshape(b, -1)).reshape(b, t, n_fft)
    del idx

    spec = _spectrum(frames, cfg)  # (B, T, n_bins)
    del frames
    n_frames = 1 + lengths // hop  # (B,)
    frame_mask = torch.arange(t, device=device)[None, :] < n_frames[:, None]

    mel = _log_floor(_mel_of(spec, cfg), cfg.clip_val, floor)
    mel = torch.where(frame_mask[:, None, :], mel,
                      torch.tensor(np.log(cfg.clip_val), dtype=mel.dtype,
                                   device=device))

    energy = torch.linalg.vector_norm(spec, dim=-1)  # (B, T)
    big = torch.tensor(3e38, dtype=energy.dtype, device=device)
    e_min = torch.where(frame_mask, energy, big).amin(dim=1, keepdim=True)
    e_max = torch.where(frame_mask, energy, -big).amax(dim=1, keepdim=True)
    energy = (energy - e_min) / torch.clamp(e_max - e_min, min=1e-10)
    energy = torch.where(frame_mask, energy, torch.zeros((), dtype=energy.dtype,
                                                         device=device))
    return mel, energy, n_frames
