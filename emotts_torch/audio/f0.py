"""WORLD-style F0 estimation: DIO candidate search + StoneMask refinement.

The reference calls pyworld's C++ DIO/StoneMask (rank_model/audio_util.py:16-20)
with ``frame_period = hop_length / sampling_rate * 1000`` (16 ms) so the F0
track is hop-aligned with the mel frames.  This module re-implements the same
algorithm family in vectorized numpy:

* **DIO**: the signal is low-pass filtered at a bank of log-spaced boundary
  frequencies (Nuttall-window FIR applied in the frequency domain).  For each
  band, four interval-based period estimates (negative/positive zero
  crossings, peaks, dips) are interpolated to the frame grid; their mean is
  the band's F0 candidate and their standard deviation its (lower-is-better)
  score.  The best-scoring candidate per frame is then cleaned by contour
  fixing (octave-jump removal, short-voiced-segment pruning, and
  candidate-guided boundary extension).
* **StoneMask**: each voiced frame is refined by instantaneous-frequency
  estimation: a Blackman-windowed segment of 3 periods around the frame is
  DFT'd together with its derivative window; the amplitude-weighted mean of
  the instantaneous frequencies at the first harmonics re-estimates F0.
  Applied twice, as in WORLD.

Own copy of ``emotts/audio/f0.py`` (host numpy, as there).
``emotts_torch.audio.native`` binds the C++ implementation of the same
algorithm under ``native/``; preprocessing takes it where the library is
built, this module where it is not.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np

_EPS = 1e-12


def _nuttall(n: int) -> np.ndarray:
    t = np.arange(n) * 2.0 * np.pi / (n - 1)
    return (
        0.355768
        - 0.487396 * np.cos(t)
        + 0.144232 * np.cos(2 * t)
        - 0.012604 * np.cos(3 * t)
    )


def _lowpass_filtered(x_spec: np.ndarray, fft_size: int, fs: float, boundary_f0: float) -> np.ndarray:
    """Filter the signal (given as rFFT) with a Nuttall FIR whose main lobe
    acts as a low-pass around boundary_f0; returns the time-domain signal
    with the group delay compensated."""
    half_avg = int(round(fs / boundary_f0 / 2.0))
    filter_len = half_avg * 4
    lpf = np.zeros(fft_size)
    lpf[:filter_len] = _nuttall(filter_len)
    lpf_spec = np.fft.rfft(lpf)
    y = np.fft.irfft(x_spec * lpf_spec, fft_size)
    # compensate the FIR delay of filter_len/2 samples
    return y[filter_len // 2 : filter_len // 2 + fft_size]


def _zero_crossings(sig: np.ndarray, fs: float) -> Tuple[np.ndarray, np.ndarray]:
    """Negative-going zero-crossing events → (interval midpoints [s], interval F0s)."""
    neg = np.where((sig[:-1] > 0.0) & (sig[1:] <= 0.0))[0]
    if len(neg) < 2:
        return np.array([]), np.array([])
    # linear-interpolated crossing times
    t = (neg + sig[neg] / (sig[neg] - sig[neg + 1])) / fs
    intervals = np.diff(t)
    locations = (t[:-1] + t[1:]) / 2.0
    f0 = 1.0 / np.maximum(intervals, _EPS)
    return locations, f0


def _four_event_candidates(
    filtered: np.ndarray, fs: float, temporal_positions: np.ndarray
) -> Tuple[np.ndarray, np.ndarray]:
    """F0 candidate and stability score per frame from 4 interval estimators."""
    n = len(temporal_positions)
    estimates = np.zeros((4, n))
    ok = True
    events = (
        _zero_crossings(filtered, fs),  # negative-going
        _zero_crossings(-filtered, fs),  # positive-going
        _zero_crossings(np.diff(filtered), fs),  # peaks
        _zero_crossings(-np.diff(filtered), fs),  # dips
    )
    for row, (locs, f0s) in enumerate(events):
        if len(locs) < 2:
            ok = False
            break
        estimates[row] = np.interp(
            temporal_positions, locs, f0s, left=f0s[0], right=f0s[-1]
        )
        # zero out frames outside the observed event span
        outside = (temporal_positions < locs[0]) | (temporal_positions > locs[-1])
        estimates[row, outside] = 0.0
    if not ok:
        return np.zeros(n), np.full(n, np.inf)
    candidate = estimates.mean(axis=0)
    score = estimates.std(axis=0, ddof=1)
    # frames where any estimator lost track are unreliable
    candidate[np.any(estimates <= 0.0, axis=0)] = 0.0
    return candidate, score


def _fix_step1_octave_jumps(f0: np.ndarray, allowed_range: float) -> np.ndarray:
    out = f0.copy()
    prev = np.concatenate([[f0[0]], f0[:-1]])
    rel = np.abs(f0 - prev) / np.maximum(f0, _EPS)
    out[(rel > allowed_range) & (prev > 0)] = 0.0
    return out


def _fix_step2_short_segments(f0: np.ndarray, min_frames: int) -> np.ndarray:
    out = f0.copy()
    voiced = out > 0
    i = 0
    n = len(out)
    while i < n:
        if voiced[i]:
            j = i
            while j < n and voiced[j]:
                j += 1
            if j - i < min_frames:
                out[i:j] = 0.0
            i = j
        else:
            i += 1
    return out


def _fix_step34_extend(
    f0: np.ndarray,
    candidates: np.ndarray,
    allowed_range: float,
) -> np.ndarray:
    """Extend voiced segments forward/backward using the candidate bank,
    picking the band candidate closest to the extrapolated F0."""
    out = f0.copy()
    n = len(out)
    for direction in (1, -1):
        rng = range(1, n) if direction == 1 else range(n - 2, -1, -1)
        for i in rng:
            if out[i] > 0 or out[i - direction] <= 0:
                continue
            ref = out[i - direction]
            cands = candidates[:, i]
            valid = cands > 0
            if not valid.any():
                continue
            err = np.abs(cands - ref) / max(ref, _EPS)
            err[~valid] = np.inf
            k = int(np.argmin(err))
            if err[k] < allowed_range:
                out[i] = cands[k]
    return out


def dio(
    x: np.ndarray,
    fs: int,
    frame_period: float = 16.0,
    f0_floor: float = 71.0,
    f0_ceil: float = 800.0,
    channels_in_octave: float = 2.0,
    allowed_range: float = 0.1,
) -> Tuple[np.ndarray, np.ndarray]:
    """DIO F0 estimation.

    Returns (f0, temporal_positions); unvoiced frames are 0.  Frame count is
    ``len(x) / fs * 1000 / frame_period + 1`` (pyworld convention, so the F0
    track aligns 1:1 with hop-aligned mel frames).
    """
    x = np.asarray(x, dtype=np.float64)
    n_frames = int(len(x) / fs * 1000.0 / frame_period) + 1
    temporal_positions = np.arange(n_frames) * frame_period / 1000.0
    if len(x) < 16:
        return np.zeros(n_frames), temporal_positions

    num_bands = 1 + int(np.log2(f0_ceil / f0_floor) * channels_in_octave)
    boundary_f0s = f0_floor * 2.0 ** ((np.arange(num_bands) + 1) / channels_in_octave)

    max_filter_len = int(round(fs / boundary_f0s[0] / 2.0)) * 4
    fft_size = 1 << int(np.ceil(np.log2(len(x) + max_filter_len + 1)))
    xd = x - x.mean()
    x_spec = np.fft.rfft(xd, fft_size)

    candidates = np.zeros((num_bands, n_frames))
    scores = np.full((num_bands, n_frames), np.inf)
    for b, bf0 in enumerate(boundary_f0s):
        filtered = _lowpass_filtered(x_spec, fft_size, fs, bf0)[: len(x)]
        cand, score = _four_event_candidates(filtered, fs, temporal_positions)
        # candidates must sit inside this band and the global range
        bad = (
            (cand < bf0 / 2.0)
            | (cand > bf0 * 2.0)
            | (cand < f0_floor)
            | (cand > f0_ceil)
        )
        cand[bad] = 0.0
        score[bad] = np.inf
        # normalize stability by frequency so bands compare fairly
        score = score / np.maximum(cand, _EPS)
        score[cand <= 0] = np.inf
        candidates[b] = cand
        scores[b] = score

    best_band = np.argmin(scores, axis=0)
    base_f0 = candidates[best_band, np.arange(n_frames)]
    base_f0[~np.isfinite(scores[best_band, np.arange(n_frames)])] = 0.0

    # contour fixing
    voice_range_minimum = int(0.5 + 1000.0 / frame_period / f0_floor) * 2 + 1
    f0 = _fix_step1_octave_jumps(base_f0, allowed_range)
    f0 = _fix_step2_short_segments(f0, voice_range_minimum)
    f0 = _fix_step34_extend(f0, candidates, allowed_range)
    return f0, temporal_positions


def _refine_once(
    x: np.ndarray, fs: int, t: float, f0_init: float, f0_floor: float, f0_ceil: float
) -> float:
    if f0_init <= 0:
        return 0.0
    half_win = int(1.5 * fs / f0_init + 0.5)
    win_len = 2 * half_win + 1
    center = int(round(t * fs))
    idx = np.clip(np.arange(center - half_win, center + half_win + 1), 0, len(x) - 1)
    seg = x[idx]

    # Blackman window and its derivative
    tw = (np.arange(win_len) - half_win) / fs
    omega_w = 2.0 * np.pi / (win_len / fs)
    window = 0.42 + 0.5 * np.cos(omega_w * tw) + 0.08 * np.cos(2 * omega_w * tw)
    diff_window = -(
        0.5 * omega_w * np.sin(omega_w * tw)
        + 0.16 * omega_w * np.sin(2 * omega_w * tw)
    )

    fft_size = 1 << int(np.ceil(np.log2(win_len) + 1))
    main_spec = np.fft.rfft(seg * window, fft_size)
    diff_spec = np.fft.rfft(seg * diff_window, fft_size)

    power = main_spec.real**2 + main_spec.imag**2
    # IF(ω) = ω − Im{X_dh(ω)·conj(X_h(ω))} / (2π |X_h(ω)|²)  [Hz], with the
    # numpy rfft sign convention (e^{-i2πkn/N}) and dh/dt per second
    inst_freq_num = (
        main_spec.real * diff_spec.imag - main_spec.imag * diff_spec.real
    )
    freqs = np.arange(len(main_spec)) * fs / fft_size
    inst_freq = freqs - inst_freq_num / np.maximum(power, _EPS) / (2.0 * np.pi)

    n_harmonics = min(int(fs / 2.0 / f0_init), 6)
    if n_harmonics < 1:
        return 0.0
    num = 0.0
    den = 0.0
    for k in range(1, n_harmonics + 1):
        bin_idx = int(round(k * f0_init * fft_size / fs))
        if bin_idx >= len(main_spec):
            break
        amp = np.sqrt(power[bin_idx])
        num += inst_freq[bin_idx] * amp / k
        den += amp
    if den <= _EPS:
        return 0.0
    refined = num / den
    if refined < f0_floor or refined > f0_ceil:
        return 0.0
    return float(refined)


def stonemask(
    x: np.ndarray,
    f0: np.ndarray,
    temporal_positions: np.ndarray,
    fs: int,
    f0_floor: float = 71.0,
    f0_ceil: float = 800.0,
) -> np.ndarray:
    """Refine a coarse F0 track via instantaneous-frequency re-estimation."""
    x = np.asarray(x, dtype=np.float64)
    out = np.zeros_like(f0)
    for i, (t, f) in enumerate(zip(temporal_positions, f0)):
        if f <= 0:
            continue
        r1 = _refine_once(x, fs, t, f, f0_floor, f0_ceil)
        if r1 <= 0:
            continue
        r2 = _refine_once(x, fs, t, r1, f0_floor, f0_ceil)
        out[i] = r2 if r2 > 0 else r1
    return out


def extract_f0(
    y: np.ndarray, hop_length: int, sampling_rate: int
) -> np.ndarray:
    """Hop-aligned F0 (reference: get_pitch, rank_model/audio_util.py:16-20)."""
    frame_period = hop_length / sampling_rate * 1000.0
    f0, t = dio(y, sampling_rate, frame_period=frame_period)
    return stonemask(y, f0, t, sampling_rate)


def interpolate_unvoiced(pitch: np.ndarray) -> np.ndarray:
    """Linearly interpolate F0 through unvoiced (zero) gaps, holding the
    first/last voiced values at the edges (reference:
    rank_model/preprocess.py:106-112)."""
    nz = np.where(pitch != 0)[0]
    if len(nz) == 0:
        return pitch
    return np.interp(np.arange(len(pitch)), nz, pitch[nz])
