"""Objective TTS evaluation metrics: MCD (with optional DTW alignment),
F0 accuracy, and duration accuracy.

The reference evaluates only qualitatively — t-SNE plots, pred-vs-GT mel
grids, and vocoded samples for human inspection (SURVEY.md §4); it computes
no objective quality numbers anywhere.  These host-side numpy metrics give
the framework a quantitative evaluation story (consumed by
emotts_torch/eval/evaluate.py).  Own copy of ``emotts/eval/metrics.py``.

Conventions:
* MCD uses mel-cepstra (orthonormal DCT-II of the log-mel, coefficients
  1..n_coeffs, c0/energy excluded) and the standard 10/ln10·√2 scaling.
* DTW is exact O(T₁·T₂) dynamic programming with a vectorized Euclidean
  cost matrix — fine at utterance scale (T ≤ ~1000).
* F0 metrics follow common practice: RMSE in Hz over frames voiced in BOTH
  tracks, plus the voiced/unvoiced disagreement rate.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np

_MCD_SCALE = 10.0 / np.log(10.0) * np.sqrt(2.0)


def mel_cepstra(log_mel: np.ndarray, n_coeffs: int = 13) -> np.ndarray:
    """(T, M) log-mel → (T, n_coeffs) cepstra c₁..c_n (orthonormal DCT-II)."""
    t, m = log_mel.shape
    n = np.arange(m)
    k = np.arange(1, n_coeffs + 1)
    basis = np.cos(np.pi * np.outer(k, (2 * n + 1) / (2.0 * m)))  # (C, M)
    basis *= np.sqrt(2.0 / m)
    return log_mel @ basis.T


def mcd(ref_ceps: np.ndarray, syn_ceps: np.ndarray) -> float:
    """Frame-aligned mel-cepstral distortion in dB (inputs (T, C))."""
    assert ref_ceps.shape == syn_ceps.shape
    d = np.linalg.norm(ref_ceps - syn_ceps, axis=-1)
    return float(_MCD_SCALE * d.mean())


def _dtw_accumulate(cost: np.ndarray) -> np.ndarray:
    """Anti-diagonal vectorized DTW accumulation (numpy fallback path).

    Cells along the anti-diagonal i+j=k depend only on diagonals k-1 and
    k-2, so the O(T₁·T₂) recurrence runs as T₁+T₂ vectorized sweeps instead
    of a per-cell Python loop (~100× at utterance scale)."""
    t1, t2 = cost.shape
    acc = np.full((t1 + 1, t2 + 1), np.inf)
    acc[0, 0] = 0.0
    for k in range(2, t1 + t2 + 2):
        lo = max(1, k - t2)
        hi = min(t1, k - 1)
        if lo > hi:
            continue
        i = np.arange(lo, hi + 1)
        j = k - i
        best = np.minimum(
            acc[i - 1, j - 1], np.minimum(acc[i - 1, j], acc[i, j - 1])
        )
        acc[i, j] = cost[i - 1, j - 1] + best
    return acc


def _dtw_backtrack(
    acc: np.ndarray, t1: int, t2: int
) -> Tuple[np.ndarray, np.ndarray]:
    i, j = t1, t2
    path_i, path_j = [], []
    while i > 0 and j > 0:
        path_i.append(i - 1)
        path_j.append(j - 1)
        moves = (acc[i - 1, j - 1], acc[i - 1, j], acc[i, j - 1])
        m = int(np.argmin(moves))
        if m == 0:
            i, j = i - 1, j - 1
        elif m == 1:
            i -= 1
        else:
            j -= 1
    return np.asarray(path_i[::-1]), np.asarray(path_j[::-1])


def dtw_path(cost: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """Minimal-cost monotonic path through a (T₁, T₂) cost matrix.

    Returns (idx_ref, idx_syn) index arrays of equal length.  Dispatches to
    the native C++ routine (native/dtw.cc) when built; otherwise runs the
    anti-diagonal vectorized numpy sweep — both implement identical
    accumulation and argmin-tie backtracking semantics."""
    from emotts_torch.audio import native as _native

    if _native.have_native_dtw():
        return _native.dtw_path_native(cost)
    t1, t2 = cost.shape
    acc = _dtw_accumulate(np.asarray(cost, dtype=np.float64))
    return _dtw_backtrack(acc, t1, t2)


def dtw_alignment(
    ref_log_mel: np.ndarray, syn_log_mel: np.ndarray, n_coeffs: int = 13
) -> Tuple[np.ndarray, np.ndarray, float]:
    """DTW over mel-cepstra: (ref frame indices, syn frame indices, MCD dB).

    The frame path is reusable for aligning any other frame-synchronous
    track (e.g. F0 — same hop) between the two sequences."""
    rc = mel_cepstra(ref_log_mel, n_coeffs)
    sc = mel_cepstra(syn_log_mel, n_coeffs)
    # vectorized pairwise Euclidean distances
    sq = (
        np.sum(rc * rc, axis=1)[:, None]
        + np.sum(sc * sc, axis=1)[None, :]
        - 2.0 * rc @ sc.T
    )
    cost = np.sqrt(np.maximum(sq, 0.0))
    pi, pj = dtw_path(cost)
    return pi, pj, float(_MCD_SCALE * cost[pi, pj].mean())


def mcd_dtw(ref_log_mel: np.ndarray, syn_log_mel: np.ndarray,
            n_coeffs: int = 13) -> float:
    """DTW-aligned MCD for sequences of different length (predicted-duration
    synthesis)."""
    return dtw_alignment(ref_log_mel, syn_log_mel, n_coeffs)[2]


def f0_metrics(
    f0_ref: np.ndarray, f0_syn: np.ndarray
) -> Tuple[float, float]:
    """(RMSE in Hz over mutually-voiced frames, V/UV disagreement rate).

    Tracks are compared on their overlapping length; 0 = unvoiced."""
    n = min(len(f0_ref), len(f0_syn))
    r, s = f0_ref[:n], f0_syn[:n]
    vr, vs = r > 0, s > 0
    vuv_err = float(np.mean(vr != vs)) if n else 0.0
    both = vr & vs
    if not both.any():
        return 0.0, vuv_err
    rmse = float(np.sqrt(np.mean(np.square(r[both] - s[both]))))
    return rmse, vuv_err


def duration_metrics(
    dur_ref: np.ndarray, log_dur_pred: np.ndarray, valid: np.ndarray
) -> Tuple[float, float]:
    """(per-phone MAE in frames, total-length relative error) for a predicted
    log-duration sequence vs MFA ground truth (reference round-trip:
    clamp(expm1(log_dur)), fastspeech2/model.py:372-375)."""
    pred = np.round(np.clip(np.expm1(log_dur_pred), 0.0, None))
    pred = pred * valid
    ref = dur_ref * valid
    n = max(int(valid.sum()), 1)
    mae = float(np.abs(pred - ref).sum() / n)
    total_ref = max(float(ref.sum()), 1.0)
    rel = float(abs(pred.sum() - ref.sum()) / total_ref)
    return mae, rel
