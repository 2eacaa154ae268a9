"""Plotting / qualitative-artifact helpers.

Counterpart of ``emotts/utils/plotting.py``: mel-spectrogram images,
predicted-against-ground-truth mel grids, the t-SNE scatter of pooled
intensity features (colored by emotion, marked by speaker), the
mel-with-pitch-and-energy plot and the intensity sweep's score-against-level
figure.  matplotlib (Agg backend) and scikit-learn are imported inside the
functions.  Where one is missing, a function writes one line to stderr and
returns False: training and evaluation never stop for an image.  Every
function returns True when it wrote its file.
"""

from __future__ import annotations

import sys
from typing import Optional, Sequence

import numpy as np

DEFAULT_COLORS = ["#7C00FE", "#F9E400", "#FFAF00", "#F5004F", "#00B2A9"]
DEFAULT_MARKERS = ["o", "^", "s", "d"]


def _plt(what: str):
    """matplotlib's pyplot on the Agg backend, or None (after one line to
    stderr naming the image not written) when matplotlib is missing."""
    try:
        import matplotlib

        matplotlib.use("Agg")
        import matplotlib.pyplot as plt
    except ImportError:
        print(f"[plot] matplotlib is not installed: {what} not written",
              file=sys.stderr)
        return None
    return plt


def have_matplotlib() -> bool:
    """Whether the images can be written here."""
    try:
        import matplotlib  # noqa: F401
    except ImportError:
        return False
    return True


def plot_melspectrogram(mel: np.ndarray, save_path: str, title: str = "Mel") -> bool:
    plt = _plt(save_path)
    if plt is None:
        return False
    fig, ax = plt.subplots(figsize=(10, 4))
    im = ax.imshow(mel, aspect="auto", origin="lower", interpolation="none")
    ax.set_xlabel("frames")
    ax.set_ylabel("mel bins")
    ax.set_title(title)
    fig.colorbar(im, ax=ax)
    fig.tight_layout()
    fig.savefig(save_path, bbox_inches="tight")
    plt.close(fig)
    return True


def plot_mel_grid(
    pred: np.ndarray,  # (N, T, n_mels)
    target: np.ndarray,
    save_path: str,
    max_each: int = 8,
) -> bool:
    """4-column grid: predictions (top half) against ground truth (bottom
    half)."""
    plt = _plt(save_path)
    if plt is None:
        return False
    pred = pred[:max_each]
    target = target[:max_each]
    mels = np.concatenate([pred, target], axis=0)
    n = len(mels)
    rows = max(1, (n + 3) // 4)
    fig, axes = plt.subplots(rows, 4, figsize=(16, 2.5 * rows), squeeze=False)
    for i, ax in enumerate(axes.flatten()):
        if i >= n:
            ax.axis("off")
            continue
        ax.imshow(mels[i].T, aspect="auto", origin="lower", interpolation="none")
        label = f"Pred {i + 1}" if i < len(pred) else f"GT {i - len(pred) + 1}"
        ax.text(0.95, 0.95, label, ha="right", va="top", transform=ax.transAxes,
                fontsize=11, fontweight="bold",
                color="tab:blue" if i < len(pred) else "tab:red")
    fig.tight_layout()
    fig.savefig(save_path, bbox_inches="tight", dpi=150)
    plt.close(fig)
    return True


def plot_tsne(
    features: np.ndarray,  # (N, D) pooled intensity features
    emotions: np.ndarray,  # (N,) int labels
    speakers: np.ndarray,  # (N,) int labels
    alphas: Optional[np.ndarray],
    emotion_names: Sequence[str],
    speaker_names: Sequence[str],
    colors: Sequence[str],
    markers: Sequence[str],
    save_path: str,
) -> bool:
    """t-SNE scatter of intensity features; False (nothing written) with
    fewer than 8 points or without scikit-learn or matplotlib."""
    if len(features) < 8:
        return False
    try:
        from sklearn.manifold import TSNE
    except ImportError:
        print(f"[plot] scikit-learn is not installed: {save_path} not written",
              file=sys.stderr)
        return False
    plt = _plt(save_path)
    if plt is None:
        return False
    import matplotlib.patches as mpatches
    from matplotlib.lines import Line2D

    perplexity = min(30.0, max(2.0, len(features) / 4 - 1))
    pts = TSNE(n_components=2, perplexity=perplexity, init="random").fit_transform(
        features
    )
    if alphas is None:
        alphas = np.ones(len(features))
    fig, ax = plt.subplots(figsize=(10, 10))
    for e in range(len(emotion_names)):
        for s in range(len(speaker_names)):
            mask = (emotions == e) & (speakers == s)
            if not mask.any():
                continue
            ax.scatter(
                pts[mask, 0], pts[mask, 1],
                c=colors[e % len(colors)], marker=markers[s % len(markers)],
                s=15, alpha=np.minimum(1.0, alphas[mask] + 0.1),
            )
    handles_e = [
        mpatches.Patch(color=colors[i % len(colors)], label=emotion_names[i])
        for i in range(len(emotion_names))
    ]
    handles_s = [
        Line2D([], [], color="black", marker=markers[i % len(markers)],
               linestyle="None", label=speaker_names[i])
        for i in range(len(speaker_names))
    ]
    leg1 = ax.legend(handles=handles_e, title="Emotion", loc="upper left",
                     bbox_to_anchor=(1.02, 1))
    ax.add_artist(leg1)
    ax.legend(handles=handles_s, title="Speaker", loc="upper left",
              bbox_to_anchor=(1.02, 0.6))
    ax.set_title("t-SNE of pooled intensity features")
    ax.grid(True, linestyle="--", alpha=0.3)
    fig.tight_layout()
    fig.savefig(save_path, bbox_inches="tight")
    plt.close(fig)
    return True


def plot_features(
    mel: np.ndarray,  # (n_mels, T)
    pitch: np.ndarray,  # (T,) z-normalized
    energy: np.ndarray,  # (T,) z-normalized
    stats: dict,  # {'pitch': [min,max,mean,std], 'energy': [...]}
    save_path: str,
) -> bool:
    """Mel with the denormalized pitch and energy curves overlaid."""
    plt = _plt(save_path)
    if plt is None:
        return False
    p_min, p_max, p_mean, p_std = stats["pitch"]
    e_min, e_max, e_mean, e_std = stats["energy"]
    pitch_hz = pitch * p_std + p_mean
    energy_v = energy * e_std + e_mean

    fig, ax = plt.subplots(figsize=(10, 3))
    ax.imshow(mel, aspect="auto", origin="lower", interpolation="none")
    ax.set_xlabel("Time (frames)")
    ax.set_title("Mel + pitch + energy")

    ax1 = ax.twinx()
    ax1.plot(pitch_hz, color="tomato", linewidth=2, label="pitch")
    ax1.set_ylim(p_min * p_std + p_mean, p_max * p_std + p_mean)
    ax1.set_ylabel("Pitch (Hz)", color="tomato")

    ax2 = ax.twinx()
    ax2.spines["right"].set_position(("axes", 1.08))
    ax2.plot(energy_v, color="darkviolet", linewidth=2, label="energy")
    ax2.set_ylim(e_min * e_std + e_mean, e_max * e_std + e_mean)
    ax2.set_ylabel("Energy", color="darkviolet")

    fig.tight_layout()
    fig.savefig(save_path, bbox_inches="tight")
    plt.close(fig)
    return True


def plot_intensity_sweep(report: dict, save_path: str) -> bool:
    """Rank score against commanded intensity level, one line per (speaker,
    emotion) cell of the intensity-efficacy report (or its saved JSON):
    ``levels`` and ``by_cell[cell]["score_mean_per_level"]``.  A rising line
    means the commanded level moved the synthesized audio along the learned
    intensity axis; cells that are not monotone are drawn dashed."""
    plt = _plt(save_path)
    if plt is None:
        return False
    first = next(iter(report["by_cell"].values()), None)
    levels = report.get("levels") or list(
        range(len(first["score_mean_per_level"]) if first else 0)
    )
    cells = report["by_cell"]
    speakers = sorted({c.split("/")[0] for c in cells})
    emotions = sorted({c.split("/")[1] for c in cells})
    n = max(1, len(speakers))
    fig, axes = plt.subplots(1, n, figsize=(3.2 * n, 3.4), sharey=True,
                             squeeze=False)
    seen_labels: dict = {}  # emotion -> handle, across all panels
    for si, spk in enumerate(speakers):
        ax = axes[0][si]
        for ei, emo in enumerate(emotions):
            cell = cells.get(f"{spk}/{emo}")
            if cell is None:
                continue
            color = DEFAULT_COLORS[ei % len(DEFAULT_COLORS)]
            style = "-" if cell.get("monotone_strict", True) else "--"
            # a cell with no synthesized frames at some level has fewer
            # scores than levels: plot the scores at their own levels
            ys = cell["score_mean_per_level"]
            xs = cell.get("levels", levels[: len(ys)])
            n_pts = min(len(xs), len(ys))
            (line,) = ax.plot(xs[:n_pts], ys[:n_pts], style,
                              marker="o", markersize=4, color=color)
            seen_labels.setdefault(emo, line)
        ax.set_title(spk, fontsize=10)
        ax.set_xlabel("intensity level")
        ax.set_xticks(levels)
        if si == 0:
            ax.set_ylabel("rank score of synthesized audio")
    if seen_labels:
        fig.legend(seen_labels.values(), seen_labels.keys(),
                   loc="upper center", ncol=len(seen_labels),
                   frameon=False, bbox_to_anchor=(0.5, 1.02))
    acc = report.get("pairwise_order_accuracy")
    verdict = report.get("verdict", "")
    sub = f"pairwise order accuracy {acc:.3f}" if acc is not None else ""
    fig.suptitle(f"Intensity-control efficacy ({verdict}) — {sub}",
                 y=1.12, fontsize=11)
    fig.tight_layout()
    fig.savefig(save_path, bbox_inches="tight", dpi=120)
    plt.close(fig)
    return True
