"""Duration-driven length regulation — counterpart of
``emotts/nn/length_regulator.py``: batched gathers and cumulative sums over a
fixed frame grid, no Python loops over phones or frames.  ``segment_mean``
is the train-time bridge from frame-level features to phones."""

from __future__ import annotations

from typing import Tuple

import torch


def phone_index_map(durations: torch.Tensor, max_len: int) -> torch.Tensor:
    """(B, P) int durations → (B, T) index of the phone covering each frame.

    Frames beyond Σdurations map to the last phone index (callers mask them).
    """
    ends = torch.cumsum(durations, dim=1)  # (B, P)
    frames = torch.arange(max_len, dtype=ends.dtype, device=ends.device)
    # phon_idx[b, t] = #{p : ends[b, p] <= t}
    idx = torch.searchsorted(ends, frames[None, :].expand(ends.shape[0], -1).contiguous(),
                             right=True)
    return torch.clamp(idx, max=durations.shape[1] - 1)


def length_regulate(
    x: torch.Tensor,  # (B, P, D) phone-level features
    durations: torch.Tensor,  # (B, P) int frames per phone
    max_len: int,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Expand phone features to the frame grid; returns (frames, mel_lens).

    frames: (B, max_len, D), zeroed past each sample's Σdurations.
    mel_lens: (B,) = Σdurations (clipped to max_len).
    """
    idx = phone_index_map(durations, max_len)  # (B, T)
    out = torch.gather(x, 1, idx[..., None].expand(-1, -1, x.shape[-1]))
    mel_lens = torch.clamp(durations.sum(dim=1), max=max_len)
    mask = torch.arange(max_len, device=x.device)[None, :] < mel_lens[:, None]
    return out * mask[..., None].to(x.dtype), mel_lens


def average_over_durations(
    values: torch.Tensor,  # (B, T) frame-level track (pad frames must be 0)
    durations: torch.Tensor,  # (B, P) int
) -> torch.Tensor:
    """Per-phone mean of a frame track → (B, P); zero-duration phones → 0."""
    b, t = values.shape
    d = torch.clamp(durations, min=0).long()
    ends = torch.clamp(torch.cumsum(d, dim=1), 0, t)  # (B, P)
    starts = torch.clamp(ends - d, 0, t)
    csum = torch.cat(
        [values.new_zeros((b, 1)), torch.cumsum(values, dim=1)], dim=1
    )  # (B, T+1)
    sums = torch.gather(csum, 1, ends) - torch.gather(csum, 1, starts)
    counts = (ends - starts).to(values.dtype)
    return torch.where(
        counts > 0, sums / torch.clamp(counts, min=1.0), torch.zeros_like(sums)
    )


def segment_mean(
    frames: torch.Tensor,  # (B, T, D) frame-level features (pad frames 0)
    durations: torch.Tensor,  # (B, P) int
) -> torch.Tensor:
    """Duration-windowed mean of frame features → (B, P, D); a phone with
    no frames gets zeros.  Windows are clamped into [0, T]."""
    b, t, d_feat = frames.shape
    d = torch.clamp(durations, min=0).long()
    ends = torch.clamp(torch.cumsum(d, dim=1), 0, t)
    starts = torch.clamp(ends - d, 0, t)
    csum = torch.cat(
        [frames.new_zeros((b, 1, d_feat)), torch.cumsum(frames, dim=1)], dim=1
    )  # (B, T+1, D)
    sums = (torch.gather(csum, 1, ends[..., None].expand(-1, -1, d_feat))
            - torch.gather(csum, 1, starts[..., None].expand(-1, -1, d_feat)))
    counts = (ends - starts).to(frames.dtype)[..., None]
    return torch.where(
        counts > 0, sums / torch.clamp(counts, min=1.0), torch.zeros_like(sums)
    )
