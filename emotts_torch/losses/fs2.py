"""FastSpeech2 composite loss: masked MSEs + SSIM, fully vectorized.

Counterpart of ``emotts/losses/fs2.py``, with its semantics:

* each masked MSE is the mean over one sample's valid positions, then the
  mean over the batch (optionally weighted by ``row_weights``, which masks
  out rows the loader duplicated to fill an eval batch);
* phone-level pitch/energy predictions are masked with ``phon_len``, and
  their targets are the duration-averaged phone-level tracks the model
  returns (``avg_pitch``/``avg_energy``);
* SSIM: per-sample min-max normalization over the valid region, an 11-tap
  Gaussian window (σ = 1.5) applied as two separable shift-and-add passes
  with zero (SAME) padding, C1 = 0.01², C2 = 0.03² at data range 1, and
  loss = 1 − mean SSIM over the valid frames, clamped to [0, 1].
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from emotts_torch.parallel.mesh import global_sum
from emotts_torch.utils.config import LossConfig


def _masked_per_sample_mse(
    pred: torch.Tensor,
    target: torch.Tensor,
    valid: torch.Tensor,
    row_weights: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-sample masked MSE, then batch mean (optionally row-weighted), as
    the (numerator, denominator) pair of that mean.

    pred/target: (B, T) or (B, T, C); valid: (B, T) bool; row_weights:
    optional (B,)."""
    if pred.dim() == 3:
        mask = valid[..., None].to(pred.dtype)
        per_elem = (pred - target) ** 2 * mask
        denom = valid.sum(dim=1).to(pred.dtype) * pred.shape[-1]
        per_sample = per_elem.sum(dim=(1, 2)) / torch.clamp(denom, min=1.0)
    else:
        mask = valid.to(pred.dtype)
        per_elem = (pred - target) ** 2 * mask
        denom = valid.sum(dim=1).to(pred.dtype)
        per_sample = per_elem.sum(dim=1) / torch.clamp(denom, min=1.0)
    if row_weights is None:
        return per_sample.sum(), per_sample.new_tensor(float(per_sample.shape[0]))
    w = row_weights.to(per_sample.dtype)
    return (per_sample * w).sum(), w.sum()


def _means(pairs, mesh=None):
    """(numerator, denominator) pairs → means, each denominator clamped at
    1.  Under data parallelism both sums are global: one differentiable
    all-reduce of all of them (``parallel.mesh.global_sum``)."""
    if mesh is not None and mesh.distributed:
        flat = global_sum(torch.stack([t for pair in pairs for t in pair]), mesh)
        pairs = flat.view(-1, 2).unbind(0)
    return [num / torch.clamp(den, min=1.0) for num, den in pairs]


def _gaussian_1d(size: int = 11, sigma: float = 1.5) -> np.ndarray:
    g = np.exp(-((np.arange(size) - size // 2) ** 2) / (2 * sigma**2))
    return (g / g.sum()).astype(np.float32)


def _separable_filter(img: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """The Gaussian window as two 1-D shift-and-add passes over (B, H, W),
    equal to the SAME-padded 2-D conv with the outer-product window."""
    size = g.shape[0]
    r = size // 2
    h, w = img.shape[1], img.shape[2]
    pt = F.pad(img, (0, 0, r, r))
    img = sum(g[j] * pt[:, j:j + h, :] for j in range(size))
    pm = F.pad(img, (r, r))
    return sum(g[i] * pm[:, :, i:i + w] for i in range(size))


def _ssim_map(x: torch.Tensor, y: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """SSIM map over (B, H, W) images (separable Gaussian, SAME padding)."""
    c1, c2 = 0.01**2, 0.03**2
    mu_x, mu_y = _separable_filter(x, g), _separable_filter(y, g)
    sigma_x = _separable_filter(x * x, g) - mu_x**2
    sigma_y = _separable_filter(y * y, g) - mu_y**2
    sigma_xy = _separable_filter(x * y, g) - mu_x * mu_y
    num = (2 * mu_x * mu_y + c1) * (2 * sigma_xy + c2)
    den = (mu_x**2 + mu_y**2 + c1) * (sigma_x + sigma_y + c2)
    return num / den


def _sample_minmax_norm(x: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    """Min-max normalize each sample over its valid frames → [0, 1]."""
    big = torch.tensor(3e38, dtype=x.dtype, device=x.device)
    m = valid[..., None]
    mn = torch.where(m, x, big).amin(dim=(1, 2), keepdim=True)
    mx = torch.where(m, x, -big).amax(dim=(1, 2), keepdim=True)
    out = (x - mn) / torch.clamp(mx - mn, min=1e-8)
    return torch.where(m, out, torch.zeros((), dtype=x.dtype, device=x.device))


_SSIM_KERNEL = _gaussian_1d()


def _ssim_sums(
    pred: torch.Tensor,
    target: torch.Tensor,
    valid: torch.Tensor,
    row_weights: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Σ SSIM over the valid pixels and their count."""
    if row_weights is not None:
        valid = valid & (row_weights[:, None] > 0)
    kernel = torch.from_numpy(_SSIM_KERNEL).to(device=pred.device, dtype=pred.dtype)
    x = _sample_minmax_norm(pred, valid)
    y = _sample_minmax_norm(target, valid)
    smap = _ssim_map(x, y, kernel)  # (B, T, n_mels)
    m = valid[..., None].to(pred.dtype)
    valid_pixels = valid.sum().to(pred.dtype) * pred.shape[-1]
    return (smap * m).sum(), valid_pixels


def ssim_loss(
    pred: torch.Tensor,
    target: torch.Tensor,
    valid: torch.Tensor,
    row_weights: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """1 − masked-mean SSIM over (B, T, n_mels) mels, clamped to [0, 1]."""
    (mean_ssim,) = _means([_ssim_sums(pred, target, valid, row_weights)])
    return torch.clamp(1.0 - mean_ssim, 0.0, 1.0)


def fs2_loss(
    predictions: Tuple[torch.Tensor, ...],
    mel_target: torch.Tensor,  # (B, T, n_mels)
    target_durations: torch.Tensor,  # (B, P) int
    mel_len: torch.Tensor,  # (B,)
    phon_len: torch.Tensor,  # (B,)
    cfg: Optional[LossConfig] = None,
    row_weights: Optional[torch.Tensor] = None,  # (B,) eval row mask
    mesh=None,  # parallel.mesh.Mesh: the batch is this rank's rows
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """(total, parts): the weighted sum and each weighted part.  Under data
    parallelism every mean is over the global batch (its numerators and
    denominators summed over the data axis), so every rank gets the global
    loss."""
    cfg = cfg or LossConfig()
    (mel_out, postnet_mel_out, log_durations, pred_pitch, avg_pitch,
     pred_energy, avg_energy, _mel_lens) = predictions

    t = mel_target.shape[1]
    p = log_durations.shape[1]
    dev = mel_target.device
    frame_valid = torch.arange(t, device=dev)[None, :] < mel_len[:, None]
    phone_valid = torch.arange(p, device=dev)[None, :] < phon_len[:, None]

    tgt_dur = target_durations.float()
    log_tgt_dur = torch.log1p(tgt_dur) if cfg.log_scale_durations else tgt_dur
    mel_l, postnet_l, dur_l, pitch_l, energy_l, mean_ssim = _means([
        _masked_per_sample_mse(mel_out, mel_target, frame_valid, row_weights),
        _masked_per_sample_mse(postnet_mel_out, mel_target, frame_valid,
                               row_weights),
        _masked_per_sample_mse(log_durations, log_tgt_dur, phone_valid,
                               row_weights),
        _masked_per_sample_mse(pred_pitch[..., 0], avg_pitch[..., 0],
                               phone_valid, row_weights),
        _masked_per_sample_mse(pred_energy[..., 0], avg_energy[..., 0],
                               phone_valid, row_weights),
        _ssim_sums(mel_out, mel_target, frame_valid, row_weights),
    ], mesh)
    ssim_l = torch.clamp(1.0 - mean_ssim, 0.0, 1.0)

    parts = {
        "ssim_loss": ssim_l * cfg.ssim_loss_weight,
        "mel_loss": mel_l * cfg.mel_loss_weight,
        "postnet_mel_loss": postnet_l * cfg.postnet_mel_loss_weight,
        "dur_loss": dur_l * cfg.duration_loss_weight,
        "pitch_loss": pitch_l * cfg.pitch_loss_weight,
        "energy_loss": energy_l * cfg.energy_loss_weight,
    }
    total = (parts["ssim_loss"] + parts["mel_loss"] + parts["postnet_mel_loss"]
             + parts["dur_loss"] + parts["pitch_loss"] + parts["energy_loss"])
    return total, {"total_loss": total, **parts}
