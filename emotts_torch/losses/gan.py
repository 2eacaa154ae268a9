"""HiFi-GAN training losses: LSGAN adversarial terms, feature matching, and
log-mel reconstruction.

Counterpart of ``emotts/losses/gan.py`` (Kong et al., 2020): least-squares
GAN objectives, L1 feature matching over every discriminator layer, L1
log-mel loss.  The discriminators hand their outputs over in the compute
dtype (bf16 by default); every square and absolute value here reduces in
fp32 whatever that dtype is.
"""

from __future__ import annotations

from typing import List

import torch


def discriminator_loss(real_outs: List[torch.Tensor],
                       fake_outs: List[torch.Tensor]) -> torch.Tensor:
    """Σ_d  E[(1 − D_d(y))²] + E[D_d(ŷ)²]  (ŷ detached by the caller)."""
    loss = 0.0
    for r, f in zip(real_outs, fake_outs):
        loss = loss + (torch.mean(torch.square(1.0 - r.float()))
                       + torch.mean(torch.square(f.float())))
    return loss


def generator_adversarial_loss(fake_outs: List[torch.Tensor]) -> torch.Tensor:
    """Σ_d  E[(1 − D_d(ŷ))²]."""
    loss = 0.0
    for f in fake_outs:
        loss = loss + torch.mean(torch.square(1.0 - f.float()))
    return loss


def feature_matching_loss(real_feats: List[List[torch.Tensor]],
                          fake_feats: List[List[torch.Tensor]]) -> torch.Tensor:
    """Σ_d Σ_layers  E|feat_real − feat_fake|  (real features detached by the
    caller; gradients reach the generator through the fake features)."""
    loss = 0.0
    for rf, ff in zip(real_feats, fake_feats):
        for r, f in zip(rf, ff):
            loss = loss + torch.mean(torch.abs(r.float() - f.float()))
    return loss


def mel_l1_loss(mel_fake: torch.Tensor, mel_real: torch.Tensor) -> torch.Tensor:
    return torch.mean(torch.abs(mel_fake - mel_real))
