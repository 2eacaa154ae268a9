"""Rank-model loss: λ-weighted mixup cross-entropy + RankNet-style BCE.

Counterpart of ``emotts/losses/rank.py``, with the quirk it keeps: the
cross-entropies are **batch-mean scalars** weighted per sample afterwards:

    L_mixup = mean_b[ λ_i[b]·CE(h_i, y_emo) + (1−λ_i[b])·CE(h_i, y_neu)
                    + λ_j[b]·CE(h_j, y_emo) + (1−λ_j[b])·CE(h_j, y_neu) ]
    p_ij    = σ(r_i − r_j)
    λ_diff  = (λ_i − λ_j + 1) / 2
    L_rank  = −mean_b[ λ_diff·log(p_ij+ε) + (1−λ_diff)·log(1−p_ij+ε) ]
    L       = α·L_mixup + β·L_rank,   ε = 1e-8
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from emotts_torch.parallel.mesh import global_sum


def _wmeans(xs, w: Optional[torch.Tensor], mesh=None):
    """Batch means of the (B,) vectors ``xs``, optionally weighted by a (B,)
    row mask/weight vector; under data parallelism over the global batch
    (one differentiable all-reduce of the numerators and the weight sum)."""
    w = torch.ones_like(xs[0]) if w is None else w.to(xs[0].dtype)
    sums = torch.stack([(x * w).sum() for x in xs] + [w.sum()])
    sums = global_sum(sums, mesh)
    return sums[:-1] / torch.clamp(sums[-1], min=1.0)


def rank_loss(
    predictions: Tuple[torch.Tensor, ...],
    y_emo: torch.Tensor,
    alpha: float = 0.1,
    beta: float = 1.0,
    row_weights: Optional[torch.Tensor] = None,
    mesh=None,
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """predictions = (λ_i, λ_j, I_i, I_j, h_i, h_j, r_i, r_j); y_neu ≡ 0
    (neutral is class 0).

    ``row_weights`` (optional, (B,)) masks rows out of every batch
    reduction — used by eval so that rows a loader duplicated to fill a
    batch do not bias validation metrics.  ``mesh`` (``parallel.mesh.Mesh``):
    the batch is this rank's rows, and every batch mean — the cross-entropy
    means the per-sample λ multiply among them — is over the global batch,
    so every rank gets the global loss."""
    lam_i, lam_j, _, _, hi, hj, ri, rj = predictions
    lam_i = lam_i.reshape(-1)  # (B,)
    lam_j = lam_j.reshape(-1)
    y_emo = y_emo.long()
    y_neu = torch.zeros_like(y_emo)

    def ce(logits, labels):
        return F.cross_entropy(logits, labels, reduction="none")

    ce_i_emo, ce_i_neu, ce_j_emo, ce_j_neu = _wmeans(
        [ce(hi, y_emo), ce(hi, y_neu), ce(hj, y_emo), ce(hj, y_neu)],
        row_weights, mesh)

    li = lam_i * ce_i_emo + (1.0 - lam_i) * ce_i_neu  # (B,)
    lj = lam_j * ce_j_emo + (1.0 - lam_j) * ce_j_neu

    pij = 1.0 / (1.0 + torch.exp(-(ri - rj)))  # σ(r_i − r_j)
    lam_diff = (lam_i - lam_j + 1.0) / 2.0
    eps = 1e-8
    l_mixup, neg_rank = _wmeans(
        [li + lj,
         lam_diff * torch.log(pij + eps) + (1.0 - lam_diff) * torch.log(1.0 - pij + eps)],
        row_weights, mesh)
    l_rank = -neg_rank

    total = alpha * l_mixup + beta * l_rank
    return total, {"loss": total, "mixup_loss": l_mixup, "rank_loss": l_rank}
