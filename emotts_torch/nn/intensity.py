"""IntensityExtractor and RankModel (the emotion-intensity ranking model).

Counterpart of ``emotts/nn/intensity.py``:

* the two mixup branches run through the extractor as one batched stream
  (``cat([X_i, X_j])`` on the batch axis: 2B rows, one pass);
* mixup weights λ are uniform on [0, 1) (Beta(1, 1)), drawn from the
  caller's generator (under data parallelism: this rank's columns of the
  global (2, B) draw), or supplied (validation uses a linspace grid,
  bucketization λ ≡ 1);
* inputs are padded (B, T, n_mels + 2) with a length vector.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from emotts_torch.nn.blocks import CastLinear, FFTStack, sequence_mask
from emotts_torch.parallel.mesh import draw_rows, grouped


def _gelu_exact(x: torch.Tensor) -> torch.Tensor:
    """The erf GELU, not the tanh approximation."""
    return F.gelu(x, approximate="none")


class IntensityExtractor(nn.Module):
    """Frame-level emotion-intensity logits I ∈ (B, T, n_emotions).

    Linear(n_mels+2 → H) → N× FFT block (GELU conv-FFN, kernel (k, k),
    post-norm, LayerNorm eps 1e-5, no final norm) → add the emotion embedding
    *after* the stack → zero padded frames → Linear(H → n_emotions), fp32 out.
    """

    def __init__(self, n_mels: int = 80, n_heads: int = 2, n_emotions: int = 5,
                 n_layers: int = 6, hidden_dim: int = 384, kernel_size: int = 9,
                 ffn_mult: int = 4, dropout: float = 0.1,
                 fused_attention: bool = False,
                 dtype: torch.dtype = torch.float32, remat: bool = False):
        super().__init__()
        self.dtype = dtype
        self.input_proj = CastLinear(n_mels + 2, hidden_dim)
        self.fft = FFTStack(
            num_layers=n_layers, d_model=hidden_dim, n_heads=n_heads,
            ffn_dim=hidden_dim * ffn_mult, kernel_sizes=(kernel_size, kernel_size),
            activation=_gelu_exact, normalize_before=False, final_norm=False,
            ln_eps=1e-5, fused_attention=fused_attention, dtype=dtype,
            dropout=dropout, ffn_internal_dropout=True, remat=remat,
        )
        self.emotion_embedding = nn.Embedding(n_emotions, hidden_dim)
        self.classifier = CastLinear(hidden_dim, n_emotions)

    def forward(self, x: torch.Tensor, lengths: torch.Tensor,
                emotions: torch.Tensor, deterministic: bool = True,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        valid = sequence_mask(lengths, x.shape[1])  # (B, T)
        h = self.input_proj(x.to(self.dtype))
        h = self.fft(h, valid, deterministic, generator)
        emo = self.emotion_embedding(emotions.long()).to(self.dtype)
        h = h + emo[:, None, :]
        h = torch.where(valid[:, :, None], h, torch.zeros((), dtype=h.dtype,
                                                          device=h.device))
        return self.classifier(h).float()


class RankModel(nn.Module):
    """Mixup + pairwise-ranking head over the IntensityExtractor.

    Returns (λ_i, λ_j, I_i, I_j, h_i, h_j, r_i, r_j) as the reference does."""

    def __init__(self, n_mels: int = 80, n_heads: int = 2, n_emotions: int = 5,
                 n_layers: int = 6, hidden_dim: int = 384, kernel_size: int = 9,
                 ffn_mult: int = 4, dropout: float = 0.1,
                 fused_attention: bool = False,
                 dtype: torch.dtype = torch.float32, remat: bool = False):
        super().__init__()
        self.intensity_extractor = IntensityExtractor(
            n_mels, n_heads, n_emotions, n_layers, hidden_dim, kernel_size,
            ffn_mult, dropout, fused_attention, dtype, remat,
        )
        self.projector = nn.Linear(n_emotions, 1, bias=False)  # fp32

    def forward(
        self,
        emo_x: torch.Tensor,  # (B, T, C)
        neu_x: torch.Tensor,  # (B, T, C)
        emotions: torch.Tensor,  # (B,)
        lengths: torch.Tensor,  # (B,)
        lambdas: Optional[torch.Tensor] = None,  # (2, B) or None → uniform
        deterministic: bool = True,
        mixup_generator: Optional[torch.Generator] = None,
        dropout_generator: Optional[torch.Generator] = None,
    ) -> Tuple[torch.Tensor, ...]:
        b = emo_x.shape[0]
        if lambdas is None:
            if mixup_generator is None:
                raise ValueError("sampling λ needs the caller's torch.Generator")
            lambdas = draw_rows(torch.rand, (2, b), mixup_generator, dim=1,
                                device=emo_x.device)
        lam_i = lambdas[0][:, None, None]  # (B, 1, 1)
        lam_j = lambdas[1][:, None, None]
        xi = lam_i * emo_x + (1.0 - lam_i) * neu_x
        xj = lam_j * emo_x + (1.0 - lam_j) * neu_x

        # one batched extractor pass over both mixes (2B, T, C)
        logits = self.intensity_extractor(
            torch.cat([xi, xj], dim=0),
            torch.cat([lengths, lengths], dim=0),
            torch.cat([emotions, emotions], dim=0),
            deterministic, grouped(dropout_generator, 2),
        )
        ii, ij = logits[:b], logits[b:]

        # masked time-average pooling (pad frames are exact zeros)
        denom = lengths[:, None].float()
        hi = ii.sum(dim=1) / denom  # (B, n_emotions)
        hj = ij.sum(dim=1) / denom
        ri = self.projector(hi)[:, 0]  # (B,)
        rj = self.projector(hj)[:, 0]
        return lam_i, lam_j, ii, ij, hi, hj, ri, rj
