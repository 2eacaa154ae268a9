"""The rank model's train step, plain: mixup, the intensity extractor
with its dropouts, the rank loss, the gradients by autograd and AdamW.

Every random draw is worked out again from the step's seed as the
configuration defines the trainer's streams: two generators on the card,
``mixup`` seeded ``seed·7919`` and ``dropout`` seeded ``seed·7919 + 1``.
Per step: λ (2, B) uniform from ``mixup``; then per FFT block, from
``dropout``: one int64 base for the attention's per-example seeds
(``base + row``, wrapped to int32, rows of the 2B stacked mixes), the
residual dropout after attention (2B, T, H), the conv-FFN's inner dropout
(2B, T, 4H), the residual dropout after the FFN (2B, T, H).

Extractor: Linear(n_mels+2 → H) → post-norm FFT blocks (exact GELU,
kernels (9, 9), LayerNorm 1e-5) → + emotion embedding → padded frames
zeroed → Linear(H → n_emotions).  Pooling is the masked time mean; the
ranker a bias-free Linear(n_emotions → 1).  Loss: α·mixup CE + β·RankNet
BCE with the batch-mean cross-entropies weighted per row.  AdamW: betas
0.9 / 0.999, eps 1e-8, decoupled weight decay, moments stored in the
configured moment dtype and all arithmetic in float32."""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from reference import nn
from reference.philox import keep_mask
from reference.precision import FP32


def generators(seed: int, device):
    out = []
    for i in range(2):
        g = torch.Generator(device=device)
        g.manual_seed(seed * 7919 + i)
        out.append(g)
    return out  # mixup, dropout


def _dropout(x, rate, gen):
    keep = torch.rand(x.shape, generator=gen, device=x.device) >= rate
    return torch.where(keep, x / (1.0 - rate), torch.zeros((), device=x.device))


class RankStep:
    def __init__(self, params, config, seed, precision=FP32):
        self.c, self.prec, self.q = config, precision, precision.q
        self.p = {k: v.detach().clone().float().requires_grad_(True)
                  for k, v in params.items()}
        self.mixup, self.dropout = generators(seed, next(iter(params.values())).device)
        self.moments = {k: (torch.zeros_like(v), torch.zeros_like(v)) for k, v in self.p.items()}
        self.count = 0

    def _extractor(self, x, lengths, emotions):
        c, p, q, gen = self.c, self.p, self.q, self.dropout
        rate, heads = c["dropout"], c["heads"]
        n, t, _ = x.shape
        valid = nn.sequence_mask(lengths, t)
        h = nn.linear(x, p, "intensity_extractor.input_proj", q)
        for i in range(c["layers"]):
            name = f"intensity_extractor.fft.layers.{i}"
            base = torch.randint(-2 ** 31, 2 ** 31, (1,), generator=gen,
                                 device=x.device, dtype=torch.int64)
            seeds = ((base + torch.arange(n, device=x.device) + 2 ** 31) % 2 ** 32) - 2 ** 31
            keep = keep_mask(seeds, heads, t, rate)
            a = nn.attention(h, p, f"{name}.attn", heads, valid, q, keep, rate)
            h = nn.layer_norm(h + _dropout(a, rate, gen), p, f"{name}.norm1", 1e-5)
            y = F.gelu(nn.conv1d(h, p, f"{name}.ffn.conv1", q), approximate="none")
            y = nn.conv1d(_dropout(y, rate, gen), p, f"{name}.ffn.conv2", q)
            h = nn.layer_norm(h + _dropout(y, rate, gen), p, f"{name}.norm2", 1e-5)
        h = h + p["intensity_extractor.emotion_embedding.weight"][emotions][:, None, :]
        h = torch.where(valid[..., None], h, torch.zeros((), device=x.device))
        return nn.linear(h, p, "intensity_extractor.classifier", q)

    def loss(self, emo_x, neu_x, emotions, lengths):
        c = self.c
        b = emo_x.shape[0]
        lam = torch.rand((2, b), generator=self.mixup, device=emo_x.device)
        li, lj = lam[0][:, None, None], lam[1][:, None, None]
        xi = li * emo_x + (1 - li) * neu_x
        xj = lj * emo_x + (1 - lj) * neu_x
        logits = self._extractor(torch.cat([xi, xj]), torch.cat([lengths, lengths]),
                                 torch.cat([emotions, emotions]))
        denom = lengths[:, None].float()
        hi, hj = logits[:b].sum(1) / denom, logits[b:].sum(1) / denom
        w = self.p["projector.weight"]
        ri, rj = (self.q(hi) @ self.q(w).T)[:, 0], (self.q(hj) @ self.q(w).T)[:, 0]
        y_emo, y_neu = emotions.long(), torch.zeros_like(emotions.long())

        def ce(logit, y):
            return F.cross_entropy(logit, y, reduction="none").mean()

        lam_i, lam_j = lam[0], lam[1]
        l_mix = (lam_i * ce(hi, y_emo) + (1 - lam_i) * ce(hi, y_neu)
                 + lam_j * ce(hj, y_emo) + (1 - lam_j) * ce(hj, y_neu)).mean()
        pij = 1.0 / (1.0 + torch.exp(-(ri - rj)))
        target = (lam_i - lam_j + 1.0) / 2.0
        l_rank = -(target * torch.log(pij + 1e-8)
                   + (1 - target) * torch.log(1 - pij + 1e-8)).mean()
        return c["alpha"] * l_mix + c["beta"] * l_rank

    def step(self, batch):
        """One step on a collated batch (host arrays); returns the loss and
        the gradients by name."""
        dev = self.p["projector.weight"].device
        t = {k: torch.from_numpy(batch[k]).to(dev) for k in
             ("emo_x", "neu_x", "emotions", "lengths")}
        with self.prec.products():
            for v in self.p.values():
                v.grad = None
            loss = self.loss(t["emo_x"], t["neu_x"], t["emotions"], t["lengths"].long())
            loss.backward()
            grads = {k: v.grad.detach().clone() for k, v in self.p.items()}
            self._adamw()
        return float(loss.detach()), grads

    @torch.no_grad()
    def _adamw(self):
        c = self.c
        b1, b2, eps = 0.9, 0.999, 1e-8
        self.count += 1
        c1 = 1.0 - b1 ** self.count
        c2 = 1.0 - b2 ** self.count
        store = getattr(torch, c["moment_dtype"])
        for k, v in self.p.items():
            m, s = self.moments[k]
            g = v.grad
            m = b1 * m + (1 - b1) * g
            s = b2 * s + (1 - b2) * g * g
            u = (m / c1) / (torch.sqrt(s / c2) + eps) + c["weight_decay"] * v
            v -= c["learning_rate"] * u
            self.moments[k] = (m.to(store).float(), s.to(store).float())


def collate(rows, buckets):
    """A batch as the configuration feeds it: ``rows`` of (emotional
    features (T, C), neutral features (T', C), emotion id); each pair cut
    to the shorter, zero-padded to the smallest frame bucket holding the
    longest pair."""
    lengths = np.array([min(len(e), len(n)) for e, n, _ in rows], np.int32)
    t = next(b for b in buckets if b >= lengths.max())
    c = rows[0][0].shape[1]
    emo = np.zeros((len(rows), t, c), np.float32)
    neu = np.zeros_like(emo)
    for r, ((e, n, _), m) in enumerate(zip(rows, lengths)):
        emo[r, :m], neu[r, :m] = e[:m], n[:m]
    return {"emo_x": emo, "neu_x": neu, "lengths": lengths,
            "emotions": np.array([k for _, _, k in rows], np.int32)}
