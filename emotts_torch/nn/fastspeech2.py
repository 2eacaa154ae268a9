"""FastSpeech2 acoustic model with speaker + emotion-intensity conditioning.

Counterpart of ``emotts/nn/fastspeech2.py``:

  tokens → EncoderPreNet → +pos-enc → FFT encoder →
  concat(token feats, speaker emb, intensity rep) → bias-free projection →
  duration/pitch/energy variance adaptors (pitch/energy embedded via Conv1d
  and *added* to the states; energy predictor sees pitch-conditioned feats) →
  gather-based length regulation (teacher-forced durations, or
  clamp(expm1(log_dur)) with pace/pitch_rate/energy_rate controls) →
  FFT decoder → mel head → PostNet residual.

Returns the reference's 8-tuple: (mel_post, postnet_mel, log_durations,
pred_pitch, avg_pitch, pred_energy, avg_energy, mel_lens).

Training mode is a call argument, as in the reference: ``deterministic=False``
switches on the dropouts (prenet, variance predictors, PostNet, FFT blocks),
each drawn from the caller's ``generator``, and puts the PostNet's BatchNorm
on batch statistics, updating its running statistics the way flax does
(:func:`batch_norm`).
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from emotts_torch.nn.blocks import (CastConv1d, CastLinear, FFTStack,
                                    LayerNorm32, dropout,
                                    positional_encoding_like, sequence_mask)
from emotts_torch.nn.length_regulator import (average_over_durations,
                                              length_regulate)
from emotts_torch.utils.config import FastSpeech2Config
from emotts_torch.utils.trace import span


class EncoderPreNet(nn.Module):
    """Token embedding + convolutional context.  ``style="embedding"`` is the
    bare token embedding that imported reference checkpoints use."""

    def __init__(self, n_char: int, d_model: int, n_convs: int = 3,
                 kernel_size: int = 5, dropout: float = 0.15,
                 style: str = "conv", dtype: torch.dtype = torch.float32):
        super().__init__()
        self.style, self.dtype, self.dropout = style, dtype, dropout
        self.embed = nn.Embedding(n_char, d_model)
        if style != "embedding":
            self.convs = nn.ModuleList(
                [CastConv1d(d_model, d_model, kernel_size) for _ in range(n_convs)]
            )
            self.norms = nn.ModuleList(
                [LayerNorm32(d_model, eps=1e-5) for _ in range(n_convs)]
            )
            self.proj = CastLinear(d_model, d_model)

    def forward(self, tokens: torch.Tensor, deterministic: bool = True,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        x = self.embed(tokens).to(self.dtype)
        if self.style == "embedding":
            return x
        rate = 0.0 if deterministic else self.dropout
        for conv, norm in zip(self.convs, self.norms):
            y = F.relu(norm(conv(x)).to(self.dtype))
            x = x + dropout(y, rate, generator)  # residual keeps the embedding
        return self.proj(x)


class VariancePredictor(nn.Module):
    """Conv-stack scalar predictor for duration/pitch/energy."""

    def __init__(self, d_model: int, kernel_size: int = 3, dropout: float = 0.5,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype, self.dropout = dtype, dropout
        self.conv1 = CastConv1d(d_model, d_model, kernel_size)
        self.norm1 = LayerNorm32(d_model, eps=1e-5)
        self.conv2 = CastConv1d(d_model, d_model, kernel_size)
        self.norm2 = LayerNorm32(d_model, eps=1e-5)
        self.out = CastLinear(d_model, 1)

    def forward(self, x: torch.Tensor, valid: torch.Tensor,
                deterministic: bool = True,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        rate = 0.0 if deterministic else self.dropout
        m = valid[..., None].to(x.dtype)
        y = F.relu(self.conv1((x * m).to(self.dtype)))
        y = dropout(self.norm1(y).to(self.dtype), rate, generator)
        y = F.relu(self.conv2(y * m.to(self.dtype)))
        y = dropout(self.norm2(y).to(self.dtype), rate, generator)
        y = self.out(y)  # (B, P, 1)
        return y * m


BN_MOMENTUM = 0.99  # flax's: the share of the old running statistic kept


def batch_norm(x: torch.Tensor, bn: nn.BatchNorm1d, train: bool) -> torch.Tensor:
    """flax ``nn.BatchNorm`` (fp32, ε from ``bn``) over (B, T, C), returning
    fp32.  ``bn`` holds the scale, bias and running statistics.

    In training the statistics are those of the batch over all B·T
    positions (pad frames included), with the *biased* variance
    E[x²] − E[x]² clipped at 0, and the running statistics move as
    ``r = 0.99·r + 0.01·stat`` — the biased variance too.  (``BatchNorm1d``'s
    own update keeps the unbiased variance and counts ``momentum`` the other
    way round, so it is not used.)  Otherwise the running statistics are
    used.  Where ``bn.process_group`` is set
    (``parallel.mesh.set_batch_norm_group``) the batch is the global one:
    Σx and Σx² are summed over the data axis by a differentiable all-reduce,
    as the reference's pjit step takes them over the sharded batch."""
    x = x.float()
    if train:
        group = getattr(bn, "process_group", None)
        if group is None:
            mean = x.mean(dim=(0, 1))
            var = torch.clamp((x * x).mean(dim=(0, 1)) - mean * mean, min=0.0)
        else:
            import torch.distributed as dist
            from torch.distributed.nn.functional import all_reduce

            sums = all_reduce(torch.stack([x.sum(dim=(0, 1)),
                                           (x * x).sum(dim=(0, 1))]), group=group)
            n = x.shape[0] * x.shape[1] * dist.get_world_size(group)
            mean = sums[0] / n
            var = torch.clamp(sums[1] / n - mean * mean, min=0.0)
        with torch.no_grad():
            bn.running_mean.copy_(BN_MOMENTUM * bn.running_mean
                                  + (1 - BN_MOMENTUM) * mean)
            bn.running_var.copy_(BN_MOMENTUM * bn.running_var
                                 + (1 - BN_MOMENTUM) * var)
    else:
        mean, var = bn.running_mean, bn.running_var
    return (x - mean) * (torch.rsqrt(var + bn.eps) * bn.weight) + bn.bias


class PostNet(nn.Module):
    """5-layer conv residual refiner over the mel output: tanh+BatchNorm
    hidden convs, linear+BatchNorm final conv."""

    def __init__(self, n_mels: int = 80, embedding_dim: int = 512,
                 kernel_size: int = 5, n_convs: int = 5, dropout: float = 0.5,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype, self.dropout = dtype, dropout
        dims = [n_mels] + [embedding_dim] * (n_convs - 1) + [n_mels]
        self.convs = nn.ModuleList(
            [CastConv1d(dims[i], dims[i + 1], kernel_size) for i in range(n_convs)]
        )
        # parameters and running statistics of flax BatchNorm (epsilon 1e-5),
        # applied by batch_norm
        self.bns = nn.ModuleList(
            [nn.BatchNorm1d(dims[i + 1], eps=1e-5) for i in range(n_convs)]
        )

    def forward(self, mel: torch.Tensor, deterministic: bool = True,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        rate = 0.0 if deterministic else self.dropout
        x = mel.to(self.dtype)
        last = len(self.convs) - 1
        for i, (conv, bn) in enumerate(zip(self.convs, self.bns)):
            x = batch_norm(conv(x), bn, not deterministic).to(self.dtype)
            if i != last:
                x = torch.tanh(x)
            x = dropout(x, rate, generator)
        return x


class SpeechBrainPostNet(nn.Module):
    """The reference checkpoints' PostNet layout: conv_pre → LN → tanh →
    (n−2) intermediate convs → LN → tanh → conv_post → LN."""

    def __init__(self, n_mels: int = 80, embedding_dim: int = 512,
                 kernel_size: int = 5, n_convs: int = 5, dropout: float = 0.5,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype, self.dropout = dtype, dropout
        self.conv_pre = CastConv1d(n_mels, embedding_dim, kernel_size)
        self.ln1 = LayerNorm32(embedding_dim, eps=1e-5)
        self.conv_mid = nn.ModuleList(
            [CastConv1d(embedding_dim, embedding_dim, kernel_size)
             for _ in range(n_convs - 2)]
        )
        self.ln2 = LayerNorm32(embedding_dim, eps=1e-5)
        self.conv_post = CastConv1d(embedding_dim, n_mels, kernel_size)
        self.ln3 = LayerNorm32(n_mels, eps=1e-5)

    def forward(self, mel: torch.Tensor, deterministic: bool = True,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        rate = 0.0 if deterministic else self.dropout
        x = self.conv_pre(mel.to(self.dtype))
        x = dropout(torch.tanh(self.ln1(x).to(self.dtype)), rate, generator)
        for conv in self.conv_mid:
            x = conv(x)
        x = dropout(torch.tanh(self.ln2(x).to(self.dtype)), rate, generator)
        x = self.conv_post(x)
        return dropout(self.ln3(x).to(self.dtype), rate, generator)


class FastSpeech2(nn.Module):
    """``dtype`` is the compute dtype of the heavy modules (bf16 on the
    card); parameters and the glue math stay fp32."""

    def __init__(self, cfg: FastSpeech2Config, n_speakers: int = 4,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        c = self.cfg = cfg
        self.n_speakers, self.dtype = n_speakers, dtype
        fused = bool(c.fused_attention)
        self.prenet = EncoderPreNet(c.n_char, c.enc_d_model,
                                    style=c.prenet_style, dtype=dtype)
        self.encoder = FFTStack(
            c.enc_num_layers, c.enc_d_model, c.enc_num_head, c.enc_ffn_dim,
            tuple(c.ffn_kernel_sizes), normalize_before=c.normalize_before,
            final_norm=True, fused_attention=fused, dtype=dtype,
            dropout=c.enc_dropout, remat=c.remat,
        )
        self.speaker_emb = nn.Embedding(n_speakers, c.enc_d_model)
        self.concat_proj = nn.Linear(
            2 * c.enc_d_model + c.intensity_dim, c.enc_d_model, bias=False
        )
        vp_drop = c.variance_predictor_dropout
        self.duration_predictor = VariancePredictor(
            c.enc_d_model, c.dur_pred_kernel_size, vp_drop, dtype)
        self.pitch_predictor = VariancePredictor(
            c.enc_d_model, c.pitch_pred_kernel_size, vp_drop, dtype)
        self.pitch_embed = CastConv1d(1, c.enc_d_model, c.pitch_pred_kernel_size)
        self.energy_predictor = VariancePredictor(
            c.enc_d_model, c.energy_pred_kernel_size, vp_drop, dtype)
        self.energy_embed = CastConv1d(1, c.enc_d_model, c.energy_pred_kernel_size)
        self.decoder = FFTStack(
            c.dec_num_layers, c.dec_d_model, c.dec_num_head, c.dec_ffn_dim,
            tuple(c.ffn_kernel_sizes), normalize_before=c.normalize_before,
            final_norm=True, fused_attention=fused, dtype=dtype,
            dropout=c.dec_dropout, remat=c.remat,
        )
        self.mel_head = nn.Linear(c.dec_d_model, c.n_mels)
        postnet_cls = (
            SpeechBrainPostNet if c.postnet_style == "speechbrain" else PostNet
        )
        self.postnet = postnet_cls(
            c.n_mels, c.postnet_embedding_dim, c.postnet_kernel_size,
            c.postnet_n_convolutions, c.postnet_dropout, dtype,
        )

    def forward(
        self,
        tokens: torch.Tensor,  # (B, P) int, 0 = pad
        speakers: torch.Tensor,  # (B,) int ids, OR (B, n_speakers) float
        #   blend weights over the speaker-embedding table
        durations: Optional[torch.Tensor] = None,  # (B, P) int (teacher forcing)
        pitch: Optional[torch.Tensor] = None,  # (B, T) frame-level target
        energy: Optional[torch.Tensor] = None,  # (B, T)
        intensity: Optional[torch.Tensor] = None,  # (B, P, n_emotions)
        pace: float = 1.0,
        pitch_rate: float = 1.0,
        energy_rate: float = 1.0,
        max_mel_len: Optional[int] = None,
        deterministic: bool = True,
        generator: Optional[torch.Generator] = None,  # dropout draws
    ) -> Tuple[Optional[torch.Tensor], ...]:
        c = self.cfg
        f32 = torch.float32  # glue math stays fp32; heavy modules use self.dtype
        b, p = tokens.shape
        token_valid = tokens != c.padding_idx  # (B, P)
        tmask = token_valid[..., None].to(f32)

        # each stage is a span (utils/trace.py), each FFT block its own, so
        # that a profile names the host time between launches by stage
        # ---------------- encoder ----------------
        det, gen = deterministic, generator
        with span("fs2.prenet"):
            feats = self.prenet(tokens, det, gen).to(f32)
            feats = (feats + positional_encoding_like(feats, c.enc_d_model)) * tmask
        feats = self.encoder(feats, token_valid, det, gen).to(f32) * tmask

        # ------------- conditioning: speaker ⊕ intensity -------------
        with span("fs2.condition"):
            if speakers.dim() == 2:
                spk = speakers.to(f32) @ self.speaker_emb.weight
            else:
                spk = self.speaker_emb(speakers)
            spk = spk[:, None, :].expand(b, p, c.enc_d_model)
            if intensity is None:
                intensity = feats.new_zeros((b, p, c.intensity_dim))
            feats = self.concat_proj(torch.cat([feats, spk, intensity.to(f32)], dim=-1))
            feats = feats * tmask

        # ---------------- variance adaptors ----------------
        with span("fs2.duration"):
            log_durations = self.duration_predictor(feats, token_valid, det, gen)[..., 0]
        with span("fs2.pitch"):
            pred_pitch = self.pitch_predictor(feats, token_valid, det, gen) * pitch_rate
            avg_pitch = None
            if pitch is not None and durations is not None:
                avg_pitch = average_over_durations(pitch, durations)[..., None]
                feats = feats + self.pitch_embed(avg_pitch) * tmask
            else:
                feats = feats + self.pitch_embed(pred_pitch.to(f32)) * tmask

        with span("fs2.energy"):
            pred_energy = self.energy_predictor(feats, token_valid, det, gen) * energy_rate
            avg_energy = None
            if energy is not None and durations is not None:
                avg_energy = average_over_durations(energy, durations)[..., None]
                feats = feats + self.energy_embed(avg_energy) * tmask
            else:
                feats = feats + self.energy_embed(pred_energy.to(f32)) * tmask

        # ---------------- length regulation ----------------
        with span("fs2.length_regulator"):
            max_len = max_mel_len or c.max_mel_len
            if durations is not None:
                dur_frames = durations
                if pace != 1.0:
                    dur_frames = torch.round(durations.to(f32) * pace).to(durations.dtype)
            else:
                dur = torch.clamp(torch.expm1(log_durations.to(f32)), min=0.0)
                dur_frames = torch.round(dur * pace).to(torch.int32)
            dur_frames = dur_frames * token_valid.to(dur_frames.dtype)
            spec, mel_lens = length_regulate(feats, dur_frames, max_len)
            frame_valid = sequence_mask(mel_lens, max_len)
            fmask = frame_valid[..., None].to(f32)
            spec = (spec + positional_encoding_like(spec, c.dec_d_model)) * fmask

        # ---------------- decoder ----------------
        spec = self.decoder(spec, frame_valid, det, gen).to(f32)
        with span("fs2.postnet"):
            mel_post = self.mel_head(spec) * fmask
            residual = self.postnet(mel_post, det, gen)
            postnet_mel = (mel_post + residual) * fmask

        return (mel_post, postnet_mel, log_durations, pred_pitch, avg_pitch,
                pred_energy, avg_energy, mel_lens)
