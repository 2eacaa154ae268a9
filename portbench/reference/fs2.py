"""FastSpeech2 inference, plain: phone ids, speakers and intensity
conditioning to the mel before the PostNet, the log-durations and the mel
lengths.  With ``durations`` given the length regulation takes them
(teacher forcing); without, it rounds expm1 of the predicted
log-durations.  Layout and widths follow the configuration file:
a conv prenet (3 convs, kernel 5, LayerNorm 1e-5, residual) and
projection; post-norm FFT blocks (ReLU conv-FFN with kernels ``ffn_kernels``,
LayerNorm ``ln_eps``) with a final LayerNorm; speaker embedding and
intensity concatenated and projected without bias; duration, pitch and
energy predictors (two convs of kernel 3 with ReLU and LayerNorm 1e-5, a
linear head, masked), pitch and energy embedded by a conv of kernel 3 and
added; a decoder stack like the encoder; a linear mel head."""

from __future__ import annotations

import torch
import torch.nn.functional as F

from reference import nn
from reference.precision import FP32


class FastSpeech2:
    def __init__(self, params, config, precision=FP32):
        self.p, self.c, self.prec = params, config, precision
        self.q = precision.q

    def _fft(self, x, valid, prefix):
        c, p, q = self.c, self.p, self.q
        for i in range(c["layers"]):
            name = f"{prefix}.layers.{i}"
            x = x + nn.attention(x, p, f"{name}.attn", c["heads"], valid, q)
            x = nn.layer_norm(x, p, f"{name}.norm1", c["ln_eps"])
            y = F.relu(nn.conv1d(x, p, f"{name}.ffn.conv1", q))
            x = x + nn.conv1d(y, p, f"{name}.ffn.conv2", q)
            x = nn.layer_norm(x, p, f"{name}.norm2", c["ln_eps"])
        return nn.layer_norm(x, p, f"{prefix}.final_norm", c["ln_eps"])

    def _predictor(self, x, m, name):
        p, q = self.p, self.q
        y = F.relu(nn.conv1d(x * m, p, f"{name}.conv1", q))
        y = nn.layer_norm(y, p, f"{name}.norm1", 1e-5)
        y = F.relu(nn.conv1d(y * m, p, f"{name}.conv2", q))
        y = nn.layer_norm(y, p, f"{name}.norm2", 1e-5)
        return nn.linear(y, p, f"{name}.out", q) * m

    @torch.no_grad()
    def __call__(self, tokens, speakers, intensity, durations=None, max_len=1024):
        with self.prec.products():
            return self._forward(tokens, speakers, intensity, durations, max_len)

    @torch.no_grad()
    def log_durations(self, tokens, speakers, intensity):
        with self.prec.products():
            return self._encode(tokens, speakers, intensity)[1]

    def _encode(self, tokens, speakers, intensity):
        p, q, c = self.p, self.q, self.c
        b, n = tokens.shape
        d = p["speaker_emb.weight"].shape[1]
        valid = tokens != 0
        m = valid[..., None].float()
        x = p["prenet.embed.weight"][tokens]
        for i in range(3):
            y = F.relu(nn.layer_norm(nn.conv1d(x, p, f"prenet.convs.{i}", q), p,
                                     f"prenet.norms.{i}", 1e-5))
            x = x + y
        x = nn.linear(x, p, "prenet.proj", q)
        x = (x + nn.sinusoid(n, d, x.device)) * m
        x = self._fft(x, valid, "encoder") * m
        spk = p["speaker_emb.weight"][speakers][:, None, :].expand(b, n, d)
        x = nn.linear(torch.cat([x, spk, intensity], -1), p, "concat_proj", q,
                      bias=False) * m
        log_dur = self._predictor(x, m, "duration_predictor")[..., 0]
        pitch = self._predictor(x, m, "pitch_predictor")
        x = x + nn.conv1d(pitch, p, "pitch_embed", q) * m
        energy = self._predictor(x, m, "energy_predictor")
        x = x + nn.conv1d(energy, p, "energy_embed", q) * m
        return x, log_dur, valid

    def _forward(self, tokens, speakers, intensity, durations, max_len):
        p, q = self.p, self.q
        b, n = tokens.shape
        d = p["speaker_emb.weight"].shape[1]
        x, log_dur, valid = self._encode(tokens, speakers, intensity)
        if durations is None:
            durations = torch.round(torch.clamp(torch.expm1(log_dur), min=0.0)).long()
        durations = durations * valid
        ends = torch.cumsum(durations, 1)
        frames = torch.arange(max_len, device=x.device)
        idx = torch.searchsorted(ends, frames[None].expand(b, -1).contiguous(), right=True)
        spec = torch.gather(x, 1, idx.clamp(max=n - 1)[..., None].expand(-1, -1, d))
        lens = torch.clamp(durations.sum(1), max=max_len)
        fvalid = nn.sequence_mask(lens, max_len)
        fm = fvalid[..., None].float()
        spec = (spec * fm + nn.sinusoid(max_len, d, x.device)) * fm
        spec = self._fft(spec, fvalid, "decoder")
        mel = nn.linear(spec, p, "mel_head", q) * fm
        return mel, log_dur, lens
