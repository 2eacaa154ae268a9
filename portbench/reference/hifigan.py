"""HiFi-GAN V1 generator, plain: mel (B, T, 80) to waveform (B, T·256)
and its 16-bit PCM.  Kernels are stored (k, in, out); the transposed
convolutions' kernels time-flipped against torch's layout.  conv_pre
(k 7) → per stage [leaky ReLU 0.1 → transposed conv (stride u, padding
(k−u)/2) → the mean of the ResBlock1s (per dilation: x += c2(lrelu(c1(lrelu
x))))] → leaky ReLU → conv_post (k 7) → tanh."""

from __future__ import annotations

import torch
import torch.nn.functional as F

from reference.precision import FP32

SLOPE = 0.1


def _conv(x, w, q, dilation=1):
    k = w.shape[0]
    y = F.conv1d(q(x).transpose(1, 2), q(w).permute(2, 1, 0),
                 padding=(k - 1) // 2 * dilation, dilation=dilation)
    return y.transpose(1, 2)


def _up(x, w, u, q):
    k = w.shape[0]
    y = F.conv_transpose1d(q(x).transpose(1, 2), q(w).flip(0).permute(1, 2, 0),
                           stride=u, padding=(k - u) // 2)
    return y.transpose(1, 2)


class Generator:
    def __init__(self, params, config, precision=FP32):
        self.p, self.c, self.prec, self.q = params, config, precision, precision.q

    @torch.no_grad()
    def __call__(self, mel):
        with self.prec.products():
            return self._forward(mel.float())

    def _forward(self, mel):
        p, c, q = self.p, self.c, self.q
        x = _conv(mel, p["conv_pre_kernel"], q) + p["conv_pre_bias"]
        n_k = len(c["resblock_kernel_sizes"])
        for i, u in enumerate(c["upsample_rates"]):
            x = F.leaky_relu(x, SLOPE)
            x = _up(x, p[f"up_kernels.{i}"], u, q) + p[f"up_biases.{i}"]
            acc = 0.0
            for j in range(n_k):
                name = f"resblocks.{i * n_k + j}"
                h = x
                for s, d in enumerate(c["resblock_dilations"][j]):
                    y = _conv(F.leaky_relu(h, SLOPE), p[f"{name}.w1"][s], q, d) + p[f"{name}.b1"][s]
                    y = _conv(F.leaky_relu(y, SLOPE), p[f"{name}.w2"][s], q) + p[f"{name}.b2"][s]
                    h = h + y
                acc = acc + h
            x = acc / n_k
        x = _conv(F.leaky_relu(x, SLOPE), p["conv_post_kernel"], q) + p["conv_post_bias"]
        return torch.tanh(x)[..., 0]


def pcm16(wave: torch.Tensor) -> torch.Tensor:
    """Float waveform to 16-bit PCM as the served path rounds it (toward 0)."""
    return torch.clamp(wave.float() * 32767.0, -32768.0, 32767.0).to(torch.int16)
