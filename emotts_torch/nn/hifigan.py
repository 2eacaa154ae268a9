"""HiFi-GAN V1 generator (16 kHz) — the synthesis vocoder.

Counterpart of ``emotts/nn/hifigan.py``: mel (B, T, 80) → waveform
(B, T·256).  pre-conv (k=7) → 4× [leaky-relu → transposed-conv upsample
(rates 8,8,2,2; kernels 16,16,4,4) → multi-receptive-field fusion of 3
ResBlocks (kernels 3/7/11, dilations 1/3/5, two convs per dilation)] →
leaky-relu → post-conv (k=7) → tanh.

Parameters keep the reference's layout so that its checkpoints convert name
by name: conv kernels are (k, in, out), and the transposed-conv kernels are
time-flipped relative to torch's ``ConvTranspose1d`` weight (the reference
runs them as input-dilated regular convs).  ``F.conv_transpose1d`` gets the
kernel flipped back.  ``convert_torch_state_dict`` brings a torch HiFi-GAN
generator's checkpoint (weight norm fused) into that layout.

The three flags of the reference select how the ResBlocks run:

* ``fused_mrf`` — stages with C ≤ 128 go through the fused MRF-stage kernel
  (``emotts_torch.ops.mrf``), one wrapper call per stage (one launch, or one
  per dilation step of each ResBlock: ``mrf.launch_plan``);
* ``use_pallas_resblocks`` (the reference's name, kept) — the remaining
  ResBlocks go through the ResBlock kernel (``emotts_torch.ops.resblock``);
* ``subpixel_upsample`` — an exactly equivalent formulation of the
  transposed convs in the reference; here both settings run
  ``F.conv_transpose1d``.

``time_packed_resblocks`` packs narrow stages into the TPU's 128 lanes in
the reference and has no meaning on this hardware: the flag is accepted and
the plain ResBlock is computed.
"""

from __future__ import annotations

import re
from typing import Dict, Mapping, Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from emotts_torch.ops.mrf import fused_mrf_stage
from emotts_torch.ops.resblock import conv1d_btc, fused_resblock1

LRELU_SLOPE = 0.1


def _conv_transpose1d_btc(x: torch.Tensor, kernel: torch.Tensor,
                          stride: int) -> torch.Tensor:
    """torch ConvTranspose1d(stride=u, padding=(k−u)//2) on (B, T, C).

    kernel: (k, in, out), time-flipped relative to the torch weight (the
    reference's storage order).  Output length = T·stride."""
    k = kernel.shape[0]
    w = kernel.flip(0).permute(1, 2, 0)  # → torch's (in, out, k)
    y = F.conv_transpose1d(x.transpose(1, 2), w.to(x.dtype), stride=stride,
                           padding=(k - stride) // 2)
    return y.transpose(1, 2)


class ResBlock1(nn.Module):
    """HiFi-GAN V1 residual block: per dilation d, x += c2(lrelu(c1(lrelu(x)))).

    Parameters are stacked over dilations, in the kernels' layout: ``w1``,
    ``w2`` (n_d, k, C, C) in (tap, in, out) order, ``b1``, ``b2`` (n_d, C).
    ``use_pallas=True`` routes through the fused kernel — same parameters,
    same math, the tile stays in shared memory through the chain."""

    def __init__(self, channels: int, kernel_size: int,
                 dilations: Sequence[int] = (1, 3, 5), use_pallas: bool = False):
        super().__init__()
        self.channels, self.kernel_size = channels, kernel_size
        self.dilations = tuple(int(d) for d in dilations)
        self.use_pallas = use_pallas
        n_d = len(self.dilations)
        shape = (n_d, kernel_size, channels, channels)
        self.w1 = nn.Parameter(torch.randn(shape) * 0.01)
        self.b1 = nn.Parameter(torch.zeros(n_d, channels))
        self.w2 = nn.Parameter(torch.randn(shape) * 0.01)
        self.b2 = nn.Parameter(torch.zeros(n_d, channels))

    def stacked_params(self):
        return self.w1, self.b1, self.w2, self.b2

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.use_pallas:
            return fused_resblock1(x, *self.stacked_params(), self.dilations)
        for i, d in enumerate(self.dilations):
            y = F.leaky_relu(x, LRELU_SLOPE)
            y = conv1d_btc(y, self.w1[i].to(x.dtype), d) + self.b1[i].to(x.dtype)
            y = F.leaky_relu(y, LRELU_SLOPE)
            y = conv1d_btc(y, self.w2[i].to(x.dtype), 1) + self.b2[i].to(x.dtype)
            x = x + y
        return x


class HiFiGANGenerator(nn.Module):
    def __init__(
        self,
        in_channels: int = 80,
        upsample_initial_channel: int = 512,
        upsample_rates: Sequence[int] = (8, 8, 2, 2),
        upsample_kernel_sizes: Sequence[int] = (16, 16, 4, 4),
        resblock_kernel_sizes: Sequence[int] = (3, 7, 11),
        resblock_dilations: Sequence[Sequence[int]] = ((1, 3, 5), (1, 3, 5), (1, 3, 5)),
        use_pallas_resblocks: bool = False,
        time_packed_resblocks: bool = False,
        fused_mrf: bool = False,
        subpixel_upsample: bool = True,
    ):
        super().__init__()
        self.upsample_rates = tuple(int(u) for u in upsample_rates)
        self.upsample_kernel_sizes = tuple(int(k) for k in upsample_kernel_sizes)
        self.resblock_kernel_sizes = tuple(int(k) for k in resblock_kernel_sizes)
        self.resblock_dilations = tuple(
            tuple(int(d) for d in dil) for dil in resblock_dilations
        )
        self.use_pallas_resblocks = use_pallas_resblocks
        self.time_packed_resblocks = time_packed_resblocks
        self.fused_mrf = fused_mrf
        self.subpixel_upsample = subpixel_upsample

        ch = upsample_initial_channel
        self.conv_pre_kernel = nn.Parameter(torch.randn(7, in_channels, ch) * 0.01)
        self.conv_pre_bias = nn.Parameter(torch.zeros(ch))
        self.up_kernels = nn.ParameterList()
        self.up_biases = nn.ParameterList()
        self.resblocks = nn.ModuleList()  # stage-major: index i·n_kernels + j
        for ku in self.upsample_kernel_sizes:
            out_ch = ch // 2
            self.up_kernels.append(nn.Parameter(torch.randn(ku, ch, out_ch) * 0.01))
            self.up_biases.append(nn.Parameter(torch.zeros(out_ch)))
            for k, dil in zip(self.resblock_kernel_sizes, self.resblock_dilations):
                self.resblocks.append(
                    ResBlock1(out_ch, k, dil, use_pallas=use_pallas_resblocks)
                )
            ch = out_ch
        self.conv_post_kernel = nn.Parameter(torch.randn(7, ch, 1) * 0.01)
        self.conv_post_bias = nn.Parameter(torch.zeros(1))

    def _stage_is_fused(self, channels: int) -> bool:
        same_dil = len(set(self.resblock_dilations)) == 1
        return (self.fused_mrf and channels <= 128 and same_dil
                and 128 % channels == 0)

    def forward(self, mel: torch.Tensor) -> torch.Tensor:
        """mel: (B, T, n_mels) → waveform (B, T·∏rates)."""
        # the reference's type promotion: the conv runs in the mel's dtype,
        # and its fp32 bias makes x fp32 from here on (a bf16 mel gives an
        # fp32 generator after the first conv)
        x = conv1d_btc(mel, self.conv_pre_kernel.to(mel.dtype), 1) + self.conv_pre_bias
        n_k = len(self.resblock_kernel_sizes)
        for i, u in enumerate(self.upsample_rates):
            x = F.leaky_relu(x, LRELU_SLOPE)
            x = _conv_transpose1d_btc(x, self.up_kernels[i], u) + self.up_biases[i]
            x = x.contiguous()
            blocks = self.resblocks[i * n_k:(i + 1) * n_k]
            if self._stage_is_fused(x.shape[2]):
                x = fused_mrf_stage(
                    x, [blk.stacked_params() for blk in blocks],
                    self.resblock_kernel_sizes, self.resblock_dilations[0],
                )
            else:
                acc = None
                for blk in blocks:
                    y = blk(x)
                    acc = y if acc is None else acc + y
                x = acc / n_k
        x = F.leaky_relu(x, LRELU_SLOPE)
        x = conv1d_btc(x, self.conv_post_kernel.to(x.dtype), 1) + self.conv_post_bias
        return torch.tanh(x)[..., 0]  # (B, T·256)


# ---------------------------------------------------------------------------
# torch checkpoint conversion
# ---------------------------------------------------------------------------


def _fuse_weight_norm(sd: Mapping[str, np.ndarray], prefix: str) -> np.ndarray:
    """The fused weight of ``prefix``: a plain ``weight``, or weight norm's
    ``weight_g``/``weight_v`` or ``parametrizations.weight.original0/1``."""
    if f"{prefix}.weight" in sd:
        return np.asarray(sd[f"{prefix}.weight"])
    if f"{prefix}.weight_v" in sd:
        g = np.asarray(sd[f"{prefix}.weight_g"])
        v = np.asarray(sd[f"{prefix}.weight_v"])
    elif f"{prefix}.parametrizations.weight.original0" in sd:
        g = np.asarray(sd[f"{prefix}.parametrizations.weight.original0"])
        v = np.asarray(sd[f"{prefix}.parametrizations.weight.original1"])
    else:
        raise KeyError(f"no weight found for {prefix}")
    # torch weight_norm dim=0: norm over all dims except 0
    axes = tuple(range(1, v.ndim))
    norm = np.sqrt((v**2).sum(axis=axes, keepdims=True))
    return g * v / np.maximum(norm, 1e-12)


def _to_flax_conv(w: np.ndarray) -> np.ndarray:
    """torch Conv1d weight (out, in, k) → (k, in, out)."""
    return np.transpose(w, (2, 1, 0))


def _to_flax_conv_transpose(w: np.ndarray) -> np.ndarray:
    """torch ConvTranspose1d weight (in, out, k) → time-flipped (k, in, out),
    the reference's storage order."""
    return np.flip(np.transpose(w, (2, 0, 1)), axis=0).copy()


def convert_torch_state_dict(sd: Mapping[str, np.ndarray]) -> Dict:
    """A torch HiFi-GAN generator state_dict (numpy values; the official
    hifi-gan / SpeechBrain layout: ``conv_pre``, ``ups.N``, ``resblocks.M``
    with M = i·n_kernels + j and ``convs1.D``/``convs2.D``, ``conv_post``)
    → the reference's ``{'params': tree}``.  The structure is read from the
    keys the state_dict holds."""

    def _count(pattern):
        idx = {int(m.group(1)) for k in sd for m in [re.match(pattern, k)] if m}
        return max(idx) + 1 if idx else 0

    n_ups = _count(r"ups\.(\d+)\.")
    n_kernels = _count(r"resblocks\.(\d+)\.") // max(n_ups, 1)
    n_dilations = _count(r"resblocks\.0\.convs1\.(\d+)\.")

    def get(name):
        return _fuse_weight_norm(sd, name)

    def bias(name):
        return np.asarray(sd[name + ".bias"])

    params: Dict = {
        "conv_pre_kernel": _to_flax_conv(get("conv_pre")),
        "conv_pre_bias": bias("conv_pre"),
        "conv_post_kernel": _to_flax_conv(get("conv_post")),
        "conv_post_bias": bias("conv_post"),
    }
    for i in range(n_ups):
        params[f"up_{i}_kernel"] = _to_flax_conv_transpose(get(f"ups.{i}"))
        params[f"up_{i}_bias"] = bias(f"ups.{i}")
        for j in range(n_kernels):
            m = i * n_kernels + j
            block: Dict = {}
            for d in range(n_dilations):
                for conv in ("convs1", "convs2"):
                    name = f"resblocks.{m}.{conv}.{d}"
                    block[f"{conv}_{d}_kernel"] = _to_flax_conv(get(name))
                    block[f"{conv}_{d}_bias"] = bias(name)
            params[f"resblock_{i}_{j}"] = block
    return {"params": params}


def generator_structure_from_params(
    variables: Dict, expected_upsample: Optional[int] = None
) -> Dict:
    """Infer HiFiGANGenerator constructor kwargs from the reference's
    (converted) params tree, so any V1/V2/V3-family checkpoint loads without
    hand-set config.

    Upsample rates follow the HiFi-GAN convention rate = kernel // 2; conv
    dilations are not recoverable from weight shapes and default to the
    paper's (1, 3, 5, 7)[:n] per resblock conv.  ``expected_upsample``
    (normally the mel hop length) validates the inference."""
    p = variables.get("params", variables)
    in_ch = int(p["conv_pre_kernel"].shape[1])
    init_ch = int(p["conv_pre_kernel"].shape[2])
    n_ups = len([k for k in p if k.startswith("up_") and k.endswith("_kernel")])
    up_kernels = tuple(int(p[f"up_{i}_kernel"].shape[0]) for i in range(n_ups))
    up_rates = tuple(k // 2 for k in up_kernels)
    if expected_upsample is not None:
        total = 1
        for r in up_rates:
            total *= r
        if total != expected_upsample:
            raise ValueError(
                f"inferred upsample rates {up_rates} (total {total}) do not "
                f"reproduce the expected hop length {expected_upsample}; the "
                "checkpoint deviates from the kernel=2*rate HiFi-GAN "
                "convention — pass an explicit vocoder_structure"
            )
    n_kernels = len(
        {k.split("_")[2] for k in p if k.startswith("resblock_0_")}
    )
    kernel_sizes = []
    dilations = []
    for j in range(n_kernels):
        block = p[f"resblock_0_{j}"]
        kernel_sizes.append(int(block["convs1_0_kernel"].shape[0]))
        n_d = len([k for k in block if k.startswith("convs1_") and k.endswith("_kernel")])
        dilations.append(tuple((1, 3, 5, 7)[:n_d]))
    return dict(
        in_channels=in_ch,
        upsample_initial_channel=init_ch,
        upsample_rates=up_rates,
        upsample_kernel_sizes=up_kernels,
        resblock_kernel_sizes=tuple(kernel_sizes),
        resblock_dilations=tuple(dilations),
    )
