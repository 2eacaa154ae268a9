"""Operation and byte counts against hand counts at small shapes, and
every share at most 1 when the time equals the bound."""

import pytest

from roofline import attention_bwd, attention_fwd, model_flops, peaks, vocoder_kernels

V1 = dict(upsample_initial_channel=512, upsample_rates=[8, 8, 2, 2],
          upsample_kernel_sizes=[16, 16, 4, 4], resblock_kernel_sizes=[3, 7, 11],
          resblock_dilations=[[1, 3, 5]] * 3)


def test_attention_counts():
    # two heads of 4, rows of 3 and 5 valid keys: QK^T and PV, 2·T²·D each
    assert attention_fwd.ops(2, 4, [3, 5]) == 2 * (2 * 9 * 4 + 2 * 9 * 4 + 2 * 25 * 4 + 2 * 25 * 4)
    assert attention_bwd.ops(2, 4, [3, 5]) == 2.5 * attention_fwd.ops(2, 4, [3, 5])
    # q, k, v, out of (2, 6, 2, 4) bf16 and a (2, 6) fp32 bias
    assert attention_fwd.nbytes(2, 6, 2, 4, "bfloat16") == 4 * 96 * 2 + 4 * 12
    assert attention_bwd.nbytes(2, 6, 2, 4, "float32") == 7 * 96 * 4 + 4 * 12 + 8 * 2 * 2 * 6


def test_vocoder_counts():
    calls = vocoder_kernels.calls(V1, 2, 3)
    assert [k for k, _, _ in calls] == ["resblock"] * 3 + ["mrf"] * 3
    # stage 0: C 256 over 3·8 samples; kernel 3, three dilations of two convs
    assert calls[0][1] == 2 * 6 * 3 * 256 * 256 * 2 * 24
    # the C = 32 stage: kernels 3 + 7 + 11 over 3·256 samples
    assert calls[-1][1] == 2 * 6 * 21 * 32 * 32 * 2 * 768
    assert vocoder_kernels.stage_shapes(V1, 1, 10) == [(256, 80), (128, 640), (64, 1280), (32, 2560)]


def test_model_flops_by_hand():
    f = dict(d_model=4, ffn_dim=8, ffn_kernel_sizes=[3, 1], variance_kernel=3, prenet_convs=1,
             prenet_kernel=5, enc_num_layers=1, dec_num_layers=1)
    per = 2 * 4 * 16 + 2 * 3 * 4 * 8 + 2 * 1 * 8 * 4
    assert model_flops.fft_stack(1, 4, 8, [3, 1], 5) == per * 5 + 4 * 4 * 25
    enc = (2 * 5 * 16 + 32) * 5 + per * 5 + 16 * 25 + 2 * 13 * 4 * 5 + 3 * (4 * 3 * 16 + 8) * 5 + 4 * 3 * 4 * 5
    dec = per * 7 + 16 * 49 + 2 * 4 * 2 * 7
    assert model_flops.fastspeech2(f, 5, 2, 5, 7) == enc + dec
    h = dict(V1, upsample_initial_channel=8, upsample_rates=[2], upsample_kernel_sizes=[4],
             resblock_kernel_sizes=[3], resblock_dilations=[[1]])
    assert model_flops.hifigan(h, 2, 5) == 2 * 7 * 2 * 8 * 5 + 2 * 4 * 8 * 4 * 5 + 2 * 2 * 3 * 16 * 10 + 2 * 7 * 4 * 10


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_a_share_at_the_bound_reads_at_most_100(dtype):
    """The readers' share on a synthetic trace whose kernels took exactly
    the bound reads 100 %, and less for any longer time."""
    from types import SimpleNamespace

    from harness.spec import ROOT, load_module

    share = load_module(ROOT / "layer_metrics" / "_roofline.py").share
    bounds = {"attention_fwd": attention_fwd.bound(8, 64, 2, 192, [64] * 8, dtype),
              "attention_bwd": attention_bwd.bound(8, 64, 2, 192, [10] * 8, dtype),
              "vocoder_kernels": vocoder_kernels.bound(V1, 4, 32, dtype)}
    for key, b in bounds.items():
        for slower in (1.0, 1.7):
            trace = SimpleNamespace(kernel_seconds=lambda *needles, t=b * slower: t)
            ctx = SimpleNamespace(trace=trace, bounds=bounds)
            assert share(ctx, key, key) <= 100.0 + 1e-9
            assert abs(share(ctx, key, key) - 100.0 / slower) < 1e-9
    # the bound is the larger of the two times: never below either
    ops, nbytes = attention_fwd.ops(2, 192, [64] * 8), attention_fwd.nbytes(8, 64, 2, 192, dtype)
    b = bounds["attention_fwd"]
    assert b >= ops / peaks.PEAK_FLOPS[dtype] and b >= nbytes / peaks.PEAK_BYTES
