"""Shared helpers of the tests that hold the PyTorch port (emotts_torch)
against the JAX package: equal small configurations on both sides, and
weights made from a numpy seed in the JAX package's tree layout (the port
receives them through emotts_torch.nn.convert)."""

import numpy as np
import pytest
import torch

from emotts_torch.ops.resblock import conv1d_btc

# The tests' JAX references compile at XLA's lowest backend optimization
# level: the same HLO, so the same operations in the same order, at a
# fraction of the compile time that dominates these toy sizes.
FAST_COMPILE = {"xla_backend_optimization_level": 0}


def jit(fn, **kwargs):
    """``jax.jit`` of a JAX reference, compiled with :data:`FAST_COMPILE`."""
    import jax

    return jax.jit(fn, compiler_options=FAST_COMPILE, **kwargs)


SMALL_VOCODER = dict(
    in_channels=8,
    upsample_initial_channel=64,
    upsample_rates=(4, 2),
    upsample_kernel_sizes=(8, 4),
    resblock_kernel_sizes=(3, 7),
    resblock_dilations=((1, 3), (1, 3)),
)


@pytest.fixture(autouse=True, scope="module")
def single_torch_thread():
    """The suite runs several workers on few cores: at these toy sizes one
    intra-op thread per worker is faster than eight fighting the others.
    A test file takes this fixture by importing it."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def shrink(cfg, prenet="conv", postnet="batchnorm", fused=True):
    """Apply the tests' small FastSpeech2 size to a Config of either package."""
    cfg.data.speakers = ["a", "b", "c"]
    cfg.data.emotions = ["neutral", "amused", "angry"]
    f = cfg.fastspeech2
    f.enc_num_layers = f.dec_num_layers = 2
    f.enc_d_model = f.dec_d_model = 32
    f.enc_ffn_dim = f.dec_ffn_dim = 64
    f.postnet_embedding_dim = 32
    f.postnet_n_convolutions = 3
    f.max_mel_len = 64
    f.prenet_style = prenet
    f.postnet_style = postnet
    f.fused_attention = fused
    f.intensity_dim = 3
    cfg.bucketing.phone_buckets = [16, 32]
    cfg.train_fs2.compute_dtype = "float32"
    cfg.inference.neural_g2p = False
    return cfg


def fill_tree(template, seed, scale=0.08):
    """A tree of the template's shapes with values from a numpy seed.

    Norm scales and BatchNorm variances stay positive and near 1; every
    other leaf is N(0, scale²)."""
    rng = np.random.default_rng(seed)

    def walk(node, path):
        if isinstance(node, dict):
            return {k: walk(v, path + (k,)) for k, v in sorted(node.items())}
        shape = tuple(node.shape)
        noise = rng.standard_normal(shape).astype(np.float32)
        if path[-1] in ("scale", "var"):
            return (1.0 + 0.1 * np.abs(noise)).astype(np.float32)
        return (scale * noise).astype(np.float32)

    return walk(template, ())


def fs2_variables(jax_cfg, seed=0, mean_frames=4.0):
    """Numpy weights for the JAX FastSpeech2 of ``jax_cfg``; the duration
    predictor's output bias is set so that a phone lasts about
    ``mean_frames`` frames (zero-initialised it predicts none)."""
    import jax

    from emotts.train.fs2_trainer import build_fastspeech2, init_fs2_variables

    model = build_fastspeech2(jax_cfg)
    # shapes only: nothing of the model runs to make the template
    template = jax.eval_shape(lambda: init_fs2_variables(jax_cfg, model, 0))
    variables = fill_tree(_plain(template), seed)
    variables["params"]["duration_predictor"]["out"]["bias"] = np.array(
        [np.log1p(mean_frames)], np.float32
    )
    return model, variables


def vocoder_params(structure=SMALL_VOCODER, seed=1, scale=0.15, **flags):
    """(JAX generator, numpy params tree) for a small HiFi-GAN."""
    import jax
    import jax.numpy as jnp

    from emotts.nn.hifigan import HiFiGANGenerator

    gen = HiFiGANGenerator(**structure, **flags)
    # shapes only: nothing of the generator runs to make the template
    template = jax.eval_shape(
        gen.init, jax.random.PRNGKey(0),
        jnp.zeros((1, 8, structure["in_channels"])),
    )
    return gen, fill_tree(_plain(template), seed, scale)


def _plain(tree):
    """FrozenDict or dict → plain nested dict."""
    if hasattr(tree, "items"):
        return {k: _plain(v) for k, v in tree.items()}
    return tree


def weight_normed_hifigan(seed=0, layout="weight_norm", n_mels=8, ch0=32,
                          kernels=(4, 4), resblock_kernels=(3, 7, 11), n_dilations=3):
    """A torch HiFi-GAN generator state_dict in the official layout
    (``conv_pre``, ``ups.N``, ``resblocks.M.convs{1,2}.D``, ``conv_post``),
    values from a numpy seed, built by chip_smoke.py's
    ``weight_normed_generator``.  ``layout``: ``weight_norm`` (``weight_g`` /
    ``weight_v``), ``parametrizations`` (``parametrizations.weight.
    original0/1``) or ``plain`` (``weight_v`` as the fused ``weight``)."""
    from chip_smoke import weight_normed_generator

    sd = weight_normed_generator(
        np.random.default_rng(seed), n_mels, ch0, kernels, resblock_kernels,
        [range(n_dilations)] * len(resblock_kernels), v_scale=0.3, g_scale=1.0)
    leaves = dict(
        weight_norm={},
        parametrizations=dict(weight_g="parametrizations.weight.original0",
                              weight_v="parametrizations.weight.original1"),
        plain=dict(weight_g=None, weight_v="weight"))[layout]
    out = {}
    for key, value in sd.items():
        name, _, leaf = key.rpartition(".")
        leaf = leaves.get(leaf, leaf)
        if leaf is not None:
            out[f"{name}.{leaf}"] = value
    return out


SMALL_RANK = dict(n_mels=8, n_heads=2, n_emotions=3, n_layers=2, hidden_dim=32,
                  kernel_size=3, ffn_mult=2, dropout=0.1)


def rank_variables(seed=0, fused=False, **overrides):
    """(JAX RankModel, numpy ``{'params': tree}``) at the tests' small size."""
    import jax
    import jax.numpy as jnp

    from emotts.nn.intensity import RankModel

    size = {**SMALL_RANK, **overrides}
    model = RankModel(**size, fused_attention=fused)
    c = size["n_mels"] + 2
    dummy = jnp.zeros((1, 8, c), jnp.float32)
    # shapes only: nothing of the model runs to make the template
    template = jax.eval_shape(
        lambda: model.init(
            {"params": jax.random.PRNGKey(0), "mixup": jax.random.PRNGKey(1)},
            dummy, dummy, jnp.zeros((1,), jnp.int32), jnp.full((1,), 8, jnp.int32)))
    return model, fill_tree(_plain(template), seed, scale=0.15)


def rank_batch(seed=0, b=4, t=24, n_mels=8, n_emotions=3):
    """emo_x, neu_x, emotions, lengths, lambdas (2, B) from a numpy seed; one
    row is full length, the others ragged."""
    rng = np.random.default_rng(seed)
    emo_x, neu_x = (rng.standard_normal((b, t, n_mels + 2)).astype(np.float32)
                    for _ in range(2))
    lengths = rng.integers(t // 2, t + 1, size=b).astype(np.int32)
    lengths[0] = t
    for i, n in enumerate(lengths):
        emo_x[i, n:] = 0.0
        neu_x[i, n:] = 0.0
    emotions = rng.integers(0, n_emotions, size=b).astype(np.int32)
    lambdas = rng.uniform(0.0, 1.0, size=(2, b)).astype(np.float32)
    return emo_x, neu_x, emotions, lengths, lambdas


def tf32_round(x):
    """fp32 → TF32 (10 mantissa bits), to nearest with ties away from zero,
    as ``cvt.rna.tf32.f32`` does: integer operations on the fp32 bits."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


def conv1d_btc_3xtf32(x, w, dilation):
    """The vocoder kernels' conv arithmetic in plain torch: each operand
    split into hi = tf32(v) and lo = tf32(v - hi), and the products
    a_lo·b_hi + a_hi·b_lo + a_hi·b_hi summed in fp32 (products of two TF32
    values are exact in fp32)."""
    xh, wh = tf32_round(x), tf32_round(w)
    xl, wl = tf32_round(x - xh), tf32_round(w - wh)
    return (conv1d_btc(xl, wh, dilation) + conv1d_btc(xh, wl, dilation)
            + conv1d_btc(xh, wh, dilation))


def conv1d_btc_tf32(x, w, dilation):
    """One TF32 product a term: the bf16 MRF instance's arithmetic."""
    return conv1d_btc(tf32_round(x), tf32_round(w), dilation)


# chip_smoke.py's fp32 tolerance for the kernels against their plain versions
KERNEL_TOL = dict(atol=2e-4, rtol=2e-4)


def within(got, want, atol, rtol):
    """Every element of ``got`` within atol + rtol·|want| of ``want``."""
    return bool(((got - want).abs() <= atol + rtol * want.abs()).all())


_einsum = torch.einsum  # the library's, whatever a test patches in its place


def einsum_3xtf32(equation, a, b):
    """The fp32 attention kernels' product arithmetic in plain torch: both
    operands split as in :func:`conv1d_btc_3xtf32`, and
    a_lo·b_hi + a_hi·b_lo + a_hi·b_hi summed in fp32."""
    ah, bh = tf32_round(a), tf32_round(b)
    al, bl = tf32_round(a - ah), tf32_round(b - bh)
    return (_einsum(equation, al, bh) + _einsum(equation, ah, bl)
            + _einsum(equation, ah, bh))


def einsum_tf32(equation, a, b):
    """One TF32 product a term."""
    return _einsum(equation, tf32_round(a), tf32_round(b))
