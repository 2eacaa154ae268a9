"""The port's fused MRF stage (emotts_torch/ops/mrf.py) held against the JAX
package on the CPU: the Pallas kernel in interpret mode and its pure-JAX
reference.  On the CPU the port's wrapper takes the kernel's plain version;
the CUDA kernel is held against it on the card by chip_smoke.py."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from emotts.ops.mrf import fused_mrf_stage as jax_fused_mrf_stage
from emotts.ops.mrf import mrf_reference
from emotts_torch.ops import mrf as tm
from emotts_torch.ops.resblock import (SMEM_FLOATS, chain_halo, ring_floats,
                                       row_floats, z_offset)
from tests.torch_port_util import (  # noqa: F401
    KERNEL_TOL, conv1d_btc_3xtf32, conv1d_btc_tf32, jit, single_torch_thread,
    tf32_round, within)

# fp32 on both sides, different summation order
TOL = dict(rtol=2e-5, atol=2e-5)


def _params(rng, channels, kernel_sizes=(3, 7, 11), n_d=3):
    out = []
    for k in kernel_sizes:
        scale = np.float32(1.0 / np.sqrt(k * channels))
        out.append((
            rng.standard_normal((n_d, k, channels, channels)).astype(np.float32) * scale,
            rng.standard_normal((n_d, channels)).astype(np.float32) * 0.1,
            rng.standard_normal((n_d, k, channels, channels)).astype(np.float32) * scale,
            rng.standard_normal((n_d, channels)).astype(np.float32) * 0.1,
        ))
    return out


def _torch(params):
    return [tuple(torch.from_numpy(a) for a in block) for block in params]


def _jax(params):
    return [tuple(jnp.asarray(a) for a in block) for block in params]


@pytest.mark.parametrize("channels,t", [(128, 72), (64, 134), (32, 332)])
def test_plain_mrf_matches_reference_and_pallas(rng, channels, t):
    """t is a multiple of 128 // channels (the TPU kernel's packing needs
    it) and of no tile."""
    params = _params(rng, channels)
    x = rng.standard_normal((2, t, channels)).astype(np.float32)
    got = tm.fused_mrf_stage(torch.from_numpy(x), _torch(params)).numpy()
    ref = np.asarray(jit(mrf_reference)(jnp.asarray(x), _jax(params)))
    np.testing.assert_allclose(got, ref, **TOL)
    pallas = np.asarray(jit(  # one compilation instead of one per primitive
        lambda x_, p_: jax_fused_mrf_stage(x_, p_, tile=32, interpret=True)
    )(jnp.asarray(x), _jax(params)))
    np.testing.assert_allclose(got, pallas, **TOL)


def test_plain_mrf_bf16_repeats_the_reference_rounding_points(rng):
    """bf16 activations: both sides round after each leaky-relu and cast the
    weights; they then differ by summation order, which can flip a bf16
    rounding (one step at |x| < 8 is 2^-5) on a few elements."""
    channels, t = 32, 64
    params = _params(rng, channels, kernel_sizes=(3, 7))
    x = rng.standard_normal((1, t, channels)).astype(np.float32)
    got = tm.fused_mrf_stage(
        torch.from_numpy(x).bfloat16(), _torch(params), (3, 7)
    ).float().numpy()
    pallas = np.asarray(jit(  # one compilation instead of one per primitive
        lambda x_, p_: jax_fused_mrf_stage(x_, p_, (3, 7), tile=32, interpret=True)
    )(jnp.asarray(x, jnp.bfloat16), _jax(params)).astype(jnp.float32))
    diff = np.abs(got - pallas)
    assert diff.max() <= 2.0 ** -5
    assert (diff > 0).mean() < 0.02


def test_single_resblock_stage_equals_the_resblock(rng):
    from emotts_torch.ops.resblock import fused_resblock1

    params = _params(rng, 32, kernel_sizes=(7,))
    x = torch.from_numpy(rng.standard_normal((2, 50, 32)).astype(np.float32))
    stage = tm.fused_mrf_stage(x, _torch(params), (7,))
    block = fused_resblock1(x, *_torch(params)[0], (1, 3, 5))
    np.testing.assert_allclose(stage.numpy(), block.numpy(), rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("channels,expected", [(32, 442), (64, 186), (128, 46)])
def test_stage_tile_fits_shared_memory(channels, expected):
    ks, dil = (3, 7, 11), (1, 3, 5)
    tile = tm.stage_tile(channels, ks, dil)
    halo = max(chain_halo(k, dil) for k in ks)
    # weight ring, window, and the intermediate without the rows of the
    # window it never holds; the running mean over the ResBlocks lives in
    # device memory
    z_off = min(z_offset(k, dil, halo) for k in ks)
    floats = ring_floats(channels) + (2 * tile + 4 * halo - 2 * z_off) * row_floats(channels)
    # the tile fitted to the core's passes (256, 128, 128 rows at C = 32,
    # 64, 128); C = 128's window and intermediate leave 46 rows beside the
    # 64 KB ring
    assert halo == 60 and tile == expected and floats <= SMEM_FLOATS
    with pytest.raises(ValueError):
        tm.stage_tile(256, ks, dil)


@pytest.mark.parametrize("channels,ks,dil,launches", [
    (32, (3, 7, 11), (1, 3, 5), 1), (64, (3, 7, 11), (1, 3, 5), 9),
    (128, (3, 7, 11), (1, 3, 5), 9), (32, (3, 5), (1, 2), 1),
])
def test_launch_plan_cuts_a_long_halo_stage_into_steps(channels, ks, dil, launches):
    """On a long sequence, one launch where the stage's passes are at most
    STEP_OVERHEAD times those of the steps' launches (C = 32, a short halo);
    else one per (ResBlock, dilation step), each with its own halo."""
    plan = tm.launch_plan(channels, ks, dil)
    assert len(plan) == launches
    if launches > 1:
        assert [p[:2] for p in plan] == [(rb, j) for rb in range(3) for j in range(3)]
    for rb, j, tile in plan:
        if rb is None:
            halo = max(chain_halo(k, dil) for k in ks)
            z_off = min(z_offset(k, dil, halo) for k in ks)
        else:
            halo = chain_halo(ks[rb], (dil[j],))
            z_off = z_offset(ks[rb], (dil[j],), halo)
        floats = ring_floats(channels) + (2 * tile + 4 * halo - 2 * z_off) * row_floats(channels)
        assert tile >= 8 and floats <= SMEM_FLOATS


@pytest.mark.parametrize("channels,parts,rows,t,launches", [
    (128, 2, 1, 64 * 49, 1), (64, 2, 1, 128 * 66, 1), (32, 1, 1, 256 * 49, 1),
    (64, 1, 16, 128 * 1024, 1), (64, 2, 16, 128 * 1024, 9), (128, 2, 2, 777, 1),
])
def test_launch_plan_follows_the_sequence(channels, parts, rows, t, launches):
    """The plan for ``rows`` sequences of ``t`` rows: the sweep's (16 rows
    of 1024 frames) keeps the long-sequence plan; a streaming window (one
    row of 49 or 66 frames) or a short ragged batch takes tiles short enough
    to give the SMs a block each, and then the whole stage in one launch."""
    ks, dil = (3, 7, 11), (1, 3, 5)
    plan = tm.launch_plan(channels, ks, dil, parts, rows, t, 132)
    assert len(plan) == launches
    if t > 100_000:
        assert plan == tm.launch_plan(channels, ks, dil, parts)
    else:
        (_, _, tile), = plan
        assert 8 <= tile < tm.stage_tile(channels, ks, dil, parts)
        assert rows * -(-t // tile) <= 132


def test_cpu_wrapper_counts_no_launch_and_checks_arguments(rng):
    params = _torch(_params(rng, 32, kernel_sizes=(3,)))
    x = torch.from_numpy(rng.standard_normal((1, 20, 32)).astype(np.float32))
    before = tm.launch_count
    tm.fused_mrf_stage(x, params, (3,))
    assert tm.launch_count == before
    with pytest.raises(ValueError):
        tm.fused_mrf_stage(x, params, (5,))  # weights have kernel size 3
    with pytest.raises(ValueError):
        tm.fused_mrf_stage(x, params, (3, 7))  # one ResBlock's weights short


def test_3xtf32_design_holds_the_fp32_tolerance(rng, monkeypatch):
    """The CUDA kernel's arithmetic, emulated in plain torch: every conv of
    the stage as 3xTF32 stays within the kernels' fp32 tolerance of the fp32
    plain version; one TF32 product a term alone would not."""
    params = _torch(_params(rng, 32))
    x = torch.from_numpy(rng.standard_normal((2, 100, 32)).astype(np.float32))
    want = tm.fused_mrf_stage_plain(x, params)
    monkeypatch.setattr(tm, "conv1d_btc", conv1d_btc_3xtf32)
    assert within(tm.fused_mrf_stage_plain(x, params), want, **KERNEL_TOL)
    monkeypatch.setattr(tm, "conv1d_btc", conv1d_btc_tf32)
    assert not within(tm.fused_mrf_stage_plain(x, params), want, **KERNEL_TOL)


def test_packed_3xtf32_stage_holds_the_fp32_tolerance(rng, monkeypatch):
    """The kernels' arithmetic on the weights as packed for them: each conv
    of a C = 32 stage takes pack_weights' hi and lo parts (unpacked) and
    a_lo·b_hi + a_hi·b_lo + a_hi·b_hi, within the kernels' fp32 tolerance of
    the fp32 plain version and equal to conv1d_btc_3xtf32 on the raw
    weights."""
    from emotts_torch.ops.resblock import conv1d_btc, pack_weights, unpack_weights

    def packed_3xtf32(x, w, dilation):
        hi, lo = (p.transpose(-1, -2) for p in unpack_weights(pack_weights(w, 2), 2))
        xh = tf32_round(x)
        xl = tf32_round(x - xh)
        return (conv1d_btc(xl, hi, dilation) + conv1d_btc(xh, lo, dilation)
                + conv1d_btc(xh, hi, dilation))

    params = _torch(_params(rng, 32))
    x = torch.from_numpy(rng.standard_normal((2, 100, 32)).astype(np.float32))
    want = tm.fused_mrf_stage_plain(x, params)
    monkeypatch.setattr(tm, "conv1d_btc", conv1d_btc_3xtf32)
    emulated = tm.fused_mrf_stage_plain(x, params)
    monkeypatch.setattr(tm, "conv1d_btc", packed_3xtf32)
    got = tm.fused_mrf_stage_plain(x, params)
    assert within(got, want, **KERNEL_TOL)
    assert torch.equal(got, emulated)


def test_one_tf32_product_is_exact_on_bf16_operands(rng, monkeypatch):
    """The bf16 instance's premise: values exact in bf16 are exact in TF32,
    so one TF32 product a term is the fp32 product."""
    a, b = (torch.from_numpy(rng.standard_normal(4096).astype(np.float32))
            .bfloat16().float() for _ in range(2))
    assert torch.equal(tf32_round(a), a) and torch.equal(tf32_round(b), b)
    assert torch.equal((tf32_round(a) * tf32_round(b)).double(),
                       a.double() * b.double())
    params = _torch(_params(rng, 32, kernel_sizes=(3, 7)))
    x = torch.from_numpy(rng.standard_normal((1, 64, 32)).astype(np.float32)).bfloat16()
    want = tm.fused_mrf_stage_plain(x, params, (3, 7))
    monkeypatch.setattr(tm, "conv1d_btc", conv1d_btc_tf32)
    assert torch.equal(tm.fused_mrf_stage_plain(x, params, (3, 7)), want)
