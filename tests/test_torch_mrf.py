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
    conv1d_btc_3xtf32, conv1d_btc_tf32, single_torch_thread, tf32_round)

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
    ref = np.asarray(mrf_reference(jnp.asarray(x), _jax(params)))
    np.testing.assert_allclose(got, ref, **TOL)
    pallas = np.asarray(
        jax_fused_mrf_stage(jnp.asarray(x), _jax(params), tile=32, interpret=True)
    )
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
    pallas = np.asarray(jax_fused_mrf_stage(
        jnp.asarray(x, jnp.bfloat16), _jax(params), (3, 7), tile=32, interpret=True
    ).astype(jnp.float32))
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


@pytest.mark.parametrize("channels", [32, 64, 128])
def test_stage_tile_fits_shared_memory(channels):
    ks, dil = (3, 7, 11), (1, 3, 5)
    tile = tm.stage_tile(channels, ks, dil)
    halo = max(chain_halo(k, dil) for k in ks)
    # weight ring, window, and the intermediate without the rows of the
    # window it never holds; the running mean over the ResBlocks lives in
    # device memory
    z_off = min(z_offset(k, dil, halo) for k in ks)
    floats = ring_floats(channels) + (2 * tile + 4 * halo - 2 * z_off) * row_floats(channels)
    assert halo == 60 and tile >= 64 and tile % 8 == 0 and floats <= SMEM_FLOATS
    with pytest.raises(ValueError):
        tm.stage_tile(256, ks, dil)


@pytest.mark.parametrize("channels,launches", [(32, 1), (64, 1), (128, 9)])
def test_launch_plan_cuts_a_long_halo_stage_into_steps(channels, launches):
    """One launch where the stage's tile computes at most 1.25 rows per row
    kept; else one per (ResBlock, dilation step), each with its own halo."""
    ks, dil = (3, 7, 11), (1, 3, 5)
    plan = tm.launch_plan(channels, ks, dil)
    assert len(plan) == launches
    if launches > 1:
        assert [p[:2] for p in plan] == [(rb, j) for rb in range(3) for j in range(3)]
    for rb, j, tile in plan:
        if rb is None:
            halo, z_off = 60, min(z_offset(k, dil, 60) for k in ks)
        else:
            halo = chain_halo(ks[rb], (dil[j],))
            z_off = z_offset(ks[rb], (dil[j],), halo)
        floats = ring_floats(channels) + (2 * tile + 4 * halo - 2 * z_off) * row_floats(channels)
        assert tile >= 8 and tile % 8 == 0 and floats <= SMEM_FLOATS


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


# chip_smoke.py's fp32 tolerance for the kernels against their plain versions
KERNEL_TOL = dict(atol=2e-4, rtol=2e-4)


def _within(got, want, atol, rtol):
    return bool(((got - want).abs() <= atol + rtol * want.abs()).all())


def test_3xtf32_design_holds_the_fp32_tolerance(rng, monkeypatch):
    """The CUDA kernel's arithmetic, emulated in plain torch: every conv of
    the stage as 3xTF32 stays within the kernels' fp32 tolerance of the fp32
    plain version; one TF32 product a term alone would not."""
    params = _torch(_params(rng, 32))
    x = torch.from_numpy(rng.standard_normal((2, 100, 32)).astype(np.float32))
    want = tm.fused_mrf_stage_plain(x, params)
    monkeypatch.setattr(tm, "conv1d_btc", conv1d_btc_3xtf32)
    assert _within(tm.fused_mrf_stage_plain(x, params), want, **KERNEL_TOL)
    monkeypatch.setattr(tm, "conv1d_btc", conv1d_btc_tf32)
    assert not _within(tm.fused_mrf_stage_plain(x, params), want, **KERNEL_TOL)


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
