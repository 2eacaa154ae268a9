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
from emotts_torch.ops.resblock import SLAB_FLOATS, SMEM_FLOATS, chain_halo
from tests.torch_port_util import single_torch_thread  # noqa: F401

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
    floats = SLAB_FLOATS + 2 * (tile + 2 * halo) * (channels + 1) + tile * channels
    assert halo == 60 and tile >= 64 and tile % 8 == 0 and floats <= SMEM_FLOATS
    with pytest.raises(ValueError):
        tm.stage_tile(256, ks, dil)


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
