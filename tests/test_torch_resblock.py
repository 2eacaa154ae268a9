"""The port's ResBlock1 (emotts_torch/ops/resblock.py) held against the JAX
package on the CPU: the Pallas kernel in interpret mode and its pure-JAX
reference.  On the CPU the port's wrapper takes the kernel's plain version;
the CUDA kernel is held against it on the card by chip_smoke.py."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from emotts.ops.resblock import fused_resblock1 as jax_fused_resblock1
from emotts.ops.resblock import resblock1_reference
from emotts_torch.ops import resblock as tr
from tests.torch_port_util import (  # noqa: F401
    conv1d_btc_3xtf32, single_torch_thread)

# fp32 on both sides, different summation order over k·C products per output
TOL = dict(rtol=2e-5, atol=2e-5)


def _case(rng, channels, k, t, n_d=3, b=2):
    scale = np.float32(1.0 / np.sqrt(k * channels))
    w1, w2 = (rng.standard_normal((n_d, k, channels, channels)).astype(np.float32) * scale
              for _ in range(2))
    b1, b2 = (rng.standard_normal((n_d, channels)).astype(np.float32) * 0.1
              for _ in range(2))
    x = rng.standard_normal((b, t, channels)).astype(np.float32)
    return x, (w1, b1, w2, b2)


@pytest.mark.parametrize("channels,k,t", [
    (32, 3, 75), (64, 7, 131), (128, 11, 77), (32, 11, 260),
])
def test_plain_resblock_matches_reference_and_pallas(rng, channels, k, t):
    x, params = _case(rng, channels, k, t)
    dil = (1, 3, 5)
    got = tr.fused_resblock1(torch.from_numpy(x),
                             *(torch.from_numpy(p) for p in params), dil).numpy()
    jx, jp = jnp.asarray(x), [jnp.asarray(p) for p in params]
    ref = np.asarray(resblock1_reference(jx, *jp, dil))
    np.testing.assert_allclose(got, ref, **TOL)
    # t is no multiple of the kernel's tile: its tail masking is in play
    pallas = np.asarray(jax_fused_resblock1(jx, *jp, dil, tile=128, interpret=True))
    np.testing.assert_allclose(got, pallas, **TOL)


def test_bf16_input_is_widened_once_and_rounded_once(rng):
    x, params = _case(rng, 32, 3, 40, n_d=2)
    xb = torch.from_numpy(x).bfloat16()
    tp = [torch.from_numpy(p) for p in params]
    got = tr.fused_resblock1(xb, *tp, (1, 3))
    want = tr.fused_resblock1(xb.float(), *tp, (1, 3)).bfloat16()
    assert got.dtype == torch.bfloat16
    assert torch.equal(got, want)


@pytest.mark.parametrize("channels,k,expected", [
    (32, 11, 1), (128, 11, 1), (256, 3, 1), (256, 7, 3), (256, 11, 3),
])
def test_launch_plan_fits_shared_memory(channels, k, expected):
    dil = (1, 3, 5)
    plan = tr.launch_plan(channels, k, dil)
    assert len(plan) == expected
    assert [p[0] for p in plan] == list(range(0, 3, 3 // expected))
    assert plan[-1][1] == 3
    for first, last, tile in plan:
        halo = tr.chain_halo(k, dil[first:last])
        # weight ring, window, and the intermediate without the rows of the
        # window it never holds
        z_off = tr.z_offset(k, dil[first:last], halo)
        floats = (tr.ring_floats(channels)
                  + (2 * tile + 4 * halo - 2 * z_off) * tr.row_floats(channels))
        assert tile >= 8 and tile % 8 == 0 and floats <= tr.SMEM_FLOATS


def test_wrapper_rejects_what_the_kernel_does_not_take(rng):
    x, (w1, b1, w2, b2) = _case(rng, 32, 3, 16)
    args = [torch.from_numpy(a) for a in (x, w1, b1, w2, b2)]
    before = tr.launch_count
    tr.fused_resblock1(*args, (1, 3, 5))
    assert tr.launch_count == before  # CPU: plain version, no launch
    with pytest.raises(ValueError):
        tr.fused_resblock1(*args, (1, 3))  # one dilation short of the weights
    with pytest.raises(ValueError):
        tr.fused_resblock1(args[0], args[1].double(), *args[2:], (1, 3, 5))


def test_3xtf32_design_holds_the_fp32_tolerance(rng, monkeypatch):
    """The CUDA kernel's arithmetic, emulated in plain torch: every conv of
    a C = 64, k = 11 ResBlock1 as 3xTF32 stays within the kernels' fp32
    tolerance (chip_smoke.py: 2e-4 abs and rel) of the fp32 plain version."""
    x, params = _case(rng, 64, 11, 100)
    x, params = torch.from_numpy(x), [torch.from_numpy(p) for p in params]
    want = tr.fused_resblock1_plain(x, *params, (1, 3, 5))
    monkeypatch.setattr(tr, "conv1d_btc", conv1d_btc_3xtf32)
    got = tr.fused_resblock1_plain(x, *params, (1, 3, 5))
    assert bool(((got - want).abs() <= 2e-4 + 2e-4 * want.abs()).all())


@pytest.mark.parametrize("tile,ratio", [(64, 1.686), (128, 1.343), (256, 1.171)])
def test_chain_rows_counts_the_halo_work(tile, ratio):
    """Rows computed per row kept over an MRF stage (k = 3/7/11, d = 1/3/5),
    weighted by taps; a chain of one step with no halo computes its tile and
    2r rows more in conv1."""
    dil = (1, 3, 5)
    rows = sum(tr.chain_rows(k, dil, tile) for k in (3, 7, 11))
    assert rows / (2 * 3 * 21 * tile) == pytest.approx(ratio, abs=1e-3)
    assert tr.chain_rows(11, (5,), 32) == 11 * ((32 + 10) + 32)
