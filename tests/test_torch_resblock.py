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
    conv1d_btc_3xtf32, jit, single_torch_thread)

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
    ref = np.asarray(jit(resblock1_reference, static_argnums=5)(jx, *jp, dil))
    np.testing.assert_allclose(got, ref, **TOL)
    # t is no multiple of the kernel's tile: its tail masking is in play
    pallas = np.asarray(jit(  # one compilation instead of one per primitive
        lambda x_, *p_: jax_fused_resblock1(x_, *p_, dil, tile=128, interpret=True)
    )(jx, *jp))
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
    (32, 11, 1), (64, 3, 1), (128, 11, 3), (256, 3, 3), (256, 7, 3), (256, 11, 3),
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
        assert tile >= 8 and floats <= tr.SMEM_FLOATS
        # a step's tile fills its conv1's last pass of the core, or shared memory
        if last - first == 1:
            r, step = (k - 1) // 2, tr.pass_rows(channels)
            assert (tile + 2 * r) % step == 0 or \
                floats + 2 * tr.row_floats(channels) > tr.SMEM_FLOATS


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


@pytest.mark.parametrize("tile,ratio", [(64, 2.151), (128, 1.575), (256, 1.288)])
def test_chain_rows_counts_the_halo_work(tile, ratio):
    """Rows computed per row kept over an MRF stage (k = 3/7/11, d = 1/3/5),
    weighted by taps, each conv's rows up to whole m64 tiles of the core; a
    chain of one step with no halo computes its tile and 2r rows more in
    conv1, each conv in whole m64 tiles; rounded to whole passes instead,
    what a block's time follows."""
    dil, m64 = (1, 3, 5), tr.M_TILE
    rows = sum(tr.chain_cost(k, dil, tile, m64) for k in (3, 7, 11))
    assert rows / (2 * 3 * 21 * tile) == pytest.approx(ratio, abs=1e-3)
    assert tr.chain_cost(11, (5,), 32, m64) == 11 * (64 + 64)  # 42 and 32 rows
    assert tr.chain_cost(11, (5,), 54, m64) == 11 * (64 + 64)  # 64 and 54 rows
    # the passes cover whole pass_rows: 64 accumulator registers a thread
    assert [tr.pass_rows(c, 2) for c in (32, 64, 128, 256)] == [256, 128, 128, 64]
    assert [tr.pass_rows(c, 1) for c in (32, 64, 128)] == [512, 256, 128]
    assert tr.chain_cost(11, (5,), 54, tr.pass_rows(32)) == 11 * (256 + 256)
    assert tr.chain_cost(11, (5,), 54, tr.pass_rows(256)) == \
        tr.chain_cost(11, (5,), 54, m64)


def _tf32_low_bits(x):
    return x.contiguous().view(torch.int32) & 0x1FFF


@pytest.mark.parametrize("channels,k", [(32, 3), (64, 1), (256, 1)])
def test_packed_weights_give_back_the_weights(rng, channels, k):
    """pack_weights' two parts: the inverse gives back hi = tf32(w) and
    lo = tf32(w - hi) in (tap, out, in) order, both with their low 13
    mantissa bits zero (TF32 values, as cvt.rna makes them), and hi + lo
    within 2^-21·|w| of w."""
    w = torch.from_numpy(rng.standard_normal((2, k, channels, channels)).astype(np.float32))
    packed = tr.pack_weights(w, 2)
    rows = 2 * channels if channels <= 64 else channels  # C <= 64: parts stacked
    assert packed.shape == (2, k, 2 * channels * channels // (32 * rows), rows, 32)
    hi, lo = tr.unpack_weights(packed, 2)
    wt = w.transpose(-1, -2)
    assert torch.equal(hi, tr.tf32_rna(wt)) and torch.equal(lo, tr.tf32_rna(wt - hi))
    assert not _tf32_low_bits(hi).any() and not _tf32_low_bits(lo).any()
    err = (hi.double() + lo.double() - wt.double()).abs()
    assert bool((err <= 2.0 ** -21 * wt.double().abs()).all())
    # tf32_rna rounds to nearest with ties away from zero, as cvt.rna does
    ties = torch.tensor([1 + 2 ** -11, -(1 + 2 ** -11), 1 + 2 ** -12], dtype=torch.float32)
    assert tr.tf32_rna(ties).tolist() == [1 + 2 ** -10, -(1 + 2 ** -10), 1.0]


def test_bf16_packing_is_the_bf16_weights(rng):
    """The bf16 MRF instance packs one part: the weights rounded to bf16,
    which are TF32 values already."""
    w = torch.from_numpy(rng.standard_normal((3, 7, 64, 64)).astype(np.float32))
    wb = w.bfloat16()
    packed = tr.pack_weights(wb, 1)
    assert packed.shape == (3, 7, 2, 64, 32) and packed.dtype == torch.float32
    (hi,) = tr.unpack_weights(packed, 1)
    assert torch.equal(hi, wb.float().transpose(-1, -2))
    assert not _tf32_low_bits(hi).any()


@pytest.mark.parametrize("channels,parts", [(32, 1), (32, 2), (128, 2)])
def test_packed_stage_reads_as_the_core_reads_it(rng, channels, parts):
    """The product of one tap as csrc/resblock_common.cuh's conv core forms
    it from the packed weights: A fragment columns from the 128-bit row loads
    (k8 step s of column c is channel 4c + 2s, or 4(c - 4) + 2s + 1 for
    c >= 4, within each 16), B through the swizzled 128-byte rows at the
    descriptors' byte offsets (chunk q at q ^ (row % 8)): one part; two side
    by side in a row (C >= 128: the lo part 64 bytes on); two stacked as rows
    (C <= 64: the lo part C rows on, a wgmma's N spanning both)."""
    c = channels
    stack = tr.stacked(c, parts)
    kc = 32 if stack or parts == 1 else 16
    w = torch.from_numpy(rng.standard_normal((1, c, c)).astype(np.float32))
    if parts == 1:
        w = w.bfloat16().float()
    packed = tr.pack_weights(w, parts)[0].double()  # (stages, rows, 32)
    act = torch.from_numpy(rng.standard_normal((5, c))).double()
    got = [torch.zeros(5, c, dtype=torch.float64) for _ in range(parts)]
    n = torch.arange(c)
    for q in range(c // kc):
        for s in range(kc // 8):
            cols = [q * kc + 16 * (s >> 1) + 4 * (j % 4) + 2 * (s & 1) + (j >= 4)
                    for j in range(8)]
            for part in range(parts):
                row = (part * c + n if stack else n)[None, :]
                pos = torch.tensor([(0 if stack else part * kc) + 8 * s + j
                                    for j in range(8)])[:, None]
                phys = 4 * ((pos // 4) ^ (row % 8)) + pos % 4
                got[part] += act[:, cols] @ packed[q, row, phys]
    want = tr.unpack_weights(tr.pack_weights(w[None], parts), parts)
    for g, p in zip(got, want):
        assert torch.allclose(g, act @ p[0, 0].double().T, rtol=1e-12, atol=1e-12)


def test_packed_weights_are_kept_until_the_weights_change(rng):
    """The wrappers' packed weights: packed once per weight tensor, packed
    anew after an in-place write to it, and for a cast (the bf16 MRF
    instance) packed from the cast values."""
    w = torch.nn.Parameter(torch.from_numpy(
        rng.standard_normal((3, 3, 32, 32)).astype(np.float32)))
    first = tr.packed_weights(w, 2)
    assert tr.packed_weights(w, 2) is first
    assert torch.equal(first, tr.pack_weights(w.detach(), 2))
    with torch.no_grad():
        w.mul_(2.0)
    second = tr.packed_weights(w, 2)
    assert second is not first and torch.equal(second, tr.pack_weights(w.detach(), 2))
    bf = tr.packed_weights(w, 1, torch.bfloat16)
    assert torch.equal(bf, tr.pack_weights(w.detach().bfloat16(), 1))
    assert not bf.requires_grad


def test_packed_weights_see_a_broadcast_into_the_weights(rng, tmp_path):
    """A collective writes a parameter without moving its version counter;
    ``replicate`` moves it, so that the packing kept beside the weights is
    made anew from what the broadcast wrote (a one-process gloo group)."""
    import torch.distributed as dist

    from emotts_torch.nn.hifigan import ResBlock1
    from emotts_torch.parallel.mesh import Mesh, replicate

    block = ResBlock1(32, 3)
    stale = tr.packed_weights(block.w1, 2)
    dist.init_process_group("gloo", init_method=f"file://{tmp_path / 'store'}",
                            world_size=1, rank=0)
    try:
        mesh = Mesh(1, (torch.device("cpu"),), group=dist.group.WORLD)
        with torch.no_grad():  # what another rank would hand this one
            block.w1.data.mul_(3.0)
        replicate(mesh, block)
    finally:
        dist.destroy_process_group()
    fresh = tr.packed_weights(block.w1, 2)
    assert fresh is not stale
    assert torch.equal(fresh, tr.pack_weights(block.w1.detach(), 2))


@pytest.mark.parametrize("k,frames,launches", [(3, 49, 1), (7, 66, 1), (11, 49, 3),
                                              (11, 1024, 3)])
def test_launch_plan_spreads_a_short_sequence_over_the_sms(k, frames, launches):
    """The C = 256 stage's blocks at a streaming window (one row of 8·frames
    rows) and at the sweep's (16 rows): a long sequence keeps the plan made
    without one, a short one takes tiles that spread over the SMs, and the
    whole chain in one launch where that then costs less than the steps."""
    dil, rows = (1, 3, 5), (1 if frames < 100 else 16)
    t = 8 * frames
    plan = tr.launch_plan(256, k, dil, rows, t, tr.SMS)
    assert len(plan) == launches and plan[-1][1] == 3
    if frames > 100:
        assert plan == tr.launch_plan(256, k, dil)
    for first, last, tile in plan:
        fit = tr.chain_fits(256, k, dil[first:last])
        assert 8 <= tile <= fit[0]
        if frames < 100:  # one wave, and no shorter tile has fewer passes
            assert rows * -(-t // tile) <= tr.SMS