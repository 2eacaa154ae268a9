"""The port's HiFi-GAN generator (emotts_torch/nn/hifigan.py) held against
the flax generator on the CPU in fp32, for the three flag settings, with
weights made from a numpy seed and carried across by
emotts_torch.nn.convert.  The JAX side runs its Pallas kernels in interpret
mode (they select it themselves off the TPU)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from emotts.nn.hifigan import generator_structure_from_params as jax_structure
from emotts_torch.nn.convert import hifigan_from_flax, load_vocoder_checkpoint
from emotts_torch.nn.hifigan import (HiFiGANGenerator, ResBlock1,
                                     generator_structure_from_params)
from tests.torch_port_util import (  # noqa: F401
    SMALL_VOCODER, jit, vocoder_params, single_torch_thread)

# fp32 on both sides through 2 upsample stages; waveform values in (-1, 1)
TOL = dict(rtol=1e-4, atol=2e-5)


@pytest.mark.parametrize("flags", [
    dict(),
    dict(use_pallas_resblocks=True),
    dict(fused_mrf=True, use_pallas_resblocks=True),
    dict(subpixel_upsample=False, time_packed_resblocks=True),
], ids=["plain", "resblock-kernel", "mrf+resblock-kernel", "literal-upsample"])
def test_waveform_matches_flax(rng, flags):
    jgen, tree = vocoder_params(**flags)
    mel = rng.standard_normal((2, 11, SMALL_VOCODER["in_channels"])).astype(np.float32)
    ref = np.asarray(jit(jgen.apply)(tree, jnp.asarray(mel)))  # one compilation
    tgen = HiFiGANGenerator(**SMALL_VOCODER, **flags)
    tgen.load_state_dict(hifigan_from_flax(tree))
    with torch.no_grad():
        got = tgen.eval()(torch.from_numpy(mel)).numpy()
    assert got.shape == ref.shape == (2, 11 * 8)
    assert np.abs(ref).max() > 0.05  # the weights give a signal worth comparing
    np.testing.assert_allclose(got, ref, **TOL)


def test_fused_stages_are_the_narrow_ones():
    gen = HiFiGANGenerator(fused_mrf=True, use_pallas_resblocks=True)
    assert [gen._stage_is_fused(c) for c in (256, 128, 64, 32)] == [
        False, True, True, True]
    assert all(blk.use_pallas for blk in gen.resblocks)
    assert not HiFiGANGenerator()._stage_is_fused(64)


def test_resblock_module_kernel_route_equals_conv_route(rng):
    a, b = ResBlock1(32, 7, (1, 3)), ResBlock1(32, 7, (1, 3), use_pallas=True)
    b.load_state_dict(a.state_dict())
    x = torch.from_numpy(rng.standard_normal((2, 37, 32)).astype(np.float32))
    with torch.no_grad():
        np.testing.assert_allclose(b(x).numpy(), a(x).numpy(), rtol=1e-5, atol=1e-6)


def test_structure_from_params_and_npz_round_trip(tmp_path):
    from emotts.infer.synthesize import save_vocoder_params_npz

    _, tree = vocoder_params()
    assert generator_structure_from_params(tree, 8) == jax_structure(tree, 8)
    with pytest.raises(ValueError):
        generator_structure_from_params(tree, expected_upsample=256)
    path = str(tmp_path / "voc.npz")
    save_vocoder_params_npz(tree, path)
    loaded = load_vocoder_checkpoint(path)
    a, b = hifigan_from_flax(tree), hifigan_from_flax(loaded)
    assert a.keys() == b.keys() and all(torch.equal(a[k], b[k]) for k in a)
    # a torch checkpoint is read as one, not refused (its conversion:
    # tests/test_torch_reference_import.py)
    with pytest.raises(FileNotFoundError):
        load_vocoder_checkpoint(str(tmp_path / "generator.pt"))


@pytest.mark.parametrize("flags", [
    dict(),
    dict(fused_mrf=True, use_pallas_resblocks=True),
], ids=["plain", "mrf+resblock-kernel"])
def test_bf16_mel_follows_the_reference_type_promotion(rng, flags):
    """A bf16 mel: both generators run the first conv in bf16, then its fp32
    bias makes x fp32 (the reference's type promotion), so the rest runs in
    fp32 on both sides and the waveform is fp32.  Tolerance: the fp32
    comparison's, with atol 1e-4 for a conv_pre output that the two
    frameworks' bf16 convs might round to neighbouring values (none does at
    this seed: 5.5e-6 apart); a generator that stays in bf16 after the first
    conv misses by 0.1."""
    jgen, tree = vocoder_params(**flags)
    mel = rng.standard_normal((2, 11, SMALL_VOCODER["in_channels"])).astype(np.float32)
    ref = jgen.apply(tree, jnp.asarray(mel, jnp.bfloat16))
    tgen = HiFiGANGenerator(**SMALL_VOCODER, **flags)
    tgen.load_state_dict(hifigan_from_flax(tree))
    with torch.no_grad():
        got = tgen.eval()(torch.from_numpy(mel).bfloat16())
    assert ref.dtype == jnp.float32 and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-4, atol=1e-4)
