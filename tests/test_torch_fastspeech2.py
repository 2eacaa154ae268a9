"""FastSpeech2 of the port (emotts_torch/nn/fastspeech2.py) held against the
flax module on the CPU, in fp32, with weights made from a numpy seed and
carried across by emotts_torch.nn.convert.  The JAX side reaches its fused
attention kernel in Pallas interpret mode."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import emotts.ops.attention as fa
from emotts.utils.config import Config as JaxConfig
from emotts_torch.infer.synthesize import build_fastspeech2
from emotts_torch.nn.convert import fs2_from_flax
from emotts_torch.nn.length_regulator import (average_over_durations,
                                              length_regulate, phone_index_map)
from emotts_torch.utils.config import Config
from tests.torch_port_util import (  # noqa: F401
    fs2_variables, jit, shrink, single_torch_thread)

# fp32 end to end through 4 FFT blocks, LayerNorms computed by different
# formulas (E[x²]−E[x]² in flax, Welford in torch): a few 1e-5 on O(1) values
TOL = dict(rtol=1e-4, atol=1e-4)
NAMES = ("mel_post", "postnet_mel", "log_durations", "pred_pitch", "avg_pitch",
         "pred_energy", "avg_energy", "mel_lens")


@pytest.fixture(autouse=True)
def _interpret():
    fa._INTERPRET = True
    yield
    fa._INTERPRET = False


def _models(prenet, postnet, fused=True):
    jcfg = shrink(JaxConfig(), prenet, postnet, fused)
    jmodel, variables = fs2_variables(jcfg, seed=5)
    tmodel = build_fastspeech2(shrink(Config(), prenet, postnet, fused))
    tmodel.load_state_dict(fs2_from_flax(variables))
    return jmodel, variables, tmodel.eval()


def _batch(rng, speakers_as_blend):
    b, p = 3, 14
    tokens = rng.integers(1, 90, (b, p)).astype(np.int32)
    tokens[1, 9:] = 0
    tokens[2, 4:] = 0
    if speakers_as_blend:
        spk = rng.random((b, 3)).astype(np.float32)
        spk /= spk.sum(axis=1, keepdims=True)
    else:
        spk = np.array([0, 2, 1], np.int32)
    intensity = rng.standard_normal((b, p, 3)).astype(np.float32)
    return tokens, spk, intensity


def _as_torch(a):
    t = torch.from_numpy(np.asarray(a))
    return t.long() if t.dtype == torch.int32 else t


def _compare(ref, got):
    assert len(ref) == len(got) == 8
    for name, a, b in zip(NAMES, ref, got):
        if a is None:
            assert b is None, name
            continue
        a = np.asarray(a)
        assert tuple(b.shape) == a.shape, name
        if name == "mel_lens":
            np.testing.assert_array_equal(b.numpy(), a)
        else:
            np.testing.assert_allclose(b.numpy(), a, err_msg=name, **TOL)


@pytest.mark.parametrize("prenet,postnet,blend", [
    ("conv", "batchnorm", False),
    ("conv", "batchnorm", True),
    ("embedding", "speechbrain", False),
])
def test_free_running_forward_matches_flax(rng, prenet, postnet, blend):
    jmodel, variables, tmodel = _models(prenet, postnet)
    tokens, spk, intensity = _batch(rng, blend)
    # jitted: one compilation instead of one per primitive
    ref = jit(lambda v, tok, s, i: jmodel.apply(
        v, tok, s, intensity=i, pace=1.3, pitch_rate=0.9, energy_rate=1.1,
        max_mel_len=64))(variables, jnp.asarray(tokens), jnp.asarray(spk),
                         jnp.asarray(intensity))
    with torch.no_grad():
        got = tmodel(_as_torch(tokens), _as_torch(spk),
                     intensity=_as_torch(intensity), pace=1.3, pitch_rate=0.9,
                     energy_rate=1.1, max_mel_len=64)
    assert int(np.asarray(ref[7]).min()) > 0  # every row has frames
    _compare(ref, got)


@pytest.mark.parametrize("prenet,postnet,fused", [
    ("conv", "batchnorm", True),
    ("embedding", "speechbrain", False),
])
def test_teacher_forced_forward_matches_flax(rng, prenet, postnet, fused):
    jmodel, variables, tmodel = _models(prenet, postnet, fused)
    tokens, spk, intensity = _batch(rng, False)
    durations = rng.integers(0, 5, tokens.shape).astype(np.int32) * (tokens != 0)
    t = 48
    frame_valid = np.arange(t)[None, :] < durations.sum(axis=1)[:, None]
    pitch = (rng.standard_normal((3, t)) * frame_valid).astype(np.float32)
    energy = (rng.standard_normal((3, t)) * frame_valid).astype(np.float32)
    ref = jit(lambda v, tok, s, d, p, e, i: jmodel.apply(
        v, tok, s, durations=d, pitch=p, energy=e, intensity=i, max_mel_len=t))(
        variables, *(jnp.asarray(a) for a in (tokens, spk, durations, pitch,
                                              energy, intensity)))
    with torch.no_grad():
        got = tmodel(_as_torch(tokens), _as_torch(spk),
                     durations=_as_torch(durations), pitch=_as_torch(pitch),
                     energy=_as_torch(energy), intensity=_as_torch(intensity),
                     max_mel_len=t)
    assert ref[4] is not None and ref[6] is not None
    _compare(ref, got)


def test_length_regulator_matches_jax(rng):
    from emotts.nn import length_regulator as jl

    durations = rng.integers(0, 6, (3, 10)).astype(np.int32)
    durations[2] = 0  # a row with no frames at all
    x = rng.standard_normal((3, 10, 4)).astype(np.float32)
    values = rng.standard_normal((3, 40)).astype(np.float32)
    td = torch.from_numpy(durations).long()
    np.testing.assert_array_equal(
        phone_index_map(td, 40).numpy(),
        np.asarray(jl.phone_index_map(jnp.asarray(durations), 40)),
    )
    frames, lens = length_regulate(torch.from_numpy(x), td, 40)
    jframes, jlens = jl.length_regulate(jnp.asarray(x), jnp.asarray(durations), 40)
    np.testing.assert_array_equal(frames.numpy(), np.asarray(jframes))
    np.testing.assert_array_equal(lens.numpy(), np.asarray(jlens))
    np.testing.assert_allclose(
        average_over_durations(torch.from_numpy(values), td).numpy(),
        np.asarray(jl.average_over_durations(jnp.asarray(values),
                                             jnp.asarray(durations))),
        rtol=1e-5, atol=1e-6,
    )
