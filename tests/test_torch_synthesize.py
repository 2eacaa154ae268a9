"""The slice as a whole: the same requests through the JAX package's
Synthesizer and the port's (device "cpu", fp32, lexicon/rule G2P), with
weights made from a numpy seed and handed to both."""

import numpy as np
import pytest
import torch

from emotts.infer.synthesize import Synthesizer as JaxSynthesizer
from emotts.utils.config import Config as JaxConfig
from emotts_torch.infer.synthesize import Synthesizer, pick_bucket, resolve_name
from emotts_torch.utils.config import Config
from tests.torch_port_util import (SMALL_VOCODER, fs2_variables, shrink,
                                   vocoder_params,
                                   single_torch_thread)  # noqa: F401

FLAGS = dict(fused_mrf=True, use_pallas_resblocks=True)
VOCODER = dict(SMALL_VOCODER, in_channels=80, upsample_rates=(8, 8, 2, 2),
               upsample_kernel_sizes=(16, 16, 4, 4),
               upsample_initial_channel=128)
# Both sides compute in fp32 and differ by summation order (~1e-5 on a
# waveform in (-1, 1)), i.e. under one step of 32767; truncation to int16
# can turn that into one whole step.
PCM_STEPS = 1


@pytest.fixture(scope="module")
def pair():
    """The JAX package's Synthesizer and the port's over the same weights.
    The port takes its fused attention and vocoder kernel paths (their plain
    versions on the CPU); the JAX side takes XLA's attention and the plain
    generator, which the JAX package's own tests hold equal to its
    interpret-mode kernels (tests/test_fused_attention.py,
    tests/test_hifigan_pallas_path.py): compiling those per phone bucket and
    vocoder shape is not what this file tests."""
    jcfg = shrink(JaxConfig(), fused=False)
    _, variables = fs2_variables(jcfg, seed=11)
    _, voc_tree = vocoder_params(VOCODER, seed=12, scale=0.05)
    bank = np.random.default_rng(13).standard_normal((3, 3, 3, 3)).astype(np.float32)
    jsynth = JaxSynthesizer(jcfg, variables, voc_tree, bank, vocoder_structure=VOCODER)
    tsynth = Synthesizer(shrink(Config()), variables, voc_tree, bank,
                         vocoder_structure=dict(VOCODER, **FLAGS), device="cpu")
    assert tsynth.model.encoder.layers[0].attn.fused and tsynth.vocoder.fused_mrf
    return jsynth, tsynth


def _pcm(wav):
    return np.round(np.asarray(wav, np.float64) * 32767.0).astype(np.int64)


def test_requests_give_the_same_pcm(pair):
    jsynth, tsynth = pair
    requests = [
        {"text": "Hello there. How are you today?", "speaker": 0, "emotion": 1,
         "level": 1.5},
        {"text": "Quite well.", "speaker": 2, "emotion": 0,
         "emotion_mix": [(1, 0.6), (2, 2.0, 0.4)], "scale": 1.2},
        {"text": "Blended voice.", "speaker": 0, "emotion": 2,
         "speaker_mix": [(0, 0.5), (1, 0.5)]},
    ]
    ref = jsynth.synthesize_requests(requests, pace=1.1)
    got = tsynth.synthesize_requests(requests, pace=1.1)
    assert len(ref) == len(got) == 3
    for a, b in zip(ref, got):
        assert a.shape == b.shape and a.size > 2000  # mel_lens agree exactly
        assert np.abs(_pcm(a)).max() > 300  # there is a signal to compare
        assert np.abs(_pcm(a) - _pcm(b)).max() <= PCM_STEPS


def test_intensity_sweep_keys_and_lengths(pair, tmp_path):
    jsynth, tsynth = pair
    text = "Gregson was asleep."
    ref = jsynth.intensity_sweep(text)
    got = tsynth.intensity_sweep(text, out_dir=str(tmp_path))
    assert list(ref) == list(got) and len(got) == 3 * 3 * 3
    for key in ref:
        assert ref[key].shape == got[key].shape
        assert np.abs(_pcm(ref[key]) - _pcm(got[key])).max() <= PCM_STEPS
    assert len(list(tmp_path.glob("*.wav"))) == 27


def test_vocode_chunking_equals_unchunked(pair):
    _, tsynth = pair
    ids = tsynth.text_to_phoneme_ids("Chunk me.")
    speakers = np.array([0, 1, 2, 0, 1], np.int32)
    inten = np.stack([tsynth.intensity_for(s, 1, 1.0, len(ids)) for s in speakers])
    mel, lens = tsynth.synthesize_mels(ids, speakers, inten)
    assert mel.shape == (5, 64, 80) and int(lens.min()) > 0
    whole = tsynth.vocode(mel, row_frame_budget=0)
    chunked = tsynth.vocode(mel, row_frame_budget=2 * 64)  # 2 + 2 + 1(+pad)
    assert whole.dtype == torch.int16 and whole.shape == (5, 64 * 256)
    assert torch.equal(whole, chunked)


def test_ssml_and_text_entry_points(pair):
    jsynth, tsynth = pair
    markup = ('<speak>Plain. <emotion name="amused" level="2">Funny!</emotion>'
              '<break time="100ms"/><voice name="b">Other.</voice></speak>')
    a = jsynth.synthesize_ssml(markup, speaker=0, emotion=0)
    b = tsynth.synthesize_ssml(markup, speaker=0, emotion=0)
    assert a.shape == b.shape
    assert np.abs(_pcm(a) - _pcm(b)).max() <= PCM_STEPS
    c = tsynth.synthesize_text("Plain.", 0, 0)
    d = jsynth.synthesize_text("Plain.", 0, 0)
    assert c.shape == d.shape and np.abs(_pcm(c) - _pcm(d)).max() <= PCM_STEPS


def test_name_resolution_and_buckets():
    table = ["a", "b"]
    assert resolve_name("b", table, "speaker") == 1
    assert resolve_name(1, table, "speaker") == resolve_name("1", table, "speaker") == 1
    for bad in (None, True, 2, "zed"):
        with pytest.raises(ValueError):
            resolve_name(bad, table, "speaker")
    assert [pick_bucket(n, [16, 32]) for n in (1, 16, 17, 33)] == [16, 16, 32, -1]


def test_cuda_is_the_default_device_and_raises_without_a_card(pair):
    if torch.cuda.is_available():
        pytest.skip("this check is for machines without a GPU")
    _, tsynth = pair
    with pytest.raises(RuntimeError, match="GPU"):
        Synthesizer(shrink(Config()), tsynth.model.state_dict())
