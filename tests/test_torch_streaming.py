"""Streamed synthesis in the port (emotts_torch/infer/streaming.py,
Synthesizer.synthesize_first_chunk, the chunked audio/L16 response of the
server) on the CPU: chunked vocoding equal to unchunked vocoding bit for bit,
as tests/test_streaming.py asks of the JAX package, and the port's stream
held against the JAX package's stream_text on the same weights."""

import json
import threading
import urllib.request

import numpy as np
import pytest
import torch

from emotts.infer.streaming import generator_halo_frames as jax_halo_frames
from emotts.infer.streaming import stream_text as jax_stream_text
from emotts.infer.synthesize import Synthesizer as JaxSynthesizer
from emotts.nn.hifigan import HiFiGANGenerator as JaxGenerator
from emotts.utils.config import Config as JaxConfig
from emotts_torch.infer.server import _pcm16, make_server
from emotts_torch.infer.streaming import (generator_halo_frames, stream_text,
                                          vocode_streaming)
from emotts_torch.infer.synthesize import Synthesizer
from emotts_torch.nn.convert import hifigan_from_flax
from emotts_torch.nn.hifigan import HiFiGANGenerator
from emotts_torch.utils.config import Config
from tests.torch_port_util import (SMALL_VOCODER, fs2_variables, shrink,
                                   single_torch_thread,  # noqa: F401
                                   vocoder_params)

VOCODER = dict(SMALL_VOCODER, in_channels=80, upsample_rates=(8, 8, 2, 2),
               upsample_kernel_sizes=(16, 16, 4, 4))
# Both sides compute in fp32 and differ by summation order (~1e-5 on a
# waveform in (-1, 1)), under one step of 32767; truncation to int16 can
# turn that into one whole step.
PCM_STEPS = 1


@pytest.fixture(scope="module")
def pair():
    """The JAX package's Synthesizer and the port's over the same weights
    (unfused attention, the plain generator: XLA's compilation of the
    interpret-mode kernels is not what this file tests)."""
    jcfg = shrink(JaxConfig(), fused=False)
    _, variables = fs2_variables(jcfg, seed=31)
    _, voc_tree = vocoder_params(VOCODER, seed=32, scale=0.05)
    bank = np.random.default_rng(33).standard_normal((3, 3, 3, 3)).astype(np.float32)
    jsynth = JaxSynthesizer(jcfg, variables, voc_tree, bank, vocoder_structure=VOCODER)
    tsynth = Synthesizer(shrink(Config(), fused=False), variables, voc_tree, bank,
                         vocoder_structure=VOCODER, device="cpu")
    return jsynth, tsynth


def _pcm(wav):
    return np.round(np.asarray(wav, np.float64) * 32767.0).astype(np.int64)


@pytest.mark.parametrize("structure", [
    {},  # HiFi-GAN V1
    dict(upsample_rates=(8, 8, 4), upsample_kernel_sizes=(16, 16, 8),
         resblock_kernel_sizes=(3, 5, 7),
         resblock_dilations=((1, 2), (2, 6), (3, 12))),  # V3
    dict(VOCODER),
])
def test_generator_halo_frames_matches_jax(structure):
    structure = dict(structure, upsample_initial_channel=16)
    got = generator_halo_frames(HiFiGANGenerator(**structure))
    assert got == jax_halo_frames(JaxGenerator(**structure))
    if len(structure) == 1:
        assert got == 17


def _int16_vocoder(flags):
    gen = HiFiGANGenerator(**SMALL_VOCODER, **flags)
    _, tree = vocoder_params(seed=34, scale=0.1)
    gen.load_state_dict(hifigan_from_flax(tree))

    @torch.inference_mode()
    def voc_fn(mel):
        return torch.clamp(gen(mel) * 32767.0, -32768.0, 32767.0).to(torch.int16)

    return gen, voc_fn


@pytest.mark.parametrize("flags", [{}, dict(fused_mrf=True, use_pallas_resblocks=True)],
                         ids=["plain", "kernel-wrappers"])
def test_vocode_streaming_equals_unchunked_bit_for_bit(flags):
    gen, voc_fn = _int16_vocoder(flags)
    hop = int(np.prod(gen.upsample_rates))
    halo = generator_halo_frames(gen)
    mel = torch.from_numpy(
        np.random.default_rng(35).standard_normal((2, 75, 8)).astype(np.float32))
    full = voc_fn(mel).numpy()
    for chunk in (24, 16):  # the second leaves a short last chunk
        chunks = list(vocode_streaming(voc_fn, mel, hop, chunk_frames=chunk,
                                       halo_frames=halo))
        assert [c.shape[1] for c in chunks][-1] == (75 - 75 // chunk * chunk or chunk) * hop
        np.testing.assert_array_equal(np.concatenate(chunks, axis=1), full)
    with pytest.raises(ValueError):
        next(vocode_streaming(voc_fn, mel, hop, chunk_frames=0))


def _content_wave(synth, text):
    ids = synth.text_to_phoneme_ids(text)
    inten = synth.intensity_for(1, 2, 1, len(ids))[None]
    mel, lens = synth.synthesize_mels(ids, np.array([1], np.int32), inten)
    n = int(lens[0])
    pcm = synth.vocode(mel[:, :n])
    return np.asarray(pcm)[0].astype(np.float32) / 32767.0, n


def test_stream_text_equals_content_vocode_on_both_first_chunk_paths(pair):
    """Long sentence: the first window is vocoded right behind the FS2
    forward and serves chunk 0; short sentence (content < window): the
    content-trimmed mel is vocoded again.  Both equal unchunked vocoding of
    the content-trimmed mel, bit for bit."""
    _, synth = pair
    calls = []
    real = synth.synthesize_first_chunk
    synth.synthesize_first_chunk = lambda *a, **k: calls.append(k["window"]) or real(*a, **k)
    try:
        for text, chunk in (("The fox ran over the hill and far away.", 4),
                            ("Go.", 40)):
            ref, n = _content_wave(synth, text)
            halo = generator_halo_frames(synth.vocoder)
            assert (n >= chunk + halo) == (chunk == 4), "the premise of each path"
            streamed = np.concatenate(list(stream_text(
                synth, text, speaker_id=1, emotion_id=2, level=1, chunk_frames=chunk)))
            np.testing.assert_array_equal(streamed, ref)
        assert calls == [4 + halo, 40 + halo]
    finally:
        synth.synthesize_first_chunk = real


def test_stream_matches_jax_stream_text(pair):
    jsynth, tsynth = pair
    text = "How are you today?"
    kw = dict(speaker_id=2, emotion_id=1, level=1.5, pace=1.1, chunk_frames=32)
    want = list(jax_stream_text(jsynth, text, **kw))
    got = list(stream_text(tsynth, text, **kw))
    assert [c.shape for c in got] == [c.shape for c in want]  # lengths agree
    assert len(got) >= 2  # the first window's chunk, then the chunks after it
    a, b = _pcm(np.concatenate(want)), _pcm(np.concatenate(got))
    assert np.abs(a).max() > 300  # a signal to compare
    assert np.abs(a - b).max() <= PCM_STEPS


def test_streamed_http_body_is_pcm16_of_the_chunks(pair):
    _, synth = pair
    req = {"text": "One sentence. And another one.", "speaker": "b",
           "emotion": "angry", "level": 2, "stream": True}
    want = b"".join(_pcm16(c) for c in stream_text(synth, req["text"], 1, 2, level=2))
    httpd = make_server(synth.cfg, synth, port=0, device="cpu")
    thread = threading.Thread(target=httpd.serve_forever, daemon=True)
    thread.start()
    try:
        request = urllib.request.Request(
            f"http://127.0.0.1:{httpd.server_address[1]}/synthesize",
            data=json.dumps(req).encode(), headers={"Content-Type": "application/json"})
        with urllib.request.urlopen(request, timeout=120) as r:
            assert r.status == 200
            assert r.headers["Content-Type"] == "audio/L16"
            assert r.headers["Transfer-Encoding"] == "chunked"
            assert r.headers["X-Sample-Rate"] == str(synth.cfg.audio.sampling_rate)
            body = r.read()  # urllib undoes the chunked transfer coding
    finally:
        httpd.shutdown()
        httpd.server_close()
        thread.join(timeout=10)
    assert not thread.is_alive()
    assert body == want and len(body) > 4000
    # _pcm16 clips, scales and truncates toward zero as the reference does
    y = np.array([-2.0, -1.0, -0.5, 0.00005, 0.49999, 1.0, 3.0], np.float32)
    assert np.frombuffer(_pcm16(y), "<i2").tolist() == [-32767, -32767, -16383, 1,
                                                        16383, 32767, 32767]
