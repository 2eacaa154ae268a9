"""The port's HTTP front end (emotts_torch/infer/server.py) over tiny models
on the CPU: the service object directly, and one real socket."""

import base64
import io
import json
import threading
import urllib.error
import urllib.request
import wave

import numpy as np
import pytest
import torch

from emotts_torch.infer.server import TTSRequestError, TTSService, make_server
from emotts_torch.infer.synthesize import Synthesizer, build_fastspeech2
from emotts_torch.nn.hifigan import HiFiGANGenerator
from emotts_torch.nn.init import seeded_init_
from emotts_torch.utils.config import Config
from tests.torch_port_util import (  # noqa: F401
    shrink, single_torch_thread)

VOCODER = dict(
    in_channels=80, upsample_initial_channel=64, upsample_rates=(8, 8, 2, 2),
    upsample_kernel_sizes=(16, 16, 4, 4), resblock_kernel_sizes=(3,),
    resblock_dilations=((1, 3),), fused_mrf=True, use_pallas_resblocks=True,
)


@pytest.fixture(scope="module")
def stack():
    cfg = shrink(Config())
    gen = torch.Generator().manual_seed(0)
    fs2 = seeded_init_(build_fastspeech2(cfg), gen)
    with torch.no_grad():  # a few frames per phone instead of none
        fs2.duration_predictor.out.bias.fill_(float(np.log1p(4.0)))
    voc = seeded_init_(HiFiGANGenerator(**VOCODER), gen, gain=0.5)
    bank = np.random.default_rng(0).standard_normal((3, 3, 3, 3)).astype(np.float32)
    synth = Synthesizer(cfg, fs2.state_dict(), voc.state_dict(), bank,
                        vocoder_structure=VOCODER, device="cpu")
    return cfg, synth


@pytest.fixture(scope="module")
def served(stack):
    cfg, synth = stack
    httpd = make_server(cfg, synth, port=0, device="cpu")
    thread = threading.Thread(target=httpd.serve_forever, daemon=True)
    thread.start()
    yield cfg, f"http://127.0.0.1:{httpd.server_address[1]}"
    httpd.shutdown()
    httpd.server_close()
    thread.join(timeout=10)
    assert not thread.is_alive()


def _post(base, path, obj):
    req = urllib.request.Request(
        base + path, data=json.dumps(obj).encode(),
        headers={"Content-Type": "application/json"},
    )
    return urllib.request.urlopen(req, timeout=120)


def _wav_samples(data: bytes):
    with wave.open(io.BytesIO(data), "rb") as w:
        assert w.getnchannels() == 1 and w.getsampwidth() == 2
        return np.frombuffer(w.readframes(w.getnframes()), "<i2"), w.getframerate()


def test_service_synthesize_and_name_resolution(stack):
    cfg, synth = stack
    svc = TTSService(cfg, synth, microbatch_window_ms=-1, device="cpu")
    a = svc.synthesize({"text": "Same words.", "speaker": "b", "emotion": 2})
    b = svc.synthesize({"text": "Same words.", "speaker": 1, "emotion": "angry"})
    assert a.dtype == np.float32 and a.size > 1000 and np.isfinite(a).all()
    np.testing.assert_array_equal(a, b)
    mixed = svc.synthesize({"text": "Same words.", "speaker": "b",
                            "emotion_mix": {"amused": 0.5, "angry": 0.5},
                            "level": 2})
    # other conditioning: other durations, or at least another waveform
    assert mixed.size > 1000 and not np.array_equal(mixed, a)
    ssml = svc.synthesize({"ssml": "<speak>Hi. <break time='50ms'/>There.</speak>"})
    assert ssml.size > 1000


def test_service_batch_equals_single_requests(stack):
    cfg, synth = stack
    svc = TTSService(cfg, synth, device="cpu")  # micro-batcher on
    reqs = [{"text": "One short line.", "speaker": "a", "emotion": "amused", "level": 1},
            {"text": "Another. And one more.", "speaker": "c", "emotion": "neutral"}]
    wavs = svc.batch(reqs)
    assert len(wavs) == 2
    for req, wav in zip(reqs, wavs):
        np.testing.assert_allclose(svc.synthesize(req), wav, atol=2e-4)


@pytest.mark.parametrize("bad", [
    {"speaker": "a", "emotion": "amused"},  # no text
    {"text": "x", "speaker": "nope", "emotion": 0},  # unknown speaker
    {"text": "x", "speaker": 0, "emotion": 99},  # emotion out of range
    {"ssml": "<speak>x</speak>", "speaker_mix": {"a": 1.0}},  # ssml + mix
])
def test_service_rejects_bad_requests(stack, bad):
    cfg, synth = stack
    svc = TTSService(cfg, synth, microbatch_window_ms=-1, device="cpu")
    with pytest.raises(TTSRequestError):
        svc.synthesize(bad)
    with pytest.raises(TTSRequestError):
        svc.batch([])


def test_service_states_its_device(stack):
    cfg, synth = stack
    if torch.cuda.is_available():
        pytest.skip("this check is for machines without a GPU")
    with pytest.raises(RuntimeError, match="GPU"):
        TTSService(cfg, synth)  # "cuda" is the default and there is no card


def test_http_health_synthesize_batch(served):
    cfg, base = served
    with urllib.request.urlopen(base + "/health", timeout=30) as r:
        info = json.loads(r.read())
    assert info["status"] == "ok" and info["vocoder"] is True
    assert info["speakers"] == ["a", "b", "c"]
    with _post(base, "/synthesize", {"text": "Hello there.", "speaker": "a",
                                     "emotion": "amused", "level": 1}) as r:
        assert r.headers["Content-Type"] == "audio/wav"
        pcm, sr = _wav_samples(r.read())
    assert sr == cfg.audio.sampling_rate and len(pcm) > sr // 10
    with _post(base, "/batch", {"requests": [
        {"text": "First.", "speaker": 0, "emotion": 0},
        {"text": "Second one.", "speaker": 1, "emotion": 1, "level": 2},
    ]}) as r:
        body = json.loads(r.read())
    assert len(body["wavs_b64"]) == 2
    for blob in body["wavs_b64"]:
        assert len(_wav_samples(base64.b64decode(blob))[0]) > 500


def test_http_errors_and_streaming_refusal(served):
    """Bad requests are refused with 400, streamed ones too: every check of a
    streamed request runs before its chunked 200 starts.  A valid streamed
    request is answered with chunked audio/L16."""
    cfg, base = served
    with pytest.raises(urllib.error.HTTPError) as e:
        _post(base, "/synthesize", {"text": "x", "speaker": "nope", "emotion": 0})
    assert e.value.code == 400 and "error" in json.loads(e.value.read())
    for bad in ({"speaker": 0, "emotion": "nope"},
                {"speaker": 0, "emotion": 0, "speaker_mix": {"a": 1.0}},
                {"speaker": 0, "emotion": 0, "ssml": "<speak>Hi.</speak>"},
                {"speaker": 0, "emotion": 0, "text": ""}):
        with pytest.raises(urllib.error.HTTPError) as e:
            _post(base, "/synthesize", {"text": "Hello.", "stream": True, **bad})
        assert e.value.code == 400 and "error" in json.loads(e.value.read())
    with _post(base, "/synthesize", {"text": "Hello there.", "speaker": 0,
                                     "emotion": 0, "stream": True}) as r:
        assert r.status == 200 and r.headers["Content-Type"] == "audio/L16"
        assert r.headers["X-Sample-Rate"] == str(cfg.audio.sampling_rate)
        pcm = np.frombuffer(r.read(), "<i2")
    assert pcm.size > 0 and pcm.size % cfg.audio.hop_length == 0
    with pytest.raises(urllib.error.HTTPError) as e:
        _post(base, "/nowhere", {"text": "x"})
    assert e.value.code == 404
