"""The port's audio front end (emotts_torch/audio/) held against the JAX
package's on the same numpy inputs: the numpy modules (wavio, normalize,
textgrid, f0) and the native bindings equal bit for bit, the tensor mel
path (mel_energy, mel_full) on the CPU against jax.jit(mel_energy_jax /
mel_full_jax) at 2e-5 (log-mel: 2e-5 absolute plus 2e-5 relative, as the
two fp32 DFT products sum in different orders and a low-energy bin's
rounding grows in log space) and against the numpy golden mel_energy_np
at the JAX package's own tolerances (tests/test_audio_mel.py: exp(mel)
rtol 5e-3 atol 5e-4, energy 1e-3)."""

import numpy as np
import pytest
import torch

import emotts.audio as ja
from emotts.audio import native as jnative
from emotts.utils.config import AudioConfig as JaxAudioConfig
from emotts_torch import audio as ta
from emotts_torch.audio import native as tnative
from emotts_torch.utils.config import AudioConfig
from tests.torch_port_util import jit, single_torch_thread  # noqa: F401

SR, HOP = 16000, 256


def _voiced(secs, f0=150.0, seed=0, sr=SR):
    """A harmonic signal with a moving F0 plus noise, and a silent gap."""
    rng = np.random.default_rng(seed)
    t = np.arange(int(secs * sr)) / sr
    phase = 2 * np.pi * np.cumsum(f0 * (1.0 + 0.15 * np.sin(2 * np.pi * 1.5 * t))) / sr
    y = 0.4 * np.sin(phase) + 0.2 * np.sin(2 * phase) + 0.1 * np.sin(3 * phase)
    y[len(y) // 2: len(y) // 2 + sr // 10] = 0.0
    return (y + 0.005 * rng.standard_normal(len(t))).astype(np.float32)


# ---------------------------------------------------------------------------
# numpy modules: exact
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", ["int16", "float32"])
def test_wavio_matches_jax(tmp_path, dtype):
    y = _voiced(0.3, seed=1)
    path = str(tmp_path / "x.wav")
    if dtype == "int16":
        ta.write_wav(path, y, 22050)
    else:  # float WAVs (and stereo) arrive from other tools
        from scipy.io import wavfile

        wavfile.write(path, 22050, np.stack([y, -0.5 * y], axis=1))
    got, want = ta.read_wav(path), ja.read_wav(path)
    assert got[1] == want[1] == 22050
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(ta.load_wav(path, SR), ja.load_wav(path, SR))
    np.testing.assert_array_equal(ta.resample(got[0], 22050, 16000),
                                  ja.resample(got[0], 22050, 16000))
    np.testing.assert_array_equal(ta.resample(y, SR, SR), ja.resample(y, SR, SR))
    np.testing.assert_array_equal(ta.trim_audio(y, 0.0123, 0.2, SR),
                                  ja.trim_audio(y, 0.0123, 0.2, SR))


def test_normalize_matches_jax():
    rng = np.random.default_rng(2)
    chunks = [rng.standard_normal(n) * 3 + 1 for n in (50, 1, 0, 200)]
    chunks[-1][:5] = 40.0  # outliers for the IQR rule
    got, want = ta.RunningStats(), ja.RunningStats()
    for c in chunks:
        got.update(ta.remove_outliers(c) if len(c) > 1 else c)
        want.update(ja.remove_outliers(c) if len(c) > 1 else c)
    assert (got.n, got.mean, got.m2, got.std) == (want.n, want.mean, want.m2, want.std)
    assert ta.RunningStats().std == ja.RunningStats().std == 1.0
    np.testing.assert_array_equal(ta.remove_outliers(chunks[-1]),
                                  ja.remove_outliers(chunks[-1]))


def test_textgrid_matches_jax(tmp_path):
    ivs = [(0.0, 0.1, ""), (0.1, 0.23, "HH"), (0.23, 0.4, "AH0"),
           (0.4, 0.41, "sp"), (0.41, 0.6, "L"), (0.6, 0.75, "sil")]
    tpath, jpath = str(tmp_path / "t.TextGrid"), str(tmp_path / "j.TextGrid")
    ta.write_textgrid(tpath, [ta.Interval(*iv) for iv in ivs], 0.75)
    ja.write_textgrid(jpath, [ja.Interval(*iv) for iv in ivs], 0.75)
    assert open(tpath).read() == open(jpath).read()
    got, want = ta.parse_textgrid(tpath), ja.parse_textgrid(tpath)
    assert [(t.name, [(i.start, i.end, i.text) for i in t.intervals]) for t in got] \
        == [(t.name, [(i.start, i.end, i.text) for i in t.intervals]) for t in want]
    sil = ["sil", "sp", "spn", ""]
    g, w = ta.process_textgrid(tpath, SR, HOP, sil), ja.process_textgrid(tpath, SR, HOP, sil)
    assert g[0] == w[0] and g[2:] == w[2:]
    np.testing.assert_array_equal(g[1], w[1])
    from emotts_torch.audio.textgrid import get_tier

    assert get_tier(got, "phones").name == "phones"
    with pytest.raises(KeyError):
        get_tier(got, "words")


@pytest.fixture(scope="module")
def voiced():
    return _voiced(0.9, seed=3).astype(np.float64)


def test_f0_matches_jax(voiced):
    f0, times = ta.dio(voiced, SR, frame_period=HOP / SR * 1000.0)
    jf0, jtimes = ja.dio(voiced, SR, frame_period=HOP / SR * 1000.0)
    np.testing.assert_array_equal(f0, jf0)
    np.testing.assert_array_equal(times, jtimes)
    refined = ta.stonemask(voiced, f0, times, SR)
    np.testing.assert_array_equal(refined, ja.stonemask(voiced, f0, times, SR))
    np.testing.assert_array_equal(ta.extract_f0(voiced, HOP, SR), refined)
    assert 10 < np.count_nonzero(refined) < len(refined)  # voiced and unvoiced frames
    np.testing.assert_array_equal(ta.interpolate_unvoiced(refined),
                                  ja.interpolate_unvoiced(refined))
    zeros = np.zeros(5)
    np.testing.assert_array_equal(ta.interpolate_unvoiced(zeros), zeros)


def test_native_bindings_match_jax(voiced, tmp_path):
    """Both packages load the same library by path, or both find none."""
    assert tnative.have_native() == jnative.have_native()
    assert tnative.have_native_dtw() == jnative.have_native_dtw()
    assert tnative._LIB_PATH == jnative._LIB_PATH
    tg = str(tmp_path / "n.TextGrid")
    ta.write_textgrid(tg, [ta.Interval(0.0, 0.2, "HH"), ta.Interval(0.2, 0.5, "")], 0.5)
    cost = np.random.default_rng(4).uniform(0.0, 1.0, (7, 11))
    calls = (lambda m: m.extract_f0_native(voiced, HOP, SR),
             lambda m: m.parse_textgrid_native(tg),
             lambda m: m.dtw_path_native(cost))
    for call in calls:
        if tnative.have_native():
            got, want = call(tnative), call(jnative)
            assert type(got) is type(want)
            if isinstance(got, tuple):
                for g, w in zip(got, want):
                    np.testing.assert_array_equal(g, w)
            else:
                np.testing.assert_array_equal(np.asarray(got, dtype=object),
                                              np.asarray(want, dtype=object))
        else:
            for mod in (tnative, jnative):
                with pytest.raises(RuntimeError):
                    call(mod)


# ---------------------------------------------------------------------------
# the tensor mel path
# ---------------------------------------------------------------------------

LENGTHS = np.array([6000, 4093, 1100], np.int32)  # a full row and ragged ones


@pytest.fixture(scope="module")
def batch():
    y = np.zeros((len(LENGTHS), int(LENGTHS.max())), np.float32)
    for i, n in enumerate(LENGTHS):
        y[i, :n] = _voiced(n / SR, f0=140.0 + 40 * i, seed=10 + i)
    return y


@pytest.mark.parametrize("floor", ["hard", "soft"])
def test_mel_energy_matches_jax_and_the_numpy_golden(batch, floor):
    mel, energy, n_frames = ta.mel_energy(torch.from_numpy(batch),
                                          torch.from_numpy(LENGTHS), AudioConfig(),
                                          floor=floor)
    jmel, jenergy, jn = jit(ja.mel_energy_jax, static_argnames=("cfg", "floor"))(
        batch, LENGTHS, cfg=JaxAudioConfig(), floor=floor)
    assert mel.dtype == energy.dtype == torch.float32
    np.testing.assert_array_equal(n_frames.numpy(), np.asarray(jn))
    np.testing.assert_allclose(mel.numpy(), np.asarray(jmel), rtol=2e-5, atol=2e-5)
    np.testing.assert_allclose(energy.numpy(), np.asarray(jenergy), rtol=0, atol=2e-5)
    clip = AudioConfig().clip_val
    for i, n in enumerate(LENGTHS):
        ref_mel, ref_energy = ta.mel_energy_np(batch[i, :n], AudioConfig())
        t = ref_mel.shape[1]
        assert int(n_frames[i]) == t
        got = np.exp(mel[i, :, :t].numpy())
        if floor == "soft":  # log(mel + clip) against log(max(mel, clip))
            got, ref = got - clip, np.exp(ref_mel)
            ref = np.where(ref <= clip, got, ref)
        else:
            ref = np.exp(ref_mel)
        np.testing.assert_allclose(got, ref, rtol=5e-3, atol=5e-4)
        np.testing.assert_allclose(energy[i, :t].numpy(), ref_energy, rtol=1e-3, atol=1e-3)
        # frames past the utterance: the log floor, energy 0
        assert (mel[i, :, t:] == np.float32(np.log(clip))).all()
        assert (energy[i, t:] == 0).all()


@pytest.mark.parametrize("floor", ["hard", "soft"])
def test_mel_full_matches_jax_and_mel_energy(batch, floor):
    full = batch[:, :4096]
    got = ta.mel_full(torch.from_numpy(full), AudioConfig(), floor=floor)
    want = jit(ja.mel_full_jax, static_argnames=("cfg", "floor"))(
        full, cfg=JaxAudioConfig(), floor=floor)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-5, atol=2e-5)
    rows = ta.mel_energy(torch.from_numpy(full), torch.full((3,), 4096),
                         AudioConfig(), floor=floor)[0]
    np.testing.assert_allclose(got.numpy(), rows.numpy(), rtol=2e-5, atol=2e-5)
    with pytest.raises(ValueError):
        ta.mel_full(torch.from_numpy(full), AudioConfig(), floor="none")


def test_mel_full_soft_floor_is_differentiable():
    """The vocoder trainer's mel loss: a gradient below the clip floor."""
    y = torch.zeros(1, 2048, requires_grad=True)
    ta.mel_full(y + 1e-9 * torch.arange(2048.0), AudioConfig(), floor="soft").sum().backward()
    assert torch.isfinite(y.grad).all() and y.grad.abs().sum() > 0


def test_mel_full_is_differentiable_after_preprocessing_under_inference_mode():
    """The device constants are cached per (config, device): made first by
    preprocessing under inference_mode, they still serve the vocoder
    trainer's differentiable mel in the same process."""
    from emotts_torch.audio import mel as tmel

    cfg = AudioConfig()
    tmel._device_constants.cache_clear()
    try:
        with torch.inference_mode():
            ta.mel_energy(torch.zeros(1, 2048), torch.full((1,), 2048), cfg)
        y = torch.full((1, 2048), 0.01, requires_grad=True)
        ta.mel_full(y * torch.arange(2048.0).sin(), cfg, floor="soft").sum().backward()
    finally:
        tmel._device_constants.cache_clear()
    assert torch.isfinite(y.grad).all() and y.grad.abs().sum() > 0


def test_mel_filterbank_and_frames_equal_the_reference():
    cfg, jcfg = AudioConfig(), JaxAudioConfig()
    np.testing.assert_array_equal(
        ta.mel_filterbank(cfg.sampling_rate, cfg.n_fft, cfg.n_mels, cfg.f_min, cfg.f_max),
        ja.mel_filterbank(jcfg.sampling_rate, jcfg.n_fft, jcfg.n_mels, jcfg.f_min,
                          jcfg.f_max))
    y = _voiced(0.2, seed=5)
    np.testing.assert_array_equal(ta.stft_magnitude_np(y, cfg), ja.stft_magnitude_np(y, jcfg))
    assert ta.num_frames(5000, HOP) == ja.num_frames(5000, HOP)
