"""The port's raw-audio-to-features path held against the JAX package's on
one tiny raw corpus in EmoV-DB's layout: prepare_corpus (resampling to
16 kHz, transcripts), preprocess_all with the host mel and with the batched
tensor mel (device_mel on the CPU here), build_rank_pair_lists and
build_fs2_splits.

Tolerances: host features (F0, durations, the numpy mel) and every list are
equal bit for bit; the batched mel against the JAX package's jitted
mel_energy_jax at 2e-5 absolute plus 2e-5 relative in log space, the
min-max energy (the stored z-scored energy times each package's own std
plus its mean, from stats.json) at 5e-5 (a min-max over fp32 spectra
summed in different orders), and so the energy's mean and std in
stats.json at 5e-5 and its z-scored extremes at 1e-4 / std."""

import json
import os
import shutil
from pathlib import Path

import numpy as np
import pytest
from scipy.signal import resample_poly

from emotts.cli.prepare_corpus import prepare_corpus as jax_prepare_corpus
from emotts.data.preprocess import preprocess_all as jax_preprocess_all
from emotts.data.splits import build_fs2_splits as jax_build_fs2_splits
from emotts.data.splits import build_rank_pair_lists as jax_build_rank_pair_lists
from emotts.utils.config import save_config
from emotts_torch.audio.wavio import read_wav, write_wav
from emotts_torch.cli import prepare_corpus
from emotts_torch.data import build_fs2_splits, build_rank_pair_lists
from emotts_torch.data.preprocess import (average_by_duration, expand_by_duration,
                                          preprocess_all)
from emotts_torch.utils.config import load_config
from tests.synthetic_corpus import make_corpus
from tests.torch_port_util import single_torch_thread  # noqa: F401

RAW_SR = 22050  # EmoV-DB's wavs are not at the model's rate


@pytest.fixture(scope="module")
def raw(tmp_path_factory):
    """A raw corpus (data_path/<speaker>/<emotion>/*.wav at 22.05 kHz and
    cmuarctic.data) made from the synthetic corpus, whose TextGrids stand in
    for the external aligner's; returns (root, made Config)."""
    root = tmp_path_factory.mktemp("torch_pre")
    made = make_corpus(str(root / "made"), utts_per_emotion=2)
    data = root / "raw"
    lines = ['( arctic_b0001 "Dropped from the index." )']
    for speaker in made.data.speakers:
        for emotion in made.data.emotions:
            (data / speaker / emotion).mkdir(parents=True)
            for wav in sorted((Path(made.data.corpus_path) / speaker).glob(
                    f"{emotion}_*.wav")):
                audio_id = wav.stem.split("_")[-1]
                y, sr = read_wav(str(wav))
                up = resample_poly(y, RAW_SR // 50, sr // 50).astype(np.float32)
                write_wav(str(data / speaker / emotion / f"{emotion}_1-28_{audio_id}.wav"),
                          up, RAW_SR)
    for i in range(2):
        lines.append(f'( arctic_a{i:04d} "Hello, world number {i + 1}." )')
    (data / "cmuarctic.data").write_text("\n".join(lines) + "\n")
    return root, made


def _configs(root, made, name):
    """(JAX Config, port Config) from one YAML for the output tree ``name``."""
    from emotts.utils.config import load_config as jax_load_config

    made.data.data_path = str(root / "raw")
    made.data.corpus_path = str(root / name / "corpus")
    made.data.preprocessed_path = str(root / name / "preprocessed")
    made.data.test_utts_per_emotion = 1
    made.data.neutral_pairs_per_utt = 1
    path = str(root / f"{name}.yaml")
    save_config(made, path)
    return jax_load_config(path), load_config(path)


@pytest.fixture(scope="module")
def prepared(raw):
    """Both packages' prepare_corpus into their own trees."""
    root, made = raw
    jcfg, _ = _configs(root, made, "jax")
    _, tcfg = _configs(root, made, "torch")
    n_jax = jax_prepare_corpus(jcfg, verbose=False)
    n_torch = prepare_corpus(tcfg, verbose=False)
    return root, made, jcfg, tcfg, n_jax, n_torch


def test_prepare_corpus_matches_jax(prepared):
    root, made, jcfg, tcfg, n_jax, n_torch = prepared
    assert n_jax == n_torch == 2 * 3 * 2
    jfiles = sorted(p.relative_to(jcfg.data.corpus_path)
                    for p in Path(jcfg.data.corpus_path).rglob("*.*"))
    tfiles = sorted(p.relative_to(tcfg.data.corpus_path)
                    for p in Path(tcfg.data.corpus_path).rglob("*.*"))
    assert jfiles == tfiles and len(tfiles) == 2 * n_torch
    for rel in tfiles:
        assert (Path(tcfg.data.corpus_path) / rel).read_bytes() == \
            (Path(jcfg.data.corpus_path) / rel).read_bytes(), rel
    lab = (Path(tcfg.data.corpus_path) / "spk_a" / "amused_0001.lab").read_text()
    assert lab.strip() == "[noise] hello, world number two. [noise]"
    y, sr = read_wav(str(Path(tcfg.data.corpus_path) / "spk_a" / "amused_0001.wav"))
    assert sr == 16000
    # a second call leaves the existing corpus alone
    assert prepare_corpus(tcfg, verbose=False) == 0


def _npz_files(cfg):
    base = Path(cfg.data.preprocessed_path)
    return sorted(p.relative_to(base) for p in base.rglob("*.npz"))


@pytest.mark.parametrize("device_mel", [False, True])
def test_preprocess_splits_and_stats_match_jax(prepared, device_mel):
    root, made, jcfg, tcfg, _, _ = prepared
    for cfg in (jcfg, tcfg):
        cfg.data.textgrid_path = made.data.textgrid_path
        shutil.rmtree(cfg.data.preprocessed_path, ignore_errors=True)
    jax_counts = jax_preprocess_all(jcfg, verbose=False, device_mel=device_mel)
    counts = preprocess_all(tcfg, verbose=False, device_mel=device_mel, device="cpu")
    assert counts == jax_counts and sum(counts.values()) == 12
    files = _npz_files(tcfg)
    assert files == _npz_files(jcfg) and len(files) == 12
    jbase, tbase = Path(jcfg.data.preprocessed_path), Path(tcfg.data.preprocessed_path)
    got_stats = json.loads((tbase / "stats.json").read_text())
    want_stats = json.loads((jbase / "stats.json").read_text())

    def min_max_energy(npz, stats):
        _, _, mean, std = stats[str(npz["speaker"])][str(npz["emotion"])]["energy"]
        return npz["energy"] * std + mean

    for rel in files:
        got, want = np.load(tbase / rel), np.load(jbase / rel)
        assert sorted(got.files) == sorted(want.files)
        for key in got.files:
            g, w = got[key], want[key]
            if key in ("audio_path",):  # each package's own corpus tree
                assert str(g).replace(str(tcfg.data.corpus_path), "") == \
                    str(w).replace(str(jcfg.data.corpus_path), "")
            elif device_mel and key == "mel":
                np.testing.assert_allclose(g, w, rtol=2e-5, atol=2e-5)
            elif device_mel and key == "energy":
                np.testing.assert_allclose(min_max_energy(got, got_stats),
                                           min_max_energy(want, want_stats),
                                           rtol=0, atol=5e-5)
            else:
                np.testing.assert_array_equal(g, w, err_msg=f"{rel}:{key}")
        assert got["mel"].shape == (80, int(got["durations"].sum()))
    got, want = got_stats, want_stats
    assert got.keys() == want.keys()
    for spk in got:
        for emo in got[spk]:
            assert got[spk][emo]["pitch"] == want[spk][emo]["pitch"]
            g, w = np.array(got[spk][emo]["energy"]), np.array(want[spk][emo]["energy"])
            if device_mel:  # [min, max] are z-scores: an error grows by 1/std
                np.testing.assert_allclose(g[2:], w[2:], rtol=0, atol=5e-5)
                np.testing.assert_allclose(g[:2], w[:2], rtol=0, atol=1e-4 / w[3])
            else:
                np.testing.assert_array_equal(g, w)

    train, test = build_rank_pair_lists(tcfg)
    jtrain, jtest = jax_build_rank_pair_lists(jcfg)
    assert (train, test) == (jtrain, jtest) and train and test
    assert (tbase / "train.txt").read_text() == (jbase / "train.txt").read_text()
    fs2 = build_fs2_splits(tcfg)
    jfs2 = jax_build_fs2_splits(jcfg)
    for got_list, want_list in zip(fs2, jfs2):
        assert [os.path.relpath(p, tbase) for p in got_list] == \
            [os.path.relpath(p, jbase) for p in want_list]


def test_match_transcript_pairs_equal_ids(prepared):
    _, _, jcfg, tcfg, _, _ = prepared
    for cfg in (jcfg, tcfg):
        cfg.data.match_transcript = True
    try:
        if not _npz_files(tcfg):
            preprocess_all(tcfg, verbose=False, device_mel=False)
            jax_preprocess_all(jcfg, verbose=False)
        got, want = build_rank_pair_lists(tcfg), jax_build_rank_pair_lists(jcfg)
    finally:
        for cfg in (jcfg, tcfg):
            cfg.data.match_transcript = False
    assert got == want and got[0]
    assert all(line.split("|")[2] == line.split("|")[3] for line in got[0] + got[1])


def test_duration_helpers_match_jax():
    from emotts.data.preprocess import average_by_duration as jax_avg
    from emotts.data.preprocess import expand_by_duration as jax_expand

    values = np.random.default_rng(0).standard_normal(20).astype(np.float32)
    durations = np.array([3, 0, 5, -1, 4, 9])  # a phone of none, one past the end
    np.testing.assert_array_equal(average_by_duration(values, durations),
                                  jax_avg(values, durations))
    np.testing.assert_array_equal(expand_by_duration(values[:6], durations),
                                  jax_expand(values[:6], durations))


def test_device_mel_on_a_missing_gpu_raises(prepared, monkeypatch):
    """device_mel on 'cuda' without a GPU never computes on the host."""
    import torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    _, _, _, tcfg, _, _ = prepared
    with pytest.raises(RuntimeError, match="needs a GPU"):
        preprocess_all(tcfg, verbose=False, device_mel=True)
    tcfg.data.device_mel = True
    try:
        with pytest.raises(RuntimeError, match="needs a GPU"):
            preprocess_all(tcfg, verbose=False)
    finally:
        tcfg.data.device_mel = False
