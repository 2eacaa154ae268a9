"""The port's evaluation (emotts_torch/eval/) held against the JAX package's
on the CPU, at toy width, on the synthetic corpus preprocessed by the port:
the metrics on the same matrices (exact: the same numpy), RankScorer
(fp32, rows within 1e-5), Evaluator.run's per-utterance rows under both
conditionings with a small vocoder, and the intensity-efficacy report
(IntensityEfficacyEvaluator._metrics exact, run / evaluate_intensity_
efficacy's scores within 1e-4).

The JAX side runs XLA's attention in place of its interpret-mode kernel
(the JAX package's own tests hold the two equal) and is built without
Orbax experiments: its Evaluator reads the same numpy trees the port's
best/ exports were made from.  Per-utterance tolerances: MCD and duration
errors at 1e-4 relative (two fp32 forwards through different libraries);
F0 rows at 1e-3 relative, the V/UV rate exact (DIO on two waveforms that
differ at the rounding level)."""

import copy
import json
import os

import numpy as np
import pytest

import emotts.eval.evaluate as jev
import emotts.eval.intensity_eval as jie
import emotts.eval.metrics as jmetrics
import emotts_torch.eval.evaluate as tev
import emotts_torch.eval.intensity_eval as tie
import emotts_torch.eval.metrics as tmetrics
from emotts.utils.config import save_config
from emotts_torch.data import build_fs2_splits, build_rank_pair_lists
from emotts_torch.data.preprocess import preprocess_all
from emotts_torch.nn.convert import fs2_from_flax, rank_from_flax
from emotts_torch.train.checkpoint import CheckpointManager
from emotts_torch.utils.config import load_config
from tests.synthetic_corpus import make_corpus
from tests.torch_port_util import (SMALL_VOCODER, fs2_variables, rank_variables,
                                   single_torch_thread,  # noqa: F401
                                   vocoder_params)

VOCODER = dict(SMALL_VOCODER, in_channels=80, upsample_rates=(8, 8, 2, 2),
               upsample_kernel_sizes=(16, 16, 4, 4))
TEXT = "The cat sat."


def _small(cfg):
    """Toy widths on a Config of either package."""
    rm = cfg.rank_model
    rm.n_encoder_layers, rm.hidden_dim, rm.ffn_mult, rm.kernel_size = 1, 32, 2, 3
    rm.fused_attention = False
    f = cfg.fastspeech2
    f.enc_num_layers = f.dec_num_layers = 1
    f.enc_d_model = f.dec_d_model = 32
    f.enc_ffn_dim = f.dec_ffn_dim = 64
    f.postnet_embedding_dim = 32
    f.postnet_n_convolutions = 3
    f.max_mel_len = 96
    f.fused_attention = False
    cfg.train_fs2.compute_dtype = cfg.train_rank.compute_dtype = "float32"
    cfg.inference.neural_g2p = False
    return cfg


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    """(JAX Config, port Config, numpy weights, experiment dirs): the corpus
    preprocessed and split by the port; FastSpeech2, rank model, bank and
    vocoder from numpy seeds, exported for the port as its trainers do."""
    root = tmp_path_factory.mktemp("torch_eval")
    jcfg = _small(make_corpus(str(root), utts_per_emotion=4))
    jcfg.data.test_utts_per_emotion = 1
    path = str(root / "cfg.yaml")
    save_config(jcfg, path)
    tcfg = load_config(path)
    tcfg.fastspeech2.fused_attention = tcfg.rank_model.fused_attention = True
    preprocess_all(tcfg, verbose=False, device_mel=False)
    build_fs2_splits(tcfg)
    build_rank_pair_lists(tcfg)

    _, fs2_vars = fs2_variables(jcfg, seed=41)
    _, rank_vars = rank_variables(seed=42, n_mels=80, n_layers=1, hidden_dim=32,
                                  ffn_mult=2, kernel_size=3)
    _, voc = vocoder_params(VOCODER, seed=43, scale=0.1)
    bank = np.random.default_rng(44).standard_normal((2, 3, 3, 3)).astype(np.float32)
    fs2_exp, rank_exp = str(root / "fs2_exp"), str(root / "rank_exp")
    CheckpointManager(fs2_exp).save_best(fs2_from_flax(fs2_vars))
    CheckpointManager(rank_exp).save_best(rank_from_flax(rank_vars))
    np.save(os.path.join(rank_exp, "intensity.npy"), bank)
    flat = {}

    def walk(node, prefix):
        for k, v in node.items():
            if isinstance(v, dict):
                walk(v, prefix + k + "/")
            else:
                flat[prefix + k] = v

    walk(voc["params"], "")
    np.savez(os.path.join(root, "voc.npz"), **flat)
    for cfg in (jcfg, tcfg):
        cfg.inference.vocoder_checkpoint = os.path.join(root, "voc.npz")
    return dict(jcfg=jcfg, tcfg=tcfg, fs2=fs2_vars, rank=rank_vars, voc=voc,
                bank=bank, fs2_exp=fs2_exp, rank_exp=rank_exp, root=root)


# ---------------------------------------------------------------------------
# metrics: the same numpy
# ---------------------------------------------------------------------------


def test_metrics_match_jax(monkeypatch):
    rng = np.random.default_rng(0)
    ref, syn = rng.standard_normal((37, 20)), rng.standard_normal((29, 20))
    np.testing.assert_array_equal(tmetrics.mel_cepstra(ref), jmetrics.mel_cepstra(ref))
    ceps = tmetrics.mel_cepstra(ref)
    assert tmetrics.mcd(ceps, ceps[::-1]) == jmetrics.mcd(ceps, ceps[::-1])
    cost = rng.uniform(0.0, 1.0, (37, 29))
    acc = tmetrics._dtw_accumulate(cost)
    np.testing.assert_array_equal(acc, jmetrics._dtw_accumulate(cost))
    for a, b in zip(tmetrics._dtw_backtrack(acc, 37, 29),
                    jmetrics._dtw_backtrack(acc, 37, 29)):
        np.testing.assert_array_equal(a, b)
    for a, b in zip(tmetrics.dtw_path(cost), jmetrics.dtw_path(cost)):
        np.testing.assert_array_equal(a, b)
    got, want = tmetrics.dtw_alignment(ref, syn), jmetrics.dtw_alignment(ref, syn)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)
    assert tmetrics.mcd_dtw(ref, syn) == jmetrics.mcd_dtw(ref, syn) == got[2]
    f0a = np.where(rng.uniform(size=50) > 0.3, rng.uniform(80, 300, 50), 0.0)
    f0b = np.where(rng.uniform(size=45) > 0.3, rng.uniform(80, 300, 45), 0.0)
    assert tmetrics.f0_metrics(f0a, f0b) == jmetrics.f0_metrics(f0a, f0b)
    assert tmetrics.f0_metrics(f0a, np.zeros(3)) == jmetrics.f0_metrics(f0a, np.zeros(3))
    dur = rng.integers(0, 9, 12).astype(np.float32)
    logd = rng.normal(1.0, 1.0, 12).astype(np.float32)
    valid = (np.arange(12) < 9).astype(np.float32)
    assert tmetrics.duration_metrics(dur, logd, valid) == \
        jmetrics.duration_metrics(dur, logd, valid)
    # the numpy DTW where the native library is absent
    from emotts_torch.audio import native

    monkeypatch.setattr(native, "have_native_dtw", lambda: False)
    for a, b in zip(tmetrics.dtw_path(cost), jmetrics.dtw_path(cost)):
        np.testing.assert_array_equal(a, b)


def test_aggregate_and_bootstrap_match_jax():
    rng = np.random.default_rng(1)
    rows = [dict(speaker="a", emotion=["neutral", "amused"][i % 2],
                 mcd_teacher_forced=float(rng.uniform(5, 9)),
                 **({"f0_rmse_hz": float(rng.uniform(0, 30))} if i % 3 else {}))
            for i in range(9)]
    assert tev.aggregate(rows) == jev.aggregate(rows)
    assert tev.bootstrap_ci(rows, 50, 3) == jev.bootstrap_ci(rows, 50, 3)
    assert tev.aggregate([]) == jev.aggregate([])


# ---------------------------------------------------------------------------
# the scorer and the intensity-efficacy metrics
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def scorers(setup):
    jscorer = jie.RankScorer(setup["jcfg"], setup["rank"])
    tscorer = tie.RankScorer(setup["tcfg"], rank_from_flax(setup["rank"]), device="cpu")
    return jscorer, tscorer


def test_rank_scorer_matches_jax(scorers):
    jscorer, tscorer = scorers
    rng = np.random.default_rng(2)
    lengths = [10, 70, 64, 200, 33, 5, 90, 120, 128, 11]  # 200 > the largest bucket
    xs = [rng.standard_normal((n, 82)).astype(np.float32) for n in lengths]
    emos = [int(e) for e in rng.integers(0, 3, len(xs))]
    got, want = tscorer.score_rows(xs, emos), jscorer.score_rows(xs, emos)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and g.shape == w.shape
        np.testing.assert_allclose(g, w, rtol=1e-5, atol=1e-5)
    assert np.unique(got[0]).size == len(xs)  # rows are scored, not padding


def test_rank_strength_correlation_matches_jax(setup, scorers, monkeypatch):
    """Spearman of the frozen scorer's λ≡1 scores against known strengths,
    per (speaker, emotion), over the train pairs' emotional utterances (the
    JAX side reuses the fixture's compiled scorer)."""
    jscorer, _ = scorers
    monkeypatch.setattr(jie, "RankScorer", lambda cfg, params: jscorer)
    rng = np.random.default_rng(5)
    strengths = {f"{s}/{e}_{i:04d}": float(rng.uniform())
                 for s in setup["jcfg"].data.speakers
                 for e in setup["jcfg"].data.emotions[1:] for i in range(4)}
    got = tie.rank_strength_correlation(setup["tcfg"], rank_from_flax(setup["rank"]),
                                        strengths, device="cpu")
    want = jie.rank_strength_correlation(setup["jcfg"], setup["rank"], strengths)
    assert got["n_utts"] == want["n_utts"] > 0
    assert got["by_cell"].keys() == want["by_cell"].keys() and got["by_cell"]
    for key in got["by_cell"]:  # ranks of scores equal within 1e-5: equal ρ
        assert got["by_cell"][key] == want["by_cell"][key]
    assert got["mean_spearman"] == want["mean_spearman"]


def test_rank_pair_lists_match_jax(setup, tmp_path):
    """The pair lists the setup wrote, against the JAX package's over the
    same features (both with and without transcript matching)."""
    from emotts.data.splits import build_rank_pair_lists as jax_build_rank_pair_lists

    jcfg, tcfg = copy.deepcopy(setup["jcfg"]), copy.deepcopy(setup["tcfg"])
    base = tcfg.data.preprocessed_path
    for match in (False, True):
        for cfg in (jcfg, tcfg):
            cfg.data.match_transcript = match
            cfg.data.preprocessed_path = str(tmp_path / type(cfg).__module__)
            os.makedirs(cfg.data.preprocessed_path, exist_ok=True)
            for speaker in cfg.data.speakers:
                link = os.path.join(cfg.data.preprocessed_path, speaker)
                if not os.path.exists(link):
                    os.symlink(os.path.join(base, speaker), link)
        got, want = build_rank_pair_lists(tcfg), jax_build_rank_pair_lists(jcfg)
        assert got == want and got[0] and got[1]
    assert open(os.path.join(base, "train.txt")).read().splitlines() == \
        jax_build_rank_pair_lists(setup["jcfg"])[0]


def _bare(module, cfg):
    ev = object.__new__(module.IntensityEfficacyEvaluator)
    ev.cfg = cfg
    return ev


def test_intensity_metrics_match_jax(setup):
    rng = np.random.default_rng(3)
    rows = [dict(text_i=t, spk=s, emo=e, level=float(lv), score=float(rng.normal()))
            for t in range(2) for s in range(2) for e in range(3)
            for lv in ((0,) if e == 0 else (0, 1, 2))]
    rows = [r for r in rows if not (r["spk"] == 1 and r["emo"] == 2 and r["level"] == 1)]
    pooled = rng.standard_normal((len(rows), 3)).astype(np.float32)
    got = _bare(tie, setup["tcfg"])._metrics(rows, pooled, [0.0, 1.0, 2.0])
    want = _bare(jie, setup["jcfg"])._metrics(rows, pooled, [0.0, 1.0, 2.0])
    assert got == want
    assert got["emotion_silhouette_h"] is not None  # scikit-learn is here
    assert tie.prototype_spread(setup["bank"]) == jie.prototype_spread(setup["bank"])
    for meta in (None, {"observed": 0.1, "null_p95": 0.2}):
        assert tie.spread_verdict(tie.prototype_spread(setup["bank"]), meta) == \
            jie.spread_verdict(jie.prototype_spread(setup["bank"]), meta)
    assert tie._spearman(pooled[:, 0], pooled[:, 1]) == jie._spearman(pooled[:, 0],
                                                                      pooled[:, 1])
    assert tie.load_feature_stats(setup["tcfg"]) == jie.load_feature_stats(setup["jcfg"])


def _captured(module, cls_name, method):
    """Patch ``module.<cls_name>.<method>`` to record its arguments."""
    seen = []
    cls = getattr(module, cls_name)
    inner = getattr(cls, method)

    def spy(self, *args, **kwargs):
        seen.append(copy.deepcopy(args))
        return inner(self, *args, **kwargs)

    return seen, spy


def test_intensity_efficacy_run_matches_jax(setup, monkeypatch, tmp_path):
    """The port's evaluate_intensity_efficacy (load_synthesizer, the
    vocoded sweep, re-extraction, scoring) against the JAX package's
    IntensityEfficacyEvaluator over the same weights, row by row."""
    from emotts.infer.synthesize import Synthesizer as JaxSynthesizer

    jcfg, tcfg = setup["jcfg"], setup["tcfg"]
    jrows, jspy = _captured(jie, "IntensityEfficacyEvaluator", "_metrics")
    trows, tspy = _captured(tie, "IntensityEfficacyEvaluator", "_metrics")
    monkeypatch.setattr(jie.IntensityEfficacyEvaluator, "_metrics", jspy)
    monkeypatch.setattr(tie.IntensityEfficacyEvaluator, "_metrics", tspy)
    jsynth = JaxSynthesizer(jcfg, setup["fs2"], setup["voc"], setup["bank"])
    want = jie.IntensityEfficacyEvaluator(
        jcfg, jsynth, setup["rank"], jie.load_feature_stats(jcfg)).run(texts=[TEXT])
    out = str(tmp_path / "intensity_eval.json")
    got = tie.evaluate_intensity_efficacy(tcfg, setup["fs2_exp"], setup["rank_exp"],
                                          texts=[TEXT], out_path=out, device="cpu")
    assert json.load(open(out))["n_synthesized"] == got["n_synthesized"]
    (grows, gpooled, glevels), = trows
    (wrows, wpooled, wlevels), = jrows
    assert glevels == wlevels and len(grows) == len(wrows) == 2 * (1 + 2 * 3)
    for g, w in zip(grows, wrows):
        assert (g["text_i"], g["spk"], g["emo"], g["level"]) == \
            (w["text_i"], w["spk"], w["emo"], w["level"])
        assert g["x"].shape == w["x"].shape
        np.testing.assert_allclose(g["score"], w["score"], rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(gpooled, wpooled, rtol=1e-4, atol=1e-4)
    for key in ("n_synthesized", "n_level_cells", "monotonic_fraction_strict",
                "pairwise_order_accuracy", "monotonic_fraction_cell_mean",
                "feature_path", "verdict", "prototype_spread", "levels"):
        assert got[key] == want[key], key
    assert got["feature_path"] == "vocoded_audio"
    np.testing.assert_allclose(got["emotion_silhouette_h"], want["emotion_silhouette_h"],
                               rtol=1e-3)
    # the contrast diagnostic's conditioning, on both synthesizers' banks
    from emotts_torch.infer.synthesize import load_synthesizer

    port_ev = object.__new__(tie.IntensityEfficacyEvaluator)
    port_ev.synth = load_synthesizer(tcfg, setup["fs2_exp"], setup["rank_exp"],
                                     device="cpu")
    jax_ev = object.__new__(jie.IntensityEfficacyEvaluator)
    jax_ev.synth = jsynth
    for s, e, lv, contrast in ((0, 1, 0.0, 1.5), (1, 2, 1.5, 1.5), (1, 0, 2.0, 2.0),
                               (0, 2, 2.0, 1.0)):
        np.testing.assert_array_equal(port_ev._conditioning(s, e, lv, 4, contrast),
                                      jax_ev._conditioning(s, e, lv, 4, contrast))


def test_f0_through_vocoder_matches_jax(setup):
    """evaluate_f0_through_vocoder: the DIO chain on two waveforms."""
    sr = setup["tcfg"].audio.sampling_rate
    t = np.arange(int(0.6 * sr)) / sr
    ref = (0.5 * np.sin(2 * np.pi * 160 * t) + 0.2 * np.sin(2 * np.pi * 320 * t)).astype(
        np.float32)
    syn = (0.5 * np.sin(2 * np.pi * 150 * t * (1 + 0.05 * t))).astype(np.float32)
    syn[len(syn) // 2:] = 0.0
    got = tev.evaluate_f0_through_vocoder(setup["tcfg"], ref, syn)
    assert got == jev.evaluate_f0_through_vocoder(setup["jcfg"], ref, syn)
    assert got["f0_rmse_hz"] > 0 and 0 < got["vuv_error_rate"] < 1


# ---------------------------------------------------------------------------
# Evaluator.run
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def evaluators(setup):
    """The port's Evaluator from its best/ exports and the JAX package's
    over the same trees (load_best_params and the Orbax templates patched
    out of its constructor)."""
    trees = {"fs2": setup["fs2"], "rank": setup["rank"]}
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jev, "init_fs2_variables",
                   lambda cfg, model, seed: {"params": None, "batch_stats": None})
        mp.setattr(jev, "init_rank_params", lambda cfg, model, seed: None)
        mp.setattr(jev, "load_best_params", lambda exp, template: trees[exp])
        jax_ev = jev.Evaluator(setup["jcfg"], fs2_exp="fs2", rank_exp="rank",
                               vocoder_params=setup["voc"])
    ev = tev.Evaluator(setup["tcfg"], setup["fs2_exp"], setup["rank_exp"],
                       vocoder_params=setup["voc"], device="cpu")
    return jax_ev, ev


def _rows(module, ev, monkeypatch, **kwargs):
    seen = []
    inner = module.aggregate

    def spy(per_utt, *args, **kw):
        seen.append(copy.deepcopy(per_utt))
        return inner(per_utt, *args, **kw)

    monkeypatch.setattr(module, "aggregate", spy)
    report = ev.run(**kwargs)
    return report, seen[0]


@pytest.mark.parametrize("conditioning", ["own", "prototype"])
def test_evaluator_rows_match_jax(setup, evaluators, conditioning, monkeypatch, tmp_path):
    jax_ev, ev = evaluators
    kwargs = dict(split="valid", f0_max_utts=2, conditioning=conditioning)
    if conditioning == "prototype":
        kwargs.update(intensity_bank=setup["bank"], contrast=1.5)
    report, rows = _rows(tev, ev, monkeypatch, out_path=str(tmp_path / "t.json"), **kwargs)
    jreport, jrows = _rows(jev, jax_ev, monkeypatch, out_path=str(tmp_path / "j.json"),
                           **kwargs)
    assert len(rows) == len(jrows) == report["n_utterances"] > 2
    assert sum("f0_rmse_hz" in r for r in rows) == 2
    for r, w in zip(rows, jrows):
        assert r.keys() == w.keys()
        assert (r["speaker"], r["emotion"]) == (w["speaker"], w["emotion"])
        for key in ("mcd_teacher_forced", "mcd_dtw_free_running",
                    "duration_mae_frames", "duration_total_rel_err"):
            np.testing.assert_allclose(r[key], w[key], rtol=1e-4, atol=1e-6, err_msg=key)
        if "f0_rmse_hz" in r:
            np.testing.assert_allclose(r["f0_rmse_hz"], w["f0_rmse_hz"], rtol=1e-3,
                                       atol=1e-3)
            assert r["vuv_error_rate"] == w["vuv_error_rate"]
    assert json.load(open(tmp_path / "t.json"))["conditioning"] == conditioning
    for key in ("conditioning", "contrast", "proto_level"):
        assert report.get(key) == jreport.get(key)
    with pytest.raises(ValueError):
        ev.run(conditioning="nearest")


def test_predicted_mel_pairs_match_jax(setup, evaluators, monkeypatch):
    """The vocoder fine-tune's (teacher-forced FS2 mel, trimmed waveform)
    pairs over the train split: the same utterances, the mels within 1e-4,
    the waveforms equal (the fixture's evaluators stand in for the ones
    predicted_mel_pairs would build)."""
    import emotts.train.vocoder_trainer as jvt
    import emotts_torch.train.vocoder_trainer as tvt

    jax_ev, ev = evaluators
    monkeypatch.setattr(jev, "Evaluator", lambda *args, **kwargs: jax_ev)
    monkeypatch.setattr(tev, "Evaluator", lambda *args, **kwargs: ev)
    want = jvt.predicted_mel_pairs(setup["jcfg"], "fs2", "rank")
    got = tvt.predicted_mel_pairs(setup["tcfg"], setup["fs2_exp"], setup["rank_exp"],
                                  device="cpu")
    assert len(got) == len(want) > 2
    for (mel, wav), (jmel, jwav) in zip(got, want):
        assert mel.shape == jmel.shape and mel.shape[0] * 256 == wav.size
        np.testing.assert_allclose(mel, jmel, rtol=1e-4, atol=1e-4)
        np.testing.assert_array_equal(wav, jwav)
    assert len(tvt.predicted_mel_pairs(setup["tcfg"], max_utts=2, device="cpu")) == 2
