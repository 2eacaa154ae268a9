"""The port's FastSpeech2 training path (emotts_torch/train/fs2_trainer.py,
losses/fs2.py, the training mode of nn/fastspeech2.py, segment_mean, the FS2
data view, load_synthesizer) held against the JAX package on the CPU, at
toy width, on the synthetic corpus preprocessed by the JAX package.  The JAX
side reaches its fused attention kernel in Pallas interpret mode.

Dropout bits cannot be shared with JAX, so the parity cases run with every
dropout rate at 0 and the bare-embedding prenet (the conv prenet's dropout
rate is fixed at 0.15 in both packages); dropout itself is checked for its
kept fraction and scale."""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import emotts.ops.attention as fa
from emotts.data import build_fs2_splits as jax_build_fs2_splits
from emotts.data import preprocess_all
from emotts.data.datasets import FS2Dataset as JaxFS2Dataset
from emotts.data.loader import BucketLoader as JaxLoader
from emotts.losses.fs2 import fs2_loss as jax_fs2_loss
from emotts.nn.length_regulator import segment_mean as jax_segment_mean
from emotts.train.state import make_optimizer as jax_make_optimizer
from emotts.utils.config import save_config
from emotts_torch.data import BucketLoader, FS2Dataset, build_fs2_splits
from emotts_torch.losses.fs2 import fs2_loss
from emotts_torch.nn.convert import fs2_from_flax, rank_from_flax
from emotts_torch.nn.length_regulator import segment_mean
from emotts_torch.train.checkpoint import CheckpointManager, load_best_params
from emotts_torch.train.fs2_trainer import (FS2Trainer, batch_to_device,
                                            build_fastspeech2,
                                            extractor_params_from_rank)
from emotts_torch.utils.config import load_config
from tests.synthetic_corpus import make_corpus
from tests.torch_port_util import (fs2_variables, jit, rank_variables,
                                   single_torch_thread)  # noqa: F401

LR = 1e-3


@pytest.fixture(autouse=True)
def _interpret():
    fa._INTERPRET = True
    yield
    fa._INTERPRET = False


def _tiny(cfg):
    """Toy widths on a Config of either package; no dropout anywhere."""
    cfg.rank_model.n_encoder_layers = 1
    cfg.rank_model.hidden_dim = 32
    cfg.rank_model.ffn_mult = 2
    cfg.rank_model.fused_attention = True
    f = cfg.fastspeech2
    f.enc_num_layers = f.dec_num_layers = 1
    f.enc_d_model = f.dec_d_model = 32
    f.enc_ffn_dim = f.dec_ffn_dim = 64
    f.postnet_embedding_dim = 32
    f.postnet_n_convolutions = 3
    f.fused_attention = True
    f.prenet_style = "embedding"
    f.enc_dropout = f.dec_dropout = 0.0
    f.variance_predictor_dropout = f.postnet_dropout = 0.0
    t = cfg.train_fs2
    t.batch_size = 4
    t.n_epochs = 2
    t.learning_rate = LR
    t.compute_dtype = "float32"
    return cfg


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    """(JAX config, port config) over one preprocessed synthetic corpus,
    with the FS2 split lists the JAX package wrote."""
    root = tmp_path_factory.mktemp("torch_fs2")
    jcfg = _tiny(make_corpus(str(root), utts_per_emotion=5))
    preprocess_all(jcfg, verbose=False)
    jax_build_fs2_splits(jcfg)
    path = str(root / "cfg.yaml")
    save_config(jcfg, path)
    return jcfg, load_config(path)  # the port's own Config, from the same YAML


@pytest.fixture(scope="module")
def weights(corpus):
    """Numpy weights in the JAX trees: FastSpeech2 (with batch_stats) and
    the rank model whose extractor conditions it."""
    import copy

    jcfg, _ = corpus
    # the trees' shapes do not depend on the attention path: trace the
    # cheaper one
    unfused = copy.deepcopy(jcfg)
    unfused.fastspeech2.fused_attention = False
    _, fs2_vars = fs2_variables(unfused, seed=21)
    rm = jcfg.rank_model
    _, rank_vars = rank_variables(seed=22, n_mels=jcfg.audio.n_mels,
                                  n_layers=1, n_emotions=jcfg.n_emotions,
                                  kernel_size=rm.kernel_size, dropout=0.0)
    return fs2_vars, rank_vars


def _port_trainer(tcfg, weights):
    fs2_vars, rank_vars = weights
    trainer = FS2Trainer(tcfg, extractor_params_from_rank(rank_from_flax(rank_vars)),
                         device="cpu")
    trainer.model.load_state_dict(fs2_from_flax(fs2_vars))
    return trainer


@pytest.fixture(scope="module")
def jax_step(corpus, weights):
    """The reference's FS2 train and eval steps (emotts/train/fs2_trainer.py:
    157-233) at the same configuration, jitted, with XLA's attention in
    place of the interpret-mode kernel: its compilation would cost the
    test budget many times over, and the JAX package's own tests hold the
    two paths equal.  The train step also returns the predictions of its
    forward."""
    import dataclasses

    import optax
    from emotts.nn.fastspeech2 import FastSpeech2 as JaxFastSpeech2
    from emotts.nn.intensity import IntensityExtractor as JaxExtractor

    jcfg, _ = corpus
    rm = jcfg.rank_model
    model = JaxFastSpeech2(dataclasses.replace(
        jcfg.fastspeech2, fused_attention=False, intensity_dim=jcfg.n_emotions),
        n_speakers=jcfg.n_speakers)
    extractor = JaxExtractor(
        n_mels=jcfg.audio.n_mels, n_heads=rm.n_heads, n_emotions=jcfg.n_emotions,
        n_layers=rm.n_encoder_layers, hidden_dim=rm.hidden_dim,
        kernel_size=rm.kernel_size, ffn_mult=rm.ffn_mult, dropout=rm.dropout,
        fused_attention=False)
    tx = jax_make_optimizer(jcfg.train_fs2)
    ext_params = {"params": weights[1]["params"]["intensity_extractor"]}
    keys = ("phonemes", "speakers", "durations", "pitch", "energy")

    def forward(params, batch_stats, b, train):
        rep = jax_segment_mean(
            extractor.apply(ext_params, b["rank_x"], b["mel_len"], b["emotions"]),
            b["durations"])
        return model.apply({"params": params, "batch_stats": batch_stats},
                           *(b[k] for k in keys), rep,
                           max_mel_len=b["mel"].shape[1], deterministic=not train,
                           mutable=["batch_stats"] if train else False,
                           rngs={"dropout": jax.random.PRNGKey(0)})

    def loss(preds, b, row_weights=None):
        return jax_fs2_loss(preds, b["mel"], b["durations"], b["mel_len"],
                            b["phon_len"], jcfg.loss, row_weights=row_weights)

    @jit
    def train_step(params, opt_state, batch_stats, b):
        def loss_fn(p):
            preds, mutated = forward(p, batch_stats, b, True)
            total, parts = loss(preds, b)
            return total, (parts, mutated["batch_stats"], preds)

        (_, (parts, new_bs, preds)), grads = jax.value_and_grad(
            loss_fn, has_aux=True)(params)
        updates, opt_state = tx.update(grads, opt_state, params)
        return optax.apply_updates(params, updates), opt_state, new_bs, parts, preds

    @jit
    def eval_step(params, batch_stats, b):
        preds = forward(params, batch_stats, b, False)
        return loss(preds, b, b["row_valid"])[1], preds[0]

    return tx, train_step, eval_step


@pytest.fixture(scope="module")
def jax_trajectory(corpus, weights, jax_step):
    """The port's first training batch and the reference's three steps on
    it: per step the loss parts, predictions and BatchNorm statistics; the
    final parameters and optimizer state."""
    fs2_vars, _ = weights
    tx, train_step, _ = jax_step
    batch = _batch(_port_trainer(corpus[1], weights))
    jb = _jax_batch(batch)
    params, batch_stats = fs2_vars["params"], fs2_vars["batch_stats"]
    opt_state = tx.init(params)
    steps = []
    for _ in range(3):
        params, opt_state, batch_stats, parts, preds = train_step(
            params, opt_state, batch_stats, jb)
        steps.append(dict(parts=parts, preds=preds, batch_stats=batch_stats))
    return batch, steps, params, opt_state


def _jax_batch(batch):
    return {k: jnp.asarray(v) for k, v in batch.items() if k not in ("texts", "wavs")}


def _batch(trainer, split="train"):
    return next(iter(trainer._loader(split, shuffle=split == "train").epoch(0)))


def test_segment_mean_matches_jax():
    rng = np.random.default_rng(0)
    frames = rng.standard_normal((3, 20, 5)).astype(np.float32)
    durations = rng.integers(0, 6, (3, 7)).astype(np.int32)
    durations[0, 2] = 0  # a phone with no frames
    durations[1] = [9, 9, 9, 2, 0, 0, 1]  # runs past T: clamped into [0, T]
    durations[2, 3] = -2  # negative: no frames
    got = segment_mean(torch.from_numpy(frames), torch.from_numpy(durations))
    want = np.asarray(jit(jax_segment_mean)(jnp.asarray(frames),
                                                 jnp.asarray(durations)))
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-6)
    assert (got[0, 2] == 0).all() and (got[1, 4:6] == 0).all()


LOSS_WEIGHTS = dict(ssim_loss_weight=0.5, duration_loss_weight=2.0,
                    pitch_loss_weight=0.3)
ROW_WEIGHTS = np.array([1.0, 1.0, 0.0], np.float32)


@pytest.fixture(scope="module")
def loss_case():
    """Loss inputs from a numpy seed, and the reference's parts without and
    with row weights (one compilation for both)."""
    from emotts.utils.config import LossConfig as JaxLossConfig

    rng = np.random.default_rng(1)
    b, t, p, m = 3, 24, 6, 8

    def f(*shape):
        return rng.standard_normal(shape).astype(np.float32)

    preds = (f(b, t, m), f(b, t, m), f(b, p), f(b, p, 1), f(b, p, 1), f(b, p, 1),
             f(b, p, 1), None)
    args = (preds, f(b, t, m), rng.integers(0, 5, (b, p)).astype(np.int32),
            np.array([24, 10, 17], np.int32), np.array([6, 3, 5], np.int32))
    cfg = JaxLossConfig(**LOSS_WEIGHTS)

    @jit
    def both(*a):
        return (jax_fs2_loss(*a, cfg)[1],
                jax_fs2_loss(*a, cfg, row_weights=jnp.asarray(ROW_WEIGHTS))[1])

    return args, both(*jax.tree_util.tree_map(jnp.asarray, args))


@pytest.mark.parametrize("weighted", [False, True])
def test_fs2_loss_parts_match_jax(loss_case, weighted):
    from emotts_torch.utils.config import LossConfig

    args, refs = loss_case
    want = refs[weighted]

    def t(a):
        return None if a is None else torch.from_numpy(a)

    preds, mel, dur, mel_len, phon_len = args
    total, got = fs2_loss(tuple(t(a) for a in preds), t(mel), t(dur), t(mel_len),
                          t(phon_len), LossConfig(**LOSS_WEIGHTS),
                          row_weights=t(ROW_WEIGHTS) if weighted else None)
    assert set(got) == set(want) and got["total_loss"] is total
    for key in want:
        np.testing.assert_allclose(got[key].item(), float(want[key]), rtol=1e-5,
                                   err_msg=key)
    assert 0.0 < got["ssim_loss"].item() < 0.5  # the window sees structure


def test_training_forward_and_batch_norm_statistics_match_flax(corpus, weights,
                                                              jax_trajectory):
    """Training mode at dropout 0 (extractor, segment_mean, FS2): the outputs
    use the batch's statistics, and the running statistics move as flax
    moves them (momentum 0.99, biased variance over all B·T positions, pad
    frames included)."""
    _, tcfg = corpus
    fs2_vars, _ = weights
    batch, steps = jax_trajectory[:2]
    trainer = _port_trainer(tcfg, weights)
    got = trainer._forward(batch_to_device(batch, "cpu"), deterministic=False)
    assert int(batch["mel_len"].min()) < batch["mel"].shape[1]  # pad frames count
    for name, a, b in zip(("mel_post", "postnet_mel", "log_durations", "pred_pitch",
                           "avg_pitch", "pred_energy", "avg_energy"),
                          steps[0]["preds"], got):
        np.testing.assert_allclose(b.detach().numpy(), np.asarray(a), rtol=1e-4,
                                   atol=1e-4, err_msg=name)
    want = fs2_from_flax({"params": fs2_vars["params"],
                          "batch_stats": jax.device_get(steps[0]["batch_stats"])})
    start = fs2_from_flax(fs2_vars)
    stats = [n for n in want if "running_" in n]
    assert len(stats) == 2 * tcfg.fastspeech2.postnet_n_convolutions
    for name in stats:
        value = trainer.model.state_dict()[name]
        np.testing.assert_allclose(value.numpy(), want[name].numpy(), rtol=1e-5,
                                   atol=1e-6, err_msg=name)
        assert not torch.equal(value, start[name]), name


def test_fs2_from_flax_carries_batch_stats(weights):
    fs2_vars, _ = weights
    sd = fs2_from_flax(fs2_vars)
    stats = fs2_vars["batch_stats"]["postnet"]
    assert len(stats) == 3
    for i in range(3):
        for leaf in ("mean", "var"):
            np.testing.assert_array_equal(sd[f"postnet.bns.{i}.running_{leaf}"].numpy(),
                                          stats[f"bn_{i}"][leaf])


def test_train_trajectory_matches_jax(corpus, weights, jax_trajectory):
    """Three optimizer steps from the same weights on one batch, through the
    frozen extractor, segment_mean, the FS2 forward and backward (the port's
    fused path), the loss and each side's AdamW with bf16 moments (the
    configured default): the loss parts at each step, then the fp32
    parameters, the BatchNorm statistics and the Adam moments.

    Adam divides a gradient by its own size, so an entry whose first
    gradient is at the rounding level (|g| ≤ 1e-6 of the model's largest
    entry) takes steps of up to ``lr`` in a direction the rounding picks, on
    either side.  The attention key biases and the PostNet conv biases ahead
    of BatchNorm on batch statistics have no gradient at all, and a few
    other entries start there (under 0.5 % of those with a gradient).  Those
    entries are held to Adam's bound on both sides; every other entry to
    the stated tolerance."""
    _, tcfg = corpus
    fs2_vars, _ = weights
    batch, steps, params, opt_state = jax_trajectory
    trainer = _port_trainer(tcfg, weights)
    assert trainer.model.encoder.layers[0].attn.fused
    for i in range(3):
        want = steps[i]["parts"]
        got = trainer.train_step(batch)
        for key in want:
            np.testing.assert_allclose(got[key], float(want[key]), rtol=2e-5,
                                       atol=1e-6, err_msg=key)
        if i == 0:
            first = {n: p.grad.clone() for n, p in trainer.model.named_parameters()}
    largest = max(g.abs().max().item() for g in first.values())
    start = fs2_from_flax(fs2_vars)
    final = fs2_from_flax(jax.device_get({"params": params,
                                          "batch_stats": steps[-1]["batch_stats"]}))
    bound = 3 * LR * (1 + tcfg.train_fs2.weight_decay)
    without_gradient = [n for n in first if n.endswith("attn.key.bias")
                        or (n.startswith("postnet.convs.") and n.endswith(".bias"))]
    assert len(without_gradient) == 2 + tcfg.fastspeech2.postnet_n_convolutions
    rest = torch.cat([g.abs().reshape(-1) for n, g in first.items()
                      if n not in without_gradient])
    assert ((rest > 0) & (rest <= 1e-6 * largest)).sum() <= 5e-3 * (rest > 0).sum()
    for name, p in trainer.model.state_dict().items():
        if name.endswith("num_batches_tracked"):
            continue
        got, want = p.numpy(), final[name].numpy()
        noise = False
        if name in first:
            noise = (first[name].abs() <= 1e-6 * largest).numpy()
            assert noise.all() or name not in without_gradient, name
        for side in (got, want):
            assert np.all(np.abs(side - start[name].numpy())[noise] <= bound), name
        np.testing.assert_allclose(np.where(noise, 0.0, got), np.where(noise, 0.0, want),
                                   rtol=0, atol=2e-4, err_msg=name)
    mu = fs2_from_flax({"params": jax.device_get(opt_state[0].mu)})
    opt = trainer.state.optimizer
    for name, p in trainer.model.named_parameters():
        m = opt.state[p]["mu"]
        assert m.dtype == torch.bfloat16
        np.testing.assert_allclose(m.float().numpy(), mu[name].numpy(), rtol=0,
                                   atol=2e-3, err_msg=name)


def test_eval_step_with_row_valid_matches_jax(corpus, weights, jax_step):
    _, tcfg = corpus
    fs2_vars, _ = weights
    trainer = _port_trainer(tcfg, weights)
    batch = _batch(trainer, "valid")
    batch["row_valid"][-1] = 0.0  # as if the last row were a repeat
    got, mel = trainer.eval_step(batch)
    want, jmel = jax_step[2](fs2_vars["params"], fs2_vars["batch_stats"],
                             _jax_batch(batch))
    assert set(got) == set(want)
    for key in want:
        np.testing.assert_allclose(got[key], float(want[key]), rtol=2e-5,
                                   atol=1e-6, err_msg=key)
    np.testing.assert_allclose(mel.numpy(), np.asarray(jmel), rtol=1e-4, atol=1e-4)
    full, _ = trainer.eval_step(dict(batch, row_valid=np.ones_like(batch["row_valid"])))
    assert full["mel_loss"] != got["mel_loss"]  # the masked row counted


def test_fs2_splits_dataset_and_batches_equal_the_reference(corpus, weights,
                                                            tmp_path):
    jcfg, tcfg = corpus
    base = tcfg.data.preprocessed_path
    want = [open(os.path.join(base, f"fs2_{s}.txt")).read() for s in ("train", "valid")]
    tcfg.data.preprocessed_path = str(tmp_path)
    try:  # the port writes its lists beside a copy of the corpus' layout
        for speaker in tcfg.data.speakers:
            os.symlink(os.path.join(base, speaker), tmp_path / speaker)
        train, valid = build_fs2_splits(tcfg)
        assert build_fs2_splits(tcfg) == (train, valid)  # kept, not redrawn
        got = [(tmp_path / f"fs2_{s}.txt").read_text() for s in ("train", "valid")]
    finally:
        tcfg.data.preprocessed_path = base
    assert got == [w.replace(base, str(tmp_path)) for w in want]
    assert len(train) == 24 and len(valid) == 6

    from emotts.data.datasets import collate_fs2 as jax_collate_fs2
    from emotts.data.datasets import pick_bucket as jax_pick_bucket

    def jax_collate(examples, frame_bucket):  # the reference trainer's
        phones = jax_pick_bucket(max(len(e.phonemes) for e in examples),
                                 jcfg.bucketing.phone_buckets)
        return jax_collate_fs2(examples, phones, frame_bucket)

    trainer = _port_trainer(tcfg, weights)
    for split, shuffle in (("train", True), ("valid", False)):
        assert len(FS2Dataset(tcfg, split)) == len(JaxFS2Dataset(jcfg, split))
        kw = dict(buckets=jcfg.bucketing.frame_buckets, batch_size=4,
                  shuffle=shuffle, seed=jcfg.data.split_seed, drop_last=shuffle)
        a_loader = BucketLoader(FS2Dataset(tcfg, split), collate=trainer._collate, **kw)
        b_loader = JaxLoader(JaxFS2Dataset(jcfg, split), collate=jax_collate, **kw)
        assert a_loader.plan_epoch(1) == b_loader.plan_epoch(1)
        n = 0
        for a, b in zip(a_loader.epoch(1), b_loader.epoch(1)):
            assert set(a) == set(b)
            for key in b:
                if key in ("texts", "wavs"):
                    assert a[key] == b[key]
                else:
                    assert a[key].dtype == b[key].dtype
                    np.testing.assert_array_equal(a[key], b[key])
            n += 1
        assert n == b_loader.batches_per_epoch(1) > 0


def test_collate_clamps_overflowing_durations():
    from emotts.data.datasets import collate_fs2 as jax_collate
    from emotts_torch.data.datasets import FS2Example, collate_fs2

    rng = np.random.default_rng(4)
    examples = []
    for p, t in ((5, 30), (9, 12)):  # the second overflows its buckets
        mel = rng.standard_normal((t, 4)).astype(np.float32)
        examples.append(FS2Example(
            phonemes=np.arange(1, p + 1, dtype=np.int32),
            durations=np.full(p, 4, np.int32), mel=mel, pitch=mel[:, 0],
            energy=mel[:, 1], rank_x=rng.standard_normal((t, 6)).astype(np.float32),
            speaker=1, emotion=2, text="x", audio_path="y"))
    got, want = collate_fs2(examples, 8, 16), jax_collate(examples, 8, 16)
    for key in want:
        if key in ("texts", "wavs"):
            assert got[key] == want[key]
        else:
            np.testing.assert_array_equal(got[key], want[key])
    assert got["durations"].sum(axis=1).max() <= 16 and got["phon_len"][1] == 8


def test_dropout_in_training_mode_keeps_its_rate_and_scale(corpus):
    """At the configured rates the training forward draws from the caller's
    generator: repeatable from one state, different from another, and each
    dropout keeps 1 − rate of its entries at 1 / (1 − rate)."""
    from emotts_torch.nn import fastspeech2 as tf

    _, tcfg = corpus
    drawn = []
    real = tf.dropout

    def spy(x, rate, generator):
        y = real(x, rate, generator)
        if rate > 0:
            drawn.append((rate, x.detach(), y.detach()))
        return y

    f = tcfg.fastspeech2
    f.variance_predictor_dropout, f.postnet_dropout = 0.5, 0.5
    try:
        model = build_fastspeech2(tcfg)
        tokens = torch.randint(1, 80, (2, 8), generator=torch.Generator().manual_seed(0))
        spk = torch.tensor([0, 1])
        out = [model(tokens, spk, deterministic=False, max_mel_len=32,
                     generator=torch.Generator().manual_seed(s))[0] for s in (1, 1, 2)]
        tf.dropout = spy
        model(tokens, spk, deterministic=False, max_mel_len=32,
              generator=torch.Generator().manual_seed(3))
    finally:
        tf.dropout = real
        f.variance_predictor_dropout = f.postnet_dropout = 0.0
    assert torch.equal(out[0], out[1]) and not torch.equal(out[0], out[2])
    assert len(drawn) == 3 * 2 + 3  # two per variance predictor, one per PostNet conv
    x = torch.cat([a.reshape(-1) for _, a, _ in drawn])
    y = torch.cat([b.reshape(-1) for _, _, b in drawn])
    kept = (y != 0) & (x != 0)
    assert abs(kept.float().sum().item() / (x != 0).sum().item() - 0.5) < 0.03
    torch.testing.assert_close(y[kept], 2.0 * x[kept])


@pytest.fixture(scope="module")
def fitted(corpus, weights, tmp_path_factory):
    """fit on the CPU from the seeded weights, with a phone lasting about
    four frames (a choice of starting weights: the seeded duration predictor
    would predict no frames), and a small generator for the vocoded
    validation samples."""
    from emotts_torch.nn.hifigan import HiFiGANGenerator
    from emotts_torch.nn.init import seeded_init_
    from tests.torch_port_util import SMALL_VOCODER

    _, tcfg = corpus
    exp = str(tmp_path_factory.mktemp("torch_fs2_exp") / "exp")
    vocoder = seeded_init_(HiFiGANGenerator(**dict(SMALL_VOCODER, in_channels=80)),
                           torch.Generator().manual_seed(7))
    trainer = FS2Trainer(tcfg, extractor_params_from_rank(rank_from_flax(weights[1])),
                         vocoder=vocoder, device="cpu")
    with torch.no_grad():
        trainer.model.duration_predictor.out.bias.fill_(float(np.log1p(4.0)))
    assert trainer.fit(exp_path=exp, verbose=False) == exp
    return trainer, exp


def test_fit_writes_metrics_checkpoints_and_best_with_batch_stats(corpus, fitted):
    _, tcfg = corpus
    trainer, exp = fitted
    assert trainer.state.step == 2 * 6  # 24 examples, batches of 4, 2 epochs
    tags = {}
    with open(os.path.join(exp, "metrics.jsonl")) as f:
        for line in f:
            rec = json.loads(line)
            tags.setdefault(rec["tag"], []).append(rec["value"])
    for name in ("total_loss", "ssim_loss", "mel_loss", "postnet_mel_loss",
                 "dur_loss", "pitch_loss", "energy_loss"):
        for prefix in ("Loss/", "Valid/Loss/"):
            assert len(tags[prefix + name]) == 2 and np.isfinite(tags[prefix + name]).all()
    for tag in ("train/loader_wait_s", "train/loader_build_s"):  # each epoch's seconds
        assert len(tags[tag]) == 2 and all(v > 0 for v in tags[tag])
    # vocoded samples of the first validated epoch (every 10th at the
    # default cadence), predicted and ground truth, mel_len frames each
    wavs = sorted(os.listdir(os.path.join(exp, "wavs")))
    assert wavs == [f"epoch_0_sample_{i}_{kind}.wav" for i in range(1, 5)
                    for kind in ("gt", "pred")]
    ckpt = CheckpointManager(exp, keep=tcfg.train_fs2.keep_checkpoints)
    assert ckpt.steps() == [6, 12]
    best = load_best_params(exp)
    assert set(best) == set(trainer.model.state_dict())
    assert not torch.equal(best["postnet.bns.0.running_var"],
                           torch.ones_like(best["postnet.bns.0.running_var"]))
    with pytest.raises(RuntimeError):
        FS2Trainer(tcfg, {}, device="cuda")  # no card here, and no silent CPU run


def test_resume_is_exact(corpus, weights, fitted):
    """restore + a step is the step the uninterrupted run takes: the same
    parameters, BatchNorm statistics, moments, step and dropout stream."""
    _, tcfg = corpus
    trainer, exp = fitted
    ext = extractor_params_from_rank(rank_from_flax(weights[1]))
    batch = _batch(trainer)
    fresh = FS2Trainer(tcfg, ext, device="cpu")
    assert fresh.restore(exp) and fresh.state.step == trainer.state.step
    f = tcfg.fastspeech2
    f.variance_predictor_dropout = 0.5  # draw from the restored stream
    try:
        a, b = (FS2Trainer(tcfg, ext, device="cpu") for _ in range(2))
        assert a.restore(exp) and b.restore(exp)
        want = [a.train_step(batch) for _ in range(2)]
        got = [b.train_step(batch) for _ in range(2)]
        again = FS2Trainer(tcfg, ext, device="cpu").train_step(batch)
    finally:
        f.variance_predictor_dropout = 0.0
    assert got == want and again != want[0]
    for x, y in zip(a.model.state_dict().values(), b.model.state_dict().values()):
        assert torch.equal(x, y)


def test_best_export_serves_a_streamed_request(corpus, fitted, tmp_path):
    """fit → best/ → load_synthesizer (with the rank experiment's bank and an
    .npz vocoder) → a streamed request through the service."""
    from emotts_torch.infer.server import TTSService
    from emotts_torch.infer.synthesize import load_synthesizer
    from tests.torch_port_util import SMALL_VOCODER, vocoder_params

    _, tcfg = corpus
    _, exp = fitted
    rank_exp = tmp_path / "rank"
    rank_exp.mkdir()
    np.save(rank_exp / "intensity.npy", np.random.default_rng(5).standard_normal(
        (2, 3, 3, 3)).astype(np.float32))
    _, voc = vocoder_params(dict(SMALL_VOCODER, in_channels=80,
                                 upsample_rates=(8, 8, 2, 2),
                                 upsample_kernel_sizes=(16, 16, 4, 4)), seed=6)
    flat = {}

    def walk(node, prefix):
        for k, v in node.items():
            if isinstance(v, dict):
                walk(v, prefix + k + "/")
            else:
                flat[prefix + k] = v

    walk(voc["params"], "")
    np.savez(tmp_path / "voc.npz", **flat)
    tcfg.inference.vocoder_checkpoint = str(tmp_path / "voc.npz")
    tcfg.inference.neural_g2p = False
    try:
        synth = load_synthesizer(tcfg, exp, str(rank_exp), device="cpu")
    finally:
        tcfg.inference.vocoder_checkpoint = ""
    assert synth.intensity_bank.shape == (2, 3, 3, 3)
    assert torch.equal(synth.model.postnet.bns[0].running_var,
                       load_best_params(exp)["postnet.bns.0.running_var"])
    svc = TTSService(tcfg, synth, microbatch_window_ms=-1, device="cpu")
    chunks = list(svc.stream({"text": "The cat. A dog ran.", "speaker": 1,
                              "emotion": "amused", "level": 1}))
    wav = np.concatenate(chunks)
    assert len(chunks) >= 3 and wav.dtype == np.float32 and np.isfinite(wav).all()
    assert wav.size > int(0.15 * tcfg.audio.sampling_rate) + 2 * 256
