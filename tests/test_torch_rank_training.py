"""The port's rank training path (emotts_torch/train, data, infer/bucketize)
held against the JAX package on the CPU, at toy width, on the synthetic
corpus preprocessed by the JAX package."""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import emotts.ops.attention as fa
from emotts.data import build_rank_pair_lists, preprocess_all
from emotts.data.datasets import RankPairDataset as JaxDataset
from emotts.data.datasets import collate_rank_pairs as jax_collate
from emotts.data.loader import BucketLoader as JaxLoader
from emotts.infer.bucketize import compute_intensity_prototypes as jax_prototypes
from emotts.losses.rank import rank_loss as jax_rank_loss
from emotts.parallel.mesh import make_mesh
from emotts.train.state import make_optimizer as jax_make_optimizer
from emotts.utils.config import save_config
from emotts_torch.data import BucketLoader, RankPairDataset, collate_rank_pairs
from emotts_torch.infer.bucketize import (bucketize, compute_intensity_prototypes,
                                          prototype_spread)
from emotts_torch.nn.convert import rank_from_flax
from emotts_torch.train.checkpoint import CheckpointManager, load_best_params
from emotts_torch.train.rank_trainer import RankTrainer, build_rank_model
from emotts_torch.utils.config import load_config
from tests.synthetic_corpus import make_corpus
from tests.torch_port_util import (jit, rank_batch, rank_variables,
                                   single_torch_thread)  # noqa: F401


@pytest.fixture(autouse=True)
def _interpret():
    fa._INTERPRET = True
    yield
    fa._INTERPRET = False


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    """(JAX config, port config) over one preprocessed synthetic corpus."""
    root = tmp_path_factory.mktemp("torch_rank")
    jcfg = make_corpus(str(root), utts_per_emotion=5)
    preprocess_all(jcfg, verbose=False)
    build_rank_pair_lists(jcfg)
    jcfg.rank_model.n_encoder_layers = 1
    jcfg.rank_model.hidden_dim = 32
    jcfg.rank_model.ffn_mult = 2
    jcfg.rank_model.fused_attention = True
    jcfg.train_rank.batch_size = 4
    jcfg.train_rank.n_epochs = 2
    jcfg.train_rank.learning_rate = 1e-3
    jcfg.train_rank.compute_dtype = "float32"
    jcfg.train_rank.selection_metric = "informative"
    path = str(root / "cfg.yaml")
    save_config(jcfg, path)
    return jcfg, load_config(path)  # the port's own Config, from the same YAML


def test_loader_plan_and_batches_equal_the_reference(corpus):
    jcfg, tcfg = corpus
    for split, shuffle in (("train", True), ("test", False)):
        kw = dict(buckets=jcfg.bucketing.frame_buckets, batch_size=4, shuffle=shuffle,
                  seed=jcfg.data.split_seed, drop_last=shuffle)
        want = JaxLoader(JaxDataset(jcfg, split), collate=jax_collate, **kw)
        got = BucketLoader(RankPairDataset(tcfg, split), collate=collate_rank_pairs, **kw)
        assert len(got.dataset) == len(want.dataset) > 0
        for epoch in (0, 3):
            assert got.plan_epoch(epoch) == want.plan_epoch(epoch)
        assert got.batches_per_epoch(0) == want.batches_per_epoch(0) > 0
        n = 0
        for a, b in zip(got.epoch(1), want.epoch(1)):
            assert set(a) == set(b)
            for key in b:
                assert a[key].dtype == b[key].dtype
                np.testing.assert_array_equal(a[key], b[key])
            n += 1
        assert n == want.batches_per_epoch(1)


def test_loader_pads_a_trailing_batch_and_flags_the_repeats(corpus):
    jcfg, tcfg = corpus
    kw = dict(buckets=jcfg.bucketing.frame_buckets, batch_size=4, shuffle=False,
              drop_last=False, pad_to_multiple=4)
    want = JaxLoader(JaxDataset(jcfg, "test"), collate=jax_collate, **kw)
    got = BucketLoader(RankPairDataset(tcfg, "test"), collate=collate_rank_pairs, **kw)
    assert got.plan_epoch(0) == want.plan_epoch(0)
    for a, b in zip(got.epoch(0), want.epoch(0)):
        np.testing.assert_array_equal(a["row_valid"], b["row_valid"])
        assert len(a["row_valid"]) % 4 == 0
    with pytest.raises(ValueError):
        BucketLoader(got.dataset, [64], 6, collate_rank_pairs, pad_to_multiple=4)


@pytest.fixture(scope="module")
def rank_trajectory():
    """Weights, a batch, and the reference's loss and gradient on it through
    the fused path (interpret mode), compiled once for both moment dtypes."""
    fa._INTERPRET = True
    try:
        jmodel, variables = rank_variables(seed=3, fused=True, dropout=0.0)
        batch = rank_batch(seed=4)
        jbatch = [jnp.asarray(a) for a in batch]

        def j_loss(params):
            out = jmodel.apply(params, *jbatch, deterministic=False)
            return jax_rank_loss(out, jbatch[2], alpha=0.1, beta=1.0)[0]

        j_grad = jit(jax.value_and_grad(j_loss))
        j_grad(variables)  # compile under interpret mode
        return variables, batch, j_grad
    finally:
        fa._INTERPRET = False


@pytest.mark.parametrize("moment_dtype", ["float32", "bfloat16"])
def test_training_trajectory_matches_a_jax_step(rank_trajectory, moment_dtype):
    """Four optimizer steps on one batch from the same weights, with the same
    λ and no dropout, through the fused path on both sides (the port's
    Function and plain backward, the reference's custom VJP in interpret
    mode) and each side's own AdamW."""
    from emotts.utils.config import TrainConfig as JaxTrainConfig
    from emotts_torch.losses.rank import rank_loss
    from emotts_torch.nn.intensity import RankModel
    from emotts_torch.train.state import make_optimizer
    from emotts_torch.utils.config import TrainConfig
    from tests.torch_port_util import SMALL_RANK

    lr, wd = 1e-3, 1e-2
    variables, batch, j_grad = rank_trajectory
    tx = jax_make_optimizer(JaxTrainConfig(learning_rate=lr, weight_decay=wd,
                                           moment_dtype=moment_dtype))

    @jit
    def j_update(params, opt_state, grads):
        updates, opt_state = tx.update(grads, opt_state, params)
        return optax.apply_updates(params, updates), opt_state

    def j_step(params, opt_state):
        loss, grads = j_grad(params)
        return (*j_update(params, opt_state, grads), loss)

    params, opt_state = variables, tx.init(variables)
    want = []
    for _ in range(4):
        params, opt_state, loss = j_step(params, opt_state)
        want.append(float(loss))

    tmodel = RankModel(**{**SMALL_RANK, "dropout": 0.0}, fused_attention=True)
    tmodel.load_state_dict(rank_from_flax(variables))
    opt = make_optimizer(TrainConfig(learning_rate=lr, weight_decay=wd,
                                     moment_dtype=moment_dtype), tmodel.parameters())
    tbatch = [torch.from_numpy(a) for a in batch]
    got = []
    for _ in range(4):
        out = tmodel(*tbatch, deterministic=False)
        loss, _ = rank_loss(out, tbatch[2], 0.1, 1.0)
        opt.zero_grad()
        loss.backward()
        opt.step()
        got.append(loss.item())
    # fp32 forward and backward on both sides; Adam's m/√v turns a last-bit
    # difference of a small gradient into a visible one, more so where the
    # moments are rounded to bf16
    np.testing.assert_allclose(got, want, rtol=2e-4 if moment_dtype == "float32" else 2e-3)
    assert got[-1] < got[0]
    final = rank_from_flax(jax.device_get(params))
    for name, p in tmodel.state_dict().items():
        np.testing.assert_allclose(p.numpy(), final[name].numpy(), rtol=0,
                                   atol=2e-4 if moment_dtype == "float32" else 2e-3)


def test_eval_step_matches_the_reference_passes(corpus):
    jcfg, tcfg = corpus
    from emotts.train.rank_trainer import build_rank_model as jax_build

    jmodel = jax_build(jcfg, dtype=jnp.float32)
    _, variables = rank_variables(seed=5, fused=True, n_mels=jcfg.audio.n_mels,
                                  n_layers=1, n_emotions=jcfg.n_emotions,
                                  kernel_size=jcfg.rank_model.kernel_size)
    trainer = RankTrainer(tcfg, device="cpu")
    trainer.model.load_state_dict(rank_from_flax(variables))
    loader = trainer._loader("test", shuffle=False)
    batch = next(iter(loader.epoch(0)))
    batch["row_valid"][-1] = 0.0  # as if the last row were a repeat
    got, h = trainer.eval_step(batch)

    b = len(batch["lengths"])
    args = [jnp.asarray(batch[k]) for k in ("emo_x", "neu_x", "emotions", "lengths")]
    rv = jnp.asarray(batch["row_valid"])
    lin = jnp.tile(jnp.linspace(0.0, 1.0, b)[None, :], (2, 1))
    apply = jit(jmodel.apply)  # one compilation instead of one per primitive
    preds = apply(variables, *args, lin)
    _, want = jax_rank_loss(preds, args[2], 0.1, 1.0, row_weights=rv)
    pairs = apply(variables, *args, jnp.stack([jnp.ones(b), jnp.zeros(b)]))
    _, inf = jax_rank_loss(pairs, args[2], 0.1, 1.0, row_weights=rv)
    want = {k: float(v) for k, v in want.items()}
    want.update(loss_informative=float(inf["loss"]),
                mixup_loss_pairs=float(inf["mixup_loss"]),
                rank_loss_pairs=float(inf["rank_loss"]),
                pair_order_acc=float(((pairs[6] > pairs[7]) * rv).sum() / rv.sum()))
    assert set(got) == set(want)
    for key in want:  # fp32 through one FFT block, another summation order
        np.testing.assert_allclose(got[key], want[key], rtol=2e-5, atol=2e-6)
    np.testing.assert_allclose(h, np.asarray(preds[4]), rtol=2e-5, atol=2e-5)
    assert abs(got["rank_loss"] - np.log(2.0)) < 1e-6  # the pinned quirk pass


@pytest.fixture(scope="module")
def fitted(corpus, tmp_path_factory):
    _, tcfg = corpus
    exp = str(tmp_path_factory.mktemp("torch_rank_exp") / "exp")
    trainer = RankTrainer(tcfg, device="cpu")
    assert trainer.fit(exp_path=exp, verbose=False) == exp
    return trainer, exp


def test_fit_writes_metrics_checkpoints_and_best(corpus, fitted):
    _, tcfg = corpus
    trainer, exp = fitted
    assert trainer.state.step > 0
    tags = {}
    with open(os.path.join(exp, "metrics.jsonl")) as f:
        for line in f:
            rec = json.loads(line)
            tags.setdefault(rec["tag"], []).append(rec["value"])
    for tag in ("train/loss", "train/mixup_loss", "train/rank_loss", "valid/loss",
                "valid/loss_informative", "valid/pair_order_acc"):
        assert len(tags[tag]) == 2 and np.isfinite(tags[tag]).all()
    ckpt = CheckpointManager(exp, keep=tcfg.train_rank.keep_checkpoints)
    assert ckpt.latest_step() == trainer.state.step and len(ckpt.steps()) == 2
    best = load_best_params(exp)
    assert set(best) == set(trainer.model.state_dict())
    with pytest.raises(RuntimeError):
        RankTrainer(tcfg, device="cuda")  # no card here, and no silent CPU run


def test_checkpoint_retention_and_missing_restore(corpus, tmp_path):
    _, tcfg = corpus
    trainer = RankTrainer(tcfg, device="cpu")
    assert trainer.restore(str(tmp_path / "none")) is False
    ckpt = CheckpointManager(str(tmp_path / "exp"), keep=2)
    for step in (1, 2, 3):
        trainer.state.step = step
        ckpt.save(trainer.state)
    assert ckpt.steps() == [2, 3]


def test_resume_is_exact(corpus, fitted):
    """restore + one step is the step the uninterrupted run takes: the same
    parameters, moments, step count and random streams."""
    _, tcfg = corpus
    trainer, exp = fitted
    batch = next(iter(trainer._loader("train", shuffle=True).epoch(0)))
    fresh = RankTrainer(tcfg, device="cpu")
    assert fresh.state.step == 0 and fresh.restore(exp)
    assert fresh.state.step == trainer.state.step
    for a, b in zip(fresh.model.state_dict().values(), trainer.model.state_dict().values()):
        assert torch.equal(a, b)
    want = [trainer.train_step(batch) for _ in range(2)]  # λ and dropout drawn
    got = [fresh.train_step(batch) for _ in range(2)]
    assert got == want
    for a, b in zip(fresh.model.state_dict().values(), trainer.model.state_dict().values()):
        assert torch.equal(a, b)
    again = RankTrainer(tcfg, device="cpu").train_step(batch)
    assert again != want[0]  # a trainer that did not resume is elsewhere


def test_bucketize_equals_the_reference_on_the_same_weights(corpus, fitted, tmp_path):
    jcfg, tcfg = corpus
    _, variables = rank_variables(seed=6, fused=True, n_mels=jcfg.audio.n_mels,
                                  n_layers=1, n_emotions=jcfg.n_emotions,
                                  kernel_size=jcfg.rank_model.kernel_size)
    want = jax_prototypes(jcfg, variables, mesh=make_mesh(devices=jax.devices()[:1]))
    got, storage = compute_intensity_prototypes(
        tcfg, rank_from_flax(variables), device="cpu", return_storage=True)
    assert got.shape == want.shape == (2, 3, tcfg.inference.bucket_size, 3)
    # fp32 through one block; prototypes are means of frame-level logits
    np.testing.assert_allclose(got, np.asarray(want), rtol=1e-4, atol=1e-5)
    assert sum(len(v) for v in storage.values()) == len(RankPairDataset(tcfg, "train"))

    from emotts.eval.intensity_eval import prototype_spread as jax_spread
    assert prototype_spread(got) == jax_spread(got)

    _, exp = fitted
    path = bucketize(tcfg, exp, device="cpu")
    bank = np.load(path)
    assert bank.shape == got.shape and np.isfinite(bank).all()
    meta = json.load(open(os.path.join(exp, "intensity_meta.json")))
    assert {"observed", "null_mean", "null_p95", "n_perm"} <= set(meta)
    model = build_rank_model(tcfg, device="cpu")
    assert model.intensity_extractor.fft.layers[0].attn.fused is True
    tcfg.rank_model.fused_attention = None  # unset: the kernels on a card only
    assert build_rank_model(tcfg, device="cpu").intensity_extractor.fft.layers[0].attn.fused is False
    tcfg.rank_model.fused_attention = True
