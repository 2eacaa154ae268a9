"""The port's data parallelism across processes (emotts_torch/parallel,
the trainers under a process group, the command under the launcher): two
``gloo`` processes on the CPU at toy width, fp32, against one process on the
same global batches and against the JAX package's FS2 step on its
8-virtual-device mesh.

The worker (tests/torch_mp_worker.py) imports nothing of the JAX package;
its processes meet through a file store under the test's temporary
directory, so that parallel test files never race for a port."""

import copy
import json
import os
import subprocess
import sys
import uuid
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from emotts.data import build_fs2_splits, build_rank_pair_lists, preprocess_all
from emotts.parallel.mesh import replicated
from emotts.parallel.mesh import shard_batch as jax_shard_batch
from emotts.train.fs2_trainer import FS2Trainer as JaxFS2Trainer
from emotts.utils.config import load_config as jax_load_config
from emotts.utils.config import save_config
from emotts_torch.nn.convert import fs2_from_flax, rank_from_flax
from emotts_torch.nn.init import seeded_init_
from emotts_torch.train.fs2_trainer import (FS2Trainer, build_intensity_extractor,
                                            extractor_params_from_rank)
from emotts_torch.train.rank_trainer import RankTrainer
from emotts_torch.train.vocoder_trainer import VocoderTrainer
from emotts_torch.utils.config import load_config
from tests.synthetic_corpus import make_corpus
from tests.torch_mp_worker import seeded
from tests.torch_port_util import (fs2_variables, jit, rank_variables,
                                   single_torch_thread)  # noqa: F401

REPO = Path(__file__).resolve().parent.parent
WORLD = 2
STEPS = 3
# a 2-process step equals a 1-process step on the same global batch up to
# the order of its sums (tests/test_multiprocess.py holds the JAX package
# to the same rtol)
RTOL = 1e-5


def _tiny(cfg, dropout=True):
    """Toy widths on a Config of either package, fp32, fused attention
    (its plain version on the CPU)."""
    rm = cfg.rank_model
    rm.n_encoder_layers, rm.hidden_dim, rm.ffn_mult = 1, 32, 2
    rm.fused_attention = True
    rm.dropout = 0.1 if dropout else 0.0
    tr = cfg.train_rank
    tr.batch_size, tr.n_epochs, tr.learning_rate = 4, 1, 1e-3
    tr.compute_dtype = "float32"
    tr.profile_epoch = -1
    f = cfg.fastspeech2
    f.enc_num_layers = f.dec_num_layers = 1
    f.enc_d_model = f.dec_d_model = 32
    f.enc_ffn_dim = f.dec_ffn_dim = 64
    f.postnet_embedding_dim = 32
    f.postnet_n_convolutions = 3
    f.fused_attention = True
    if not dropout:
        f.prenet_style = "embedding"  # the conv prenet's dropout is fixed
        f.enc_dropout = f.dec_dropout = 0.0
        f.variance_predictor_dropout = f.postnet_dropout = 0.0
    t = cfg.train_fs2
    t.batch_size, t.learning_rate, t.compute_dtype = 8, 1e-3, "float32"
    vc = cfg.train_vocoder
    vc.batch_size, vc.segment_frames = 2, 8
    vc.upsample_initial_channel = 16
    vc.resblock_kernel_sizes, vc.resblock_dilations = [3], [[1, 3]]
    vc.disc_channel_mult, vc.mpd_periods, vc.msd_scales = 0.05, [2, 3], 2
    vc.compute_dtype, vc.learning_rate = "float32", 1e-3
    return cfg


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    """The synthetic corpus preprocessed by the JAX package; the config
    with dropout on (``cfg.yaml``) and with every dropout off
    (``det.yaml``), the vocoder's wav list, and the weights of the JAX
    comparison in both packages' forms."""
    root = tmp_path_factory.mktemp("torch_mp")
    jcfg = make_corpus(str(root), utts_per_emotion=5)
    preprocess_all(jcfg, verbose=False)
    build_rank_pair_lists(jcfg)
    build_fs2_splits(jcfg)
    paths = {}
    for name, dropout in (("cfg", True), ("det", False)):
        paths[name] = str(root / f"{name}.yaml")
        save_config(_tiny(copy.deepcopy(jcfg), dropout), paths[name])
    wavs = sorted(str(p) for p in (root / "corpus").glob("*/*.wav"))
    paths["wavs"] = str(root / "wavs.txt")
    Path(paths["wavs"]).write_text("\n".join(wavs))

    det = jax_load_config(paths["det"])
    _, fs2_vars = fs2_variables(dataclass_unfused(det), seed=31)
    rm = det.rank_model
    _, rank_vars = rank_variables(seed=32, n_mels=det.audio.n_mels, n_layers=1,
                                  n_emotions=det.n_emotions,
                                  kernel_size=rm.kernel_size, dropout=0.0)
    paths["extractor"] = str(root / "extractor.pt")
    paths["fs2"] = str(root / "fs2.pt")
    torch.save(extractor_params_from_rank(rank_from_flax(rank_vars)), paths["extractor"])
    torch.save(fs2_from_flax(fs2_vars), paths["fs2"])
    return root, paths, fs2_vars, rank_vars


def dataclass_unfused(cfg):
    """The JAX side takes XLA's attention: the interpret-mode kernel's
    compilation would cost the test budget many times over, and the JAX
    package's own tests hold the two paths equal."""
    cfg = copy.deepcopy(cfg)
    cfg.fastspeech2.fused_attention = False
    cfg.rank_model.fused_attention = False
    return cfg


def _workers(root, paths, jobs, extra=()):
    """Run the 2-process job; each rank's result dict."""
    store = f"file://{root / f'store_{uuid.uuid4().hex}'}"
    env = dict(os.environ, PYTHONPATH=str(REPO), OMP_NUM_THREADS="1")
    procs, outs = [], []
    for rank in range(WORLD):
        outs.append(root / f"out_{uuid.uuid4().hex}_{rank}.pt")
        procs.append(subprocess.Popen(
            [sys.executable, str(REPO / "tests" / "torch_mp_worker.py"),
             "--init", store, "--world", str(WORLD), "--rank", str(rank),
             "--config", paths["cfg"], "--out", str(outs[-1]), "--jobs", jobs,
             "--steps", str(STEPS), "--wavs", paths["wavs"], *extra],
            cwd=str(REPO), env=env, stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT))
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=300)[0].decode(errors="replace"))
    finally:
        for p in procs:
            p.kill()
    for rank, p in enumerate(procs):
        assert p.returncode == 0, f"rank {rank} failed:\n{logs[rank][-4000:]}"
    return [torch.load(o, weights_only=False) for o in outs]


@pytest.fixture(scope="module")
def two(corpus):
    root, paths, _, _ = corpus
    return _workers(root, paths, "rank,fs2,fs2_weights,vocoder",
                    ("--fs2-config", paths["det"], "--fs2-weights",
                     paths["extractor"], paths["fs2"]))


def _assert_lockstep(runs):
    """Both ranks: bit-identical parameters after every step, equal losses."""
    a, b = runs
    assert len(a["digests"]) == len(b["digests"]) > 0
    assert a["digests"] == b["digests"]
    assert a["losses"] == b["losses"]


def _assert_close_losses(got, want, rtol=RTOL):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert set(g) == set(w)
        for key in w:
            np.testing.assert_allclose(g[key], w[key], rtol=rtol, atol=1e-7,
                                       err_msg=key)


def _assert_close_grads(got, want, rel=1e-4, zero=1e-6):
    """Each gradient within ``rel`` of its own largest entry.  A gradient
    that is zero in exact arithmetic holds rounding noise alone — a key
    projection's bias (softmax does not see a constant added to every logit
    of a row), a conv bias under BatchNorm in training (the batch mean takes
    it out): where the reference's largest entry is below ``zero`` of the
    model's largest, both sides must be."""
    assert set(got) == set(want)
    top = max(float(np.abs(np.asarray(w)).max()) for w in want.values())
    bad = {}
    for name, w in want.items():
        g = np.abs(np.asarray(got[name], np.float64))
        w = np.asarray(w, np.float64)
        if np.abs(w).max() < zero * top:
            err = g.max() / (zero * top)
        else:
            err = np.abs(np.asarray(got[name], np.float64) - w).max() / (
                rel * np.abs(w).max())
        if err > 1.0:
            bad[name] = err
    assert not bad, bad


def _one_process(trainer, steps=STEPS):
    """The trainer's steps on the global batches of one process's loader;
    (losses, step-1 gradients)."""
    it = iter(trainer._loader("train", shuffle=True).epoch(0))
    losses, grads = [], None
    for i in range(steps):
        losses.append(trainer.train_step(next(it)))
        if i == 0:
            grads = {n: p.grad.clone() for n, p in trainer.model.named_parameters()
                     if p.grad is not None}
    return losses, grads


def test_rank_trainer_two_processes_equal_one(corpus, two):
    """Dropout (fused-attention seeds and masks) and mixup on: the ranks in
    lockstep, and the global steps those of one process."""
    _, paths, _, _ = corpus
    runs = [r["rank"] for r in two]
    _assert_lockstep(runs)
    tcfg = load_config(paths["cfg"])
    assert tcfg.rank_model.dropout > 0
    losses, grads = _one_process(seeded(lambda: RankTrainer(tcfg, device="cpu")))
    _assert_close_losses(runs[0]["losses"], losses)
    _assert_close_grads(runs[0]["grads"], grads)
    _assert_close_grads(runs[1]["grads"], grads)


def test_fs2_trainer_two_processes_equal_one(corpus, two):
    """Dropout on, PostNet BatchNorm on the batch statistics, SSIM and MSE
    denominators that differ between the ranks' halves of the batch."""
    _, paths, _, _ = corpus
    runs = [r["fs2"] for r in two]
    _assert_lockstep(runs)
    tcfg = load_config(paths["cfg"])
    extractor = seeded(lambda: seeded_init_(
        build_intensity_extractor(tcfg, device="cpu"),
        torch.Generator().manual_seed(5))).state_dict()
    trainer = seeded(lambda: FS2Trainer(tcfg, extractor, device="cpu"))
    batch = next(iter(trainer._loader("train", shuffle=True).epoch(0)))
    half = len(batch["mel_len"]) // WORLD
    assert batch["mel_len"][:half].sum() != batch["mel_len"][half:].sum()
    losses, grads = _one_process(trainer)
    _assert_close_losses(runs[0]["losses"], losses)
    _assert_close_grads(runs[0]["grads"], grads)
    # the BatchNorm running statistics moved by the global statistics
    bn = trainer.model.postnet.bns[0]
    assert not torch.allclose(bn.running_mean, torch.zeros_like(bn.running_mean))


def test_fs2_two_processes_match_the_jax_trainer_on_eight_devices(corpus, two):
    """The slice as a whole: the 2-process FS2 steps (dropout 0) against
    emotts.train.fs2_trainer.FS2Trainer's step on the 8-virtual-device mesh,
    on the same global batches and weights (carried across by
    emotts_torch.nn.convert).  Losses within 1e-4 relative (the FS2 norm of
    the port's parity tests: fp32, other summation orders, the port's
    attention against XLA's), step-1 gradients within 1e-4 of each one's
    largest entry."""
    _, paths, fs2_vars, rank_vars = corpus
    run = two[0]["fs2_weights"]
    _assert_lockstep([r["fs2_weights"] for r in two])

    jcfg = dataclass_unfused(jax_load_config(paths["det"]))
    trainer = JaxFS2Trainer(
        jcfg, {"params": rank_vars["params"]["intensity_extractor"]})
    assert len(jax.devices()) == 8 and trainer.mesh.shape["data"] == 8

    def stash():
        """Keeps each step's gradients in its state, passes them on."""
        return optax.GradientTransformation(
            lambda params: jax.tree_util.tree_map(jnp.zeros_like, params),
            lambda updates, state, params=None: (updates, updates))

    trainer.tx = optax.chain(stash(), trainer.tx)
    params = jax.tree_util.tree_map(jnp.asarray, fs2_vars["params"])
    state = trainer.state.replace(
        params=params, opt_state=trainer.tx.init(params),
        batch_stats=jax.tree_util.tree_map(jnp.asarray, fs2_vars["batch_stats"]))
    state = jax.device_put(state, replicated(trainer.mesh))
    step = jit(trainer._train_step_fn)
    it = iter(trainer._loader("train", shuffle=True).epoch(0))
    losses = []
    for i in range(STEPS):
        db = jax_shard_batch(trainer.mesh, trainer._device_batch(next(it)))
        state, metrics = step(state, trainer.extractor_params, db)
        losses.append({k: float(v) for k, v in metrics.items()})
        if i == 0:
            grads = fs2_from_flax({"params": jax.device_get(state.opt_state[0]),
                                   "batch_stats": fs2_vars["batch_stats"]})
    _assert_close_losses(run["losses"], losses, rtol=1e-4)
    _assert_close_grads(run["grads"], {k: v for k, v in grads.items()
                                       if k in run["grads"]})


def test_vocoder_trainer_two_processes_equal_one(corpus, two):
    """Lockstep over 2 GAN steps; step 1 equals one process fed both
    ranks' batches, concatenated (the global batch is batch_size × W)."""
    _, paths, _, _ = corpus
    runs = [r["vocoder"] for r in two]
    _assert_lockstep(runs)
    assert not np.array_equal(runs[0]["y"], runs[1]["y"])  # own utterances
    one = seeded(lambda: VocoderTrainer(load_config(paths["cfg"]), device="cpu"))
    metrics = one.train_step({"y": np.concatenate([runs[0]["y"], runs[1]["y"]])})
    _assert_close_losses(runs[0]["losses"][:1], [metrics])
    for part, model in (("gen", one.gen), ("disc", one.disc)):
        _assert_close_grads(runs[0]["grads"][part],
                            {n: p.grad for n, p in model.named_parameters()
                             if p.grad is not None})


def test_command_under_the_launcher_writes_one_experiment(corpus, tmp_path):
    """``train-rank --device cpu`` under ``torch.distributed.run`` with two
    processes: one experiment directory, written and announced by rank 0."""
    _, paths, _, _ = corpus
    exp_root = tmp_path / "experiments"
    env = dict(os.environ, PYTHONPATH=str(REPO), OMP_NUM_THREADS="1")
    proc = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         "--nproc-per-node", str(WORLD), "-m", "emotts_torch.cli.main",
         "train-rank", "--config", paths["cfg"], "--device", "cpu",
         f"data.experiment_path={exp_root}"],
        cwd=str(REPO), env=env, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout[-3000:] + proc.stderr[-3000:]
    exps = sorted(p.name for p in (exp_root / "rank_model").iterdir())
    assert exps == ["exp_1"]
    exp = exp_root / "rank_model" / "exp_1"
    assert (exp / "best" / "params.pt").exists()
    assert any((exp / "checkpoints").iterdir())
    announced = [ln for ln in proc.stdout.splitlines()
                 if ln.startswith("[train-rank] experiment:")]
    assert len(announced) == 1
    with open(exp / "metrics.jsonl") as f:
        tags = {json.loads(ln)["tag"] for ln in f}
    assert "train/loss" in tags and "valid/loss" in tags
