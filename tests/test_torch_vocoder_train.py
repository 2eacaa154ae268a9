"""The port's vocoder training (emotts_torch/nn/hifigan_disc.py,
losses/gan.py, train/vocoder_trainer.py, the staircase learning rate of
train/state.py::AdamW, nn/convert.py::disc_from_flax / hifigan_to_flax,
infer/synthesize.py::save_vocoder_params_npz) held against the JAX package
on the CPU at toy width.

The JAX references are built from the JAX package's modules, losses and
optax, with parameters from ``jax.eval_shape`` + ``fill_tree`` and every
function jitted through ``tests/torch_port_util.py::jit``; the JAX
``VocoderTrainer`` is never constructed (its flax ``init`` and full
compilation take minutes on the CPU).  The adversarial step is composed as
the JAX trainer composes it (emotts/train/vocoder_trainer.py:260-353), as
tests/test_vocoder_train.py composes it to hold the trainer's own step.

Tolerances: discriminator logits and feature maps 1e-5 (fp32); losses
1e-6 relative; a step's metrics 1e-5 relative, its gradients 1e-4 (the
discriminators') and 2e-4 (the generator's, see
test_train_step_matches_jax) of each one's largest entry; updated
parameters 2e-4, or Adam's bound where the first gradient is at the
rounding level (as tests/test_torch_fs2_training.py holds them)."""

import copy
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import emotts.losses.gan as jgan
import emotts_torch.losses.gan as tgan
import emotts_torch.train.vocoder_trainer as tvt
from emotts.audio.mel import mel_full_jax
from emotts.audio.wavio import write_wav
from emotts.infer.synthesize import load_vocoder_checkpoint as jax_load_vocoder
from emotts.nn.hifigan_disc import MultiPeriodDiscriminator as JaxMPD
from emotts.nn.hifigan_disc import MultiScaleDiscriminator as JaxMSD
from emotts.train import vocoder_trainer as jvt
from emotts.utils.config import Config as JaxConfig
from emotts_torch.nn.convert import disc_from_flax, hifigan_from_flax
from emotts_torch.nn.hifigan_disc import (MultiPeriodDiscriminator,
                                          MultiScaleDiscriminator)
from emotts_torch.train.state import AdamW, staircase_lr
from emotts_torch.utils.config import Config
from tests.torch_port_util import _plain, fill_tree, jit
from tests.torch_port_util import single_torch_thread  # noqa: F401

F32 = jnp.float32


def _tiny(cfg, adversarial=1.0, root=None):
    """The JAX package's vocoder test size (tests/test_vocoder_train.py) on
    a Config of either package."""
    vc = cfg.train_vocoder
    vc.batch_size = 2
    vc.segment_frames = 8
    vc.upsample_initial_channel = 16
    vc.resblock_kernel_sizes = [3]
    vc.resblock_dilations = [[1, 3]]
    vc.disc_channel_mult = 0.05
    vc.mpd_periods = [2, 3]
    vc.msd_scales = 2
    vc.adversarial_weight = adversarial
    vc.compute_dtype = "float32"
    vc.learning_rate = 1e-3
    vc.checkpoint_every_steps = 5
    vc.log_every_steps = 5
    if root is not None:
        cfg.data.corpus_path = os.path.join(root, "corpus")
        cfg.data.experiment_path = os.path.join(root, "experiments")
    return cfg


def _disc_params(model, y, seed):
    """Seeded weights at flax's lecun-normal scale (N(0, 1/fan_in) kernels,
    biases N(0, 0.1²)), so that every layer's activations stay of order 1."""
    template = jax.eval_shape(model.init, jax.random.PRNGKey(0), jnp.asarray(y))
    tree = fill_tree(_plain(template), seed, scale=1.0)

    def scale(node):
        if isinstance(node, dict):
            return {k: (v / np.sqrt(np.prod(v.shape[:-1])) if k == "kernel"
                        else 0.1 * v if k == "bias" else scale(v))
                    for k, v in node.items()}
        return node

    return scale(tree)


def _close(got: torch.Tensor, want, tol=1e-5):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), rtol=tol, atol=tol)


# ---------------------------------------------------------------------------
# (a) the discriminators against flax
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("fold", [(), (3, 5)], ids=["unfolded", "fold_periods"])
def test_mpd_matches_flax(fold):
    """MPD (2, 3, 5) at a length no period divides (reflect padding), with
    and without the TPU's folded layout: every logit and feature map."""
    y = np.random.default_rng(0).standard_normal((2, 1001)).astype(np.float32)
    jmpd = JaxMPD(periods=(2, 3, 5), channel_mult=0.1, fold_periods=fold)
    params = _disc_params(jmpd, y, seed=1)
    outs, feats = jit(jmpd.apply)(params, y)
    mpd = MultiPeriodDiscriminator((2, 3, 5), 0.1, fold_periods=fold)
    mpd.load_state_dict({k[4:]: v for k, v in disc_from_flax(
        {"mpd": params, "msd": {}}).items()})
    got_outs, got_feats = mpd(torch.from_numpy(y))
    assert len(got_outs) == len(outs) == 3
    for g, w in zip(got_outs, outs):
        _close(g, w)
    for gl, wl in zip(got_feats, feats):
        assert len(gl) == len(wl) == 6
        for g, w in zip(gl, wl):
            _close(g.permute(0, 2, 3, 1), w)  # NCHW → the reference's NHWC
    plain = MultiPeriodDiscriminator((2, 3, 5), 0.1)
    plain.load_state_dict(mpd.state_dict())
    for g, w in zip(plain(torch.from_numpy(y))[0], got_outs):
        assert torch.equal(g, w)  # the layout flag changes no number


@pytest.mark.parametrize("merge,dense", [(0, False), (4, False), (0, True)],
                         ids=["grouped", "group_merge_4", "dense_groups"])
def test_msd_matches_flax(merge, dense):
    """MSD, 3 scales at channel_mult 0.25 (the groups stay above 1), with
    the TPU's block-diagonal layouts: every logit and feature map."""
    y = np.random.default_rng(2).standard_normal((2, 1000)).astype(np.float32)
    jmsd = JaxMSD(n_scales=3, channel_mult=0.25, dense_groups=dense, group_merge=merge)
    params = _disc_params(jmsd, y, seed=3)
    outs, feats = jit(jmsd.apply)(params, y)
    msd = MultiScaleDiscriminator(3, 0.25, dense_groups=dense, group_merge=merge)
    msd.load_state_dict({k[4:]: v for k, v in disc_from_flax(
        {"mpd": {}, "msd": params}).items()})
    assert max(d.groups[3] for d in msd.discriminators.values()) == 16
    got_outs, got_feats = msd(torch.from_numpy(y))
    for g, w in zip(got_outs, outs):
        _close(g, w)
    for gl, wl in zip(got_feats, feats):
        assert len(gl) == len(wl) == 8
        for g, w in zip(gl, wl):
            _close(g.transpose(1, 2), w)  # NCW → NWC
    plain = MultiScaleDiscriminator(3, 0.25)
    plain.load_state_dict(msd.state_dict())
    for g, w in zip(plain(torch.from_numpy(y))[0], got_outs):
        assert torch.equal(g, w)


# ---------------------------------------------------------------------------
# (b) the four losses
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_gan_losses_match_jax(dtype):
    """The squares and absolute values reduce in fp32 whatever the
    discriminators' dtype."""
    rng = np.random.default_rng(4)
    outs = [[rng.standard_normal((2, n)).astype(np.float32) for n in (37, 12, 5)]
            for _ in range(2)]
    feats = [[[rng.standard_normal((2, c, 9)).astype(np.float32) for c in (4, 6)]
              for _ in range(3)] for _ in range(2)]
    jdt, tdt = jnp.dtype(dtype), getattr(torch, dtype)
    j = jax.tree.map(lambda a: jnp.asarray(a).astype(jdt), (outs, feats))
    t = jax.tree.map(lambda a: torch.from_numpy(a).to(tdt), (outs, feats))

    def jax_losses(args):
        (ro, fo), (rf, ff) = args
        return (jgan.discriminator_loss(ro, fo), jgan.generator_adversarial_loss(fo),
                jgan.feature_matching_loss(rf, ff),
                jgan.mel_l1_loss(ro[0].astype(F32), fo[0].astype(F32)))

    (ro, fo), (rf, ff) = t
    got = (tgan.discriminator_loss(ro, fo), tgan.generator_adversarial_loss(fo),
           tgan.feature_matching_loss(rf, ff),
           tgan.mel_l1_loss(ro[0].float(), fo[0].float()))
    for g, w in zip(got, jit(jax_losses)(j)):
        assert g.dtype == torch.float32
        np.testing.assert_allclose(g.item(), float(w), rtol=1e-6)


# ---------------------------------------------------------------------------
# (c) one step of train_step against the JAX composition
# ---------------------------------------------------------------------------


def _jax_step(jcfg, gen, mpd, msd):
    """The JAX trainer's step (emotts/train/vocoder_trainer.py:260-353) from
    the JAX package's modules, losses and optax; returns the metrics, both
    gradients and both updated parameter trees."""
    vc, acfg = jcfg.train_vocoder, jcfg.audio
    t_frames = vc.segment_frames
    schedule = optax.exponential_decay(vc.learning_rate, vc.lr_decay_every,
                                       vc.lr_decay, staircase=True)
    tx = optax.adamw(schedule, b1=vc.adam_b1, b2=vc.adam_b2, weight_decay=0.01)

    def device_mel(y, floor="hard"):
        return mel_full_jax(y, acfg, floor=floor)[:, :, :t_frames]

    def disc_all(dp, y):
        op, fp = mpd.apply(dp["mpd"], y)
        os_, fs = msd.apply(dp["msd"], y)
        return op + os_, fp + fs

    def step(gp, dp, y):
        mel_in = device_mel(y).transpose(0, 2, 1)
        mel_soft = device_mel(y, floor="soft")
        if vc.adversarial_weight > 0:
            y_hat, gen_vjp = jax.vjp(lambda g: gen.apply(g, mel_in).astype(F32), gp)
            y_det = jax.lax.stop_gradient(y_hat)

            def d_loss_fn(d):
                return jgan.discriminator_loss(disc_all(d, y)[0], disc_all(d, y_det)[0])

            d_loss, d_grads = jax.value_and_grad(d_loss_fn)(dp)
            d_upd, _ = tx.update(d_grads, tx.init(dp), dp)
            dp1 = optax.apply_updates(dp, d_upd)

            def g_loss(yh):
                l_mel = jgan.mel_l1_loss(device_mel(yh, floor="soft"), mel_soft)
                fake_outs, fake_feats = disc_all(dp1, yh)
                _, real_feats = disc_all(dp1, jax.lax.stop_gradient(y))
                l_adv = jgan.generator_adversarial_loss(fake_outs)
                l_fm = jgan.feature_matching_loss(real_feats, fake_feats)
                total = (vc.mel_loss_weight * l_mel + vc.adversarial_weight * l_adv
                         + vc.feature_loss_weight * l_fm)
                return total, {"mel_l1": l_mel, "g_adv": l_adv,
                               "feature_match": l_fm, "g_total": total}

            (_, parts), dl = jax.value_and_grad(g_loss, has_aux=True)(y_hat)
            (g_grads,) = gen_vjp(dl)
            parts = {"d_loss": d_loss, **parts}
        else:
            def g_loss(g):
                y_hat = gen.apply(g, mel_in).astype(F32)
                l_mel = jgan.mel_l1_loss(device_mel(y_hat, floor="soft"), mel_soft)
                total = vc.mel_loss_weight * l_mel
                return total, {"mel_l1": l_mel, "g_total": total}

            (_, parts), g_grads = jax.value_and_grad(g_loss, has_aux=True)(gp)
            d_grads, dp1 = None, dp
        g_upd, _ = tx.update(g_grads, tx.init(gp), gp)
        return parts, g_grads, d_grads, optax.apply_updates(gp, g_upd), dp1

    return jit(step)


@pytest.fixture(scope="module", params=["adversarial", "mel_only"])
def step_case(request):
    """One step from the same weights and batch on both sides: the JAX
    composition's results and the port trainer's (gen_remat off and on)."""
    adv = 1.0 if request.param == "adversarial" else 0.0
    jcfg, tcfg = _tiny(JaxConfig(), adv), _tiny(Config(), adv)
    vc = jcfg.train_vocoder
    gen = jvt.build_vocoder_generator(jcfg)
    mpd = JaxMPD(tuple(vc.mpd_periods), vc.disc_channel_mult)
    msd = JaxMSD(vc.msd_scales, vc.disc_channel_mult)
    s = vc.segment_frames * jcfg.audio.hop_length
    y = (0.3 * np.random.default_rng(5).standard_normal((vc.batch_size, s))).astype(np.float32)
    key = jax.random.PRNGKey(0)
    gp = fill_tree(_plain(jax.eval_shape(
        gen.init, key, jnp.zeros((1, vc.segment_frames, jcfg.audio.n_mels)))), 6, 0.1)
    dp = {"mpd": _disc_params(mpd, y, 7), "msd": _disc_params(msd, y, 8)}
    want = jax.device_get(_jax_step(jcfg, gen, mpd, msd)(gp, dp, y))
    runs = {}
    for remat in (False, True):
        tcfg.train_vocoder.gen_remat = remat
        trainer = tvt.VocoderTrainer(tcfg, device="cpu")
        trainer.gen.load_state_dict(hifigan_from_flax(gp))
        trainer.disc.load_state_dict(disc_from_flax(dp))
        metrics = trainer.train_step({"y": y})
        runs[remat] = dict(
            metrics=metrics, trainer=trainer,
            g_grads={n: p.grad.clone() for n, p in trainer.gen.named_parameters()},
            d_grads={n: None if p.grad is None else p.grad.clone()
                     for n, p in trainer.disc.named_parameters()})
    return dict(case=request.param, want=want, gp=gp, dp=dp, runs=runs)


def _hold_update(got_sd, start, want, first_grads, lr):
    """Updated parameters: 2e-4, or on both sides within Adam's bound of the
    start where the first gradient is at the rounding level (≤ 1e-6 of the
    model's largest entry): Adam takes a step of up to lr there in the
    direction the rounding picks."""
    largest = max(g.abs().max().item() for g in first_grads.values())
    bound = 3 * lr * (1 + 0.01)
    for name, p in got_sd.items():
        noise = (first_grads[name].abs() <= 1e-6 * largest).numpy()
        got, ref, s0 = p.numpy(), want[name].numpy(), start[name].numpy()
        for side in (got, ref):
            assert np.all(np.abs(side - s0)[noise] <= bound), name
        np.testing.assert_allclose(np.where(noise, 0.0, got), np.where(noise, 0.0, ref),
                                   rtol=0, atol=2e-4, err_msg=name)


def _hold_grads(got, want, rtol):
    for name, g in got.items():
        scale = want[name].abs().max().item()
        err = (g - want[name]).abs().max().item()
        assert err <= rtol * scale, (name, err, scale)


def test_train_step_matches_jax(step_case):
    """Metrics (1e-5 relative); the discriminators' gradients within 1e-4
    of each one's largest entry (a discriminator's .grad holds its own
    loss's gradient alone: the generator's losses took none into it); the
    generator's within 2e-4 (its output bias's gradient is a sum over all
    4096 output samples whose absolute values add up to about 150 times
    the sum: 1.1e-4 of fp32 rounding there, the other entries ≤ 5.8e-5);
    the updated parameters; the mel-only step runs no discriminator."""
    want_metrics, g_grads, d_grads, gp1, dp1 = step_case["want"]
    run = step_case["runs"][False]
    assert run["metrics"].keys() == want_metrics.keys()
    for key, value in want_metrics.items():
        np.testing.assert_allclose(run["metrics"][key], float(value), rtol=1e-5,
                                   err_msg=key)
    _hold_grads(run["g_grads"], hifigan_from_flax(g_grads), 2e-4)
    trainer = run["trainer"]
    lr = 1e-3
    _hold_update(trainer.gen.state_dict(), hifigan_from_flax(step_case["gp"]),
                 hifigan_from_flax(gp1), run["g_grads"], lr)
    if step_case["case"] == "adversarial":
        _hold_grads(run["d_grads"], disc_from_flax(d_grads), 1e-4)
        _hold_update(trainer.disc.state_dict(), disc_from_flax(step_case["dp"]),
                     disc_from_flax(dp1), run["d_grads"], lr)
        assert trainer.state.disc.step == 1
    else:
        assert all(g is None for g in run["d_grads"].values())
        assert trainer.state.disc.step == 0
        for name, p in trainer.disc.state_dict().items():
            assert torch.equal(p, disc_from_flax(step_case["dp"])[name])
    assert trainer.state.step == 1


def test_gen_remat_gives_the_same_bits(step_case):
    a, b = step_case["runs"][False], step_case["runs"][True]
    assert a["metrics"] == b["metrics"]
    for name in a["g_grads"]:
        assert torch.equal(a["g_grads"][name], b["g_grads"][name]), name
    for x, y in ((a["trainer"].gen, b["trainer"].gen), (a["trainer"].disc, b["trainer"].disc)):
        for (name, p), q in zip(x.state_dict().items(), y.state_dict().values()):
            assert torch.equal(p, q), name


# ---------------------------------------------------------------------------
# (d) the samplers, (e) the schedule
# ---------------------------------------------------------------------------


def test_samplers_give_jax_batches(tmp_path):
    sr, hop = 16000, 256
    rng = np.random.default_rng(9)
    paths = []
    for i, n in enumerate((5000, 1500, 9000)):  # the second is shorter than a segment
        p = str(tmp_path / f"u{i}.wav")
        write_wav(p, (0.3 * rng.standard_normal(n)).astype(np.float32), sr)
        paths.append(p)
    jax_s = jvt.SegmentSampler(paths, sr, 8 * hop, seed=11)
    port_s = tvt.SegmentSampler(paths, sr, 8 * hop, seed=11)
    for _ in range(3):
        np.testing.assert_array_equal(port_s.batch(4), jax_s.batch(4))
    pairs = [(rng.standard_normal((n, 80)).astype(np.float32),
              rng.standard_normal(n * hop + 17).astype(np.float32)) for n in (20, 5, 33)]
    jax_p = jvt.PairedSegmentSampler(pairs, 8, hop, mel_floor=-11.5, seed=12)
    port_p = tvt.PairedSegmentSampler(pairs, 8, hop, mel_floor=-11.5, seed=12)
    for _ in range(3):
        got, want = port_p.batch(4), jax_p.batch(4)
        assert got.keys() == want.keys()
        for key in want:
            np.testing.assert_array_equal(got[key], want[key])
    assert port_p.pairs[1][0][5:].min() == np.float32(-11.5)  # the padded short pair


@pytest.mark.parametrize("n", [0, 999, 1000, 2500])
def test_staircase_learning_rate_equals_optax(n):
    """The update after ``n`` earlier ones uses lr · 0.999^⌊n/1000⌋, as
    optax.adamw(exponential_decay(..., staircase=True)) does."""
    schedule = optax.exponential_decay(2e-4, 1000, 0.999, staircase=True)
    assert staircase_lr(2e-4, 0.999, 1000, n) == float(schedule(n))
    rng = np.random.default_rng(n)
    p0, g = (rng.standard_normal(8).astype(np.float32) for _ in range(2))
    tx = optax.adamw(schedule, b1=0.8, b2=0.99, weight_decay=0.01)
    state = jax.tree.map(lambda x: jnp.full_like(x, n) if x.dtype == jnp.int32 else x,
                         tx.init(jnp.asarray(p0)))
    upd, _ = tx.update(jnp.asarray(g), state, jnp.asarray(p0))
    param = torch.nn.Parameter(torch.from_numpy(p0.copy()))
    opt = AdamW([param], lr=2e-4, weight_decay=0.01, betas=(0.8, 0.99),
                lr_decay_every=1000, lr_decay=0.999)
    opt.param_groups[0]["count"] = n
    param.grad = torch.from_numpy(g)
    opt.step()
    np.testing.assert_allclose(param.detach().numpy(), np.asarray(p0 + upd),
                               rtol=1e-6, atol=1e-9)


# ---------------------------------------------------------------------------
# (f) fit → resume → export
# ---------------------------------------------------------------------------


def _same_bits(a, b):
    if isinstance(a, dict):
        return a.keys() == b.keys() and all(_same_bits(a[k], b[k]) for k in a)
    if isinstance(a, (list, tuple)):
        return len(a) == len(b) and all(_same_bits(x, y) for x, y in zip(a, b))
    if isinstance(a, torch.Tensor):
        return a.dtype == b.dtype and torch.equal(a, b)
    return a == b


def test_fit_resume_export(tmp_path, monkeypatch):
    """fit writes metrics, checkpoints and vocoder.npz; a resume restores
    both states and seeds the sampler at seed + step; the JAX package's
    load_vocoder_checkpoint reads the export, and its generator on it gives
    the port's waveform."""
    cfg = _tiny(Config(), root=str(tmp_path))
    sr = cfg.audio.sampling_rate
    os.makedirs(os.path.join(cfg.data.corpus_path, "spk"))
    t = np.arange(int(0.4 * sr)) / sr
    for i in range(3):
        write_wav(os.path.join(cfg.data.corpus_path, "spk", f"amused_{i:04d}.wav"),
                  (0.4 * np.sin(2 * np.pi * (150 + 60 * i) * t)).astype(np.float32), sr)
    trainer = tvt.VocoderTrainer(cfg, device="cpu")
    start = copy.deepcopy(trainer.state.state_dict())
    exp = trainer.fit(n_steps=1)
    assert exp.endswith("exp_1") and os.path.isfile(os.path.join(exp, "vocoder.npz"))
    saved = copy.deepcopy(trainer.state.state_dict())
    assert not _same_bits(saved["gen"]["model"], start["gen"]["model"])
    assert not _same_bits(saved["disc"]["model"], start["disc"]["model"])

    seeds = []

    class Recording(tvt.SegmentSampler):
        def __init__(self, *args, seed=0):
            seeds.append(seed)
            super().__init__(*args, seed=seed)

    monkeypatch.setattr(tvt, "SegmentSampler", Recording)
    fresh = tvt.VocoderTrainer(cfg, device="cpu")
    assert fresh.restore(exp) and _same_bits(fresh.state.state_dict(), saved)
    fresh.fit(n_steps=2, exp_path=exp, resume=True)
    assert seeds == [cfg.train_vocoder.seed + 1]
    assert fresh.state.step == fresh.state.disc.step == 2
    assert fresh.state.gen.optimizer.param_groups[0]["count"] == 2
    assert sorted(os.listdir(os.path.join(exp, "checkpoints"))) == ["step_1.pt", "step_2.pt"]
    tags = {line.split('"tag": "')[1].split('"')[0]
            for line in open(os.path.join(exp, "metrics.jsonl"))}
    assert tags == {"train/d_loss", "train/mel_l1", "train/g_adv", "train/feature_match",
                    "train/g_total"} | ({"train/step_time_s"} & tags)

    jcfg = _tiny(JaxConfig())
    params = jax_load_vocoder(os.path.join(exp, "vocoder.npz"), jcfg)
    mel = np.random.default_rng(13).standard_normal((1, 12, 80)).astype(np.float32)
    want = jit(jvt.build_vocoder_generator(jcfg).apply)(params, mel)
    with torch.no_grad():
        got = fresh.gen(torch.from_numpy(mel))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)
