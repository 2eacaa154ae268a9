"""The port's neural G2P training mirror (emotts_torch/text/neural_g2p.py:
G2PTransformer, batched_greedy_decode), its schedule and optimizer
(emotts_torch/train/state.py) and its trainer (emotts_torch/text/g2p_train.py,
tools/train_g2p_torch.py) against the JAX package's mirror
(emotts/text/neural_g2p.py: jax_forward, jax_batched_greedy_decode), optax,
tools/train_g2p.py and the numpy decoders, at toy widths on the CPU."""

import importlib.util
import shutil
from pathlib import Path
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from emotts.text import g2p as jax_g2p
from emotts.text import neural_g2p as jng
from emotts_torch.text import g2p as torch_g2p
from emotts_torch.text import g2p_train as gt
from emotts_torch.text import neural_g2p as tng
from emotts_torch.train.state import AdamW, warmup_cosine_lr
from tests.torch_port_util import FAST_COMPILE, jit, single_torch_thread  # noqa: F401

REPO = Path(__file__).resolve().parent.parent
WORDS = ["a", "it's", "parity", "checking", "zyzzyva",
         "abcdefghijklmnopqrstuvwxyzab", "hello", "quixotry"]
HEADS = 4
RATE = 0.2
# base words of the cut lexicons (seeded samples of the bundled one): the
# pairs' and the trainer's, and the tool's
CUT_WORDS = 300
TOOL_WORDS = 20


def _tool_module(name, path):
    spec = importlib.util.spec_from_file_location(name, path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@pytest.fixture(scope="module")
def tiny():
    return jng.init_params(5, d_model=32, d_ff=64, n_enc=2, n_dec=2)


@pytest.fixture(scope="module")
def batch():
    """Padded words of several lengths and decoder inputs drawn from a seed."""
    chars = np.stack([jng.encode_word(w) for w in WORDS])
    rng = np.random.default_rng(7)
    phon = rng.integers(3, jng.N_PHON_TOKENS, (len(WORDS), jng.MAX_PHON_LEN))
    phon[:, 0] = jng.PHON_BOS
    return chars, phon.astype(np.int32)


@pytest.fixture(scope="module")
def jax_forward():
    """``jax_forward`` compiled once per head count and rate."""
    return jit(jng.jax_forward, static_argnames=("n_heads", "dropout_rate"))


def _port(p, chars, phon, heads=HEADS, **kw):
    model = tng.G2PTransformer.from_flat(p, heads, device="cpu")
    return model(torch.from_numpy(chars).long(), torch.from_numpy(phon).long(),
                 **kw).detach().numpy()


def _close_to_largest(got, want, rel):
    err = np.abs(got - want).max()
    assert err <= rel * np.abs(want).max(), (err, np.abs(want).max())


# ---------------------------------------------------------------------------
# forward
# ---------------------------------------------------------------------------


def test_forward_matches_jax_forward(tiny, batch, jax_forward):
    chars, phon = batch
    want = np.asarray(jax_forward(tiny, chars, phon, n_heads=HEADS))
    got = _port(tiny, chars, phon)
    assert got.shape == (len(WORDS), jng.MAX_PHON_LEN, jng.N_PHON_TOKENS)
    _close_to_largest(got, want, 1e-5)


def test_forward_matches_jax_forward_at_the_bundled_weights(jax_forward):
    """d 256, 3 + 3 layers, 8 heads: four words teacher-forced over their
    numpy greedy outputs."""
    p, heads = gt.load_weights(jng.BUNDLED_WEIGHTS)
    words = ["parity", "checking", "zyzzyva", "blorptastic"]
    chars = np.stack([jng.encode_word(w) for w in words])
    phon = np.zeros((len(words), jng.MAX_PHON_LEN), np.int32)
    for i, c in enumerate(chars):
        out = [jng.PHON_BOS] + jng.np_greedy_decode(p, c, heads)
        phon[i, :len(out)] = out
    want = np.asarray(jax_forward(p, chars, phon, n_heads=heads))
    got = _port(p, chars, phon, heads)
    _close_to_largest(got, want, 2e-5)
    assert (got.argmax(-1) == want.argmax(-1)).all()


# ---------------------------------------------------------------------------
# dropout
# ---------------------------------------------------------------------------


def test_dropout_same_generator_seed_same_output(tiny, batch):
    chars, phon = batch
    outs = [_port(tiny, chars, phon, dropout_rate=RATE,
                  generator=torch.Generator().manual_seed(seed))
            for seed in (3, 3, 4)]
    np.testing.assert_array_equal(outs[0], outs[1])
    assert not np.array_equal(outs[0], outs[2])
    assert not np.allclose(outs[0], _port(tiny, chars, phon))


def test_dropout_keeps_its_share_at_each_of_the_seven_sites(tiny, batch, monkeypatch):
    """Both embeddings, per encoder layer the attention probabilities, the
    attention output, the FFN's GELU output and its output, per decoder
    layer those of both attentions and of the FFN: 2 + 2·4 + 2·6 masks,
    each keeping 1 − rate of its entries within 3σ."""
    masks = []
    draw = tng._keep_mask

    def record(shape, rate, generator, device):
        masks.append(draw(shape, rate, generator, device))
        return masks[-1]

    monkeypatch.setattr(tng, "_keep_mask", record)
    chars, phon = batch
    _port(tiny, chars, phon, dropout_rate=RATE, generator=torch.Generator().manual_seed(1))
    assert len(masks) == 2 + 2 * 4 + 2 * 6
    b, tw, tp, d = len(WORDS), jng.MAX_WORD_LEN, jng.MAX_PHON_LEN, 32
    assert masks[0].shape == (b, tw, d)
    assert masks[1].shape == (b, HEADS, tw, tw)  # the encoder's probabilities
    assert masks[3].shape == (b, tw, 64)  # the FFN's GELU output
    for m in masks:
        n = m.numel()
        kept = m.float().mean().item()
        assert abs(kept - (1 - RATE)) <= 3 * np.sqrt(RATE * (1 - RATE) / n), (m.shape, kept)


def test_dropout_with_every_mask_kept_matches_jax_forward(tiny, batch, jax_forward,
                                                          monkeypatch):
    """With every mask kept, dropout leaves only its 1 / (1 − rate) scaling
    at the seven sites: the port and the JAX mirror with its Bernoulli draws
    all kept give the same logits, as they do at rate 0."""
    chars, phon = batch
    monkeypatch.setattr(tng, "_keep_mask",
                        lambda shape, rate, gen, device: torch.ones(shape, dtype=torch.bool))
    monkeypatch.setattr(jax.random, "bernoulli",
                        lambda key, p, shape: jnp.ones(shape, bool))
    want = np.asarray(jit(lambda p, c, q, key: jng.jax_forward(
        p, c, q, dropout_rate=RATE, rng=key, n_heads=HEADS))(
            tiny, chars, phon, jax.random.PRNGKey(0)))
    got = _port(tiny, chars, phon, dropout_rate=RATE, generator=torch.Generator())
    _close_to_largest(got, want, 1e-5)
    assert not np.allclose(got, _port(tiny, chars, phon))


# ---------------------------------------------------------------------------
# loss gradients, schedule, optimizer
# ---------------------------------------------------------------------------


def _jax_loss_fn(smooth, heads, rate=0.0):
    """tools/train_g2p.py's loss_fn."""
    def loss_fn(p, c, di, tg, rng=None):
        logits = jng.jax_forward(p, c, di, dropout_rate=rate, rng=rng, n_heads=heads)
        mask = (tg != jng.PHON_PAD).astype(jnp.float32)
        logp = jax.nn.log_softmax(logits, axis=-1)
        nll = -jnp.take_along_axis(logp, tg[..., None], axis=-1)[..., 0]
        uni = -logp.mean(-1)
        ce = (1.0 - smooth) * nll + smooth * uni
        return (ce * mask).sum() / mask.sum()
    return loss_fn


def test_loss_gradients_match_jax_grad():
    """Label smoothing 0.1, rate 0, 1 + 1 layers: every gradient within 1e-4
    of its own largest entry."""
    tiny = jng.init_params(6, d_model=32, d_ff=64, n_enc=1, n_dec=1)
    pairs = [(w, ["HH", "AH0", "L", "OW1"][: 1 + i % 4]) for i, w in enumerate(WORDS)]
    chars, dec_in, targets = gt.vectorize(pairs)
    loss, grads = jit(jax.value_and_grad(_jax_loss_fn(0.1, HEADS)))(
        tiny, chars, dec_in, targets)
    model = tng.G2PTransformer.from_flat(tiny, HEADS, device="cpu")
    got = gt.g2p_loss(model(*(torch.from_numpy(a).long() for a in (chars, dec_in))),
                      torch.from_numpy(targets).long(), 0.1)
    got.backward()
    np.testing.assert_allclose(got.item(), float(loss), rtol=1e-6)
    for name, g in grads.items():
        g = np.asarray(g)
        err = np.abs(model.params[name].grad.numpy() - g).max()
        assert err <= 1e-4 * np.abs(g).max(), (name, err, np.abs(g).max())


@pytest.mark.parametrize("warmup,total", [(0, 7), (3, 40), (200, 5680)])
def test_warmup_cosine_lr_matches_optax(warmup, total):
    """At every update count up to total + 2, within 1e-6 of the peak: the
    fp32 arithmetic in optax's order (JAX's own jitted and eager
    evaluations of the schedule differ by up to 1.5e-7 of the peak)."""
    peak = 1e-3
    sched = optax.warmup_cosine_decay_schedule(0.0, peak, warmup, total)
    counts = jnp.arange(total + 3, dtype=jnp.int32)
    want = np.asarray(jax.jit(jax.vmap(sched))(counts))
    got = np.array([warmup_cosine_lr(n, peak, warmup, total) for n in range(total + 3)])
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6 * peak)
    assert got[0] == (np.float32(peak) if warmup == 0 else 0.0) and got[-1] == 0.0


def test_adamw_with_the_schedule_matches_optax_adamw(tiny):
    """Three updates of ``AdamW(weight_decay=1e-4, lr_schedule=...)`` from
    one state against ``optax.adamw(sched, weight_decay=1e-4)`` on the same
    gradients: every parameter (embeddings and norms included) within 1e-6.
    The optax side updates the parameters as one flat vector: its arithmetic
    is per element, and one leaf compiles in a fraction of the time."""
    warmup, total, peak = 2, 10, 1e-2
    sched = optax.warmup_cosine_decay_schedule(0.0, peak, warmup, total)
    rng = np.random.default_rng(2)
    grads = [{k: rng.standard_normal(v.shape).astype(np.float32) for k, v in tiny.items()}
             for _ in range(3)]
    opt = optax.adamw(sched, weight_decay=1e-4)

    @jit
    def update(params, state, g):
        updates, state = opt.update(g, state, params)
        return optax.apply_updates(params, updates), state

    names = sorted(tiny)
    flat = lambda tree: np.concatenate([tree[k].ravel() for k in names])  # noqa: E731
    params = flat(tiny)
    state = opt.init(params)
    for g in grads:
        params, state = update(params, state, flat(g))
    sizes = np.cumsum([tiny[k].size for k in names])[:-1]
    params = {k: v.reshape(tiny[k].shape)
              for k, v in zip(names, np.split(np.asarray(params), sizes))}
    model = tng.G2PTransformer.from_flat(tiny, HEADS, device="cpu")
    port = AdamW(model.parameters(), lr=peak, weight_decay=1e-4,
                 lr_schedule=lambda n: warmup_cosine_lr(n, peak, warmup, total))
    for g in grads:
        for k, p in model.params.items():
            p.grad = torch.from_numpy(g[k])
        port.step()
    for k, v in params.items():
        np.testing.assert_allclose(model.params[k].detach().numpy(), np.asarray(v),
                                   rtol=0, atol=1e-6, err_msg=k)
        assert not np.array_equal(np.asarray(v), tiny[k])


# ---------------------------------------------------------------------------
# batched greedy decode
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def bundled_first_layers():
    """The bundled weights cut to their first encoder and decoder layer (d
    256, 8 heads): trained weights whose rows end in EOS at several lengths,
    as random toy weights' rows do not, at a third of the full depth's cost."""
    p, heads = gt.load_weights(jng.BUNDLED_WEIGHTS)
    return {k: v for k, v in p.items()
            if not (k[:3] in ("enc", "dec") and k[3].isdigit() and k[3] != "0")}, heads


@pytest.mark.parametrize("case", ["single", "ensemble", "chunked"])
def test_batched_greedy_decode_matches_jax_and_numpy(case, bundled_first_layers, tiny,
                                                     monkeypatch):
    """Id for id against jax_batched_greedy_decode and the numpy decoders:
    one member (8 heads), an ensemble of it and a toy member with 4 heads,
    and the one member in chunks of 2 (a padded tail chunk)."""
    words = ["a", "it's", "parity", "checking", "zyzzyva"]
    chars = np.stack([jng.encode_word(w) for w in words])
    p, heads = bundled_first_layers
    if case == "ensemble":
        members, heads = [p, tiny], [heads, HEADS]
        want_np = [jng.np_ensemble_greedy_decode(members, c, heads) for c in chars]
    else:
        members = p
        want_np = [jng.np_greedy_decode(p, c, heads) for c in chars]
    got = tng.batched_greedy_decode(members, chars, heads, device="cpu",
                                    chunk=2 if case == "chunked" else 512)
    assert got.dtype == np.int32 and got.shape == (len(words), jng.MAX_PHON_LEN - 1)
    if case != "chunked":  # the JAX mirror's chunk is its own (512)
        real_jit = jax.jit
        monkeypatch.setattr(jax, "jit", lambda fn, **kw: real_jit(
            fn, compiler_options=FAST_COMPILE, **kw))
        np.testing.assert_array_equal(got, jng.jax_batched_greedy_decode(members, chars, heads))
    for row, want in zip(got, want_np):
        n = len(want)
        assert 0 < n and list(row[:n]) == want
        assert row[n] == jng.PHON_EOS and (row[n + 1:] == jng.PHON_PAD).all()


# ---------------------------------------------------------------------------
# pairs
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def lexicons(tmp_path_factory):
    """Seeded samples of the bundled lexicon's entries, by size: each, while
    a test holds ``monkeypatch`` with it, both packages' bundled lexicon."""
    lines = [ln for ln in Path(torch_g2p.BUNDLED_LEXICON).read_text(
        errors="ignore").splitlines() if ln.strip() and not ln.startswith(";;;")]
    root = tmp_path_factory.mktemp("g2p_lexicon")
    paths = {}
    for n in (CUT_WORDS, TOOL_WORDS):
        pick = np.random.default_rng(4).permutation(len(lines))[:n]
        paths[n] = root / f"lexicon_{n}.dict"
        paths[n].write_text("\n".join(lines[i] for i in sorted(pick)) + "\n")
    return {n: str(p) for n, p in paths.items()}


def _use_lexicon(monkeypatch, path):
    monkeypatch.setattr(jax_g2p, "BUNDLED_LEXICON", path)
    monkeypatch.setattr(torch_g2p, "BUNDLED_LEXICON", path)


@pytest.fixture(scope="module")
def cut_pairs(lexicons):
    with pytest.MonkeyPatch.context() as m:
        _use_lexicon(m, lexicons[CUT_WORDS])
        return gt.build_pairs(seed=0, holdout_frac=0.1)


def test_build_pairs_and_vectorize_match_the_jax_tool(lexicons, cut_pairs, monkeypatch):
    _use_lexicon(monkeypatch, lexicons[CUT_WORDS])
    tool = _tool_module("train_g2p", REPO / "tools" / "train_g2p.py")
    want = tool.build_pairs(seed=0, holdout_frac=0.1)
    assert cut_pairs == want
    train, held = cut_pairs
    assert len(train) > 4 * CUT_WORDS // 2 and len(held) > 0
    assert any(w not in torch_g2p.G2P(neural=False).lexicon for w, _ in train)
    for got, ref in zip(gt.vectorize(train), tool.vectorize(train)):
        np.testing.assert_array_equal(got, ref)


# ---------------------------------------------------------------------------
# training
# ---------------------------------------------------------------------------


def _args(out, **kw):
    args = dict(d_model=32, d_ff=64, layers=1, heads=2, batch=8, epochs=2,
                lr=1e-3, dropout=0.0, label_smoothing=0.1, swa_frac=0.25,
                holdout=0.1, seed=0, init_seed=None, checkpoint_every=0,
                resume_from=None, out=str(out), device="cpu")
    args.update(kw)
    return SimpleNamespace(**args)


def test_two_epochs_match_the_jax_composition(cut_pairs, tmp_path):
    """Rate 0 on 64 pairs, batch 8: each of the 16 steps' losses against
    jax_forward + optax.adamw(warmup-cosine) on the same batches, within
    1e-5 relative."""
    pairs = (cut_pairs[0][:64], cut_pairs[1])
    args = _args(tmp_path / "g.npz", init_seed=3)
    history = []
    gt.train(args, pairs=pairs, history=history)
    got = np.concatenate([h["losses"] for h in history])

    chars, dec_in, targets = gt.vectorize(pairs[0])
    total = 8 * args.epochs
    opt = optax.adamw(optax.warmup_cosine_decay_schedule(
        0.0, args.lr, min(200, total // 10), total), weight_decay=1e-4)
    params = {k: jnp.asarray(v) for k, v in jng.init_params(
        3, d_model=32, d_ff=64, n_enc=1, n_dec=1).items()}
    state = opt.init(params)
    loss_fn = _jax_loss_fn(args.label_smoothing, args.heads)

    @jit
    def step(p, s, c, di, tg):
        loss, g = jax.value_and_grad(loss_fn)(p, c, di, tg)
        updates, s = opt.update(g, s, p)
        return optax.apply_updates(p, updates), s, loss

    rng = np.random.default_rng(3 + 1)
    want = []
    for _ in range(args.epochs):
        perm = rng.permutation(64).reshape(8, 8)
        for idx in perm:
            params, state, loss = step(params, state, chars[idx], dec_in[idx], targets[idx])
            want.append(float(loss))
    assert len(got) == 16 and np.isfinite(got).all()
    np.testing.assert_allclose(got, want, rtol=1e-5)


def test_swa_averages_the_epoch_ends_and_resume_is_bit_identical(cut_pairs, tmp_path):
    """Dropout on, SWA over every epoch: a run of 2 epochs that checkpoints
    after the first; the SWA weights are the mean of the two epoch ends;
    a fresh trainer resuming from the checkpoint ends on the same bits."""
    pairs = (cut_pairs[0][:64], cut_pairs[1])
    args = _args(tmp_path / "g.npz", dropout=RATE, swa_frac=1.0, checkpoint_every=1)
    final, swa, _, _ = gt.train(args, pairs=pairs)
    ckpt = tmp_path / "g.resume.npz"
    first = {k[len("param."):]: v for k, v in np.load(ckpt).items() if k.startswith("param.")}
    assert set(first) == set(final)
    for k in final:
        np.testing.assert_array_equal(swa[k], ((first[k] + final[k]) / 2).astype(np.float32))
    kept = tmp_path / "epoch1.npz"
    shutil.copy(ckpt, kept)
    resumed, swa_resumed, _, _ = gt.train(
        _args(tmp_path / "h.npz", dropout=RATE, swa_frac=1.0, resume_from=str(kept)),
        pairs=pairs)
    for k in final:
        np.testing.assert_array_equal(resumed[k], final[k], err_msg=k)
        np.testing.assert_array_equal(swa_resumed[k], swa[k], err_msg=k)


def test_resume_refuses_a_checkpoint_of_other_hyperparameters(cut_pairs, tmp_path):
    pairs = (cut_pairs[0][:16], cut_pairs[1])
    gt.train(_args(tmp_path / "g.npz", checkpoint_every=1), pairs=pairs)
    with pytest.raises(SystemExit, match="REFUSING"):
        gt.train(_args(tmp_path / "g.npz", checkpoint_every=1, lr=2e-3), pairs=pairs)


# ---------------------------------------------------------------------------
# the tool
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def tool():
    return _tool_module("train_g2p_torch", REPO / "tools" / "train_g2p_torch.py")


def test_tool_writes_weights_both_packages_decode_alike(tool, lexicons, tmp_path,
                                                        monkeypatch, capsys):
    """``--device cpu`` at toy widths on the cut lexicon: the better of the
    last iterate and SWA on the held-out subsample is saved, with its
    metrics, and both packages' NeuralG2P decode it alike."""
    _use_lexicon(monkeypatch, lexicons[TOOL_WORDS])
    out = tmp_path / "g2p.npz"
    rc = tool.main(["--device", "cpu", "--out", str(out), "--epochs", "3",
                    "--d-model", "32", "--d-ff", "64", "--layers", "1",
                    "--heads", "2", "--batch", "32", "--lr", "1e-2",
                    "--dropout", "0", "--swa-frac", "0.5"])
    assert rc == 0
    log = capsys.readouterr().out
    scores = {name: float(log.split(f"[held-out sub ({name})]")[1].split("exact ")[1].split()[0])
              for name in ("final", "swa")}
    selected = log.split("selected: ")[1].split()[0]
    assert scores[selected] == max(scores.values())
    data = np.load(out)
    assert int(data["__n_heads__"][0]) == 2 and "__eval_exact__" in data.files
    assert not out.with_suffix(".unevaluated.npz").exists()
    words = ["zembla", "blorptastic", "crystalline", "it's", "a"]
    jax_side, port_side = jng.NeuralG2P(str(out)), tng.NeuralG2P(str(out))
    decoded = [port_side.word_to_phonemes(w) for w in words]
    assert decoded == [jax_side.word_to_phonemes(w) for w in words]
    assert any(decoded)


def test_tool_refuses_the_host_unless_asked_and_the_jax_package(tool, tmp_path, capsys):
    if not torch.cuda.is_available():
        assert tool.main(["--out", str(tmp_path / "g.npz")]) == 2
        assert "--device cpu" in capsys.readouterr().err
    assert tool.main(["--device", "cpu", "--out",
                      str(REPO / "emotts" / "text" / "data" / "x.npz")]) == 2
    assert "emotts/" in capsys.readouterr().err
    assert not (REPO / "emotts" / "text" / "data" / "x.npz").exists()
