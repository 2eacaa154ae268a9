"""The port's rank model and loss (emotts_torch/nn/intensity.py,
losses/rank.py, the training mode of nn/blocks.py) held against the JAX
package on the CPU, with the same weights (through rank_from_flax) and the
same mixup weights."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import emotts.ops.attention as fa
from emotts.losses.rank import rank_loss as jax_rank_loss
from emotts_torch.losses.rank import rank_loss
from emotts_torch.nn import blocks
from emotts_torch.nn.convert import rank_from_flax
from emotts_torch.nn.intensity import RankModel
from tests.torch_port_util import (SMALL_RANK, jit, rank_batch, rank_variables,
                                   single_torch_thread)  # noqa: F401

# fp32 on both sides through two FFT blocks; they differ in summation order
TOL = dict(rtol=2e-5, atol=2e-5)


@pytest.fixture(autouse=True)
def _interpret():
    fa._INTERPRET = True
    yield
    fa._INTERPRET = False


def _torch_model(variables, fused, dtype=torch.float32):
    model = RankModel(**SMALL_RANK, fused_attention=fused, dtype=dtype)
    model.load_state_dict(rank_from_flax(variables))  # strict: every key matches
    return model


@pytest.mark.parametrize("fused", [True, False])
def test_rank_model_matches_flax(fused):
    jmodel, variables = rank_variables(seed=1, fused=fused)
    batch = rank_batch(seed=2)
    # jitted: one compilation instead of one per primitive
    want = jit(jmodel.apply)(variables, *(jnp.asarray(a) for a in batch))
    tmodel = _torch_model(variables, fused)
    with torch.no_grad():
        got = tmodel(*(torch.from_numpy(a) for a in batch))
    assert len(got) == len(want) == 8
    for g, w in zip(got, want):
        assert tuple(g.shape) == tuple(w.shape)
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **TOL)
    lengths = batch[3]
    assert got[2].dtype == torch.float32
    # padded frames are zeroed before the classifier: its bias is all they get
    pad = got[2][1, lengths[1]:]
    assert torch.equal(pad, tmodel.intensity_extractor.classifier.bias.expand_as(pad))


def test_rank_model_in_bfloat16_follows_flax():
    """bf16 compute with fp32 parameters: the two frameworks round at other
    places, so this is held loosely; logits come out in fp32."""
    jmodel, variables = rank_variables(seed=1, fused=False, dtype=jnp.bfloat16)
    batch = rank_batch(seed=2)
    want = jit(jmodel.apply)(variables, *(jnp.asarray(a) for a in batch))
    tmodel = _torch_model(variables, False, torch.bfloat16)
    with torch.no_grad():
        got = tmodel(*(torch.from_numpy(a) for a in batch))
    assert got[2].dtype == torch.float32
    for g, w in zip(got[2:], want[2:]):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=5e-2, atol=5e-2)


@pytest.mark.parametrize("weighted", [False, True])
def test_rank_loss_matches_jax(weighted):
    rng = np.random.default_rng(7)
    b, e = 6, 3
    lam = rng.uniform(size=(2, b, 1, 1)).astype(np.float32)
    hi, hj = (rng.standard_normal((b, e)).astype(np.float32) for _ in range(2))
    ri, rj = (rng.standard_normal(b).astype(np.float32) for _ in range(2))
    y = rng.integers(0, e, size=b).astype(np.int32)
    w = np.array([1, 1, 1, 1, 0, 0], np.float32) if weighted else None
    preds = (lam[0], lam[1], None, None, hi, hj, ri, rj)
    want_total, want = jax_rank_loss(
        tuple(None if a is None else jnp.asarray(a) for a in preds),
        jnp.asarray(y), 0.1, 1.0, row_weights=None if w is None else jnp.asarray(w))
    got_total, got = rank_loss(
        tuple(None if a is None else torch.from_numpy(a) for a in preds),
        torch.from_numpy(y), 0.1, 1.0,
        row_weights=None if w is None else torch.from_numpy(w))
    assert set(got) == set(want) == {"loss", "mixup_loss", "rank_loss"}
    for key in want:  # fp32 scalars of a handful of terms
        np.testing.assert_allclose(float(got[key]), float(want[key]), rtol=1e-6)
    np.testing.assert_allclose(float(got_total), float(want_total), rtol=1e-6)


def test_sampled_lambdas_come_from_the_callers_generator():
    _, variables = rank_variables(seed=1)
    model = _torch_model(variables, False)
    emo_x, neu_x, emotions, lengths, _ = (torch.from_numpy(a) for a in rank_batch(2))
    with pytest.raises(ValueError):
        model(emo_x, neu_x, emotions, lengths)  # λ to be drawn, no generator
    outs = []
    for _ in range(2):
        gen = torch.Generator().manual_seed(5)
        with torch.no_grad():
            outs.append(model(emo_x, neu_x, emotions, lengths, mixup_generator=gen))
    lam = outs[0][0]
    assert lam.shape == (4, 1, 1) and float(lam.min()) >= 0.0 and float(lam.max()) < 1.0
    for a, b in zip(*outs):
        assert torch.equal(a, b)


@pytest.mark.parametrize("fused", [True, False])
def test_training_mode_draws_every_mask_from_the_generator(fused):
    _, variables = rank_variables(seed=1, fused=fused)
    model = _torch_model(variables, fused)
    batch = [torch.from_numpy(a) for a in rank_batch(seed=2)]
    with torch.no_grad():
        quiet = model(*batch)
        with pytest.raises(ValueError):
            model(*batch, deterministic=False)  # dropout without a generator
        noisy = [model(*batch, deterministic=False,
                       dropout_generator=torch.Generator().manual_seed(s))
                 for s in (9, 9, 10)]
    state = torch.random.get_rng_state()
    assert torch.equal(noisy[0][2], noisy[1][2])  # same seed, same masks
    assert not torch.equal(noisy[0][2], noisy[2][2])
    assert not torch.equal(noisy[0][2], quiet[2])
    assert torch.equal(state, torch.random.get_rng_state())  # global one untouched


def test_dropout_helper_keeps_the_mean_and_the_rate():
    gen = torch.Generator().manual_seed(0)
    x = torch.ones(200, 500)
    y = blocks.dropout(x, 0.1, gen)
    kept = (y != 0).float().mean().item()
    # 1e5 draws: the standard error of the fraction is 9.5e-4
    assert abs(kept - 0.9) < 4e-3
    np.testing.assert_allclose(y[y != 0].numpy(), 1.0 / 0.9, rtol=1e-6)
    assert blocks.dropout(x, 0.0, None) is x
    seeds = blocks.draw_attention_seeds(5, gen, "cpu")
    assert seeds.dtype == torch.int32 and seeds.shape == (5,)
    d = (seeds[1:].long() - seeds[:-1].long()) % 2 ** 32
    assert torch.equal(d, torch.ones(4, dtype=torch.long))  # base + arange, wrapped
