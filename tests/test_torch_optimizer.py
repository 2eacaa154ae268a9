"""The port's AdamW (emotts_torch/train/state.py) held against the JAX
package's make_optimizer on the CPU: the same seeded parameters and
gradients, moments starting at zero on both sides, five steps."""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from emotts.train.state import make_optimizer as jax_make_optimizer
from emotts.utils.config import TrainConfig as JaxTrainConfig
from emotts_torch.train.state import AdamW, TrainState, make_optimizer
from emotts_torch.utils.config import TrainConfig
from tests.torch_port_util import single_torch_thread  # noqa: F401

SHAPES = {"w": (7, 5), "b": (5,), "conv": (4, 3, 3)}
STEPS = 5


def _tree(seed, scale):
    rng = np.random.default_rng(seed)
    return {k: (scale * rng.standard_normal(s)).astype(np.float32)
            for k, s in SHAPES.items()}


# fp32 moments: the same fp32 arithmetic in the same order; a step is
# lr·O(1) = 1e-2, an fp32 ulp of the parameters is 1e-7.  bf16 moments: the
# stored moments round to bf16 on both sides; where the two fp32 values
# before that rounding differ in the last bit they may land on neighbouring
# bf16 values (2^-8 relative), which moves one step by up to 1e-2 · 2^-8.
@pytest.mark.parametrize("moment_dtype,atol", [("float32", 2e-7), ("bfloat16", 2e-4)])
def test_adamw_matches_the_reference_over_five_steps(moment_dtype, atol):
    lr, wd = 1e-2, 1e-2
    params0 = _tree(0, 0.5)
    grads = [_tree(10 + i, 1.0 / (1 + i)) for i in range(STEPS)]

    jcfg = JaxTrainConfig(learning_rate=lr, weight_decay=wd, moment_dtype=moment_dtype)
    tx = jax_make_optimizer(jcfg)
    jparams = jax.tree.map(jnp.asarray, params0)
    opt_state = tx.init(jparams)
    for g in grads:
        updates, opt_state = tx.update(jax.tree.map(jnp.asarray, g), opt_state, jparams)
        jparams = optax.apply_updates(jparams, updates)

    tcfg = TrainConfig(learning_rate=lr, weight_decay=wd, moment_dtype=moment_dtype)
    tparams = {k: torch.nn.Parameter(torch.from_numpy(v.copy()))
               for k, v in params0.items()}
    opt = make_optimizer(tcfg, tparams.values())
    for g in grads:
        for k, p in tparams.items():
            p.grad = torch.from_numpy(g[k].copy())
        opt.step()

    for k in SHAPES:
        np.testing.assert_allclose(tparams[k].detach().numpy(), np.asarray(jparams[k]),
                                   rtol=0, atol=atol)
        state = opt.state[tparams[k]]
        assert state["mu"].dtype == state["nu"].dtype == getattr(torch, moment_dtype)
    # the moments themselves, against the reference's stored ones
    adam = opt_state[0]
    for k in SHAPES:
        for mine, theirs in ((opt.state[tparams[k]]["mu"], adam.mu[k]),
                             (opt.state[tparams[k]]["nu"], adam.nu[k])):
            np.testing.assert_allclose(
                mine.float().numpy(), np.asarray(theirs.astype(jnp.float32)),
                rtol=2 ** -7 if moment_dtype == "bfloat16" else 1e-6,
                # a moment near zero, where b·m and (1−b)·g cancel, differs by
                # an fp32 ulp of those terms (|g| ≤ 4: 2e-8 after the 0.1 weight)
                atol=2e-8)


def test_adamw_is_not_torch_adamw_at_bf16_moments_but_close_at_fp32():
    """The reference's order (update, then decay, then the step) differs from
    torch.optim.AdamW's (decay first, corrections folded into the step size)
    only in rounding at fp32 moments."""
    params0, g = _tree(0, 0.5), _tree(1, 1.0)
    mine = {k: torch.nn.Parameter(torch.from_numpy(v.copy())) for k, v in params0.items()}
    ref = {k: torch.nn.Parameter(torch.from_numpy(v.copy())) for k, v in params0.items()}
    a = AdamW(mine.values(), lr=1e-2, weight_decay=1e-2)
    b = torch.optim.AdamW(ref.values(), lr=1e-2, weight_decay=1e-2)
    for _ in range(3):
        for k in SHAPES:
            mine[k].grad = torch.from_numpy(g[k].copy())
            ref[k].grad = torch.from_numpy(g[k].copy())
        a.step()
        b.step()
    for k in SHAPES:  # decoupled decay applied to p before or after the step: O(lr²·wd)
        np.testing.assert_allclose(mine[k].detach().numpy(), ref[k].detach().numpy(),
                                   rtol=0, atol=1e-5)
    with pytest.raises(ValueError):
        a.step(closure=lambda: 0.0)


@pytest.mark.parametrize("moment_dtype", ["float32", "bfloat16"])
def test_train_state_round_trip_keeps_moments_count_and_generators(moment_dtype):
    def make():
        model = torch.nn.Linear(4, 3)
        cfg = TrainConfig(learning_rate=1e-2, moment_dtype=moment_dtype)
        return TrainState(model, make_optimizer(cfg, model.parameters()), 3, "cpu")

    def step(state, x):
        lam = torch.rand(5, 4, generator=state.generators["mixup"])
        loss = (state.model(x * lam) ** 2).mean()
        state.optimizer.zero_grad()
        loss.backward()
        state.optimizer.step()
        state.step += 1
        return loss.item()

    x = torch.from_numpy(np.random.default_rng(0).standard_normal((5, 4)).astype(np.float32))
    a = make()
    for _ in range(3):
        step(a, x)
    saved = copy.deepcopy(a.state_dict())  # a checkpoint file is a copy too
    want = [step(a, x) for _ in range(2)]
    b = make()
    b.load_state_dict(saved)
    assert b.step == 3
    moments = [st["mu"] for st in b.optimizer.state.values()]
    assert moments and all(m.dtype == getattr(torch, moment_dtype) for m in moments)
    assert [step(b, x) for _ in range(2)] == want  # same moments, count and λ stream
    for p, q in zip(a.model.parameters(), b.model.parameters()):
        assert torch.equal(p, q)
