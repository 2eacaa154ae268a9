"""Train state (step, model, optimizer, generators) and the optimizer.

Counterpart of ``emotts/train/state.py``.  The whole state checkpoints —
parameters, optimizer moments, the step counter and the states of the random
generators — so that training is exactly resumable: a resumed run continues
the same random streams.  The reference's ``batch_stats`` (BatchNorm running
statistics) are buffers of the model here, so they travel with its
``state_dict`` into checkpoints and the ``best/`` export.  Under tensor
parallelism a checkpoint holds the full tensors, parameters and moments
alike, whatever the model axis it was written at, and every rank restores
its slices (``parallel.tp``).
"""

from __future__ import annotations

from typing import Dict, Iterable, Optional

import numpy as np
import torch
from torch import nn

from emotts_torch.parallel.mesh import Mesh
from emotts_torch.parallel.tp import (gather_state_dict, gather_tensor,
                                      shard_state_dict, shard_tensor)
from emotts_torch.utils.config import TrainConfig


class AdamW(torch.optim.Optimizer):
    """AdamW with torch-default hyperparameters (betas 0.9/0.999, eps 1e-8,
    decoupled weight decay) whose moments are *stored* in ``moment_dtype``
    while all arithmetic is fp32, in the reference's order:

        m = b1·m + (1−b1)·g ;  v = b2·v + (1−b2)·g²          (fp32)
        u = (m / c1) / (√(v / c2) + eps)                      c = 1 − bᵗ
        u = u + wd·p
        p = p + (−lr)·u
        m, v stored back in ``moment_dtype``

    One implementation for fp32 and bf16 moments.  ``torch.optim.AdamW`` is
    not the same arithmetic (it decays the parameter first and folds the bias
    corrections into the step size), nor would it keep bf16 moments beside
    fp32 parameters.

    ``lr_decay_every`` > 0 decays the learning rate in steps, as
    ``optax.exponential_decay(lr, lr_decay_every, lr_decay, staircase=True)``:
    an update uses :func:`staircase_lr` of the number of updates before it
    (the first uses ``lr``).  Weight decay applies to every parameter given,
    biases included.
    """

    def __init__(self, params: Iterable, lr: float, weight_decay: float = 1e-2,
                 betas=(0.9, 0.999), eps: float = 1e-8,
                 moment_dtype: torch.dtype = torch.float32,
                 lr_decay_every: int = 0, lr_decay: float = 1.0):
        super().__init__(params, dict(lr=lr, weight_decay=weight_decay,
                                      betas=betas, eps=eps,
                                      lr_decay_every=lr_decay_every,
                                      lr_decay=lr_decay))
        self.moment_dtype = moment_dtype

    @torch.no_grad()
    def step(self, closure=None):
        if closure is not None:
            raise ValueError("this optimizer takes no closure")
        for group in self.param_groups:
            b1, b2 = group["betas"]
            group["count"] = count = group.get("count", 0) + 1
            # fp32 bias-correction scalars
            c1 = float(np.float32(1.0) - np.power(np.float32(b1), np.float32(count)))
            c2 = float(np.float32(1.0) - np.power(np.float32(b2), np.float32(count)))
            params = [p for p in group["params"] if p.grad is not None]
            if not params:
                continue
            for p in params:
                state = self.state[p]
                if not state:
                    state["mu"] = torch.zeros_like(p, dtype=self.moment_dtype)
                    state["nu"] = torch.zeros_like(p, dtype=self.moment_dtype)
            mus = [self.state[p]["mu"] for p in params]
            nus = [self.state[p]["nu"] for p in params]
            # one multi-tensor call per operation instead of one call per
            # operation and parameter: the arithmetic is per element either way
            g = [p.grad.float() for p in params]
            m = torch._foreach_mul([x.float() for x in mus], b1)
            torch._foreach_add_(m, g, alpha=1.0 - b1)
            v = torch._foreach_mul([x.float() for x in nus], b2)
            torch._foreach_addcmul_(v, g, g, value=1.0 - b2)
            u = torch._foreach_div(m, c1)
            denom = torch._foreach_div(v, c2)
            torch._foreach_sqrt_(denom)
            torch._foreach_add_(denom, group["eps"])
            torch._foreach_div_(u, denom)
            torch._foreach_add_(u, params, alpha=group["weight_decay"])
            lr = group["lr"]
            if group["lr_decay_every"] > 0:
                lr = staircase_lr(lr, group["lr_decay"], group["lr_decay_every"],
                                  count - 1)
            torch._foreach_add_(params, u, alpha=-lr)
            torch._foreach_copy_(mus, m)  # rounds to the storage dtype
            torch._foreach_copy_(nus, v)


def staircase_lr(lr: float, decay: float, every: int, n: int) -> float:
    """lr · decay^⌊n / every⌋ for update count ``n``, in fp32 as optax's
    staircase ``exponential_decay`` returns it (the power is rounded once
    from float64: XLA's fp32 power is that close, where numpy's fp32 power
    is not)."""
    power = np.float64(np.float32(decay)) ** (n // every)
    return float(np.float32(lr) * np.float32(power))


def moment_dtype_of(cfg: TrainConfig) -> torch.dtype:
    if cfg.moment_dtype in (None, "", "float32"):
        return torch.float32
    return getattr(torch, cfg.moment_dtype)


def make_optimizer(cfg: TrainConfig, params: Iterable) -> AdamW:
    """The optimizer of a training configuration over ``params``."""
    return AdamW(params, lr=cfg.learning_rate, weight_decay=cfg.weight_decay,
                 moment_dtype=moment_dtype_of(cfg))


class TrainState:
    """What a trainer carries from step to step and writes to a checkpoint:
    the step counter, the model, its optimizer, and the named generators the
    step draws from (made on the model's device, seeded from ``seed``).
    ``mesh``: the grid of a model sharded by ``parallel.tp.shard_module_``
    (None, or a model axis of 1, for a whole model)."""

    def __init__(self, model: nn.Module, optimizer: torch.optim.Optimizer,
                 seed: int, device, streams=("mixup", "dropout"),
                 mesh: Optional[Mesh] = None):
        self.step = 0
        self.model = model
        self.optimizer = optimizer
        self.mesh = mesh
        self.generators: Dict[str, torch.Generator] = {}
        for i, name in enumerate(streams):
            gen = torch.Generator(device=device)
            gen.manual_seed(seed * 7919 + i)
            self.generators[name] = gen

    def _map_moments(self, opt_state: dict, fn) -> dict:
        """``opt_state`` with ``fn(parameter name, moment)`` for each moment."""
        names = {id(p): n for n, p in self.model.named_parameters()}
        params = [p for g in self.optimizer.param_groups for p in g["params"]]
        state = {i: {k: fn(names[id(params[i])], v) if k in ("mu", "nu") else v
                     for k, v in st.items()}
                 for i, st in opt_state["state"].items()}
        return dict(opt_state, state=state)

    def model_state_dict(self) -> Dict[str, torch.Tensor]:
        """The model's full ``state_dict``: under tensor parallelism its
        shards gathered over the model group (a collective: every rank of
        the group calls it)."""
        return gather_state_dict(self.model.state_dict(), self.mesh)

    def state_dict(self) -> dict:
        """The checkpoint: full tensors under tensor parallelism (a
        collective over the model group, as :meth:`model_state_dict`)."""
        return {
            "step": self.step,
            "model": self.model_state_dict(),
            "optimizer": self._map_moments(
                self.optimizer.state_dict(),
                lambda name, t: gather_tensor(name, t, self.mesh)),
            "generators": {k: g.get_state() for k, g in self.generators.items()},
        }

    def load_state_dict(self, state: dict) -> None:
        """Restore a checkpoint of full tensors (this rank's slices of them
        under tensor parallelism)."""
        self.step = int(state["step"])
        self.model.load_state_dict(shard_state_dict(state["model"], self.mesh))
        self.optimizer.load_state_dict(self._map_moments(
            state["optimizer"], lambda name, t: shard_tensor(name, t, self.mesh)))
        moment_dtype: Optional[torch.dtype] = getattr(
            self.optimizer, "moment_dtype", None)
        if moment_dtype is not None:
            # Optimizer.load_state_dict casts state to the parameters' dtype;
            # the moments go back to their storage dtype (also where the
            # checkpoint was written under another moment_dtype)
            for st in self.optimizer.state.values():
                for key in ("mu", "nu"):
                    if key in st:
                        st[key] = st[key].to(moment_dtype)
        for name, gen_state in state["generators"].items():
            self.generators[name].set_state(gen_state.cpu())
