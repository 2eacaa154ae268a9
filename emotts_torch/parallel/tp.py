"""Tensor parallelism over the model axis.

Counterpart of ``emotts/parallel/tp.py``.  The FFT blocks' heavy weights
are split over the M ranks of a model group in Megatron's column → row
pairs; everything else is replicated:

* the conv-FFN's ``conv1`` splits its output channels (column-parallel,
  weight and bias) and ``conv2`` its input channels (row-parallel);
* the attention's ``query``/``key``/``value`` split their heads (weights
  and biases, heads-major as ``view(b, t, h, d)`` lays them out) and the
  ``out`` projection its heads input (row-parallel).

The rules go by ``state_dict`` name (:func:`shard_dim`), in the port's
``(out, in[, k])`` layouts; they are the JAX package's ``_spec_for``
through ``nn/convert.py``'s name mapping.  The row-parallel biases
(``out``, ``conv2``) stay whole and are added once, after the sum.

Each pair needs two collectives, the conjugate pair of Megatron-LM:
:func:`copy_to_model` (``f``: identity forward, all-reduce of the input's
gradient backward) before the column-parallel layer and
:func:`reduce_from_model` (``g``: all-reduce forward, identity backward)
after the row-parallel one.  A train step adds one more: the replicated
parameters' gradients averaged over the model group
(:func:`average_replicated_gradients`), so that their replicas stay equal
bit for bit.  Every rank starts from the full seeded
weights and keeps its slice (:func:`shard_module_`); checkpoints hold the
full tensors (:func:`gather_state_dict`, :func:`shard_state_dict`).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, Optional

import torch
import torch.distributed as dist
from torch import nn

from emotts_torch.parallel.mesh import Mesh

HEAD_MIX = -1640531527  # the attention kernels' per-head mix of the seeds

_HEADS = ("query", "key", "value")

# the model axis's all-reduces (f's backward, g's forward) and the bytes
# they reduce, counted as ops.attention counts its launches
all_reduce_count = 0
all_reduce_bytes = 0


@dataclass(frozen=True)
class ModelAxis:
    """What a sharded module needs of the grid: the model axis's size, this
    rank's place on it and its process group."""

    size: int
    rank: int
    group: Any

    def split(self, dim: int):
        """``draw_rows``' ``split`` for a draw sharded on ``dim``."""
        return (dim, self.size, self.rank)


def model_axis(mesh: Optional[Mesh]) -> Optional[ModelAxis]:
    """The model axis of ``mesh``; None where it has size 1."""
    if mesh is None or mesh.model == 1:
        return None
    return ModelAxis(mesh.model, mesh.model_rank, mesh.model_group)


def shard_dim(name: str) -> Optional[int]:
    """The dim of ``state_dict`` entry ``name`` that the model axis splits,
    None where the entry is replicated."""
    parts = name.split(".")
    if len(parts) < 3:
        return None
    block, layer, leaf = parts[-3:]
    if block == "attn":
        if layer in _HEADS and leaf in ("weight", "bias"):
            return 0  # (H·D, d) and (H·D,): heads
        if layer == "out" and leaf == "weight":
            return 1  # (d, H·D): row-parallel
    if block == "ffn":
        if layer == "conv1" and leaf in ("weight", "bias"):
            return 0  # (ffn, d, k) and (ffn,): column-parallel
        if layer == "conv2" and leaf == "weight":
            return 1  # (d, ffn, k): row-parallel
    return None


def _slice(t: torch.Tensor, dim: int, axis: ModelAxis) -> torch.Tensor:
    n = t.shape[dim]
    if n % axis.size:
        raise ValueError(f"mesh.model_parallel={axis.size} does not divide "
                         f"{n} (dim {dim} of a {tuple(t.shape)} weight)")
    part = n // axis.size
    return t.narrow(dim, axis.rank * part, part)


def shard_tensor(name: str, t: torch.Tensor, mesh: Optional[Mesh]) -> torch.Tensor:
    """This rank's shard of the full tensor of entry ``name`` (a copy), or
    ``t`` itself where the entry is replicated or there is no model axis."""
    axis = model_axis(mesh)
    dim = None if axis is None else shard_dim(name)
    return t if dim is None else _slice(t, dim, axis).clone()


def shard_state_dict(full: Dict[str, torch.Tensor], mesh: Optional[Mesh]
                     ) -> Dict[str, torch.Tensor]:
    """This rank's shards of a full ``state_dict`` (replicated entries as
    they are)."""
    return {name: shard_tensor(name, t, mesh) for name, t in full.items()}


def _all_gather(t: torch.Tensor, dim: int, axis: ModelAxis) -> torch.Tensor:
    # gloo gathers host tensors only; NCCL gathers on the device
    src = t.detach().contiguous()
    if dist.get_backend(axis.group) == "gloo":
        src = src.cpu()
    parts = [torch.empty_like(src) for _ in range(axis.size)]
    dist.all_gather(parts, src, group=axis.group)
    return torch.cat(parts, dim=dim).to(t.device)


def gather_tensor(name: str, t: torch.Tensor, mesh: Optional[Mesh]) -> torch.Tensor:
    """The full tensor of entry ``name`` from the model group's shards (a
    collective over the model group where ``name`` is sharded)."""
    axis = model_axis(mesh)
    dim = None if axis is None else shard_dim(name)
    return t if dim is None else _all_gather(t, dim, axis)


def gather_state_dict(local: Dict[str, torch.Tensor], mesh: Optional[Mesh]
                      ) -> Dict[str, torch.Tensor]:
    """The full ``state_dict`` from the model group's shards: every rank of
    the group calls it and gets the whole."""
    return {name: gather_tensor(name, t, mesh) for name, t in local.items()}


@torch.no_grad()
def shard_module_(module: nn.Module, mesh: Optional[Mesh]) -> nn.Module:
    """Keep this rank's slice of every sharded parameter of ``module`` (new
    ``nn.Parameter``s: build the optimizer afterwards) and hand the model
    axis to its attention and conv-FFN layers.  Raises ``ValueError`` where
    M divides the heads or channels of a layer unevenly.  A no-op without a
    model axis."""
    axis = model_axis(mesh)
    if axis is None:
        return module
    for m in module.modules():
        if hasattr(m, "model_axis"):  # nn.blocks' attention and conv-FFN
            what, units = m.tp_units
            if units % axis.size:
                raise ValueError(
                    f"mesh.model_parallel={axis.size} does not divide {what}={units}; "
                    "the model axis must divide every attention's heads and "
                    "every FFN width")
            m.model_axis = axis
    for name, p in list(module.named_parameters()):
        dim = shard_dim(name)
        if dim is None:
            continue
        owner_name, leaf = name.rsplit(".", 1)
        owner = module.get_submodule(owner_name)
        setattr(owner, leaf, nn.Parameter(_slice(p, dim, axis).clone(),
                                          requires_grad=p.requires_grad))
    return module


def _all_reduce(x: torch.Tensor, group) -> torch.Tensor:
    global all_reduce_count, all_reduce_bytes
    out = x.clone(memory_format=torch.contiguous_format)
    dist.all_reduce(out, group=group)
    all_reduce_count += 1
    all_reduce_bytes += out.numel() * out.element_size()
    return out


@torch.no_grad()
def average_replicated_gradients(module: nn.Module, mesh: Optional[Mesh]) -> None:
    """Replace the gradient of every replicated parameter of ``module`` by
    its mean over the model group (one flattened all-reduce).  In exact
    arithmetic the ranks of a model group compute these gradients alike;
    on the card some backward kernels add with atomics in an order of their
    own (FastSpeech2's length regulator: ``gather``'s backward), and
    without the mean the ranks' replicas of a parameter would drift apart.
    A no-op without a model axis."""
    axis = model_axis(mesh)
    if axis is None:
        return
    grads = [p.grad for n, p in module.named_parameters()
             if p.grad is not None and shard_dim(n) is None]
    flat = torch.cat([g.reshape(-1).float() for g in grads])
    dist.all_reduce(flat, group=axis.group)
    flat /= axis.size
    offset = 0
    for g in grads:
        n = g.numel()
        g.copy_(flat[offset:offset + n].view_as(g))
        offset += n


class _CopyToModel(torch.autograd.Function):
    """Megatron's ``f``: identity forward, the input gradient summed over
    the model group backward."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        return _all_reduce(grad, ctx.group), None


class _ReduceFromModel(torch.autograd.Function):
    """Megatron's ``g``: the partial sums added over the model group
    forward, identity backward."""

    @staticmethod
    def forward(ctx, x, group):
        return _all_reduce(x, group)

    @staticmethod
    def backward(ctx, grad):
        return grad, None


def copy_to_model(x: torch.Tensor, axis: ModelAxis) -> torch.Tensor:
    return _CopyToModel.apply(x, axis.group)


def reduce_from_model(x: torch.Tensor, axis: ModelAxis) -> torch.Tensor:
    return _ReduceFromModel.apply(x, axis.group)


def offset_seeds(seeds: torch.Tensor, first_head: int) -> torch.Tensor:
    """(B,) int32 seeds for a kernel call whose head 0 is head
    ``first_head`` of the layer: ``seeds + first_head · HEAD_MIX`` with
    int32 wrap-around, so that the kernels' key ``seed + head · HEAD_MIX``
    of local head j is that of head ``first_head + j``."""
    s = seeds.to(torch.int64) + first_head * HEAD_MIX
    return (((s + 2 ** 31) % 2 ** 32) - 2 ** 31).to(torch.int32)
