"""The (data, model) grid: processes and devices, batch rows, random draws
and sums.

Counterpart of ``emotts/parallel/mesh.py`` on ``torch.distributed``.  There
every train step is compiled over a (data, model) device mesh: the batch is
sharded on the data axis, the heavy weights on the model axis
(``parallel/tp.py``) and XLA inserts the collectives.  Here the grid takes
one of two forms:

* a process group — one process per device (``torch.distributed.run``), the
  trainers' form.  Global rank ``data_rank · M + model_rank``: a model group
  is M consecutive ranks (the NVLink neighbours of a node), each holding a
  shard of the FFT blocks (``parallel/tp.py``) and running the same rows; a
  data group is the ranks of one model rank across the replicas, each
  holding its contiguous rows of every global batch, the parameters broadcast
  from its first rank and the gradients all-reduced over it (DDP, or
  :func:`average_gradients`);
* the devices of one process — serving and bucketization: the weights are
  replicated once per device of the data axis and every batch is split over
  those devices.

The numbers do not depend on the topology: a train step on a data × model
grid on a global batch equals the step of one process on that batch.  Random
draws are made at the global batch shape and every rank keeps its rows
(:class:`RowDraws`) and its model-axis slice, and batch statistics and loss
denominators are global sums over the data axis (:func:`global_sum`).
"""

from __future__ import annotations

import copy
from dataclasses import dataclass
from typing import Any, Callable, Dict, Iterable, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist
from torch import nn

from emotts_torch.utils.config import MeshConfig

@dataclass(frozen=True)
class Mesh:
    """``data``: the data-axis size (the size of the data group ``group``,
    or the number of ``devices`` in one process); ``rank``: this process's
    place on it; ``group``: the data group, None in one process;
    ``devices``: the devices this process drives (one in a process group).
    ``model``, ``model_rank``, ``model_group``: the model axis, its size 1
    and its group None without tensor parallelism."""

    data: int
    devices: Tuple[torch.device, ...]
    rank: int = 0
    group: Optional[Any] = None
    model: int = 1
    model_rank: int = 0
    model_group: Optional[Any] = None

    @property
    def distributed(self) -> bool:
        return self.group is not None

    @property
    def primary(self) -> bool:
        """The process that writes files and prints (global rank 0)."""
        return self.rank == 0 and self.model_rank == 0

    def row_offset(self, local_rows: int) -> int:
        """Where this process's rows start in the global batch."""
        return self.rank * local_rows


def visible_devices() -> List[torch.device]:
    """Every CUDA device of this process, or the CPU where there is none."""
    n = torch.cuda.device_count() if torch.cuda.is_available() else 0
    return [torch.device("cuda", i) for i in range(n)] or [torch.device("cpu")]


def _grid(cfg: MeshConfig, n: int) -> Tuple[int, int]:
    """(data, model) of ``cfg`` over ``n`` devices; ``data_parallel`` -1
    takes ``n // model_parallel``."""
    model = max(1, cfg.model_parallel)
    data = cfg.data_parallel if cfg.data_parallel > 0 else max(1, n // model)
    return data, model


def _refuse(data: int, model: int, n: int) -> None:
    raise ValueError(
        f"mesh {data}x{model} needs {data * model} devices, have {n}; "
        "set mesh.data_parallel/model_parallel to match")


def make_mesh(cfg: Optional[MeshConfig] = None,
              devices: Optional[Sequence] = None) -> Mesh:
    """The grid of ``cfg``.

    With an initialized process group it spans the world: ``data ·
    model_parallel`` must equal its size (``data_parallel`` -1 means
    ``world // model_parallel``), the data and model groups are made with
    ``dist.new_group`` (by every rank, for every group), and ``devices`` is
    this process's one device (default: the current CUDA device under
    NCCL, else the CPU).  In one process it is ``devices`` (default: every
    visible device) with replicated weights: -1 means ``len(devices) //
    model_parallel`` of them on the data axis, n > 0 the first n; the model
    axis holds no shards there, and ``data · model_parallel`` devices must
    exist, as the JAX package's mesh requires."""
    cfg = cfg or MeshConfig()
    if dist.is_available() and dist.is_initialized():
        world = dist.get_world_size()
        data, model = _grid(cfg, world)
        if world % model or data * model != world:
            _refuse(data, model, world)
        if devices is None:
            devices = ([torch.device("cuda", torch.cuda.current_device())]
                       if torch.cuda.is_available() and dist.get_backend() == "nccl"
                       else [torch.device("cpu")])
        devices = tuple(torch.device(d) for d in devices)
        if len(devices) != 1:
            raise ValueError("a process of a process group drives one device, "
                             f"got {len(devices)}")
        if model == 1:
            return Mesh(world, devices, dist.get_rank(), dist.group.WORLD)
        data_rank, model_rank = divmod(dist.get_rank(), model)
        data_group = model_group = None
        for m in range(model):  # every rank makes every group, in one order
            g = dist.new_group([d * model + m for d in range(data)])
            data_group = g if m == model_rank else data_group
        for d in range(data):
            g = dist.new_group([d * model + m for m in range(model)])
            model_group = g if d == data_rank else model_group
        return Mesh(data, devices, data_rank, data_group, model, model_rank,
                    model_group)
    devices = [torch.device(d) for d in
               (devices if devices is not None else visible_devices())]
    data, model = _grid(cfg, len(devices))
    if data * model > len(devices):
        _refuse(data, model, len(devices))
    return Mesh(data, tuple(devices[:data]))


def round_up_to_multiple(n: int, m: int) -> int:
    """Smallest multiple of m that is >= n (shard-alignment arithmetic — the
    one implementation shared by the loader, bucketizer and synthesizer
    padding paths)."""
    m = max(1, m)
    return -(-n // m) * m


def data_axis_size(mesh: Optional[Mesh]) -> int:
    return 1 if mesh is None else mesh.data


# -- batches and weights ------------------------------------------------------


def _take_rows(v, lo: int, hi: int, device):
    if isinstance(v, torch.Tensor):
        return v[lo:hi].to(device)
    if isinstance(v, np.ndarray):
        return v[lo:hi]
    return v


def shard_batch(mesh: Mesh, batch: Dict[str, Any]) -> List[Dict[str, Any]]:
    """The rows of a global batch that this process runs, one dict per
    device it drives: this rank's contiguous rows in a process group, an
    equal row slice per device in one process.  Tensors move to their
    shard's device, numpy arrays are sliced, anything else passes through.
    The batch's rows must divide by the data-axis size
    (:func:`round_up_to_multiple` pads them)."""
    rows = next(len(v) for v in batch.values()
                if isinstance(v, (torch.Tensor, np.ndarray)))
    if rows % mesh.data:
        raise ValueError(f"{rows} rows do not split over a data axis of {mesh.data}")
    per = rows // mesh.data
    first = mesh.row_offset(per)
    shards = []
    for i, device in enumerate(mesh.devices):
        lo = first + i * per
        shards.append({k: _take_rows(v, lo, lo + per, device)
                       for k, v in batch.items()})
    return shards


def replicate(mesh: Mesh, module: nn.Module) -> List[nn.Module]:
    """The replicas of ``module`` this process runs, one per device it
    drives.  In a process group the parameters and buffers are broadcast
    from the first rank of the data group (in place, their version counters
    moved: see _written); in one process the module moves to the first
    device and a copy goes to each further one."""
    if mesh.distributed:
        src = dist.get_global_rank(mesh.group, 0)
        with torch.no_grad():
            for t in list(module.parameters()) + list(module.buffers()):
                dist.broadcast(t, src=src, group=mesh.group)
        _written(module)
        return [module]
    first = module.to(mesh.devices[0])
    return [first] + [copy.deepcopy(first).to(d) for d in mesh.devices[1:]]


# -- reductions over the data axis --------------------------------------------


def global_sum(t: torch.Tensor, mesh: Optional[Mesh]) -> torch.Tensor:
    """The sum of ``t`` over the data axis, differentiable: its backward
    sums the incoming gradients over the ranks.  A trainer whose loss is
    built from such sums alone gets, on every rank, W times that rank's share
    of the global gradient, which DDP's (or :func:`average_gradients`')
    mean over the W ranks turns into the global gradient.  Identity without
    a process group."""
    if mesh is None or not mesh.distributed:
        return t
    from torch.distributed.nn.functional import all_reduce

    return all_reduce(t, group=mesh.group)


def average_gradients(params: Iterable[torch.nn.Parameter],
                      mesh: Optional[Mesh]) -> None:
    """Replace every ``.grad`` by its mean over the data axis: one
    flattened buffer, one all-reduce.  A no-op without a process group."""
    if mesh is None or not mesh.distributed:
        return
    grads = [p.grad for p in params if p.grad is not None]
    if not grads:
        return
    flat = torch.cat([g.reshape(-1).float() for g in grads])
    dist.all_reduce(flat, group=mesh.group)
    flat /= mesh.data
    offset = 0
    for g in grads:
        n = g.numel()
        g.copy_(flat[offset:offset + n].view_as(g))
        offset += n


def broadcast_object(obj, mesh: Optional[Mesh]):
    """Global rank 0's ``obj`` on every rank of the world (e.g. an
    experiment directory that only rank 0 may create)."""
    if mesh is None or not mesh.distributed:
        return obj
    box = [obj]
    dist.broadcast_object_list(box, src=0)
    return box[0]


def gather_objects(obj, mesh: Optional[Mesh]) -> List:
    """Every data rank's ``obj``, in rank order, on every rank of the data
    group (host objects: ``gloo`` gathers no CUDA tensors)."""
    if mesh is None or not mesh.distributed:
        return [obj]
    out = [None] * mesh.data
    dist.all_gather_object(out, obj, group=mesh.group)
    return out


def set_batch_norm_group(module: nn.Module, mesh: Optional[Mesh]) -> None:
    """Make the batch statistics of every ``BatchNorm1d`` in ``module``
    global over the data axis (read by ``nn.fastspeech2.batch_norm``), as
    ``SyncBatchNorm.process_group`` does."""
    group = mesh.group if mesh is not None and mesh.distributed else None
    for m in module.modules():
        if isinstance(m, nn.BatchNorm1d):
            m.process_group = group


# -- random draws at the global batch shape -----------------------------------


class RowDraws:
    """A ``torch.Generator`` whose draws are made at the global batch shape:
    every rank draws ``(W·B_local, …)`` and keeps its own rows, so that the
    ranks' generators stay in lockstep and each row gets the draw of a
    one-process run on the global batch.

    ``groups``: the local batch is ``groups`` blocks of rows, each block a
    slice of its own global block (the rank model runs its two mixes as
    ``cat([x_i, x_j])``; globally that is ``cat([X_i, X_j])``)."""

    def __init__(self, generator: torch.Generator, index: int, count: int,
                 groups: int = 1):
        self.generator, self.index, self.count = generator, index, count
        self.groups = groups

    def grouped(self, groups: int) -> "RowDraws":
        return RowDraws(self.generator, self.index, self.count, self.groups * groups)

    def rows(self, n_local: int, device) -> torch.Tensor:
        """The global indices of the ``n_local`` local rows."""
        if n_local % self.groups:
            raise ValueError(f"{n_local} rows are not {self.groups} equal blocks")
        b = n_local // self.groups
        block = torch.arange(self.groups, device=device)[:, None] * (self.count * b)
        own = self.index * b + torch.arange(b, device=device)[None, :]
        return (block + own).reshape(-1)


def row_draws(generator: Optional[torch.Generator], mesh: Optional[Mesh]):
    """``generator`` as the trainer hands it to the model: wrapped in
    :class:`RowDraws` where the data axis spans several processes, itself
    otherwise (one process draws at the global shape already)."""
    if generator is None or mesh is None or not mesh.distributed or mesh.data == 1:
        return generator
    return RowDraws(generator, mesh.rank, mesh.data)


def grouped(generator, groups: int):
    """``generator`` for a batch of ``groups`` stacked blocks of rows."""
    return generator.grouped(groups) if isinstance(generator, RowDraws) else generator


def base_generator(generator) -> Optional[torch.Generator]:
    """The ``torch.Generator`` under a :class:`RowDraws` (or itself)."""
    return generator.generator if isinstance(generator, RowDraws) else generator


def row_index(generator, n_local: int, device) -> torch.Tensor:
    """The global row index of each local row: ``arange(n_local)`` in one
    process, this rank's rows under :class:`RowDraws`."""
    if isinstance(generator, RowDraws):
        return generator.rows(n_local, device)
    return torch.arange(n_local, device=device)


def draw_rows(fn: Callable, shape: Sequence[int], generator, dim: int = 0,
              split: Optional[Tuple[int, int, int]] = None,
              **kwargs) -> torch.Tensor:
    """``fn(shape, generator=…, **kwargs)`` (``torch.rand`` and its kin) at
    the global shape — ``shape[dim]`` times the data-axis size — keeping
    this rank's rows of ``dim``.  A plain generator draws ``shape``
    itself.  ``split`` = (dim, parts, index): the draw is also ``parts``
    times as wide on that dim and slice ``index`` is kept — a model-axis
    rank's heads or channels of the draw at the full width, so that every
    rank of a model group moves its generator alike."""
    if split is not None:
        at, parts, index = split
        shape = list(shape)
        n = shape[at]
        shape[at] = n * parts
        return draw_rows(fn, shape, generator, dim, **kwargs).narrow(at, index * n, n)
    if not isinstance(generator, RowDraws):
        return fn(tuple(shape), generator=generator, **kwargs)
    shape = list(shape)
    n_local = shape[dim]
    shape[dim] = n_local * generator.count
    full = fn(tuple(shape), generator=generator.generator, **kwargs)
    return full.index_select(dim, generator.rows(n_local, full.device))


def data_parallel(module: nn.Module, mesh: Optional[Mesh]) -> nn.Module:
    """``module`` as a train step calls it: under a process group wrapped
    in ``DistributedDataParallel`` over the data group (parameters broadcast
    from its first rank at construction, gradients averaged over its ranks
    in the backward); the
    module itself otherwise.  Buffers are not re-broadcast: BatchNorm's
    running statistics move by the global batch statistics on every rank
    alike."""
    if mesh is None or not mesh.distributed:
        return module
    from torch.nn.parallel import DistributedDataParallel

    device = mesh.devices[0]
    wrapped = DistributedDataParallel(
        module, device_ids=[device] if device.type == "cuda" else None,
        process_group=mesh.group, broadcast_buffers=False)
    _written(module)
    return wrapped


def _written(module: nn.Module) -> None:
    """Move the version counters of ``module``'s parameters and buffers
    after a collective wrote them in place: c10d's writes do not, and what
    is kept beside a tensor until it changes (the vocoder kernels' packed
    weights, ``ops/resblock.py::packed_weights``) goes by that counter."""
    for t in list(module.parameters()) + list(module.buffers()):
        torch.autograd.graph.increment_version(t)


def one_device(mesh: Mesh, what: str) -> torch.device:
    """The one device a trainer runs on; a mesh over several devices of one
    process is refused (data-parallel training is one process per device,
    ``torch.distributed.run``)."""
    if len(mesh.devices) != 1 or (not mesh.distributed and mesh.data != 1):
        raise ValueError(
            f"{what} trains on one device per process; launch one process per "
            "device with torch.distributed.run for data parallelism "
            f"(got a one-process mesh over {mesh.data} devices)")
    return mesh.devices[0]


def serving_mesh(cfg: MeshConfig, device) -> Optional[Mesh]:
    """The mesh that serving and bucketization engage by themselves: on a
    CUDA ``device``, outside a process group, where ``cfg`` would span more
    than one GPU (``data_parallel`` -1 and several visible, or n > 1); its
    data axis is ``devices // model_parallel`` with the weights replicated,
    as the reference's ``load_synthesizer`` takes it.  None otherwise — one
    device runs unsharded."""
    if torch.device(device).type != "cuda" or (dist.is_available()
                                               and dist.is_initialized()):
        return None
    dp = cfg.data_parallel
    if dp > 1 or (dp <= 0 and torch.cuda.device_count() > 1):
        return make_mesh(cfg, visible_devices())
    return None


def local_mesh(mesh: Optional[Mesh], what: str) -> Optional[Mesh]:
    """``mesh`` where it spans several devices of this process; None where
    it spans one.  A process-group mesh is refused: ``what`` splits its
    batches over the devices of one process."""
    if mesh is None:
        return None
    if mesh.distributed:
        raise ValueError(f"{what} splits batches over the devices of one process; "
                         "give it make_mesh(cfg.mesh, devices) outside a process group")
    return mesh if mesh.data > 1 else None
