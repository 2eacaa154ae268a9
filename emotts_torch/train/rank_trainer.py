"""Rank-model trainer: train/eval steps and the epoch loop.

Counterpart of ``emotts/train/rank_trainer.py``: AdamW, an epoch loop with
early stopping on a validation loss, the deterministic λ = linspace
validation pass beside the informative λ = (1, 0) pass, per-epoch scalars,
step-indexed checkpoints and a best-params export.

Mixup weights and dropout masks come from two ``torch.Generator``s that the
train state owns and checkpoints, so a resumed run continues their streams.
Under data parallelism (a process group, one process per device: ``mesh``,
default ``make_mesh(cfg.mesh)``) the model runs in DDP over the data group,
each process loads its rows of every global batch, the draws and the loss
are those of the global batch, and a step equals one process's step on that
batch.  With a model axis (``mesh.model_parallel`` M > 1) every rank builds
the full model from the seed and keeps its shard of the FFT blocks
(``parallel.tp``); the M ranks of a model group load the same rows.  Only
global rank 0 creates the experiment directory and writes checkpoints (full
tensors, gathered over the model group), scalars and plots; every rank
restores, and the decisions (best, early stop) come from global numbers, so
the ranks stay in lockstep.
Metrics are read back from the device once per step.  Validation on the
artifact epochs (``artifact_every_epochs``) and the last writes
``<exp>/tsne_epoch_{epoch}.png`` of the pooled features (where scikit-learn
and matplotlib are installed), and ``profile_epoch`` runs under
``torch.profiler`` with its trace under ``<exp>/profile``.
"""

from __future__ import annotations

import contextlib
import os
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from emotts_torch.data.datasets import RankPairDataset, collate_rank_pairs
from emotts_torch.data.loader import BucketLoader
from emotts_torch.losses.rank import rank_loss
from emotts_torch.nn.init import seeded_init_
from emotts_torch.nn.intensity import RankModel
from emotts_torch.ops.attention import resolve_fused_attention
from emotts_torch.parallel.mesh import (Mesh, broadcast_object, data_parallel,
                                        gather_objects, global_sum, make_mesh,
                                        one_device, row_draws)
from emotts_torch.parallel.tp import average_replicated_gradients, shard_module_
from emotts_torch.train.checkpoint import CheckpointManager
from emotts_torch.train.metrics import (EpochAverager, MetricsWriter, StepTimer,
                                        profile_trace)
from emotts_torch.train.state import TrainState, make_optimizer
from emotts_torch.utils.config import Config
from emotts_torch.utils.experiment import increment_path, set_seed
from emotts_torch.utils.plotting import DEFAULT_COLORS, DEFAULT_MARKERS, plot_tsne
from emotts_torch.utils.trace import span

_BATCH_TENSORS = ("emo_x", "neu_x", "emotions", "lengths", "row_valid")


def resolve_device(device) -> torch.device:
    """The device an entry point runs on; asking for CUDA where there is
    none raises instead of running elsewhere."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "device='cuda' was asked for and torch.cuda.is_available() is "
            "false; pass device='cpu' to run on the CPU")
    return device


def build_rank_model(cfg: Config, dtype: Optional[torch.dtype] = None,
                     device="cuda") -> RankModel:
    rm = cfg.rank_model
    if dtype is None:
        dtype = getattr(torch, cfg.train_rank.compute_dtype)
    return RankModel(
        n_mels=cfg.audio.n_mels,
        n_heads=rm.n_heads,
        n_emotions=cfg.n_emotions,
        n_layers=rm.n_encoder_layers,
        hidden_dim=rm.hidden_dim,
        kernel_size=rm.kernel_size,
        ffn_mult=rm.ffn_mult,
        dropout=rm.dropout,
        fused_attention=resolve_fused_attention(rm.fused_attention, device),
        dtype=dtype,
        remat=rm.remat,
    )


def init_rank_model(model: RankModel, seed: int = 0) -> RankModel:
    """Seeded initial weights (drawn on the CPU, whatever the device)."""
    return seeded_init_(model, torch.Generator().manual_seed(seed))


def batch_to_device(batch: Dict[str, np.ndarray], device) -> Dict[str, torch.Tensor]:
    """The arrays of a collated batch that a step reads, on ``device``."""
    return {k: torch.from_numpy(np.ascontiguousarray(batch[k])).to(device)
            for k in _BATCH_TENSORS if k in batch}


def trainer_mesh(cfg: Config, device, mesh: Optional[Mesh], what: str
                 ) -> Tuple[torch.device, Mesh]:
    """A trainer's device and data axis: ``mesh`` (default
    ``make_mesh(cfg.mesh)`` over ``device``), one device per process."""
    device = resolve_device(device)
    mesh = mesh if mesh is not None else make_mesh(cfg.mesh, devices=[device])
    return one_device(mesh, what), mesh


class RankTrainer:
    def __init__(self, cfg: Config, device="cuda", mesh: Optional[Mesh] = None):
        self.cfg = cfg
        self.device, self.mesh = trainer_mesh(cfg, device, mesh, "RankTrainer")
        model = build_rank_model(cfg, device=self.device)
        init_rank_model(model, cfg.train_rank.seed)
        shard_module_(model, self.mesh)
        model.to(self.device)
        self.state = TrainState(
            model, make_optimizer(cfg.train_rank, model.parameters()),
            cfg.train_rank.seed, self.device, mesh=self.mesh,
        )
        self._step_model = data_parallel(model, self.mesh)

    @property
    def model(self) -> RankModel:
        return self.state.model

    # ------------------------------------------------------------------

    def train_step(self, batch: Dict[str, np.ndarray],
                   lambdas: Optional[torch.Tensor] = None) -> Dict[str, float]:
        """One optimizer step on a collated batch (this rank's rows of the
        global batch); λ is drawn from the mixup generator unless given.
        Its phases are spans: ``train.step`` holds ``train.to_device``,
        ``train.forward``, ``train.loss``, ``train.backward``,
        ``train.optimizer`` and ``train.readback``."""
        rm = self.cfg.rank_model
        state, mesh = self.state, self.mesh
        with span("train.step"):
            with span("train.to_device"):
                b = batch_to_device(batch, self.device)
            with span("train.forward"):
                preds = self._step_model(
                    b["emo_x"], b["neu_x"], b["emotions"], b["lengths"], lambdas,
                    deterministic=False,
                    mixup_generator=row_draws(state.generators["mixup"], mesh),
                    dropout_generator=row_draws(state.generators["dropout"], mesh),
                )
            with span("train.loss"):
                loss, metrics = rank_loss(preds, b["emotions"], rm.alpha, rm.beta,
                                          mesh=mesh)
            with span("train.backward"):
                state.optimizer.zero_grad(set_to_none=True)
                loss.backward()
                average_replicated_gradients(state.model, self.mesh)
            with span("train.optimizer"):
                state.optimizer.step()
                state.step += 1
            with span("train.readback"):
                return _read_back(metrics)

    @torch.no_grad()
    def eval_step(self, batch: Dict[str, np.ndarray]) -> Tuple[Dict[str, float], np.ndarray]:
        """Metrics of the global batch (identical on every rank) and this
        rank's pooled features."""
        rm = self.cfg.rank_model
        model, mesh = self.state.model, self.mesh
        b = batch_to_device(batch, self.device)
        n = b["emo_x"].shape[0]
        rv = b.get("row_valid")
        # 1) reference-parity pass: BOTH branches share the same λ = linspace
        #    row, which pins the RankNet BCE at ln 2 for any model — kept for
        #    parity, logged as valid/loss etc.  The row is the global batch's.
        lam = eval_lambdas(n, mesh, self.device)
        lambdas = lam[None, :].repeat(2, 1)
        preds = model(b["emo_x"], b["neu_x"], b["emotions"], b["lengths"], lambdas)
        # row_valid masks rows the loader duplicated to fill a batch out of
        # the eval reductions
        _, metrics = rank_loss(preds, b["emotions"], rm.alpha, rm.beta,
                               row_weights=rv, mesh=mesh)
        # 2) informative pass: a REAL pair — branch i gets the pure emotional
        #    input (λ ≡ 1), branch j the pure neutral (λ ≡ 0), so the ranking
        #    target is 1 and the metric moves with the model's margin.
        #    valid/pair_order_acc is the held-out real-pair order accuracy
        #    (chance 0.5); valid/loss_informative drives patience and the
        #    best-checkpoint selection under selection_metric="informative".
        lam_pairs = torch.stack([torch.ones(n, device=self.device),
                                 torch.zeros(n, device=self.device)])
        preds_p = model(b["emo_x"], b["neu_x"], b["emotions"], b["lengths"], lam_pairs)
        _, m_inf = rank_loss(preds_p, b["emotions"], rm.alpha, rm.beta,
                             row_weights=rv, mesh=mesh)
        order = (preds_p[6].reshape(-1) > preds_p[7].reshape(-1)).float()
        w = torch.ones_like(order) if rv is None else rv.float()
        correct, n_valid = global_sum(torch.stack([(order * w).sum(), w.sum()]), mesh)
        metrics = dict(metrics)
        metrics["loss_informative"] = m_inf["loss"]
        metrics["mixup_loss_pairs"] = m_inf["mixup_loss"]
        metrics["rank_loss_pairs"] = m_inf["rank_loss"]
        metrics["pair_order_acc"] = correct / torch.clamp(n_valid, min=1.0)
        return _read_back(metrics), preds[4].cpu().numpy()  # pooled h_i

    # ------------------------------------------------------------------

    def _loader(self, split: str, shuffle: bool) -> BucketLoader:
        cfg = self.cfg
        return BucketLoader(
            RankPairDataset(cfg, split),
            buckets=cfg.bucketing.frame_buckets,
            batch_size=cfg.train_rank.batch_size,
            collate=collate_rank_pairs,
            shuffle=shuffle,
            seed=cfg.data.split_seed,
            drop_last=shuffle,  # keep all eval data
            # eval partial batches pad (cyclic repeat) to split over the mesh
            pad_to_multiple=self.mesh.data,
            # each process loads its rows of every global batch
            process_index=self.mesh.rank,
            process_count=self.mesh.data,
        )

    def train_epoch(self, loader: BucketLoader, epoch: int, writer=None) -> Dict:
        avg = EpochAverager()
        timer = StepTimer(self.device)
        build_s = loader.stats["build_s"]
        for batch in timer.batches(loader.epoch(epoch)):
            avg.update(self.train_step(batch))
            timer.tick()
        means = avg.means()
        if writer is not None:
            writer.scalars(means, epoch, prefix="train/")
            st = timer.mean_step_time()
            if st:
                writer.scalar("train/step_time_s", st, epoch)
            # the epoch's host seconds waiting on the loader, and the prefetch
            # thread's seconds building batches
            writer.scalar("train/loader_wait_s", timer.loader_wait_s, epoch)
            writer.scalar("train/loader_build_s",
                          loader.stats["build_s"] - build_s, epoch)
        return means

    def validate_epoch(self, loader: BucketLoader, epoch: int, writer=None,
                       exp_path: Optional[str] = None) -> Dict:
        """Validation means (weighted by each batch's valid rows); with
        ``exp_path``, also the t-SNE image of the pooled features of the
        rows the loader did not repeat, gathered from every rank and drawn
        by rank 0."""
        avg = EpochAverager()
        h_all, emo_all, spk_all, lam_all = [], [], [], []
        for batch in loader.epoch(epoch):
            metrics, h = self.eval_step(batch)
            rv = batch.get("row_valid")
            avg.update(metrics, weight=valid_rows(rv, self.mesh, self.device))
            if exp_path is not None:
                keep = rv > 0 if rv is not None else slice(None)
                n = len(batch["emotions"])
                h_all.append(h[keep])
                emo_all.append(batch["emotions"][keep])
                spk_all.append(batch["speakers"][keep])
                lam_all.append(eval_lambdas(n, self.mesh, "cpu").numpy()[keep])
        means = avg.means()
        if writer is not None:
            writer.scalars(means, epoch, prefix="valid/")
        if exp_path is not None:
            parts = gather_objects((h_all, emo_all, spk_all, lam_all), self.mesh)
            h_all, emo_all, spk_all, lam_all = (
                [a for p in parts for a in p[i]] for i in range(4))
        if h_all and self.mesh.primary:
            plot_tsne(
                np.concatenate(h_all), np.concatenate(emo_all),
                np.concatenate(spk_all), np.concatenate(lam_all),
                self.cfg.data.emotions, self.cfg.data.speakers,
                DEFAULT_COLORS, DEFAULT_MARKERS,
                os.path.join(exp_path, f"tsne_epoch_{epoch}.png"),
            )
        return means

    def restore(self, exp_path: str) -> bool:
        """Resume the full train state (parameters, optimizer, step,
        generators) from an experiment's latest checkpoint; True if one was
        found."""
        ckpt = CheckpointManager(exp_path, keep=self.cfg.train_rank.keep_checkpoints)
        return ckpt.restore(self.state)

    def fit(self, exp_path: Optional[str] = None, verbose: bool = True,
            resume: bool = False) -> str:
        """Full training loop; returns the experiment directory."""
        cfg = self.cfg
        tr = cfg.train_rank
        set_seed(tr.seed)
        exp_path, writer, ckpt = open_experiment(
            self, exp_path, resume, os.path.join(cfg.data.experiment_path, "rank_model"),
            tr.keep_checkpoints)
        verbose = verbose and self.mesh.primary

        train_loader = self._loader("train", shuffle=True)
        valid_loader = self._loader("test", shuffle=False)

        best_val = float("inf")
        patience = 0
        global_step = 0
        ve = max(1, tr.validate_every_epochs)
        ae = max(1, tr.artifact_every_epochs)
        anomaly = torch.autograd.set_detect_anomaly(bool(tr.debug_nans))
        with anomaly:
            for epoch in range(tr.n_epochs):
                with (profile_trace(os.path.join(exp_path, "profile"), self.device)
                      if epoch == tr.profile_epoch and self.mesh.primary
                      else contextlib.nullcontext()):
                    train_means = self.train_epoch(train_loader, epoch, writer)
                next_step = global_step + train_loader.batches_per_epoch(epoch)
                # the final epoch always validates so best/ is always exported
                last = (next_step >= tr.max_iterations or epoch == tr.n_epochs - 1)
                if last or (epoch + 1) % ve == 0:
                    val_means = self.validate_epoch(
                        valid_loader, epoch, writer,
                        exp_path if (last or (epoch + 1) % ae == 0) else None)
                    sel_key = ("loss_informative"
                               if tr.selection_metric == "informative" else "loss")
                    val_loss = val_means.get(
                        sel_key, val_means.get("loss", float("inf")))
                    if verbose:
                        print(
                            f"[rank] epoch {epoch}: "
                            f"train {train_means.get('loss', 0):.4f} "
                            f"valid {val_means.get('loss', 0):.4f} "
                            f"informative {val_means.get('loss_informative', 0):.4f} "
                            f"pair_acc {val_means.get('pair_order_acc', 0):.3f}"
                        )
                    snapshot = save_checkpoint(self.state, ckpt)
                    if val_loss < best_val:
                        best_val = val_loss
                        patience = 0
                        if ckpt is not None:
                            ckpt.save_best(snapshot["model"])
                    else:
                        patience += 1
                        if patience >= tr.patience:
                            break
                global_step = next_step
                if global_step >= tr.max_iterations:
                    break
        if writer is not None:
            writer.close()
        return exp_path


def eval_lambdas(n: int, mesh: Mesh, device) -> torch.Tensor:
    """This rank's n entries of the validation λ = linspace(0, 1) row of the
    global batch."""
    lo = mesh.row_offset(n)
    return torch.linspace(0.0, 1.0, n * mesh.data, device=device)[lo:lo + n]


def valid_rows(row_valid: Optional[np.ndarray], mesh: Mesh, device) -> float:
    """The weight of an eval batch in its epoch's means: the valid rows of
    the global batch (1.0 without a ``row_valid``)."""
    if row_valid is None:
        return 1.0
    return float(global_sum(torch.tensor(float(row_valid.sum()), device=device), mesh))


def open_experiment(trainer, exp_path: Optional[str], resume: bool, base: str,
                    keep: int, subdirs: tuple = ()):
    """(experiment directory, MetricsWriter, CheckpointManager) of a fit.
    A new directory is made by rank 0 alone and its path broadcast, so that
    the ranks do not make one each; a resumed run restores on every rank.
    The writer and the checkpoint manager are rank 0's (None elsewhere)."""
    mesh = trainer.mesh
    if exp_path is None:
        exp_path = broadcast_object(
            increment_path(base, subdirs) if mesh.primary else None, mesh)
    elif resume:
        trainer.restore(exp_path)
    if not mesh.primary:
        return exp_path, None, None
    return exp_path, MetricsWriter(exp_path), CheckpointManager(exp_path, keep=keep)


def save_checkpoint(state: TrainState, ckpt: Optional[CheckpointManager]) -> dict:
    """Write ``state``'s checkpoint where this rank has the manager (global
    rank 0); returns the full state.  Every rank calls it: under tensor
    parallelism the full tensors are gathered over each model group."""
    snapshot = state.state_dict()
    if ckpt is not None:
        ckpt.save(snapshot)
    return snapshot


def _read_back(metrics: Dict[str, torch.Tensor]) -> Dict[str, float]:
    """Device scalars → floats, in one transfer."""
    values = torch.stack([v.detach().float() for v in metrics.values()]).tolist()
    return dict(zip(metrics.keys(), values))
