"""Rank-model trainer: train/eval steps and the epoch loop.

Counterpart of ``emotts/train/rank_trainer.py`` for one device: AdamW, an
epoch loop with early stopping on a validation loss, the deterministic
λ = linspace validation pass beside the informative λ = (1, 0) pass,
per-epoch scalars, step-indexed checkpoints and a best-params export.

Mixup weights and dropout masks come from two ``torch.Generator``s that the
train state owns and checkpoints, so a resumed run continues their streams.
Metrics are read back from the device once per step.  The t-SNE image the
reference renders at validation (it needs scikit-learn and matplotlib) and
its profiler capture are not written here.
"""

from __future__ import annotations

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
from emotts_torch.train.checkpoint import CheckpointManager
from emotts_torch.train.metrics import EpochAverager, MetricsWriter, StepTimer
from emotts_torch.train.state import TrainState, make_optimizer
from emotts_torch.utils.config import Config
from emotts_torch.utils.experiment import increment_path, set_seed

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
    )


def init_rank_model(model: RankModel, seed: int = 0) -> RankModel:
    """Seeded initial weights (drawn on the CPU, whatever the device)."""
    return seeded_init_(model, torch.Generator().manual_seed(seed))


def batch_to_device(batch: Dict[str, np.ndarray], device) -> Dict[str, torch.Tensor]:
    """The arrays of a collated batch that a step reads, on ``device``."""
    return {k: torch.from_numpy(np.ascontiguousarray(batch[k])).to(device)
            for k in _BATCH_TENSORS if k in batch}


class RankTrainer:
    def __init__(self, cfg: Config, device="cuda"):
        self.cfg = cfg
        self.device = resolve_device(device)
        model = build_rank_model(cfg, device=self.device)
        init_rank_model(model, cfg.train_rank.seed)
        model.to(self.device)
        self.state = TrainState(
            model, make_optimizer(cfg.train_rank, model.parameters()),
            cfg.train_rank.seed, self.device,
        )

    @property
    def model(self) -> RankModel:
        return self.state.model

    # ------------------------------------------------------------------

    def train_step(self, batch: Dict[str, np.ndarray],
                   lambdas: Optional[torch.Tensor] = None) -> Dict[str, float]:
        """One optimizer step on a collated batch; λ is drawn from the mixup
        generator unless given."""
        rm = self.cfg.rank_model
        state = self.state
        b = batch_to_device(batch, self.device)
        preds = state.model(
            b["emo_x"], b["neu_x"], b["emotions"], b["lengths"], lambdas,
            deterministic=False,
            mixup_generator=state.generators["mixup"],
            dropout_generator=state.generators["dropout"],
        )
        loss, metrics = rank_loss(preds, b["emotions"], rm.alpha, rm.beta)
        state.optimizer.zero_grad(set_to_none=True)
        loss.backward()
        state.optimizer.step()
        state.step += 1
        return _read_back(metrics)

    @torch.no_grad()
    def eval_step(self, batch: Dict[str, np.ndarray]) -> Tuple[Dict[str, float], np.ndarray]:
        rm = self.cfg.rank_model
        model = self.state.model
        b = batch_to_device(batch, self.device)
        n = b["emo_x"].shape[0]
        rv = b.get("row_valid")
        # 1) reference-parity pass: BOTH branches share the same λ = linspace
        #    row, which pins the RankNet BCE at ln 2 for any model — kept for
        #    parity, logged as valid/loss etc.
        lambdas = torch.linspace(0.0, 1.0, n, device=self.device)[None, :].repeat(2, 1)
        preds = model(b["emo_x"], b["neu_x"], b["emotions"], b["lengths"], lambdas)
        # row_valid masks rows the loader duplicated to fill a batch out of
        # the eval reductions
        _, metrics = rank_loss(preds, b["emotions"], rm.alpha, rm.beta, row_weights=rv)
        # 2) informative pass: a REAL pair — branch i gets the pure emotional
        #    input (λ ≡ 1), branch j the pure neutral (λ ≡ 0), so the ranking
        #    target is 1 and the metric moves with the model's margin.
        #    valid/pair_order_acc is the held-out real-pair order accuracy
        #    (chance 0.5); valid/loss_informative drives patience and the
        #    best-checkpoint selection under selection_metric="informative".
        lam_pairs = torch.stack([torch.ones(n, device=self.device),
                                 torch.zeros(n, device=self.device)])
        preds_p = model(b["emo_x"], b["neu_x"], b["emotions"], b["lengths"], lam_pairs)
        _, m_inf = rank_loss(preds_p, b["emotions"], rm.alpha, rm.beta, row_weights=rv)
        order = (preds_p[6].reshape(-1) > preds_p[7].reshape(-1)).float()
        w = torch.ones_like(order) if rv is None else rv.float()
        metrics = dict(metrics)
        metrics["loss_informative"] = m_inf["loss"]
        metrics["mixup_loss_pairs"] = m_inf["mixup_loss"]
        metrics["rank_loss_pairs"] = m_inf["rank_loss"]
        metrics["pair_order_acc"] = (order * w).sum() / torch.clamp(w.sum(), min=1.0)
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
        )

    def train_epoch(self, loader: BucketLoader, epoch: int, writer=None) -> Dict:
        avg = EpochAverager()
        timer = StepTimer(self.device)
        for batch in loader.epoch(epoch):
            avg.update(self.train_step(batch))
            timer.tick()
        means = avg.means()
        if writer is not None:
            writer.scalars(means, epoch, prefix="train/")
            st = timer.mean_step_time()
            if st:
                writer.scalar("train/step_time_s", st, epoch)
        return means

    def validate_epoch(self, loader: BucketLoader, epoch: int, writer=None) -> Dict:
        avg = EpochAverager()
        for batch in loader.epoch(epoch):
            metrics, _ = self.eval_step(batch)
            rv = batch.get("row_valid")
            avg.update(metrics, weight=float(rv.sum()) if rv is not None else 1.0)
        means = avg.means()
        if writer is not None:
            writer.scalars(means, epoch, prefix="valid/")
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
        if exp_path is None:
            exp_path = increment_path(
                os.path.join(cfg.data.experiment_path, "rank_model"))
        elif resume:
            self.restore(exp_path)
        writer = MetricsWriter(exp_path)
        ckpt = CheckpointManager(exp_path, keep=tr.keep_checkpoints)

        train_loader = self._loader("train", shuffle=True)
        valid_loader = self._loader("test", shuffle=False)

        best_val = float("inf")
        patience = 0
        global_step = 0
        ve = max(1, tr.validate_every_epochs)
        anomaly = torch.autograd.set_detect_anomaly(bool(tr.debug_nans))
        with anomaly:
            for epoch in range(tr.n_epochs):
                train_means = self.train_epoch(train_loader, epoch, writer)
                next_step = global_step + train_loader.batches_per_epoch(epoch)
                # the final epoch always validates so best/ is always exported
                last = (next_step >= tr.max_iterations or epoch == tr.n_epochs - 1)
                if last or (epoch + 1) % ve == 0:
                    val_means = self.validate_epoch(valid_loader, epoch, writer)
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
                    ckpt.save(self.state)
                    if val_loss < best_val:
                        best_val = val_loss
                        patience = 0
                        ckpt.save_best(self.state.model.state_dict())
                    else:
                        patience += 1
                        if patience >= tr.patience:
                            break
                global_step = next_step
                if global_step >= tr.max_iterations:
                    break
        writer.close()
        return exp_path


def _read_back(metrics: Dict[str, torch.Tensor]) -> Dict[str, float]:
    """Device scalars → floats, in one transfer."""
    values = torch.stack([v.detach().float() for v in metrics.values()]).tolist()
    return dict(zip(metrics.keys(), values))
