"""FastSpeech2 trainer: teacher-forced steps conditioned on a frozen
IntensityExtractor.

Counterpart of ``emotts/train/fs2_trainer.py``: AdamW,
per-epoch scalars for every loss part, step-indexed checkpoints, a
best-on-validation export, early stopping, vocoded validation samples, and
the train-time intensity bridge — the frozen rank-model extractor's
frame-level output averaged to phone level over the ground-truth durations
(``segment_mean``), under ``torch.no_grad()``.

The PostNet's BatchNorm running statistics are buffers of the model, so the
checkpoints, the ``best/`` export and a restore carry them with the
parameters.  Dropout masks come from a ``torch.Generator`` that the train
state owns and checkpoints.  A sampled validation epoch writes the
predicted-against-ground-truth mel grid ``<exp>/mels/valid_epoch_{epoch}.png``
(where matplotlib is installed), and ``profile_epoch`` runs under
``torch.profiler`` with its trace under ``<exp>/profile``.

Under data parallelism (a process group, one process per device, as in
``RankTrainer``) the model runs in DDP, each process loads its rows of every
global batch and runs the frozen extractor on them, the dropout masks, the
PostNet's BatchNorm statistics and every loss denominator are those of the
global batch, and only global rank 0 writes the experiment's files and
vocoded samples.  With a model axis the FFT blocks are sharded as in
``RankTrainer``; the frozen extractor stays whole on every rank.
"""

from __future__ import annotations

import contextlib
import dataclasses
import os
from pathlib import Path
from typing import Dict, Optional, Tuple

import numpy as np
import torch
from torch import nn

from emotts_torch.audio.wavio import write_wav
from emotts_torch.data.datasets import FS2Dataset, collate_fs2, pick_bucket
from emotts_torch.data.loader import BucketLoader
from emotts_torch.losses.fs2 import fs2_loss
from emotts_torch.nn.fastspeech2 import FastSpeech2
from emotts_torch.nn.init import seeded_init_
from emotts_torch.nn.intensity import IntensityExtractor
from emotts_torch.nn.length_regulator import segment_mean
from emotts_torch.ops.attention import resolve_fused_attention
from emotts_torch.parallel.mesh import (Mesh, data_parallel, row_draws,
                                        set_batch_norm_group)
from emotts_torch.parallel.tp import average_replicated_gradients, shard_module_
from emotts_torch.train.checkpoint import CheckpointManager
from emotts_torch.train.metrics import (EpochAverager, StepTimer,
                                        profile_trace)
from emotts_torch.train.rank_trainer import (_read_back, open_experiment,
                                             save_checkpoint, trainer_mesh,
                                             valid_rows)
from emotts_torch.train.state import TrainState, make_optimizer
from emotts_torch.utils.config import Config
from emotts_torch.utils.experiment import set_seed
from emotts_torch.utils.plotting import plot_mel_grid

_BATCH_TENSORS = ("phonemes", "durations", "mel", "pitch", "energy", "rank_x",
                  "phon_len", "mel_len", "speakers", "emotions", "row_valid")


def build_fastspeech2(cfg: Config, dtype: Optional[torch.dtype] = None,
                      device=None) -> FastSpeech2:
    """The FastSpeech2 of ``cfg``: intensity width follows ``n_emotions``,
    compute dtype follows ``train_fs2.compute_dtype``.  The fused-attention
    flag's auto value (None) takes the kernels on a CUDA ``device``; without
    a device (serving) it takes the unfused path, as the reference does
    wherever no training batch size is given."""
    # the intensity conditioning vector is the extractor's per-emotion logit
    cfg.fastspeech2.intensity_dim = cfg.n_emotions
    if dtype is None:
        dtype = getattr(torch, cfg.train_fs2.compute_dtype)
    fs2_cfg = dataclasses.replace(
        cfg.fastspeech2,
        fused_attention=resolve_fused_attention(cfg.fastspeech2.fused_attention,
                                                device or "cpu"),
    )
    return FastSpeech2(fs2_cfg, n_speakers=cfg.n_speakers, dtype=dtype)


def build_intensity_extractor(cfg: Config, dtype: Optional[torch.dtype] = None,
                              device="cuda") -> IntensityExtractor:
    """The frozen extractor: it runs at the FS2 train compute dtype (its
    parameters stay fp32; only activations are cast)."""
    rm = cfg.rank_model
    if dtype is None:
        dtype = getattr(torch, cfg.train_fs2.compute_dtype)
    return IntensityExtractor(
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


def extractor_params_from_rank(rank_params: Dict[str, torch.Tensor]
                               ) -> Dict[str, torch.Tensor]:
    """The IntensityExtractor's entries of a RankModel ``state_dict`` (e.g.
    the rank experiment's ``best/`` export)."""
    prefix = "intensity_extractor."
    return {k[len(prefix):]: v for k, v in rank_params.items()
            if k.startswith(prefix)}


def init_fs2_variables(model: FastSpeech2, seed: int = 0) -> Dict[str, torch.Tensor]:
    """Seeded initial weights (drawn on the CPU, whatever the device) with
    fresh BatchNorm statistics (mean 0, variance 1); returns the state_dict."""
    seeded_init_(model, torch.Generator().manual_seed(seed))
    return model.state_dict()


def batch_to_device(batch: Dict[str, np.ndarray], device) -> Dict[str, torch.Tensor]:
    """The arrays of a collated FS2 batch that a step reads, on ``device``;
    int32 ids and lengths become int64 (embedding and gather indices)."""
    out = {}
    for k in _BATCH_TENSORS:
        if k in batch:
            t = torch.from_numpy(np.ascontiguousarray(batch[k]))
            out[k] = (t.long() if t.dtype == torch.int32 else t).to(device)
    return out


class FS2Trainer:
    """``extractor_params``: the IntensityExtractor's state_dict
    (:func:`extractor_params_from_rank`).  ``vocoder`` (optional, a
    HiFiGANGenerator with its weights, on ``device``) enables vocoded
    validation samples: four predicted and ground-truth wavs per sampled
    epoch under ``<exp>/wavs``."""

    def __init__(self, cfg: Config, extractor_params: Dict[str, torch.Tensor],
                 vocoder: Optional[nn.Module] = None, device="cuda",
                 mesh: Optional[Mesh] = None):
        self.cfg = cfg
        self.device, self.mesh = trainer_mesh(cfg, device, mesh, "FS2Trainer")
        self.vocoder = vocoder
        model = build_fastspeech2(cfg, device=self.device)
        init_fs2_variables(model, cfg.train_fs2.seed)
        shard_module_(model, self.mesh)
        model.to(self.device)
        self.extractor = build_intensity_extractor(cfg, device=self.device)
        self.extractor.load_state_dict(extractor_params)
        self.extractor.to(self.device).eval().requires_grad_(False)
        self.state = TrainState(
            model, make_optimizer(cfg.train_fs2, model.parameters()),
            cfg.train_fs2.seed, self.device, streams=("dropout",), mesh=self.mesh,
        )
        set_batch_norm_group(model, self.mesh)
        self._step_model = data_parallel(model, self.mesh)

    @property
    def model(self) -> FastSpeech2:
        return self.state.model

    # ------------------------------------------------------------------

    @torch.no_grad()
    def intensity_rep(self, b: Dict[str, torch.Tensor]) -> torch.Tensor:
        """Frozen extractor → phone-level conditioning (B, P, n_emotions)."""
        frames = self.extractor(b["rank_x"], b["mel_len"], b["emotions"])
        return segment_mean(frames, b["durations"])

    def _forward(self, b: Dict[str, torch.Tensor], deterministic: bool,
                 model: Optional[nn.Module] = None):
        return (model or self.state.model)(
            b["phonemes"], b["speakers"], b["durations"], b["pitch"],
            b["energy"], self.intensity_rep(b), max_mel_len=b["mel"].shape[1],
            deterministic=deterministic,
            generator=row_draws(self.state.generators["dropout"], self.mesh),
        )

    def train_step(self, batch: Dict[str, np.ndarray]) -> Dict[str, float]:
        """One optimizer step on a collated batch — this rank's rows of the
        global batch (dropout on, BatchNorm on batch statistics, which moves
        its running statistics)."""
        state = self.state
        b = batch_to_device(batch, self.device)
        preds = self._forward(b, deterministic=False, model=self._step_model)
        total, parts = fs2_loss(preds, b["mel"], b["durations"], b["mel_len"],
                                b["phon_len"], self.cfg.loss, mesh=self.mesh)
        state.optimizer.zero_grad(set_to_none=True)
        total.backward()
        average_replicated_gradients(state.model, self.mesh)
        state.optimizer.step()
        state.step += 1
        return _read_back(parts)

    @torch.no_grad()
    def eval_step(self, batch: Dict[str, np.ndarray]
                  ) -> Tuple[Dict[str, float], torch.Tensor]:
        """Loss parts of a deterministic pass (running statistics) and the
        predicted mel; ``row_valid`` masks rows the loader repeated to fill
        the batch out of the reductions."""
        b = batch_to_device(batch, self.device)
        preds = self._forward(b, deterministic=True)
        _, metrics = fs2_loss(preds, b["mel"], b["durations"], b["mel_len"],
                              b["phon_len"], self.cfg.loss,
                              row_weights=b.get("row_valid"), mesh=self.mesh)
        return _read_back(metrics), preds[0]

    # ------------------------------------------------------------------

    def _phone_bucket(self, phone_max: int) -> int:
        phone_bucket = pick_bucket(phone_max, self.cfg.bucketing.phone_buckets)
        if phone_bucket < 0:
            phone_bucket = self.cfg.bucketing.phone_buckets[-1]
        return phone_bucket

    def _collate(self, examples, frame_bucket: int,
                 phone_bucket: Optional[int] = None):
        if phone_bucket is None:
            phone_bucket = self._phone_bucket(max(len(e.phonemes) for e in examples))
        return collate_fs2(examples, phone_bucket, frame_bucket)

    def _loader(self, split: str, shuffle: bool) -> BucketLoader:
        cfg = self.cfg
        dataset = FS2Dataset(cfg, split)
        return BucketLoader(
            dataset,
            buckets=cfg.bucketing.frame_buckets,
            batch_size=cfg.train_fs2.batch_size,
            collate=self._collate,
            shuffle=shuffle,
            seed=cfg.data.split_seed,
            drop_last=shuffle,  # keep all eval data
            # eval partial batches pad (cyclic repeat) to split over the mesh
            pad_to_multiple=self.mesh.data,
            # each process loads its rows of every global batch, all of them
            # padded to the phone bucket of the global batch
            process_index=self.mesh.rank,
            process_count=self.mesh.data,
            batch_shape=lambda idxs: {"phone_bucket": self._phone_bucket(
                max(dataset.phone_count_of(i) for i in idxs))},
        )

    def train_epoch(self, loader: BucketLoader, epoch: int, writer=None) -> Dict:
        avg = EpochAverager()
        timer = StepTimer(self.device)
        for batch in loader.epoch(epoch):
            avg.update(self.train_step(batch))
            timer.tick()
        means = avg.means()
        if writer is not None:
            writer.scalars(means, epoch, prefix="Loss/")
            st = timer.mean_step_time()
            if st:
                writer.scalar("train/step_time_s", st, epoch)
        return means

    def valid_epoch(self, loader: BucketLoader, epoch: int, writer=None,
                    exp_path: Optional[str] = None, plot_every: int = 10) -> Dict:
        avg = EpochAverager()
        sampled = False
        for batch in loader.epoch(epoch):
            metrics, mel_pred = self.eval_step(batch)
            avg.update(metrics, weight=valid_rows(batch.get("row_valid"),
                                                  self.mesh, self.device))
            # rank 0's rows are the first rows of the global batch
            if (exp_path and self.mesh.primary and not sampled
                    and epoch % plot_every == 0):
                mels_dir = Path(exp_path) / "mels"
                mels_dir.mkdir(exist_ok=True)
                plot_mel_grid(mel_pred.float().cpu().numpy(), batch["mel"],
                              str(mels_dir / f"valid_epoch_{epoch}.png"))
                self._vocode_samples(batch, mel_pred, epoch, exp_path)
                sampled = True
        means = avg.means()
        if writer is not None:
            writer.scalars(means, epoch, prefix="Valid/Loss/")
        return means

    def restore(self, exp_path: str) -> bool:
        """Resume the full train state (parameters, BatchNorm statistics,
        optimizer, step, generator) from an experiment's latest checkpoint;
        True if one was found."""
        ckpt = CheckpointManager(exp_path, keep=self.cfg.train_fs2.keep_checkpoints)
        return ckpt.restore(self.state)

    @torch.no_grad()
    def _vocode_samples(self, batch, mel_pred: torch.Tensor, epoch: int,
                        exp_path: str, max_samples: int = 4) -> None:
        """Vocode predicted and ground-truth mels of the first few
        validation samples into ``<exp>/wavs``."""
        if self.vocoder is None:
            return
        wav_dir = Path(exp_path) / "wavs"
        wav_dir.mkdir(exist_ok=True)
        n = min(max_samples, mel_pred.shape[0])
        hop = self.cfg.audio.hop_length
        sr = self.cfg.audio.sampling_rate
        gt = torch.from_numpy(batch["mel"][:n]).to(self.device)
        pred_wavs = self.vocoder(mel_pred[:n].float()).float().cpu().numpy()
        gt_wavs = self.vocoder(gt).float().cpu().numpy()
        for i in range(n):
            t = int(batch["mel_len"][i]) * hop
            write_wav(str(wav_dir / f"epoch_{epoch}_sample_{i + 1}_pred.wav"),
                      pred_wavs[i, :t], sr)
            write_wav(str(wav_dir / f"epoch_{epoch}_sample_{i + 1}_gt.wav"),
                      gt_wavs[i, :t], sr)

    def fit(self, exp_path: Optional[str] = None, verbose: bool = True,
            resume: bool = False) -> str:
        """Full training loop; returns the experiment directory."""
        cfg = self.cfg
        tr = cfg.train_fs2
        set_seed(tr.seed)
        exp_path, writer, ckpt = open_experiment(
            self, exp_path, resume, os.path.join(cfg.data.experiment_path, "fastspeech2"),
            tr.keep_checkpoints, subdirs=("wavs", "mels"))
        verbose = verbose and self.mesh.primary

        train_loader = self._loader("train", shuffle=True)
        valid_loader = self._loader("valid", shuffle=False)

        best_val = float("inf")
        patience = 0
        global_step = 0
        ve = max(1, tr.validate_every_epochs)
        ae = max(1, tr.artifact_every_epochs)
        with torch.autograd.set_detect_anomaly(bool(tr.debug_nans)):
            for epoch in range(tr.n_epochs):
                with (profile_trace(os.path.join(exp_path, "profile"), self.device)
                      if epoch == tr.profile_epoch and self.mesh.primary
                      else contextlib.nullcontext()):
                    train_means = self.train_epoch(train_loader, epoch, writer)
                next_step = global_step + train_loader.batches_per_epoch(epoch)
                # the final epoch always validates so best/ is always exported
                last = next_step >= tr.max_iterations or epoch == tr.n_epochs - 1
                if last or (epoch + 1) % ve == 0:
                    # artifact_every_epochs=1 keeps the reference's default
                    # (samples every 10th epoch); an explicit cadence takes
                    # over the gating entirely
                    val_means = self.valid_epoch(
                        valid_loader, epoch, writer,
                        exp_path if (last or (epoch + 1) % ae == 0) else None,
                        plot_every=10 if ae == 1 else 1,
                    )
                    val_loss = val_means.get("total_loss", float("inf"))
                    if verbose:
                        print(f"[fs2] epoch {epoch}: "
                              f"train {train_means.get('total_loss', 0):.4f} "
                              f"valid {val_loss:.4f}")
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
