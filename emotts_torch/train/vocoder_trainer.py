"""HiFi-GAN vocoder trainer: adversarial training of the V1 generator.

Counterpart of ``emotts/train/vocoder_trainer.py``.  The
generator the synthesis path serves (``emotts_torch/nn/hifigan.py``) trains
against the multi-period and multi-scale discriminators
(``emotts_torch/nn/hifigan_disc.py``) with the HiFi-GAN objective (LSGAN
adversarial + 2 × feature matching + 45 × L1 log-mel), then exports the flat
``vocoder.npz`` that ``load_synthesizer`` reads.

A step runs in the reference's order: ONE generator forward; the
discriminators' update on the detached ŷ; the generator's losses against
the UPDATED discriminators, differentiated with respect to ŷ only (no
gradient of them reaches the discriminators' parameters or moments) and
pulled back through the saved forward.  The conditioning mel and the mel
loss come from ``audio/mel.py::mel_full`` on the step's device (hard floor
for the conditioning, soft floor on both sides of the L1).
``adversarial_weight: 0`` makes the step mel-only, with no discriminator.
``gen_remat`` recomputes the generator forward inside its backward
(``torch.utils.checkpoint``): the same numbers, less memory.

The generator is built without kernel flags, as the reference's trainer
builds it: the step differentiates the plain path, and no vocoder kernel
has a backward.  ``condition: "fs2"`` fine-tunes on teacher-forced
FastSpeech2 mels (:func:`predicted_mel_pairs`, through ``Evaluator``, whose
fp32 models take the attention kernel on the card).

Under data parallelism (a process group, one process per device) each
process samples ``batch_size`` segments from its own share of the utterances
(``wav_paths[rank::W]``, seeded with ``seed + rank + start_step``), so the
global batch is ``batch_size × W``, as the reference's
``make_array_from_process_local_data`` assembles it.  The GAN step is not
wrapped in DDP: it runs each discriminator on real and fake and pulls the
generator's loss back through the just-updated discriminators, more than
the one forward per backward DDP's reducer expects.  Each model's gradients
are averaged over the ranks instead (one flattened all-reduce) before its
AdamW step; every loss is a mean over equal local batches, so that average
is the global batch's gradient.  Only rank 0 writes the experiment.  A
model axis replicates, as in the JAX package (no rule of its
``parallel/tp.py`` matches the vocoder's parameters): ``rank`` and ``W``
are the data rank and size, so the M ranks of a model group run the same
rows and the same step.
"""

from __future__ import annotations

import os
from glob import glob
from typing import Dict, List, Optional

import numpy as np
import torch
from torch.utils.checkpoint import checkpoint

from emotts_torch.audio.mel import mel_full
from emotts_torch.audio.wavio import load_wav
from emotts_torch.losses.gan import (
    discriminator_loss,
    feature_matching_loss,
    generator_adversarial_loss,
    mel_l1_loss,
)
from emotts_torch.nn.convert import hifigan_to_flax
from emotts_torch.nn.hifigan import HiFiGANGenerator
from emotts_torch.nn.hifigan_disc import (
    Discriminators,
    MultiPeriodDiscriminator,
    MultiScaleDiscriminator,
)
from emotts_torch.nn.init import seeded_init_
from emotts_torch.parallel.mesh import (Mesh, average_gradients, global_sum,
                                        replicate)
from emotts_torch.train.checkpoint import CheckpointManager
from emotts_torch.train.metrics import EpochAverager, StepTimer
from emotts_torch.train.rank_trainer import open_experiment, trainer_mesh
from emotts_torch.train.state import AdamW, TrainState
from emotts_torch.utils.config import Config
from emotts_torch.utils.experiment import set_seed


def build_vocoder_generator(cfg: Config) -> HiFiGANGenerator:
    vc = cfg.train_vocoder
    return HiFiGANGenerator(
        in_channels=cfg.audio.n_mels,
        upsample_initial_channel=vc.upsample_initial_channel,
        upsample_rates=tuple(vc.upsample_rates),
        upsample_kernel_sizes=tuple(vc.upsample_kernel_sizes),
        resblock_kernel_sizes=tuple(vc.resblock_kernel_sizes),
        resblock_dilations=tuple(tuple(d) for d in vc.resblock_dilations),
    )


def build_discriminators(cfg: Config) -> Discriminators:
    """MPD and MSD of ``train_vocoder``, computing in its ``compute_dtype``."""
    vc = cfg.train_vocoder
    dtype = getattr(torch, vc.compute_dtype)
    return Discriminators(
        MultiPeriodDiscriminator(tuple(vc.mpd_periods), vc.disc_channel_mult,
                                 fold_periods=tuple(vc.mpd_fold_periods), dtype=dtype),
        MultiScaleDiscriminator(vc.msd_scales, vc.disc_channel_mult,
                                dense_groups=vc.disc_dense_groups and vc.msd_group_merge <= 1,
                                group_merge=vc.msd_group_merge, dtype=dtype),
    )


class SegmentSampler:
    """In-memory random-crop sampler over corpus wavs.

    Short utterances are zero-padded to one segment; crops are uniform over
    (utterance, offset)."""

    def __init__(self, paths: List[str], sr: int, segment_samples: int,
                 seed: int = 0):
        if not paths:
            raise ValueError("no wav files to train on")
        self.segment = segment_samples
        self.wavs = []
        for p in paths:
            y = load_wav(p, sr).astype(np.float32)
            if len(y) < segment_samples:
                y = np.pad(y, (0, segment_samples - len(y)))
            self.wavs.append(y)
        self.rng = np.random.default_rng(seed)

    def batch(self, b: int) -> np.ndarray:
        out = np.empty((b, self.segment), np.float32)
        idx = self.rng.integers(0, len(self.wavs), b)
        for row, i in enumerate(idx):
            y = self.wavs[i]
            t0 = self.rng.integers(0, len(y) - self.segment + 1)
            out[row] = y[t0 : t0 + self.segment]
        return out


class PairedSegmentSampler:
    """Random crops over aligned (conditioning mel, waveform) pairs — the
    fine-tuning path, where the conditioning mel is a FastSpeech2 prediction
    rather than the analysis mel of the audio."""

    def __init__(self, pairs, segment_frames: int, hop: int, mel_floor: float,
                 seed: int = 0):
        if not pairs:
            raise ValueError("no (mel, wav) pairs to train on")
        self.f = segment_frames
        self.hop = hop
        self.pairs = []
        for mel, wav in pairs:
            n = min(mel.shape[0], len(wav) // hop)
            mel, wav = mel[:n], wav[: n * hop]
            if n < segment_frames:  # pad short utterances to one segment
                pad_m = np.full((segment_frames, mel.shape[1]), mel_floor,
                                np.float32)
                pad_m[:n] = mel
                pad_w = np.zeros(segment_frames * hop, np.float32)
                pad_w[: n * hop] = wav
                mel, wav = pad_m, pad_w
            self.pairs.append((mel.astype(np.float32), wav.astype(np.float32)))
        self.rng = np.random.default_rng(seed)

    def batch(self, b: int):
        m_dim = self.pairs[0][0].shape[1]
        y = np.empty((b, self.f * self.hop), np.float32)
        mel = np.empty((b, self.f, m_dim), np.float32)
        idx = self.rng.integers(0, len(self.pairs), b)
        for row, i in enumerate(idx):
            m, w = self.pairs[i]
            f0 = self.rng.integers(0, m.shape[0] - self.f + 1)
            mel[row] = m[f0 : f0 + self.f]
            y[row] = w[f0 * self.hop : (f0 + self.f) * self.hop]
        return {"y": y, "mel_cond": mel}


def predicted_mel_pairs(cfg: Config, fs2_exp: Optional[str] = None,
                        rank_exp: Optional[str] = None,
                        split: Optional[str] = None,
                        max_utts: Optional[int] = None, device="cuda"):
    """Teacher-forced FastSpeech2 mels aligned with the ground-truth audio:
    the fine-tuning data of the HiFi-GAN paper (predicted mel in, real
    waveform out).  ``Evaluator``'s teacher-forced pass over ``split``
    (default ``train_vocoder.fs2_split``); an utterance is kept where its
    TextGrid exists, its wav trimmed to the TextGrid's speech span."""
    from pathlib import Path

    from emotts_torch.audio.textgrid import process_textgrid
    from emotts_torch.audio.wavio import trim_audio
    from emotts_torch.eval.evaluate import Evaluator

    split = split or cfg.train_vocoder.fs2_split
    ev = Evaluator(cfg, fs2_exp, rank_exp, device=device)
    sr, hop = cfg.audio.sampling_rate, cfg.audio.hop_length
    pairs = []
    for batch in ev.loader(split).epoch(0):
        mel, _, _ = ev.teacher_forced(batch)
        for i in range(mel.shape[0]):
            t = int(batch["mel_len"][i])
            if t == 0:
                continue
            wav_path = Path(str(batch["wavs"][i]))
            tg = (Path(cfg.data.textgrid_path) / wav_path.parent.name
                  / f"{wav_path.stem}.TextGrid")
            if not tg.exists():
                continue
            _, _, t0, t1 = process_textgrid(str(tg), sr, hop, cfg.data.sil_phones)
            y = trim_audio(load_wav(str(wav_path), sr), t0, t1, sr)
            n = min(t, len(y) // hop)
            if n <= 0:
                continue
            pairs.append((np.asarray(mel[i, :n]), y[: n * hop]))
            if max_utts is not None and len(pairs) >= max_utts:
                return pairs
    return pairs


class GANState:
    """The generator's and the discriminators' train states, checkpointed
    together (parameters, both optimizers, the step)."""

    def __init__(self, gen: TrainState, disc: TrainState):
        self.gen, self.disc = gen, disc

    @property
    def step(self) -> int:
        return self.gen.step

    @property
    def model(self):
        return self.gen.model

    def state_dict(self) -> dict:
        return {"gen": self.gen.state_dict(), "disc": self.disc.state_dict()}

    def load_state_dict(self, state: dict) -> None:
        self.gen.load_state_dict(state["gen"])
        self.disc.load_state_dict(state["disc"])


class VocoderTrainer:
    """Runs on ``device`` (CUDA unless the caller asks for the CPU); both
    models start from seeded weights (``seeded_init_``, ``train_vocoder.seed``)
    and train with AdamW (b1 0.8, b2 0.99, weight decay 0.01, fp32 moments)
    at the staircase-decayed learning rate."""

    def __init__(self, cfg: Config, device="cuda", mesh: Optional[Mesh] = None):
        self.cfg = cfg
        vc = cfg.train_vocoder
        self.device, self.mesh = trainer_mesh(cfg, device, mesh, "VocoderTrainer")
        self.dtype = getattr(torch, vc.compute_dtype)
        self.segment_samples = vc.segment_frames * cfg.audio.hop_length
        self.adversarial = vc.adversarial_weight > 0.0
        self.condition = vc.condition  # "gt" | "fs2"

        init = torch.Generator().manual_seed(vc.seed)
        gen = seeded_init_(build_vocoder_generator(cfg), init).to(self.device)
        disc = seeded_init_(build_discriminators(cfg), init).to(self.device)
        for model in (gen, disc):  # the data group's first weights on its ranks
            replicate(self.mesh, model)

        def optimizer(params):
            return AdamW(params, lr=vc.learning_rate, weight_decay=0.01,
                         betas=(vc.adam_b1, vc.adam_b2),
                         lr_decay_every=vc.lr_decay_every, lr_decay=vc.lr_decay)

        self.state = GANState(
            TrainState(gen, optimizer(gen.parameters()), vc.seed, self.device, streams=()),
            TrainState(disc, optimizer(disc.parameters()), vc.seed + 1, self.device,
                       streams=()))

    @property
    def gen(self) -> HiFiGANGenerator:
        return self.state.gen.model

    @property
    def disc(self) -> Discriminators:
        return self.state.disc.model

    # ------------------------------------------------------------------

    def _device_mel(self, y: torch.Tensor, floor: str = "hard") -> torch.Tensor:
        # segments are always segment_samples long: the full-length path
        return mel_full(y, self.cfg.audio, floor=floor)[:, :, :self.cfg.train_vocoder.segment_frames]

    def _gen_forward(self, mel_in: torch.Tensor) -> torch.Tensor:
        def forward(mel):
            return self.gen(mel.to(self.dtype)).float()

        if self.cfg.train_vocoder.gen_remat:
            return checkpoint(forward, mel_in, use_reentrant=False)
        return forward(mel_in)

    def train_step(self, batch: Dict[str, np.ndarray]) -> Dict[str, float]:
        """One step on ``{"y": (B, S)}`` (plus ``"mel_cond"`` (B, T, M) under
        ``condition: "fs2"``): the discriminators' update, then the
        generator's; the metrics under the reference's names, averaged over
        the ranks.  Afterwards each parameter's ``.grad`` holds the gradient
        its update used."""
        vc = self.cfg.train_vocoder
        y = torch.from_numpy(np.ascontiguousarray(batch["y"])).to(self.device)
        with torch.no_grad():
            if self.condition == "fs2":
                mel_in = torch.from_numpy(np.ascontiguousarray(batch["mel_cond"])).to(
                    self.device)
            else:
                mel_in = self._device_mel(y).transpose(1, 2)  # (B, T, M)
            # soft-floored log-mels on BOTH sides of the L1
            mel_soft = self._device_mel(y, floor="soft")
        gen, disc = self.state.gen, self.state.disc
        metrics: Dict[str, torch.Tensor] = {}
        y_hat = self._gen_forward(mel_in)
        if self.adversarial:
            real_outs, _ = disc.model(y)
            fake_outs, _ = disc.model(y_hat.detach())
            d_loss = discriminator_loss(real_outs, fake_outs)
            disc.optimizer.zero_grad(set_to_none=True)
            d_loss.backward()
            average_gradients(disc.model.parameters(), self.mesh)
            disc.optimizer.step()
            disc.step += 1
            metrics["d_loss"] = d_loss.detach()

            # the generator's losses against the updated discriminators, as a
            # function of ŷ alone: the discriminators' parameters are frozen
            # while the losses are built, so no gradient reaches them
            y_leaf = y_hat.detach().requires_grad_()
            disc.model.requires_grad_(False)
            try:
                l_mel = mel_l1_loss(self._device_mel(y_leaf, floor="soft"), mel_soft)
                fake_outs, fake_feats = disc.model(y_leaf)
                with torch.no_grad():
                    _, real_feats = disc.model(y)
                l_adv = generator_adversarial_loss(fake_outs)
                l_fm = feature_matching_loss(real_feats, fake_feats)
                total = (vc.mel_loss_weight * l_mel + vc.adversarial_weight * l_adv
                         + vc.feature_loss_weight * l_fm)
                total.backward()
            finally:
                disc.model.requires_grad_(True)
            gen.optimizer.zero_grad(set_to_none=True)
            y_hat.backward(y_leaf.grad)
            metrics.update(mel_l1=l_mel, g_adv=l_adv, feature_match=l_fm, g_total=total)
        else:
            l_mel = mel_l1_loss(self._device_mel(y_hat, floor="soft"), mel_soft)
            total = vc.mel_loss_weight * l_mel
            gen.optimizer.zero_grad(set_to_none=True)
            total.backward()
            metrics.update(mel_l1=l_mel, g_total=total)
        average_gradients(gen.model.parameters(), self.mesh)
        gen.optimizer.step()
        gen.step += 1
        values = global_sum(torch.stack([v.detach().float() for v in metrics.values()]),
                            self.mesh) / self.mesh.data
        return dict(zip(metrics.keys(), values.tolist()))

    # ------------------------------------------------------------------

    def restore(self, exp_path: str) -> bool:
        """Both states from the experiment's latest checkpoint; True if one
        was found."""
        ckpt = CheckpointManager(exp_path, keep=self.cfg.train_vocoder.keep_checkpoints)
        return ckpt.restore(self.state)

    def export(self, exp_path: str) -> str:
        """The generator's parameters as the flat ``vocoder.npz`` the
        synthesis path reads (``inference.vocoder_checkpoint``)."""
        # not at the top: infer.synthesize imports this package's modules
        from emotts_torch.infer.synthesize import save_vocoder_params_npz

        out = os.path.join(exp_path, "vocoder.npz")
        save_vocoder_params_npz(hifigan_to_flax(self.gen.state_dict()), out)
        return out

    def fit(self, wav_paths: Optional[List[str]] = None,
            n_steps: Optional[int] = None, exp_path: Optional[str] = None,
            resume: bool = False, pairs=None) -> str:
        """Train up to ``n_steps`` (default ``train_vocoder.n_steps``) total
        steps; returns the experiment directory.  ``wav_paths`` default to
        ``<corpus_path>/*/*.wav``; ``pairs``: precomputed
        :func:`predicted_mel_pairs` for ``condition: "fs2"``."""
        cfg, vc = self.cfg, self.cfg.train_vocoder
        mesh = self.mesh
        set_seed(vc.seed)
        exp_path, writer, ckpt = open_experiment(
            self, exp_path, resume, os.path.join(cfg.data.experiment_path, "vocoder"),
            vc.keep_checkpoints)
        # the sampler seed folds in the (restored) step counter, so that a
        # resumed run draws fresh crops instead of replaying the first run's;
        # each process samples its own share of the utterances
        start = self.state.step
        sampler_seed = vc.seed + mesh.rank + start
        if self.condition == "fs2":
            if pairs is None:
                pairs = predicted_mel_pairs(cfg, device=self.device)
            pairs = pairs[mesh.rank::mesh.data]
            sampler = PairedSegmentSampler(
                pairs, vc.segment_frames, cfg.audio.hop_length,
                mel_floor=float(np.log(cfg.audio.clip_val)), seed=sampler_seed)
        else:
            if wav_paths is None:
                wav_paths = sorted(glob(os.path.join(cfg.data.corpus_path, "*", "*.wav")))
            wav_paths = wav_paths[mesh.rank::mesh.data]
            sampler = SegmentSampler(wav_paths, cfg.audio.sampling_rate,
                                     self.segment_samples, seed=sampler_seed)
        avg = EpochAverager()
        timer = StepTimer(self.device)
        total = n_steps if n_steps is not None else vc.n_steps
        for step in range(start, total):
            raw = sampler.batch(vc.batch_size)
            if not isinstance(raw, dict):
                raw = {"y": raw}
            avg.update(self.train_step(raw))
            timer.tick()
            if (step + 1) % vc.log_every_steps == 0 or step + 1 == total:
                if writer is not None:
                    writer.scalars(avg.means(), step + 1, prefix="train/")
                    st = timer.mean_step_time()
                    if st:
                        writer.scalar("train/step_time_s", st, step + 1)
                avg = EpochAverager()
            if ckpt is not None and ((step + 1) % vc.checkpoint_every_steps == 0
                                     or step + 1 == total):
                ckpt.save(self.state)
        if writer is not None:
            self.export(exp_path)
            writer.close()
        return exp_path
