"""Typed configuration tree for the whole framework.

One source of truth replacing the reference's two hand-destructured YAML files
(``rank_model/parameter.yaml`` and ``fastspeech2/parameter.yaml`` of the
reference implementation, which duplicate the audio/preprocessing blocks).
Any field can be overridden from YAML and from ``--a.b.c=value`` CLI
arguments.

Own copy of ``emotts/utils/config.py`` (same fields, same defaults — the
trainers' fields stay for the modules still to be ported), so that this
package imports nothing of the JAX package.
"""

from __future__ import annotations

import dataclasses
import json
from dataclasses import dataclass, field
from pathlib import Path
from typing import Any, List, Optional

import yaml


@dataclass(unsafe_hash=True)
class AudioConfig:
    """Audio analysis parameters (reference: rank_model/parameter.yaml:28-35).

    Hashable so it can be a jit static argument."""

    sampling_rate: int = 16000
    hop_length: int = 256
    win_length: int = 1024
    n_fft: int = 1024
    n_mels: int = 80
    f_min: float = 0.0
    f_max: float = 8000.0
    # log-compression floor used by the mel frontend (torchaudio convention)
    clip_val: float = 1e-5


@dataclass
class DataConfig:
    """Corpus layout and preprocessing switches
    (reference: rank_model/parameter.yaml:4-23)."""

    data_path: str = "data/EmoV-DB"
    corpus_path: str = "data/mfa/corpus"
    textgrid_path: str = "data/mfa/aligned"
    preprocessed_path: str = "data/preprocessed"
    experiment_path: str = "experiments"
    noise_symbol: str = " [noise] "
    speakers: List[str] = field(default_factory=lambda: ["bea", "jenie", "josh", "sam"])
    emotions: List[str] = field(
        default_factory=lambda: ["neutral", "amused", "angry", "disgusted", "sleepy"]
    )
    sil_phones: List[str] = field(default_factory=lambda: ["sil", "spn", "sp", ""])
    pitch_averaging: bool = False
    energy_averaging: bool = False
    match_transcript: bool = False
    # compute mel/energy on the accelerator in bucketed batches during
    # preprocessing instead of per-utterance numpy FFTs on the host
    device_mel: bool = False
    # deterministic split seeds (the reference used unseeded random.sample /
    # random.shuffle — SURVEY.md §3.6-B5; we fix that)
    split_seed: int = 42
    # pairing fan-out: each emotional utterance is paired with K random
    # neutral utterances (reference: rank_model/preprocess.py:215)
    neutral_pairs_per_utt: int = 10
    test_utts_per_emotion: int = 5
    fs2_train_fraction: float = 0.8


@dataclass
class BucketingConfig:
    """Static-shape bucketing (TPU replacement for per-batch max_T padding)."""

    # mel-frame length buckets; an utterance pads up to the smallest bucket
    # that fits.  Keeps the number of XLA compilations small and static.
    frame_buckets: List[int] = field(default_factory=lambda: [192, 320, 512, 768, 1024])
    phone_buckets: List[int] = field(default_factory=lambda: [48, 96, 144, 192])
    drop_overflow: bool = True  # drop utterances longer than the largest bucket


@dataclass
class RankModelConfig:
    """IntensityExtractor / RankModel (reference: rank_model/parameter.yaml:52-59)."""

    n_encoder_layers: int = 6
    n_heads: int = 2
    hidden_dim: int = 384
    kernel_size: int = 9
    ffn_mult: int = 4  # conv-FFN expansion (hidden_dim * 4 = 1536)
    dropout: float = 0.1
    remat: bool = False  # rematerialize FFT blocks (memory↔FLOPs trade)
    # Pallas fused attention (ops/attention.py). None = auto: on for TPU
    # training batches >= 32, where it measured 1.11x (rank B=64) /
    # neutral B=8 — BENCH_NOTES.md; True/False force either path.
    fused_attention: Optional[bool] = None
    alpha: float = 0.1  # mixup-CE loss weight
    beta: float = 1.0  # ranking loss weight


@dataclass
class FastSpeech2Config:
    """FastSpeech2 acoustic model (reference: fastspeech2/parameter.yaml:62-90)."""

    enc_num_layers: int = 6
    enc_num_head: int = 2
    enc_d_model: int = 384
    enc_ffn_dim: int = 1536
    enc_dropout: float = 0.1
    dec_num_layers: int = 6
    dec_num_head: int = 2
    dec_d_model: int = 384
    dec_ffn_dim: int = 1536
    dec_dropout: float = 0.1
    normalize_before: bool = False
    remat: bool = False  # rematerialize FFT blocks (memory↔FLOPs trade)
    # Pallas fused attention (ops/attention.py). None = auto: on for TPU
    # training batches >= 32, where it measured 1.09x (FS2 B=64) /
    # neutral B=8 — BENCH_NOTES.md; True/False force either path.
    fused_attention: Optional[bool] = None
    ffn_kernel_sizes: List[int] = field(default_factory=lambda: [9, 1])
    n_char: int = 95
    n_mels: int = 80
    postnet_embedding_dim: int = 512
    postnet_kernel_size: int = 5
    postnet_n_convolutions: int = 5
    postnet_dropout: float = 0.5
    padding_idx: int = 0
    dur_pred_kernel_size: int = 3
    pitch_pred_kernel_size: int = 3
    energy_pred_kernel_size: int = 3
    variance_predictor_dropout: float = 0.5
    # architecture-compat switches for importing reference-trained torch
    # checkpoints (fastspeech2/model.py): the reference's SpeechBrain
    # EncoderPreNet is a bare token embedding and its PostNet is
    # LayerNorm-based (conv_pre → intermediates → conv_post with ln1-3);
    # this framework's defaults add a conv context stack to the prenet and
    # use a tanh+BatchNorm postnet.  "embedding"/"speechbrain" reproduce the
    # reference layouts so imported weights run unchanged.
    prenet_style: str = "conv"  # "conv" | "embedding"
    postnet_style: str = "batchnorm"  # "batchnorm" | "speechbrain"
    # dim of the frame/phone-level intensity conditioning vector (== n_emotions;
    # the reference hard-codes 5 at fastspeech2/model.py:201 and has a
    # mismatched zeros(1,T,256) at inference — SURVEY.md §3.6-B2.  We derive it.)
    intensity_dim: int = 5
    # capacity of the length-regulated frame grid at inference time
    max_mel_len: int = 1024


@dataclass
class LossConfig:
    """FS2 composite loss weights (reference: fastspeech2/parameter.yaml:96-106)."""

    log_scale_durations: bool = True
    ssim_loss_weight: float = 1.0
    duration_loss_weight: float = 1.0
    pitch_loss_weight: float = 1.0
    energy_loss_weight: float = 1.0
    mel_loss_weight: float = 1.0
    postnet_mel_loss_weight: float = 1.0


@dataclass
class TrainConfig:
    """Optimization loop settings (reference: */parameter.yaml train blocks)."""

    n_epochs: int = 20
    max_iterations: int = 80_000
    batch_size: int = 8
    learning_rate: float = 1e-6
    weight_decay: float = 1e-2  # AdamW default (torch.optim.AdamW)
    patience: int = 5
    seed: int = 42
    # numerics: bf16 matmuls with fp32 params/accumulation; 'float32' gives
    # the exact-parity mode used by tests.
    compute_dtype: str = "bfloat16"
    # PRNG implementation for train-time randomness (mixup/dropout):
    # 'rbg' = TPU hardware RNG (fastest; streams differ across backends),
    # 'threefry2x32' = JAX default (identical streams everywhere)
    rng_impl: str = "rbg"
    # storage dtype of the Adam moments ('float32' | 'bfloat16').  The AdamW
    # update fusion is HBM-bound; bf16 moments cut its traffic 28->20
    # B/param/step with fp32 math throughout (see train/state.py).
    moment_dtype: str = "bfloat16"
    checkpoint_every_steps: int = 500
    keep_checkpoints: int = 3
    log_every_steps: int = 50
    # validation/artifact cadence in EPOCHS (1 = reference behavior:
    # rank_model/train.py validates and renders a t-SNE every epoch).  On a
    # tiny corpus or under a fixed max_iterations budget an "epoch" can be a
    # single step, and the per-epoch host work (sklearn t-SNE, Orbax saves,
    # vocoded wavs) then dominates wall time; raising these keeps the jitted
    # step loop hot.  Validation always runs on the final epoch so the best-
    # checkpoint export is guaranteed; `patience` counts validation RUNS
    # (not epochs) when validate_every_epochs > 1.
    validate_every_epochs: int = 1
    artifact_every_epochs: int = 1
    # observability/debug (SURVEY.md §5: absent in the reference)
    profile_epoch: int = -1  # epoch to capture a jax.profiler trace (-1 = off)
    debug_nans: bool = False  # enable jax_debug_nans for fault isolation
    # best-checkpoint / early-stop criterion.  "loss" = the validation total
    # loss (the reference's criterion, rank_model/train.py:246-256).  For the
    # RANK model that loss's ranking term is pinned at ln 2 by construction:
    # the replicated reference validation drives both mixup branches with the
    # SAME λ=linspace row (rank_model/train.py:92), so r_i≡r_j and the
    # RankNet BCE is constant for any model.  "informative" (rank trainer
    # only; the default there) selects on valid/loss_informative instead —
    # the same α/β-weighted loss computed on a REAL pair pass (λ_i≡1 pure
    # emotional vs λ_j≡0 pure neutral), whose ranking BCE and the
    # valid/pair_order_acc series actually move with model quality.  The
    # quirk metric stays logged as valid/loss for parity either way.
    selection_metric: str = "loss"


@dataclass
class VocoderTrainConfig:
    """HiFi-GAN GAN-training settings (no reference counterpart — the
    reference downloads a pretrained vocoder; training one in-framework makes
    the stack standalone).  Hyperparameters follow Kong et al. 2020."""

    n_steps: int = 500_000
    batch_size: int = 16
    segment_frames: int = 32  # mel frames per training segment (×hop samples)
    learning_rate: float = 2e-4
    lr_decay: float = 0.999  # exponential decay factor per decay_every steps
    lr_decay_every: int = 1000
    adam_b1: float = 0.8
    adam_b2: float = 0.99
    mel_loss_weight: float = 45.0
    feature_loss_weight: float = 2.0
    # 0.0 disables the adversarial + feature-matching terms (mel-only
    # pretraining; also the deterministic mode used by convergence tests)
    adversarial_weight: float = 1.0
    seed: int = 42
    compute_dtype: str = "bfloat16"
    rng_impl: str = "rbg"
    checkpoint_every_steps: int = 2000
    keep_checkpoints: int = 3
    log_every_steps: int = 100
    # generator structure (defaults = HiFi-GAN V1 @ 16 kHz, ×256 upsampling)
    upsample_initial_channel: int = 512
    upsample_rates: List[int] = field(default_factory=lambda: [8, 8, 2, 2])
    upsample_kernel_sizes: List[int] = field(
        default_factory=lambda: [16, 16, 4, 4]
    )
    resblock_kernel_sizes: List[int] = field(default_factory=lambda: [3, 7, 11])
    resblock_dilations: List[List[int]] = field(
        default_factory=lambda: [[1, 3, 5], [1, 3, 5], [1, 3, 5]]
    )
    # discriminator scale (1.0 = paper channels; tests shrink it)
    disc_channel_mult: float = 1.0
    # run the MSD's grouped convs as block-diagonal dense convs — g× the
    # MACs but solid MXU tiles; measured faster at full size on TPU
    # (benchmarks/disc_profile.py).  Param layout is unchanged either way.
    disc_dense_groups: bool = True
    # >1: PARTIAL block-diagonal merge of the MSD's grouped convs — m
    # original groups fuse into one 128·m/2-lane conv group at m× the MACs
    # (dense_groups is the m=16 special case).  Takes precedence over
    # disc_dense_groups when set.  Default 4 = the measured full-GAN-step
    # winner on the chip (103.3 -> 75.5 ms/step at B=16; m=8 gave 79.4 —
    # BENCH_NOTES.md round-3 A/B).  Identical math/params at every m
    # (tests/test_vocoder_train.py::test_msd_group_merge_parity); gcd
    # degrades it gracefully for tiny test group counts.
    msd_group_merge: int = 4
    mpd_periods: List[int] = field(default_factory=lambda: [2, 3, 5, 7, 11])
    # periods to run with the period axis folded into batch (identical math
    # and params; faster on TPU for the larger periods).  Default [5,7,11]
    # = the measured winner inside the full GAN step on top of
    # msd_group_merge=4 (74.4 vs 75.5 ms/step; folding alone without the
    # merge is neutral, 102.6 vs 103.3 — BENCH_NOTES.md round-3 A/B).
    # Periods not in mpd_periods are ignored, so tiny test configs with
    # mpd_periods=[2] are unaffected.
    mpd_fold_periods: List[int] = field(
        default_factory=lambda: [5, 7, 11])
    msd_scales: int = 3
    # conditioning source: "gt" trains on ground-truth mels (from scratch);
    # "fs2" fine-tunes on teacher-forced FastSpeech2 PREDICTED mels aligned
    # with the real audio (the HiFi-GAN paper's TTS fine-tuning recipe —
    # closes the train/inference mel mismatch).  "fs2" requires trained
    # rank + FS2 experiments (inference.rank_exp / inference.fs2_exp).
    condition: str = "gt"
    fs2_split: str = "train"  # which split provides the fine-tuning mels
    # rematerialize the generator forward inside its vjp pullback: the
    # residuals otherwise stay live across the whole discriminator
    # forward/backward/update (the single-forward formulation), raising
    # peak HBM; remat recomputes the forward instead — identical math,
    # ~one extra G forward of FLOPs per step.  Enable if a large config
    # OOMs where the two-forward formulation used to fit.
    gen_remat: bool = False


@dataclass
class MeshConfig:
    """Device-mesh layout.  Data parallelism over ICI is the only parallelism
    worth being first-class at this model scale (SURVEY.md §2.3)."""

    data_axis: str = "data"
    model_axis: str = "model"
    # -1 means "all available devices" on the data axis
    data_parallel: int = -1
    model_parallel: int = 1


@dataclass
class InferenceConfig:
    """Bucketization & synthesis (reference: */parameter.yaml inference blocks)."""

    rank_exp: str = "exp_1"
    fs2_exp: str = "exp_1"
    bucket_size: int = 3
    text: str = "gregson was asleep when he re-entered the cabin."
    vocoder_checkpoint: str = ""  # path to a converted HiFi-GAN checkpoint
    lexicon_path: str = ""  # optional CMUdict-format lexicon for G2P
    neural_g2p: bool = True  # trained OOV fallback (emotts/text/neural_g2p.py)
    # beam width for the neural OOV decode (1 = greedy; >1 pays ~beam x the
    # one-time per-novel-word decode cost — memoized thereafter)
    neural_g2p_beam: int = 1
    # vocoder-inference HBM budget as batch-rows x mel-frames per dispatch:
    # the fp32 HiFi-GAN upsample intermediates scale with rows x frames
    # (~0.9 MB per row-frame on v5e incl. layout padding — a 52-row x
    # 512-frame batch compiled to a 23.25G program and OOM'd the 15.75G
    # chip, while 60 x 256 fits).  Batches above the budget are vocoded in
    # equal row-chunks of ONE compiled shape (last chunk zero-padded).
    # 0 disables chunking.
    vocode_row_frames: int = 16384
    output_path: str = "demo"


@dataclass
class Config:
    audio: AudioConfig = field(default_factory=AudioConfig)
    data: DataConfig = field(default_factory=DataConfig)
    bucketing: BucketingConfig = field(default_factory=BucketingConfig)
    rank_model: RankModelConfig = field(default_factory=RankModelConfig)
    fastspeech2: FastSpeech2Config = field(default_factory=FastSpeech2Config)
    loss: LossConfig = field(default_factory=LossConfig)
    train_rank: TrainConfig = field(
        default_factory=lambda: TrainConfig(selection_metric="informative")
    )
    train_fs2: TrainConfig = field(
        default_factory=lambda: TrainConfig(
            n_epochs=1000, max_iterations=250_000, learning_rate=1e-4
        )
    )
    train_vocoder: VocoderTrainConfig = field(
        default_factory=VocoderTrainConfig
    )
    mesh: MeshConfig = field(default_factory=MeshConfig)
    inference: InferenceConfig = field(default_factory=InferenceConfig)

    @property
    def n_speakers(self) -> int:
        return len(self.data.speakers)

    @property
    def n_emotions(self) -> int:
        return len(self.data.emotions)


# --------------------------------------------------------------------------
# construction / override machinery
# --------------------------------------------------------------------------


def _build(cls, raw: dict):
    """Recursively build a dataclass from a nested dict, erroring on unknown keys."""
    if raw is None:
        raw = {}
    fields = {f.name: f for f in dataclasses.fields(cls)}
    unknown = set(raw) - set(fields)
    if unknown:
        raise KeyError(f"unknown config keys for {cls.__name__}: {sorted(unknown)}")
    kwargs = {}
    for name, f in fields.items():
        if name not in raw:
            continue
        val = raw[name]
        if dataclasses.is_dataclass(f.type) or (
            isinstance(f.type, str) and f.type[0].isupper()
        ):
            sub_cls = _resolve_field_type(cls, name)
            if dataclasses.is_dataclass(sub_cls) and isinstance(val, dict):
                kwargs[name] = _build(sub_cls, val)
                continue
        kwargs[name] = val
    return cls(**kwargs)


def _resolve_field_type(cls, name):
    import typing

    hints = typing.get_type_hints(cls)
    return hints.get(name)


def _parse_scalar(s: str) -> Any:
    """Parse a CLI override value with YAML semantics ('true', '1e-4', '[a,b]')."""
    try:
        val = yaml.safe_load(s)
    except yaml.YAMLError:
        return s
    # YAML 1.1 only accepts '1.0e-3'-style floats; accept '1e-3' too
    if isinstance(val, str):
        try:
            return float(val)
        except ValueError:
            return val
    return val


def _set_dotted(cfg: Any, dotted: str, value: Any) -> None:
    parts = dotted.split(".")
    obj = cfg
    for p in parts[:-1]:
        if not hasattr(obj, p):
            raise KeyError(f"no config section '{p}' in override '{dotted}'")
        obj = getattr(obj, p)
    leaf = parts[-1]
    if not dataclasses.is_dataclass(obj) or leaf not in {
        f.name for f in dataclasses.fields(obj)
    }:
        raise KeyError(f"no config field '{leaf}' in override '{dotted}'")
    setattr(obj, leaf, value)


def load_config(
    yaml_path: Optional[str] = None, overrides: Optional[List[str]] = None
) -> Config:
    """Build a Config from (optional) YAML file + ``a.b.c=value`` overrides."""
    raw = {}
    if yaml_path:
        raw = yaml.safe_load(Path(yaml_path).read_text()) or {}
    cfg = _build(Config, raw)
    for ov in overrides or []:
        ov = ov.lstrip("-")
        if "=" not in ov:
            raise ValueError(f"override must look like a.b.c=value, got '{ov}'")
        key, val = ov.split("=", 1)
        _set_dotted(cfg, key, _parse_scalar(val))
    return cfg


def config_to_dict(cfg: Any) -> dict:
    return dataclasses.asdict(cfg)


def save_config(cfg: Config, path: str) -> None:
    Path(path).parent.mkdir(parents=True, exist_ok=True)
    Path(path).write_text(yaml.safe_dump(config_to_dict(cfg), sort_keys=False))


def config_fingerprint(cfg: Config) -> str:
    """Stable hash of the full config tree, for experiment bookkeeping."""
    import hashlib

    blob = json.dumps(config_to_dict(cfg), sort_keys=True).encode()
    return hashlib.sha256(blob).hexdigest()[:12]
