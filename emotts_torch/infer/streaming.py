"""Streaming vocoder: emit waveform chunks while later mel frames are still
being vocoded — bounded memory and a low time to first audio for serving.

Counterpart of ``emotts/infer/streaming.py``.  HiFi-GAN is fully
convolutional with a finite receptive field, so a mel chunk vocoded with
``halo`` frames of real context on each side reproduces the full-sequence
output on its interior: the zero padding at a window edge reaches no further
than the receptive field (about 14 mel frames for the V1 generator), and at
the sequence's own ends the window edge *is* the true edge.  Whether the
chunks equal unchunked vocoding bit for bit also depends on each convolution
summing an output in the same order whatever the window's length: see
``tests/test_torch_streaming.py`` (CPU) and ``chip_smoke.py`` (the card).
"""

from __future__ import annotations

from typing import Callable, Iterator, Optional

import numpy as np
import torch

from emotts_torch.text.segment import split_sentences

DEFAULT_HALO = 16  # mel frames; > the V1 generator's ~14-frame receptive field


def generator_halo_frames(gen) -> int:
    """Halo (half receptive field in mel frames, rounded up, plus a margin
    of 2) computed from a HiFiGANGenerator's structure, so that generators
    with larger kernels or more dilation steps get a sufficient halo."""
    half = 3.0  # conv_pre k=7
    rate = 1
    for u, ku in zip(gen.upsample_rates, gen.upsample_kernel_sizes):
        rate *= u
        half += ku / rate  # transposed conv reach at this stage's rate
        stage = 0.0
        for k, ds in zip(gen.resblock_kernel_sizes, gen.resblock_dilations):
            reach = sum((k - 1) // 2 * d + (k - 1) // 2 for d in ds)
            stage = max(stage, float(reach))
        half += stage / rate
    half += 3.0 / rate  # post conv k=7
    return int(np.ceil(half)) + 2


def vocode_streaming(
    voc_fn: Callable[[torch.Tensor], torch.Tensor],
    mel: torch.Tensor,  # (B, T, n_mels)
    hop: int,
    chunk_frames: int = 64,
    halo_frames: int = DEFAULT_HALO,
    start_frame: int = 0,
) -> Iterator[np.ndarray]:
    """Yield int16 PCM chunks (B, chunk·hop) left to right; concatenated
    they equal ``voc_fn(mel)`` where the convolutions sum in a fixed order.

    ``voc_fn`` is the mel → int16 PCM function (``Synthesizer._vocode``).
    ``start_frame`` (a multiple of ``chunk_frames``) skips chunks already
    produced elsewhere, e.g. by ``Synthesizer.synthesize_first_chunk``."""
    if chunk_frames <= 0:
        raise ValueError("chunk_frames must be positive")
    t_total = mel.shape[1]
    for t0 in range(start_frame, t_total, chunk_frames):
        t1 = min(t0 + chunk_frames, t_total)
        lo = max(0, t0 - halo_frames)
        hi = min(t_total, t1 + halo_frames)
        pcm = voc_fn(mel[:, lo:hi])
        yield pcm[:, (t0 - lo) * hop:(t1 - lo) * hop].cpu().numpy()


def stream_text(
    synth,
    text: str,
    speaker_id: int,
    emotion_id: int,
    level: float = 0,
    pace: float = 1.0,
    pitch_rate: float = 1.0,
    energy_rate: float = 1.0,
    gap_s: float = 0.15,
    intensity_scale: float = 1.0,
    chunk_frames: int = 64,
    halo_frames: Optional[int] = None,  # default: from the synthesizer's
    # generator structure (generator_halo_frames)
) -> Iterator[np.ndarray]:
    """Long-form streaming synthesis: sentence-split ``text``, synthesize each
    sentence's mel, and yield float32 waveform chunks (PCM / 32767) in
    playback order with ``gap_s`` of silence between sentences.

    Each sentence's audio is the chunked vocoding of its content-trimmed mel
    (:func:`vocode_streaming`).  The first window (chunk + right halo) is
    vocoded right behind the FS2 forward (``synthesize_first_chunk``), and
    its first chunk is used where the sentence has at least a window of
    frames; a shorter sentence is vocoded again content-trimmed."""
    if synth.vocoder is None:
        raise RuntimeError("stream_text requires vocoder params")
    if halo_frames is None:
        halo_frames = generator_halo_frames(synth.vocoder)
    cfg = synth.cfg
    hop = cfg.audio.hop_length
    seqs = [synth.text_to_phoneme_ids(s) for s in split_sentences(text)]
    seqs = [s for s in seqs if len(s) > 0]
    if not seqs:
        raise ValueError("no synthesizable sentences in text")

    gap = np.zeros(int(gap_s * cfg.audio.sampling_rate), np.float32)
    window = chunk_frames + halo_frames
    first_fused = window <= cfg.fastspeech2.max_mel_len
    for i, ids in enumerate(seqs):
        if i and gap.size:
            yield gap
        inten = synth.intensity_for(
            speaker_id, emotion_id, level, len(ids), scale=intensity_scale,
        )[None]
        spk = np.array([speaker_id], np.int32)
        start = 0
        if first_fused:
            pcm_w, mel, lens = synth.synthesize_first_chunk(
                ids, spk, inten, window=window,
                pace=pace, pitch_rate=pitch_rate, energy_rate=energy_rate,
            )
            n = int(lens[0])
            if n >= window:
                # true left edge and a full right halo inside the window:
                # its first chunk is exact, stream it now
                yield pcm_w[0, :chunk_frames * hop].cpu().numpy().astype(
                    np.float32) / 32767.0
                start = chunk_frames
            # else: the content is shorter than the window, whose tail saw
            # capacity padding instead of the true right edge; vocode the
            # content-trimmed mel below
        else:
            mel, lens = synth.synthesize_mels(
                ids, spk, inten,
                pace=pace, pitch_rate=pitch_rate, energy_rate=energy_rate,
            )
            n = int(lens[0])
        for pcm in vocode_streaming(
            synth._vocode, mel[:, :n], hop, chunk_frames=chunk_frames,
            halo_frames=halo_frames, start_frame=start,
        ):
            yield pcm[0].astype(np.float32) / 32767.0
