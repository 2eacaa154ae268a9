"""End-to-end synthesis: text → G2P → FastSpeech2 → HiFi-GAN → wav.

Counterpart of ``emotts/infer/synthesize.py``.  For every (speaker × emotion
× intensity level), FastSpeech2 is conditioned on the bucketized intensity
prototype (neutral → zeros) and the predicted mel is vocoded.  The whole
sweep runs as one batch through both models on the device, with a single
transfer of the 16-bit waveform batch to the host.

``Synthesizer`` runs on the card unless the caller asks for the CPU.  With
``fastspeech2.fused_attention=True`` and a ``vocoder_structure`` that sets
``fused_mrf`` / ``use_pallas_resblocks`` the forward goes through the
package's hand-written kernels (``emotts_torch.ops``).  ``load_synthesizer``
assembles one from the package's own experiment directories.

``mesh`` (a ``parallel.mesh.Mesh`` over several devices of one process)
shards synthesis: the weights are replicated once per device, and every
batch — the sweep, long-form sentence batches, streamed chunks — is padded
to a multiple of the data-axis size (padded rows are all-pad phones, so
their ``mel_len`` is 0) and split over the devices; the results come back in
row order on the first device.
"""

from __future__ import annotations

import itertools
import os
import sys
from pathlib import Path
from typing import Dict, Mapping, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from emotts_torch.audio.wavio import write_wav
from emotts_torch.data.datasets import pick_bucket
from emotts_torch.nn.convert import (fs2_from_flax, hifigan_from_flax,
                                     load_vocoder_checkpoint)
from emotts_torch.nn.hifigan import (HiFiGANGenerator,
                                     generator_structure_from_params)
from emotts_torch.parallel.mesh import (Mesh, local_mesh, replicate,
                                        round_up_to_multiple, serving_mesh,
                                        shard_batch)
from emotts_torch.text.g2p import G2P
from emotts_torch.text.segment import split_sentences
from emotts_torch.train.checkpoint import load_best_params
from emotts_torch.train.fs2_trainer import build_fastspeech2
from emotts_torch.utils.config import Config


def resolve_name(value, table, what: str) -> int:
    """Speaker/emotion name-or-id → index; raises ``ValueError``.

    The ONE resolution rule shared by the HTTP server and the SSML
    renderer."""
    if isinstance(value, bool) or value is None:
        raise ValueError(f"missing/invalid {what}: {value!r}")
    if isinstance(value, (int, np.integer)):
        idx = int(value)
    elif value in table:
        return list(table).index(value)
    else:
        try:
            idx = int(value)
        except (TypeError, ValueError):
            raise ValueError(
                f"unknown {what} {value!r}; known: {list(table)}"
            ) from None
    if not 0 <= idx < len(table):
        raise ValueError(f"{what} id {idx} out of range (n={len(table)})")
    return idx


def _is_flax_tree(weights: Mapping) -> bool:
    """The reference's trees nest dicts; a state_dict maps names to tensors."""
    return any(isinstance(v, Mapping) for v in weights.values())


def build_vocoder(cfg: Config, vocoder_params: Mapping,
                  vocoder_structure: Optional[Dict] = None,
                  device="cpu") -> HiFiGANGenerator:
    """A HiFiGANGenerator with ``vocoder_params`` (the reference's params
    tree, or a state_dict of this package's generator), in eval mode on
    ``device``.  Without ``vocoder_structure`` the structure is inferred
    from a params tree (any V1/V2/V3-family model); a state_dict needs it."""
    flax_tree = _is_flax_tree(vocoder_params)
    if vocoder_structure is None:
        if not flax_tree:
            raise ValueError(
                "a vocoder state_dict needs an explicit vocoder_structure"
            )
        vocoder_structure = generator_structure_from_params(
            vocoder_params, expected_upsample=cfg.audio.hop_length
        )
    vocoder = HiFiGANGenerator(**vocoder_structure)
    if flax_tree:
        vocoder_params = hifigan_from_flax(vocoder_params)
    vocoder.load_state_dict(vocoder_params)
    return vocoder.to(device).eval()


def kernel_vocoder_structure(cfg: Config, vocoder_params: Mapping,
                             device) -> Optional[Dict]:
    """The generator structure of a params tree as ``load_synthesizer``
    builds it: on a CUDA device through the vocoder kernels
    (``fused_mrf``, ``use_pallas_resblocks``); elsewhere None (inferred,
    plain path)."""
    if torch.device(device).type != "cuda":
        return None
    return dict(
        generator_structure_from_params(
            vocoder_params, expected_upsample=cfg.audio.hop_length),
        fused_mrf=True, use_pallas_resblocks=True)


class Synthesizer:
    def __init__(
        self,
        cfg: Config,
        fs2_variables: Mapping,  # the reference's {'params', 'batch_stats'}
        #   tree of numpy arrays, or a state_dict of this package's FastSpeech2
        vocoder_params: Optional[Mapping] = None,  # the reference's params
        #   tree, or a state_dict of this package's HiFiGANGenerator
        intensity_bank: Optional[np.ndarray] = None,  # (n_spk, n_emo, levels, n_emo)
        g2p: Optional[G2P] = None,
        vocoder_structure: Optional[Dict] = None,  # explicit generator
        # kwargs: required with a state_dict, and for checkpoints whose
        # dilations/strides deviate from the HiFi-GAN conventions
        # generator_structure_from_params assumes
        device: str = "cuda",
        mesh: Optional[Mesh] = None,  # shard batches over its devices
    ):
        self.mesh = local_mesh(mesh, "Synthesizer")
        if self.mesh is not None:
            device = self.mesh.devices[0]
        self.device = torch.device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(
                "Synthesizer(device='cuda') needs an NVIDIA GPU and none is "
                "visible; pass device='cpu' to run the plain PyTorch path"
            )
        # One numeric contract for the whole process: float32 matmuls and
        # convolutions are full float32 (no TF32), like the package's own
        # fp32 kernels.  cuDNN's default would run float32 convs in TF32.
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False

        self.cfg = cfg
        self.model = build_fastspeech2(cfg)
        if _is_flax_tree(fs2_variables):
            fs2_variables = fs2_from_flax(fs2_variables)
        self.model.load_state_dict(fs2_variables)
        self.model.to(self.device).eval()

        self.vocoder = (None if vocoder_params is None else build_vocoder(
            cfg, vocoder_params, vocoder_structure, self.device))
        self.vocoder_params = vocoder_params
        # one replica of the models per device of the mesh (the first is
        # self.model / self.vocoder)
        self._replicas = [(self.model, self.vocoder)]
        if self.mesh is not None:
            models = replicate(self.mesh, self.model)
            vocoders = (replicate(self.mesh, self.vocoder) if self.vocoder is not None
                        else [None] * len(models))
            self._replicas = list(zip(models, vocoders))
        self.intensity_bank = intensity_bank
        self.g2p = g2p or G2P(
            cfg.inference.lexicon_path or None,
            neural=cfg.inference.neural_g2p,
            neural_beam=cfg.inference.neural_g2p_beam,
        )

    # -- device cores ------------------------------------------------------

    @torch.inference_mode()
    def _mel_forward(self, phonemes, speakers, intensity, max_mel_len,
                     pace, pitch_rate, energy_rate):
        return self._over_mesh(self._mel_forward_on, (phonemes, speakers, intensity),
                               max_mel_len, pace, pitch_rate, energy_rate)

    def _mel_forward_on(self, replica, phonemes, speakers, intensity,
                        max_mel_len, pace, pitch_rate, energy_rate):
        preds = replica[0](
            phonemes, speakers, intensity=intensity, pace=pace,
            pitch_rate=pitch_rate, energy_rate=energy_rate,
            max_mel_len=max_mel_len,
        )
        # element 0 is the mel BEFORE the PostNet, as in the reference
        return preds[0], preds[7]  # mel (B, T, n_mels), mel_lens (B,)

    @torch.inference_mode()
    def _first_chunk(self, phonemes, speakers, intensity, max_mel_len, pace,
                     pitch_rate, energy_rate, window):
        """FS2 forward, then the vocoder on the first ``window`` mel frames,
        queued on the device with no host synchronisation between the two.
        The returned mel/lens let the caller stream the remaining chunks
        without running FastSpeech2 again."""
        return self._over_mesh(self._first_chunk_on, (phonemes, speakers, intensity),
                               max_mel_len, pace, pitch_rate, energy_rate, window)

    def _first_chunk_on(self, replica, phonemes, speakers, intensity,
                        max_mel_len, pace, pitch_rate, energy_rate, window):
        mel, lens = self._mel_forward_on(replica, phonemes, speakers, intensity,
                                         max_mel_len, pace, pitch_rate, energy_rate)
        return self._vocode_on(replica, mel[:, :window]), mel, lens

    @torch.inference_mode()
    def _vocode(self, mel):
        return self._over_mesh(self._vocode_on, (mel,))

    def _vocode_on(self, replica, mel):
        wav = replica[1](mel)  # (B, T·hop)
        # 16-bit PCM on device: the wav files are written as int16 anyway,
        # and it halves the transfer to the host
        return torch.clamp(wav.float() * 32767.0, -32768.0, 32767.0).to(torch.int16)

    def _over_mesh(self, fn, rows, *args):
        """``fn(replica, *rows, *args)`` over the batch ``rows`` (tensors on
        ``self.device`` with one leading row axis): on the one replica
        without a mesh; with one, zero-padded to a multiple of the data-axis
        size, split over the replicas, and the results (a tensor or a
        tuple of them) gathered back in row order on ``self.device``."""
        if self.mesh is None:
            return fn(self._replicas[0], *rows, *args)
        n = rows[0].shape[0]
        n_pad = round_up_to_multiple(n, self.mesh.data)
        if n_pad != n:
            rows = [torch.cat([t, t.new_zeros((n_pad - n, *t.shape[1:]))]) for t in rows]
        shards = shard_batch(self.mesh, dict(enumerate(rows)))
        outs = [fn(replica, *shard.values(), *args)
                for replica, shard in zip(self._replicas, shards)]
        def gather(parts):
            return torch.cat([t.to(self.device) for t in parts])[:n]

        if isinstance(outs[0], torch.Tensor):
            return gather(outs)
        return tuple(gather(parts) for parts in zip(*outs))

    def _to_device(self, arr: np.ndarray) -> torch.Tensor:
        t = torch.from_numpy(arr)
        if t.dtype == torch.int32:
            t = t.long()  # embedding and gather indices
        return t.to(self.device)

    # -- public API ------------------------------------------------------

    def text_to_phoneme_ids(self, text: str) -> np.ndarray:
        return np.asarray(self.g2p.text_to_sequence(text), dtype=np.int32)

    def intensity_for(
        self, speaker_id: int, emotion_id: int, level: float, n_phones: int,
        scale: float = 1.0,
    ) -> np.ndarray:
        """Prototype lookup broadcast over phones; neutral (class 0) → zeros.

        A fractional ``level`` linearly interpolates between the two adjacent
        bucket prototypes (level 1.5 = halfway between buckets 1 and 2;
        clamped to the bank's range), and ``scale`` multiplies the
        conditioning vector (0 → neutral-like, >1 → exaggerated)."""
        n_emo = self.cfg.n_emotions
        if emotion_id == 0 or self.intensity_bank is None:
            return np.zeros((n_phones, n_emo), np.float32)
        proto = self._proto(speaker_id, emotion_id, level) * scale
        return np.broadcast_to(proto, (n_phones, n_emo)).astype(np.float32)

    def _proto(self, speaker_id: int, emotion_id: int, level: float) -> np.ndarray:
        """Level-interpolated prototype vector (n_emo,) for one
        (speaker, emotion)."""
        levels = self.intensity_bank.shape[2]
        lv = float(np.clip(level, 0.0, levels - 1))
        lo, hi = int(np.floor(lv)), int(np.ceil(lv))
        frac = lv - lo
        proto = (1.0 - frac) * self.intensity_bank[speaker_id, emotion_id, lo]
        if frac:
            proto = proto + frac * self.intensity_bank[speaker_id, emotion_id, hi]
        return np.asarray(proto, np.float32)

    def intensity_for_mix(
        self,
        speaker,  # int id, or (n_speakers,) float blend weights
        emotion_mix,  # [(emotion_id, level, weight), ...]
        n_phones: int,
        scale: float = 1.0,
    ) -> np.ndarray:
        """Blended prototype conditioning: mix prototypes ACROSS emotions
        (0.6·amused + 0.4·sleepy) and, for a blended speaker, across the
        per-speaker prototype banks with the same weights used for the
        speaker-embedding blend.  Neutral (class 0) contributes zeros."""
        n_emo = self.cfg.n_emotions
        out = np.zeros((n_emo,), np.float32)
        if self.intensity_bank is not None:
            for emo, level, w in emotion_mix:
                if emo == 0 or w == 0.0:
                    continue
                if isinstance(speaker, np.ndarray):
                    proto = np.zeros((n_emo,), np.float32)
                    for s, ws in enumerate(speaker):
                        if ws:
                            proto += float(ws) * self._proto(s, emo, level)
                else:
                    proto = self._proto(int(speaker), emo, level)
                out += float(w) * proto
        out *= scale
        return np.broadcast_to(out, (n_phones, n_emo)).astype(np.float32)

    def synthesize_mels(
        self,
        phoneme_ids: np.ndarray,  # (P,)
        speakers: np.ndarray,  # (B,)
        intensity: np.ndarray,  # (B, P, n_emo)
        pace: float = 1.0,
        pitch_rate: float = 1.0,
        energy_rate: float = 1.0,
    ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Batched mel synthesis with predicted durations/pitch/energy.
        Returns device tensors: mel (B, max_mel_len, n_mels), mel_lens (B,)."""
        phon, spk, inten = self._bucket_pad(phoneme_ids, speakers, intensity)
        return self._mel_forward(
            phon, spk, inten, self.cfg.fastspeech2.max_mel_len,
            pace, pitch_rate, energy_rate,
        )

    def _bucket_pad(self, phoneme_ids, speakers, intensity):
        """Pad one phoneme sequence + per-row conditioning to its phone
        bucket; returns device tensors."""
        p_bucket = pick_bucket(len(phoneme_ids), self.cfg.bucketing.phone_buckets)
        if p_bucket < 0:
            p_bucket = len(phoneme_ids)
        b = len(speakers)
        phon = np.zeros((b, p_bucket), np.int32)
        phon[:, : len(phoneme_ids)] = phoneme_ids
        speakers = np.asarray(speakers)
        if speakers.ndim == 2:  # blend weights (B, n_speakers)
            spk = speakers.astype(np.float32)
        else:
            spk = speakers.astype(np.int32)
        inten = np.zeros((b, p_bucket, intensity.shape[-1]), np.float32)
        inten[:, : intensity.shape[1]] = intensity
        return self._to_device(phon), self._to_device(spk), self._to_device(inten)

    def synthesize_first_chunk(
        self,
        phoneme_ids: np.ndarray,  # (P,)
        speakers: np.ndarray,  # (B,)
        intensity: np.ndarray,  # (B, P, n_emo)
        window: int,  # mel frames vocoded right after the FS2 forward
        pace: float = 1.0,
        pitch_rate: float = 1.0,
        energy_rate: float = 1.0,
    ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """(int16 PCM of mel[:, :window], mel, mel_lens) as device tensors.
        The PCM is exact on rows whose content length ≥ window (true left
        edge and a full right halo inside the window); shorter rows must be
        vocoded again content-trimmed by the caller."""
        if self.vocoder is None:
            raise RuntimeError("no vocoder params loaded")
        phon, spk, inten = self._bucket_pad(phoneme_ids, speakers, intensity)
        return self._first_chunk(
            phon, spk, inten, self.cfg.fastspeech2.max_mel_len,
            pace, pitch_rate, energy_rate, window,
        )

    def vocode(self, mel: torch.Tensor,
               row_frame_budget: Optional[int] = None) -> torch.Tensor:
        """mel (B, T, n_mels) → int16 PCM device tensor (B, T·hop).

        Returns 16-bit PCM (the wav-file sample format) so the host transfer
        is half the size of float32; divide by 32767 for float waveforms.

        Batches whose rows × frames exceed ``inference.vocode_row_frames``
        are split into equal row-chunks of one shape (the generator's
        upsample intermediates scale with rows × samples)."""
        if self.vocoder is None:
            raise RuntimeError("no vocoder params loaded")
        budget = (self.cfg.inference.vocode_row_frames
                  if row_frame_budget is None else row_frame_budget)
        b, t = int(mel.shape[0]), int(mel.shape[1])
        if budget <= 0 or b * t <= budget:
            return self._vocode(mel)
        # rows per chunk such that every dispatch honors the budget; a
        # single row longer than the budget dispatches alone
        k = max(1, budget // t)
        k = -(-b // (-(-b // k)))  # rebalance: equal chunks, no pad waste
        outs = []
        for s in range(0, b, k):
            chunk = mel[s : s + k]
            pad = k - int(chunk.shape[0])
            if pad:  # keep ONE dispatch shape
                chunk = F.pad(chunk, (0, 0, 0, 0, 0, pad))
            pcm = self._vocode(chunk)
            outs.append(pcm[: k - pad] if pad else pcm)
        return torch.cat(outs, dim=0)

    def intensity_sweep(
        self, text: str, out_dir: Optional[str] = None
    ) -> Dict[Tuple[str, str, int], np.ndarray]:
        """The demo sweep: every (speaker, emotion, level) for one sentence —
        one batched device pass instead of 60 sequential forwards."""
        cfg = self.cfg
        ids = self.text_to_phoneme_ids(text)
        levels = cfg.inference.bucket_size
        combos = list(
            itertools.product(
                range(cfg.n_speakers), range(cfg.n_emotions), range(levels)
            )
        )
        speakers = np.array([s for s, _, _ in combos], np.int32)
        intensity = np.stack(
            [self.intensity_for(s, e, lv, len(ids)) for s, e, lv in combos]
        )
        mel, mel_lens = self.synthesize_mels(ids, speakers, intensity)
        wav = self.vocode(mel) if self.vocoder is not None else None

        hop = cfg.audio.hop_length
        mel_lens = mel_lens.cpu().numpy()  # (B,), tiny
        out: Dict[Tuple[str, str, int], np.ndarray] = {}
        if wav is not None:
            # transfer only the content span (padded capacity frames carry
            # no audio)
            t_max = int(mel_lens.max()) * hop
            wav_np = wav[:, :t_max].cpu().numpy().astype(np.float32) / 32767.0
            mel_np = None
        else:
            wav_np = None
            mel_np = mel.float().cpu().numpy()
        for i, (s, e, lv) in enumerate(combos):
            key = (cfg.data.speakers[s], cfg.data.emotions[e], lv)
            if wav_np is not None:
                out[key] = wav_np[i, : int(mel_lens[i]) * hop]
            else:
                out[key] = mel_np[i, : int(mel_lens[i])]
        if out_dir is not None:
            Path(out_dir).mkdir(parents=True, exist_ok=True)
            for (spk, emo, lv), item in out.items():
                if wav_np is not None:
                    write_wav(
                        os.path.join(out_dir, f"{spk}_{emo}_{lv}.wav"),
                        item,
                        cfg.audio.sampling_rate,
                    )
                else:  # no vocoder configured: persist the mels instead
                    np.save(
                        os.path.join(out_dir, f"{spk}_{emo}_{lv}_mel.npy"), item
                    )
        return out

    def synthesize_requests(
        self,
        requests,  # sequence of dicts: text, speaker, emotion[, level, scale]
        pace: float = 1.0,
        pitch_rate: float = 1.0,
        energy_rate: float = 1.0,
        gap_s: float = 0.15,
    ):
        """Serve a BATCH of long-form requests in one pass: every request's
        text is sentence-split, and all segments across all requests that
        share a phone bucket go through one FS2+vocoder forward — different
        speakers/emotions/levels mix freely within a batch row.  Device work
        is O(#distinct buckets), independent of request count.

        Returns one float32 waveform per request (sentences joined with
        ``gap_s`` of silence).  Prosody controls are shared per call.
        """
        if self.vocoder is None:
            raise RuntimeError("synthesize_requests requires vocoder params")
        cfg = self.cfg

        def _spk_spec(r):
            """int speaker id, or (n_speakers,) float weights for a blend."""
            mix = r.get("speaker_mix")
            if not mix:
                return int(r["speaker"])
            w = np.zeros((cfg.n_speakers,), np.float32)
            for sid, ws in (mix.items() if isinstance(mix, dict) else mix):
                w[int(sid)] += float(ws)  # duplicate entries accumulate
            total = w.sum()
            if total <= 0:
                raise ValueError("speaker_mix weights must sum > 0")
            return w / total

        def _emo_mix(r):
            """[(emotion_id, level, weight)] — pure requests become a
            single-entry mix so one code path conditions every row."""
            mix = r.get("emotion_mix")
            lvl = float(r.get("level", 0.0))
            if not mix:
                return [(int(r["emotion"]), lvl, 1.0)]
            out = []
            for entry in (mix.items() if isinstance(mix, dict) else mix):
                if len(entry) == 2:
                    emo, w = entry
                    out.append((int(emo), lvl, float(w)))
                else:
                    emo, elvl, w = entry
                    out.append((int(emo), float(elvl), float(w)))
            total = sum(w for _, _, w in out)
            if total <= 0:
                raise ValueError("emotion_mix weights must sum > 0")
            return [(e, l, w / total) for e, l, w in out]

        segs = []  # (request_idx, order_in_request, ids, spk_spec, emo_mix, scale)
        for r_i, r in enumerate(requests):
            if r.get("phonemes"):
                # direct ARPABET input (pronunciation override / SSML
                # <phoneme ph=...>): bypasses G2P entirely
                from emotts_torch.text.vocab import (filter_to_vocab,
                                                     phoneme_to_sequence)

                phones = (r["phonemes"].split()
                          if isinstance(r["phonemes"], str)
                          else list(r["phonemes"]))
                kept = filter_to_vocab(phones)
                if len(kept) != len(phones):
                    raise ValueError(
                        f"request {r_i}: non-ARPABET phoneme tokens "
                        f"{[p for p in phones if p not in kept]}"
                    )
                seq = np.asarray(phoneme_to_sequence(kept), np.int32)
                seqs = [seq] if len(seq) else []
            else:
                sentences = split_sentences(r["text"])
                seqs = [self.text_to_phoneme_ids(s) for s in sentences]
                seqs = [s for s in seqs if len(s) > 0]
            if not seqs:
                raise ValueError(
                    f"request {r_i}: no synthesizable sentences in text"
                )
            for s_i, ids in enumerate(seqs):
                segs.append((
                    r_i, s_i, ids, _spk_spec(r), _emo_mix(r),
                    float(r.get("scale", 1.0)),
                ))

        groups: Dict[int, list] = {}
        for g_i, seg in enumerate(segs):
            pb = pick_bucket(len(seg[2]), cfg.bucketing.phone_buckets)
            if pb < 0:
                pb = len(seg[2])
            groups.setdefault(pb, []).append(g_i)

        pieces: Dict[Tuple[int, int], np.ndarray] = {}
        hop = cfg.audio.hop_length
        for pb, idxs in sorted(groups.items()):
            b = len(idxs)
            phon = np.zeros((b, pb), np.int32)
            inten = np.zeros((b, pb, cfg.n_emotions), np.float32)
            # one blended row ⇒ the whole batch uses the weights path
            # (pure rows become one-hot, numerically identical to id lookup)
            blended = any(isinstance(segs[g][3], np.ndarray) for g in idxs)
            if blended:
                spk = np.zeros((b, cfg.n_speakers), np.float32)
            else:
                spk = np.zeros((b,), np.int32)
            for row, g_i in enumerate(idxs):
                r_i, s_i, ids, spk_spec, emo_mix, scale = segs[g_i]
                phon[row, : len(ids)] = ids
                if blended:
                    if isinstance(spk_spec, np.ndarray):
                        spk[row] = spk_spec
                    else:
                        spk[row, int(spk_spec)] = 1.0
                else:
                    spk[row] = spk_spec
                inten[row, : len(ids)] = self.intensity_for_mix(
                    spk_spec, emo_mix, len(ids), scale=scale
                )
            mel, mel_lens = self._mel_forward(
                self._to_device(phon), self._to_device(spk),
                self._to_device(inten), cfg.fastspeech2.max_mel_len,
                pace, pitch_rate, energy_rate,
            )
            pcm = self.vocode(mel)  # int16 (B, T·hop) on device
            lens = mel_lens.cpu().numpy()
            t_max = int(lens.max()) * hop
            pcm_np = pcm[:, :t_max].cpu().numpy()
            for row, g_i in enumerate(idxs):
                r_i, s_i = segs[g_i][0], segs[g_i][1]
                pieces[(r_i, s_i)] = (
                    pcm_np[row, : int(lens[row]) * hop].astype(np.float32)
                    / 32767.0
                )

        gap = np.zeros(int(gap_s * cfg.audio.sampling_rate), np.float32)
        parts_by_request: list = [[] for _ in requests]
        for r_i, s_i, *_ in segs:  # segs is ordered by (request, sentence)
            parts_by_request[r_i].append(pieces[(r_i, s_i)])
        out = []
        for parts in parts_by_request:
            chunks: list = []
            for i, piece in enumerate(parts):
                if i:
                    chunks.append(gap)
                chunks.append(piece)
            out.append(np.concatenate(chunks))
        return out

    def synthesize_ssml(
        self,
        markup: str,
        speaker: int = 0,  # defaults for spans without overrides
        emotion: int = 0,
        level: float = 0.0,
        intensity_scale: float = 1.0,
        pace: float = 1.0,
        pitch_rate: float = 1.0,
        energy_rate: float = 1.0,
        gap_s: float = 0.15,  # between sentences within a span
        span_gap_s: float = 0.05,  # between adjacent control spans
    ) -> np.ndarray:
        """Render SSML-lite markup (emotts_torch/text/ssml.py) to one waveform.

        Span-level <voice>/<emotion>/<prosody rate>/<phoneme>/<break>
        control inside one utterance.  All spans sharing a speaking rate
        render through ONE ``synthesize_requests`` call, so device work
        stays O(#distinct buckets × #distinct rates).
        """
        from emotts_torch.text.ssml import SSMLError, parse_ssml

        cfg = self.cfg
        segs = parse_ssml(markup)

        def rid(value, table, what, default):
            if value is None:
                return default
            try:
                return resolve_name(value, table, what)
            except ValueError as e:
                raise SSMLError(str(e)) from None

        jobs: Dict[float, list] = {}  # rate -> [(segment_index, request)]
        for i, seg in enumerate(segs):
            if seg.kind == "break":
                continue
            c = seg.controls
            req = {
                "speaker": rid(c.speaker, list(cfg.data.speakers),
                               "speaker", speaker),
                "emotion": rid(c.emotion, list(cfg.data.emotions),
                               "emotion", emotion),
                "level": level if c.level is None else c.level,
                "scale": intensity_scale if c.scale is None else c.scale,
            }
            if seg.kind == "phonemes":
                req["phonemes"] = seg.phonemes
            else:
                req["text"] = seg.text
            rate = 1.0 if c.rate is None else float(c.rate)
            if rate <= 0:
                raise SSMLError(f"prosody rate must be > 0, got {rate}")
            jobs.setdefault(rate, []).append((i, req))
        if not jobs:
            raise SSMLError("no synthesizable content in SSML input")

        waves: Dict[int, np.ndarray] = {}
        for rate, items in sorted(jobs.items()):
            # SSML rate is a SPEED multiplier; FS2 ``pace`` multiplies
            # durations (pace 0.5 = faster) — so rate maps to pace/rate
            outs = self.synthesize_requests(
                [r for _, r in items], pace=pace / rate,
                pitch_rate=pitch_rate, energy_rate=energy_rate, gap_s=gap_s,
            )
            for (i, _), w in zip(items, outs):
                waves[i] = w

        sr = cfg.audio.sampling_rate
        parts: list = []
        prev_spoken = False
        for i, seg in enumerate(segs):
            if seg.kind == "break":
                parts.append(np.zeros(int(seg.seconds * sr), np.float32))
                prev_spoken = False
            else:
                if prev_spoken:
                    parts.append(np.zeros(int(span_gap_s * sr), np.float32))
                parts.append(waves[i])
                prev_spoken = True
        return np.concatenate(parts)

    def synthesize_text(
        self,
        text: str,
        speaker_id: int,
        emotion_id: int,
        level: float = 0,
        pace: float = 1.0,
        pitch_rate: float = 1.0,
        energy_rate: float = 1.0,
        gap_s: float = 0.15,
        intensity_scale: float = 1.0,
        speaker_mix=None,  # [(speaker_id, weight), ...] — blended voice
        emotion_mix=None,  # [(emotion_id[, level], weight), ...] — blended affect
    ) -> np.ndarray:
        """Long-form synthesis: split ``text`` into sentences, batch sentences
        that share a phone bucket through one pass each, vocode, and stitch
        the waveforms in order with ``gap_s`` of silence between sentences.
        Returns a float32 waveform in [-1, 1]."""
        req = {
            "text": text, "speaker": speaker_id, "emotion": emotion_id,
            "level": level, "scale": intensity_scale,
        }
        if speaker_mix:
            req["speaker_mix"] = speaker_mix
        if emotion_mix:
            req["emotion_mix"] = emotion_mix
        return self.synthesize_requests(
            [req],
            pace=pace, pitch_rate=pitch_rate, energy_rate=energy_rate,
            gap_s=gap_s,
        )[0]


def load_synthesizer(cfg: Config, fs2_exp: Optional[str] = None,
                     rank_exp: Optional[str] = None,
                     device: str = "cuda",
                     mesh: Optional[Mesh] = None) -> Synthesizer:
    """Assemble a Synthesizer from this package's experiment directories:
    the FS2 experiment's ``best/`` export, the rank experiment's
    ``intensity.npy`` (absent: neutral conditioning) and the vocoder
    checkpoint of ``inference.vocoder_checkpoint``, ``.npz`` or torch
    ``.pt`` (absent: mels only).  The directories default to
    ``<experiment_path>/fastspeech2/<inference.fs2_exp>`` and
    ``<experiment_path>/rank_model/<inference.rank_exp>``.  On a CUDA
    device the loaded generator runs through the vocoder kernels
    (``fused_mrf``, ``use_pallas_resblocks``).

    ``mesh`` shards the batches over its devices.  Without one, the default
    ``mesh.data_parallel: -1`` engages every GPU where there are several
    (``parallel.mesh.serving_mesh``): the mesh engages only where it would
    span more than one device, as the reference's does."""
    if mesh is None:
        mesh = serving_mesh(cfg.mesh, device)
    fs2_exp = fs2_exp or os.path.join(
        cfg.data.experiment_path, "fastspeech2", cfg.inference.fs2_exp)
    rank_exp = rank_exp or os.path.join(
        cfg.data.experiment_path, "rank_model", cfg.inference.rank_exp)
    fs2_params = load_best_params(fs2_exp)
    intensity_path = os.path.join(rank_exp, "intensity.npy")
    bank = np.load(intensity_path) if os.path.exists(intensity_path) else None
    vocoder = maybe_load_vocoder(cfg)
    structure = (None if vocoder is None
                 else kernel_vocoder_structure(cfg, vocoder, device))
    return Synthesizer(cfg, fs2_params, vocoder, bank,
                       vocoder_structure=structure, device=device, mesh=mesh)


def save_vocoder_params_npz(params: Mapping, path: str) -> None:
    """Flatten a vocoder's ``{'params': tree}`` (numpy leaves, e.g.
    ``hifigan_to_flax`` of a generator's state_dict) to the ``.npz`` that
    ``load_vocoder_checkpoint`` reads: keys ``a/b/c``."""
    flat: Dict[str, np.ndarray] = {}

    def walk(node, prefix=""):
        for k, v in node.items():
            if isinstance(v, Mapping):
                walk(v, f"{prefix}{k}/")
            else:
                flat[f"{prefix}{k}"] = np.asarray(v)

    walk(params["params"])
    np.savez(path, **flat)


def maybe_load_vocoder(cfg: Config) -> Optional[dict]:
    """Load ``cfg.inference.vocoder_checkpoint`` if configured, warning
    (rather than silently degrading) when the configured path is missing.
    Returns None when no vocoder is configured or found."""
    ckpt = cfg.inference.vocoder_checkpoint
    if not ckpt:
        return None
    if not os.path.exists(ckpt):
        print(
            f"[vocoder] WARNING: inference.vocoder_checkpoint={ckpt!r} does "
            "not exist — continuing without a vocoder (mel-only outputs)",
            file=sys.stderr,
        )
        return None
    return load_vocoder_checkpoint(ckpt)
