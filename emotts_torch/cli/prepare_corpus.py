"""MFA corpus preparation: EmoV-DB → corpus/<speaker>/<emotion>_<id>.{wav,lab}.

Own copy of ``emotts/cli/prepare_corpus.py``.  Capability parity with the
reference prep script (rank_model/prepare_mfa.py:10-56): parse the
``cmuarctic.data`` transcript index (dropping the ``arctic_b`` set), clean each sentence with
english_cleaners and wrap it in the noise sentinel, resample every EmoV-DB
wav to the target rate, and emit the wav+lab corpus the Montreal Forced
Aligner consumes.  MFA itself remains an external offline tool
(readme.md:50-72); this framework owns everything before and after it.
"""

from __future__ import annotations

import os
from glob import glob
from pathlib import Path
from typing import Dict

from emotts_torch.audio.wavio import load_wav, write_wav
from emotts_torch.text.cleaners import clean_text
from emotts_torch.utils.config import Config


def parse_transcript_index(data_path: str, noise_symbol: str) -> Dict[str, str]:
    """cmuarctic.data lines look like ``( arctic_a0001 "..." )``; keep the
    a-set, key by the trailing 4-digit id, clean + wrap with the sentinel."""
    index: Dict[str, str] = {}
    path = Path(data_path) / "cmuarctic.data"
    for line in path.read_text(errors="ignore").splitlines():
        line = line.strip()
        if not line.startswith("("):
            continue
        try:
            head, text = line[1:].split('"', 1)
            text = text.rsplit('"', 1)[0]
        except ValueError:
            continue
        audio_id = head.strip()
        if audio_id.startswith("arctic_b"):
            continue
        key = audio_id[-4:]
        cleaned = noise_symbol + clean_text(text.strip()) + noise_symbol
        index[key] = cleaned.strip()
    return index


def prepare_corpus(cfg: Config, verbose: bool = True) -> int:
    """Resample + transcribe every available (speaker, emotion); returns the
    number of corpus utterances written.  Skips if the corpus already exists
    (same guard as the reference, prepare_mfa.py:76-82)."""
    data = cfg.data
    if os.path.exists(data.corpus_path):
        if verbose:
            print(f"[prepare] corpus exists at {data.corpus_path}, skipping")
        return 0
    index = parse_transcript_index(data.data_path, data.noise_symbol)
    n = 0
    for speaker in data.speakers:
        for emotion in data.emotions:
            src_dir = Path(data.data_path) / speaker / emotion
            if not src_dir.exists():  # e.g. josh has only 3 emotions
                continue
            out_dir = Path(data.corpus_path) / speaker
            out_dir.mkdir(parents=True, exist_ok=True)
            for wav_path in sorted(glob(str(src_dir / "*.wav"))):
                audio_id = os.path.basename(wav_path)[-8:-4]
                if audio_id not in index:
                    continue
                y = load_wav(wav_path, cfg.audio.sampling_rate)
                stem = out_dir / f"{emotion}_{audio_id}"
                write_wav(str(stem) + ".wav", y, cfg.audio.sampling_rate)
                (Path(str(stem) + ".lab")).write_text(index[audio_id] + "\n")
                n += 1
            if verbose:
                print(f"[prepare] {speaker}/{emotion} done")
    return n
