"""Phoneme vocabulary.

Token inventory matches the reference (fastspeech2/util.py:11-12):
``['@'] + ARPABET valid_symbols (84) + ['sil', 'spn', 'sp', '']`` = 89 tokens,
with '@' at index 0 doubling as the padding id.  The model's embedding table
is sized ``n_char`` (95 in the reference config) to leave headroom.
"""

from __future__ import annotations

from typing import List, Sequence

# ARPABET symbols with stress markers (CMUdict convention).
_VOWELS = [
    "AA", "AE", "AH", "AO", "AW", "AY", "EH", "ER", "EY", "IH", "IY",
    "OW", "OY", "UH", "UW",
]
_CONSONANTS = [
    "B", "CH", "D", "DH", "F", "G", "HH", "JH", "K", "L", "M", "N", "NG",
    "P", "R", "S", "SH", "T", "TH", "V", "W", "Y", "Z", "ZH",
]

VALID_SYMBOLS: List[str] = sorted(
    [v for vowel in _VOWELS for v in (vowel, vowel + "0", vowel + "1", vowel + "2")]
    + _CONSONANTS
)

SIL_PHONES = ["sil", "spn", "sp", ""]

PAD = "@"
VALID_TOKENS: List[str] = [PAD] + VALID_SYMBOLS + SIL_PHONES
PAD_ID = 0

_TOKEN_TO_ID = {t: i for i, t in enumerate(VALID_TOKENS)}


def vocab_size() -> int:
    return len(VALID_TOKENS)


def phoneme_to_sequence(phonemes: Sequence[str]) -> List[int]:
    """Map phoneme tokens to ids (reference: fastspeech2/util.py:30-32)."""
    return [_TOKEN_TO_ID[p] for p in phonemes]


def sequence_to_phoneme(sequence: Sequence[int]) -> List[str]:
    return [VALID_TOKENS[i] for i in sequence]


def filter_to_vocab(phonemes: Sequence[str]) -> List[str]:
    """Drop tokens outside the vocabulary (reference: fastspeech2/util.py:26)."""
    return [p for p in phonemes if p in _TOKEN_TO_ID]
