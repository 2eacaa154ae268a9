"""Text cleaners with ``english_cleaners`` semantics.

The reference delegates cleaning to SpeechBrain's ``_clean_text(text,
['english_cleaners'])`` (fastspeech2/util.py:24, rank_model/prepare_mfa.py:24):
ascii transliteration → lowercase → number expansion → abbreviation
expansion → whitespace collapsing.  Re-implemented here without the
dependency.
"""

from __future__ import annotations

import re
import unicodedata

from emotts_torch.text.numbers import normalize_numbers

_whitespace_re = re.compile(r"\s+")

_ABBREVIATIONS = [
    (re.compile(rf"\b{abbr}\.", re.IGNORECASE), full)
    for abbr, full in [
        ("mrs", "misess"),
        ("mr", "mister"),
        ("dr", "doctor"),
        ("st", "saint"),
        ("co", "company"),
        ("jr", "junior"),
        ("maj", "major"),
        ("gen", "general"),
        ("drs", "doctors"),
        ("rev", "reverend"),
        ("lt", "lieutenant"),
        ("hon", "honorable"),
        ("sgt", "sergeant"),
        ("capt", "captain"),
        ("esq", "esquire"),
        ("ltd", "limited"),
        ("col", "colonel"),
        ("ft", "fort"),
    ]
]


def convert_to_ascii(text: str) -> str:
    """Transliterate to ASCII (NFKD-decompose and drop combining marks)."""
    normalized = unicodedata.normalize("NFKD", text)
    return normalized.encode("ascii", "ignore").decode("ascii")


def lowercase(text: str) -> str:
    return text.lower()


def expand_abbreviations(text: str) -> str:
    for regex, replacement in _ABBREVIATIONS:
        text = regex.sub(replacement, text)
    return text


def collapse_whitespace(text: str) -> str:
    return _whitespace_re.sub(" ", text)


def english_cleaners(text: str) -> str:
    """Full English pipeline: ascii → lowercase → numbers → abbreviations → ws."""
    text = convert_to_ascii(text)
    text = lowercase(text)
    text = normalize_numbers(text)
    text = expand_abbreviations(text)
    text = collapse_whitespace(text)
    return text


def basic_cleaners(text: str) -> str:
    return collapse_whitespace(lowercase(text))


# spoken expansions for symbols the word tokenizer would otherwise drop
# silently ("a 5% raise" losing "percent").  NOT part of english_cleaners —
# that stays bit-identical to the reference pipeline (corpus .lab files for
# MFA must match, prepare_mfa.py:24); the synthesis-side G2P opts in.
_SYMBOLS = [
    (re.compile(r"%"), " percent "),
    (re.compile(r"&"), " and "),
    (re.compile(r"\+"), " plus "),
    (re.compile(r"@"), " at "),
    (re.compile(r"#"), " number "),
    (re.compile(r"="), " equals "),
    (re.compile(r"°"), " degrees "),
]


def expand_symbols(text: str) -> str:
    for regex, replacement in _SYMBOLS:
        text = regex.sub(replacement, text)
    return collapse_whitespace(text)


_CLEANERS = {
    "english_cleaners": english_cleaners,
    "basic_cleaners": basic_cleaners,
    "expand_symbols": expand_symbols,
}


def clean_text(text: str, cleaner_names=("english_cleaners",)) -> str:
    for name in cleaner_names:
        if name not in _CLEANERS:
            raise KeyError(f"unknown cleaner: {name}")
        text = _CLEANERS[name](text)
    return text
