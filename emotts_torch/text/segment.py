"""Sentence segmentation for long-form synthesis.

The reference synthesizes exactly one configured sentence
(fastspeech2/inference.py:55); long-form input must be split into
utterance-sized pieces before FastSpeech2 (whose decoder has a fixed
max_mel_len capacity).  This is a deterministic rule splitter: terminal
punctuation ends a sentence unless it closes a known abbreviation or a
single-letter initial; decimals never split (the regex requires whitespace
or end-of-text after the punctuation).
"""

from __future__ import annotations

import re
from typing import List

_TERMINAL = re.compile(r"([.!?;]+)[\"')\]]*(\s+|$)")

# dotted acronyms like "u.s", "e.g", "p.m" (the final "." is the terminal
# match itself) — treated as mid-sentence, same as single-letter initials
_DOTTED_ACRONYM = re.compile(r"([a-z]\.)+[a-z]?$")

_ABBREVIATIONS = {
    "mr", "mrs", "ms", "dr", "prof", "rev", "gen", "col", "capt", "sgt",
    "st", "mt", "ft", "etc", "vs", "eg", "ie", "cf", "al", "jr", "sr",
    "no", "vol", "pp", "inc", "co", "corp", "ltd", "dept", "univ",
    "jan", "feb", "mar", "apr", "jun", "jul", "aug", "sep", "sept",
    "oct", "nov", "dec", "mon", "tue", "wed", "thu", "fri", "sat", "sun",
}


def split_sentences(text: str) -> List[str]:
    """Split text into sentences (whitespace-trimmed, punctuation kept)."""
    out: List[str] = []
    start = 0
    for m in _TERMINAL.finditer(text):
        before = text[start : m.start()].rstrip()
        words = before.split()
        last = words[-1].lower().strip("\"'([") if words else ""
        if m.group(1).startswith(".") and (
            last in _ABBREVIATIONS
            # single-letter initial ("J. R. Tolkien") — but NOT the pronoun
            # "I", which commonly ends a sentence ("So did I.")
            or (len(last) == 1 and last.isalpha() and last != "i")
            # multi-letter dotted acronym ("The U.S. economy grew.")
            or _DOTTED_ACRONYM.fullmatch(last) is not None
        ):
            continue  # abbreviation or initial, not a boundary
        seg = text[start : m.end()].strip()
        if seg:
            out.append(seg)
        start = m.end()
    tail = text[start:].strip()
    if tail:
        out.append(tail)
    return out
