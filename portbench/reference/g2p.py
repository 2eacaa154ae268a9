"""Phone ids of the generated sentences, from the frozen word list's
pronunciations and the configuration's phone table: '@' (the pad, id 0),
then the 84 ARPABET symbols (15 vowels with no stress and stresses 0-2,
24 consonants) sorted, then sil, spn, sp and the empty token."""

from __future__ import annotations

from pathlib import Path
from typing import Dict, List

WORDS = Path(__file__).resolve().parents[1] / "traffic" / "words.txt"

_VOWELS = "AA AE AH AO AW AY EH ER EY IH IY OW OY UH UW".split()
_CONSONANTS = "B CH D DH F G HH JH K L M N NG P R S SH T TH V W Y Z ZH".split()
TOKENS = (["@"] + sorted([v + s for v in _VOWELS for s in ("", "0", "1", "2")]
                         + _CONSONANTS) + ["sil", "spn", "sp", ""])
_ID = {t: i for i, t in enumerate(TOKENS)}


def pronunciations(path: Path = WORDS) -> Dict[str, List[str]]:
    out = {}
    for line in path.read_text().splitlines():
        if line and not line.startswith("#"):
            word, *phones = line.split()
            out[word] = phones
    return out


def phone_ids(sentence: str, prons: Dict[str, List[str]]) -> List[int]:
    """A generated sentence: lower-case words of the list, one full stop."""
    return [_ID[p] for w in sentence.rstrip(".").split() for p in prons[w]]
