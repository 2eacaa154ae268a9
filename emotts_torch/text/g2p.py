"""Grapheme-to-phoneme frontend.

The reference uses the pretrained SpeechBrain ``soundchoice-g2p`` neural model
(fastspeech2/util.py:20-27, downloaded from HuggingFace).  In a hermetic TPU
deployment we instead use a **pronunciation lexicon** (CMUdict format — the
same lexicon family MFA aligns with, readme.md:57) with a deterministic
rule-based letter-to-sound fallback for out-of-vocabulary words.  The output
contract is identical: ARPABET tokens filtered to the model vocabulary.
"""

from __future__ import annotations

import re
from pathlib import Path
from typing import Dict, List, Optional

from emotts_torch.text import homograph
from emotts_torch.text.cleaners import clean_text
from emotts_torch.text.vocab import filter_to_vocab, phoneme_to_sequence

_WORD_RE = homograph.WORD_RE  # single shared tokenizer (see homograph.py)

# ---------------------------------------------------------------------------
# Rule-based letter-to-sound fallback.
# Longest-match substring rules, applied left to right.  This is intentionally
# compact — the lexicon covers normal vocabulary; rules only catch OOVs.
# ---------------------------------------------------------------------------

_LTS_RULES: List[tuple] = [
    # multigraph rules first (longest match wins)
    ("tion", ["SH", "AH0", "N"]),
    ("sion", ["ZH", "AH0", "N"]),
    ("ought", ["AO1", "T"]),
    ("aught", ["AO1", "T"]),
    ("ight", ["AY1", "T"]),
    ("tch", ["CH"]),
    ("sch", ["S", "K"]),
    ("dge", ["JH"]),
    ("igh", ["AY1"]),
    ("eau", ["OW1"]),
    ("ais", ["EY1"]),
    ("ing", ["IH0", "NG"]),
    ("qu", ["K", "W"]),
    ("ch", ["CH"]),
    ("ck", ["K"]),
    ("sh", ["SH"]),
    ("th", ["TH"]),
    ("ph", ["F"]),
    ("wh", ["W"]),
    ("ng", ["NG"]),
    ("gh", ["G"]),
    ("kn", ["N"]),
    ("wr", ["R"]),
    ("ee", ["IY1"]),
    ("ea", ["IY1"]),
    ("oo", ["UW1"]),
    ("ou", ["AW1"]),
    ("ow", ["OW1"]),
    ("oi", ["OY1"]),
    ("oy", ["OY1"]),
    ("ay", ["EY1"]),
    ("ai", ["EY1"]),
    ("au", ["AO1"]),
    ("aw", ["AO1"]),
    ("ey", ["IY1"]),
    ("ie", ["IY1"]),
    ("oa", ["OW1"]),
    ("ue", ["UW1"]),
    ("ui", ["UW1"]),
    ("ar", ["AA1", "R"]),
    ("er", ["ER0"]),
    ("ir", ["ER1"]),
    ("or", ["AO1", "R"]),
    ("ur", ["ER1"]),
    ("a", ["AE1"]),
    ("b", ["B"]),
    ("c", ["K"]),
    ("d", ["D"]),
    ("e", ["EH1"]),
    ("f", ["F"]),
    ("g", ["G"]),
    ("h", ["HH"]),
    ("i", ["IH1"]),
    ("j", ["JH"]),
    ("k", ["K"]),
    ("l", ["L"]),
    ("m", ["M"]),
    ("n", ["N"]),
    ("o", ["AA1"]),
    ("p", ["P"]),
    ("r", ["R"]),
    ("s", ["S"]),
    ("t", ["T"]),
    ("u", ["AH1"]),
    ("v", ["V"]),
    ("w", ["W"]),
    ("x", ["K", "S"]),
    ("y", ["Y"]),
    ("z", ["Z"]),
    ("'", []),
]
_LTS_BY_LEN: List[tuple] = sorted(_LTS_RULES, key=lambda r: -len(r[0]))


def letter_to_sound(word: str) -> List[str]:
    """Deterministic rule-based fallback for OOV words."""
    word = word.lower()
    # collapse doubled consonants (letter → single sound)
    word = re.sub(r"([bcdfgklmnprstvz])\1", r"\1", word)
    phones: List[str] = []
    i = 0
    while i < len(word):
        # 'y' as a vowel: word-final (happy → IY0) or before a consonant
        # (syllable → IH1)
        if word[i] == "y" and len(word) > 1:
            if i == len(word) - 1:
                phones.append("IY0")
                i += 1
                continue
            if i > 0 and word[i + 1] not in "aeiouy":
                phones.append("ER0" if word[i + 1] == "r" else "IH1")
                i += 2 if word[i + 1] == "r" else 1
                continue
        for pat, ph in _LTS_BY_LEN:
            if word.startswith(pat, i):
                # trailing silent 'e'
                if pat == "e" and i == len(word) - 1 and len(word) > 2:
                    i += 1
                    break
                phones.extend(ph)
                i += len(pat)
                break
        else:  # unknown character: skip
            i += 1
    return phones


# ---------------------------------------------------------------------------
# Morphological decomposition: extend lexicon coverage to regular inflections
# (plays, played, playing, quickly, ...) without listing every form.
# ---------------------------------------------------------------------------

_VOICELESS = {"P", "T", "K", "F", "TH", "S", "SH", "CH", "HH"}
_SIBILANT = {"S", "Z", "SH", "ZH", "CH", "JH"}

# packaged default lexicon (band-curated CMUdict-format vocabulary)
# the data files are shared with the JAX package by path, not duplicated
_DATA_DIR = Path(__file__).resolve().parents[2] / "emotts" / "text" / "data"
BUNDLED_LEXICON = str(_DATA_DIR / "lexicon_en.dict")

# stress-neutral derivational suffixes: phonetic concatenation onto the
# base pronunciation (careful, hopeless, payment, neighborhood, friendship)
_NEUTRAL_SUFFIXES = (
    ("ful", ["F", "AH0", "L"]),
    ("less", ["L", "AH0", "S"]),
    ("ment", ["M", "AH0", "N", "T"]),
    ("hood", ["HH", "UH2", "D"]),
    ("ship", ["SH", "IH2", "P"]),
)

# stress-neutral prefixes (secondary stress on heavy prefixes, reduced on
# light ones — CMUdict convention: overlook OW2 V ER0 L UH1 K,
# understand AH2 N D ER0 ..., distrust D IH0 S ..., preheat P R IY0 ...)
_NEUTRAL_PREFIXES = (
    ("counter", ["K", "AW2", "N", "T", "ER0"]),
    ("pseudo", ["S", "UW2", "D", "OW0"]),
    ("under", ["AH2", "N", "D", "ER0"]),
    ("inter", ["IH2", "N", "T", "ER0"]),
    ("super", ["S", "UW2", "P", "ER0"]),
    ("multi", ["M", "AH2", "L", "T", "IY0"]),
    ("micro", ["M", "AY2", "K", "R", "OW0"]),
    ("ultra", ["AH2", "L", "T", "R", "AH0"]),
    ("anti", ["AE2", "N", "T", "IY0"]),
    ("semi", ["S", "EH2", "M", "IY0"]),
    ("auto", ["AO2", "T", "OW0"]),
    ("mega", ["M", "EH2", "G", "AH0"]),
    ("mini", ["M", "IH2", "N", "IY0"]),
    ("over", ["OW2", "V", "ER0"]),
    ("non", ["N", "AA2", "N"]),
    ("out", ["AW2", "T"]),
    ("dis", ["D", "IH0", "S"]),
    ("mis", ["M", "IH0", "S"]),
    ("sub", ["S", "AH2", "B"]),
    ("pre", ["P", "R", "IY0"]),
    ("un", ["AH0", "N"]),
    ("re", ["R", "IY0"]),
)


def _strip_stressless(ph: str) -> str:
    return ph.rstrip("012")


def _s_suffix(base: List[str]) -> List[str]:
    last = _strip_stressless(base[-1])
    if last in _SIBILANT:
        return base + ["IH0", "Z"]
    if last in _VOICELESS:
        return base + ["S"]
    return base + ["Z"]


def _ed_suffix(base: List[str]) -> List[str]:
    last = _strip_stressless(base[-1])
    if last in ("T", "D"):
        return base + ["AH0", "D"]
    if last in _VOICELESS:
        return base + ["T"]
    return base + ["D"]


class G2P:
    """Lexicon-first G2P with morphological, neural, and rule fallbacks.

    Output contract matches the reference ``text2phoneme``
    (fastspeech2/util.py:20-27): cleaned text → ARPABET tokens → filtered to
    the model vocabulary.  Lookup chain per word:

    1. bundled/user **lexicon** (exact pronunciations),
    2. **morphological decomposition** of regular inflections against it,
    3. the bundled **neural G2P** (trained transformer — the counterpart of
       the reference's SoundChoice model; ``emotts_torch/text/neural_g2p.py``),
    4. deterministic **rule LTS** (last resort / neural-unavailable path).

    Pass ``lexicon_path`` to extend/override the bundled lexicon,
    ``bundled=False`` for pure-rule behavior, or ``neural=False`` to disable
    the trained fallback.
    """

    def __init__(
        self,
        lexicon_path: Optional[str] = None,
        bundled: bool = True,
        neural: bool = True,
        neural_beam: int = 1,
    ):
        self.lexicon: Dict[str, List[str]] = {}
        if bundled:
            self.load_lexicon(BUNDLED_LEXICON)
        if lexicon_path:
            self.load_lexicon(lexicon_path, override=True)
        self.neural = None
        # memoizes neural-tier decodes only: an autoregressive numpy decode
        # is ~16 ms/word (d256) — paid once per novel OOV, not per mention
        self._neural_memo: Dict[str, List[str]] = {}
        if neural:
            from emotts_torch.text.neural_g2p import BUNDLED_WEIGHTS, NeuralG2P

            if NeuralG2P.available(BUNDLED_WEIGHTS):
                self.neural = NeuralG2P(BUNDLED_WEIGHTS, beam=neural_beam)

    def load_lexicon(self, path: str, override: bool = False) -> None:
        """Load a CMUdict-format lexicon: ``WORD  PH1 PH2 ...`` per line.

        Alternate pronunciations (``WORD(2)``) are ignored; within one file
        the first entry wins.  ``override=True`` lets this file's entries
        replace previously loaded ones (user lexicon over bundled).
        """
        seen = set()
        for line in Path(path).read_text(errors="ignore").splitlines():
            line = line.strip()
            if not line or line.startswith(";;;"):
                continue
            parts = line.split()
            word = parts[0].lower()
            if "(" in word:  # alternate pronunciation
                continue
            if word in seen:
                continue
            seen.add(word)
            if override or word not in self.lexicon:
                self.lexicon[word] = parts[1:]

    def _morph(self, word: str) -> Optional[List[str]]:
        """Regular-inflection decomposition against the lexicon."""
        lex = self.lexicon

        def base(*cands):
            for c in cands:
                if c and c in lex:
                    return list(lex[c])
            return None

        if word.endswith("'s") or word.endswith("s'"):
            b = base(word[:-2])
            if b:
                return _s_suffix(b)
        if word.endswith("ies") and len(word) > 4:
            b = base(word[:-3] + "y")
            if b:
                return _s_suffix(b)
        if word.endswith("es"):
            b = base(word[:-2])
            if b and _strip_stressless(b[-1]) in _SIBILANT:
                return _s_suffix(b)
        if word.endswith("s") and not word.endswith("ss"):
            # the stem may itself be a derived form (nonsmokers, rematches,
            # misjudgments): recurse once past the lexicon lookup
            b = base(word[:-1]) or self._morph(word[:-1])
            if b:
                return _s_suffix(b)
        if word.endswith("ied") and len(word) > 4:
            b = base(word[:-3] + "y")
            if b:
                return _ed_suffix(b)
        if word.endswith("ed") and len(word) > 3:
            stem = word[:-2]
            degem = stem[:-1] if len(stem) > 2 and stem[-1] == stem[-2] else None
            # degem first (doubled consonant ⇒ short-vowel stem), then the
            # e-dropping base BEFORE the bare stem: an undoubled stem whose
            # +e form exists almost always came from it ('used' → use, not
            # 'us'; 'noted' → note, not 'not')
            b = base(degem, stem + "e", stem)
            if b:
                return _ed_suffix(b)
        if word.endswith("ing") and len(word) > 4:
            stem = word[:-3]
            degem = stem[:-1] if len(stem) > 2 and stem[-1] == stem[-2] else None
            b = base(degem, stem + "e", stem)
            if b:
                return b + ["IH0", "NG"]
        if word.endswith("ily") and len(word) > 4:
            b = base(word[:-3] + "y")
            if b:  # happy → happily: final IY0 → AH0 + L IY0
                if b[-1] == "IY0":
                    b = b[:-1] + ["AH0"]
                return b + ["L", "IY0"]
        if word.endswith("ly") and len(word) > 3:
            b = base(word[:-2])
            if b:
                return b + ["L", "IY0"]
        if word.endswith("ness") and len(word) > 5:
            b = base(word[:-4])
            if b:
                return b + ["N", "AH0", "S"]
        if word.endswith("er") and len(word) > 3:
            stem = word[:-2]
            degem = stem[:-1] if len(stem) > 2 and stem[-1] == stem[-2] else None
            b = base(degem, stem + "e", stem)
            if b:
                return b + ["ER0"]
        if word.endswith("est") and len(word) > 4:
            stem = word[:-3]
            degem = stem[:-1] if len(stem) > 2 and stem[-1] == stem[-2] else None
            b = base(degem, stem + "e", stem)
            if b:
                return b + ["AH0", "S", "T"]
        # neutral suffixes: plain phonetic concatenation, no stress shift
        # (careful=care+ful, payment=pay+ment, neighborhood, friendship, ...)
        for suffix, ph in _NEUTRAL_SUFFIXES:
            if word.endswith(suffix) and len(word) > len(suffix) + 2:
                b = base(word[: -len(suffix)])
                if b:
                    return b + ph
        # e-drop suffixes: usable=use+able, childish=child+ish
        for suffix, ph in (("able", ["AH0", "B", "AH0", "L"]), ("ish", ["IH0", "SH"])):
            if word.endswith(suffix) and len(word) > len(suffix) + 1:
                stem = word[: -len(suffix)]
                degem = stem[:-1] if len(stem) > 2 and stem[-1] == stem[-2] else None
                b = base(degem, stem + "e", stem)
                if b:
                    return b + ph
        for prefix, ph in _NEUTRAL_PREFIXES:
            if word.startswith(prefix) and len(word) > len(prefix) + 2:
                rest = word[len(prefix) :]
                # prefix + inflected stem (outmaneuvered, underestimated,
                # unhappily): recurse so the suffix rules above apply to the
                # remainder; word length strictly decreases, so this
                # terminates.  Suffix rules run first, so plain inflections
                # never reach here.
                b = base(rest) or self._morph(rest)
                if b:
                    return ph + b
        return self._compound(word)

    def _compound(self, word: str) -> Optional[List[str]]:
        """Closed-compound decomposition: both halves in the lexicon.

        English compounds keep primary stress on the first element and
        demote the second element's primary to secondary (moonlight
        ``M UW1 N + L AY1 T`` → ``M UW1 N L AY2 T``).  Affix rules run
        first, so suffix-looking tails (-able, -er, -ness …) never reach
        here; among multiple valid splits the longest first element wins
        ("bookshops" resolves via the plural rule recursing into this).
        """
        lex = self.lexicon
        n = len(word)
        if n < 6:
            return None
        cands = []
        for i in range(3, n - 2):  # first part ≥3, second ≥3 chars
            a, b = word[:i], word[i:]
            pa = lex.get(a)
            if pa is None:
                continue
            # the second element may itself be inflected (daydreaming =
            # day + dream+ing); b is strictly shorter, so this terminates
            pb = lex.get(b) or self._morph(b)
            if pb is None:
                continue
            # both halves need a stressed vowel (reduced function words
            # make junk compounds)
            if not any(p.endswith(("1", "2")) for p in pa):
                continue
            if not any(p.endswith(("1", "2")) for p in pb):
                continue
            # prefer the most balanced split, then the longer second
            # element: "bookshops" → book|shops, not books|hop
            cands.append((min(i, n - i), n - i, list(pa), list(pb)))
        if not cands:
            return None
        _, _, pa, pb = max(cands, key=lambda c: (c[0], c[1]))
        return pa + [p[:-1] + "2" if p.endswith("1") else p for p in pb]

    def word_to_phonemes(self, word: str) -> List[str]:
        if word in self.lexicon:
            return list(self.lexicon[word])
        # inflected homograph-verb forms (recorded, closing, used) carry the
        # verb stress/voicing; plain morphology against the lexicon's noun
        # default would get them wrong — so this runs first
        infl = homograph.resolve_word(word)
        if infl:
            return infl
        morph = self._morph(word)
        if morph:
            return morph
        if self.neural is not None:
            hit = self._neural_memo.get(word)
            if hit is not None:
                return list(hit)
            hyp = self.neural.word_to_phonemes(word)
            if hyp:
                self._neural_memo[word] = list(hyp)
                return hyp
        return letter_to_sound(word)

    def explain(self, text: str) -> List[tuple]:
        """Per-word resolution trace: ``[(word, tier, phones), ...]``.

        Tier is one of ``homograph`` (context-aware table hit or inflected
        homograph stem), ``lexicon``, ``morphology``, ``neural``, ``lts`` —
        in lookup-chain order.  Drives the ``g2p`` CLI verb and keeps
        ``__call__`` and the debug surface on one code path.
        """
        # symbols expand BEFORE english_cleaners so "5.5%" → "5.5 percent"
        # → "five point five percent"; corpus prep (MFA .lab files) keeps
        # the reference-exact english_cleaners-only pipeline
        text = clean_text(text, ["expand_symbols", "english_cleaners"])
        words = _WORD_RE.findall(text)
        out: List[tuple] = []
        for i, word in enumerate(words):
            # sentence-level homograph disambiguation (the SoundChoice
            # capability the reference gets from its pretrained model)
            pron = homograph.resolve(words, i,
                                     in_lexicon=word in self.lexicon)
            if pron is not None:
                tier = "homograph"
            elif word in self.lexicon:
                tier, pron = "lexicon", list(self.lexicon[word])
            elif (infl := homograph.resolve_word(word)) is not None:
                tier, pron = "homograph", infl
            elif (morph := self._morph(word)) is not None:
                tier, pron = "morphology", morph
            else:
                hyp = (self.neural.word_to_phonemes(word)
                       if self.neural is not None else None)
                if hyp:
                    # POS-aware stress for true OOVs: where the homograph
                    # table abstains, unambiguous local context (to X /
                    # the X) applies the productive disyllabic noun/verb
                    # stress alternation to the neural hypothesis
                    pos = homograph.oov_pos(words, i)
                    if pos is not None:
                        hyp = homograph.shift_disyllable_stress(hyp, pos)
                    tier, pron = "neural", hyp
                else:
                    tier, pron = "lts", letter_to_sound(word)
            out.append((word, tier, filter_to_vocab(pron)))
        return out

    def __call__(self, text: str) -> List[str]:
        return [p for _, _, ph in self.explain(text) for p in ph]

    def text_to_sequence(self, text: str) -> List[int]:
        """Reference ``text2sequence`` (fastspeech2/util.py:14-17)."""
        return phoneme_to_sequence(self(text))
