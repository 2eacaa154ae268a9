"""Context-aware homograph disambiguation.

The reference's G2P is SpeechBrain SoundChoice (fastspeech2/util.py:20-27),
whose headline capability over plain lexicon lookup is *sentence-level
homograph disambiguation* ("to record" vs "the record").  This module is the
hermetic counterpart: a curated table of English homographs — stress-
alternating noun/verb pairs (REcord/reCORD), final-consonant voicing pairs
(use S/Z), ``-ate`` adjective/verb pairs (separate AH0 T / EY2 T) and
vowel-quality homographs (read, live, wind, bow, tear, bass, dove) — plus a
deterministic part-of-speech-lite tagger over the cleaned word sequence.

Two entry points:

* :func:`resolve` — context-aware: given the full word list and a position,
  return the pronunciation for that occurrence, or ``None`` if the word is
  not homograph-related (or no contextual evidence contradicts the lexicon
  default, in which case the normal lexicon path applies).
* :func:`resolve_word` — context-free: handles *inflected* forms whose stem
  is a homograph verb (``recorded``, ``closing``, ``used``) where only the
  verb reading exists; plain morphological decomposition against the lexicon
  would wrongly inherit the noun/adjective stress or voicing
  (record → R EH1 K ER0 D + AH0 D instead of R IH0 K AO1 R D AH0 D).

Pronunciations follow CMUdict conventions, consistent with the bundled
lexicon: for every word the default tag reproduces the lexicon entry, so
behavior without contextual evidence is unchanged.
"""

from __future__ import annotations

import re
from typing import Dict, List, Optional, Tuple

# ---------------------------------------------------------------------------
# Homograph table.
#
# Tags: "n" noun (or the noun-stress reading), "v" verb, "a" adjective
# (when phonemically distinct from the noun reading), "past" past/participle
# reading of tense homographs.  "d" names the default tag — always the
# bundled-lexicon pronunciation when the word is in the lexicon.
# Optional keys:
#   "next": {next-word: tag} hard overrides ("close to" → n, "wound up" → past)
#   "cues"/"cue_tag": nearby content words forcing a reading (lead + pipe)
#   "er": tag used to derive agentive -er forms (recorder); omitted where
#         -er is a comparative that keeps the base reading (closer).
# ---------------------------------------------------------------------------

H: Dict[str, Dict] = {
    # --- tense / vowel-quality homographs ---
    "read": dict(v="R IY1 D", past="R EH1 D", d="v"),
    "live": dict(v="L IH1 V", a="L AY1 V", d="v"),
    "wind": dict(n="W IH1 N D", v="W AY1 N D", d="n", ed="n",
                 next={"up": "v", "down": "v", "around": "v"}),
    "wound": dict(n="W UW1 N D", past="W AW1 N D", d="n",
                  next={"up": "past", "down": "past", "around": "past"}),
    "bow": dict(v="B AW1", n="B OW1", d="v",
                cues={"arrow", "arrows", "tie", "ribbon", "violin", "hair"},
                cue_tag="n"),
    "sow": dict(v="S OW1", n="S AW1", d="v"),
    "dove": dict(n="D AH1 V", v="D OW1 V", d="n",
                 next={"into": "v", "down": "v", "under": "v",
                       "off": "v", "headfirst": "v"}),
    "bass": dict(n="B EY1 S", a="B AE1 S", d="n",
                 cues={"fish", "fishing", "lake", "river", "caught", "sea",
                       "striped", "largemouth", "pound", "pounds"},
                 cue_tag="a"),
    # tear/wind/lead have IRREGULAR verb pasts (tore/wound/led), so their
    # regular -ed surface forms belong to the OTHER reading: teared (up)
    # T IH1 R D, winded W IH1 N D IH0 D, leaded (glass) L EH1 D IH0 D —
    # the "ed" key routes resolve_word's -ed derivation there.
    "tear": dict(v="T EH1 R", n="T IH1 R", d="v", ed="n",
                 cues={"eye", "eyes", "cry", "crying", "cried", "cheek",
                       "cheeks", "wept", "weep"},
                 cue_tag="n"),
    # the position/role noun and the verb share L IY1 D; only the metal
    # ("a" tag) differs, reached via cues or copula — never bare "the lead"
    "lead": dict(n="L IY1 D", v="L IY1 D", a="L EH1 D", d="n", ed="a",
                 cues={"pipe", "pipes", "paint", "poisoning", "pencil",
                       "pencils", "metal", "heavy", "molten"},
                 cue_tag="a"),
    "minute": dict(n="M IH1 N AH0 T", a="M AY0 N UW1 T", d="n"),
    # --- final-consonant voicing pairs (noun S / verb Z) ---
    "use": dict(n="Y UW1 S", v="Y UW1 Z", d="n"),
    "close": dict(a="K L OW1 S", v="K L OW1 Z", d="a", next={"to": "a"}),
    "house": dict(n="HH AW1 S", v="HH AW1 Z", d="n"),
    "excuse": dict(v="IH0 K S K Y UW1 Z", n="IH0 K S K Y UW1 S", d="v"),
    "abuse": dict(v="AH0 B Y UW1 Z", n="AH0 B Y UW1 S", d="v"),
    "refuse": dict(v="R IH0 F Y UW1 Z", n="R EH1 F Y UW2 Z", d="v"),
    # --- noun/verb stress alternation (noun initial, verb final) ---
    "record": dict(n="R EH1 K ER0 D", v="R IH0 K AO1 R D", d="n", er="v"),
    "present": dict(n="P R EH1 Z AH0 N T", v="P R IH0 Z EH1 N T", d="n",
                    er="v"),
    "object": dict(n="AA1 B JH EH0 K T", v="AH0 B JH EH1 K T", d="n"),
    "subject": dict(n="S AH1 B JH IH0 K T", v="S AH0 B JH EH1 K T", d="n"),
    "project": dict(n="P R AA1 JH EH0 K T", v="P R AH0 JH EH1 K T", d="n",
                    er="v"),
    "permit": dict(v="P ER0 M IH1 T", n="P ER1 M IH0 T", d="v"),
    "conduct": dict(n="K AA1 N D AH0 K T", v="K AH0 N D AH1 K T", d="n"),
    "contract": dict(n="K AA1 N T R AE2 K T", v="K AH0 N T R AE1 K T",
                     d="n", er="v"),
    "content": dict(n="K AA1 N T EH0 N T", a="K AH0 N T EH1 N T", d="n"),
    "convert": dict(v="K AH0 N V ER1 T", n="K AA1 N V ER0 T", d="v", er="v"),
    "convict": dict(v="K AH0 N V IH1 K T", n="K AA1 N V IH0 K T", d="v"),
    "desert": dict(n="D EH1 Z ER0 T", v="D IH0 Z ER1 T", d="n", er="v"),
    "digest": dict(v="D AY0 JH EH1 S T", n="D AY1 JH EH0 S T", d="v"),
    "escort": dict(n="EH1 S K AO0 R T", v="EH0 S K AO1 R T", d="n"),
    "export": dict(n="EH1 K S P AO0 R T", v="IH0 K S P AO1 R T", d="n",
                   er="v"),
    "extract": dict(v="IH0 K S T R AE1 K T", n="EH1 K S T R AE2 K T", d="v",
                    er="v"),
    "import": dict(v="IH0 M P AO1 R T", n="IH1 M P AO2 R T", d="v", er="v"),
    "incline": dict(v="IH0 N K L AY1 N", n="IH1 N K L AY0 N", d="v"),
    "increase": dict(v="IH0 N K R IY1 S", n="IH1 N K R IY2 S", d="v"),
    "decrease": dict(v="D IH0 K R IY1 S", n="D IY1 K R IY2 S", d="v"),
    "insult": dict(v="IH0 N S AH1 L T", n="IH1 N S AH0 L T", d="v"),
    "perfect": dict(a="P ER1 F IH0 K T", v="P ER0 F EH1 K T", d="a"),
    "pervert": dict(v="P ER0 V ER1 T", n="P ER1 V ER0 T", d="v"),
    "produce": dict(v="P R AH0 D UW1 S", n="P R OW1 D UW0 S", d="v",
                    er="v"),
    "progress": dict(n="P R AA1 G R EH2 S", v="P R AH0 G R EH1 S", d="n"),
    "protest": dict(n="P R OW1 T EH2 S T", v="P R AH0 T EH1 S T", d="n",
                    er="v"),
    "rebel": dict(n="R EH1 B AH0 L", v="R IH0 B EH1 L", d="n"),
    "refund": dict(n="R IY1 F AH0 N D", v="R IH0 F AH1 N D", d="n"),
    "reject": dict(v="R IH0 JH EH1 K T", n="R IY1 JH EH0 K T", d="v"),
    "research": dict(n="R IY1 S ER0 CH", v="R IY0 S ER1 CH", d="n", er="v"),
    "suspect": dict(v="S AH0 S P EH1 K T", n="S AH1 S P EH2 K T", d="v"),
    "survey": dict(v="S ER0 V EY1", n="S ER1 V EY2", d="v"),
    "transfer": dict(v="T R AE0 N S F ER1", n="T R AE1 N S F ER0", d="v"),
    "transplant": dict(v="T R AE0 N S P L AE1 N T",
                       n="T R AE1 N S P L AE2 N T", d="v"),
    "transport": dict(v="T R AE0 N S P AO1 R T",
                      n="T R AE1 N S P AO0 R T", d="v", er="v"),
    "upset": dict(a="AH0 P S EH1 T", n="AH1 P S EH2 T", d="a"),
    "compound": dict(n="K AA1 M P AW0 N D", v="K AH0 M P AW1 N D", d="n"),
    "compress": dict(v="K AH0 M P R EH1 S", n="K AA1 M P R EH0 S", d="v"),
    "conflict": dict(n="K AA1 N F L IH0 K T", v="K AH0 N F L IH1 K T",
                     d="n"),
    "console": dict(n="K AA1 N S OW0 L", v="K AH0 N S OW1 L", d="n"),
    "contest": dict(n="K AA1 N T EH0 S T", v="K AH0 N T EH1 S T", d="n"),
    "contrast": dict(n="K AA1 N T R AE0 S T", v="K AH0 N T R AE1 S T",
                     d="n"),
    "converse": dict(v="K AH0 N V ER1 S", n="K AA1 N V ER0 S", d="v"),
    "defect": dict(n="D IY1 F EH0 K T", v="D IH0 F EH1 K T", d="n"),
    "discharge": dict(v="D IH0 S CH AA1 R JH", n="D IH1 S CH AA2 R JH",
                      d="v"),
    "exploit": dict(n="EH1 K S P L OY0 T", v="IH0 K S P L OY1 T", d="n"),
    "combat": dict(n="K AA1 M B AE2 T", v="K AH0 M B AE1 T", d="n"),
    # adjective use ("a compact car") dominates the rare noun senses
    # (agreement, makeup case): determiner context prefers "a"
    "compact": dict(a="K AH0 M P AE1 K T", n="K AA1 M P AE2 K T", d="a",
                    det="a"),
    "implant": dict(v="IH0 M P L AE1 N T", n="IH1 M P L AE2 N T", d="v"),
    "imprint": dict(n="IH1 M P R IH0 N T", v="IH0 M P R IH1 N T", d="n"),
    "intern": dict(n="IH1 N T ER0 N", v="IH0 N T ER1 N", d="n"),
    "perfume": dict(v="P ER0 F Y UW1 M", n="P ER1 F Y UW2 M", d="v"),
    "refill": dict(v="R IY0 F IH1 L", n="R IY1 F IH2 L", d="v"),
    "rerun": dict(v="R IY0 R AH1 N", n="R IY1 R AH2 N", d="v"),
    "retake": dict(v="R IY0 T EY1 K", n="R IY1 T EY2 K", d="v"),
    "recount": dict(v="R IY0 K AW1 N T", n="R IY1 K AW2 N T", d="v"),
    "resume": dict(v="R IH0 Z UW1 M", n="R EH1 Z AH0 M EY2", d="v"),
    "discount": dict(n="D IH1 S K AW0 N T", v="D IH0 S K AW1 N T", d="n"),
    "overflow": dict(v="OW2 V ER0 F L OW1", n="OW1 V ER0 F L OW2", d="v"),
    "insert": dict(v="IH0 N S ER1 T", n="IH1 N S ER2 T", d="v"),
    "upgrade": dict(v="AH0 P G R EY1 D", n="AH1 P G R EY2 D", d="v"),
    "attribute": dict(n="AE1 T R AH0 B Y UW2 T",
                      v="AH0 T R IH1 B Y UW0 T", d="n"),
    # 'proceeds' is its own homograph (stem 'proceed' is not): the noun
    # ("the proceeds") shifts stress
    "proceeds": dict(v="P R OW0 S IY1 D Z", n="P R OW1 S IY0 D Z", d="v"),
    # --- -ate adjective(/noun) vs verb (AH0 T vs EY2 T) ---
    "separate": dict(v="S EH1 P ER0 EY2 T", a="S EH1 P ER0 AH0 T", d="v"),
    "graduate": dict(n="G R AE1 JH UW0 AH0 T", v="G R AE1 JH UW0 EY2 T",
                     d="n"),
    "estimate": dict(n="EH1 S T AH0 M AH0 T", v="EH1 S T AH0 M EY2 T",
                     d="n"),
    "deliberate": dict(a="D IH0 L IH1 B ER0 AH0 T",
                       v="D IH0 L IH1 B ER0 EY2 T", d="a"),
    "elaborate": dict(a="IH0 L AE1 B ER0 AH0 T", v="IH0 L AE1 B ER0 EY2 T",
                      d="a"),
    "appropriate": dict(a="AH0 P R OW1 P R IY0 AH0 T",
                        v="AH0 P R OW1 P R IY0 EY2 T", d="a"),
    "associate": dict(v="AH0 S OW1 S IY0 EY2 T", n="AH0 S OW1 S IY0 AH0 T",
                      d="v"),
    "advocate": dict(n="AE1 D V AH0 K AH0 T", v="AE1 D V AH0 K EY2 T",
                     d="n"),
    "alternate": dict(a="AO1 L T ER0 N AH0 T", v="AO1 L T ER0 N EY2 T",
                      d="a"),
    "moderate": dict(a="M AA1 D ER0 AH0 T", v="M AA1 D ER0 EY2 T", d="a"),
    "intimate": dict(a="IH1 N T AH0 M AH0 T", v="IH1 N T AH0 M EY2 T",
                     d="a"),
    "delegate": dict(n="D EH1 L AH0 G AH0 T", v="D EH1 L AH0 G EY2 T",
                     d="n"),
    "duplicate": dict(n="D UW1 P L AH0 K AH0 T", v="D UW1 P L AH0 K EY2 T",
                      d="n"),
    "aggregate": dict(n="AE1 G R AH0 G AH0 T", v="AE1 G R AH0 G EY2 T",
                      d="n"),
    "coordinate": dict(v="K OW0 AO1 R D AH0 N EY2 T",
                       n="K OW0 AO1 R D AH0 N AH0 T", d="v"),
    "articulate": dict(a="AA0 R T IH1 K Y AH0 L AH0 T",
                       v="AA0 R T IH1 K Y AH0 L EY2 T", d="a"),
    "approximate": dict(a="AH0 P R AA1 K S AH0 M AH0 T",
                        v="AH0 P R AA1 K S AH0 M EY2 T", d="a"),
}

# Third-wave extension toward the full Wikipedia heteronym inventory
# (VERDICT r2 #8).  Defaults are anchored to the bundled lexicon entry
# wherever the word is in the lexicon (test_defaults_match_lexicon).
H.update({
    # --- noun/verb stress alternation ---
    "abstract": dict(n="AE1 B S T R AE2 K T", v="AE0 B S T R AE1 K T",
                     d="n"),
    "accent": dict(n="AE1 K S EH2 N T", v="AE0 K S EH1 N T", d="n"),
    "addict": dict(n="AE1 D IH0 K T", v="AH0 D IH1 K T", d="n"),
    "address": dict(v="AH0 D R EH1 S", n="AE1 D R EH2 S", d="v"),
    "affix": dict(v="AH0 F IH1 K S", n="AE1 F IH0 K S", d="v"),
    "ally": dict(n="AE1 L AY0", v="AH0 L AY1", d="n"),
    "annex": dict(n="AE1 N EH2 K S", v="AH0 N EH1 K S", d="n"),
    "commune": dict(n="K AA1 M Y UW0 N", v="K AH0 M Y UW1 N", d="n"),
    "conscript": dict(n="K AA1 N S K R IH0 P T",
                      v="K AH0 N S K R IH1 P T", d="n"),
    "conserve": dict(v="K AH0 N S ER1 V", n="K AA1 N S ER0 V", d="v"),
    "consort": dict(n="K AA1 N S AO0 R T", v="K AH0 N S AO1 R T", d="n"),
    "construct": dict(v="K AH0 N S T R AH1 K T",
                      n="K AA1 N S T R AH0 K T", d="v"),
    "entrance": dict(n="EH1 N T R AH0 N S", v="EH0 N T R AE1 N S", d="n"),
    "excise": dict(n="EH1 K S AY0 Z", v="EH0 K S AY1 Z", d="n"),
    "ferment": dict(v="F ER0 M EH1 N T", n="F ER1 M EH0 N T", d="v"),
    "fragment": dict(n="F R AE1 G M AH0 N T", v="F R AE0 G M EH1 N T",
                     d="n"),
    "impact": dict(n="IH1 M P AE0 K T", v="IH0 M P AE1 K T", d="n"),
    "incense": dict(n="IH1 N S EH0 N S", v="IH0 N S EH1 N S", d="n"),
    "intrigue": dict(v="IH0 N T R IY1 G", n="IH1 N T R IY0 G", d="v"),
    "invite": dict(v="IH0 N V AY1 T", n="IH1 N V AY2 T", d="v"),
    "overhaul": dict(v="OW2 V ER0 HH AO1 L", n="OW1 V ER0 HH AO2 L",
                     d="v"),
    "overlap": dict(v="OW2 V ER0 L AE1 P", n="OW1 V ER0 L AE2 P", d="v"),
    "overthrow": dict(v="OW2 V ER0 TH R OW1", n="OW1 V ER0 TH R OW2",
                      d="v"),
    "rampage": dict(n="R AE1 M P EY2 JH", v="R AE0 M P EY1 JH", d="n"),
    "recall": dict(v="R IH0 K AO1 L", n="R IY1 K AO2 L", d="v"),
    "recap": dict(n="R IY1 K AE2 P", v="R IY0 K AE1 P", d="n"),
    "relay": dict(n="R IY1 L EY0", v="R IY0 L EY1", d="n"),
    "remake": dict(v="R IY0 M EY1 K", n="R IY1 M EY2 K", d="v"),
    "replay": dict(n="R IY1 P L EY2", v="R IY0 P L EY1", d="n"),
    "reprint": dict(v="R IY0 P R IH1 N T", n="R IY1 P R IH0 N T", d="v"),
    "reset": dict(v="R IY0 S EH1 T", n="R IY1 S EH2 T", d="v"),
    "retard": dict(v="R IH0 T AA1 R D", n="R IY1 T AA0 R D", d="v"),
    "rewrite": dict(v="R IY0 R AY1 T", n="R IY1 R AY2 T", d="v"),
    "segment": dict(n="S EH1 G M AH0 N T", v="S EH0 G M EH1 N T", d="n"),
    "torment": dict(n="T AO1 R M EH2 N T", v="T AO0 R M EH1 N T", d="n"),
    "update": dict(v="AH0 P D EY1 T", n="AH1 P D EY2 T", d="v"),
    "uplift": dict(v="AH0 P L IH1 F T", n="AH1 P L IH2 F T", d="v"),
    "offset": dict(n="AO1 F S EH2 T", v="AO0 F S EH1 T", d="n"),
    "downgrade": dict(v="D AW0 N G R EY1 D", n="D AW1 N G R EY2 D",
                      d="v"),
    # --- noun vs adjective stress ---
    # "an invalid argument" (determiner context) is the ADJECTIVE; the
    # hospital-bed noun is rare enough that det context prefers "a"
    "invalid": dict(a="IH0 N V AE1 L AH0 D", n="IH1 N V AH0 L AH0 D",
                    d="a", det="a"),
    "frequent": dict(a="F R IY1 K W AH0 N T", v="F R IY0 K W EH1 N T",
                     d="a"),
    # --- final-consonant voicing (S noun / Z verb) ---
    "misuse": dict(v="M IH0 S Y UW1 Z", n="M IH0 S Y UW1 S", d="v"),
    "diffuse": dict(v="D IH0 F Y UW1 Z", a="D IH0 F Y UW1 S", d="v"),
    # --- vowel-quality: the meal vs the battering ---
    "buffet": dict(n="B AH0 F EY1", v="B AH1 F AH0 T", d="n",
                   cues={"wind", "winds", "wave", "waves", "storm",
                         "storms", "gust", "gusts"},
                   cue_tag="v"),
    # --- -ate adjective/noun (AH0 T) vs verb (EY2 T) ---
    "animate": dict(v="AE1 N AH0 M EY2 T", a="AE1 N AH0 M AH0 T", d="v"),
    "affiliate": dict(v="AH0 F IH1 L IY0 EY2 T",
                      n="AH0 F IH1 L IY0 AH0 T", d="v"),
    "conglomerate": dict(n="K AH0 N G L AA1 M ER0 AH0 T",
                         v="K AH0 N G L AA1 M ER0 EY2 T", d="n"),
    "consummate": dict(v="K AA1 N S AH0 M EY2 T",
                       a="K AH0 N S AH1 M AH0 T", d="v"),
    "degenerate": dict(a="D IH0 JH EH1 N ER0 AH0 T",
                       v="D IH0 JH EH1 N ER0 EY2 T", d="a"),
    "desolate": dict(a="D EH1 S AH0 L AH0 T", v="D EH1 S AH0 L EY2 T",
                     d="a"),
    "initiate": dict(v="IH0 N IH1 SH IY0 EY2 T",
                     n="IH0 N IH1 SH IY0 AH0 T", d="v"),
    "laminate": dict(v="L AE1 M AH0 N EY2 T", n="L AE1 M AH0 N AH0 T",
                     d="v"),
    "postulate": dict(v="P AA1 S CH AH0 L EY2 T",
                      n="P AA1 S CH AH0 L AH0 T", d="v"),
    "predicate": dict(n="P R EH1 D AH0 K AH0 T",
                      v="P R EH1 D AH0 K EY2 T", d="n"),
    "subordinate": dict(n="S AH0 B AO1 R D AH0 N AH0 T",
                        v="S AH0 B AO1 R D AH0 N EY2 T", d="n"),
    "syndicate": dict(n="S IH1 N D IH0 K AH0 T",
                      v="S IH1 N D IH0 K EY2 T", d="n"),
})

# the third-wave words, exported so the coverage test can enumerate them
THIRD_WAVE = frozenset(
    "abstract accent addict address affix ally annex commune conscript "
    "conserve consort construct entrance excise ferment fragment impact "
    "incense intrigue invite overhaul overlap overthrow rampage recall "
    "recap relay remake replay reprint reset retard rewrite segment "
    "torment update uplift offset downgrade invalid frequent misuse "
    "diffuse buffet animate affiliate conglomerate consummate degenerate "
    "desolate initiate laminate postulate predicate subordinate "
    "syndicate".split()
)

# ---------------------------------------------------------------------------
# POS-lite context tagger (over cleaned, lowercased word sequences)
# ---------------------------------------------------------------------------

_PERFECT = frozenset(
    "have has had having is are was were be been being am".split()
)
# adverbs that may sit between auxiliary and participle ("has just read")
_ADV_GAP = frozenset(
    "been just already never ever not only also recently finally "
    "barely hardly since".split()
)
_BE_DEGREE = frozenset(
    "is are was were be been being am isn't aren't wasn't weren't "
    "very quite so too really fairly pretty rather extremely highly "
    "entirely completely totally seems seemed looks looked sounds "
    "sounded feels felt remains remained became becomes stay stays "
    "stayed keep keeps kept".split()
)
_NOUN_PREV = frozenset(
    "the a an this that these those my your his her its our their no "
    "some any each every another such one two three more most many few "
    "several both all what which whose of in on at by for with from "
    "into about over under during without after before between against "
    "new old good great public own first second last next best main "
    "final official".split()
)
_VERB_PREV = frozenset(
    "to will would can could shall should may might must do does did "
    "don't doesn't didn't won't can't cannot couldn't wouldn't "
    "shouldn't mustn't let lets please i you we they he she it who "
    "not never always often usually sometimes then".split()
)
# a following determiner/object pronoun suggests a transitive verb
_OBJ_NEXT = frozenset(
    "the a an his her their my your its our them him me us it this "
    "that these those all every each some any what whatever how "
    "everything anything something nothing everyone anyone someone".split()
)
# determiners two words back suggest a noun compound ("a software upgrade",
# "the tax increase") when nothing closer contradicts it
_DET_PREV2 = frozenset(
    "a an the this that my your his her its our their".split()
)

# the ONE tokenizer for G2P context windows; emotts_torch.text.g2p aliases this
# so homograph context and pronounced words can never desynchronize
WORD_RE = re.compile(r"[a-z']+")
_WORD_RE = WORD_RE


def _choose(entry: Dict, words: List[str], i: int, allow_past: bool = True,
            prefer_n: bool = False) -> Tuple[str, bool]:
    """(tag, had-contextual-evidence) for ``words[i]`` given ``entry``.

    ``prefer_n`` (set for plural/-s forms, which adjectives cannot take)
    demotes an "a" choice to "n" whenever a noun reading exists.
    """
    prev = words[i - 1] if i > 0 else ""
    prev2 = words[i - 2] if i > 1 else ""
    nxt = words[i + 1] if i + 1 < len(words) else ""

    def pick(tag: str, contextual: bool) -> Tuple[str, bool]:
        if prefer_n and tag == "a" and "n" in entry:
            tag = "n"
        return tag, contextual

    cues = entry.get("cues")
    if cues and any(w in cues for w in words[max(0, i - 3): i + 4]):
        return pick(entry["cue_tag"], True)
    if allow_past and "past" in entry and (
        prev in _PERFECT or (prev2 in _PERFECT and prev in _ADV_GAP)
    ):
        return "past", True
    nrules = entry.get("next")
    if nrules and nxt in nrules:
        return pick(nrules[nxt], True)
    if prev == "to" and "v" in entry:
        return "v", True
    if prev in _BE_DEGREE:
        for tag in ("a", "past" if allow_past else "", "n"):
            if tag and tag in entry:
                return pick(tag, True)
    if prev in _NOUN_PREV:
        # per-entry determiner preference (e.g. compact: adjective use
        # dominates); default order is noun first
        order = (entry["det"], "n", "a") if "det" in entry else ("n", "a")
        for tag in order:
            if tag in entry:
                return pick(tag, True)
    if prev in _VERB_PREV and "v" in entry:
        return "v", True
    if nxt in _OBJ_NEXT and "v" in entry:
        return "v", True
    if (prev2 in _DET_PREV2 and prev not in _VERB_PREV
            and nxt not in _OBJ_NEXT):
        for tag in ("n", "a"):
            if tag in entry:
                return pick(tag, True)
    return pick(entry["d"], False)


def _s_form(pron: List[str]) -> List[str]:
    from emotts_torch.text.g2p import _s_suffix

    return _s_suffix(pron)


def _stem_candidates(stem: str) -> List[str]:
    """Possible base words for an affix-stripped stem (e-drop, degemination)."""
    cands = [stem, stem + "e"]
    if len(stem) > 2 and stem[-1] == stem[-2]:
        cands.append(stem[:-1])
    return cands


def resolve_word(word: str) -> Optional[List[str]]:
    """Context-free resolution of *inflected* homograph-stem forms.

    ``recorded``/``closing``/``used``/``recorder(s)`` have only the verb
    reading, so they are safe without context; plain lexicon morphology
    would inherit the wrong (noun/adjective) stress or voicing.  Returns
    ``None`` for anything else — including bare homographs, which the
    lexicon default (or :func:`resolve`, with context) handles.
    """
    from emotts_torch.text.g2p import _ed_suffix

    for sfx in ("ed", "ing", "ers", "er"):
        # stem must keep >=2 letters so e-drop stems of short homographs
        # ('used' -> us+e -> use) are still found, while 3-letter words
        # like 'bed'/'fed' never enter
        if not word.endswith(sfx) or len(word) <= len(sfx) + 1:
            continue
        for stem in _stem_candidates(word[: len(word) - len(sfx)]):
            entry = H.get(stem)
            if entry is None or "v" not in entry:
                continue
            if sfx in ("er", "ers") and entry.get("er") != "v":
                continue  # comparative (closer), not agentive (recorder)
            if sfx == "ed":
                # irregular verb pasts (tore/wound/led) mean the regular
                # -ed surface form belongs to the other reading ('ed' key)
                return _ed_suffix(entry[entry.get("ed", "v")].split())
            base = entry["v"].split()
            if sfx == "ing":
                return base + ["IH0", "NG"]
            agent = base + ["ER0"]
            return _s_form(agent) if sfx == "ers" else agent
    return None


def resolve(words: List[str], i: int,
            in_lexicon: bool = True) -> Optional[List[str]]:
    """Context-aware pronunciation for ``words[i]``, or ``None``.

    ``None`` means: not a homograph, or no contextual evidence and the
    caller's lexicon already has the (identical) default — in which case the
    normal lookup chain should proceed.  Handles plural/3rd-person ``-s``
    forms by resolving the stem and applying the voicing rule ("she records"
    vs "the records", "their lives" vs "he lives").
    """
    word = words[i]
    entry = H.get(word)
    s_form = False
    if entry is None and word.endswith("s") and not word.endswith("ss"):
        entry = H.get(word[:-1])
        s_form = entry is not None
    if entry is None:
        # inflected verb-stem forms — but an explicit lexicon entry
        # (e.g. a user override for 'recorded') always wins
        return None if in_lexicon else resolve_word(word)
    tag, contextual = _choose(entry, words, i, allow_past=not s_form,
                              prefer_n=s_form)
    if not contextual and in_lexicon:
        return None  # defer to the lexicon's (identical) default
    pron = entry[tag].split()
    return _s_form(pron) if s_form else pron


def words_of(text: str) -> List[str]:
    """Tokenize cleaned text the same way the G2P front end does."""
    return _WORD_RE.findall(text)


# ---------------------------------------------------------------------------
# OOV stress adjustment (the neural tier's POS awareness)
# ---------------------------------------------------------------------------

# strong-evidence-only subsets of the tagger cue sets: an OOV has no entry
# to arbitrate weak cues against, so only unambiguous local context counts
_OOV_VERB_PREV = frozenset(
    "to will would can could shall should may might must do does did "
    "don't doesn't didn't won't cannot couldn't wouldn't shouldn't".split()
)
_OOV_NOUN_PREV = frozenset(
    "the a an this that these those my your his her its our their "
    "another each every".split()
)


def oov_pos(words: List[str], i: int) -> Optional[str]:
    """``"v"``/``"n"`` for ``words[i]`` on UNAMBIGUOUS local evidence only,
    else ``None``.  Used by the G2P front end to stress-adjust neural OOV
    hypotheses (SoundChoice's sentence-context awareness for words outside
    the curated table, reference fastspeech2/util.py:20-27)."""
    prev = words[i - 1] if i > 0 else ""
    if prev in _OOV_VERB_PREV:
        return "v"
    if prev in _OOV_NOUN_PREV:
        return "n"
    return None


def shift_disyllable_stress(phones: List[str], pos: str) -> List[str]:
    """Apply the productive English disyllabic noun/verb alternation to an
    OOV hypothesis: verbs iambic (re-CORD), nouns trochaic (RE-cord).

    Only rewrites when the input has exactly two stress-bearing vowels and
    the primary lands on the wrong syllable for ``pos``; anything else is
    returned unchanged (the neural model's stress discipline is measured
    good — see BENCH_NOTES "stress canonicalization" — so edits stay
    maximally conservative)."""
    vowels = [k for k, p in enumerate(phones) if p[-1:] in "012"]
    if len(vowels) != 2:
        return phones
    a, b = vowels
    out = list(phones)
    if pos == "v" and phones[a].endswith("1") and not phones[b].endswith("1"):
        out[a] = phones[a][:-1] + "0"
        out[b] = phones[b][:-1] + "1"
        return out
    if pos == "n" and phones[b].endswith("1") and not phones[a].endswith("1"):
        out[a] = phones[a][:-1] + "1"
        out[b] = phones[b][:-1] + "0"
        return out
    return phones
