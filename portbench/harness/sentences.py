"""Sentences and requests drawn from a seed, as a traffic mix's file
states them: words uniformly from the frozen word list
(``traffic/words.txt``), their count lognormal with the mix's median and
sigma, clipped to ``[min, max]`` words and cut back to ``max_phones``
phones.  Every text drawn in a run is unique (a repeat is drawn again),
so a served request can be found by its text.

The word counts of a group of n sentences are the distribution's n
quantiles at (i + ½) / n, in an order drawn from the seed: every seed asks
for the same amount of speech, in another order and other words."""

from __future__ import annotations

import itertools
from statistics import NormalDist
from dataclasses import dataclass
from pathlib import Path
from typing import Dict, List

import numpy as np

WORDS = Path(__file__).resolve().parents[1] / "traffic" / "words.txt"


def word_list(path: Path = WORDS):
    words, phones = [], []
    for line in path.read_text().splitlines():
        if line and not line.startswith("#"):
            w, *ph = line.split()
            words.append(w)
            phones.append(len(ph))
    return words, np.asarray(phones)


@dataclass
class Request:
    id: int
    text: str
    speaker: int
    emotion: int
    level: int
    phones: int

    def body(self) -> dict:
        return {"text": self.text, "speaker": self.speaker,
                "emotion": self.emotion, "level": self.level}


class Sentences:
    def __init__(self, mix: dict, rng: np.random.Generator, registry: Dict[str, Request],
                 bank_shape):
        self.words, self.phones = word_list()
        s = mix["sentence"]
        self.median, self.sigma = float(s["median_words"]), float(s["sigma"])
        self.lo, self.hi, self.max_phones = int(s["min_words"]), int(s["max_words"]), int(s["max_phones"])
        self.rng, self.registry = rng, registry
        self.n_spk, self.n_emo, self.n_lvl = bank_shape
        self._ids = itertools.count(len(registry))

    def counts(self, n: int) -> np.ndarray:
        """n word counts: the quantile grid in the seed's order."""
        z = np.array([NormalDist().inv_cdf((i + 0.5) / n) for i in range(n)])
        grid = self.median * np.exp(self.sigma * z)
        return self.rng.permutation(np.clip(np.rint(grid), self.lo, self.hi).astype(int))

    def _text(self, n: int):
        while True:
            idx = self.rng.integers(0, len(self.words), n)
            keep = np.cumsum(self.phones[idx]) <= self.max_phones
            idx = idx[keep]
            text = " ".join(self.words[i] for i in idx) + "."
            if text not in self.registry:
                return text, int(self.phones[idx].sum())

    def request(self, words: int, speaker=None, emotion=None, level=None) -> Request:
        text, phones = self._text(words)
        r = self.rng
        req = Request(next(self._ids), text,
                      int(r.integers(self.n_spk)) if speaker is None else speaker,
                      int(r.integers(self.n_emo)) if emotion is None else emotion,
                      int(r.integers(self.n_lvl)) if level is None else level, phones)
        self.registry[text] = req
        return req

    def sweep(self) -> List[Request]:
        """One request for each (speaker, emotion, level), in that order."""
        combos = list(itertools.product(range(self.n_spk), range(self.n_emo), range(self.n_lvl)))
        return [self.request(int(w), s, e, lv) for w, (s, e, lv) in
                zip(self.counts(len(combos)), combos)]

    def requests(self, n: int) -> List[Request]:
        """n requests, speaker, emotion and level drawn uniformly."""
        return [self.request(int(w)) for w in self.counts(n)]
