"""Praat TextGrid parsing and MFA-duration ingestion.

Own copy of ``emotts/audio/textgrid.py``.  Replaces the reference's ``tgt``
dependency (rank_model/audio_util.py:46-74).  Parses both long and short
TextGrid formats as produced by the Montreal Forced Aligner, and converts
the 'phones' tier into (phones, frame durations, speech start/end) with the
reference's conventions: silence phones map to 'spn', leading/trailing
silence is stripped, and interval times quantize to frames via
round(t * sr / hop).
"""

from __future__ import annotations

import re
from dataclasses import dataclass
from pathlib import Path
from typing import List, Sequence, Tuple

import numpy as np


@dataclass
class Interval:
    start: float
    end: float
    text: str


@dataclass
class Tier:
    name: str
    intervals: List[Interval]


_QUOTED = re.compile(r'"((?:[^"]|"")*)"')
_NUM = re.compile(r"-?\d+(?:\.\d+)?(?:[eE][-+]?\d+)?")


def _tokenize(text: str):
    """Yield ('str', s) and ('num', x) tokens in file order, skipping keys."""
    pos = 0
    while pos < len(text):
        ch = text[pos]
        if ch == '"':
            m = _QUOTED.match(text, pos)
            if not m:
                raise ValueError(f"unterminated string at offset {pos}")
            yield ("str", m.group(1).replace('""', '"'))
            pos = m.end()
        elif ch.isdigit() or (ch == "-" and pos + 1 < len(text) and text[pos + 1].isdigit()):
            m = _NUM.match(text, pos)
            yield ("num", float(m.group(0)))
            pos = m.end()
        else:
            pos += 1


def parse_textgrid(path: str) -> List[Tier]:
    """Parse a TextGrid file (long or short format) into interval tiers.

    Both formats reduce to the same token stream: after the two header
    strings ("ooTextFile", "TextGrid") and global xmin/xmax comes either
    <exists flag> + tier count (long format spells 'tiers? <exists>' and
    'size = N'), then per tier: class, name, xmin, xmax, n, then n × (xmin,
    xmax, text).  Point tiers ("TextTier") carry (time, mark) pairs and are
    skipped.
    """
    text = Path(path).read_text(errors="ignore")
    # long-format index markers ('item [1]:', 'intervals [2]:') would emit
    # stray number tokens; strip them (quoted strings never contain them
    # un-escaped at line scope relevant here because labels are parsed from
    # the token stream, not line-wise — bracket indices only occur on
    # structural lines)
    text = re.sub(r"\[\s*\d*\s*\]", "", text)
    toks = list(_tokenize(text))
    i = 0

    def expect(kind):
        nonlocal i
        while i < len(toks) and toks[i][0] != kind:
            i += 1
        if i >= len(toks):
            raise ValueError(f"TextGrid parse error in {path}: expected {kind}")
        val = toks[i][1]
        i += 1
        return val

    # header: "ooTextFile", "TextGrid", xmin, xmax, (maybe "exists"), ntiers
    expect("str")  # ooTextFile
    expect("str")  # TextGrid
    expect("num")  # xmin
    expect("num")  # xmax
    # long format has the string "exists" token? No — 'tiers? <exists>' is a
    # flag line without quotes, so the next token is the tier count (short
    # format) or the count after 'size =' (long format): both are the next num.
    ntiers = int(expect("num"))

    tiers: List[Tier] = []
    for _ in range(ntiers):
        tier_class = expect("str")
        name = expect("str")
        expect("num")  # tier xmin
        expect("num")  # tier xmax
        n = int(expect("num"))
        intervals: List[Interval] = []
        if tier_class == "IntervalTier":
            for _ in range(n):
                xmin = expect("num")
                xmax = expect("num")
                label = expect("str")
                intervals.append(Interval(xmin, xmax, label))
        else:  # point tier: (time, mark)
            for _ in range(n):
                expect("num")
                expect("str")
        tiers.append(Tier(name, intervals))
    return tiers


def get_tier(tiers: List[Tier], name: str) -> Tier:
    for t in tiers:
        if t.name == name:
            return t
    raise KeyError(f"no tier named '{name}' (have: {[t.name for t in tiers]})")


def process_textgrid(
    textgrid_file: str,
    sampling_rate: int,
    hop_length: int,
    sil_phones: Sequence[str],
) -> Tuple[List[str], np.ndarray, float, float]:
    """Extract (phones, frame durations, speech_start, speech_end).

    Reference semantics (rank_model/audio_util.py:46-74): quantize interval
    boundaries to frames with round(t*sr/hop), map silence phones to 'spn',
    strip leading/trailing silence, return the voiced span's time bounds.
    Returns ([], [], 0.0, 0.0) if no voiced phones exist.
    """
    tiers = parse_textgrid(textgrid_file)
    tier = get_tier(tiers, "phones")
    intervals = [(iv.start, iv.end, iv.text or "") for iv in tier.intervals]
    if not intervals:
        return [], np.array([], dtype=np.int64), 0.0, 0.0

    starts = np.array([s for s, _, _ in intervals])
    ends = np.array([e for _, e, _ in intervals])
    start_frames = np.round(starts * sampling_rate / hop_length).astype(int)
    end_frames = np.round(ends * sampling_rate / hop_length).astype(int)
    durations = end_frames - start_frames

    sil = set(sil_phones)
    labels = [p if p not in sil else "spn" for _, _, p in intervals]
    is_voiced = np.array([p not in sil for _, _, p in intervals])
    if not is_voiced.any():
        return [], np.array([], dtype=np.int64), 0.0, 0.0

    first, last = np.where(is_voiced)[0][[0, -1]]
    phones = labels[first : last + 1]
    durations = durations[first : last + 1]
    speech_start = intervals[first][0]
    speech_end = intervals[last][1]
    return phones, durations, speech_start, speech_end


def write_textgrid(path: str, phones_tier: List[Interval], xmax: float) -> None:
    """Write a minimal long-format TextGrid (used by tests/fixtures)."""
    lines = [
        'File type = "ooTextFile"',
        'Object class = "TextGrid"',
        "",
        "xmin = 0",
        f"xmax = {xmax}",
        "tiers? <exists>",
        "size = 1",
        "item []:",
        "    item [1]:",
        '        class = "IntervalTier"',
        '        name = "phones"',
        "        xmin = 0",
        f"        xmax = {xmax}",
        f"        intervals: size = {len(phones_tier)}",
    ]
    for i, iv in enumerate(phones_tier, 1):
        lines += [
            f"        intervals [{i}]:",
            f"            xmin = {iv.start}",
            f"            xmax = {iv.end}",
            f'            text = "{iv.text}"',
        ]
    Path(path).write_text("\n".join(lines) + "\n")
