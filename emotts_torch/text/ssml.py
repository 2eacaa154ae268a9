"""SSML-lite: span-level synthesis control markup.

The reference synthesizes one fixed sentence per run with one (speaker,
emotion, level) triple (fastspeech2/inference.py:40-84).  Production TTS
serving wants *span-level* control inside one utterance; this module parses
the useful subset of SSML into a flat segment list the Synthesizer renders:

* ``<speak>`` — optional root (added automatically when absent).
* ``<voice name="bea">…</voice>`` — speaker for the span.
* ``<emotion name="amused" level="1.5" scale="1.2">…</emotion>`` — emotion
  conditioning for the span (an emotts extension; SSML has no emotion tag).
* ``<prosody rate="1.2">…</prosody>`` — speaking-rate multiplier.
* ``<break time="300ms"/>`` or ``time="0.5s"`` — explicit pause.
* ``<phoneme ph="HH AH0 L OW1">word</phoneme>`` — literal ARPABET for the
  span (the enclosed text is ignored; the reference cannot do this at all).

Tags nest; inner attributes override outer ones.  Anything unrecognized
raises ``SSMLError`` — silent tag-dropping would misrender the request.
"""

from __future__ import annotations

import re
import xml.etree.ElementTree as ET
from dataclasses import dataclass, field, replace
from typing import List, Optional


class SSMLError(ValueError):
    pass


@dataclass(frozen=True)
class Controls:
    """Per-span overrides; ``None`` = inherit the request default."""

    speaker: Optional[str] = None  # name or id-as-string
    emotion: Optional[str] = None
    level: Optional[float] = None
    scale: Optional[float] = None
    rate: Optional[float] = None


@dataclass
class Segment:
    kind: str  # "text" | "phonemes" | "break"
    text: str = ""
    phonemes: List[str] = field(default_factory=list)
    seconds: float = 0.0
    controls: Controls = field(default_factory=Controls)


_TIME_RE = re.compile(r"^\s*([0-9]+(?:\.[0-9]+)?)\s*(ms|s)\s*$")
MAX_BREAK_S = 30.0  # hard cap: a request must not allocate minutes of zeros


def _parse_time(value: str) -> float:
    m = _TIME_RE.match(value)
    if not m:  # the unit is REQUIRED — a bare number is ambiguous (s? ms?)
        raise SSMLError(f"bad break time {value!r} (use e.g. 300ms or 0.5s)")
    t = float(m.group(1))
    t = t / 1000.0 if m.group(2) == "ms" else t
    if t > MAX_BREAK_S:
        raise SSMLError(f"break time {value!r} exceeds {MAX_BREAK_S:.0f}s cap")
    return t


def _float_attr(el, name: str, current: Optional[float]) -> Optional[float]:
    if name not in el.attrib:
        return current
    try:
        return float(el.attrib[name])
    except ValueError as e:
        raise SSMLError(f"bad {name}={el.attrib[name]!r} on <{el.tag}>") from e


def parse_ssml(markup: str) -> List[Segment]:
    """Parse SSML-lite markup into an ordered segment list."""
    s = markup.strip()
    if not s.startswith("<speak"):
        s = f"<speak>{s}</speak>"
    try:
        root = ET.fromstring(s)
    except ET.ParseError as e:
        raise SSMLError(f"malformed SSML: {e}") from e

    def local(tag: str) -> str:
        # spec-conformant SSML carries xmlns; ElementTree expands tags to
        # '{uri}name' — strip the namespace so standard tooling output works
        return tag.rpartition("}")[2].lower()

    if local(root.tag) != "speak":
        raise SSMLError(f"root element must be <speak>, got <{root.tag}>")

    segs: List[Segment] = []

    def add_text(t: Optional[str], ctrl: Controls) -> None:
        if t and t.strip():
            segs.append(Segment("text", text=t.strip(), controls=ctrl))

    def walk(el, ctrl: Controls) -> None:
        add_text(el.text, ctrl)
        for child in el:
            tag = local(child.tag)
            if tag == "break":
                segs.append(Segment(
                    "break",
                    seconds=_parse_time(child.attrib.get("time", "0.3s")),
                ))
            elif tag == "phoneme":
                ph = child.attrib.get("ph", "").split()
                if not ph:
                    raise SSMLError("<phoneme> requires a ph attribute")
                from emotts_torch.text.vocab import PAD, VALID_TOKENS

                bad = [p for p in ph if p not in VALID_TOKENS or p == PAD]
                if bad:  # silent dropping would misrender the request
                    raise SSMLError(
                        f"<phoneme> has non-ARPABET tokens {bad} "
                        "(stress-marked uppercase ARPABET required, "
                        "e.g. HH AH0 L OW1)"
                    )
                segs.append(Segment("phonemes", phonemes=ph, controls=ctrl))
            elif tag == "voice":
                if "name" not in child.attrib:
                    raise SSMLError("<voice> requires a name attribute")
                walk(child, replace(ctrl, speaker=child.attrib["name"]))
            elif tag == "emotion":
                sub = ctrl
                if "name" in child.attrib:
                    sub = replace(sub, emotion=child.attrib["name"])
                sub = replace(
                    sub,
                    level=_float_attr(child, "level", sub.level),
                    scale=_float_attr(child, "scale", sub.scale),
                )
                walk(child, sub)
            elif tag == "prosody":
                walk(child, replace(
                    ctrl, rate=_float_attr(child, "rate", ctrl.rate)
                ))
            elif tag in ("s", "p"):
                walk(child, ctrl)
            else:
                raise SSMLError(f"unsupported SSML tag <{tag}>")
            add_text(child.tail, ctrl)

    walk(root, Controls())
    return segs
