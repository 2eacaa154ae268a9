"""Number → English words expansion used by the text cleaners.

Implements the same normalization capability the reference gets from
SpeechBrain's ``english_cleaners`` (used at fastspeech2/util.py:24 and
rank_model/prepare_mfa.py:24): dollars, decimals, ordinals, years and plain
cardinals are spelled out before G2P/alignment.
"""

from __future__ import annotations

import re

_UNITS = [
    "zero", "one", "two", "three", "four", "five", "six", "seven", "eight",
    "nine", "ten", "eleven", "twelve", "thirteen", "fourteen", "fifteen",
    "sixteen", "seventeen", "eighteen", "nineteen",
]
_TENS = [
    "", "", "twenty", "thirty", "forty", "fifty", "sixty", "seventy",
    "eighty", "ninety",
]
_SCALES = [
    (10 ** 12, "trillion"),
    (10 ** 9, "billion"),
    (10 ** 6, "million"),
    (10 ** 3, "thousand"),
    (10 ** 2, "hundred"),
]

_ORDINAL_UNITS = {
    "one": "first", "two": "second", "three": "third", "five": "fifth",
    "eight": "eighth", "nine": "ninth", "twelve": "twelfth",
}

_comma_number_re = re.compile(r"([0-9][0-9,]+[0-9])")
_decimal_re = re.compile(r"([0-9]+\.[0-9]+)")
_dollars_re = re.compile(r"\$([0-9.,]*[0-9]+)")
_pounds_re = re.compile(r"£([0-9,]*[0-9]+)")
_ordinal_re = re.compile(r"([0-9]+)(st|nd|rd|th)")
_number_re = re.compile(r"[0-9]+")


def _three_digits_to_words(n: int) -> str:
    assert 0 <= n < 1000
    if n < 20:
        return _UNITS[n]
    if n < 100:
        tens, unit = divmod(n, 10)
        return _TENS[tens] + (f" {_UNITS[unit]}" if unit else "")
    hundreds, rest = divmod(n, 100)
    out = f"{_UNITS[hundreds]} hundred"
    if rest:
        out += f" {_three_digits_to_words(rest)}"
    return out


def number_to_words(n: int) -> str:
    """Spell out a non-negative integer in English."""
    if n < 0:
        return "minus " + number_to_words(-n)
    if n < 1000:
        return _three_digits_to_words(n)
    parts = []
    for scale, name in _SCALES:
        if scale == 100:
            break
        q, n = divmod(n, scale)
        if q:
            parts.append(f"{_three_digits_to_words(q) if q < 1000 else number_to_words(q)} {name}")
    if n:
        parts.append(_three_digits_to_words(n))
    return " ".join(parts) if parts else "zero"


def number_to_ordinal_words(n: int) -> str:
    words = number_to_words(n)
    head, _, last = words.rpartition(" ")
    if last in _ORDINAL_UNITS:
        last = _ORDINAL_UNITS[last]
    elif last.endswith("y"):
        last = last[:-1] + "ieth"
    elif last.endswith("t"):
        last = last + "h"
    else:
        last = last + "th"
    return (head + " " + last).strip()


def _year_to_words(n: int) -> str:
    """1984 → 'nineteen eighty four'; 2000/2007 read as cardinals."""
    if 1000 <= n < 3000:
        if n % 1000 == 0:
            return number_to_words(n)
        if n % 100 == 0:
            return f"{_three_digits_to_words(n // 100)} hundred"
        hi, lo = divmod(n, 100)
        if lo < 10:
            return f"{_three_digits_to_words(hi)} oh {_UNITS[lo]}"
        return f"{_three_digits_to_words(hi)} {_three_digits_to_words(lo)}"
    return number_to_words(n)


def _expand_dollars(m: re.Match) -> str:
    amount = m.group(1).replace(",", "")
    if "." in amount:
        d, c = amount.split(".", 1)
        dollars = int(d) if d else 0
        cents = int(c.ljust(2, "0")[:2]) if c else 0
    else:
        dollars, cents = int(amount), 0
    parts = []
    if dollars:
        parts.append(f"{number_to_words(dollars)} dollar{'s' if dollars != 1 else ''}")
    if cents:
        parts.append(f"{number_to_words(cents)} cent{'s' if cents != 1 else ''}")
    return ", ".join(parts) if parts else "zero dollars"


def _expand_decimal(m: re.Match) -> str:
    whole, frac = m.group(1).split(".")
    digits = " ".join(_UNITS[int(ch)] for ch in frac)
    return f"{number_to_words(int(whole))} point {digits}"


def _expand_number(m: re.Match) -> str:
    n = int(m.group(0))
    if 1000 < n < 3000 and n != 2000:
        return _year_to_words(n)
    return number_to_words(n)


def normalize_numbers(text: str) -> str:
    text = _comma_number_re.sub(lambda m: m.group(1).replace(",", ""), text)
    text = _pounds_re.sub(lambda m: f"{number_to_words(int(m.group(1).replace(',', '')))} pounds", text)
    text = _dollars_re.sub(_expand_dollars, text)
    text = _decimal_re.sub(_expand_decimal, text)
    text = _ordinal_re.sub(lambda m: number_to_ordinal_words(int(m.group(1))), text)
    text = _number_re.sub(_expand_number, text)
    return text
