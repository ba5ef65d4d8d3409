"""English number normalization.

Behavioral parity with the reference's ``utils/text/number_norm.py``: strips
commas, expands currency (dollars/pounds), decimals, ordinals, and cardinals
to words. The reference delegates word conversion to ``inflect``; that
dependency is not available here, so the int->words conversion is implemented
directly (same output conventions: two-digit grouping for years,
'oh' for in-group zeros).
"""

from __future__ import annotations

import re

_comma_number_re = re.compile(r"([0-9][0-9\,]+[0-9])")
_decimal_number_re = re.compile(r"([0-9]+\.[0-9]+)")
_pounds_re = re.compile(r"£([0-9\,]*[0-9]+)")
_dollars_re = re.compile(r"\$([0-9\.\,]*[0-9]+)")
_ordinal_re = re.compile(r"([0-9]+)(st|nd|rd|th)")
_number_re = re.compile(r"[0-9]+")

_ONES = ["zero", "one", "two", "three", "four", "five", "six", "seven", "eight",
         "nine", "ten", "eleven", "twelve", "thirteen", "fourteen", "fifteen",
         "sixteen", "seventeen", "eighteen", "nineteen"]
_TENS = ["", "", "twenty", "thirty", "forty", "fifty", "sixty", "seventy",
         "eighty", "ninety"]
_SCALES = [(10 ** 12, "trillion"), (10 ** 9, "billion"), (10 ** 6, "million"),
           (10 ** 3, "thousand"), (100, "hundred")]

_ORDINAL_SPECIAL = {
    "one": "first", "two": "second", "three": "third", "five": "fifth",
    "eight": "eighth", "nine": "ninth", "twelve": "twelfth",
}


def _two_digits_to_words(n: int) -> str:
    if n < 20:
        return _ONES[n]
    tens, ones = divmod(n, 10)
    return _TENS[tens] + ("-" + _ONES[ones] if ones else "")


def _int_to_words(n: int, andword: str = "") -> str:
    """Full cardinal expansion, e.g. 1234 -> 'one thousand two hundred thirty-four'."""
    if n < 0:
        return "minus " + _int_to_words(-n, andword)
    if n < 100:
        return _two_digits_to_words(n)
    parts: list[str] = []
    for value, name in _SCALES:
        if n >= value:
            parts.append(_int_to_words(n // value, andword))
            parts.append(name)
            n %= value
    if n:
        if andword:
            parts.append(andword)
        parts.append(_two_digits_to_words(n))
    return " ".join(parts)


def _int_to_words_grouped(n: int) -> str:
    """Two-digit grouping, e.g. 1984 -> 'nineteen eighty-four' (year style)."""
    s = str(n)
    if len(s) % 2:
        s = "0" + s
    groups = [int(s[i:i + 2]) for i in range(0, len(s), 2)]
    words = []
    for g in groups:
        if g == 0:
            words.append("hundred" if len(groups) == 2 else "oh oh")
        elif g < 10:
            words.append("oh " + _ONES[g])
        else:
            words.append(_two_digits_to_words(g))
    return " ".join(words)


def _remove_commas(m: re.Match) -> str:
    return m.group(1).replace(",", "")


def _expand_decimal_point(m: re.Match) -> str:
    return m.group(1).replace(".", " point ")


def _expand_dollars(m: re.Match) -> str:
    match = m.group(1).replace(",", "")
    parts = match.split(".")
    if len(parts) > 2:
        return match + " dollars"
    dollars = int(parts[0]) if parts[0] else 0
    cents = int(parts[1]) if len(parts) > 1 and parts[1] else 0
    if dollars and cents:
        dollar_unit = "dollar" if dollars == 1 else "dollars"
        cent_unit = "cent" if cents == 1 else "cents"
        return f"{_int_to_words(dollars)} {dollar_unit}, {_int_to_words(cents)} {cent_unit}"
    if dollars:
        dollar_unit = "dollar" if dollars == 1 else "dollars"
        return f"{_int_to_words(dollars)} {dollar_unit}"
    if cents:
        cent_unit = "cent" if cents == 1 else "cents"
        return f"{_int_to_words(cents)} {cent_unit}"
    return "zero dollars"


def _expand_pounds(m: re.Match) -> str:
    return _int_to_words(int(m.group(1).replace(",", ""))) + " pounds"


def _expand_ordinal(m: re.Match) -> str:
    words = _int_to_words(int(m.group(1)))
    head, _, last = words.rpartition(" ")
    if "-" in last:
        pre, _, tail = last.rpartition("-")
        last = pre + "-" + _ORDINAL_SPECIAL.get(tail, _make_ordinal(tail))
    else:
        last = _ORDINAL_SPECIAL.get(last, _make_ordinal(last))
    return (head + " " + last).strip()


def _make_ordinal(word: str) -> str:
    if word.endswith("y"):
        return word[:-1] + "ieth"
    if word.endswith("t"):  # eight handled in specials; 'hundred/thousand...' below
        return word + "h"
    return word + "th"


def _expand_number(m: re.Match) -> str:
    num = int(m.group(0))
    # Year-style reading for 1000 < num < 3000 (reference behavior).
    if 1000 < num < 3000:
        if num == 2000:
            return "two thousand"
        if 2000 < num < 2010:
            return "two thousand " + _int_to_words(num % 100)
        if num % 100 == 0:
            return _int_to_words(num // 100) + " hundred"
        return _int_to_words_grouped(num)
    return _int_to_words(num)


def normalize_numbers(text: str) -> str:
    text = re.sub(_comma_number_re, _remove_commas, text)
    text = re.sub(_pounds_re, _expand_pounds, text)
    text = re.sub(_dollars_re, _expand_dollars, text)
    text = re.sub(_decimal_number_re, _expand_decimal_point, text)
    text = re.sub(_ordinal_re, _expand_ordinal, text)
    text = re.sub(_number_re, _expand_number, text)
    return text
