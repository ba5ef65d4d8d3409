"""Text cleaners.

Behavioral parity with the reference's ``utils/text/cleaners.py`` (SURVEY.md
SS2.1 "Text frontend"): pipelines named by the ``text_cleaner`` config field.
The reference uses ``unidecode`` for ASCII transliteration; here that is a
stdlib ``unicodedata`` NFKD fold (plus explicit German umlaut digraphs for the
fork's German corpus path).
"""

from __future__ import annotations

import re
import unicodedata

from .numbers import normalize_numbers

_whitespace_re = re.compile(r"\s+")

_abbreviations = [
    (re.compile(rf"\b{abbr}\.", re.IGNORECASE), expansion)
    for abbr, expansion in [
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

# German transliteration applied before NFKD so umlauts become digraphs,
# not bare vowels (fork addition for the German "your voice" corpus [I]).
_german_translit = str.maketrans(
    {"ä": "ae", "ö": "oe", "ü": "ue", "Ä": "Ae", "Ö": "Oe", "Ü": "Ue", "ß": "ss"}
)


def expand_abbreviations(text: str) -> str:
    for pattern, expansion in _abbreviations:
        text = pattern.sub(expansion, text)
    return text


def lowercase(text: str) -> str:
    return text.lower()


def collapse_whitespace(text: str) -> str:
    return _whitespace_re.sub(" ", text)


def convert_to_ascii(text: str) -> str:
    nfkd = unicodedata.normalize("NFKD", text)
    return nfkd.encode("ascii", "ignore").decode("ascii")


def expand_numbers(text: str) -> str:
    return normalize_numbers(text)


def basic_cleaners(text: str) -> str:
    """Lowercase + whitespace collapse; no transliteration (any language)."""
    return collapse_whitespace(lowercase(text))


def transliteration_cleaners(text: str) -> str:
    """ASCII-fold + lowercase + whitespace collapse (non-English text)."""
    return collapse_whitespace(lowercase(convert_to_ascii(text)))


def english_cleaners(text: str) -> str:
    """English pipeline: ascii-fold, lowercase, numbers, abbreviations."""
    text = convert_to_ascii(text)
    text = lowercase(text)
    text = expand_numbers(text)
    text = expand_abbreviations(text)
    return collapse_whitespace(text)


def german_cleaners(text: str) -> str:
    """German pipeline: umlaut digraphs, ascii-fold, lowercase."""
    text = text.translate(_german_translit)
    text = convert_to_ascii(text)
    return collapse_whitespace(lowercase(text))


def phoneme_cleaners(text: str) -> str:
    """Pipeline applied before G2P: numbers + abbreviations, keep case/diacritics."""
    text = expand_numbers(text)
    text = expand_abbreviations(text)
    return collapse_whitespace(text)


CLEANERS = {
    "basic_cleaners": basic_cleaners,
    "transliteration_cleaners": transliteration_cleaners,
    "english_cleaners": english_cleaners,
    "german_cleaners": german_cleaners,
    "phoneme_cleaners": phoneme_cleaners,
}


def get_cleaner(name: str):
    try:
        return CLEANERS[name]
    except KeyError:
        raise ValueError(f"unknown cleaner {name!r}; available: {sorted(CLEANERS)}") from None
