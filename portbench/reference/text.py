"""Text to symbol ids, the plain way: the English cleaner (ASCII fold,
lowercase, abbreviations, collapsed whitespace) and the grapheme table of
the Mozilla TTS recipe (pad, eos, bos, then the characters). Written from
the recipe's description, for sentences without digits; it refuses one
with a digit rather than guess at number expansion."""

from __future__ import annotations

import re
import unicodedata

PAD, EOS, BOS = "_", "~", "^"
CHARACTERS = "ABCDEFGHIJKLMNOPQRSTUVWXYZabcdefghijklmnopqrstuvwxyz!'(),-.:;? "
SYMBOL_ID = {s: i for i, s in enumerate([PAD, EOS, BOS] + list(CHARACTERS))}

ABBREVIATIONS = [(re.compile(rf"\b{a}\.", re.IGNORECASE), e) for a, e in (
    ("mrs", "misess"), ("mr", "mister"), ("dr", "doctor"), ("st", "saint"),
    ("co", "company"), ("jr", "junior"), ("maj", "major"), ("gen", "general"),
    ("drs", "doctors"), ("rev", "reverend"), ("lt", "lieutenant"), ("hon", "honorable"),
    ("sgt", "sergeant"), ("capt", "captain"), ("esq", "esquire"), ("ltd", "limited"),
    ("col", "colonel"), ("ft", "fort"))]


def clean(text: str) -> str:
    if any(c.isdigit() for c in text):
        raise ValueError(f"the plain cleaner takes no digits: {text!r}")
    text = unicodedata.normalize("NFKD", text).encode("ascii", "ignore").decode("ascii")
    text = text.lower()
    for pattern, expansion in ABBREVIATIONS:
        text = pattern.sub(expansion, text)
    return re.sub(r"\s+", " ", text)


def text_ids(text: str) -> list[int]:
    """Cleaned characters to ids; characters outside the table are dropped."""
    return [SYMBOL_ID[c] for c in clean(text) if c in SYMBOL_ID]
