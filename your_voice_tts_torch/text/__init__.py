"""Text -> symbol-id sequences, grapheme path (the JAX package's
text/__init__.py ``text_to_sequence``). The phoneme / G2P path comes with a
later slice of the port."""

from __future__ import annotations

import re

import numpy as np

from .cleaners import get_cleaner
from .symbols import pad, symbols

_curly_re = re.compile(r"(.*?)\{(.+?)\}(.*)")

_symbol_to_id = {s: i for i, s in enumerate(symbols)}


def _clean(text: str, cleaner_names: str | list[str]) -> str:
    if isinstance(cleaner_names, str):
        cleaner_names = [cleaner_names]
    for name in cleaner_names:
        text = get_cleaner(name)(text)
    return text


def _chars_to_ids(text: str) -> list[int]:
    return [_symbol_to_id[ch] for ch in text if ch in _symbol_to_id and ch != pad]


def text_to_sequence(text: str, cleaner_names: str | list[str] = "english_cleaners") -> np.ndarray:
    """Clean then map chars to ids, dropping unknown chars. Curly-brace
    segments carry inline ARPAbet mapped to the "@PHONE" symbol entries."""
    ids: list[int] = []
    while text:
        m = _curly_re.match(text)
        if not m:
            ids += _chars_to_ids(_clean(text, cleaner_names))
            break
        ids += _chars_to_ids(_clean(m.group(1), cleaner_names))
        ids += [_symbol_to_id["@" + p] for p in m.group(2).split()
                if "@" + p in _symbol_to_id]
        text = m.group(3)
    return np.asarray(ids, dtype=np.int32)


__all__ = ["text_to_sequence", "symbols"]
