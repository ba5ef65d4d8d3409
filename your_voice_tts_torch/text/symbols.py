"""Grapheme symbol table (the JAX package's text/symbols.py, grapheme half).

IDs index the model's symbol embedding, so table ORDER is part of the
checkpoint format: pad/eos/bos, the ASCII characters and punctuation, then
the "@"-prefixed ARPAbet entries used for inline "{HH AH0 L OW1}" text.
"""

_pad = "_"
_eos = "~"
_bos = "^"

_characters = "ABCDEFGHIJKLMNOPQRSTUVWXYZabcdefghijklmnopqrstuvwxyz!'(),-.:;? "

# ARPAbet set of the JAX package's text/cmudict.py VALID_SYMBOLS: every base
# symbol plus the 0/1/2 stress forms of the vowels, sorted.
_ARPABET_BASE = [
    "AA", "AE", "AH", "AO", "AW", "AY", "B", "CH", "D", "DH", "EH", "ER",
    "EY", "F", "G", "HH", "IH", "IY", "JH", "K", "L", "M", "N", "NG", "OW",
    "OY", "P", "R", "S", "SH", "T", "TH", "UH", "UW", "V", "W", "Y", "Z",
    "ZH",
]
_ARPABET_VOWELS = ["AA", "AE", "AH", "AO", "AW", "AY", "EH", "ER", "EY", "IH",
                   "IY", "OW", "OY", "UH", "UW"]
VALID_SYMBOLS = sorted(
    _ARPABET_BASE + [v + d for v in _ARPABET_VOWELS for d in "012"])

symbols: list[str] = ([_pad, _eos, _bos] + list(_characters)
                      + ["@" + s for s in VALID_SYMBOLS])

pad = _pad
eos = _eos
bos = _bos
