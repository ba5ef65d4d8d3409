"""CMU Pronouncing Dictionary support (the JAX package's text/cmudict.py).

Two uses: inline ARPAbet in text ("turn {L EH1 F T} now", through the
"@PHONE" entries of the grapheme table, whose ARPAbet set is
VALID_SYMBOLS), and the dictionary-backed offline G2P (`CMUDictBackend` in
text/__init__.py), which maps ARPAbet to the IPA phoneme table.
"""

from __future__ import annotations

import re

_BASE_SYMBOLS = [
    "AA", "AE", "AH", "AO", "AW", "AY", "B", "CH", "D", "DH", "EH", "ER",
    "EY", "F", "G", "HH", "IH", "IY", "JH", "K", "L", "M", "N", "NG", "OW",
    "OY", "P", "R", "S", "SH", "T", "TH", "UH", "UW", "V", "W", "Y", "Z",
    "ZH",
]
_VOWELS = ("AA", "AE", "AH", "AO", "AW", "AY", "EH", "ER", "EY", "IH", "IY",
           "OW", "OY", "UH", "UW")
# every base symbol plus the 0/1/2 stress forms of the vowels, sorted
VALID_SYMBOLS = sorted(_BASE_SYMBOLS + [v + d for v in _VOWELS for d in "012"])
_VALID = set(_BASE_SYMBOLS)

# ARPAbet -> IPA (General American); stress digits are handled apart
ARPABET_TO_IPA = {
    "AA": "ɑ", "AE": "æ", "AH": "ʌ", "AO": "ɔ", "AW": "aʊ", "AY": "aɪ",
    "B": "b", "CH": "tʃ", "D": "d", "DH": "ð", "EH": "ɛ", "ER": "ɚ",
    "EY": "eɪ", "F": "f", "G": "ɡ", "HH": "h", "IH": "ɪ", "IY": "i",
    "JH": "dʒ", "K": "k", "L": "l", "M": "m", "N": "n", "NG": "ŋ",
    "OW": "oʊ", "OY": "ɔɪ", "P": "p", "R": "ɹ", "S": "s", "SH": "ʃ",
    "T": "t", "TH": "θ", "UH": "ʊ", "UW": "u", "V": "v", "W": "w",
    "Y": "j", "Z": "z", "ZH": "ʒ",
}

_ALT_RE = re.compile(r"\([0-9]+\)")


class CMUDict:
    """A cmudict-format lexicon: "WORD  P1 P2 ..." lines, alternate
    pronunciations as WORD(1). `lookup` returns the word's pronunciations
    (each a space-joined ARPAbet string) or None."""

    def __init__(self, path_or_lines, keep_ambiguous: bool = True):
        if isinstance(path_or_lines, str):
            with open(path_or_lines, encoding="latin-1") as f:
                entries = _parse_cmudict(f)
        else:
            entries = _parse_cmudict(path_or_lines)
        if not keep_ambiguous:
            entries = {w: p for w, p in entries.items() if len(p) == 1}
        self._entries = entries

    def __len__(self) -> int:
        return len(self._entries)

    def lookup(self, word: str) -> list[str] | None:
        return self._entries.get(word.upper())


def _parse_cmudict(lines) -> dict[str, list[str]]:
    out: dict[str, list[str]] = {}
    for line in lines:
        if not line or line.startswith(";;;"):
            continue
        parts = line.split("  ")
        if len(parts) != 2:
            continue
        word = _ALT_RE.sub("", parts[0])
        pron = _validate(parts[1].strip())
        if pron is not None:
            out.setdefault(word, []).append(pron)
    return out


def _validate(pron: str) -> str | None:
    for ph in pron.split(" "):
        if ph.rstrip("012") not in _VALID:
            return None
    return pron


# suffix-voicing classes: the last phone of the base picks the allomorph
_SIBILANT = {"S", "Z", "SH", "CH", "JH", "ZH"}
_VOICELESS = {"P", "T", "K", "F", "TH"}


def _last_phone(pron: str) -> str:
    return pron.split(" ")[-1].rstrip("012")


def _s_suffix(pron: str) -> str:
    lp = _last_phone(pron)
    if lp in _SIBILANT:
        return pron + " IH0 Z"
    if lp in _VOICELESS:
        return pron + " S"
    return pron + " Z"


def _ed_suffix(pron: str) -> str:
    lp = _last_phone(pron)
    if lp in ("T", "D"):
        return pron + " IH0 D"
    if lp in _VOICELESS or lp in ("S", "SH", "CH"):
        return pron + " T"
    return pron + " D"


def derive(word: str, lookup) -> str | None:
    """A pronunciation for an inflection missing from the lexicon, built
    from an in-lexicon base with the regular English voicing rules: plural
    and possessive -s, past -ed, -ing, -ly, -er and -est. `lookup` maps
    WORD -> list of pronunciations or None."""
    w = word.upper()

    def base_pron(candidates):
        for c in candidates:
            if len(c) >= 2:
                prons = lookup(c)
                if prons:
                    return prons[0]
        return None

    def undouble(stem: str) -> list[str]:
        # stopp -> stop, runn -> run (the doubled-consonant spelling rule)
        out = [stem, stem + "E"]
        if len(stem) >= 2 and stem[-1] == stem[-2]:
            out.append(stem[:-1])
        return out

    if w.endswith("'S"):
        b = base_pron([w[:-2]])
        if b:
            return _s_suffix(b)
    if w.endswith("IES"):
        b = base_pron([w[:-3] + "Y"])
        if b:
            return _s_suffix(b)
    if w.endswith("ES"):
        b = base_pron([w[:-2]])
        if b:
            return _s_suffix(b)
    if w.endswith("S") and not w.endswith("SS"):
        b = base_pron([w[:-1]])
        if b:
            return _s_suffix(b)
    if w.endswith("IED"):
        b = base_pron([w[:-3] + "Y"])
        if b:
            return _ed_suffix(b)
    if w.endswith("ED"):
        b = base_pron(undouble(w[:-2]) + [w[:-1]])
        if b:
            return _ed_suffix(b)
    if w.endswith("ING"):
        b = base_pron(undouble(w[:-3]))
        if b:
            return b + " IH0 NG"
    if w.endswith("ILY"):
        # happily <- happy: -y (IY0) + -ily (AH0 L IY0)
        b = base_pron([w[:-3] + "Y"])
        if b and b.endswith(" IY0"):
            return b[: -len(" IY0")] + " AH0 L IY0"
    if w.endswith("LY"):
        b = base_pron([w[:-2]])
        if b:
            return b + " L IY0"
    if w.endswith("IEST"):
        b = base_pron([w[:-4] + "Y"])
        if b:
            return b + " AH0 S T"
    if w.endswith("EST"):
        b = base_pron(undouble(w[:-3]) + [w[:-2]])
        if b:
            return b + " AH0 S T"
    if w.endswith("IER"):
        b = base_pron([w[:-3] + "Y"])
        if b:
            return b + " ER0"
    if w.endswith("ER"):
        b = base_pron(undouble(w[:-2]) + [w[:-1]])
        if b:
            return b + " ER0"
    return None


def arpabet_to_ipa(pron: str) -> str:
    """ARPAbet ("HH AH0 L OW1") -> IPA, a stress digit 1 or 2 written as
    the primary or secondary stress mark before its vowel."""
    out: list[str] = []
    for ph in pron.split(" "):
        stress = ph[-1] if ph and ph[-1] in "012" else ""
        ipa = ARPABET_TO_IPA.get(ph.rstrip("012"), "")
        out.append({"1": "ˈ", "2": "ˌ"}.get(stress, "") + ipa)
    return "".join(out)
