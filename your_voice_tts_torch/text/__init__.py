"""Text -> symbol-id sequences (the JAX package's text/__init__.py).

The grapheme path (`text_to_sequence`) maps cleaned characters, and inline
"{HH AH0 L OW1}" ARPAbet, to the grapheme table. The phoneme path
(`phoneme_to_sequence`) cleans, phonemizes through a G2P backend and maps
the IPA characters to the phoneme table. The backends: espeak-ng in a
subprocess (the reference's engine) where the binary exists, a lookup of
precomputed phonemizations, the CMU dictionary with a rule fallback for
words it lacks, and the rule fallback alone. `default_g2p_backend` picks
one, or builds the one a checkpoint was trained with.
"""

from __future__ import annotations

import logging
import os
import re
import shutil
import subprocess

import numpy as np

from .cleaners import get_cleaner
from .symbols import bos, eos, pad, phonemes, symbols

_log = logging.getLogger(__name__)
_curly_re = re.compile(r"(.*?)\{(.+?)\}(.*)")

_symbol_to_id = {s: i for i, s in enumerate(symbols)}
_id_to_symbol = {i: s for i, s in enumerate(symbols)}
_phoneme_to_id = {s: i for i, s in enumerate(phonemes)}
_id_to_phoneme = {i: s for i, s in enumerate(phonemes)}

_PUNCT_KEEP = set("!'(),-.:;? ")


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


def sequence_to_text(seq) -> str:
    return "".join(_id_to_symbol[int(i)] for i in seq if int(i) in _id_to_symbol)


def phoneme_to_sequence(text: str, cleaner_names: str | list[str] = "phoneme_cleaners",
                        language: str = "en-us", enable_eos_bos: bool = False,
                        backend: "G2PBackend | None" = None) -> np.ndarray:
    """Clean, phonemize (with `backend`, or `default_g2p_backend`) and map
    the IPA characters to phoneme ids; bos ... eos around them with
    enable_eos_bos."""
    text = _clean(text, cleaner_names)
    ipa = (backend or default_g2p_backend(language)).phonemize(text)
    ids = [_phoneme_to_id[ch] for ch in ipa if ch in _phoneme_to_id and ch != pad]
    if enable_eos_bos:
        ids = [_phoneme_to_id[bos]] + ids + [_phoneme_to_id[eos]]
    return np.asarray(ids, dtype=np.int32)


def sequence_to_phoneme(seq) -> str:
    return "".join(_id_to_phoneme[int(i)] for i in seq if int(i) in _id_to_phoneme)


def pad_with_eos_bos(seq: np.ndarray, use_phonemes: bool = False) -> np.ndarray:
    table = _phoneme_to_id if use_phonemes else _symbol_to_id
    return np.concatenate(
        [[table[bos]], np.asarray(seq, dtype=np.int32), [table[eos]]]).astype(np.int32)


class G2PBackend:
    """Grapheme -> IPA backend."""

    def phonemize(self, text: str) -> str:  # pragma: no cover - interface
        raise NotImplementedError


class EspeakBackend(G2PBackend):
    """espeak-ng (or espeak) in a subprocess; raises RuntimeError where
    neither binary is on PATH."""

    def __init__(self, language: str = "en-us"):
        self.language = language
        self._bin = shutil.which("espeak-ng") or shutil.which("espeak")
        if self._bin is None:
            raise RuntimeError("espeak/espeak-ng binary not found")

    def phonemize(self, text: str) -> str:
        out = subprocess.run([self._bin, "-q", "--ipa=3", "-v", self.language, text],
                             capture_output=True, text=True, check=True).stdout
        # --ipa=3 separates the phonemes within a word with "_": drop it (a
        # space would read as the space symbol, a word boundary)
        return out.strip().replace("_", "")


class CacheBackend(G2PBackend):
    """Lookup of precomputed phonemizations (text -> IPA); a text missing
    from it raises KeyError."""

    def __init__(self, mapping: dict[str, str]):
        self.mapping = mapping

    @classmethod
    def from_npy_dir(cls, path: str) -> "CacheBackend":
        """The union of the {text: IPA} dicts saved as .npy files in `path`."""
        mapping = {}
        for fn in os.listdir(path):
            if fn.endswith(".npy"):
                mapping.update(np.load(os.path.join(path, fn), allow_pickle=True).item())
        return cls(mapping)

    def phonemize(self, text: str) -> str:
        try:
            return self.mapping[text]
        except KeyError:
            raise KeyError(f"text not in phoneme cache: {text[:60]!r}") from None


class RuleG2PBackend(G2PBackend):
    """Deterministic letter-to-IPA rules (digraphs first, then single
    letters; punctuation and spaces kept). Not linguistically faithful: the
    fallback that keeps the phoneme path working without a lexicon."""

    _DIGRAPHS = [
        ("tch", "tʃ"), ("sch", "ʃ"), ("ch", "tʃ"), ("sh", "ʃ"), ("th", "θ"),
        ("ph", "f"), ("ng", "ŋ"), ("qu", "kw"), ("oo", "uː"), ("ee", "iː"),
        ("ea", "iː"), ("ai", "eɪ"), ("ay", "eɪ"), ("ou", "aʊ"), ("ow", "aʊ"),
        ("oi", "ɔɪ"), ("oy", "ɔɪ"), ("ck", "k"),
    ]
    _SINGLE = {
        "a": "æ", "b": "b", "c": "k", "d": "d", "e": "ɛ", "f": "f", "g": "ɡ",
        "h": "h", "i": "ɪ", "j": "dʒ", "k": "k", "l": "l", "m": "m", "n": "n",
        "o": "ɒ", "p": "p", "q": "k", "r": "ɹ", "s": "s", "t": "t", "u": "ʌ",
        "v": "v", "w": "w", "x": "ks", "y": "j", "z": "z",
    }

    def phonemize(self, text: str) -> str:
        text = text.lower()
        out: list[str] = []
        i = 0
        while i < len(text):
            for pat, rep in self._DIGRAPHS:
                if text.startswith(pat, i):
                    out.append(rep)
                    i += len(pat)
                    break
            else:
                ch = text[i]
                if ch in self._SINGLE:
                    out.append(self._SINGLE[ch])
                elif ch in _PUNCT_KEEP:
                    out.append(ch)
                i += 1
        return "".join(out)


class CMUDictBackend(G2PBackend):
    """Offline G2P on a CMU dictionary: each word's first pronunciation in
    IPA; a word the lexicon lacks is derived from its base (`derive`) or,
    failing that, falls through to the rules. Counts the words, the
    derived ones and the out-of-vocabulary ones."""

    name = "cmudict"

    def __init__(self, cmudict_path: str):
        from .cmudict import CMUDict, arpabet_to_ipa, derive

        self.dict = CMUDict(cmudict_path)
        self._to_ipa = arpabet_to_ipa
        self._derive = derive
        self._fallback = RuleG2PBackend()
        self.oov_count = 0
        self.word_count = 0
        self.derived_count = 0

    @property
    def oov_rate(self) -> float:
        """The share of words that fell through to the rules."""
        return self.oov_count / max(self.word_count, 1)

    def phonemize(self, text: str) -> str:
        out: list[str] = []
        # apostrophes stay inside a token, so contractions and possessives
        # look up whole (DON'T, DOG'S) and the 'S derivation can fire;
        # quote apostrophes around a word are peeled off
        for raw in re.split(r"(\s+|[!(),\-.:;?])", text):
            if not raw:
                continue
            if raw.isspace() or raw in _PUNCT_KEEP:
                out.append(raw)
                continue
            tok = raw.strip("'")
            if not tok:
                out.append(raw)
                continue
            out.append("'" * (len(raw) - len(raw.lstrip("'"))))
            trail = len(raw) - len(raw.rstrip("'"))
            self.word_count += 1
            prons = self.dict.lookup(tok)
            if prons:
                out.append(self._to_ipa(prons[0]))
            else:
                derived = self._derive(tok, self.dict.lookup)
                if derived:
                    self.derived_count += 1
                    out.append(self._to_ipa(derived))
                else:
                    self.oov_count += 1
                    out.append(self._fallback.phonemize(tok))
            if trail:
                out.append("'" * trail)
        return "".join(out)


def bundled_cmudict_path() -> str | None:
    """The lexicon in the repository's assets/ (cmudict_core.txt), or None
    where it is missing."""
    path = os.path.join(os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__)))), "assets", "cmudict_core.txt")
    return path if os.path.exists(path) else None


def default_g2p_backend(language: str = "en-us", cmudict_path: str | None = None,
                        prefer: str | None = None) -> G2PBackend:
    """espeak-ng where the binary exists, else CMUDict (`cmudict_path` or
    the bundled lexicon), else the rules with a warning: a checkpoint
    trained on espeak phonemes gets another symbol stream from them.

    prefer: the backend class name a checkpoint was trained with
    (cfg.data.g2p_backend). That backend is built even where another one
    is available; where it cannot be, the chain above picks one, with a
    warning that the phoneme stream differs from training."""
    if prefer == "RuleG2PBackend":
        return RuleG2PBackend()
    if prefer == "CMUDictBackend":
        path = cmudict_path or bundled_cmudict_path()
        if path:
            try:
                return CMUDictBackend(path)
            except OSError as e:
                _log.warning("pinned CMUDictBackend unusable (%s); phoneme "
                             "stream will DIFFER from training", e)
    elif prefer == "EspeakBackend":
        try:
            return EspeakBackend(language)
        except RuntimeError:
            _log.warning("pinned EspeakBackend unavailable (no espeak "
                         "binary); phoneme stream will DIFFER from training")
    elif prefer is not None:
        _log.warning("unknown pinned G2P backend %r; using auto selection", prefer)
    try:
        return EspeakBackend(language)
    except RuntimeError:
        pass
    cmudict_path = cmudict_path or bundled_cmudict_path()
    if cmudict_path:
        try:
            return CMUDictBackend(cmudict_path)
        except OSError as e:
            _log.warning("cmudict_path %s unusable (%s)", cmudict_path, e)
    _log.warning(
        "G2P: espeak-ng not found and no CMUDict lexicon configured — "
        "falling back to the rule-based letter-to-IPA backend, which is NOT "
        "linguistically faithful. Phoneme streams will differ from any "
        "espeak-trained checkpoint. Install espeak-ng or set "
        "data.cmudict_path to a CMU dictionary file.")
    return RuleG2PBackend()


__all__ = [
    "text_to_sequence", "sequence_to_text", "phoneme_to_sequence",
    "sequence_to_phoneme", "pad_with_eos_bos", "symbols", "phonemes",
    "pad", "eos", "bos", "G2PBackend", "EspeakBackend", "CacheBackend",
    "RuleG2PBackend", "CMUDictBackend", "default_g2p_backend",
    "bundled_cmudict_path",
]
