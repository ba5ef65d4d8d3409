"""Symbol tables (the JAX package's text/symbols.py).

IDs index the model's symbol embedding, so table ORDER is part of the
checkpoint format. The grapheme table: pad/eos/bos, the ASCII characters
and punctuation, then the "@"-prefixed ARPAbet entries used for inline
"{HH AH0 L OW1}" text. The phoneme table: pad/eos/bos, the sorted IPA
inventory, then the punctuation.
"""

from .cmudict import VALID_SYMBOLS

_pad = "_"
_eos = "~"
_bos = "^"

_characters = "ABCDEFGHIJKLMNOPQRSTUVWXYZabcdefghijklmnopqrstuvwxyz!'(),-.:;? "
_punctuations = "!'(),-.:;? "

# IPA phoneme inventory (espeak-ng en/de output coverage): vowels,
# non-pulmonic and pulmonic consonants, suprasegmentals, other symbols and
# diacritics
_vowels = "iyɨʉɯuɪʏʊeøɘəɵɤoɛœɜɞʌɔæɐaɶɑɒᵻ"
_non_pulmonic_consonants = "ʘɓǀɗǃʄǂɠǁʛ"
_pulmonic_consonants = "pbtdʈɖcɟkɡqɢʔɴŋɲɳnɱmʙrʀⱱɾɽɸβfvθðszʃʒʂʐçʝxɣχʁħʕhɦɬɮʋɹɻjɰlɭʎʟ"
_suprasegmentals = "ˈˌːˑ"
_other_symbols = "ʍwɥʜʢʡɕʑɺɧ"
_diacritics = "ɚ˞ɫ"
_phoneme_chars = (_vowels + _non_pulmonic_consonants + _pulmonic_consonants
                  + _suprasegmentals + _other_symbols + _diacritics)

symbols: list[str] = ([_pad, _eos, _bos] + list(_characters)
                      + ["@" + s for s in VALID_SYMBOLS])
phonemes: list[str] = [_pad, _eos, _bos] + sorted(set(_phoneme_chars)) + list(_punctuations)

pad = _pad
eos = _eos
bos = _bos


def make_symbols(characters: str, punctuations: str = _punctuations,
                 pad: str = _pad, eos: str = _eos, bos: str = _bos) -> list[str]:
    """A custom grapheme table: pad/eos/bos, `characters`, then each
    punctuation mark not already among them (dropping one would delete
    that character from every input sequence)."""
    extra = [p for p in punctuations if p not in characters]
    return [pad, eos, bos] + list(characters) + extra
