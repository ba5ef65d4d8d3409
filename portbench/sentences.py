"""The one traffic generator: English sentences whose lengths follow a
mix's parameters, made from the seed.

Every seed gets the same multiset of lengths (a quantile grid of a
log-normal, clipped to the mix's bounds), in an order and with words that
the seed draws, so that the work of a run does not depend on its seed;
only which sentence lands in which batch does.

A mix file (portbench/traffic/<mix>.json) gives:
  "lengths": {"min", "max", "median", "sigma"}  characters a sentence
  "pool": how many distinct sentences a run draws (more than a run serves)
  "comma_every": a comma after a word with this chance's inverse (0: none)
"""

from __future__ import annotations

import os
import statistics

import numpy as np

WORDS = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data", "words.txt")


def words() -> list[str]:
    with open(WORDS, encoding="utf-8") as f:
        return [w.strip() for w in f if w.strip() and not w.startswith("#")]


def lengths(spec: dict, n: int) -> np.ndarray:
    """The n sentence lengths every seed shares: log-normal quantiles at
    (i + 1/2) / n, rounded and clipped to [min, max]."""
    dist = statistics.NormalDist()
    z = np.array([dist.inv_cdf((i + 0.5) / n) for i in range(n)])
    ln = np.rint(spec["median"] * np.exp(spec["sigma"] * z))
    return np.clip(ln, spec["min"], spec["max"]).astype(int)


def sentences(rng: np.random.Generator, vocab: list[str], lens: np.ndarray,
              comma_every: int, most: int = 64) -> list[str]:
    """One sentence a length: words drawn from vocab while the next, its
    comma and the closing period still fit in the length (at least one
    word); first letter capitalized."""
    n = len(lens)
    idx = rng.integers(len(vocab), size=(n, most))
    comma = (rng.integers(comma_every, size=(n, most)) == 0) if comma_every else \
        np.zeros((n, most), bool)
    comma[:, -1] = False
    wl = np.array([len(w) for w in vocab])[idx] + 1 + comma    # word, space or period, comma
    fits = np.cumsum(wl, 1) <= lens[:, None]
    fits[:, 0] = True
    count = np.minimum(np.argmin(fits, 1) + most * fits.all(1), most)
    out = []
    for r in range(n):
        k = int(count[r])
        ws = [vocab[i] + ("," if c and j < k - 1 else "")
              for j, (i, c) in enumerate(zip(idx[r, :k], comma[r, :k]))]
        s = " ".join(ws)
        out.append(s[0].upper() + s[1:] + ".")
    return out


def pool(mix: dict, seed: int) -> list[str]:
    """The run's sentences, distinct, in the order the traffic sends them."""
    rng = np.random.default_rng(seed)
    vocab = words()
    order = rng.permutation(lengths(mix["lengths"], mix["pool"]))
    out = sentences(rng, vocab, order, mix.get("comma_every", 0))
    seen: set[str] = set()
    for i, s in enumerate(out):
        while s in seen:
            s = sentences(rng, vocab, order[i:i + 1], mix.get("comma_every", 0))[0]
        seen.add(s)
        out[i] = s
    return out
