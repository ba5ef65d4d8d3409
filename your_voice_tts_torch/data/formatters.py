"""Corpus metadata formatters (the JAX package's data/formatters.py), the
two this slice trains on: each returns ``[text, wav_path, speaker]`` rows."""

from __future__ import annotations

import os


def ljspeech(root_path: str, meta_file: str = "metadata.csv") -> list[list[str]]:
    """LJSpeech-1.1: metadata.csv with id|raw|normalized text."""
    items = []
    with open(os.path.join(root_path, meta_file), encoding="utf-8") as f:
        for line in f:
            cols = line.rstrip("\n").split("|")
            text = cols[2] if len(cols) > 2 else cols[1]
            items.append([text, os.path.join(root_path, "wavs", cols[0] + ".wav"), "ljspeech"])
    return items


def synthetic(root_path: str, meta_file: str = "metadata.csv") -> list[list[str]]:
    """The synthetic corpus (data/synthetic.py): LJSpeech layout, speaker
    parsed from the SYNxx file-id prefix."""
    items = []
    with open(os.path.join(root_path, meta_file), encoding="utf-8") as f:
        for line in f:
            cols = line.rstrip("\n").split("|")
            text = cols[2] if len(cols) > 2 else cols[1]
            items.append([text, os.path.join(root_path, "wavs", cols[0] + ".wav"),
                          cols[0].split("-")[0]])
    return items


FORMATTERS = {"ljspeech": ljspeech, "synthetic": synthetic}
LATER = ("tweb", "mozilla", "mailabs", "libri_tts", "common_voice", "vctk")


def get_formatter(name: str):
    if name in LATER:
        raise NotImplementedError(
            f"dataset formatter {name!r} arrives with a later slice of the port")
    try:
        return FORMATTERS[name]
    except KeyError:
        raise ValueError(f"unknown dataset formatter {name!r}") from None


def load_meta_data(datasets, eval_split: bool = True):
    """Concatenate the formatters' rows over the configured datasets and
    split train / eval by meta_file_val, or else the first 1% (at least one
    row) of each dataset as eval."""
    train_items, eval_items = [], []
    for ds in datasets:
        formatter = get_formatter(ds.name)
        items = formatter(ds.path, ds.meta_file_train) if ds.meta_file_train \
            else formatter(ds.path)
        if ds.meta_file_val:
            eval_items += formatter(ds.path, ds.meta_file_val)
            train_items += items
        elif eval_split:
            n_eval = max(1, int(len(items) * 0.01))
            eval_items += items[:n_eval]
            train_items += items[n_eval:]
        else:
            train_items += items
    return train_items, eval_items
