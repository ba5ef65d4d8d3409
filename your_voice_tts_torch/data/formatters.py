"""Corpus metadata formatters (the JAX package's data/formatters.py, after
the reference's datasets/preprocess.py): each reads one corpus layout and
returns ``[text, wav_path, speaker]`` rows. The multi-speaker corpora
(M-AILABS, LibriTTS, Common Voice, VCTK) name each row's speaker, which the
Trainer's speaker map numbers."""

from __future__ import annotations

import os
from glob import glob


def ljspeech(root_path: str, meta_file: str = "metadata.csv") -> list[list[str]]:
    """LJSpeech-1.1: metadata.csv with id|raw|normalized text."""
    items = []
    with open(os.path.join(root_path, meta_file), encoding="utf-8") as f:
        for line in f:
            cols = line.rstrip("\n").split("|")
            text = cols[2] if len(cols) > 2 else cols[1]
            items.append([text, os.path.join(root_path, "wavs", cols[0] + ".wav"), "ljspeech"])
    return items


def tweb(root_path: str, meta_file: str) -> list[list[str]]:
    """The World English Bible corpus: tab-separated id\ttext."""
    items = []
    with open(os.path.join(root_path, meta_file), encoding="utf-8") as f:
        for line in f:
            cols = line.rstrip("\n").split("\t")
            items.append([cols[1], os.path.join(root_path, cols[0] + ".wav"), "tweb"])
    return items


def mozilla(root_path: str, meta_file: str) -> list[list[str]]:
    """Mozilla German corpus: pipe-separated, wavs in BATCH_<n>_FINAL
    folders by the id's prefix (or wavs/)."""
    items = []
    with open(os.path.join(root_path, meta_file), encoding="utf-8") as f:
        for line in f:
            cols = line.rstrip("\n").split("|")
            wav_folder = f"BATCH_{cols[0].split('_')[0]}_FINAL" if "_" in cols[0] else "wavs"
            wav = os.path.join(root_path, wav_folder, cols[0])
            if not wav.endswith(".wav"):
                wav += ".wav"
            items.append([cols[1], wav, "mozilla"])
    return items


def mailabs(root_path: str, meta_files: str | None = None) -> list[list[str]]:
    """M-AILABS: by_book/<gender>/<speaker>/<book>/metadata.csv trees, the
    speaker the folder two above each metadata.csv."""
    items = []
    for meta in glob(os.path.join(root_path, "**", "metadata.csv"), recursive=True):
        folder = os.path.dirname(meta)
        parts = os.path.normpath(meta).split(os.sep)
        speaker = parts[-3] if len(parts) >= 3 else "mailabs"
        with open(meta, encoding="utf-8") as f:
            for line in f:
                cols = line.rstrip("\n").split("|")
                text = cols[2] if len(cols) > 2 else cols[1]
                items.append([text, os.path.join(folder, "wavs", cols[0] + ".wav"), speaker])
    return items


def libri_tts(root_path: str, meta_files: str | None = None) -> list[list[str]]:
    """LibriTTS: <speaker>/<chapter>/*.normalized.txt beside their .wav
    files; speaker LTTS_<the file name's first field>."""
    items = []
    for txt in glob(os.path.join(root_path, "**", "*.normalized.txt"), recursive=True):
        with open(txt, encoding="utf-8") as f:
            text = f.read().strip()
        items.append([text, txt.replace(".normalized.txt", ".wav"),
                      f"LTTS_{os.path.basename(txt).split('_')[0]}"])
    return items


def common_voice(root_path: str, meta_file: str) -> list[list[str]]:
    """Mozilla Common Voice: a tsv with client_id, path and sentence columns
    (by its header); the clips as .wav under clips/, the speaker the
    client_id."""
    items = []
    with open(os.path.join(root_path, meta_file), encoding="utf-8") as f:
        idx = {name: i for i, name in enumerate(f.readline().rstrip("\n").split("\t"))}
        for line in f:
            cols = line.rstrip("\n").split("\t")
            wav = os.path.join(root_path, "clips", cols[idx["path"]].replace(".mp3", ".wav"))
            items.append([cols[idx["sentence"]], wav, cols[idx["client_id"]]])
    return items


def vctk(root_path: str, meta_files: str | None = None) -> list[list[str]]:
    """VCTK: txt/<speaker>/*.txt with the audio in wav48/<speaker>/ (or
    wav/<speaker>/); a text without its audio is left out; speaker
    VCTK_<speaker>."""
    items = []
    for txt in glob(os.path.join(root_path, "txt", "**", "*.txt"), recursive=True):
        speaker = os.path.basename(os.path.dirname(txt))
        file_id = os.path.splitext(os.path.basename(txt))[0]
        with open(txt, encoding="utf-8") as f:
            text = f.read().strip()
        for wav_dir in ("wav48", "wav"):
            wav = os.path.join(root_path, wav_dir, speaker, file_id + ".wav")
            if os.path.exists(wav):
                items.append([text, wav, f"VCTK_{speaker}"])
                break
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


FORMATTERS = {"ljspeech": ljspeech, "tweb": tweb, "mozilla": mozilla, "mailabs": mailabs,
              "libri_tts": libri_tts, "common_voice": common_voice, "vctk": vctk,
              "synthetic": synthetic}


def get_formatter(name: str):
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
