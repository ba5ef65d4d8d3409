"""The corpus formatters the port took from the JAX package (tweb, mozilla,
mailabs, libri_tts, common_voice, vctk) on a tiny tree of each layout
built under tmp_path: the port's rows, speakers included, equal the JAX
formatter's list for list, and `load_meta_data` splits them as the JAX
package's does. Each tree has several speakers and the layout's edge
cases (raw-only lines, ids with and without a batch prefix, a VCTK text
without its audio and one whose audio sits in wav/, Common Voice columns
out of order)."""

import os

import pytest

from your_voice_tts_tpu.config import DatasetConfig as JaxDatasetConfig
from your_voice_tts_tpu.data import formatters as jax_formatters
from your_voice_tts_tpu.data import load_meta_data as jax_load_meta_data
from your_voice_tts_torch.config import DatasetConfig
from your_voice_tts_torch.data import formatters, load_meta_data


def write(path, text: str = "") -> None:
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with open(path, "w", encoding="utf-8") as f:
        f.write(text)


def tweb(root):
    write(os.path.join(root, "meta.txt"),
          "".join(f"clip_{i:02d}\tIn the beginning {i}.\n" for i in range(5)))
    return "meta.txt"


def mozilla(root):
    write(os.path.join(root, "meta.txt"),
          "12_0001|Guten Tag.\n3_0042.wav|Wie geht es?\nsolo|Ohne Stapel.\n")
    return "meta.txt"


def mailabs(root):
    for gender, speaker, book, rows in (
            ("female", "anna", "book1", ["ch01_0001|Raw text|Normalized text",
                                         "ch01_0002|Only raw"]),
            ("female", "anna", "book2", ["ch02_0001|Raw|Second book"]),
            ("male", "bert", "book1", ["ch01_0001|R|His line", "ch01_0002|R|Another"])):
        write(os.path.join(root, "by_book", gender, speaker, book, "metadata.csv"),
              "".join(r + "\n" for r in rows))
    return None


def libri_tts(root):
    for spk, chap, n in (("19", "198", 3), ("103", "1240", 2)):
        for i in range(n):
            write(os.path.join(root, spk, chap, f"{spk}_{chap}_000000_{i:06d}.normalized.txt"),
                  f"Line {i} of speaker {spk}.\n")
    return None


def common_voice(root):
    write(os.path.join(root, "validated.tsv"),
          "sentence\tage\tclient_id\tpath\n"
          "Hello common voice.\t30\tabc123\tsample-000.mp3\n"
          "A second voice.\t\tdef456\tsample-001.mp3\n"
          "The first again.\t30\tabc123\tsample-002.mp3\n")
    return "validated.tsv"


def vctk(root):
    for spk, n in (("p225", 3), ("p226", 2)):
        for i in range(n):
            write(os.path.join(root, "txt", spk, f"{spk}_{i:03d}.txt"), f"{spk} line {i}.\n")
            if (spk, i) != ("p225", 2):                 # a text without its audio
                wav_dir = "wav" if spk == "p226" else "wav48"
                write(os.path.join(root, wav_dir, spk, f"{spk}_{i:03d}.wav"))
    return None


LAYOUTS = {f.__name__: f for f in (tweb, mozilla, mailabs, libri_tts, common_voice, vctk)}


@pytest.mark.parametrize("name", sorted(LAYOUTS))
def test_rows_are_the_jax_formatters(tmp_path, name):
    """The port's formatter, and the one `get_formatter` names, give the
    JAX formatter's rows on the layout's tree; the multi-speaker layouts
    name more than one speaker."""
    root = str(tmp_path)
    meta = LAYOUTS[name](root)
    args = (root,) if meta is None else (root, meta)
    ref = getattr(jax_formatters, name)(*args)
    got = formatters.get_formatter(name)(*args)
    assert got == ref and len(ref) >= 3
    assert formatters.get_formatter(name) is getattr(formatters, name)
    if name in ("mailabs", "libri_tts", "common_voice", "vctk"):
        assert len({row[2] for row in got}) >= 2


@pytest.mark.parametrize("name", ["common_voice", "vctk"])
def test_load_meta_data_is_the_jax_packages(tmp_path, name):
    """`load_meta_data` over a dataset of the layout, without and with a
    validation file: the JAX package's train and eval rows."""
    root = str(tmp_path)
    meta = LAYOUTS[name](root)
    for val in (None, meta):
        kw = dict(name=name, path=root, meta_file_train=meta, meta_file_val=val)
        assert load_meta_data([DatasetConfig(**kw)]) == \
            jax_load_meta_data([JaxDatasetConfig(**kw)])
