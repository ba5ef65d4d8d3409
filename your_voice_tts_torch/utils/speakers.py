"""Speaker mapping files (the JAX package's utils/speakers.py).

speakers.json maps speaker name -> integer id (the model's own table) or
speaker name -> {clip: {"embedding": [...]}} (external d-vectors, as
bin/compute_embeddings writes them).
"""

from __future__ import annotations

import json
import os

import numpy as np


def save_speaker_mapping(out_path: str, speaker_mapping: dict) -> None:
    path = os.path.join(out_path, "speakers.json") if os.path.isdir(out_path) else out_path
    with open(path, "w", encoding="utf-8") as f:
        json.dump(speaker_mapping, f, indent=2)


def load_speaker_mapping(path: str) -> dict:
    if os.path.isdir(path):
        path = os.path.join(path, "speakers.json")
    with open(path, encoding="utf-8") as f:
        return json.load(f)


def parse_speakers(mapping: dict):
    """A speakers.json -> (name -> id, name -> mean d-vector or None). In
    d-vector mode the ids are the names' sorted order, and a speaker's
    vector is the mean of its clips' (or the one list given)."""
    if not mapping:
        return {}, None
    first = next(iter(mapping.values()))
    if isinstance(first, int):
        return dict(mapping), None
    ids = {name: i for i, name in enumerate(sorted(mapping))}
    embeddings = {}
    for name, val in mapping.items():
        if isinstance(val, dict):
            vecs = [np.asarray(clip["embedding"] if isinstance(clip, dict) else clip, np.float32)
                    for clip in val.values()]
            embeddings[name] = np.mean(vecs, axis=0)
        else:
            embeddings[name] = np.asarray(val, np.float32)
    return ids, embeddings
