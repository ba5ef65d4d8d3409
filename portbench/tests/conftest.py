"""Narrow configurations and light mixes for the CPU tests of the
benchmark: the cells' own files with every width shrunk, a few clients, a
short pool, decodes of 10 steps, limits a narrow run can meet."""

import json
import os
import sys

import pytest
import torch

# a few threads: the plain CPU paths slow down by an order of magnitude when
# their pool outnumbers the cores a shared machine gives them
torch.set_num_threads(2)

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

NARROW = dict(embedding_dim=16, encoder_dim=16, attention_rnn_dim=32, decoder_rnn_dim=32,
              attention_dim=8, attention_location_filters=4, attention_location_kernel_size=5,
              prenet_dim=8, postnet_dim=16, max_decoder_steps=10)


def bench() -> dict:
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        return json.load(f)


def narrow(workload: str) -> tuple[dict, dict]:
    """(conf, mix) of a cell, shrunk to run on the CPU in seconds."""
    from portbench import harness

    cell = harness.cell_of(bench(), workload)
    # the gaps' limits loosened to what a sound narrow run reads (its few
    # frames and rows are no full-size run): a planted fault has to fail an
    # exact check or pass these
    limits = dict(cell["conf"]["limits"], decode_gap=0.05, stop_gap=0.05, align_gap=0.05,
                  postnet_gap=1e-4, vocoder_gap=0.1)
    conf = dict(cell["conf"], tts=dict(cell["conf"]["tts"], **NARROW), limits=limits)
    if conf.get("vocoder"):
        conf["vocoder"] = dict(conf["vocoder"],
                               melgan=dict(conf["vocoder"]["melgan"], base_channels=16))
    mix = dict(cell["mix"], pool=2048, sample={"rows": 4, "share": 0.3})
    if "clients" in mix:
        mix.update(clients=6, max_batch=3)
    else:
        mix.update(batch=6)
    return conf, mix


@pytest.fixture
def cells():
    return [w["name"] for w in bench()["workloads"]]
