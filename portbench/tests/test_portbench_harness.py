"""CPU tests of the benchmark's harness: every part found by name, the
traffic made from the seed alone, the result line's keys, the refusal
without a card, and the whole-name check for the JAX package."""

import json
import os
import subprocess
import sys
import time
import types

import numpy as np
import pytest
from conftest import ROOT, bench, narrow

from portbench import harness, sentences
from portbench.system import plugs


def test_every_part_of_every_cell_is_found_by_name(cells):
    b = bench()
    files = {c["name"]: c["file"] for c in b["configs"]}
    for name in cells:
        cell = harness.cell_of(b, name)
        w = cell["workload"]
        assert os.path.exists(os.path.join(ROOT, files[w["config"]]))
        assert os.path.exists(os.path.join(ROOT, "portbench", "drivers",
                                           cell["mix"]["driver"] + ".py"))
        model, vocoder = plugs(cell["conf"])
        for plug in (model, vocoder):
            for name in ("KERNELS", "CONTROL", "weight_spec", "install", "reference", "flops"):
                assert hasattr(plug, name), (plug.__name__, name)
        for name in ("FIELDS", "keep_result", "numbers"):
            assert hasattr(model, name), name
        for name in ("vocoder_config", "prepare", "gap"):
            assert hasattr(vocoder, name), name
        assert {m["name"] for m in cell["end_to_end"]} >= {"setup_s", "audio_s_per_s"}
        assert cell["per_layer"]
        for m in cell["per_layer"]:
            mod = harness.load_module(os.path.join(ROOT, "portbench", "metrics",
                                                   m["name"] + ".py"), "m")
            assert callable(mod.read)


def test_metric_workloads_report_what_they_move():
    b = bench()
    e2e = {m["name"]: set(m.get("workloads", [w["name"] for w in b["workloads"]]))
           for m in b["end_to_end"]}
    for m in b["per_layer"]:
        assert set(m["workloads"]) <= e2e[m["moves"]], m["name"]


def test_traffic_is_made_from_the_seed_alone():
    cell = harness.cell_of(bench(), "tacotron2-ljspeech-melgan.serve-c64")
    mix = dict(cell["mix"], pool=512)
    a, b, c = sentences.pool(mix, 2 ** 31 + 5), sentences.pool(mix, 2 ** 31 + 5), \
        sentences.pool(mix, 7)
    assert a == b and a != c
    assert len(set(a)) == len(a)
    spec = mix["lengths"]
    assert all(spec["min"] - 8 <= len(s) <= spec["max"] for s in a + c)
    # every seed gets the same lengths to aim at, in its own order
    assert np.array_equal(sentences.lengths(spec, 512), sentences.lengths(spec, 512))
    for s in a:
        assert s.endswith(".") and s[0].isupper() and not any(ch.isdigit() for ch in s)
        assert not any(p in s[:-1] for p in ".!?")


def test_import_check_compares_whole_top_level_names(monkeypatch):
    assert "your_voice_tts_torch" not in harness.forbidden_modules()
    monkeypatch.setitem(sys.modules, "your_voice_tts_tpu_extra", types.ModuleType("x"))
    assert harness.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "your_voice_tts_tpu.models", types.ModuleType("x"))
    assert harness.forbidden_modules() == ["your_voice_tts_tpu"]
    monkeypatch.setitem(sys.modules, "jax", types.ModuleType("jax"))
    assert harness.forbidden_modules() == ["jax", "your_voice_tts_tpu"]


def test_the_run_refuses_without_a_card():
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    p = subprocess.run([sys.executable, "portbench/run.py", "--workload",
                        "tacotron2-ljspeech-melgan.serve-c64", "--seed", "1", "--seconds", "1"],
                       cwd=ROOT, env=env, capture_output=True, text=True, timeout=300)
    assert p.returncode != 0
    assert p.stdout.strip() == ""
    assert "CUDA is not available" in p.stderr


def test_a_run_prints_the_contract_keys_with_the_checks_last():
    conf, mix = narrow("tacotron2-ljspeech-melgan.serve-c64")
    line = harness.run("tacotron2-ljspeech-melgan.serve-c64", 2 ** 31 + 11, 2.0, False,
                       time.perf_counter(), device="cpu", conf=conf, mix=mix)
    assert list(line) == ["correct", "attempted", "failed", "metrics", "device", "checks"]
    assert line["correct"] is True and line["failed"] == 0 and line["attempted"] > 0
    assert set(line["metrics"]) == {"audio_s_per_s", "setup_s"}
    assert all(m["value"] > 0 for m in line["metrics"].values())
    assert {"platform", "kind", "count", "memory_peak_bytes"} <= set(line["device"])
    assert all(set(n) == {"value", "limit"} for n in line["checks"].values())
    json.loads(json.dumps(line))


@pytest.mark.parametrize("workload,host_metrics", [
    ("tacotron2-ljspeech.bulk-b448", ["facade_ms", "trim_ms"]),
    ("tacotron2-ljspeech-melgan.serve-c64", ["facade_ms", "batch_rows.serve",
                                             "queue_wait_ms.serve", "latency_p95_ms.serve"]),
])
def test_a_traced_run_reads_its_per_layer_metrics(workload, host_metrics):
    conf, mix = narrow(workload)
    line = harness.run(workload, 3, 1.0, True, time.perf_counter(),
                       device="cpu", conf=conf, mix=mix)
    assert list(line)[-2:] == ["breakdown", "checks"]
    assert {"busy_s", "window_s"} <= set(line["device"])
    # a CPU run has no kernels: the device's metrics say nothing rather than 0
    assert "decode_roofline" not in line["metrics"]
    assert "synth_mfu" not in line["metrics"]
    for name in host_metrics:
        assert line["metrics"][name]["value"] > 0, name


def test_percentile_interpolates():
    assert harness.percentile([1.0, 2.0, 3.0, 4.0, 5.0], 95) == pytest.approx(4.8)
    assert harness.percentile([7.0], 95) == 7.0


@pytest.mark.parametrize("name", ["harness.py", "system.py", "check.py", "run.py", "trace.py"])
def test_the_harness_names_no_model_vocoder_or_metric(name):
    """A later configuration, vocoder or metric comes in as files of its own:
    the general code dispatches by the names in BENCHMARK.json and the
    configuration, and names none itself outside its prose."""
    import ast

    tree = ast.parse(open(os.path.join(ROOT, "portbench", name)).read())
    words = ("tacotron", "melgan", "griffin", "taco2", "wavernn", "audio_s_per_s",
             "latency_p95", "roofline")
    for node in ast.walk(tree):
        if isinstance(node, ast.Constant) and isinstance(node.value, str):
            if node is getattr(tree.body[0], "value", None):
                continue                      # the module's docstring
            assert not any(w in node.value.lower() for w in words), (name, node.value)
        if isinstance(node, (ast.Name, ast.Attribute)):
            ident = node.id if isinstance(node, ast.Name) else node.attr
            assert not any(w in ident.lower() for w in words), (name, ident)
