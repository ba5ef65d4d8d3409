"""The system under test: the port's serving facade (`Synthesizer`) built
from a configuration file, given the benchmark's seeded weights, and
watched from outside.

What belongs to one model or one vocoder (its weights, its vocoder
configuration, the wrappers that capture its layers' outputs) comes from
the plugs that the configuration names (portbench/plugs/<name>.py); this
file names none.

Two kinds of wrapper sit around the calls into the program's layers; they
replace attributes of the built objects (and the facade module's
`synthesis_batch`), never the program's files.
- Capture, in every run: what the correctness check needs of a few
  sampled rows (here the text, the served mel and the trimmed waveform;
  the plugs add their layers' outputs), and each synthesis call's start
  and shapes (rows, padded text length, frames a row), from which the
  rooflines count operations and bytes.
- Spans, in the traced run only: a `record_function` and a wall-clock
  interval at each layer boundary, and the per-call counts the per-layer
  metrics read.
"""

from __future__ import annotations

import os
import threading
import time
import zlib

import torch

from .harness import load_module
from .weights import draw, subseed

HERE = os.path.dirname(os.path.abspath(__file__))
_PLUGS: dict = {}


def plugs(conf: dict):
    """The configuration's model plug and vocoder plug
    (portbench/plugs/<name>.py, named under conf["plugs"])."""
    for kind in ("model", "vocoder"):
        name = conf["plugs"][kind]
        if name not in _PLUGS:
            _PLUGS[name] = load_module(os.path.join(HERE, "plugs", name + ".py"),
                                       "portbench_plug_" + name)
    return _PLUGS[conf["plugs"]["model"]], _PLUGS[conf["plugs"]["vocoder"]]


class Capture:
    """Rows kept for the check: a row whose text the sample marks, or the
    longest text served since `reset`; per call, the shapes."""

    def __init__(self, seed: int, share: float):
        self.seed, self.share = seed, share
        self.rows: dict[str, dict] = {}
        self.longest = 0
        self.local = threading.local()

    def reset(self):
        """Start of the window: the longest text from here on."""
        self.longest = 0

    def marked(self, text: str) -> bool:
        return zlib.crc32(f"{self.seed}:{text}".encode()) < self.share * 2 ** 32

    def rows_of(self, texts: list[str]) -> list[int]:
        keep = []
        for i, t in enumerate(texts):
            if len(t) > self.longest:
                self.longest = len(t)
                keep.append(i)
            elif self.marked(t):
                keep.append(i)
        return keep


class System:
    """The port's `Synthesizer` at a configuration, on `device`, with weights
    drawn from `seed`. `spans` turns on the traced run's wrappers."""

    def __init__(self, conf: dict, seed: int, device, share: float, spans: bool = False):
        from your_voice_tts_torch.config import config_from_dict
        from your_voice_tts_torch.infer import synthesizer as synth_mod
        from your_voice_tts_torch.infer.server import _batch_fn

        self.conf, self.seed, self.device = conf, seed, torch.device(device)
        self.plugs = self.model_plug, self.vocoder_plug = plugs(conf)
        self.gl_seed = subseed(seed, "vocoder") % (2 ** 31)
        cfg = config_from_dict(conf["tts"])
        voc_cfg = self.vocoder_plug.vocoder_config(conf, cfg)
        t0 = time.perf_counter()
        self.synth = synth_mod.Synthesizer(cfg, vocoder_config=voc_cfg, rng_seed=self.gl_seed,
                                           device=self.device)
        self.build_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        self.synth.model.load_state_dict(draw(self.model_plug.weight_spec(conf),
                                              subseed(seed, "tts"), self.device))
        if self.vocoder_plug.weight_spec is not None:
            self.synth.vocoder.model.load_state_dict(
                draw(self.vocoder_plug.weight_spec(conf), subseed(seed, "vocoder"), self.device))
        if self.device.type == "cuda":
            torch.cuda.synchronize()
        self.weights_s = time.perf_counter() - t0
        self.sample_rate = self.synth.ap.sample_rate
        self.capture = Capture(seed, share)
        self.spans: dict[str, list] | None = {} if spans else None
        self.calls: list[dict] = []    # a synthesis call: t, rows, padded, frames a row
        self._install(synth_mod)
        self.batch_fn = self.timed("batch_fn", _batch_fn(self.synth))

    # ----------------------------------------------------------- wrappers

    def timed(self, name, fn):
        """fn with a span (record_function + wall interval) in the traced run."""
        if self.spans is None:
            return fn
        label = "pb:" + name
        out = self.spans.setdefault(name, [])

        def wrapped(*a, **kw):
            t0 = time.perf_counter()
            with torch.profiler.record_function(label):
                res = fn(*a, **kw)
            out.append((t0, time.perf_counter()))
            return res
        return wrapped

    def _install(self, synth_mod):
        """The facade's and the host's own wrappers, then the plugs'."""
        synth, cap = self.synth, self.capture
        orig_batch = synth_mod.synthesis_batch
        keep_result = self.model_plug.keep_result

        def synthesis_batch(model_, texts, *a, **kw):
            cap.local.texts = texts
            cap.local.keep = cap.rows_of(texts)
            cap.local.scratch = {}
            call = cap.local.call = {"t": time.perf_counter(), "rows": len(texts)}
            res = orig_batch(model_, texts, *a, **kw)
            call["frames"] = [r["mel_postnet_spec"].shape[1] for r in res]
            self.calls.append(call)
            for i in cap.local.keep:
                row = cap.rows.setdefault(texts[i], {})
                row.update(text=texts[i], postnet=res[i]["mel_postnet_spec"], trimmed=res[i]["wav"])
                keep_result(row, res[i])
            return res

        synth_mod.synthesis_batch = self.timed("synthesis_batch", synthesis_batch)
        synth.ap.find_endpoint = self.timed("find_endpoint", synth.ap.find_endpoint)
        synth.tts_many = self.timed("tts_many", synth.tts_many)
        self.model_plug.install(self)
        self.vocoder_plug.install(self)

    def window_start(self):
        """Counts and spans from here on belong to the window."""
        self.capture.reset()
        self.calls.clear()
        if self.spans is not None:
            for v in self.spans.values():
                v.clear()

    def audio_seconds(self, wav_bytes: bytes) -> float:
        """Seconds of 16-bit mono audio in a WAV container's bytes."""
        return (len(wav_bytes) - 44) / 2.0 / self.sample_rate

    def close(self):
        """Free the program's state on the device."""
        self.synth = None
        if self.device.type == "cuda":
            torch.cuda.empty_cache()
