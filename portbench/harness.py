"""One run of one cell: set up, warm up, measure, check, print.

Everything a cell is made of is found by name: the cell in BENCHMARK.json
names its configuration (portbench/configs/<config>.json), whose "plugs"
name the model and the vocoder (portbench/plugs/<name>.py: weights,
kernels to build, capture, reference and comparison), and its traffic mix
(portbench/traffic/<mix>.json), whose "driver" names the loop that drives
it (portbench/drivers/<driver>.py) and gives the end-to-end metrics; each
per-layer metric the cell reports is read by
portbench/metrics/<metric>.py. This file names none of them.
"""

from __future__ import annotations

import bisect
import importlib.util
import json
import os
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
FORBIDDEN = ("jax", "jaxlib", "flax", "your_voice_tts_tpu")


class Refused(Exception):
    """The run cannot measure: it prints no result and exits non-zero."""


def load_module(path: str, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def cell_of(bench: dict, workload: str) -> dict:
    """The workload, its configuration and mix files, and the metrics it
    reports: an end-to-end or per-layer metric belongs to a cell that its
    `workloads` list names, or to every cell without that list."""
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise Refused(f"no workload {workload!r} in BENCHMARK.json")
    w = cells[workload]
    conf = json.load(open(os.path.join(HERE, "configs", w["config"] + ".json")))
    mix = json.load(open(os.path.join(HERE, "traffic", w["traffic"] + ".json")))
    mine = lambda ms: [m for m in ms if workload in m.get("workloads", [workload])]  # noqa: E731
    e2e = mine(bench["end_to_end"])
    layer = [m for m in mine(bench["per_layer"])
             if any(e["name"] == m["moves"] for e in e2e)]
    return {"workload": w, "conf": conf, "mix": mix, "end_to_end": e2e, "per_layer": layer}


def forbidden_modules() -> list[str]:
    """Loaded modules whose top-level name (before the first dot) is JAX's
    or the JAX package's, compared whole."""
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(FORBIDDEN))


def percentile(values: list[float], q: float) -> float:
    """The q-th percentile by linear interpolation between order
    statistics."""
    v = sorted(values)
    if not v:
        raise ValueError("no values")
    x = (len(v) - 1) * q / 100.0
    lo = int(x)
    hi = min(lo + 1, len(v) - 1)
    return v[lo] + (v[hi] - v[lo]) * (x - lo)


def run(workload: str, seed: int, seconds: float, trace: bool, t_start: float,
        device: str = "cuda", conf: dict | None = None, mix: dict | None = None) -> dict:
    """One run; returns the result line (a dict), the checked numbers last.
    A `device` other than CUDA, and a `conf` and `mix` in place of the
    cell's own (narrow, light ones), are for the CPU tests of the harness."""
    import torch

    from . import check
    from .system import System, plugs

    seed = int(seed) % 2 ** 63          # numpy's generators take no negative seed
    cell = cell_of(json.load(open(os.path.join(ROOT, "BENCHMARK.json"))), workload)
    w = cell["workload"]
    conf, mix = conf or cell["conf"], mix or cell["mix"]
    if device == "cuda":
        if not torch.cuda.is_available():
            raise Refused("CUDA is not available: this benchmark measures the card only")
        if torch.cuda.device_count() < w["chips"]:
            raise Refused(f"the cell needs {w['chips']} cards, "
                          f"{torch.cuda.device_count()} are visible")
    import your_voice_tts_torch  # noqa: F401
    from your_voice_tts_torch.ops import cuda_build

    from . import sentences

    phases = {"import": time.perf_counter() - t_start}
    t0 = time.perf_counter()
    driver = load_module(os.path.join(HERE, "drivers", mix["driver"] + ".py"),
                         "portbench_driver_" + mix["driver"])
    pool = sentences.pool(mix, seed)
    phases["traffic"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    if device == "cuda":
        torch.cuda.init()
        cuda_build.build_all(tuple(k for p in plugs(conf) for k in p.KERNELS))
    phases["build"] = time.perf_counter() - t0
    system = System(conf, seed, device, mix["sample"]["share"], spans=trace)
    phases["model"], phases["weights"] = system.build_s, system.weights_s
    t0 = time.perf_counter()
    driver.warm(system, pool, mix)
    if device == "cuda":
        torch.cuda.synchronize()
    phases["warm"] = time.perf_counter() - t0
    setup_s = time.perf_counter() - t_start
    print("setup " + " ".join(f"{k} {v:.3f} s" for k, v in phases.items())
          + f" total {setup_s:.3f} s", file=sys.stderr, flush=True)

    tracer = reading = None
    if trace:
        from .trace import Trace

        tracer = Trace()
        tracer.start()
    result = driver.measure(system, pool, mix, seconds)
    print(f"window {result['diagnostic']}", file=sys.stderr, flush=True)
    if tracer is not None:
        tracer.stop()
        reading = tracer.read(result["window"], system.spans)
    dev = device_info(device, w["chips"])
    metrics = {}
    if not trace:
        got = dict(result["end_to_end"], setup_s=setup_s)
        for m in cell["end_to_end"]:
            if m["name"] in got:
                metrics[m["name"]] = {"value": got[m["name"]], "unit": m["unit"]}
    else:
        dev.update(busy_s=reading["busy_s"], window_s=reading["window_s"])
        ctx = MetricContext(system, result, reading, conf, mix)
        for m in cell["per_layer"]:
            mod = load_module(os.path.join(HERE, "metrics", m["name"] + ".py"),
                              "portbench_metric_" + m["name"].replace(".", "_"))
            v = mod.read(ctx)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    numbers = check.check(system, result, conf, mix, seed, device)
    line = {
        "correct": bool(result["failed"] == 0 and all(n["value"] <= n["limit"]
                                                      for n in numbers.values())),
        "attempted": result["attempted"],
        "failed": result["failed"],
        "metrics": metrics,
        "device": dev,
    }
    if reading is not None:
        line["breakdown"] = {"device_ops": reading["device_ops"],
                             "idle_gaps": reading["idle_gaps"]}
    line["checks"] = numbers
    return line


def device_info(device: str, chips: int) -> dict:
    import torch

    if device != "cuda":
        return {"platform": "cpu", "kind": "cpu", "count": 1, "memory_peak_bytes": 0}
    peak = max(torch.cuda.max_memory_allocated(i) for i in range(chips))
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": chips,
            "memory_peak_bytes": int(peak)}


class MetricContext:
    """What a per-layer metric reads: the system's call log and spans, the
    driver's result, the trace reading, the configuration and the mix."""

    def __init__(self, system, result, reading, conf, mix):
        self.system, self.result, self.trace, self.conf, self.mix = \
            system, result, reading, conf, mix
        w0, w1 = result["window"]
        self.calls = [c for c in system.calls if w0 <= c["t"] <= w1]
        self.spans = {k: [s for s in v if w0 <= s[0] <= w1]
                      for k, v in (system.spans or {}).items()}

    def kernel_seconds(self, part: str) -> float:
        """Device seconds of the window's kernels whose name holds `part`."""
        return sum(s for n, s, _ in self.trace["kernels"] if part in n)

    def span_device_seconds(self, name: str) -> float:
        """Device seconds of the window's kernels that start inside a `name`
        span: on the serving paths a layer's call ends in a copy to the
        host, so its kernels run inside its span and no other's do."""
        spans = sorted(self.spans.get(name, []))
        starts = [a for a, _ in spans]
        total = 0.0
        for _, s, t in self.trace["kernels"]:
            i = bisect.bisect_right(starts, t) - 1
            if i >= 0 and t <= spans[i][1]:
                total += s
        return total
