"""The traced run's reading of torch.profiler: the card's kernels (CUPTI
sees every thread's launches) on the profiler's clock, tied to
perf_counter by a marker span, and the benchmark's own host spans (wall
intervals its wrappers record on whichever thread calls the layer; the
profiler's host events are those of the thread that started it only).

- busy: the union of the kernels' intervals in the window (kernels of one
  step may overlap, so their summed time would count some twice), the
  method of the device-busy reading the repository's chip script uses;
- device ops: device seconds by kernel name;
- idle gaps: each stretch of the window in which no kernel ran, cut at
  the host spans' edges, each piece named by the innermost span covering
  it, summed by name;
- kernels that start inside the window, whole, with their start on
  perf_counter, for the rooflines, whose counts take the calls that start
  inside the window.
"""

from __future__ import annotations

import heapq
import time
from collections import defaultdict

import torch


class Trace:
    def __init__(self):
        from torch.profiler import ProfilerActivity, profile

        self.prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])

    def start(self):
        """Start the profiler, then tie perf_counter to its clock: a marker
        span opened now (after one unmarked span, which pays the first
        span's cost)."""
        self.prof.start()
        with torch.profiler.record_function("pb:warm"):
            pass
        self._mark_pc = time.perf_counter()
        with torch.profiler.record_function("pb:mark"):
            pass

    def stop(self):
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        self.prof.stop()

    def read(self, window: tuple[float, float], spans: dict, top: int = 10) -> dict:
        """window (perf_counter seconds); spans: name -> [(start, end)] on
        perf_counter."""
        kernels, mark = [], None
        for name, device, t0, t1, annotation in _events(self.prof):
            if device:
                # the device rows of the benchmark's own spans are no kernels
                if not name.startswith("pb:") and not annotation:
                    kernels.append((t0, t1, name))
            elif name == "pb:mark":
                mark = t0
        if mark is None:
            raise RuntimeError("the trace holds no window mark")
        off = mark - self._mark_pc * 1e6          # profiler us = perf_counter us + off
        w0, w1 = window[0] * 1e6 + off, window[1] * 1e6 + off
        inside = [(max(a, w0), min(b, w1), n) for a, b, n in kernels if b > w0 and a < w1]
        by_name = defaultdict(float)
        for a, b, n in inside:
            by_name[n] += (b - a) / 1e6
        merged = []
        for a, b, _ in sorted(inside):
            if merged and a <= merged[-1][1]:
                merged[-1][1] = max(merged[-1][1], b)
            else:
                merged.append([a, b])
        busy = sum(b - a for a, b in merged) / 1e6
        gaps, edge = [], w0
        for a, b in merged:
            if a > edge:
                gaps.append((edge, a))
            edge = max(edge, b)
        if w1 > edge:
            gaps.append((edge, w1))
        host = [(a * 1e6 + off, b * 1e6 + off, "pb:" + n)
                for n, iv in spans.items() for a, b in iv]
        idle = defaultdict(float)
        for a, b, name in _split(gaps, host):
            idle[name] += (b - a) / 1e6
        order = lambda d: sorted(d.items(), key=lambda kv: -kv[1])[:top]  # noqa: E731
        return {
            "window_s": (w1 - w0) / 1e6,
            "busy_s": busy,
            "kernels": [(n, (b - a) / 1e6, (a - off) / 1e6) for a, b, n in kernels
                        if w0 <= a <= w1],
            "device_ops": [[n, s] for n, s in order(by_name)],
            "idle_gaps": [[n, s] for n, s in order(idle)],
        }


def _events(prof):
    """(name, on the device, start us, end us, a user annotation) of every
    event, from the profiler's raw results (no event tree is built)."""
    from torch.autograd import DeviceType

    for e in prof.profiler.kineto_results.events():
        if hasattr(e, "start_ns"):
            t0, dur = e.start_ns() / 1e3, e.duration_ns() / 1e3
        else:
            t0, dur = e.start_us(), e.duration_us()
        yield (e.name(), e.device_type() == DeviceType.CUDA, t0, t0 + dur,
               bool(getattr(e, "is_user_annotation", lambda: False)()))


def _split(gaps: list, host: list) -> list:
    """The ascending, disjoint gaps cut at every host span's edge: each piece
    (start, end, name) is named by the innermost (shortest) span covering
    it, or "host: outside the spans"."""
    edges = sorted({t for a, b, _ in host for t in (a, b)})
    starts = sorted(host)
    pieces, active, j, k = [], [], 0, 0
    for a, b in gaps:
        cuts = [a]
        while k < len(edges) and edges[k] <= a:
            k += 1
        m = k
        while m < len(edges) and edges[m] < b:
            cuts.append(edges[m])
            m += 1
        cuts.append(b)
        for lo, hi in zip(cuts, cuts[1:]):
            t = (lo + hi) / 2
            while j < len(starts) and starts[j][0] <= t:
                sa, sb, n = starts[j]
                heapq.heappush(active, (sb, sb - sa, n))
                j += 1
            while active and active[0][0] < t:
                heapq.heappop(active)
            name = min((d, n) for _, d, n in active)[1] if active else "host: outside the spans"
            pieces.append((lo, hi, name))
    return pieces
