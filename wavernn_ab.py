#!/usr/bin/env python3
"""Time the WaveRNN sample-loop kernel, a decode kernel (Tacotron2 or
Tacotron(1)) or a training scan (forward or backward), of one checkout of the port,
so that two checkouts can be compared on the same card in one run:

    python3 wavernn_ab.py --root OLD
    python3 wavernn_ab.py --root .
    python3 wavernn_ab.py --root OLD --mode decode [--probes] [--holds]
    python3 wavernn_ab.py --root OLD --mode taco1 [--probes] [--holds]

`--root` is the directory whose `your_voice_tts_torch` is imported (built
into its own build/cuda). The inputs are those of chip_smoke.py's wavernn
phase (its `wavernn_inputs`): full width (WaveRNNConfig defaults, seeded
random weights from WaveRNN(seed=3)), mu-law sampled, on the folds of
seeded N(0, 1) mels of 500 frames (22 folds) and 1400 frames (60 folds) x
6,600 steps. Prints one JSON line: kernel ms (median of `--reps`, 5 unless
given, after a warm-up, CUDA events) and us a step for each shape. `--probes` adds the
version's probe launches where it has them (`wavernn_probe_cuda`);
`--holds` adds the largest |kernel - plain| of MoL and Gaussian sampling
over 256 steps at both shapes for two input seeds.

`--mode decode` times `tacotron2_decode_cuda` instead, on the inputs of
chip_smoke.py's decode phase (its `decode_inputs`: full width, seeded
random weights, T=152, 250 steps, dropout on) at B=8 and B=1, median of
`--reps`; `--probes` adds the version's probe
launches in us a step and its per-round profile where it has them,
`--holds` the largest |kernel -
plain| of frames, alignments and stops and whether the lengths agree.
`--mode taco1` does the same for `tacotron1_decode_cuda` on the inputs of
the taco1-decode phase (`taco1_inputs`: the Tacotron(1) config at full
width, T=160, 250 steps, r = 7, dropout on); `--blocks N` launches it on
N blocks where the version takes a grid size.

    python3 wavernn_ab.py --root OLD --mode train_bwd [--holds]
    python3 wavernn_ab.py --root OLD --mode train_fwd [--probes] [--holds]

`--mode train_bwd` times the training backward scan `taco2_train_bwd_cuda`
on chip_smoke.py's train-bwd inputs (`core_inputs` at config #3's shape:
B=32, T_in=128, 200 steps, bf16, full width; the forward kernel's
residuals and seeded cotangents, `train_bwd_args`), median of `--reps`,
and each of its four launches' device time (torch.profiler,
`bwd_launch_times`, on the version's serial probe where it has one); `--holds` adds rel L2 against the plain version per
output; `--probes` times the version's probe launches where it has them
(`taco2_train_bwd_probe_cuda`: the scan with its attention backward
stopped after each phase).

`--mode train_fwd` does the same for the forward scan `taco2_train_fwd_cuda`
on chip_smoke.py's train-fwd inputs (`core_inputs`, the same shape): median
of `--reps`, the launches a call (its counter), and each launch's device
time (`fwd_launch_times`, on the version's serial probe where it has one);
`--probes` times the version's probe launches (`taco2_train_fwd_probe_cuda`:
the attention or the LSTM products stopped after each phase, serial);
`--holds` adds rel L2 and max abs error against the plain version per
output.

    python3 wavernn_ab.py --root OLD --mode train_step [--reps N]
    python3 wavernn_ab.py --root OLD --mode gl [--holds]
    python3 wavernn_ab.py --root NEW --mode gl_spread

`--mode train_step` times chip_smoke.py's timed train step (`Trainer` on
its config, `bench_batch`: config #3's shape, bf16 mixed precision,
dropout on): wall ms a step (median of `--reps` after two warm-up steps,
each ending in a host read of the metrics) and, from one more step under
torch.profiler, the device's busy ms (the union of its kernels' intervals:
dependent launches overlap, so their summed times would count the overlap
twice), the kernels' summed ms and the idle share of that step's wall.

`--mode gl` times the Griffin-Lim kernels on chip_smoke.py's inputs
(`gl_inputs`, `gl_iteration_inputs`): kernel 2 (`griffin_lim_wave_cuda`)
at the main path's shape `GL_WAVE` (B=8, T=500, n_fft 1024, hop 256, 24
iterations, momentum 0.95), kernel 3 (`griffin_lim_full_cuda`) at a 12.5
ms hop `GL_FULL` (n_fft 2048, hop 275, window 1102) and at the smoke
path's launch shape `GL_SMALL` (B=4, T=96, n_fft 256, hop 64, 15
iterations), and kernel 4 (`gl_iteration_cuda`) at B=8 and B=1, T=1,760
(the Tacotron(1) path's bucket): median of `--reps` (CUDA events), the
launches a call (the counter), and each launch's device time
(`gl_launch_times`, torch.profiler over one call: the version's serial
probe, `fgla_serial_cuda` / `gl_iteration_serial_cuda`, where it has
one), and a sha256 of kernels 2 and 3's output after 3 iterations (equal
between checkouts where their bits are); `--holds` adds rel L2 against the plain version after one
iteration; `--bn 128` or `--bn 256` plans kernel 4's products in tiles of
that many columns (where the version has `gl_iteration_plan`). It also times chip_smoke.py's
main path (`main_path_ab`, left out with `--no_main`): the batch of 8's
wall ms (median of `--reps`) and the batch-1 p50 of its 5 requests. `--mode
gl_spread` holds kernels 2 and 3 against their plain versions after 0-3
iterations at card-test shapes up to n_fft 4096, beside the plain loop's
own spread under a relative 1e-6 and 1e-4 nudge of its magnitudes: how far
the FGLA loop at momentum 0.95 carries f32 sum-order differences.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import os
import statistics
import sys

from chip_smoke import (BENCH_FRAMES, GL_FULL, GL_SMALL, GL_WAVE, SERVE_FRAMES, TACO1_R, TRAIN_B,
                        TRAIN_T_MEL, TRAIN_T_TEXT, bench_batch, bwd_launch_times, core_inputs,
                        decode_inputs, device_busy, fwd_launch_times, gl_inputs,
                        gl_iteration_inputs, gl_launch_times, taco1_inputs, train_bwd_args,
                        train_config, wavernn_inputs)


def timed(fn, reps: int):
    """(median ms, all ms) of fn() over `reps` runs, CUDA events, after one
    warm-up run."""
    import torch

    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times), times


def decode_ab(args, torch) -> dict:
    """The Tacotron2 decode kernel (--mode decode) or the Tacotron(1) one
    (--mode taco1) of the checkout at --root, at B=8 and B=1."""
    import importlib

    module, fn, inputs = {"decode": ("taco2_decode", "tacotron2", decode_inputs),
                          "taco1": ("taco1_decode", "tacotron1", taco1_inputs)}[args.mode]
    dec = importlib.import_module(f"your_voice_tts_torch.ops.{module}")
    run, plain = getattr(dec, f"{fn}_decode_cuda"), getattr(dec, f"{fn}_decode_plain")
    probe = getattr(dec, f"{fn}_decode_probe_cuda", None)
    profile = getattr(dec, f"{fn}_decode_profile_cuda", None)
    if args.blocks:
        dec._blocks = lambda dev: args.blocks
    reps = args.reps
    result = {"root": args.root, "device": torch.cuda.get_device_name(0), "mode": args.mode,
              "blocks": args.blocks or None}
    for B in (8, 1):
        w, enc, pinp, mask, kw = inputs(B)
        kw.setdefault("r", TACO1_R)
        steps = kw["max_steps"]
        before = run.launches
        got = run(w, enc, pinp, mask, **kw)
        res = result[f"B{B}"] = {"launches_a_decode": run.launches - before}
        ms, times = timed(lambda: run(w, enc, pinp, mask, **kw), reps)
        res.update(ms=ms, all_ms=times, us_per_step=ms * 1e3 / steps)
        if args.probes and probe is not None:
            for name in dec.PROBES:
                pms, _ = timed(lambda: probe(w, enc, pinp, mask, name, r=kw["r"],
                                             max_steps=steps), 3)
                res[name + "_us_per_step"] = pms * 1e3 / steps
            if profile is not None:
                res["rounds_us_per_step"] = profile(w, enc, pinp, mask, **kw)["rounds"]
        if args.holds:
            ref = plain(w, enc, pinp, mask, **kw)
            res["lengths_equal"] = bool(torch.equal(got[3].cpu(), ref[3].cpu()))
            for name, a, b in zip(("frames", "alignments", "stops"), got[:3], ref[:3]):
                res[name + "_max_abs_err"] = float((a - b).abs().max())
    return result


def train_bwd_ab(args, torch) -> dict:
    """The training backward scan of the checkout at --root at config #3's
    shape."""
    from your_voice_tts_torch.models import setup_model
    from your_voice_tts_torch.ops import taco2_train as tt
    from your_voice_tts_torch.text import symbols

    steps = TRAIN_T_MEL // 2
    model = setup_model(len(symbols), train_config(), device="cuda", seed=1)
    w, x = core_inputs(model, steps, TRAIN_B, TRAIN_T_TEXT, seed=11)
    fwd = tt.taco2_train_fwd_cuda(w, x["prenet_t"], x["enc"], x["pinp"], x["maskf"], x["m_a"],
                                  x["m_d"])
    a = train_bwd_args(w, x, fwd)
    run = lambda: tt.taco2_train_bwd_cuda(*a)  # noqa: E731
    ms, times = timed(run, args.reps)
    # each launch's device time alone: the serial probe where the version
    # has dependent launches
    probe = getattr(tt, "taco2_train_bwd_probe_cuda", None)
    serial = run if probe is None else lambda: probe(*a, probe="serial")  # noqa: E731
    result = {"root": args.root, "device": torch.cuda.get_device_name(0), "mode": args.mode,
              "B": TRAIN_B, "T_in": TRAIN_T_TEXT, "steps": steps, "ms": ms, "all_ms": times,
              "us_per_step": ms * 1e3 / steps, "launches": bwd_launch_times(serial)}
    if args.probes and probe is not None:
        result["probes_ms"] = {name: timed(lambda: probe(*a, probe=name), args.reps)[0]
                               for name in tt.BWD_PROBES}
    if args.holds:
        got, ref = run(), tt.taco2_train_bwd_plain(*a)
        result["rel_l2"] = {k: float((got[k].float() - ref[k].float()).norm()
                                     / ref[k].float().norm()) for k in ref}
    return result


def train_fwd_ab(args, torch) -> dict:
    """The training forward scan of the checkout at --root at config #3's
    shape."""
    from your_voice_tts_torch.models import setup_model
    from your_voice_tts_torch.ops import taco2_train as tt
    from your_voice_tts_torch.text import symbols

    steps = TRAIN_T_MEL // 2
    model = setup_model(len(symbols), train_config(), device="cuda", seed=1)
    w, x = core_inputs(model, steps, TRAIN_B, TRAIN_T_TEXT, seed=11)
    a = (w, x["prenet_t"], x["enc"], x["pinp"], x["maskf"], x["m_a"], x["m_d"])
    run = lambda: tt.taco2_train_fwd_cuda(*a)  # noqa: E731
    before = tt.taco2_train_fwd_cuda.launches
    run()
    launches = tt.taco2_train_fwd_cuda.launches - before
    ms, times = timed(run, args.reps)
    probe = getattr(tt, "taco2_train_fwd_probe_cuda", None)
    serial = run if probe is None else lambda: probe(*a, probe="serial")  # noqa: E731
    result = {"root": args.root, "device": torch.cuda.get_device_name(0), "mode": args.mode,
              "B": TRAIN_B, "T_in": TRAIN_T_TEXT, "steps": steps, "ms": ms, "all_ms": times,
              "us_per_step": ms * 1e3 / steps, "launches_a_call": launches,
              "launches": fwd_launch_times(serial)}
    if args.probes and probe is not None:
        result["probes_ms"] = {name: timed(lambda: probe(*a, probe=name), args.reps)[0]
                               for name in tt.FWD_PROBES}
    if args.holds:
        got, ref = run(), tt.taco2_train_fwd_plain(*a)
        result["rel_l2"] = {k: float((got[k].float() - ref[k].float()).norm()
                                     / ref[k].float().norm()) for k in ref}
        result["max_abs_err"] = {k: float((got[k].float() - ref[k].float()).abs().max())
                                 for k in ref}
    return result


def train_step_ab(args, torch) -> dict:
    """chip_smoke.py's timed train step on the checkout at --root."""
    import dataclasses
    import tempfile
    import time

    from torch.profiler import ProfilerActivity, profile

    from your_voice_tts_torch.data.synthetic import make_synthetic_corpus
    from your_voice_tts_torch.train.trainer import Trainer

    with tempfile.TemporaryDirectory() as tmp:
        cfg = train_config()
        corpus = make_synthetic_corpus(os.path.join(tmp, "corpus"), n_items=64, sr=22050,
                                       max_words=15)
        ds = dataclasses.replace(cfg.data.datasets[0], name="synthetic", path=corpus)
        cfg = dataclasses.replace(cfg, data=dataclasses.replace(cfg.data, datasets=(ds,)))
        trainer = Trainer(cfg, output_path=os.path.join(tmp, "run"), device="cuda")
        batch = bench_batch()
        for _ in range(2):
            trainer.train_step(batch, 2)
        torch.cuda.synchronize()
        times = []
        for _ in range(args.reps):
            t0 = time.perf_counter()
            trainer.train_step(batch, 2)            # ends in a host read of the metrics
            times.append((time.perf_counter() - t0) * 1e3)
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            trainer.train_step(batch, 2)
            torch.cuda.synchronize()
            wall = (time.perf_counter() - t0) * 1e3
        trace = os.path.join(tmp, "trace.json")
        prof.export_chrome_trace(trace)
        busy, summed, n = device_busy(trace)
    return {"root": args.root, "device": torch.cuda.get_device_name(0), "mode": args.mode,
            "B": TRAIN_B, "T_in": TRAIN_T_TEXT, "T_mel": TRAIN_T_MEL,
            "train_step_ms": statistics.median(times), "all_ms": times,
            "profiled_wall_ms": wall, "device_busy_ms": busy, "kernels_summed_ms": summed,
            "kernels": n, "idle_share": 1 - busy / wall}


def gl_ab(args, torch) -> dict:
    """Kernels 2, 3 and 4 of the checkout at --root at chip_smoke.py's
    shapes (kernel 4 at B=8 and B=1), then the serving main path."""
    from your_voice_tts_torch.ops import griffin_lim as gl

    result = {"root": args.root, "device": torch.cuda.get_device_name(0), "mode": args.mode}
    serial = getattr(gl, "fgla_serial_cuda", None)
    for name, route, case in (("wave", "wave", GL_WAVE), ("full_12ms_hop", "full", GL_FULL),
                              ("full_small", "full", GL_SMALL)):
        mag, phase, consts, _, _ = gl_inputs(**case)
        fn = getattr(gl, f"griffin_lim_{route}_cuda")
        run = lambda fn=fn, n=case["iters"]: fn(mag, phase, consts, n_iters=n,  # noqa: E731
                                                 momentum=case["mom"])
        launches = fn.launches
        run()
        res = result[name] = {k: case[k] for k in ("B", "T", "n_fft", "hop", "iters")}
        res["launches_a_call"] = fn.launches - launches
        res["ms"], res["all_ms"] = timed(run, args.reps)
        probe = run if serial is None else lambda: serial(  # noqa: E731
            mag, phase, consts, n_iters=case["iters"], momentum=case["mom"], route=route)
        res["launch_us"] = gl_launch_times(probe)
        # the output's bits after 3 iterations, to compare checkouts
        res["sha256_3iter"] = hashlib.sha256(
            fn(mag, phase, consts, n_iters=3, momentum=case["mom"]).cpu().numpy().tobytes()
        ).hexdigest()
        if args.holds:
            plain = getattr(gl, f"griffin_lim_{route}_plain")
            got = fn(mag, phase, consts, n_iters=1, momentum=case["mom"])
            ref = plain(mag, phase, consts, n_iters=1, momentum=case["mom"])
            res["rel_l2_1iter"] = float((got - ref).abs().norm() / ref.abs().norm())
    mags, phase, consts, _, _, iters = gl_iteration_inputs()
    if args.bn and hasattr(gl, "gl_iteration_plan"):   # kernel 4 in tiles of bn columns
        plan = gl.gl_iteration_plan
        gl.gl_iteration_plan = lambda n_fft, hop, M, *sms: {
            **plan(n_fft, hop, M, *sms), **gl.product_plan(n_fft, M, args.bn)}
    serial = getattr(gl, "gl_iteration_serial_cuda", None)
    for B in (8, 1):
        mag = mags[:B]
        start = (mag * torch.cos(phase), mag * torch.sin(phase))
        run = lambda m=mag, s=start, fn=gl.gl_iteration_cuda: fn(  # noqa: E731
            *s, m, consts, n_iters=iters)
        res = result[f"iteration_B{B}"] = {"B": B, "T": mags.shape[1], "iters": iters,
                                           "bn": args.bn or None}
        launches = gl.gl_iteration_cuda.launches
        run()
        res["launches_a_call"] = gl.gl_iteration_cuda.launches - launches
        res["ms"], res["all_ms"] = timed(run, args.reps)
        probe = run if serial is None else lambda m=mag, s=start: serial(  # noqa: E731
            *s, m, consts, n_iters=iters)
        res["launch_us"] = gl_launch_times(probe)
        if args.holds:
            got = gl.gl_iteration_cuda(*start, mag, consts, n_iters=1)
            ref = gl.gl_iteration_plain(*start, mag, consts, n_iters=1)
            res["rel_l2_1iter"] = float(torch.cat([got[0] - ref[0], got[1] - ref[1]]).norm()
                                        / torch.cat(ref).norm())
    if not args.no_main:
        result["main"] = main_path_ab(torch, args.reps)
    return result


# kernels 2 and 3 at card-test shapes past n_fft 2048 (the first read rel
# L2 1.0046e-2 after three iterations against the tests' 1e-2) and at n_fft
# 1024 for comparison: (route, n_fft, hop, B, T, a phase per row)
GL_SPREAD_CASES = [("wave", 4096, 1024, 2, 9, True), ("wave", 4096, 1024, 4, 40, True),
                   ("full", 4096, 1024, 1, 5, False), ("wave", 2176, 545, 2, 9, False),
                   ("wave", 1024, 256, 2, 20, False)]


def gl_spread(args, torch) -> dict:
    """Kernels 2 and 3 of the checkout at --root against their plain versions
    after 0-3 FGLA iterations at momentum 0.95 (tests/test_torch_cuda.py's
    seeded inputs), beside the plain loop's own spread: the plain version
    from magnitudes nudged by a relative 1e-6 and 1e-4 (seeded). Rel L2
    each."""
    import numpy as np

    from your_voice_tts_torch.ops import griffin_lim as gl
    from your_voice_tts_torch.ops.filters import hann_window

    rel = lambda a, b: float((a - b).abs().norm() / b.abs().norm())  # noqa: E731
    result = {"root": args.root, "device": torch.cuda.get_device_name(0), "mode": args.mode,
              "cases": []}
    for route, n_fft, hop, B, T, per_row in GL_SPREAD_CASES:
        g = torch.Generator().manual_seed(0)
        mag = (torch.randn(B, T, n_fft // 2 + 1, generator=g).abs() + 0.1).cuda()
        shape = (B, T, n_fft // 2 + 1) if per_row else (T, n_fft // 2 + 1)
        phase = (torch.rand(shape, generator=g) * 2 * np.pi).cuda()
        consts = gl.packed_constants(n_fft, hop, hann_window(n_fft, n_fft), torch.bfloat16,
                                     "cuda")
        kernel, plain = (getattr(gl, f"griffin_lim_{route}_{k}") for k in ("cuda", "plain"))
        nudged = {e: mag * (1 + e * torch.randn(mag.shape, generator=g).cuda())
                  for e in (1e-6, 1e-4)}
        case = {"route": route, "n_fft": n_fft, "hop": hop, "B": B, "T": T, "per_row": per_row}
        for n in range(4):
            def run(fn, m, n=n):
                return fn(m, phase, consts, n_iters=n, momentum=0.95)

            ref = run(plain, mag)
            case[f"iters_{n}"] = {"kernel": rel(run(kernel, mag), ref),
                                  **{f"nudged_{e:g}": rel(run(plain, m), ref)
                                     for e, m in nudged.items()}}
        result["cases"].append(case)
    return result


def main_path_ab(torch, reps: int) -> dict:
    """chip_smoke.py's main path (`Synthesizer.tts_many` at full width,
    Griffin-Lim on the wave route): the batch of 8's wall ms (median of
    `reps`) and the batch-1 p50 over its 5 requests."""
    import time

    from chip_smoke import SENTENCES, full_width_config, no_chance_stops
    from your_voice_tts_torch.infer.synthesizer import Synthesizer

    synth = Synthesizer(full_width_config(), device="cuda")
    no_chance_stops(synth.model)
    synth.tts_many(SENTENCES[:1])
    torch.cuda.synchronize()

    def wall(texts):
        t0 = time.perf_counter()
        synth.tts_many(texts)                      # returns host arrays: ends synchronized
        return (time.perf_counter() - t0) * 1e3

    batch = [wall(SENTENCES) for _ in range(reps)]
    lat = [wall([s]) for s in SENTENCES[:5]]
    return {"batch_ms": statistics.median(batch), "all_batch_ms": batch,
            "p50_batch1_ms": statistics.median(lat), "batch1_ms": lat}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", required=True)
    ap.add_argument("--mode", choices=("wavernn", "decode", "taco1", "train_bwd", "train_fwd",
                                       "train_step", "gl", "gl_spread"), default="wavernn")
    ap.add_argument("--blocks", type=int, default=0,
                    help="--mode taco1: blocks a launch where the version has `_blocks`")
    ap.add_argument("--reps", type=int, default=5, help="timed runs (their median)")
    ap.add_argument("--probes", action="store_true")
    ap.add_argument("--holds", action="store_true")
    ap.add_argument("--bn", type=int, default=0,
                    help="--mode gl: kernel 4's product tile width where the version plans it")
    ap.add_argument("--no_main", action="store_true",
                    help="--mode gl: leave out the serving main path")
    args = ap.parse_args()
    root = os.path.abspath(args.root)
    sys.path.insert(0, root)
    import torch

    if not torch.cuda.is_available():
        print("wavernn_ab: no CUDA device", file=sys.stderr)
        return 2
    import your_voice_tts_torch

    assert os.path.dirname(os.path.dirname(your_voice_tts_torch.__file__)) == root
    if args.mode in ("decode", "taco1"):
        print(json.dumps(decode_ab(args, torch)))
        return 0
    if args.mode in ("gl", "gl_spread"):
        print(json.dumps((gl_ab if args.mode == "gl" else gl_spread)(args, torch)))
        return 0
    if args.mode.startswith("train"):
        ab = {"train_bwd": train_bwd_ab, "train_fwd": train_fwd_ab,
              "train_step": train_step_ab}[args.mode]
        print(json.dumps(ab(args, torch)))
        return 0
    from your_voice_tts_torch.ops import wavernn_gen as gen
    from your_voice_tts_torch.vocoder.config import WaveRNNConfig
    from your_voice_tts_torch.vocoder.models.wavernn import WaveRNN

    c = WaveRNNConfig()
    model = WaveRNN(device="cuda", seed=3)
    w = gen.generation_weights(model)
    extra = {"packed": model.packed_weights(w)} if hasattr(model, "packed_weights") else {}
    result = {"root": args.root, "device": torch.cuda.get_device_name(0)}
    for frames, seed in ((SERVE_FRAMES, 4), (BENCH_FRAMES, 8)):
        cond, aux = wavernn_inputs(model, frames, seed)
        B, L = cond.shape[:2]
        ms, times = timed(lambda: gen.wavernn_generate_cuda(w, cond, aux, 7, bits=c.bits,
                                                            **extra), args.reps)
        res = result[f"folds_{B}"] = {"ms": ms, "all_ms": times, "us_per_step": ms * 1e3 / L}
        if args.probes and hasattr(gen, "wavernn_probe_cuda"):
            for probe in gen.PROBES:
                pms, _ = timed(lambda: gen.wavernn_probe_cuda(w, cond, aux, probe, bits=c.bits,
                                                              **extra), 1)
                res[probe + "_us_per_step"] = pms * 1e3 / L
        if args.holds:
            for mode in ("mol", "gauss"):
                m = WaveRNN(mode=mode, device="cuda", seed=5)
                wm = gen.generation_weights(m)
                for in_seed in (6, 16):
                    cm, am = wavernn_inputs(m, frames, in_seed)
                    cm, am = cm[:, :256].contiguous(), am[:, :256].contiguous()
                    err = (gen.wavernn_generate_cuda(wm, cm, am, 7, bits=c.bits, mode=mode)
                           - gen.wavernn_generate_plain(wm, cm, am, 7, bits=c.bits, mode=mode))
                    res[f"{mode}_seed{in_seed}_max_abs_err"] = float(err.abs().max())
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
