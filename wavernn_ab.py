#!/usr/bin/env python3
"""Time the WaveRNN sample-loop kernel of one checkout of the port, so that
two checkouts can be compared on the same card in one run:

    python3 wavernn_ab.py --root OLD
    python3 wavernn_ab.py --root .

`--root` is the directory whose `your_voice_tts_torch` is imported (built
into its own build/cuda). The inputs are those of chip_smoke.py's wavernn
phase (its `wavernn_inputs`): full width (WaveRNNConfig defaults, seeded
random weights from WaveRNN(seed=3)), mu-law sampled, on the folds of
seeded N(0, 1) mels of 500 frames (22 folds) and 1400 frames (60 folds) x
6,600 steps. Prints one JSON line: kernel ms (median of `--reps` after a
warm-up, CUDA events) and us a step for each shape. `--probes` adds the
version's probe launches where it has them (`wavernn_probe_cuda`);
`--holds` adds the largest |kernel - plain| of MoL and Gaussian sampling
over 256 steps at both shapes for two input seeds.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import sys

from chip_smoke import BENCH_FRAMES, SERVE_FRAMES, wavernn_inputs


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


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", required=True)
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--probes", action="store_true")
    ap.add_argument("--holds", action="store_true")
    args = ap.parse_args()
    root = os.path.abspath(args.root)
    sys.path.insert(0, root)
    import torch

    if not torch.cuda.is_available():
        print("wavernn_ab: no CUDA device", file=sys.stderr)
        return 2
    import your_voice_tts_torch
    from your_voice_tts_torch.ops import wavernn_gen as gen
    from your_voice_tts_torch.vocoder.config import WaveRNNConfig
    from your_voice_tts_torch.vocoder.models.wavernn import WaveRNN

    assert os.path.dirname(os.path.dirname(your_voice_tts_torch.__file__)) == root
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
