"""Run one cell of the port's benchmark once, on the card.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Loads, warms up, measures for --seconds, checks the served outputs against
the plain reference, and prints one JSON line last on standard output
(the compared numbers beside their limits last on standard error too).
Without a CUDA card, or with fewer cards than the cell asks for, it prints
no result and exits non-zero. Host thread pools are fixed before torch is
imported, and every build and kernel cache lives inside the checkout.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
THREADS = {"OMP_NUM_THREADS": "1", "MKL_NUM_THREADS": "1", "OPENBLAS_NUM_THREADS": "1"}
CACHES = {"TORCH_EXTENSIONS_DIR": "build/portbench/torch_extensions",
          "TRITON_CACHE_DIR": "build/portbench/triton",
          "CUDA_CACHE_PATH": "build/portbench/cuda_cache"}


def finite(x):
    """A number JSON can carry: NaN and the infinities as 1e308 (a failed
    comparison)."""
    if isinstance(x, float) and not math.isfinite(x):
        return 1e308
    if isinstance(x, dict):
        return {k: finite(v) for k, v in x.items()}
    if isinstance(x, list):
        return [finite(v) for v in x]
    return x


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    os.environ.update(THREADS)
    for k, v in CACHES.items():
        os.environ[k] = os.path.join(ROOT, v)
    sys.path.insert(0, ROOT)
    import torch

    torch.set_num_threads(int(THREADS["OMP_NUM_THREADS"]))
    torch.set_num_interop_threads(1)
    from portbench import harness

    print(f"threads intra-op {torch.get_num_threads()} inter-op "
          f"{torch.get_num_interop_threads()} " + " ".join(f"{k}={v}" for k, v in THREADS.items()),
          file=sys.stderr, flush=True)
    try:
        line = harness.run(args.workload, args.seed, args.seconds, bool(args.trace), T_START)
    except harness.Refused as e:
        print(f"refused: {e}", file=sys.stderr)
        return 2
    bad = harness.forbidden_modules()
    if bad:
        print(f"refused: the process loaded {', '.join(bad)}", file=sys.stderr)
        return 3
    if torch.cuda.is_available():
        import subprocess

        try:
            card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                                   "--format=csv,noheader"], capture_output=True, text=True,
                                  timeout=20).stdout.strip()
        except (OSError, subprocess.SubprocessError):
            card = "nvidia-smi unavailable"
        print(f"card {card}", file=sys.stderr)
    for name, n in line["checks"].items():
        print(f"check {name} {n['value']!r} limit {n['limit']!r}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(finite(line)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
