"""The readings that the limits of `correct` are set from, on the card at a
cell's own size: for each seed, a short window of the cell's own traffic,
then the program's compared numbers and the control's on the same sample.

The control is the plain reference put in the program's place at the
precision below the configuration's (each plug's CONTROL): fp8 products
where the configuration serves bf16 ones (the decode, Griffin-Lim), TF32
where it states float32 with TF32 off (encoder, postnet, MelGAN).

    python3 portbench/control.py --workload <cell> --seeds 1,2,3 --seconds 3

One JSON line a seed: {"seed", "program": {...}, "control": {...}}. The
benchmark's own runs never run this.
"""

import argparse
import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def readings(workload: str, seed: int, seconds: float, device: str = "cuda",
             conf: dict | None = None, mix: dict | None = None) -> dict:
    """One seed: the cell's traffic for `seconds`, then both sets of numbers
    on the same sample."""
    import torch

    from portbench import check, harness, sentences
    from portbench.system import System

    cell = harness.cell_of(json.load(open(os.path.join(ROOT, "BENCHMARK.json"))), workload)
    conf, mix = conf or cell["conf"], mix or cell["mix"]
    driver = harness.load_module(os.path.join(ROOT, "portbench", "drivers",
                                              mix["driver"] + ".py"), "pb_driver")
    pool = sentences.pool(mix, seed)
    system = System(conf, seed, device, mix["sample"]["share"])
    driver.warm(system, pool, mix)
    result = driver.measure(system, pool, mix, seconds)
    rows = check.sample(system, result, seed, mix["sample"]["rows"])
    system.vocoder_plug.prepare(system, rows, conf, device)
    system.close()
    with torch.no_grad():
        ref = check.reference(rows, conf, seed, device)
        program = check.numbers(rows, conf, ref, None, device)
        served = check.reference(rows, conf, seed, device, modes=check.control_modes(conf))
        control = check.numbers(rows, conf, ref, served, device)
    return {"seed": seed, "rows": len(rows), "program": program, "control": control}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True, help="comma-separated")
    p.add_argument("--seconds", type=float, default=3.0)
    args = p.parse_args(argv)
    sys.path.insert(0, ROOT)
    from portbench.run import CACHES, THREADS

    os.environ.update(THREADS)
    for k, v in CACHES.items():
        os.environ[k] = os.path.join(ROOT, v)
    import torch

    torch.set_num_threads(int(THREADS["OMP_NUM_THREADS"]))

    if not torch.cuda.is_available():
        print("refused: CUDA is not available", file=sys.stderr)
        return 2
    for s in args.seeds.split(","):
        print(json.dumps(readings(args.workload, int(s), args.seconds)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
