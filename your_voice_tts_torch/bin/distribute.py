"""Data-parallel training launcher (the JAX package's bin/distribute.py).

The JAX package drives every local device from one process and needs its
launcher only across hosts. PyTorch trains one process a device, so this
launcher starts one rank for each local device, joins them into one
process group across every host, and hands each rank off to the training
CLI (bin/train.py), whose Trainer then trains data-parallel
(train/trainer.py; parallel/mesh.py):

    python -m your_voice_tts_torch.bin.distribute --config_path config.json \\
        [--coordinator_address host:port --num_processes N --process_id K] \\
        [--restore_path ckpt.npz] [--max_steps N] [--device cpu] \\
        [--rendezvous_timeout S] [bin/train.py's flags]

Each host runs the same command. With L local devices (the host's CUDA
devices; one CPU rank with --device cpu), the world is N x L ranks and
local rank l of host K is rank K x L + l. Rank r binds cuda:l and joins
over NCCL; with --device cpu the ranks join over gloo. The group meets
at --coordinator_address (host 0's host:port); on one host without it,
at a free local port. Under torchrun (its RANK, WORLD_SIZE and
LOCAL_RANK in the environment) this process is one rank and joins the
group torchrun describes. A rendezvous or backend that fails raises
(after --rendezvous_timeout seconds); the launcher never trains as one
process instead. Flags this launcher does not know go to bin/train.py.
Without --device and without CUDA it raises.
"""

from __future__ import annotations

import argparse
import os
import socket


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _rank_main(local_rank: int, args, rest: list, init_method: str, n_local: int,
               world: int) -> None:
    """One rank: join the group, say so, hand off to bin/train.py."""
    import torch
    import torch.distributed as dist

    from ..parallel import mesh

    rank = args.process_id * n_local + local_rank
    device = (torch.device("cpu") if args.device == "cpu"
              else torch.device("cuda", local_rank))
    mesh.init_process_group(device, init_method, world, rank, args.rendezvous_timeout)
    try:
        print(f" > process {rank}/{world} up, {n_local} local / {world} global "
              f"devices ({dist.get_backend()})", flush=True)
        _hand_off(args, rest, str(device))
    finally:
        dist.destroy_process_group()


def _hand_off(args, rest: list, device: str) -> None:
    from .train import main as train_main

    train_argv = ["--config_path", args.config_path]
    if args.restore_path:
        train_argv += ["--restore_path", args.restore_path]
    if args.max_steps:
        train_argv += ["--max_steps", str(args.max_steps)]
    train_main(train_argv + rest + ["--device", device])


def main(argv: list[str] | None = None) -> None:
    p = argparse.ArgumentParser(description="Data-parallel training launcher")
    p.add_argument("--config_path", required=True)
    p.add_argument("--coordinator_address", default=None,
                   help="host:port of host 0, where every rank meets")
    p.add_argument("--num_processes", type=int, default=None,
                   help="hosts taking part (each runs this command), 1 by default")
    p.add_argument("--process_id", type=int, default=None, help="this host's index")
    p.add_argument("--restore_path", default=None)
    p.add_argument("--max_steps", type=int, default=None)
    p.add_argument("--device", default=None,
                   help="'cpu' for gloo ranks on the CPU (default: one rank a CUDA device, "
                        "NCCL)")
    p.add_argument("--rendezvous_timeout", type=float, default=300.0,
                   help="seconds to wait for every rank before raising")
    args, rest = p.parse_known_args(argv)

    import torch

    from ..parallel import mesh

    if args.device not in (None, "cpu", "cuda"):
        raise ValueError(f"--device takes 'cpu' or 'cuda', not {args.device!r}: each rank "
                         "binds its own local CUDA device")
    if args.device != "cpu" and not torch.cuda.is_available():
        raise RuntimeError("CUDA is not available; pass --device cpu to train gloo ranks on "
                           "the CPU")
    if "RANK" in os.environ and "WORLD_SIZE" in os.environ:
        mesh.init_from_env("cpu" if args.device == "cpu" else None)
        import torch.distributed as dist

        try:
            print(f" > process {dist.get_rank()}/{dist.get_world_size()} up (torchrun, "
                  f"{dist.get_backend()})", flush=True)
            _hand_off(args, rest, "cpu" if args.device == "cpu"
                      else f"cuda:{torch.cuda.current_device()}")
        finally:
            dist.destroy_process_group()
        return
    n_local = 1 if args.device == "cpu" else torch.cuda.device_count()
    n_hosts = args.num_processes or 1
    args.process_id = args.process_id or 0
    if not 0 <= args.process_id < n_hosts:
        raise ValueError(f"--process_id {args.process_id} outside [0, {n_hosts})")
    if args.coordinator_address is None:
        if n_hosts > 1:
            raise ValueError("--num_processes > 1 needs --coordinator_address host:port")
        address = f"localhost:{_free_port()}"
    else:
        address = args.coordinator_address
    world = n_hosts * n_local
    init_method = f"tcp://{address}"
    if n_local == 1:
        _rank_main(0, args, rest, init_method, n_local, world)
        return
    import torch.multiprocessing as mp

    mp.start_processes(_rank_main, args=(args, rest, init_method, n_local, world),
                       nprocs=n_local, start_method="spawn")


if __name__ == "__main__":
    main()
