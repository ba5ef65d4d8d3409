"""Build the port's CUDA sources (csrc/*.cu) with nvcc and load them with
ctypes.

Each source compiles on first use into its own shared library with a plain
C interface (no PyTorch headers, so a build takes seconds), for sm_90a, into
``build/cuda/`` beside the package; the file name carries a hash of the
sources, so an edited source rebuilds and an unchanged one is reused.
`build_all` starts one nvcc per source at once. Nothing here runs at import.
"""

from __future__ import annotations

import contextlib
import ctypes
import hashlib
import os
import shutil
import subprocess
import time

CSRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "csrc")
BUILD_DIR = os.path.join(os.path.dirname(os.path.dirname(CSRC)), "build", "cuda")
SOURCES = ("taco2_decode", "griffin_lim", "taco2_train", "wavernn_gen", "taco1_decode")
ARCH = "arch=compute_90a,code=sm_90a"

_loaded: dict[str, ctypes.CDLL] = {}
build_logs: dict[str, str] = {}


def _nvcc() -> str:
    found = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(found):
        raise RuntimeError("nvcc not found: the CUDA kernels build only on a "
                           "machine with the CUDA toolkit")
    return found


def _target(name: str) -> str:
    h = hashlib.sha256()
    for fn in sorted(os.listdir(CSRC)):
        if fn == f"{name}.cu" or fn.endswith(".cuh"):
            with open(os.path.join(CSRC, fn), "rb") as f:
                h.update(fn.encode() + f.read())
    h.update(ARCH.encode())
    return os.path.join(BUILD_DIR, f"lib{name}-{h.hexdigest()[:16]}.so")


def _start(name: str):
    out = _target(name)
    tmp = f"{out}.{os.getpid()}.tmp"
    cmd = [_nvcc(), "-gencode", ARCH, "-std=c++17", "-O3", "-shared",
           "-Xcompiler", "-fPIC", "-Xptxas", "-v", "-I", CSRC,
           "-o", tmp, os.path.join(CSRC, f"{name}.cu")]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                            text=True)
    return proc, tmp, out


def build_all(names=SOURCES) -> dict[str, float]:
    """Compile every source not yet built, one nvcc each, all started
    together. Returns the seconds each build took (0 for a cached one);
    the compiler's output (register and shared-memory use) is kept in
    `build_logs`. Raises if any build fails."""
    os.makedirs(BUILD_DIR, exist_ok=True)
    t0 = time.perf_counter()
    jobs = {n: _start(n) for n in names if not os.path.exists(_target(n))}
    seconds = {n: 0.0 for n in names}
    failed = []
    for name, (proc, tmp, out) in jobs.items():
        log, _ = proc.communicate()
        build_logs[name] = log
        seconds[name] = time.perf_counter() - t0
        if proc.returncode != 0:
            failed.append(f"{name}:\n{log}")
            continue
        os.replace(tmp, out)
    if failed:
        raise RuntimeError("nvcc failed for " + "\n".join(failed))
    return seconds


def load(name: str) -> ctypes.CDLL:
    """The loaded library for csrc/<name>.cu, built first if needed."""
    lib = _loaded.get(name)
    if lib is None:
        if not os.path.exists(_target(name)):
            build_all((name,))
        lib = ctypes.CDLL(_target(name))
        _loaded[name] = lib
    return lib


@contextlib.contextmanager
def on_device(dev):
    """`dev` made the current CUDA device for a launch, yielding the handle
    of its current stream. A launcher here runs on the current device (and
    reads its SM count there); called from a thread or a caller whose
    current device is another card, it would launch there with pointers
    into `dev`'s memory."""
    import torch

    with torch.cuda.device(dev):
        yield torch.cuda.current_stream(dev).cuda_stream


def check(err: int, what: str) -> None:
    """Raise on a nonzero cudaError_t returned by a launcher."""
    if err != 0:
        raise RuntimeError(f"CUDA error {err} launching {what}")
