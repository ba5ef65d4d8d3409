"""Data parallelism (the JAX package's parallel/mesh.py) on torch.distributed.

The JAX package runs single-process SPMD over a 1-axis mesh: the batch is
sharded over the "data" axis, parameters are replicated, and XLA inserts
the gradient all-reduce into the jitted step. PyTorch's idiom splits that
in two:

- serving is one process with a device list (`make_mesh`): the batch is cut
  into one shard a device (`shard_batch`), each device runs the model's
  full inference on its shard on a replica of the model (`replicate`), and
  the outputs are gathered (infer/synthesis.py `synthesis_batch(mesh=)`);
- training is one process a device under a process group
  (`torch.distributed`, bin/distribute.py starts it). Each rank holds its
  slice of the global batch, which is the ranks' local batches
  concatenated in rank order, and the step computes what the reference's
  jitted step computes on that global batch: inside `global_batch()` the
  losses divide by counts all-reduced over the ranks (`global_count`,
  `global_mean`), BatchNorm takes its statistics over the global batch with
  a differentiable all-reduce (`global_sum`), a term computed from such
  sums on every rank enters each rank's loss as its share (`share`), and
  the float32 gradients are summed over the ranks in one buffer
  (`sum_grads`). Only sums are reordered.

Outside `global_batch()`, or with no process group, every helper is the
identity: a single process behaves exactly as before.

`pad_batch_to_devices` and `sync_batch_shapes` are the reference's batch
padding, for numpy batches.
"""

from __future__ import annotations

import contextlib
import contextvars
import datetime
import os
import weakref

import numpy as np
import torch
import torch.distributed as dist

# whether the global batch's statistics are in force (`global_batch`); a
# context variable, so that a thread of the sharded serving route never sees
# a train step's setting
_ACTIVE = contextvars.ContextVar("global_batch", default=False)


class Mesh:
    """A 1-axis mesh of torch devices (the reference's `Mesh` with one
    "data" axis), and the model replicas kept on it (`replicate`)."""

    def __init__(self, devices, axis: str = "data"):
        self.devices = tuple(torch.device(d) for d in devices)
        if not self.devices:
            raise ValueError("a mesh needs at least one device")
        self.axis = axis
        # module -> ((its device, its weights' versions), {device: copy});
        # weak, so that a mesh keeps no model alive
        self._replicas = weakref.WeakKeyDictionary()

    @property
    def size(self) -> int:
        return len(self.devices)

    def __repr__(self) -> str:
        return f"Mesh({[str(d) for d in self.devices]}, axis={self.axis!r})"


def make_mesh(n_devices: int | None = None, axis: str = "data", devices=None) -> Mesh:
    """A 1-axis mesh: the first n_devices local CUDA devices (all of them
    by default), or the given `devices` (any torch devices, the same one
    more than once included). With no CUDA and no device list this raises;
    it never falls back to the CPU."""
    if devices is None:
        if not torch.cuda.is_available():
            raise RuntimeError("CUDA is not available; pass make_mesh(devices=['cpu', ...]) "
                               "to build a mesh of CPU devices")
        count = torch.cuda.device_count()
        devices = [torch.device("cuda", i) for i in range(n_devices or count)]
        if len(devices) > count:
            raise ValueError(f"{len(devices)} devices asked for, {count} CUDA devices present")
    elif n_devices is not None:
        devices = list(devices)[:n_devices]
    return Mesh(devices, axis)


def replicate(mesh: Mesh, module: torch.nn.Module) -> list:
    """The replica of `module` for each mesh entry: one a distinct device
    (the module itself on its own device, a copy elsewhere), so the
    entries of one device share it. The copies are kept on the mesh and
    rebuilt when the module's weights change."""
    home = next(module.parameters()).device
    key = (home, tuple(t._version for t in module.state_dict().values()))
    hit = mesh._replicas.get(module)
    if hit is None or hit[0] != key:
        import copy

        hit = mesh._replicas[module] = (key, {d: copy.deepcopy(module).to(d)
                                              for d in set(mesh.devices) - {home}})
    return [module if d == home else hit[1][d] for d in mesh.devices]


def shard_batch(batch: dict, mesh: Mesh) -> list[dict]:
    """A host batch cut along its first axis into one shard a mesh device,
    each moved to its device (0-d values go to every shard as they are).
    The batch size must be a multiple of the mesh size."""
    b = next(np.shape(v)[0] for v in batch.values() if np.ndim(v) > 0)
    if b % mesh.size:
        raise ValueError(f"batch of {b} rows does not divide over a mesh of {mesh.size}")
    n = b // mesh.size
    out = []
    for i, d in enumerate(mesh.devices):
        out.append({k: (v if np.ndim(v) == 0 else
                        torch.as_tensor(np.asarray(v[i * n:(i + 1) * n])).to(d))
                    for k, v in batch.items()})
    return out


# ------------------------------------------------------------ the process group

def world_size() -> int:
    """The process group's size, 1 without one."""
    return dist.get_world_size() if dist.is_initialized() else 1


def rank() -> int:
    """This process's rank, 0 without a process group."""
    return dist.get_rank() if dist.is_initialized() else 0


def is_rank0() -> bool:
    """Whether this process writes checkpoints and logs (the reference's
    process 0)."""
    return rank() == 0


def distributed() -> bool:
    """Whether a process group is initialized (trainers then run
    data-parallel, at world size 1 too)."""
    return dist.is_initialized()


def init_process_group(device: torch.device, init_method: str, world: int, rank_: int,
                       timeout_s: float = 300.0) -> None:
    """Join the group: NCCL for a CUDA device (bound first), gloo
    otherwise. A failed rendezvous raises (after `timeout_s`)."""
    backend = "nccl" if device.type == "cuda" else "gloo"
    if device.type == "cuda":
        torch.cuda.set_device(device)
    dist.init_process_group(backend, init_method=init_method, world_size=world, rank=rank_,
                            timeout=datetime.timedelta(seconds=timeout_s))


def init_from_env(device) -> bool:
    """Join the group torchrun describes (its RANK, WORLD_SIZE, LOCAL_RANK,
    MASTER_ADDR and MASTER_PORT), binding `cuda:LOCAL_RANK` unless the
    device is named; False (and nothing done) outside torchrun or when a
    group already exists."""
    if dist.is_initialized() or "RANK" not in os.environ or "WORLD_SIZE" not in os.environ:
        return False
    local = int(os.environ.get("LOCAL_RANK", 0))
    dev = torch.device(device) if device is not None else torch.device("cuda", local)
    init_process_group(dev, "env://", int(os.environ["WORLD_SIZE"]), int(os.environ["RANK"]))
    return True


def comm_device() -> torch.device:
    """Where this group's collectives take their tensors: the bound CUDA
    device under NCCL, the CPU under gloo."""
    if dist.get_backend() == "nccl":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


@contextlib.contextmanager
def global_batch():
    """The forward (and backward) of a data-parallel train step: inside it,
    under a process group, counts, means and BatchNorm statistics are the
    global batch's. Without a group it changes nothing."""
    token = _ACTIVE.set(dist.is_initialized())
    try:
        yield
    finally:
        _ACTIVE.reset(token)


def active() -> bool:
    """Whether the global batch's statistics are in force (`global_batch`)."""
    return _ACTIVE.get()


def global_count(c):
    """A count (a number or a tensor, no gradient) summed over the ranks;
    `c` itself when inactive."""
    if not _ACTIVE.get():
        return c
    t = torch.as_tensor(c, dtype=torch.float32).detach().clone()
    if t.device.type == "cpu" and dist.get_backend() == "nccl":
        t = t.to(comm_device())
    dist.all_reduce(t)
    return t if not isinstance(c, torch.Tensor) else t.to(c.device, c.dtype)


class _AllReduceSum(torch.autograd.Function):
    """y = the sum of x over the ranks; dL/dx = the sum over the ranks of
    their dL/dy (each rank's loss reads y)."""

    @staticmethod
    def forward(ctx, x):
        y = x.clone()
        dist.all_reduce(y)
        return y

    @staticmethod
    def backward(ctx, grad):
        grad = grad.contiguous().clone()
        dist.all_reduce(grad)
        return grad


def global_sum(x: torch.Tensor) -> torch.Tensor:
    """x summed over the ranks, differentiably (the backward sums the
    ranks' upstream gradients); x itself when inactive."""
    return _AllReduceSum.apply(x) if _ACTIVE.get() else x


def global_mean(x: torch.Tensor) -> torch.Tensor:
    """This rank's share of the mean of x over the global batch: its sum
    over the global element count; x.mean() when inactive."""
    if not _ACTIVE.get():
        return x.mean()
    return x.sum() / global_count(torch.tensor(float(x.numel()), device=x.device))


def share(x: torch.Tensor) -> torch.Tensor:
    """A loss term every rank computes alike from global sums enters each
    rank's loss divided by the world size, so that the ranks' summed
    gradients and summed metrics count it once; x itself when inactive."""
    return x / dist.get_world_size() if _ACTIVE.get() else x


def sum_grads(grads: list) -> list:
    """The float32 gradient list summed over the ranks in one coalesced
    all-reduce; the list itself without a process group."""
    if not dist.is_initialized():
        return grads
    flat = torch.cat([g.reshape(-1) for g in grads])
    dev = flat.device
    if dev.type == "cpu" and dist.get_backend() == "nccl":
        flat = flat.to(comm_device())
    dist.all_reduce(flat)
    flat = flat.to(dev)
    out, i = [], 0
    for g in grads:
        out.append(flat[i:i + g.numel()].view_as(g))
        i += g.numel()
    return out


def sum_metrics(values: dict) -> dict:
    """Each rank's share of each metric (0-d tensors) summed over the
    ranks in one all-reduce, as float64 tensors; the dict itself without a
    process group."""
    if not dist.is_initialized() or not values:
        return values
    keys = list(values)
    t = torch.stack([values[k].detach().double().reshape(()) for k in keys])
    dev = t.device
    if dev.type == "cpu" and dist.get_backend() == "nccl":
        t = t.to(comm_device())
    dist.all_reduce(t)
    return dict(zip(keys, t.to(dev)))


def broadcast_module(module: torch.nn.Module, src: int = 0) -> None:
    """Every parameter and buffer of `module` set to rank `src`'s (a
    coalesced broadcast a dtype); nothing without a process group."""
    if not dist.is_initialized():
        return
    by_dtype: dict = {}
    for t in module.state_dict().values():
        by_dtype.setdefault(t.dtype, []).append(t)
    for ts in by_dtype.values():
        flat = torch.cat([t.reshape(-1) for t in ts])
        dev = flat.device
        if dev.type == "cpu" and dist.get_backend() == "nccl":
            flat = flat.to(comm_device())
        dist.broadcast(flat, src)
        flat = flat.to(dev)
        i = 0
        with torch.no_grad():
            for t in ts:
                t.copy_(flat[i:i + t.numel()].view_as(t))
                i += t.numel()


def broadcast_object(obj, src: int = 0):
    """A picklable value from rank `src`; `obj` without a process group."""
    if not dist.is_initialized():
        return obj
    box = [obj]
    dist.broadcast_object_list(box, src, device=comm_device())
    return box[0]


def barrier() -> None:
    if dist.is_initialized():
        dist.barrier()


# ------------------------------------------------------------ the batch padding

def sync_batch_shapes(batch: dict, r: int) -> dict:
    """The reference's rule: every rank pads its batch to the largest text
    and mel lengths of the group's batches this step (one all-gather of the
    two ints), text, mel and linear with zeros and the stop targets with
    1s (pad frames past the end stay stopped). Without a process group, or
    where the lengths already agree, the batch itself."""
    if not dist.is_initialized() or dist.get_world_size() <= 1:
        return batch
    t_text, t_mel = batch["text"].shape[1], batch["mel"].shape[1]
    mine = torch.tensor([t_text, t_mel], dtype=torch.int64, device=comm_device())
    dims = [torch.zeros_like(mine) for _ in range(dist.get_world_size())]
    dist.all_gather(dims, mine)
    dims = torch.stack(dims).cpu().numpy()
    return pad_batch_shapes(batch, int(dims[:, 0].max()), int(dims[:, 1].max()), r)


def pad_batch_shapes(batch: dict, g_text: int, g_mel: int, r: int) -> dict:
    """`sync_batch_shapes`' padding of one batch to text length g_text and
    mel length g_mel (stop targets to g_mel // r steps)."""
    t_text, t_mel = batch["text"].shape[1], batch["mel"].shape[1]
    if g_text == t_text and g_mel == t_mel:
        return batch
    out = dict(batch)
    out["text"] = np.pad(batch["text"], ((0, 0), (0, g_text - t_text)))
    out["mel"] = np.pad(batch["mel"], ((0, 0), (0, g_mel - t_mel), (0, 0)))
    if "linear" in batch:
        out["linear"] = np.pad(batch["linear"], ((0, 0), (0, g_mel - t_mel), (0, 0)))
    st = batch["stop_targets"]
    out["stop_targets"] = np.pad(st, ((0, 0), (0, g_mel // r - st.shape[1])),
                                 constant_values=1.0)
    return out


def pad_batch_to_devices(batch: dict, n_devices: int) -> dict:
    """Pad the batch axis up to a multiple of n_devices with phantom rows:
    zeros everywhere, so mel_lengths 0 (the losses ignore them), and
    text_lengths 1 (attention needs one valid position)."""
    b = next(np.shape(v)[0] for v in batch.values() if np.ndim(v) > 0)
    rem = (-b) % n_devices
    if rem == 0:
        return batch
    out = {}
    for k, v in batch.items():
        v = np.asarray(v)
        if v.ndim == 0:
            out[k] = v
        else:
            out[k] = np.pad(v, [(0, rem)] + [(0, 0)] * (v.ndim - 1))
    if "text_lengths" in out:
        out["text_lengths"][b:] = 1
    return out
