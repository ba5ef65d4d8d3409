"""WaveRNN generation over a batch of folds: the CUDA kernel
(csrc/wavernn_gen.cu), its plain PyTorch version, and the dispatcher.

Counterpart of the JAX package's ops/pallas/wavernn_gen.py
`wavernn_generate_pallas`: conditioning cond [B, L, n_mels] and aux
[B, L, 4 aux_dims] (the rows are the folds of one utterance) -> samples
[B, L], float32. Per sample step and row: the input layer on
[x_prev | mel | a1], GRU1 with a residual, GRU2 on [x | a2] with a
residual, relu(fc1 [x | a3]), relu(fc2 [f1 | a4]), fc3, then the sampling
of the I/O mode (vocoder/models/distribs.py), whose random numbers come
from the counter hash keyed by (seed, step). The plain version keeps the
Pallas kernel's order of operations: every concatenated input is two
products on the row-split weight.
"""

from __future__ import annotations

import ctypes
import math

import torch
import torch.nn.functional as F

from ..nn.rnn import gru_gates
from ..vocoder.models.distribs import (LOG_SCALE_MIN, mulaw_width, sample_gauss,
                                       sample_mol, sample_mulaw)
from . import cuda_build
from .prng import step_key

F32 = torch.float32
MODES = ("mulaw", "mol", "gauss")


def generation_weights(model) -> dict:
    """The sample loop's float32 weights from a WaveRNN module, in the
    port's [out, in] layouts: the input layer split into its x_prev column
    `i_w0` and the [mel | a1] columns `i_wc`; both GRUs and the three FCs
    as they are."""
    d = lambda t: t.detach().to(F32)  # noqa: E731
    w = {"i_w0": d(model.I.weight[:, 0]), "i_wc": d(model.I.weight[:, 1:]),
         "i_b": d(model.I.bias)}
    for k, cell in (("g1", model.rnn1), ("g2", model.rnn2)):
        w.update({f"{k}_wx": d(cell.weight_ih), f"{k}_wh": d(cell.weight_hh),
                  f"{k}_bx": d(cell.bias_ih), f"{k}_bh": d(cell.bias_hh)})
    for k in ("fc1", "fc2", "fc3"):
        fc = getattr(model, k)
        w[f"{k}_w"], w[f"{k}_b"] = d(fc.weight), d(fc.bias)
    return w


def _check(w: dict, cond, aux, mode: str):
    if mode not in MODES:
        raise ValueError(f"unknown WaveRNN mode {mode!r}")
    if cond.dim() != 3 or aux.dim() != 3 or cond.shape[:2] != aux.shape[:2] \
            or aux.shape[-1] % 4:
        raise ValueError(f"cond {tuple(cond.shape)} and aux {tuple(aux.shape)} must be "
                         f"[B, L, n_mels] and [B, L, 4 aux_dims]")
    B, L, M = cond.shape
    A = aux.shape[-1] // 4
    R = w["g1_wh"].shape[1]
    if w["i_wc"].shape[1] != M + A or w["g2_wx"].shape[1] != R + A:
        raise ValueError(f"weights do not fit n_mels {M} / aux_dims {A}")
    return B, L, M, A, R


def wavernn_generate_plain(w: dict, cond, aux, seed: int, *, bits: int,
                           mode: str = "mulaw", num_mixtures: int = 10,
                           greedy: bool = False):
    """The sample loop in plain PyTorch ops, one step at a time, on any
    device: the reference the kernel is held against. Arguments as
    `wavernn_generate`."""
    B, L, M, A, R = _check(w, cond, aux, mode)
    Fd = w["fc1_w"].shape[0]
    stream = torch.cat([cond, aux], -1).to(F32)
    dev = stream.device
    h1 = torch.zeros(B, R, device=dev)
    h2 = torch.zeros(B, R, device=dev)
    x_prev = torch.zeros(B, 1, device=dev)
    out = torch.empty(B, L, device=dev)
    mm = lambda x, wt: x @ wt.T  # noqa: E731
    for t in range(L):
        key = step_key(seed, t)
        c = stream[:, t]
        a2, a3, a4 = (c[:, M + k * A: M + (k + 1) * A] for k in (1, 2, 3))
        x = x_prev * w["i_w0"] + mm(c[:, :M + A], w["i_wc"]) + w["i_b"]
        h1 = gru_gates(mm(x, w["g1_wx"]) + w["g1_bx"], mm(h1, w["g1_wh"]) + w["g1_bh"], h1)
        x = x + h1
        gx = mm(x, w["g2_wx"][:, :R]) + mm(a2, w["g2_wx"][:, R:]) + w["g2_bx"]
        h2 = gru_gates(gx, mm(h2, w["g2_wh"]) + w["g2_bh"], h2)
        x = x + h2
        f1 = F.relu(mm(x, w["fc1_w"][:, :R]) + mm(a3, w["fc1_w"][:, R:]) + w["fc1_b"])
        f2 = F.relu(mm(f1, w["fc2_w"][:, :Fd]) + mm(a4, w["fc2_w"][:, Fd:]) + w["fc2_b"])
        logits = mm(f2, w["fc3_w"]) + w["fc3_b"]
        if mode == "mulaw":
            x_next, sample = sample_mulaw(logits, key, bits, greedy)
        elif mode == "mol":
            x_next = sample = sample_mol(logits, key, num_mixtures, greedy)
        else:
            x_next = sample = sample_gauss(logits, key, greedy)
        x_prev = x_next[:, None]
        out[:, t] = sample
    return out


def _pad4(n: int) -> int:
    return -(-n // 4) * 4


def padded_widths(M: int, A: int, R: int, Fd: int) -> tuple[int, int, int, int, int]:
    """The kernel's row lengths, each a multiple of 4 floats: the input
    layer's [mel | a1] columns, the GRU hidden state, GRU2 and fc1 on
    [x | a], fc2 on [f1 | a4], fc3 on f2."""
    return _pad4(M + A), _pad4(R), _pad4(R + A), _pad4(Fd + A), _pad4(Fd)


def _rows(wt, K: int):
    """[N, k] -> [N, K] float32, zero-padded on the right to K columns."""
    return F.pad(wt, (0, K - wt.shape[1])).contiguous()


def _gates(wt, K: int):
    """GRU weight [3H, k] (gates r, z, n) -> [H, 3, K]: one unit's three
    gate rows next to each other, rows zero-padded to K."""
    H = wt.shape[0] // 3
    return _rows(wt, K).reshape(3, H, K).transpose(0, 1).contiguous()


_P = ctypes.c_void_p


def _lib():
    lib = cuda_build.load("wavernn_gen")
    lib.wavernn_generate.argtypes = [ctypes.POINTER(_P), ctypes.POINTER(ctypes.c_int),
                                     ctypes.POINTER(ctypes.c_float), ctypes.c_uint, _P]
    lib.wavernn_generate.restype = ctypes.c_int
    lib.wavernn_launch_shape.argtypes = [ctypes.POINTER(ctypes.c_int),
                                         ctypes.POINTER(ctypes.c_int)]
    lib.wavernn_launch_shape.restype = ctypes.c_int
    lib.wavernn_probe.argtypes = [*lib.wavernn_generate.argtypes, ctypes.c_int]
    lib.wavernn_probe.restype = ctypes.c_int
    return lib


def pack_weights(w: dict) -> dict:
    """The kernel's weight layout from `generation_weights`: every matrix
    zero-padded on the right to its row length (`padded_widths`); each GRU
    matrix as [H, 3, K], one unit's three gate rows next to each other, and
    each GRU bias as [H, 3]. `mats` and `bias` in the order the kernel takes
    them. Made once per set of weights (`WaveRNN.packed_weights` keeps it)."""
    R, M_A = w["g1_wh"].shape[1], w["i_wc"].shape[1]
    A = w["g2_wx"].shape[1] - R
    KI, KR, K2, KF, KF3 = padded_widths(M_A - A, A, R, w["fc1_w"].shape[0])
    mats = [_rows(w["i_wc"], KI), _gates(w["g1_wx"], KR), _gates(w["g1_wh"], KR),
            _gates(w["g2_wx"], K2), _gates(w["g2_wh"], KR), _rows(w["fc1_w"], K2),
            _rows(w["fc2_w"], KF), _rows(w["fc3_w"], KF3)]
    bias = [w["i_w0"].contiguous(), w["i_b"].contiguous(),
            *(w[k].reshape(3, R).T.contiguous() for k in ("g1_bx", "g1_bh", "g2_bx", "g2_bh")),
            w["fc1_b"].contiguous(), w["fc2_b"].contiguous(), w["fc3_b"].contiguous()]
    return {"mats": mats, "bias": bias}


def _dims(B, L, M, A, R, Fd, NC, mode, greedy, num_mixtures):
    KI, KR, K2, KF, KF3 = padded_widths(M, A, R, Fd)
    W = mulaw_width(NC) if mode == "mulaw" else (num_mixtures if mode == "mol" else 1)
    return [B, L, M, A, M + 4 * A, R, Fd, NC, W, MODES.index(mode), int(greedy),
            num_mixtures, KI, KR, K2, KF, KF3]


def launch_shape(B: int, L: int, M: int, A: int, R: int, Fd: int, NC: int,
                 mode: str = "mulaw", num_mixtures: int = 10) -> dict:
    """The kernel's launch on this card for these sizes: blocks (one per
    SM), threads a block, batch rows staged per tile and tiles a stage,
    dynamic shared memory bytes, co-resident blocks per SM, the bytes of a
    block's weight slice (every stage's rows are copied from L2 each step;
    only the input layer's are kept in shared memory for the launch), and
    grid barriers a step."""
    dims = (ctypes.c_int * 17)(*_dims(B, L, M, A, R, Fd, NC, mode, False, num_mixtures))
    out = (ctypes.c_int * 7)()
    cuda_build.check(_lib().wavernn_launch_shape(dims, out), "wavernn_launch_shape")
    shape = dict(zip(("blocks", "threads", "tile_rows", "smem_bytes", "blocks_per_sm",
                      "weight_slice_bytes", "barriers_per_step"), out))
    shape["tiles"] = -(-B // shape["tile_rows"]) if shape["tile_rows"] else 0
    return shape


def _launch(w: dict, cond, aux, seed: int, bits: int, mode: str, num_mixtures: int,
            greedy: bool, packed, probe: int):
    if cond.device.type != "cuda" or aux.device.type != "cuda":
        raise ValueError("the WaveRNN kernel takes CUDA tensors")
    B, L, M, A, R = _check(w, cond, aux, mode)
    if cond.dtype != F32 or aux.dtype != F32:
        raise ValueError(f"the WaveRNN kernel takes float32 cond/aux (got {cond.dtype}, "
                         f"{aux.dtype})")
    if not (cond.is_contiguous() and aux.is_contiguous()):
        raise ValueError("the WaveRNN kernel takes contiguous cond/aux")
    for k, v in w.items():
        if v.dtype != F32 or v.device != cond.device:
            raise ValueError(f"WaveRNN weight {k} must be float32 on {cond.device}")
    Fd, NC = w["fc1_w"].shape[0], w["fc3_w"].shape[0]
    need = {"mulaw": 2 ** bits, "mol": 3 * num_mixtures, "gauss": 2}[mode]
    if NC != need:
        raise ValueError(f"fc3 has {NC} outputs; mode {mode!r} needs {need}")
    packed = pack_weights(w) if packed is None else packed
    if packed["mats"][0].device != cond.device:
        raise ValueError(f"the packed WaveRNN weights must be on {cond.device}")
    lib = _lib()
    dev = cond.device
    dims = _dims(B, L, M, A, R, Fd, NC, mode, greedy, num_mixtures)
    stream = torch.cat([cond, aux], -1).transpose(0, 1).contiguous()       # [L, B, C]
    e = lambda *s: torch.empty(*s, device=dev)  # noqa: E731
    scratch = [e(2, B, R), e(B, R), e(B, R), torch.zeros(2, B, R, device=dev),
               torch.zeros(2, B, R, device=dev), e(B, Fd), e(B, Fd), e(B, NC),
               torch.zeros(2, B, dtype=torch.int64, device=dev)]
    out = e(L, B)
    ptrs = [stream] + packed["mats"] + packed["bias"] + scratch + [out]
    c_ptrs = (_P * len(ptrs))(*(t.data_ptr() for t in ptrs))
    mu = float(2 ** bits - 1)
    c_fl = (ctypes.c_float * 3)(mu, math.log1p(mu), LOG_SCALE_MIN)
    c_dims = (ctypes.c_int * len(dims))(*dims)
    args = (c_ptrs, c_dims, c_fl, seed & 0xFFFFFFFF, torch.cuda.current_stream(dev).cuda_stream)
    err = lib.wavernn_probe(*args, probe) if probe else lib.wavernn_generate(*args)
    if err == -1:
        raise RuntimeError("the WaveRNN kernel's grid cannot be co-resident on this card")
    cuda_build.check(err, "wavernn_probe" if probe else "wavernn_generate")
    return out


def wavernn_generate_cuda(w: dict, cond, aux, seed: int, *, bits: int,
                          mode: str = "mulaw", num_mixtures: int = 10,
                          greedy: bool = False, packed: dict | None = None):
    """The sample loop as ONE cooperative launch of the CUDA kernel: every
    step of every fold runs inside it, with grid-wide barriers between
    its five stages. `packed`: `pack_weights(w)`, made here when not given.
    Takes contiguous float32 CUDA tensors and raises on anything else, or
    when the card cannot hold the grid co-resident."""
    out = _launch(w, cond, aux, seed, bits, mode, num_mixtures, greedy, packed, 0)
    wavernn_generate_cuda.launches += 1
    return out.T.contiguous()


wavernn_generate_cuda.launches = 0

# The kernel's probe launches: parts of every step left out (the bits of
# csrc/wavernn_gen.cu); "barriers_only" keeps the grid and its five
# barriers a step and nothing else, the latency floor.
PROBES = {"no_dots": 1, "no_staging": 2, "no_sampling": 4, "barriers_only": 8}


def wavernn_probe_cuda(w: dict, cond, aux, probe: str, *, bits: int, packed: dict | None = None):
    """One probe launch (`PROBES`) on the mu-law sampled route, for its
    time alone: its samples mean nothing, and it counts no launch."""
    _launch(w, cond, aux, 7, bits, "mulaw", 10, False, packed, PROBES[probe])


def wavernn_generate(w: dict, cond, aux, seed: int, *, bits: int,
                     mode: str = "mulaw", num_mixtures: int = 10,
                     greedy: bool = False, packed: dict | None = None):
    """Decode folds. w: `generation_weights` of a WaveRNN on the inputs'
    device; cond [B, L, n_mels], aux [B, L, 4 aux_dims]; seed: the hash
    PRNG's seed (uint32); mode 'mulaw' (2**bits classes), 'mol' or
    'gauss'; greedy replaces every draw by its argmax / mean. Returns
    samples [B, L] in [-1, 1]. CPU tensors run the plain version, CUDA
    tensors the kernel (on `packed`, the kernel's layout of w, when given)."""
    if cond.device.type == "cpu":
        return wavernn_generate_plain(w, cond, aux, seed, bits=bits, mode=mode,
                                      num_mixtures=num_mixtures, greedy=greedy)
    return wavernn_generate_cuda(w, cond, aux, seed, bits=bits, mode=mode,
                                 num_mixtures=num_mixtures, greedy=greedy, packed=packed)
