"""Tacotron2 free-running decode: the CUDA kernel (csrc/taco2_decode.cu), its
plain PyTorch version, and the weight layout both read.

Counterpart of the JAX package's ops/pallas/taco2_decode.py
`tacotron2_decode_pallas` for the configuration this slice serves
(location-sensitive attention with sigmoid or softmax norm, location
features on or off, original or BN-folded prenet with the hash-PRNG
dropout). Same arguments, same outputs: time-major frames
[steps, B, n_mels * r_init], alignments [steps, B, T], stop probabilities
[steps, B] and lengths [B] in r-groups.

Semantics of the Pallas route, which both versions keep:
- every `chunk` steps the host reads the done mask once; once every row is
  done the remaining chunks are zero;
- within a chunk a row that is done keeps advancing its LSTM and attention
  state and still writes its alignment and stop probability; only its
  output frame and its fed-back frame are zero;
- prenet dropout draws from the hash PRNG keyed by (seed, step), salts 11
  and 12, element index row * width + col;
- the stopnet is folded through the projection;
- matrix inputs are rounded to the working dtype (bf16 by default), with
  f32 accumulation, f32 state and f32 outputs.

`tacotron2_decode` runs the plain version for a CPU tensor and the kernel
for a CUDA tensor; the kernel wrapper raises on what it does not take.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from . import cuda_build
from .prng import step_key, uniform

F32 = torch.float32
BF16 = torch.bfloat16


def _round_up(n: int, m: int = 8) -> int:
    return (n + m - 1) // m * m


def _interleave_gates(w):
    """[4H, ...] stacked (i, f, g, o) blocks -> rows 4 * j + g."""
    H = w.shape[0] // 4
    return w.reshape(4, H, *w.shape[1:]).transpose(0, 1).reshape(4 * H, *w.shape[1:])


def _rows(w, dtype):
    """Weight [out, in] -> `dtype` rows padded to a multiple of 8 columns
    (16-byte rows for the kernel's vector loads)."""
    return F.pad(w.detach().to(F32), (0, _round_up(w.shape[1]) - w.shape[1])) \
        .to(dtype).contiguous()


@torch.no_grad()
def prepare_weights(prenet, attention_rnn, query_w, loc_u, v_w, v_b,
                    decoder_rnn, projection, stopnet, *, dtype=BF16) -> dict:
    """Lay the decoder's weights out for the decode, once per load.

    prenet: [(weight [P, in], bias [P]), ...] (two layers, BN already
    folded); attention_rnn / decoder_rnn: (weight_ih, weight_hh, bias) with
    torch gate order; query_w [A, H1]; loc_u [2, K, A] folded location
    filter or None; v_w [1, A], v_b [1]; projection (weight [OW, H2 + E],
    bias); stopnet (weight [1, H2 + OW], bias).

    Every matrix is [out, in] in `dtype`; LSTM gate rows are interleaved so
    that rows 4j..4j+3 are unit j's i, f, g, o over inputs [x | ctx | h];
    the projection gets the stop row appended, folded through it
    (stop([h2, proj(h2, ctx)]) = W_eff [h2 | ctx] + b_eff). Biases, v and the
    state stay f32."""
    (p1_w, p1_b), (p2_w, p2_b) = prenet
    a_ih, a_hh, a_b = attention_rnn
    d_ih, d_hh, d_b = decoder_rnn
    proj_w, proj_b = (t.detach().to(F32) for t in projection)
    stop_w, stop_b = (t.detach().to(F32) for t in stopnet)
    H1, H2 = a_hh.shape[1], d_hh.shape[1]
    A = query_w.shape[0]
    OW = proj_w.shape[0]
    if loc_u is None:
        loc_u = torch.zeros(2, 1, A, device=query_w.device)
    so = stop_w[0, H2:]
    stop_w_eff = so @ proj_w
    stop_w_eff[:H2] += stop_w[0, :H2]
    stop_b_eff = stop_b + proj_b @ so
    f32 = lambda t: t.detach().to(F32).contiguous()  # noqa: E731
    return {
        "dtype": dtype,
        "dims": {"n_in": p1_w.shape[1], "P": p1_w.shape[0], "H1": H1,
                 "H2": H2, "E": d_ih.shape[1] - H1, "A": A,
                 "K": loc_u.shape[1], "OW": OW},
        "p1_w": _rows(p1_w, dtype), "p1_b": f32(p1_b),
        "p2_w": _rows(p2_w, dtype), "p2_b": f32(p2_b),
        "a_w": _rows(_interleave_gates(torch.cat([a_ih, a_hh], 1)), dtype),
        "a_b": f32(_interleave_gates(a_b)),
        "q_w": _rows(query_w, dtype),
        "u": loc_u.detach().to(F32).to(dtype).contiguous(),
        "v_w": f32(v_w[0]), "v_b": float(v_b[0]),
        "d_w": _rows(_interleave_gates(torch.cat([d_ih, d_hh], 1)), dtype),
        "d_b": f32(_interleave_gates(d_b)),
        "o_w": _rows(torch.cat([proj_w, stop_w_eff[None]], 0), dtype),
        "o_b": f32(torch.cat([proj_b, stop_b_eff])),
    }


def _drive(n_steps: int, chunk: int, step, all_done) -> int:
    """Run step(s) for s < n_steps; at each chunk boundary stop once every
    row is done. Returns the number of steps run."""
    for s in range(n_steps):
        if s and s % chunk == 0 and all_done(s):
            return s
        step(s)
    return n_steps


def _finish(out, aligns, stops, ran: int, max_steps: int, thresh: float):
    """Zero the skipped chunks, cut to max_steps, and count each row's
    length in r-groups: a step counts while the row was active at its
    start (the stop token's own step counts)."""
    out[ran:].zero_()
    aligns[ran:].zero_()
    stops[ran:].zero_()
    out, aligns, stops = out[:max_steps], aligns[:max_steps], stops[:max_steps]
    done_before = torch.cumsum((stops > thresh).to(torch.int32), 0) > 0
    done_at_start = torch.cat([torch.zeros_like(done_before[:1]), done_before[:-1]])
    lengths = (~done_at_start).sum(0)
    return out, aligns, stops, lengths


def attention_plain(h, att, cum, q_w, u, v_w, v_b: float, pinp, enc, maskadd,
                    norm: str, rnd):
    """One location-sensitive attention step of the plain decodes: query
    h [B, H] against q_w [A, H]; location features from the folded filter
    u [2, K, A] over the rounded [att, cum]; energies, sigmoid or softmax
    norm; returns (context [B, E], alignment [B, T])."""
    K = u.shape[1]
    pad = (K - 1) // 2
    pq = rnd(h) @ q_w.T                                   # [B, A]
    loc = F.conv1d(F.pad(rnd(torch.stack([att, cum], 1)), (pad, K - 1 - pad)),
                   u.permute(2, 0, 1)).transpose(1, 2)    # [B, T, A]
    e = (torch.tanh(pq[:, None, :] + loc + pinp) * v_w).sum(-1) + v_b
    e = e + maskadd
    if norm == "softmax":
        align = torch.softmax(e, -1)
    else:
        sg = torch.sigmoid(e)
        align = sg / sg.sum(-1, keepdim=True).clamp_min(1e-8)
    return (align[:, :, None] * enc).sum(1), align


def tacotron2_decode_plain(w: dict, enc_out, pinp, mask, *, r: int,
                           max_steps: int, norm: str = "sigmoid",
                           thresh: float = 0.6, prenet_dropout: bool = True,
                           seed: int = 0, chunk: int = 50):
    """The decode in plain PyTorch ops, on any device: the reference the
    kernel is held against. Arguments as `tacotron2_decode`."""
    d = w["dims"]
    NM, P, H1, H2, E, OW = (d[k] for k in ("n_in", "P", "H1", "H2", "E", "OW"))
    rnd = (lambda x: x.to(BF16).float()) if w["dtype"] == BF16 else (lambda x: x)
    W = {k: v.float() for k, v in w.items() if isinstance(v, torch.Tensor)}
    B, T, _ = enc_out.shape
    dev = enc_out.device
    enc = rnd(enc_out.float())
    pinp = pinp.float()
    maskadd = torch.where(mask, 0.0, -1e9).to(F32)
    z = lambda *s: torch.zeros(*s, device=dev)  # noqa: E731
    h1, c1, h2, c2 = z(B, H1), z(B, H1), z(B, H2), z(B, H2)
    ctx, att, cum, frame, done = z(B, E), z(B, T), z(B, T), z(B, NM), z(B)
    n_steps = -(-max_steps // chunk) * chunk
    out = torch.empty(n_steps, B, OW, device=dev)
    aligns = torch.empty(n_steps, B, T, device=dev)
    stops = torch.empty(n_steps, B, device=dev)

    def lstm(wk, bk, xs, c):
        gates = (rnd(torch.cat(xs, 1)) @ W[wk][:, :sum(x.shape[1] for x in xs)].T
                 + W[bk]).view(B, -1, 4)
        c = torch.sigmoid(gates[..., 1]) * c + torch.sigmoid(gates[..., 0]) * torch.tanh(gates[..., 2])
        return torch.sigmoid(gates[..., 3]) * torch.tanh(c), c

    def dropout(x, key, salt):
        if not prenet_dropout:
            return x
        return torch.where(uniform(tuple(x.shape), key, salt, dev) < 0.5, 0.0, x * 2.0)

    def step(s):
        nonlocal h1, c1, h2, c2, ctx, att, cum, frame, done
        key = step_key(seed, s)
        x = torch.relu(rnd(frame) @ W["p1_w"][:, :NM].T + W["p1_b"])
        x = dropout(x, key, 11)
        x = torch.relu(rnd(x) @ W["p2_w"][:, :P].T + W["p2_b"])
        x = dropout(x, key, 12)
        h1, c1 = lstm("a_w", "a_b", [x, ctx, h1], c1)
        ctx, align = attention_plain(h1, att, cum, W["q_w"][:, :H1], W["u"], W["v_w"],
                                     w["v_b"], pinp, enc, maskadd, norm, rnd)
        h2, c2 = lstm("d_w", "d_b", [h1, ctx, h2], c2)
        o = rnd(torch.cat([h2, ctx], 1)) @ W["o_w"][:, :H2 + E].T + W["o_b"]
        stop = torch.sigmoid(o[:, OW])
        dec = o[:, :OW] * (1.0 - done)[:, None]
        done = torch.maximum(done, (stop > thresh).to(F32))
        frame = dec[:, NM * (r - 1): NM * r]
        att, cum = align, cum + align
        out[s], aligns[s], stops[s] = dec, align, stop

    ran = _drive(n_steps, chunk, step, lambda s: bool(done.min() > 0))
    return _finish(out, aligns, stops, ran, max_steps, thresh)


_P, _I = ctypes.c_void_p, ctypes.c_int
_ARGTYPES = {
    "taco2_prenet": [_P, _I, _P, _P, _I, _P, _P, _I, _I, _P, _I, ctypes.c_uint,
                     ctypes.c_uint, _I, _P],
    "taco2_lstm": [_P, _P, _I, _P, _I, _P, _I, _P, _I, _P, _P, _I, _P],
    "taco2_attention": [_P, _P, _I, _I, _P, _I, _P, ctypes.c_float, _P, _P, _P,
                        _P, _P, _P, _P, _I, _I, _I, _I, _I, _P],
    "taco2_project": [_P, _P, _I, _P, _I, _P, _I, _P, _P, _P, _P, _P, _I, _I,
                      _I, _I, ctypes.c_float, _P],
}


def _lib():
    lib = cuda_build.load("taco2_decode")
    for name, types in _ARGTYPES.items():
        fn = getattr(lib, name)
        fn.argtypes, fn.restype = types, ctypes.c_int
    return lib


def tacotron2_decode_cuda(w: dict, enc_out, pinp, mask, *, r: int,
                          max_steps: int, norm: str = "sigmoid",
                          thresh: float = 0.6, prenet_dropout: bool = True,
                          seed: int = 0, chunk: int = 50):
    """The decode on the CUDA kernels: five launches per step on the
    current stream, one host read of the done mask per chunk."""
    if enc_out.device.type != "cuda":
        raise ValueError("tacotron2_decode_cuda takes CUDA tensors")
    if w["dtype"] != BF16:
        raise ValueError("the decode kernel runs bf16 weights")
    if norm not in ("sigmoid", "softmax"):
        raise ValueError(f"unknown attention norm {norm!r}")
    d = w["dims"]
    NM, P, H1, H2, E, A, K, OW = (d[k] for k in ("n_in", "P", "H1", "H2", "E",
                                                  "A", "K", "OW"))
    B, T, E_in = enc_out.shape
    if E_in != E or tuple(pinp.shape) != (B, T, A) or tuple(mask.shape) != (B, T):
        raise ValueError(f"shape mismatch: enc_out {tuple(enc_out.shape)}, "
                         f"pinp {tuple(pinp.shape)}, mask {tuple(mask.shape)}")
    for k, v in w.items():
        if isinstance(v, torch.Tensor) and v.device != enc_out.device:
            raise ValueError(f"decode weight {k} is on {v.device}, "
                             f"inputs on {enc_out.device}")
    lib = _lib()
    dev = enc_out.device
    enc = enc_out.to(BF16).contiguous()
    pinp = pinp.to(F32).contiguous()
    maskadd = torch.where(mask, 0.0, -1e9).to(F32).contiguous()
    z = lambda *s: torch.zeros(*s, device=dev)  # noqa: E731
    h1, h2, done = z(2, B, H1), z(2, B, H2), z(2, B)
    c1, c2, ctx, att, cum = z(B, H1), z(B, H2), z(B, E), z(B, T), z(B, T)
    frame, xpre = z(B, NM), z(B, P)
    n_steps = -(-max_steps // chunk) * chunk
    out = torch.empty(n_steps, B, OW, device=dev)
    aligns = torch.empty(n_steps, B, T, device=dev)
    stops = torch.empty(n_steps, B, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    p = {k: v.data_ptr() for k, v in w.items() if isinstance(v, torch.Tensor)}
    ld = {k: w[k].shape[1] for k in ("p1_w", "p2_w", "a_w", "q_w", "d_w", "o_w")}
    h1p = [h1[0].data_ptr(), h1[1].data_ptr()]
    h2p = [h2[0].data_ptr(), h2[1].data_ptr()]
    dnp = [done[0].data_ptr(), done[1].data_ptr()]
    out0, al0, st0 = out.data_ptr(), aligns.data_ptr(), stops.data_ptr()
    softmax = int(norm == "softmax")
    seed32 = seed & 0xFFFFFFFF

    def step(s):
        cur, nxt = s % 2, (s + 1) % 2
        cuda_build.check(lib.taco2_prenet(
            frame.data_ptr(), NM, p["p1_w"], p["p1_b"], ld["p1_w"], p["p2_w"],
            p["p2_b"], ld["p2_w"], P, xpre.data_ptr(), B, seed32, s,
            int(prenet_dropout), stream), "taco2_prenet")
        cuda_build.check(lib.taco2_lstm(
            p["a_w"], p["a_b"], ld["a_w"], xpre.data_ptr(), P, ctx.data_ptr(), E,
            h1p[cur], H1, c1.data_ptr(), h1p[nxt], B, stream), "taco2_lstm")
        cuda_build.check(lib.taco2_attention(
            h1p[nxt], p["q_w"], ld["q_w"], H1, p["u"], K, p["v_w"], w["v_b"],
            pinp.data_ptr(), maskadd.data_ptr(), enc.data_ptr(), att.data_ptr(),
            cum.data_ptr(), ctx.data_ptr(), al0 + 4 * s * B * T, B, T, A, E,
            softmax, stream), "taco2_attention")
        cuda_build.check(lib.taco2_lstm(
            p["d_w"], p["d_b"], ld["d_w"], h1p[nxt], H1, ctx.data_ptr(), E,
            h2p[cur], H2, c2.data_ptr(), h2p[nxt], B, stream), "taco2_lstm")
        cuda_build.check(lib.taco2_project(
            p["o_w"], p["o_b"], ld["o_w"], h2p[nxt], H2, ctx.data_ptr(), E,
            dnp[cur], dnp[nxt], out0 + 4 * s * B * OW, st0 + 4 * s * B,
            frame.data_ptr(), B, OW, NM, r, thresh, stream), "taco2_project")
        tacotron2_decode_cuda.launches += 5

    ran = _drive(n_steps, chunk, step, lambda s: bool(done[s % 2].min() > 0))
    return _finish(out, aligns, stops, ran, max_steps, thresh)


tacotron2_decode_cuda.launches = 0


def tacotron2_decode(w: dict, enc_out, pinp, mask, *, r: int, max_steps: int,
                     norm: str = "sigmoid", thresh: float = 0.6,
                     prenet_dropout: bool = True, seed: int = 0,
                     chunk: int = 50):
    """Free-running decode. w: `prepare_weights` output on the inputs'
    device; enc_out [B, T, E] encoder memory; pinp [B, T, A] = W_k m; mask
    [B, T] bool. Returns (frames [max_steps, B, OW], alignments
    [max_steps, B, T], stop probabilities [max_steps, B], lengths [B] in
    r-groups). CPU tensors run the plain version, CUDA tensors the kernel."""
    fn = tacotron2_decode_plain if enc_out.device.type == "cpu" else tacotron2_decode_cuda
    return fn(w, enc_out, pinp, mask, r=r, max_steps=max_steps, norm=norm,
              thresh=thresh, prenet_dropout=prenet_dropout, seed=seed,
              chunk=chunk)
