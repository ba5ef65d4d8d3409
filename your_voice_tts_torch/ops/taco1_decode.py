"""Tacotron(1) free-running decode: the CUDA kernel (csrc/taco1_decode.cu),
its plain PyTorch version, and the weight layout both read.

Counterpart of the JAX package's ops/pallas/taco1_decode.py
`tacotron1_decode_pallas` for the configuration it serves (location-
sensitive attention with sigmoid or softmax norm, original or BN-folded
prenet with the hash-PRNG dropout). Same arguments, same
outputs: time-major frames [steps, B, n_mels * r_init], alignments
[steps, B, T], stop probabilities [steps, B] and lengths [B] in r-groups.

Semantics of the Pallas route, which both versions keep:
- the decoder input is a flat [B, memory * n_mels] queue of the last
  frames; each step appends its first n_mels * r outputs (zero for a row
  that is done) and keeps the last memory * n_mels values. For r <= memory
  that is the Pallas kernel's roll; the reference serves r > memory on its
  XLA scan only (`TacotronDecoder.inference`), whose queue keeps the
  step's last memory frames, and both versions here follow that rule;
- every `chunk` steps the host reads the done mask once; once every row is
  done the remaining chunks are zero;
- within a chunk a row that is done keeps advancing its GRU and attention
  state and still writes its alignment and stop probability; only its
  output frame and its queue input are zero;
- prenet dropout draws from the hash PRNG keyed by (seed, step), salts 21
  and 22, element index row * width + col;
- the stopnet is folded through the mel projection;
- matrix inputs are rounded to the working dtype (bf16 by default), with
  f32 accumulation, f32 state and f32 outputs.

The location features use one formulation for every T: the folded [2, K, A]
correlation of the Tacotron2 decode, which equals both of the reference's
(banded for T <= 256, tiled beyond). The reference pads the batch to a
multiple of 8; the port does not (dropout bits are indexed by the row, so
real rows draw the same ones).

`tacotron1_decode` runs the plain version for a CPU tensor and the kernel
for a CUDA tensor; the kernel wrapper raises on what it does not take.
"""

from __future__ import annotations

import ctypes

import torch

from . import cuda_build
from .prng import step_key, uniform
from .taco2_decode import _drive, _finish, _rows, attention_plain

F32 = torch.float32
BF16 = torch.bfloat16


def _interleave_gru(w):
    """[3H, ...] stacked (r, z, n) blocks -> rows 3 * j + g."""
    H = w.shape[0] // 3
    return w.reshape(3, H, *w.shape[1:]).transpose(0, 1).reshape(3 * H, *w.shape[1:])


@torch.no_grad()
def prepare_weights(prenet, attention_rnn, query_w, loc_u, v_w, v_b, project,
                    decoder_rnns, proj_mel, stopnet, *, n_mels: int, dtype=BF16) -> dict:
    """Lay the decoder's weights out for the decode, once per load.

    prenet: [(weight [P1, M * n_mels], bias), (weight [P2, P1], bias)] (BN
    already folded); attention_rnn and each of the two decoder_rnns:
    (weight_ih, weight_hh, bias_ih, bias_hh) in torch's GRU layout;
    query_w [A, H]; loc_u [2, K, A] folded location filter or None; v_w
    [1, A], v_b [1]; project (weight [D, H + E], bias); proj_mel (weight
    [OW, D], bias); stopnet (weight [1, D + OW], bias).

    Every matrix is [out, in] in `dtype`; GRU gate rows are interleaved so
    that rows 3j..3j+2 are unit j's r, z, n; the mel projection gets the stop
    row appended, folded through it (stop([x, mel(x)]) = W_eff x + b_eff).
    Biases, v and the state stay f32."""
    (p1_w, p1_b), (p2_w, p2_b) = prenet
    a_ih, a_hh, a_bx, a_bh = attention_rnn
    pj_w, pj_b = project
    m_w, m_b = (t.detach().to(F32) for t in proj_mel)
    stop_w, stop_b = (t.detach().to(F32) for t in stopnet)
    H, A, D, OW = a_hh.shape[1], query_w.shape[0], pj_w.shape[0], m_w.shape[0]
    if loc_u is None:
        loc_u = torch.zeros(2, 1, A, device=query_w.device)
    so = stop_w[0, D:]
    stop_w_eff = so @ m_w + stop_w[0, :D]
    stop_b_eff = stop_b + m_b @ so
    f32 = lambda t: t.detach().to(F32).contiguous()  # noqa: E731
    w = {
        "dtype": dtype,
        "dims": {"NQ": p1_w.shape[1], "NM": n_mels, "P1": p1_w.shape[0],
                 "P2": p2_w.shape[0], "H": H, "E": pj_w.shape[1] - H, "A": A,
                 "K": loc_u.shape[1], "D": D, "OW": OW},
        "p1_w": _rows(p1_w, dtype), "p1_b": f32(p1_b),
        "p2_w": _rows(p2_w, dtype), "p2_b": f32(p2_b),
        "a_wx": _rows(_interleave_gru(a_ih), dtype), "a_bx": f32(_interleave_gru(a_bx)),
        "a_wh": _rows(_interleave_gru(a_hh), dtype), "a_bh": f32(_interleave_gru(a_bh)),
        "q_w": _rows(query_w, dtype),
        "u": loc_u.detach().to(F32).to(dtype).contiguous(),
        "v_w": f32(v_w[0]), "v_b": float(v_b[0]),
        "pj_w": _rows(pj_w, dtype), "pj_b": f32(pj_b),
        "m_w": _rows(torch.cat([m_w, stop_w_eff[None]], 0), dtype),
        "m_b": f32(torch.cat([m_b, stop_b_eff])),
    }
    for i, (w_ih, w_hh, bx, bh) in enumerate(decoder_rnns, 1):
        w[f"d{i}_wx"] = _rows(_interleave_gru(w_ih), dtype)
        w[f"d{i}_bx"] = f32(_interleave_gru(bx))
        w[f"d{i}_wh"] = _rows(_interleave_gru(w_hh), dtype)
        w[f"d{i}_bh"] = f32(_interleave_gru(bh))
    return w


def _dims(w: dict, r: int):
    d = w["dims"]
    if d["NQ"] % d["NM"] or not 1 <= r * d["NM"] <= d["OW"]:
        raise ValueError(f"r={r} frames of {d['NM']} mels a step need 1 <= r <= r_init "
                         f"(the mel projection is {d['OW']} wide) and a queue of whole "
                         f"frames ({d['NQ']} values)")
    return d


def tacotron1_decode_plain(w: dict, enc_out, pinp, mask, *, r: int, max_steps: int,
                           norm: str = "sigmoid", thresh: float = 0.6,
                           prenet_dropout: bool = True, seed: int = 0, chunk: int = 50):
    """The decode in plain PyTorch ops, on any device: the reference the
    kernel is held against. Arguments as `tacotron1_decode`."""
    d = _dims(w, r)
    NQ, NM, P1, H, E, D, OW = (d[k] for k in ("NQ", "NM", "P1", "H", "E", "D", "OW"))
    rnd = (lambda x: x.to(BF16).float()) if w["dtype"] == BF16 else (lambda x: x)
    W = {k: v.float() for k, v in w.items() if isinstance(v, torch.Tensor)}
    B, T, _ = enc_out.shape
    dev = enc_out.device
    enc = rnd(enc_out.float())
    pinp = pinp.float()
    maskadd = torch.where(mask, 0.0, -1e9).to(F32)
    z = lambda *s: torch.zeros(*s, device=dev)  # noqa: E731
    ah, h1, h2, ctx = z(B, H), z(B, D), z(B, D), z(B, E)
    att, cum, queue, done = z(B, T), z(B, T), z(B, NQ), z(B)
    n_steps = -(-max_steps // chunk) * chunk
    out = torch.empty(n_steps, B, OW, device=dev)
    aligns = torch.empty(n_steps, B, T, device=dev)
    stops = torch.empty(n_steps, B, device=dev)

    def gru(pre, xs, h):
        n = sum(x.shape[1] for x in xs)
        gx = (rnd(torch.cat(xs, 1)) @ W[pre + "wx"][:, :n].T + W[pre + "bx"]).view(B, -1, 3)
        gh = (rnd(h) @ W[pre + "wh"][:, :h.shape[1]].T + W[pre + "bh"]).view(B, -1, 3)
        rg = torch.sigmoid(gx[..., 0] + gh[..., 0])
        zg = torch.sigmoid(gx[..., 1] + gh[..., 1])
        ng = torch.tanh(gx[..., 2] + rg * gh[..., 2])
        return (1.0 - zg) * ng + zg * h

    def dropout(x, key, salt):
        if not prenet_dropout:
            return x
        return torch.where(uniform(tuple(x.shape), key, salt, dev) < 0.5, 0.0, x * 2.0)

    def step(s):
        nonlocal ah, h1, h2, ctx, att, cum, queue, done
        key = step_key(seed, s)
        x = dropout(torch.relu(rnd(queue) @ W["p1_w"][:, :NQ].T + W["p1_b"]), key, 21)
        x = dropout(torch.relu(rnd(x) @ W["p2_w"][:, :P1].T + W["p2_b"]), key, 22)
        ah = gru("a_", [x, ctx], ah)
        ctx, align = attention_plain(ah, att, cum, W["q_w"][:, :H], W["u"], W["v_w"],
                                     w["v_b"], pinp, enc, maskadd, norm, rnd)
        xd = rnd(torch.cat([ah, ctx], 1)) @ W["pj_w"][:, :H + E].T + W["pj_b"]
        h1 = gru("d1_", [xd], h1)
        xd = xd + h1
        h2 = gru("d2_", [xd], h2)
        xd = xd + h2
        o = rnd(xd) @ W["m_w"][:, :D].T + W["m_b"]
        stop = torch.sigmoid(o[:, OW])
        dec = o[:, :OW] * (1.0 - done)[:, None]
        done = torch.maximum(done, (stop > thresh).to(F32))
        queue = torch.cat([queue, dec[:, :NM * r]], 1)[:, -NQ:]
        att, cum = align, cum + align
        out[s], aligns[s], stops[s] = dec, align, stop

    ran = _drive(n_steps, chunk, step, lambda s: bool(done.min() > 0))
    return _finish(out, aligns, stops, ran, max_steps, thresh)


_P, _I, _U, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_uint, ctypes.c_float
_ARGTYPES = {
    "taco1_prenet": [_P, _I, _P, _P, _I, _I, _P, _P, _I, _I, _P, _I, _U, _U, _I, _P],
    "taco1_gru": [_P, _P, _I, _P, _P, _I, _P, _I, _P, _I, _P, _I, _P, _P, _I, _P],
    "taco1_linear": [_P, _P, _I, _P, _I, _P, _I, _P, _I, _I, _P],
    "taco1_attention": [_P, _P, _I, _I, _P, _I, _P, _F, _P, _P, _P, _P, _P, _P, _P, _I, _I,
                        _I, _I, _I, _P],
    "taco1_mel": [_P, _P, _I, _P, _I, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _F, _P],
}


def _lib():
    lib = cuda_build.load("taco1_decode")
    for name, types in _ARGTYPES.items():
        fn = getattr(lib, name)
        fn.argtypes, fn.restype = types, ctypes.c_int
    return lib


def tacotron1_decode_cuda(w: dict, enc_out, pinp, mask, *, r: int, max_steps: int,
                          norm: str = "sigmoid", thresh: float = 0.6,
                          prenet_dropout: bool = True, seed: int = 0, chunk: int = 50):
    """The decode on the CUDA kernels: seven launches per step on the current
    stream (prenet, attention GRU, attention, projection, two residual GRUs,
    mel projection with the stop row and the queue roll), one host read of
    the done mask per chunk."""
    if enc_out.device.type != "cuda":
        raise ValueError("tacotron1_decode_cuda takes CUDA tensors")
    if w["dtype"] != BF16:
        raise ValueError("the decode kernel runs bf16 weights")
    if norm not in ("sigmoid", "softmax"):
        raise ValueError(f"unknown attention norm {norm!r}")
    d = _dims(w, r)
    NQ, NM, P1, P2, H, E, A, K, D, OW = (d[k] for k in ("NQ", "NM", "P1", "P2", "H", "E",
                                                         "A", "K", "D", "OW"))
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
    ah, h1, h2, done, queue = z(2, B, H), z(2, B, D), z(2, B, D), z(2, B), z(2, B, NQ)
    ctx, att, cum = z(B, E), z(B, T), z(B, T)
    xpre, xd0, xd1, xd2 = z(B, P2), z(B, D), z(B, D), z(B, D)
    n_steps = -(-max_steps // chunk) * chunk
    out = torch.empty(n_steps, B, OW, device=dev)
    aligns = torch.empty(n_steps, B, T, device=dev)
    stops = torch.empty(n_steps, B, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    p = {k: v.data_ptr() for k, v in w.items() if isinstance(v, torch.Tensor)}
    ld = {k: v.shape[1] for k, v in w.items() if isinstance(v, torch.Tensor) and v.dim() == 2}
    two = lambda t: [t[0].data_ptr(), t[1].data_ptr()]  # noqa: E731
    ahp, h1p, h2p, dnp, qp = two(ah), two(h1), two(h2), two(done), two(queue)
    out0, al0, st0 = out.data_ptr(), aligns.data_ptr(), stops.data_ptr()
    softmax, seed32 = int(norm == "softmax"), seed & 0xFFFFFFFF
    P = lambda t: t.data_ptr()  # noqa: E731

    def gru(pre, x0, n0, x1, n1, h_in, n_h, h_out, res):
        cuda_build.check(lib.taco1_gru(
            p[pre + "wx"], p[pre + "bx"], ld[pre + "wx"], p[pre + "wh"], p[pre + "bh"],
            ld[pre + "wh"], x0, n0, x1, n1, h_in, n_h, h_out, res, B, stream), "taco1_gru")

    def step(s):
        cur, nxt = s % 2, (s + 1) % 2
        cuda_build.check(lib.taco1_prenet(
            qp[cur], NQ, p["p1_w"], p["p1_b"], ld["p1_w"], P1, p["p2_w"], p["p2_b"],
            ld["p2_w"], P2, P(xpre), B, seed32, s, int(prenet_dropout), stream),
            "taco1_prenet")
        gru("a_", P(xpre), P2, P(ctx), E, ahp[cur], H, ahp[nxt], None)
        cuda_build.check(lib.taco1_attention(
            ahp[nxt], p["q_w"], ld["q_w"], H, p["u"], K, p["v_w"], w["v_b"], P(pinp),
            P(maskadd), P(enc), P(att), P(cum), P(ctx), al0 + 4 * s * B * T, B, T, A, E,
            softmax, stream), "taco1_attention")
        cuda_build.check(lib.taco1_linear(
            p["pj_w"], p["pj_b"], ld["pj_w"], ahp[nxt], H, P(ctx), E, P(xd0), B, D, stream),
            "taco1_linear")
        gru("d1_", P(xd0), D, None, 0, h1p[cur], D, h1p[nxt], P(xd1))
        gru("d2_", P(xd1), D, None, 0, h2p[cur], D, h2p[nxt], P(xd2))
        cuda_build.check(lib.taco1_mel(
            p["m_w"], p["m_b"], ld["m_w"], P(xd2), D, dnp[cur], dnp[nxt],
            out0 + 4 * s * B * OW, st0 + 4 * s * B, qp[cur], qp[nxt], NQ, B, OW, NM * r,
            thresh, stream), "taco1_mel")
        tacotron1_decode_cuda.launches += 7

    ran = _drive(n_steps, chunk, step, lambda s: bool(done[s % 2].min() > 0))
    return _finish(out, aligns, stops, ran, max_steps, thresh)


tacotron1_decode_cuda.launches = 0


def tacotron1_decode(w: dict, enc_out, pinp, mask, *, r: int, max_steps: int,
                     norm: str = "sigmoid", thresh: float = 0.6,
                     prenet_dropout: bool = True, seed: int = 0, chunk: int = 50):
    """Free-running Tacotron(1) decode. w: `prepare_weights` output on the
    inputs' device; enc_out [B, T, E] encoder memory; pinp [B, T, A] = W_k m;
    mask [B, T] bool. Returns (frames [max_steps, B, n_mels * r_init],
    alignments [max_steps, B, T], stop probabilities [max_steps, B], lengths
    [B] in r-groups). CPU tensors run the plain version, CUDA tensors the
    kernel."""
    fn = tacotron1_decode_plain if enc_out.device.type == "cpu" else tacotron1_decode_cuda
    return fn(w, enc_out, pinp, mask, r=r, max_steps=max_steps, norm=norm, thresh=thresh,
              prenet_dropout=prenet_dropout, seed=seed, chunk=chunk)
