"""The port's teacher-forced decoder core (models/decoder_grad.py
`DecoderCore`: the training kernels' plain versions plus the hand-written
backward) against `jax.grad` through the JAX package's scan core
(`make_scan_core(...).plain`, plain autodiff of the same forward), dropout
off, measured as tests/test_taco2_train_kernel.py `_grad_check` measures.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from your_voice_tts_tpu.config import ModelConfig
from your_voice_tts_tpu.models.decoder_grad import make_scan_core
from your_voice_tts_tpu.models.tacotron2 import Decoder
from your_voice_tts_torch.models.decoder_grad import DecoderCore

torch.set_num_threads(1)

B, T_R, T_IN, E, P, H1, H2, A = 3, 7, 7, 16, 8, 12, 20, 10


def setup(norm, location, dtype):
    cfg = ModelConfig(r=2, prenet_dim=P, attention_rnn_dim=H1, decoder_rnn_dim=H2,
                      attention_dim=A, attention_location_filters=4,
                      attention_location_kernel_size=7, attention_norm=norm,
                      location_attn=location)
    dec = Decoder(E, 5, 2, cfg)
    p = dec.init(jax.random.PRNGKey(0))
    p_core = {k: p[k] for k in ("attention_rnn", "decoder_rnn", "attention")}
    rng = np.random.default_rng(1)
    x = {"prenet": rng.normal(size=(T_R, B, P)), "enc": rng.normal(size=(B, T_IN, E)),
         "pinp": 0.5 * rng.normal(size=(B, T_IN, A))}
    x = {k: np.asarray(v, np.float32) for k, v in x.items()}
    maskf = (np.arange(T_IN)[None] < np.array([T_IN, T_IN - 2, T_IN - 3])[:, None]
             ).astype(np.float32)
    return dec, p_core, x, maskf


def jax_grads(dec, p_core, x, maskf, jdt):
    core = make_scan_core(dec, use_dropout=False)
    keys = jnp.zeros((T_R, 2), jnp.uint32)

    def loss(p_core, pren, enc, pinp):
        dh, cx, al = core.plain(p_core, pren, enc, pinp, jnp.asarray(maskf), keys)
        return (jnp.sum(dh.astype(jnp.float32) ** 2)
                + 0.7 * jnp.sum(cx.astype(jnp.float32) ** 2) + 0.3 * jnp.sum(al ** 2))

    args = [jax.tree_util.tree_map(lambda a: a.astype(jdt), p_core)] + [
        jnp.asarray(x[k], jdt) for k in ("prenet", "enc", "pinp")]
    return jax.grad(loss, argnums=(0, 1, 2, 3))(*args)


def port_grads(p_core, x, maskf, dtype, norm, location):
    t = lambda a: torch.tensor(np.asarray(a, np.float32)).to(dtype)  # noqa: E731
    ar, dr, at = p_core["attention_rnn"], p_core["decoder_rnn"], p_core["attention"]
    weights = {"a_ih": t(ar["wx"]).T, "a_hh": t(ar["wh"]).T, "a_b": t(ar["b"]),
               "q_w": t(at["query"]["w"]).T,
               "conv_w": t(np.transpose(at["loc_conv"]["w"], (2, 1, 0))) if location else None,
               "dense_w": t(at["loc_dense"]["w"]).T if location else None,
               "v_w": t(at["v"]["w"]).T, "v_b": t(at["v"]["b"]),
               "d_ih": t(dr["wx"]).T, "d_hh": t(dr["wh"]).T, "d_b": t(dr["b"])}
    leaves = {k: v.contiguous().requires_grad_() for k, v in weights.items() if v is not None}
    ins = {k: t(x[k]).requires_grad_() for k in ("prenet", "enc", "pinp")}
    w = {k: leaves.get(k) for k in weights}
    dh, cx, al = DecoderCore.apply(ins["prenet"], ins["enc"], ins["pinp"],
                                   torch.from_numpy(maskf), None, None, norm, *w.values())
    loss = (dh.float().pow(2).sum() + 0.7 * cx.float().pow(2).sum() + 0.3 * al.pow(2).sum())
    names = list(leaves) + list(ins)
    grads = torch.autograd.grad(loss, [leaves.get(k, ins.get(k)) for k in names])
    return dict(zip(names, grads))


def to_port_layout(gj, location):
    """JAX gradient trees -> {port name: numpy array in the port's layout}."""
    gp, gpren, genc, gpinp = gj
    ar, dr, at = gp["attention_rnn"], gp["decoder_rnn"], gp["attention"]
    out = {"a_ih": ar["wx"].T, "a_hh": ar["wh"].T, "a_b": ar["b"], "q_w": at["query"]["w"].T,
           "v_w": at["v"]["w"].T, "v_b": at["v"]["b"], "d_ih": dr["wx"].T,
           "d_hh": dr["wh"].T, "d_b": dr["b"], "prenet": gpren, "enc": genc, "pinp": gpinp}
    if location:
        out["conv_w"] = jnp.transpose(at["loc_conv"]["w"], (2, 1, 0))
        out["dense_w"] = at["loc_dense"]["w"].T
    return {k: np.asarray(v, np.float64) for k, v in out.items()}


@pytest.mark.parametrize("norm,location,dtype,tol", [
    ("sigmoid", True, torch.float32, 2e-5),
    ("softmax", True, torch.float32, 2e-5),
    ("sigmoid", False, torch.float32, 2e-5),
    ("sigmoid", True, torch.bfloat16, 0.08),
])
def test_core_grads_match_jax_autodiff(norm, location, dtype, tol):
    """Every gradient leaf: max |port - jax| over max(max |jax|, 1e-2 of
    the largest gradient anywhere) below `tol` (2e-5 f32, 0.08 bf16: the
    JAX package's own kernel-vs-autodiff bounds)."""
    dec, p_core, x, maskf = setup(norm, location, dtype)
    jdt = jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float32
    ref = to_port_layout(jax_grads(dec, p_core, x, maskf, jdt), location)
    got = port_grads(p_core, x, maskf, dtype, norm, location)
    assert set(got) == set(ref)
    gscale = max(np.max(np.abs(v)) for v in ref.values())
    for k, r in ref.items():
        a = got[k].double().numpy()
        assert a.shape == r.shape, k
        rel = np.max(np.abs(a - r)) / max(np.max(np.abs(r)), 1e-2 * gscale)
        assert rel < tol, (k, rel)
