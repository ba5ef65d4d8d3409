"""The plain PyTorch versions of the port's training-decoder kernels
(ops/taco2_train.py) against the JAX package's Pallas training kernels run
in interpret mode, at the small shapes of tests/test_taco2_train_kernel.py.

Inputs (prenet stack, encoder memory, processed inputs, masks, dropout
multipliers, cotangents) are made with numpy from a seed and handed to both
sides; the weights are one JAX decoder's, carried into the port's layouts.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from your_voice_tts_tpu.config import ModelConfig
from your_voice_tts_tpu.models.tacotron2 import Decoder
from your_voice_tts_tpu.ops.pallas.taco2_train import (taco2_train_bwd_pallas,
                                                       taco2_train_fwd_pallas)
from your_voice_tts_torch.ops.taco2_train import (prepare_train_weights,
                                                  taco2_train_bwd_plain,
                                                  taco2_train_fwd_plain)

torch.set_num_threads(1)

# 7 steps, B=3, T_in=7 (the JAX test's shapes); P=8, H1=12, H2=20, A=10
B, T_R, T_IN, E, P, H1, H2 = 3, 7, 7, 16, 8, 12, 20
FWD_NAMES = ("dech", "ctx", "align", "g_a", "g_d", "c_a", "c_d")
BWD_NAMES = ("d_g_a", "d_g_d", "d_ctx", "d_prenet", "d_e")


def jax_core(norm, location):
    cfg = ModelConfig(r=2, prenet_dim=P, attention_rnn_dim=H1, decoder_rnn_dim=H2,
                      attention_dim=10, attention_location_filters=4,
                      attention_location_kernel_size=7, attention_norm=norm,
                      location_attn=location)
    p = Decoder(E, 5, 2, cfg).init(jax.random.PRNGKey(0))
    return {k: p[k] for k in ("attention_rnn", "decoder_rnn", "attention")}


def port_weights(p_core, dtype):
    """The JAX decoder core's weights in the port's layouts and `dtype`."""
    t = lambda x: torch.from_numpy(np.asarray(x, np.float32)).to(dtype)  # noqa: E731
    ar, dr, at = p_core["attention_rnn"], p_core["decoder_rnn"], p_core["attention"]
    loc = "loc_conv" in at
    return prepare_train_weights(
        (t(ar["wx"]).T, t(ar["wh"]).T, t(ar["b"])), t(at["query"]["w"]).T,
        t(np.transpose(at["loc_conv"]["w"], (2, 1, 0))) if loc else None,
        t(at["loc_dense"]["w"]).T if loc else None, t(at["v"]["w"]).T, t(at["v"]["b"]),
        (t(dr["wx"]).T, t(dr["wh"]).T, t(dr["b"])))


def inputs(dropout, seed=1):
    rng = np.random.default_rng(seed)
    x = {"prenet": rng.normal(size=(T_R, B, P)), "enc": rng.normal(size=(B, T_IN, E)),
         "pinp": 0.5 * rng.normal(size=(B, T_IN, 10)),
         "maskf": (np.arange(T_IN)[None] < np.array([T_IN, T_IN - 2, T_IN - 3])[:, None])}
    if dropout:
        x["m_a"] = np.where(rng.random((T_R, B, H1)) < 0.9, 1 / 0.9, 0.0)
        x["m_d"] = np.where(rng.random((T_R, B, H2)) < 0.9, 1 / 0.9, 0.0)
    return {k: np.asarray(v, np.float32) for k, v in x.items()}


def both(x, dtype):
    """numpy -> (jax array, torch tensor) in dtype (the mask stays f32)."""
    jd = jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float32
    return ({k: jnp.asarray(v, jnp.float32 if k == "maskf" else jd) for k, v in x.items()},
            {k: torch.from_numpy(v).to(torch.float32 if k == "maskf" else dtype)
             for k, v in x.items()})


@functools.lru_cache(maxsize=None)
def case_fwd(norm, location, dropout, dtype):
    """run_fwd for one case, computed once for both tests of the case."""
    p_core = jax_core(norm, location)
    return (p_core,) + run_fwd(p_core, inputs(dropout), dtype, norm, location)


def run_fwd(p_core, x, dtype, norm, location):
    jx, tx = both(x, dtype)
    jp = jax.tree_util.tree_map(lambda a: a.astype(jx["prenet"].dtype), p_core)
    ref = taco2_train_fwd_pallas(jp, jx["prenet"], jx["enc"], jx["pinp"], jx["maskf"],
                                 jx.get("m_a"), jx.get("m_d"), norm=norm, loc_attn=location,
                                 chunk=4, interpret=True)
    got = taco2_train_fwd_plain(port_weights(p_core, dtype), tx["prenet"], tx["enc"],
                                tx["pinp"], tx["maskf"], tx.get("m_a"), tx.get("m_d"),
                                norm=norm)
    return jp, jx, tx, dict(zip(FWD_NAMES, ref)), got


def err(a, b):
    return float(np.max(np.abs(np.asarray(a, np.float32)
                               - b.float().numpy())))


# float32: the two sides differ only by sum order (the JAX kernel test's own
# 1e-5, tests/test_taco2_train_kernel.py:91); bf16: both round the same
# inputs at the same points, and a rare 1-ulp flip of a stored bf16 value
# (2^-8 relative) moves later steps by about that much
CASES = [("sigmoid", True, False, torch.float32), ("softmax", True, False, torch.float32),
         ("sigmoid", False, False, torch.float32), ("sigmoid", True, True, torch.float32),
         ("softmax", True, True, torch.bfloat16)]
TOL = {torch.float32: 1e-5, torch.bfloat16: 1e-2}


@pytest.mark.parametrize("norm,location,dropout,dtype", CASES)
def test_train_fwd_plain_matches_pallas(norm, location, dropout, dtype):
    _, _, _, _, ref, got = case_fwd(norm, location, dropout, dtype)
    for name in FWD_NAMES:
        assert got[name].dtype == (torch.float32 if name == "align" else dtype), name
        scale = max(1.0, float(np.max(np.abs(np.asarray(ref[name], np.float32)))))
        assert err(ref[name], got[name]) <= TOL[dtype] * scale, name


@pytest.mark.parametrize("norm,location,dropout,dtype", CASES)
def test_train_bwd_plain_matches_pallas(norm, location, dropout, dtype):
    """The same residuals (the JAX forward's) and seeded cotangents on both
    sides."""
    p_core, jp, jx, tx, fwd, _ = case_fwd(norm, location, dropout, dtype)
    rng = np.random.default_rng(7)
    cot = [rng.normal(size=s).astype(np.float32) for s in
           ((T_R, B, H2), (T_R, B, E), (T_R, B, T_IN))]
    shift = lambda a: jnp.concatenate([jnp.zeros_like(a[:1]), a[:-1]], 0)  # noqa: E731
    res = {k: fwd[k] for k in ("g_a", "g_d", "c_a", "c_d")}
    res.update(c_a_prev=shift(fwd["c_a"]), c_d_prev=shift(fwd["c_d"]),
               att_prev=shift(fwd["align"]), cum_prev=shift(jnp.cumsum(fwd["align"], 0)))
    jd = jx["prenet"].dtype
    ref = taco2_train_bwd_pallas(
        jp, res, (jnp.asarray(cot[0], jd), jnp.asarray(cot[1], jd), jnp.asarray(cot[2])),
        jx["enc"], jx["pinp"], jx["maskf"], jx.get("m_a"), jx.get("m_d"), P=P, norm=norm,
        loc_attn=location, chunk=4, interpret=True)
    t_res = {k: torch.from_numpy(np.asarray(v, np.float32)).to(
        torch.float32 if k in ("att_prev", "cum_prev") else dtype) for k, v in res.items()}
    got = taco2_train_bwd_plain(
        port_weights(p_core, dtype), t_res, torch.from_numpy(cot[0]).to(dtype),
        torch.from_numpy(cot[1]).to(dtype), torch.from_numpy(cot[2]), tx["enc"], tx["pinp"],
        tx["maskf"], tx.get("m_a"), tx.get("m_d"), norm=norm)
    for name, r in zip(BWD_NAMES, ref):
        scale = max(1.0, float(np.max(np.abs(np.asarray(r, np.float32)))))
        assert err(r, got[name]) <= TOL[dtype] * scale, name
