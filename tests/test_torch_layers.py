"""The port's layers against the JAX package's with shared weights (the
trained smoke checkpoint, so BatchNorm statistics and weights are real),
and the checkpoint bridge that carries those weights across without JAX."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from your_voice_tts_tpu.config import load_config as jax_load_config
from your_voice_tts_tpu.models import setup_model as jax_setup_model
from your_voice_tts_tpu.models.attention import AttentionState
from your_voice_tts_tpu.nn.rnn import LSTMCell as JaxLSTMCell
from your_voice_tts_tpu.text import symbols as jax_symbols
from your_voice_tts_tpu.train.checkpoint import load_checkpoint as jax_load_checkpoint
from your_voice_tts_torch.config import load_config
from your_voice_tts_torch.models import setup_model
from your_voice_tts_torch.nn.rnn import LSTMCell
from your_voice_tts_torch.text import symbols
from your_voice_tts_torch.train.checkpoint import (load_checkpoint, params_from_jax,
                                                   parse_keypath, read_checkpoint)

torch.set_num_threads(1)

CONFIG, CKPT = "configs/smoke_synthetic.json", "assets/bench_trained_smoke.npz"
TOL = 1e-5   # float32 on both sides; only the summation order differs


@pytest.fixture(scope="module")
def pair():
    jm = jax_setup_model(len(jax_symbols), 0, jax_load_config(CONFIG))
    v = jm.init(jax.random.PRNGKey(0))
    p, s, _, _ = jax_load_checkpoint(CKPT, params=v["params"], model_state=v["state"])
    pm = setup_model(len(symbols), load_config(CONFIG), device="cpu")
    load_checkpoint(pm, CKPT)
    return jm, p, s, pm


def test_symbol_table_matches_checkpoint(pair):
    assert symbols == list(jax_symbols)
    assert pair[3].embedding.weight.shape[0] == len(symbols)


def test_encoder_with_unequal_lengths(pair):
    jm, p, s, pm = pair
    rng = np.random.default_rng(0)
    text = rng.integers(1, len(symbols), (3, 16))
    lengths = np.array([16, 9, 3])
    x = jm.embedding(p["embedding"], jnp.asarray(text))
    ref, _ = jm.encoder(p["encoder"], s["encoder"], x, jnp.asarray(lengths), None, False)
    with torch.no_grad():
        got = pm.encoder(pm.embedding(torch.from_numpy(text)), torch.from_numpy(lengths))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=TOL)
    assert not got[2, 3:].any()


def test_postnet(pair):
    jm, p, s, pm = pair
    x = np.random.default_rng(1).uniform(-4, 4, (2, 30, 20)).astype(np.float32)
    ref, _ = jm.postnet(p["postnet"], s["postnet"], jnp.asarray(x), None, False)
    with torch.no_grad():
        got = pm.postnet(torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=TOL)


def test_prenet_without_dropout(pair):
    jm, p, s, pm = pair
    x = np.random.default_rng(2).uniform(-4, 4, (3, 20)).astype(np.float32)
    ref, _ = jm.decoder.prenet(p["decoder"]["prenet"], s["decoder"]["prenet"],
                               jnp.asarray(x), None, False)
    with torch.no_grad():
        got = pm.decoder.prenet(torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=TOL)


@pytest.mark.parametrize("norm", ["sigmoid", "softmax"])
def test_location_sensitive_attention(pair, norm):
    jm, p, s, pm = pair
    ja, pa = jm.decoder.attention, pm.decoder.attention
    ja.norm, pa.norm = norm, norm
    try:
        rng = np.random.default_rng(3)
        B, T = 3, 11
        q = rng.standard_normal((B, 48)).astype(np.float32)
        enc = rng.standard_normal((B, T, 32)).astype(np.float32)
        att = rng.dirichlet(np.ones(T), B).astype(np.float32)
        cum = (att + rng.dirichlet(np.ones(T), B)).astype(np.float32)
        mask = np.arange(T)[None] < np.array([11, 8, 4])[:, None]
        pa_ = p["decoder"]["attention"]
        pinp = ja.preprocess_inputs(pa_, jnp.asarray(enc))
        st = AttentionState(jnp.asarray(att), jnp.asarray(cum), jnp.zeros((B, T)),
                            jnp.zeros((B,), jnp.int32), jnp.zeros((B, 1)))
        _, ref_ctx, ref_al = ja(pa_, jnp.asarray(q), jnp.asarray(enc), pinp, st,
                                mask=jnp.asarray(mask))
        with torch.no_grad():
            enc_t = torch.from_numpy(enc)
            state = pa.init_state(B, T, "cpu")._replace(attention=torch.from_numpy(att),
                                                         attention_cum=torch.from_numpy(cum))
            _, ctx, al = pa(torch.from_numpy(q), enc_t, pa.preprocess_inputs(enc_t), state,
                            torch.from_numpy(mask))
    finally:
        ja.norm, pa.norm = "sigmoid", "sigmoid"
    np.testing.assert_allclose(al.numpy(), np.asarray(ref_al), atol=TOL)
    np.testing.assert_allclose(ctx.numpy(), np.asarray(ref_ctx), atol=TOL)


def test_lstm_cell_gate_order():
    cell = JaxLSTMCell(6, 5)
    p = cell.init(jax.random.PRNGKey(4))
    rng = np.random.default_rng(4)
    x, h, c = (rng.standard_normal((2, n)).astype(np.float32) for n in (6, 5, 5))
    (ref_h, ref_c), _ = cell(p, (jnp.asarray(h), jnp.asarray(c)), jnp.asarray(x))
    port = LSTMCell(6, 5)
    port.load_state_dict({"weight_ih": torch.from_numpy(np.asarray(p["wx"]).T.copy()),
                          "weight_hh": torch.from_numpy(np.asarray(p["wh"]).T.copy()),
                          "bias": torch.from_numpy(np.asarray(p["b"]).copy())})
    with torch.no_grad():
        got_h, got_c = port(torch.from_numpy(x), (torch.from_numpy(h), torch.from_numpy(c)))
    np.testing.assert_allclose(got_h.numpy(), np.asarray(ref_h), atol=TOL)
    np.testing.assert_allclose(got_c.numpy(), np.asarray(ref_c), atol=TOL)


def _leaves(tree, prefix=()):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, prefix + (k,))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _leaves(v, prefix + (i,))
    else:
        yield prefix, np.asarray(tree)


def test_checkpoint_reader_is_leaf_exact(pair):
    """The port's own reader (no JAX) gives every leaf the JAX loader
    returns, bit for bit, and params_from_jax lands each one in the model
    in torch's layout."""
    _, p, s, pm = pair
    params, state, meta = read_checkpoint(CKPT)
    assert meta["r"] == 2
    ours = dict(_leaves(params)) | {("state",) + k: v for k, v in _leaves(state)}
    theirs = dict(_leaves(p)) | {("state",) + k: v for k, v in _leaves(s)}
    assert ours.keys() == theirs.keys()
    for k in theirs:
        np.testing.assert_array_equal(ours[k], theirs[k])
    sd = pm.state_dict()
    assert params_from_jax(params, state).keys() == sd.keys()
    enc = p["encoder"]
    np.testing.assert_array_equal(sd["encoder.lstm.weight_ih_l0_reverse"].numpy(),
                                  np.asarray(enc["lstm_bwd"]["wx"]).T)
    np.testing.assert_array_equal(sd["encoder.blocks.1.conv.weight"].numpy(),
                                  np.asarray(enc["blocks"][1]["conv"]["w"]).transpose(2, 1, 0))
    np.testing.assert_array_equal(sd["decoder.attention.loc_dense.weight"].numpy(),
                                  np.asarray(p["decoder"]["attention"]["loc_dense"]["w"]).T)
    np.testing.assert_array_equal(sd["postnet.blocks.4.bn.running_var"].numpy(),
                                  np.asarray(s["postnet"]["blocks"][4]["bn"]["var"]))
    assert not sd["encoder.lstm.bias_hh_l0"].any()


@pytest.mark.parametrize("key,parts", [
    ("['decoder']['attention_rnn']['wx']", ["decoder", "attention_rnn", "wx"]),
    ("['blocks'][0]['bn']['mean']", ["blocks", 0, "bn", "mean"]),
])
def test_parse_keypath(key, parts):
    assert parse_keypath(key) == parts


def test_parse_keypath_rejects_malformed():
    with pytest.raises(ValueError):
        parse_keypath("['a']x['b']")
