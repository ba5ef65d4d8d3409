"""The port's conditioned Tacotron(1) against the JAX package on the CPU: a
speaker table, d-vectors and Global Style Tokens on the CBHG encoder's
outputs, then the decode (the plain version of kernel 8) against the JAX
`_encode` and the Pallas decode kernel run in interpret mode, at the small
widths of the JAX package's Tacotron(1) kernel tests; the strict load of a
JAX-saved conditioned checkpoint and its way back; the Synthesizer serving
a multi-speaker Tacotron(1); and kernel 8's launch plan at the full width
with E = 512 (the CBHG's 256 columns and 256 of a speaker), covering every
tile, pair and context chunk within the card's shared memory.

Weights come from the JAX `init` through the checkpoint bridge; inputs are
made with numpy from a seed. Tolerances: the encoder memory 1e-5 (float32,
sum order only); the decode as the Tacotron(1) decode tests hold it in bf16
against the Pallas kernel: frames 5e-3, alignments and stops 2e-3, lengths
exact.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from test_torch_taco1_layout import FULL, check_plan
from your_voice_tts_tpu.config import GSTConfig as JaxGSTConfig
from your_voice_tts_tpu.config import ModelConfig as JaxModelConfig
from your_voice_tts_tpu.models.tacotron import Tacotron as JaxTacotron
from your_voice_tts_tpu.train.checkpoint import _flatten
from your_voice_tts_tpu.train.checkpoint import save_checkpoint as jax_save_checkpoint
from your_voice_tts_torch.config import GSTConfig, ModelConfig
from your_voice_tts_torch.models.tacotron import Tacotron
from your_voice_tts_torch.ops.taco1_decode import SMEM_LIMIT, TILE, launch_plan
from your_voice_tts_torch.ops.taco2_decode import batch_slices
from your_voice_tts_torch.train.checkpoint import (jax_layouts, load_checkpoint,
                                                   params_from_jax, params_to_jax)

torch.set_num_threads(1)

N_MELS, N_FREQ, CHARS, B, T, STEPS = 20, 129, 30, 4, 12, 20
# tests/test_pallas_kernels.py:312-319 and :706-728
SMALL = dict(model="Tacotron", r=2, memory_size=5, tacotron_width=32, attention_dim=24,
             attention_location_filters=8, attention_location_kernel_size=15,
             max_decoder_steps=STEPS, prenet_dropout=False)
SMALL_GST = dict(gst_embedding_dim=32, gst_num_heads=4, gst_style_tokens=6)
ENC_TOL, FRAME_TOL, ALIGN_TOL = 1e-5, 5e-3, 2e-3
# (speakers, d-vector width (0: the model's table, tacotron_width wide), GST)
CASES = {"table": (4, 0, False), "dvec": (4, 16, False), "gst": (0, 0, True),
         "gst_dvec": (3, 16, True)}


def np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


@functools.cache
def models(case, seed=0):
    """(JAX Tacotron(1), its variables, the port's with the same weights);
    the stopnet bias at -10, so every row decodes all its steps. Built
    once a module, as the tests share them."""
    n, dim, gst = CASES[case]
    kw = dict(num_speakers=n, speaker_embedding_dim=dim, use_gst=gst)
    jm = JaxTacotron(CHARS, JaxModelConfig(**SMALL), n_mels=N_MELS, num_freq=N_FREQ,
                     gst_cfg=JaxGSTConfig(**SMALL_GST), **kw)
    v = jm.init(jax.random.PRNGKey(seed))
    stop = v["params"]["decoder"]["stopnet"]
    stop["b"] = jnp.full_like(stop["b"], -10.0)
    pm = Tacotron(CHARS, ModelConfig(**SMALL), n_mels=N_MELS, num_freq=N_FREQ, device="cpu",
                  gst_cfg=GSTConfig(**SMALL_GST), **kw)
    pm.load_state_dict(params_from_jax(np_tree(v["params"]), np_tree(v["state"]),
                                       jax_layouts(pm)), strict=True)
    return jm, v, pm


def conditioning(case, seed=1):
    """Text [B, T] (zero ids in each row's padding), lengths, and the
    case's keywords: speaker ids, unit d-vectors, a style mel."""
    n, dim, gst = CASES[case]
    rng = np.random.default_rng(seed)
    lengths = np.array([12, 10, 8, 7])
    text = rng.integers(1, CHARS, (B, T))
    text[np.arange(T)[None] >= lengths[:, None]] = 0
    kw = {}
    if n and not dim:
        kw["speaker_ids"] = np.array([3, 0, 2, 1])
    if dim:
        d = rng.standard_normal((B, dim)).astype(np.float32)
        kw["speaker_embeddings"] = d / np.linalg.norm(d, axis=-1, keepdims=True)
    if gst:
        kw["style_mel"] = np.repeat(
            rng.standard_normal((1, 29, N_MELS)).astype(np.float32), B, axis=0)
    return text, lengths, kw


@pytest.mark.parametrize("case", list(CASES))
def test_conditioned_encode_and_decode_match_jax_kernel(case):
    """`_encode` (style added to the CBHG outputs, then the speaker vector
    concatenated) against the JAX `_encode`; the port's decode on that
    memory against `TacotronDecoder.inference_pallas(interpret=True)` on
    the JAX memory, E = 32 + spk_dim."""
    jm, v, pm = models(case)
    text, lengths, kw = conditioning(case)
    p, s = v["params"], v["state"]
    jkw = {k: jnp.asarray(x, jnp.int32 if k == "speaker_ids" else jnp.float32)
           for k, x in kw.items()}
    ref_enc = np.asarray(jm._encode(p, s, jnp.asarray(text, jnp.int32), None, False,
                                    jkw.get("speaker_ids"), jkw.get("speaker_embeddings"),
                                    jkw.get("style_mel"))[0])
    with torch.no_grad():
        enc = pm._encode(torch.from_numpy(text), **kw)
    E = 32 + pm.spk_dim
    assert enc.shape == (B, T, E)
    assert pm.spk_dim == (CASES[case][1] or 32 * bool(CASES[case][0]))
    np.testing.assert_allclose(enc.numpy(), ref_enc, atol=ENC_TOL)
    with pltpu.force_tpu_interpret_mode():
        ref = jax.jit(lambda e, n: jm.decoder.inference_pallas(
            p["decoder"], e, n, STEPS, interpret=True, state=s["decoder"]))(
                jnp.asarray(ref_enc), jnp.asarray(lengths, jnp.int32))
    assert pm.decoder.decode_weights(torch.bfloat16)["dims"]["E"] == E
    got = pm.decoder.inference(torch.from_numpy(np.array(ref_enc)), torch.from_numpy(lengths),
                               STEPS, 2)
    np.testing.assert_array_equal(got[3].numpy(), np.asarray(ref[3]))
    for i, (name, tol) in enumerate((("frames", FRAME_TOL), ("alignments", ALIGN_TOL),
                                     ("stops", ALIGN_TOL))):
        np.testing.assert_allclose(got[i].numpy(), np.asarray(ref[i]), atol=tol, err_msg=name)


def test_conditioned_inference_needs_its_speakers():
    _, _, pm = models("table")
    text, lengths, kw = conditioning("table")
    out = pm.inference(text, lengths, max_decoder_steps=3, **kw)
    assert out["postnet_outputs"].shape == (B, 6, N_FREQ)
    with pytest.raises(ValueError, match="speaker_ids"):
        pm.inference(text, lengths, max_decoder_steps=3)
    _, _, pm = models("dvec")
    with pytest.raises(ValueError, match="expected"):
        pm.inference(text, lengths, max_decoder_steps=3,
                     speaker_embeddings=np.zeros((B, 15), np.float32))


@pytest.mark.parametrize("case", ["table", "gst_dvec"])
def test_conditioned_checkpoint_loads_strictly_and_goes_back(case, tmp_path):
    """A JAX-saved conditioned Tacotron(1) loads strictly (the table
    `speaker_embedding`, the `gst` subtree with its BatchNorm state); the
    port's writer gives back every key and value."""
    jm, v, _ = models(case, seed=4)
    path = jax_save_checkpoint(str(tmp_path / "t1.npz"), params=v["params"],
                               model_state=v["state"], opt_state={}, step=1, epoch=0, r=2)
    n, dim, gst = CASES[case]
    pm = Tacotron(CHARS, ModelConfig(**SMALL), n_mels=N_MELS, num_freq=N_FREQ, device="cpu",
                  num_speakers=n, speaker_embedding_dim=dim, use_gst=gst,
                  gst_cfg=GSTConfig(**SMALL_GST), seed=7)
    load_checkpoint(pm, path)
    params, state = params_to_jax(pm)
    assert ("['speaker_embedding']['table']" in params) == (case == "table")
    for ref, got in ((_flatten(v["params"]), params), (_flatten(v["state"]), state)):
        assert set(got) == set(ref)
        for k in ref:
            np.testing.assert_array_equal(got[k], ref[k], err_msg=k)


def test_synthesizer_serves_a_multi_speaker_tacotron(tmp_path):
    """Synthesizer with an id mapping builds the conditioned Tacotron(1)
    (a 32-wide table at the small width) and serves a batch over the
    speakers through tts_many, Griffin-Lim on the linear spectrogram."""
    import json

    from your_voice_tts_torch.config import load_config
    from your_voice_tts_torch.infer.synthesizer import Synthesizer

    spk = tmp_path / "speakers.json"
    spk.write_text(json.dumps({"ann": 0, "bob": 1, "cy": 2}))
    cfg = load_config("configs/smoke_synthetic.json")
    cfg = dataclasses.replace(cfg, model=dataclasses.replace(cfg.model, **dict(
        SMALL, max_decoder_steps=8)))
    synth = Synthesizer(cfg, speakers_json=str(spk), device="cpu")
    assert synth.model.spk_dim == 32 and synth.model.decoder.decode_weights(
        torch.float32)["dims"]["E"] == 64
    wavs = synth.tts_many(["Hi there.", "A cat sat. It slept.", "Go."], ["ann", 2, "bob"])
    assert len(wavs) == 3 and all(w.ndim == 1 and len(w) and np.isfinite(w).all()
                                  for w in wavs)


# ------------------------------------------------------------ kernel 8 at E = 512

E512 = dict(FULL, E=512)


@pytest.mark.parametrize("B", [1, 8, 11, 40])
@pytest.mark.parametrize("G,T", [(132, 160), (132, 13), (48, 29)])
def test_launch_plan_at_e512_covers_every_tile_pair_and_chunk(B, G, T):
    check_plan(E512, B, T, G)


def test_launch_plan_at_e512_full_width():
    """At B=8 and B=1, T=160 on 132 blocks: the context chunks (E16 / 8 = 64
    a row) and the resident a_x and projection matrices grow with E; one
    unit group a block still (the largest region an attention-GRU group's:
    3 tiles x (8 + 32 + 16) k-tiles), within the card's shared memory; the
    staged tile's stride stays 520 (E16 + 8, as 2 D16 + 8 at E = 256)."""
    for B in (8, 1):
        plan, base = launch_plan(E512, B, 160, 132), launch_plan(FULL, B, 160, 132)
        assert plan["E16"] == 512 and plan["XLD"] == 520
        assert plan["matrices"]["ax"][2] == 8 + 32 and plan["matrices"]["pj"][2] == 16 + 32
        assert base["RES"] == 3 * (24 + 16) and plan["RES"] == 3 * (40 + 16)
        assert plan["CPB"] == -(-(B * 64) // 132) and plan["ALN"] == min(B, 2)
        assert plan["smem_bytes"] <= SMEM_LIMIT and plan["PIN_SMEM"] == 1


@pytest.mark.parametrize("B,n", [(72, 1), (80, 2), (300, 5)])
def test_batch_slices_at_e512(B, n):
    """A batch past one launch's shared memory at E = 512 (72 rows at
    T=160, 96 at E = 256) runs as slices of whole tiles, each of which
    fits."""
    if n > 1:
        with pytest.raises(ValueError, match="shared memory"):
            launch_plan(E512, B, 160, 132)
    got = batch_slices(E512, B, 160, 132, plan=launch_plan)
    assert got[0][0] == 0 and got[-1][1] == B
    assert all(a[1] == b[0] for a, b in zip(got, got[1:]))
    for b0, b1 in got:
        assert b0 % TILE == 0
        launch_plan(E512, b1 - b0, 160, 132)
    assert len(got) == n
