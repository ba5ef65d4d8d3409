"""The port's Global Style Tokens against the JAX package on the CPU: the
reference encoder (n_mels 80, odd and even lengths, with and without
style_len, BatchNorm running statistics away from (0, 1)), the style token
layer, the whole GST, a GST Tacotron2 with and without a speaker table
through `inference` against the JAX kernel route (the Pallas decode in
interpret mode), the strict load of a JAX-saved GST checkpoint and its way
back, the warning of a GST model used without a style reference, bf16
serving, and GST training in the teacher-forced pass (Tacotron(1)'s is
refused).

Weights come from the JAX `init` through the checkpoint bridge; inputs are
made with numpy from a seed and handed to both sides. Tolerances: the GST
modules 1e-5 in float32 (sum order only); the Tacotron2 inference as the
attention-variant test holds its kernel route: frames 5e-3, alignments and
stop probabilities 2e-3 (a bf16 decode on both sides), lengths exact.
"""

import dataclasses
import functools
import logging

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from your_voice_tts_tpu.config import GSTConfig as JaxGSTConfig
from your_voice_tts_tpu.config import ModelConfig as JaxModelConfig
from your_voice_tts_tpu.models.gst import GST as JaxGST
from your_voice_tts_tpu.models.gst import ReferenceEncoder as JaxReferenceEncoder
from your_voice_tts_tpu.models.gst import StyleTokenLayer as JaxStyleTokenLayer
from your_voice_tts_tpu.models.tacotron2 import Tacotron2 as JaxTacotron2
from your_voice_tts_tpu.train.checkpoint import _flatten
from your_voice_tts_tpu.train.checkpoint import save_checkpoint as jax_save_checkpoint
from your_voice_tts_torch.config import GSTConfig, ModelConfig
from your_voice_tts_torch.models.gst import GST, ReferenceEncoder, StyleTokenLayer
from your_voice_tts_torch.models.tacotron2 import Tacotron2
from your_voice_tts_torch.train.checkpoint import (jax_layouts, load_checkpoint,
                                                   params_from_jax, params_to_jax)

torch.set_num_threads(1)

GST_TOL = 1e-5
FRAME_TOL, ALIGN_TOL = 5e-3, 2e-3


def np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def randomize_bn_state(state, seed):
    """Running statistics away from (0, 1) in every {mean, var} leaf pair."""
    rng = np.random.default_rng(seed)

    def walk(node):
        if isinstance(node, dict):
            if set(node) == {"mean", "var"}:
                n = np.asarray(node["mean"]).shape
                node["mean"] = jnp.asarray(0.3 * rng.standard_normal(n), jnp.float32)
                node["var"] = jnp.asarray(np.exp(0.4 * rng.standard_normal(n)), jnp.float32)
            else:
                for v in node.values():
                    walk(v)
        elif isinstance(node, list):
            for v in node:
                walk(v)
    walk(state)
    return state


def load_into(port, params, state, prefix):
    """`params_from_jax` of a sub-tree (the JAX module's own params/state)
    into a port module: the tree goes under `prefix`, as in a model."""
    layouts = {f"{prefix}.{k}": v for k, v in jax_layouts(port).items()}
    sd = params_from_jax({prefix: np_tree(params)}, {prefix: np_tree(state)}, layouts)
    port.load_state_dict({k[len(prefix) + 1:]: v for k, v in sd.items()}, strict=True)
    return port.eval()


@pytest.fixture(scope="module")
def ref_encoder():
    jm = JaxReferenceEncoder(80, 128)
    p = jm.init(jax.random.PRNGKey(0))
    st = randomize_bn_state(jm.init_state(), 1)
    return jm, p, st, load_into(ReferenceEncoder(80, 128), p, st, "ref")


@pytest.mark.parametrize("T", [37, 64])
@pytest.mark.parametrize("with_len", [False, True])
def test_reference_encoder_matches_jax(ref_encoder, T, with_len):
    """Odd and even lengths through the six halvings; style_len picks each
    row's last real step (rows of T, T - 9 and 5 frames)."""
    jm, p, st, port = ref_encoder
    mel = np.random.default_rng(T).standard_normal((3, T, 80)).astype(np.float32)
    lens = np.array([T, T - 9, 5]) if with_len else None
    ref, _ = jm(p, st, jnp.asarray(mel), style_len=None if lens is None else jnp.asarray(lens))
    with torch.no_grad():
        got = port(torch.from_numpy(mel), None if lens is None else torch.from_numpy(lens))
    assert got.shape == (3, 128)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=GST_TOL)


def test_reference_encoder_reads_frequency_major(ref_encoder):
    """The GRU's input is [B, T, F * C] with C minor, as the reference's
    NHWC flatten: a GRU input column the reference reads from (f, c) is the
    port's column f * C + c. Permuting the GRU's input weights changes the
    port's output away from the JAX package's (the check has teeth). A
    port of its own, on the shared JAX weights, takes the permutation."""
    jm, p, st, _ = ref_encoder
    port = load_into(ReferenceEncoder(80, 128), p, st, "ref")
    mel = np.random.default_rng(3).standard_normal((3, 37, 80)).astype(np.float32)
    ref = np.asarray(jm(p, st, jnp.asarray(mel))[0])
    with torch.no_grad():
        np.testing.assert_allclose(port(torch.from_numpy(mel)).numpy(), ref, atol=GST_TOL)
        w = port.gru.weight_ih_l0
        F, C = 2, 128
        w.copy_(w.view(-1, F, C).transpose(1, 2).reshape(w.shape))
        assert np.abs(port(torch.from_numpy(mel)).numpy() - ref).max() > 1e-3


def test_style_token_layer_matches_jax():
    jm = JaxStyleTokenLayer(128, 10, 256, 4)
    p = jm.init(jax.random.PRNGKey(4))
    port = load_into(StyleTokenLayer(128, 10, 256, 4), p, {}, "style")
    q = np.random.default_rng(5).standard_normal((6, 128)).astype(np.float32)
    ref = np.asarray(jm(p, jnp.asarray(q)))
    with torch.no_grad():
        got = port(torch.from_numpy(q)).numpy()
    assert got.shape == (6, 256)
    np.testing.assert_allclose(got, ref, atol=GST_TOL)


@pytest.mark.parametrize("heads,tokens,dim", [(4, 10, 256), (2, 5, 64)])
def test_gst_matches_jax(heads, tokens, dim):
    jcfg = JaxGSTConfig(gst_embedding_dim=dim, gst_num_heads=heads, gst_style_tokens=tokens)
    jm = JaxGST(80, 96, jcfg)
    p = jm.init(jax.random.PRNGKey(heads))
    st = randomize_bn_state(jm.init_state(), heads)
    port = load_into(GST(80, 96, GSTConfig(**dataclasses.asdict(jcfg))), p, st, "gst")
    mel = np.random.default_rng(6).standard_normal((3, 51, 80)).astype(np.float32)
    lens = np.array([51, 30, 12])
    ref, _ = jm(p, st, jnp.asarray(mel), style_len=jnp.asarray(lens))
    with torch.no_grad():
        got = port(torch.from_numpy(mel), torch.from_numpy(lens)).numpy()
    assert got.shape == (3, 96)
    np.testing.assert_allclose(got, np.asarray(ref), atol=GST_TOL)


# ------------------------------------------------------------ GST Tacotron2

N_MELS, CHARS, B, T = 80, 30, 3, 11
SMALL = dict(r=2, embedding_dim=32, encoder_dim=32, decoder_rnn_dim=48,
             attention_rnn_dim=48, attention_dim=24, attention_location_filters=8,
             attention_location_kernel_size=15, prenet_dim=24, postnet_dim=32,
             max_decoder_steps=6, prenet_dropout=False)
SMALL_GST = dict(gst_embedding_dim=32, gst_num_heads=4, gst_style_tokens=6)


@functools.cache
def gst_models(num_speakers=0, seed=0):
    """(JAX GST Tacotron2 and its variables, the port's with the same
    weights): 80 mels (the reference encoder's width), the stopnet bias at
    -10, so no row stops before max_decoder_steps. Built once a module, as
    the tests share them; a test that leaves a model in training mode puts
    it back."""
    jm = JaxTacotron2(CHARS, JaxModelConfig(**SMALL), n_mels=N_MELS, num_speakers=num_speakers,
                      use_gst=True, gst_cfg=JaxGSTConfig(**SMALL_GST))
    v = jm.init(jax.random.PRNGKey(seed))
    randomize_bn_state(v["state"], seed + 1)
    stop = v["params"]["decoder"]["stopnet"]
    stop["b"] = jnp.full_like(stop["b"], -10.0)
    pm = Tacotron2(CHARS, ModelConfig(**SMALL), n_mels=N_MELS, device="cpu",
                   num_speakers=num_speakers, use_gst=True, gst_cfg=GSTConfig(**SMALL_GST))
    pm.load_state_dict(params_from_jax(np_tree(v["params"]), np_tree(v["state"]),
                                       jax_layouts(pm)), strict=True)
    return jm, v, pm


def inputs(seed=0, style_T=43):
    rng = np.random.default_rng(seed)
    text = rng.integers(1, CHARS, (B, T))
    lengths = np.array([11, 9, 6])
    style = rng.standard_normal((1, style_T, N_MELS)).astype(np.float32)
    return text, lengths, np.repeat(style, B, axis=0)


@pytest.mark.parametrize("num_speakers", [0, 4])
def test_gst_tacotron2_inference_matches_jax_kernel_route(num_speakers):
    """The style is added before the speaker table's 512 columns are
    concatenated (E = 32 + 512 with speakers): the whole inference against
    the JAX model with use_pallas=True under the Pallas interpreter."""
    jm, v, pm = gst_models(num_speakers)
    text, lengths, style = inputs(num_speakers)
    kw, ref_kw = {}, {}
    if num_speakers:
        ids = np.array([3, 0, 2])
        kw["speaker_ids"], ref_kw["speaker_ids"] = ids, jnp.asarray(ids, jnp.int32)
    with pltpu.force_tpu_interpret_mode():      # jitted: one compile, not one an op
        ref = jax.jit(lambda *a, **k: jm.inference(*a, use_pallas=True, **k))(
            v, jnp.asarray(text, jnp.int32), jnp.asarray(lengths, jnp.int32),
            style_mel=jnp.asarray(style), **ref_kw)
    got = pm.inference(text, lengths, style_mel=style, **kw)
    assert pm.decoder.decode_weights(torch.float32)["dims"]["E"] == 32 + 512 * bool(num_speakers)
    np.testing.assert_array_equal(got["mel_lengths"].numpy(), np.asarray(ref["mel_lengths"]))
    for key, tol in (("decoder_outputs", FRAME_TOL), ("alignments", ALIGN_TOL),
                     ("stop_probs", ALIGN_TOL)):
        np.testing.assert_allclose(got[key].numpy(), np.asarray(ref[key]), atol=tol,
                                   err_msg=key)


def test_style_goes_on_the_memory_before_the_speaker_columns():
    """`_condition`: the CBHG-width style sum, then the speaker vector:
    the speaker columns of the memory do not carry the style."""
    _, _, pm = gst_models(4)
    enc = torch.randn(B, T, 32, generator=torch.Generator().manual_seed(0))
    _, _, style = inputs()
    with torch.no_grad():
        got = pm._condition(enc, speaker_ids=[1, 2, 3], style_mel=style)
        s = pm.gst(torch.from_numpy(np.ascontiguousarray(style)))
    torch.testing.assert_close(got[..., :32], enc + s[:, None], rtol=0, atol=0)
    torch.testing.assert_close(got[..., 32:], pm.speaker_embedding.weight[[1, 2, 3]][:, None]
                               .expand(B, T, 512), rtol=0, atol=0)


def test_gst_checkpoint_loads_strictly_and_goes_back(tmp_path):
    """A JAX-saved GST Tacotron2 (with a speaker table) loads strictly,
    BatchNorm running statistics of the GST convolutions included; the
    port's writer gives back the JAX package's keys and values, and the
    JAX package reloads a port save."""
    from your_voice_tts_tpu.train.checkpoint import load_checkpoint as jax_load_checkpoint
    from your_voice_tts_torch.train.checkpoint import save_checkpoint

    jm, v, _ = gst_models(4, seed=3)
    path = jax_save_checkpoint(str(tmp_path / "gst.npz"), params=v["params"],
                               model_state=v["state"], opt_state={}, step=2, epoch=0, r=2)
    pm = Tacotron2(CHARS, ModelConfig(**SMALL), n_mels=N_MELS, device="cpu", num_speakers=4,
                   use_gst=True, gst_cfg=GSTConfig(**SMALL_GST), seed=5)
    assert load_checkpoint(pm, path)["r"] == 2
    assert pm.gst.ref.convs[2].bn.running_var.std() > 0.1
    params, state = params_to_jax(pm)
    assert "['gst']['ref']['convs'][0]['w']" in params
    assert "['gst']['ref']['convs'][0]['mean']" in state
    for ref, got in ((_flatten(v["params"]), params), (_flatten(v["state"]), state)):
        assert set(got) == set(ref)
        for k in ref:
            np.testing.assert_array_equal(got[k], ref[k], err_msg=k)
    out = save_checkpoint(str(tmp_path / "port.npz"), pm, step=4, epoch=1, r=2)
    fresh = jm.init(jax.random.PRNGKey(9))
    p2, s2, _, meta = jax_load_checkpoint(out, params=fresh["params"],
                                          model_state=fresh["state"])
    assert meta["step"] == 4
    for ref, got in ((_flatten(v["params"]), _flatten(p2)), (_flatten(v["state"]), _flatten(s2))):
        for k in ref:
            np.testing.assert_array_equal(np.asarray(got[k]), np.asarray(ref[k]), err_msg=k)


def test_missing_style_warns_and_skips_the_branch(caplog):
    """Without a style reference the memory is the encoder's own (the JAX
    package's rule), with its warning; inference still serves."""
    _, _, pm = gst_models()
    text, lengths, _ = inputs()
    enc = torch.randn(B, T, 32, generator=torch.Generator().manual_seed(1))
    with caplog.at_level(logging.WARNING, logger="your_voice_tts_torch.models.common"):
        assert pm._condition(enc) is enc
        got = pm.inference(text, lengths, max_decoder_steps=3)
    assert sum("WITHOUT a style reference" in r.getMessage() for r in caplog.records) == 2
    assert bool(torch.isfinite(got["postnet_outputs"]).all())


def test_gst_runs_bf16_at_bf16_compute():
    """inference_compute_dtype bf16: the style mel and a bf16 copy of the
    GST run where the reference casts them; outputs float32, near the
    float32 route."""
    from your_voice_tts_torch.models.common import compute_copy

    _, _, pm = gst_models()
    text, lengths, style = inputs()
    ref = pm.inference(text, lengths, style_mel=style, decode_dtype=torch.float32)
    got = pm.inference(text, lengths, style_mel=style, decode_dtype=torch.float32,
                       compute_dtype=torch.bfloat16)
    gst16 = compute_copy(pm, "gst", torch.bfloat16)
    assert gst16.ref.gru.weight_ih_l0.dtype == torch.bfloat16
    assert gst16.ref.convs[0].bn.running_mean.dtype == torch.bfloat16
    assert got["postnet_outputs"].dtype == torch.float32
    err = float((got["postnet_outputs"] - ref["postnet_outputs"]).abs().max())
    assert 0 < err < 0.1, err


# bf16 serving against the JAX package: test_torch_bf16.py's tolerances
BF16_FRAME_TOL, BF16_ALIGN_TOL, BF16_STOP_TOL = 0.0625, 0.05, 2e-3


def port_bf16_run(pm, monkeypatch, text, lengths, style, compute_dtype):
    """The port's inference at `compute_dtype` with the style mel `style`:
    its outputs, the memory its decode was given, and every module with
    weights that ran, with the dtype of its output."""
    import your_voice_tts_torch.models.tacotron2 as t2

    real, seen, ran = t2.tacotron2_decode, {}, []

    def spy(w, enc, pinp, mask, **kw):
        seen["enc"] = enc.clone()
        return real(w, enc, pinp, mask, **kw)

    def hook(module, args, out):
        out = out[0] if isinstance(out, tuple) else out
        if isinstance(out, torch.Tensor) and any(True for _ in module.parameters(False)):
            ran.append((module, out))

    with monkeypatch.context() as mp:
        mp.setattr(t2, "tacotron2_decode", spy)
        handle = torch.nn.modules.module.register_module_forward_hook(hook)
        try:
            out = pm.inference(text, lengths, style_mel=style, compute_dtype=compute_dtype)
        finally:
            handle.remove()
    return out, seen["enc"].float().numpy(), ran


def test_gst_bf16_inference_matches_jax(monkeypatch):
    """A GST Tacotron2 at compute_dtype bf16 against the JAX package's
    `inference(compute_dtype=jnp.bfloat16)` on its kernel route (the
    Pallas decode in interpret mode), the port given the style mel once
    ([1, T, n_mels], as `synthesis_batch` gives it) and the JAX package
    once a row: lengths exact, frames within one bf16 ulp at |x| < 8
    (0.0625), alignments 0.05, stop probabilities 2e-3. The style-shifted
    memory the decode is given is bf16, within 2% of its largest value of
    the JAX bf16 route's, and closer on average than the float32 route's
    (below 0.9 of its mean error). The style mel and the GST weights are
    cast where the reference casts them: every GST module with weights
    that ran (the convolutions, their BatchNorm, the GRU, the token layer,
    the attention's and the projection's Dense layers) holds bf16 weights
    and returns bf16, and the style the GST returned is within 2% of its
    largest value of the JAX bf16 GST's."""
    from your_voice_tts_tpu.models.common import cast_compute
    from your_voice_tts_torch.models.common import compute_copy

    jm, v, pm = gst_models()
    text, lengths, style = inputs()
    with pltpu.force_tpu_interpret_mode():
        ref = jax.jit(lambda *a, **k: jm.inference(*a, use_pallas=True,
                                                   compute_dtype=jnp.bfloat16, **k))(
            v, jnp.asarray(text, jnp.int32), jnp.asarray(lengths, jnp.int32),
            style_mel=jnp.asarray(style))
    got, mem, ran = port_bf16_run(pm, monkeypatch, text, lengths, style[:1], torch.bfloat16)
    np.testing.assert_array_equal(got["mel_lengths"].numpy(), np.asarray(ref["mel_lengths"]))
    for key, tol in (("decoder_outputs", BF16_FRAME_TOL), ("postnet_outputs", BF16_FRAME_TOL),
                     ("alignments", BF16_ALIGN_TOL), ("stop_probs", BF16_STOP_TOL)):
        assert got[key].dtype == torch.float32, key
        err = float(np.abs(got[key].numpy() - np.asarray(ref[key])).max())
        assert err <= tol, f"{key}: {err} > {tol}"

    def memory_and_style(v, t, n, style):
        """The JAX bf16 route's conditioned memory and its GST's style."""
        params, state, sm = cast_compute(v["params"], v["state"], jnp.bfloat16, style)
        x = jm.embedding(params["embedding"], t)
        enc, _ = jm.encoder(params["encoder"], state["encoder"], x, n, None, train=False)
        return (jm._condition(params, state, enc, style_mel=sm)[0],
                jm.gst(params["gst"], state["gst"], sm)[0])

    enc, ref_style = jax.jit(memory_and_style)(v, jnp.asarray(text, jnp.int32),
                                               jnp.asarray(lengths, jnp.int32), jnp.asarray(style))
    assert enc.dtype == ref_style.dtype == jnp.bfloat16
    ref_mem, ref_style = (np.asarray(a.astype(jnp.float32)) for a in (enc, ref_style))
    full = port_bf16_run(pm, monkeypatch, text, lengths, style[:1], None)[1]
    assert torch.equal(torch.from_numpy(mem).bfloat16().float(), torch.from_numpy(mem))
    assert np.abs(mem - ref_mem).max() <= 0.02 * np.abs(ref_mem).max()
    mean_bf16, mean_f32 = np.abs(mem - ref_mem).mean(), np.abs(full - ref_mem).mean()
    assert mean_bf16 < 0.9 * mean_f32, (mean_bf16, mean_f32)

    gst16 = compute_copy(pm, "gst", torch.bfloat16)
    in_gst = [(m, out) for m, out in ran if any(m is g for g in gst16.modules())]
    kinds = {type(m).__name__ for m, _ in in_gst}
    assert {"Conv2d", "BatchNorm1d", "GRU", "Linear", "StyleTokenLayer"} <= kinds, kinds
    for m, out in in_gst:
        assert out.dtype == torch.bfloat16, type(m).__name__
        assert all(t.dtype == torch.bfloat16 for t in m.parameters(False)), type(m).__name__
    style16 = next(out for m, out in in_gst if m is gst16.proj).float().numpy()
    assert style16.shape == (1, 32)
    assert np.abs(style16 - ref_style[:1]).max() <= 0.02 * np.abs(ref_style).max()


def test_gst_training_is_refused(tmp_path):
    """GST training is Tacotron2's now (tests/test_torch_train_speakers.py
    holds it against the JAX package), not yet Tacotron(1)'s: a GST
    Tacotron2's teacher-forced pass in training mode reads the style of the
    teacher mels and moves the reference encoder's running statistics; a
    GST Tacotron(1) config is refused before its data is read."""
    from your_voice_tts_torch.config import load_config
    from your_voice_tts_torch.train.trainer import Trainer

    _, _, pm = gst_models()
    text, lengths, _ = inputs()
    mels = torch.from_numpy(np.random.default_rng(2).standard_normal((B, 16, N_MELS))
                            .astype(np.float32))
    kept = {k: v.clone() for k, v in pm.named_buffers()}
    pm.train()
    try:
        out = pm(torch.from_numpy(text), torch.from_numpy(lengths), mels,
                 mel_lengths=torch.tensor([16, 12, 7]))
        grads = torch.autograd.grad(out["postnet_outputs"].square().mean(), pm.gst.style.tokens)
    finally:
        pm.eval()
        with torch.no_grad():
            for k, v in pm.named_buffers():
                v.copy_(kept[k])
    assert bool(torch.isfinite(out["postnet_outputs"]).all())
    assert float(grads[0].abs().max()) > 0
    assert not torch.equal(out["state"]["gst.ref.convs.0.bn.running_mean"],
                           kept["gst.ref.convs.0.bn.running_mean"])
    cfg = load_config("configs/smoke_synthetic.json")
    ds = dataclasses.replace(cfg.data.datasets[0], path=str(tmp_path / "missing"))
    cfg = dataclasses.replace(cfg, data=dataclasses.replace(cfg.data, datasets=(ds,)),
                              speakers=dataclasses.replace(cfg.speakers, use_gst=True),
                              model=dataclasses.replace(cfg.model, model="Tacotron"))
    with pytest.raises(NotImplementedError, match="Tacotron\\(1\\) training arrives"):
        Trainer(cfg, verbose=False, device="cpu")


def test_synthesize_cli_takes_a_style_wav(tmp_path, caplog):
    """bin/synthesize.py with a GST config and --style_wav: the style mel
    reaches the model (no missing-style warning), a wav is written."""
    import re

    from your_voice_tts_torch.audio import AudioProcessor
    from your_voice_tts_torch.bin import synthesize
    from your_voice_tts_torch.config import load_config
    from your_voice_tts_torch.models import setup_model
    from your_voice_tts_torch.text import symbols
    from your_voice_tts_torch.train.checkpoint import save_checkpoint

    text = open("configs/smoke_synthetic.json", encoding="utf-8").read()
    text = text.replace('"run_name": "smoke",', '"run_name": "smoke", "use_gst": true,')
    text = re.sub(r'"max_decoder_steps": \d+', '"max_decoder_steps": 6', text)
    cfg_path = tmp_path / "gst.json"
    cfg_path.write_text(text)
    cfg = load_config(str(cfg_path))
    assert cfg.speakers.use_gst
    ckpt = save_checkpoint(str(tmp_path / "gst.npz"), setup_model(len(symbols), cfg, device="cpu"),
                           step=1, epoch=0, r=cfg.model.r)
    ap = AudioProcessor(cfg.audio, "cpu")
    wav = np.random.default_rng(0).uniform(-0.5, 0.5, 4000).astype(np.float32)
    ap.save_wav(wav, str(tmp_path / "style.wav"))
    with caplog.at_level(logging.WARNING, logger="your_voice_tts_torch.models.common"):
        synthesize.main(["Hi there.", str(cfg_path), ckpt, str(tmp_path / "out"),
                         "--style_wav", str(tmp_path / "style.wav"), "--device", "cpu"])
    assert (tmp_path / "out" / "out_000.wav").exists()
    assert not any("WITHOUT a style reference" in r.getMessage() for r in caplog.records)
