"""ParallelTTS in the port against the JAX package, on the CPU.

The JAX package's tests/test_parallel_tts.py widths (MCFG, 20 mels) for
five variants of the model (the shared encoder; the conv encoder with an
embedding projection; GST + the energy adaptor; d-vectors; a speaker
table), each JAX model's weights carried into the port through the
checkpoint bridge: the length regulator exactly, the training forward
(dropout off, BatchNorm on batch statistics) and inference (speed,
energy_scale) at 1e-4 with integer outputs exact, the loss and one
step's gradients at rel L2 1e-4, the duration helpers, the trained asset,
the Synthesizer with an injected Griffin-Lim phase, the server, a CPU
artifact against its program, `ClipAdam(if_finite=True)` against optax's
apply_if_finite, and both CLIs against the JAX CLIs on one synthetic
corpus, each tool's output read by the other side."""

import copy
import dataclasses
import functools
import json
import os
import threading
import urllib.request

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from your_voice_tts_tpu.config import AudioConfig as JaxAudioConfig
from your_voice_tts_tpu.config import Config as JaxConfig
from your_voice_tts_tpu.config import GSTConfig as JaxGSTConfig
from your_voice_tts_tpu.config import ModelConfig as JaxModelConfig
from your_voice_tts_tpu.config import SpeakerConfig as JaxSpeakerConfig
from your_voice_tts_tpu.config import load_config as jax_load_config
from your_voice_tts_tpu.models import parallel_tts as jpt
from your_voice_tts_tpu.models import setup_model as jax_setup_model
from your_voice_tts_tpu.text import symbols
from your_voice_tts_torch.bin.train_parallel import step_grads
from your_voice_tts_torch.config import AudioConfig, Config, GSTConfig, ModelConfig, SpeakerConfig
from your_voice_tts_torch.config import load_config
from your_voice_tts_torch.models import parallel_tts as ppt
from your_voice_tts_torch.models import setup_model
from your_voice_tts_torch.train.checkpoint import jax_layouts, params_from_jax

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MCFG = dict(embedding_dim=32, encoder_dim=32, postnet_dim=32, parallel_decoder_blocks=2,
            duration_predictor_dim=16, max_decoder_steps=64, r=1)
N_MELS = 20
SPK_DIM = 16
GST = dict(gst_embedding_dim=32, gst_num_heads=2, gst_style_tokens=4)
VARIANTS = {
    "shared": {},
    "conv": {"model": {"parallel_encoder": "conv", "embedding_dim": 24}},
    "gst_energy": {"model": {"parallel_energy_predictor": True}, "gst": True},
    "dvector": {"spk_dim": SPK_DIM},
    "table": {"num_speakers": 4},
}
ASSET, TEACHER = "assets/bench_trained_parallel.npz", "assets/bench_trained_smoke.npz"
SMOKE = "configs/smoke_synthetic.json"
TOL = 1e-4


def config(kind: str, variant: str):
    """The variant's config in the JAX package's classes or the port's."""
    A, M, S, G, C = ((JaxAudioConfig, JaxModelConfig, JaxSpeakerConfig, JaxGSTConfig, JaxConfig)
                     if kind == "jax" else
                     (AudioConfig, ModelConfig, SpeakerConfig, GSTConfig, Config))
    spec = VARIANTS[variant]
    spk = S(use_gst=True, gst=G(**GST)) if spec.get("gst") else S()
    return C(audio=A(num_mels=N_MELS),
             model=M(model="ParallelTTS", **dict(MCFG, **spec.get("model", {}))), speakers=spk)


def np_tree(tree):
    return jax.tree_util.tree_map(np.array, tree)


@functools.cache
def pair(variant: str):
    """(JAX model, its variables, the port model with those weights). The
    duration head's bias starts at 2, so that inference spreads tokens over
    several frames each (exp(2) - 1 ~ 6.4) and reaches the frame cap."""
    spec = VARIANTS[variant]
    n_spk, spk_dim = spec.get("num_speakers", 0), spec.get("spk_dim", 0)
    jm = jax_setup_model(len(symbols), n_spk, config("jax", variant),
                         speaker_embedding_dim=spk_dim)
    v = np_tree(jm.init(jax.random.PRNGKey(3)))
    v["params"]["duration"]["proj"]["b"] = np.full((1,), 2.0, np.float32)
    pm = setup_model(len(symbols), config("port", variant), device="cpu", num_speakers=n_spk,
                     speaker_embedding_dim=spk_dim)
    pm.load_state_dict(params_from_jax(v["params"], v["state"], jax_layouts(pm)), strict=True)
    return jm, v, pm


def inputs(variant: str, seed: int = 0):
    """A batch of three rows: text [3, 12] (lengths 12, 9, 5), durations
    with zeros on real tokens and a row past the 40-frame cap, mels
    [3, 40, 20] with lengths 40, 27, 13, and the variant's conditioning."""
    rng = np.random.default_rng(seed)
    B, T, M = 3, 12, 40
    tl = np.array([12, 9, 5])
    ml = np.array([40, 27, 13])
    text = np.zeros((B, T), np.int64)
    dur = np.zeros((B, T), np.int32)
    for i, n in enumerate(tl):
        text[i, :n] = rng.integers(1, len(symbols), n)
        dur[i, :n] = rng.integers(0, 6, n)
    dur[0, :12] = rng.integers(3, 7, 12)                # sums past M: cut at the cap
    mel = (rng.standard_normal((B, M, N_MELS)) * 0.5).astype(np.float32)
    cond = {}
    if VARIANTS[variant].get("spk_dim"):
        cond["speaker_embeddings"] = rng.standard_normal((B, SPK_DIM)).astype(np.float32)
    if VARIANTS[variant].get("num_speakers"):
        cond["speaker_ids"] = np.array([0, 3, 1])
    if VARIANTS[variant].get("gst"):
        cond["style_mel"], cond["style_len"] = mel, ml
    return dict(text=text, text_lengths=tl, durations=dur, mel=mel, mel_lengths=ml, M=M,
                cond=cond)


def jx(cond: dict) -> dict:
    return {k: jnp.asarray(v) for k, v in cond.items()}


def tx(cond: dict) -> dict:
    return {k: torch.as_tensor(v) for k, v in cond.items()}


def close(got, ref, what: str, tol: float = TOL):
    ref = np.asarray(ref)
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    assert got.shape == ref.shape, (what, got.shape, ref.shape)
    err = float(np.abs(got.astype(np.float64) - ref).max()) if ref.size else 0.0
    assert err <= tol, f"{what}: max abs {err:.3e} > {tol}"


def exact(got, ref, what: str):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    np.testing.assert_array_equal(got, np.asarray(ref), err_msg=what)


def frame_mask(mel_lengths, M: int):
    return np.arange(M)[None, :] < np.asarray(mel_lengths)[:, None]


def train_kwargs(variant: str, x: dict, teacher_energy: bool = True) -> dict:
    """The conditioning of a training pass, numpy: the variant's speaker
    input and GST style (the target mel), an energy model's teacher
    energies (the target's `frame_energy`) unless teacher_energy is off."""
    kw = dict(x["cond"])
    if teacher_energy and VARIANTS[variant].get("model", {}).get("parallel_energy_predictor"):
        kw["energies"] = np.array(jpt.frame_energy(
            jnp.asarray(x["mel"]), jnp.asarray(frame_mask(x["mel_lengths"], x["M"]))))
    return kw


@functools.cache
def jax_train_pass(variant: str, teacher_energy: bool = True):
    """The JAX training forward (train mode, no key: dropout off), its loss
    and `jax.value_and_grad`'s gradients on `inputs(variant)`, jitted:
    (loss parts, outputs with the alignments, gradients), numpy."""
    jm, v, _ = pair(variant)
    x = inputs(variant)
    args = [jnp.asarray(x[k]) for k in ("text", "text_lengths", "durations")]
    mel = jnp.asarray(x["mel"])
    kw = jx(train_kwargs(variant, x, teacher_energy))

    def loss(params):
        out = jm.forward({"params": params, "state": v["state"]}, *args, rng=None, train=True,
                         max_frames=x["M"], return_alignments=True, **kw)
        total, parts = jpt.ParallelTTSLoss()(out, mel, args[2], args[1])
        return total, (parts, out)

    (_, (parts, out)), grads = jax.jit(jax.value_and_grad(loss, has_aux=True))(v["params"])
    return np_tree(parts), np_tree(out), np_tree(grads)


def port_train_pass(variant: str, teacher_energy: bool = True):
    """The port's counterpart of `jax_train_pass` on a copy of the model:
    (loss parts, outputs, gradients of the trained parameters by name,
    the model)."""
    pm = copy.deepcopy(pair(variant)[2]).train()
    x = inputs(variant)
    args = [torch.from_numpy(x[k]) for k in ("text", "text_lengths", "durations")]
    out = pm(*args, max_frames=x["M"], return_alignments=True,
             **tx(train_kwargs(variant, x, teacher_energy)))
    total, parts = ppt.ParallelTTSLoss()(out, torch.from_numpy(x["mel"]), args[2], args[1])
    names = [n for n, p in pm.named_parameters() if p.requires_grad]
    grads = torch.autograd.grad(total, [pm.get_parameter(n) for n in names], allow_unused=True)
    return parts, out, {n: (torch.zeros_like(pm.get_parameter(n)) if g is None else g)
                        for n, g in zip(names, grads)}, pm


def test_length_regulate_matches_jax():
    """Frames, mask, token index and totals bit for bit, rows cut at the
    cap included (the JAX test's rows plus zero-duration tokens and a
    row of zeros)."""
    rng = np.random.default_rng(0)
    enc = rng.standard_normal((5, 5, 4)).astype(np.float32)
    dur = np.array([[3, 0, 2, 4, 1], [1, 1, 1, 1, 1], [8, 8, 8, 0, 0], [0, 0, 0, 0, 0],
                    [0, 5, 0, 0, 7]], np.int32)
    for M in (16, 7, 1):
        ref = jpt.length_regulate(jnp.asarray(enc), jnp.asarray(dur), M)
        got = ppt.length_regulate(torch.from_numpy(enc), torch.from_numpy(dur), M)
        for name, g, r in zip(("frames", "mask", "idx", "total"), got, ref):
            exact(g, r, f"{name} at M={M}")
        assert got[2].dtype == got[3].dtype == torch.int32


@pytest.mark.parametrize("variant", list(VARIANTS))
def test_forward_matches_jax(variant):
    """The training forward (train mode, dropout off, max_frames = 40, the
    alignments asked for; a GST model styled by its target, an energy model
    on the teacher energies and, a second pass, on its own prediction):
    every float output and the BatchNorm state after the pass at 1e-4,
    integer outputs exact. The shared model also in eval mode without
    max_frames, whose frame count is then the largest duration sum."""
    runs = [True, False] if pair(variant)[2].energy is not None else [True]
    for teacher_energy in runs:
        _, ref, _ = jax_train_pass(variant, teacher_energy)
        _, got, _, pm = port_train_pass(variant, teacher_energy)
        for k in ("decoder_outputs", "postnet_outputs", "log_durations", "energy_pred"):
            assert (k in got) == (k in ref), k
            if k in ref:
                close(got[k], ref[k], k)
        for k in ("frame_mask", "frame_token_idx", "mel_lengths", "alignments"):
            exact(got[k], ref[k], k)
        state = params_from_jax({}, ref["state"], jax_layouts(pm))
        assert set(state) <= set(got["state"])
        for k, t in state.items():
            close(got["state"][k], t, k)
    if variant != "shared":
        return
    jm, v, pm = pair(variant)
    x = inputs(variant)
    M = int(x["durations"].sum(1).max())
    ref = jax.jit(functools.partial(jm.forward, rng=None, train=False, max_frames=M))(
        v, *(jnp.asarray(x[k]) for k in ("text", "text_lengths", "durations")))
    got = pm(*(torch.from_numpy(x[k]) for k in ("text", "text_lengths", "durations")))
    assert got["postnet_outputs"].shape[1] == M
    close(got["postnet_outputs"], ref["postnet_outputs"], "eval postnet_outputs")
    exact(got["mel_lengths"], ref["mel_lengths"], "eval mel_lengths")


@pytest.mark.parametrize("variant", list(VARIANTS))
def test_inference_matches_jax(variant):
    """Inference at speed 1.3 and energy_scale 1.5 (which only an energy
    model reads), 48 frames: mels at 1e-4, durations, lengths and
    alignments exact, stop probabilities zero, the port's serving keywords
    changing nothing; the shared model also at speed 1 with the default
    frame cap, max_decoder_steps * r frames."""
    jm, v, pm = pair(variant)
    x = inputs(variant, seed=1)
    cond = {k: x["cond"][k] for k in ("speaker_ids", "speaker_embeddings", "style_mel")
            if k in x["cond"]}
    runs = [{"max_decoder_steps": 48, "speed": 1.3, "energy_scale": 1.5}]
    if variant == "shared":
        runs.append({})
    for kw in runs:
        ref = jax.jit(functools.partial(jm.inference, **kw))(
            v, jnp.asarray(x["text"]), jnp.asarray(x["text_lengths"]), **jx(cond))
        got = pm.inference(x["text"], x["text_lengths"], **cond, **kw, seed=7,
                           decode_dtype=torch.bfloat16, compute_dtype=torch.bfloat16)
        for k in ("decoder_outputs", "postnet_outputs"):
            assert got[k].dtype == torch.float32
            close(got[k], ref[k], k)
        for k in ("durations", "mel_lengths", "alignments", "stop_probs"):
            exact(got[k], ref[k], k)
        assert int(got["durations"].max()) > 1
        assert got["postnet_outputs"].shape[1] == kw.get("max_decoder_steps", 64)
    assert not pm.training


def test_energy_scale_runs_the_predictor_once():
    """At energy_scale != 1 the port runs the energy predictor once (the
    reference a second time, for an output it throws away), and the
    outputs equal the reference's (`test_inference_matches_jax`)."""
    _, _, pm = pair("gst_energy")
    x = inputs("gst_energy")
    calls = []
    hook = pm.energy.register_forward_hook(lambda *a: calls.append(1))
    try:
        pm.inference(x["text"], x["text_lengths"], energy_scale=1.5)
    finally:
        hook.remove()
    assert len(calls) == 1


def _ahead_of_bn(pm) -> set:
    """The conv biases right before a BatchNorm (the encoder's, the
    postnet's, the GST reference encoder's): their gradient is zero but
    for rounding, on either side."""
    return {f"{n}.conv.bias" for n, m in pm.named_modules()
            if hasattr(m, "conv") and hasattr(m, "bn")}


@pytest.mark.parametrize("variant", list(VARIANTS))
def test_loss_and_gradients_match_jax(variant):
    """One training step's loss parts (1e-5 relative) and gradients (rel L2
    1e-4 over all parameters, and for each but the conv biases ahead of
    BatchNorm, whose gradient is rounding noise), dropout off, against
    `jax.value_and_grad` of the JAX forward + loss. The trainer's own
    `bin/train_parallel.step_grads` (which passes no speaker ids, as the
    reference trainer does, and computes the teacher energies itself)
    gives the same gradients to rel L2 1e-6 over all parameters."""
    ref_parts, _, ref_grads = jax_train_pass(variant)
    parts, _, grads, pm = port_train_pass(variant)
    assert set(parts) == set(ref_parts)
    for k, r in ref_parts.items():
        assert abs(float(parts[k].detach()) - float(r)) <= 1e-5 * abs(float(r)), k
    names = list(grads)
    sd = params_from_jax(ref_grads, {}, jax_layouts(pm))
    ref = {n: sd[n].numpy() for n in names}
    got = {n: g.numpy() for n, g in grads.items()}
    flat = lambda d: np.concatenate([np.ravel(d[n]) for n in names])  # noqa: E731
    assert np.linalg.norm(flat(got) - flat(ref)) <= TOL * np.linalg.norm(flat(ref))
    noise = _ahead_of_bn(pm)
    for n in names:
        r = ref[n]
        if np.linalg.norm(r) == 0:
            assert np.linalg.norm(got[n]) == 0, n
        elif n not in noise:
            assert np.linalg.norm(got[n] - r) <= TOL * np.linalg.norm(r), n
    if variant == "table":
        return
    x = inputs(variant)
    b = {k: torch.as_tensor(x[k]) for k in ("text", "text_lengths", "mel", "mel_lengths",
                                             "durations")}
    if "speaker_embeddings" in x["cond"]:
        b["speaker_embeddings"] = torch.as_tensor(x["cond"]["speaker_embeddings"])
    _, trainer_grads = step_grads(copy.deepcopy(pair(variant)[2]), ppt.ParallelTTSLoss(), b)
    assert np.linalg.norm(flat({n: g.numpy() for n, g in zip(names, trainer_grads)})
                          - flat(got)) <= 1e-6 * np.linalg.norm(flat(got))


@pytest.mark.parametrize("case", range(6))
def test_duration_helpers_match_jax(case):
    """repair_row_durations (deficit, excess, rows longer than T, zeros),
    uniform_durations and durations_from_alignment (r 1-3, overshooting
    last groups, a degenerate alignment) against the JAX functions."""
    from your_voice_tts_torch.bin.extract_durations import durations_from_alignment
    from your_voice_tts_tpu.bin.extract_durations import (
        durations_from_alignment as jax_durations_from_alignment)

    rng = np.random.default_rng(case)
    T = int(rng.integers(2, 9))
    for _ in range(20):
        d = rng.integers(0, 6, int(rng.integers(1, T + 3)))
        mel_len = int(rng.integers(0, 40))
        exact(ppt.repair_row_durations(d, mel_len, T),
              jpt.repair_row_durations(d, mel_len, T), "repair_row_durations")
    tl = rng.integers(0, T + 1, 5)
    ml = rng.integers(0, 50, 5)
    got = ppt.uniform_durations(tl, ml, T)
    assert got.dtype == torch.int32
    exact(got, jpt.uniform_durations(jnp.asarray(tl), jnp.asarray(ml), T), "uniform_durations")
    r = case % 3 + 1
    for mel_len in (1, 7, 17, 30):
        steps = -(-mel_len // r) + int(rng.integers(0, 3))
        align = rng.random((steps, T)).astype(np.float32)
        if case == 5:
            align = np.zeros_like(align)
            align[:, T // 2] = 1.0
        n_tok = int(rng.integers(1, T + 1))
        exact(durations_from_alignment(align, n_tok, mel_len, r),
              jax_durations_from_alignment(align, n_tok, mel_len, r),
              "durations_from_alignment")


def asset_config(loader, **audio):
    """The asset's config: the smoke config with model ParallelTTS,
    max_decoder_steps 512, r 1 (and `audio` set in its audio group)."""
    cfg = loader(SMOKE)
    return dataclasses.replace(
        cfg, audio=dataclasses.replace(cfg.audio, **audio),
        model=dataclasses.replace(cfg.model, model="ParallelTTS", max_decoder_steps=512, r=1))


@pytest.fixture(scope="module")
def asset_synths():
    """(JAX Synthesizer, port Synthesizer) on the trained asset, Griffin-Lim
    at 0 iterations: the waveform is the inverse STFT of the magnitudes at
    the initial phase, so that the two agree to the DFT's rounding (the
    port's loop follows the TPU kernel's bf16 DFT, the JAX package's CPU
    route runs XLA's float32 loop; the loop itself is held against the
    Pallas kernel in tests/test_torch_export.py and
    tests/test_torch_gl_routes.py)."""
    from your_voice_tts_tpu.infer.synthesizer import Synthesizer as JaxSynthesizer
    from your_voice_tts_torch.infer.synthesizer import Synthesizer

    return (JaxSynthesizer(asset_config(jax_load_config, griffin_lim_iters=0), ASSET),
            Synthesizer(asset_config(load_config, griffin_lim_iters=0), ASSET, device="cpu"))


def test_trained_asset_matches_jax(asset_synths):
    """assets/bench_trained_parallel.npz through the port's bridge: the
    durations, lengths and alignments of three texts equal the JAX model's,
    the mels within 1e-4."""
    from your_voice_tts_torch.infer.synthesis import _pad_texts, text_to_seq

    jax_s, port = asset_synths
    assert port.model.r == 1
    texts = ["Hi there.", "The quick brown fox jumps over the lazy dog.",
             "A parallel model speaks every frame at once"]
    text, lengths = _pad_texts([text_to_seq(t, port.cfg) for t in texts])
    ref = jax.jit(jax_s.model.inference)(jax_s.variables, jnp.asarray(text, jnp.int32),
                                         jnp.asarray(lengths, jnp.int32))
    got = port.model.inference(text, lengths)
    for k in ("durations", "mel_lengths", "alignments"):
        exact(got[k], ref[k], k)
    for k in ("decoder_outputs", "postnet_outputs"):
        close(got[k], ref[k], k)
    assert 20 < int(got["mel_lengths"].min()) and int(got["mel_lengths"].max()) < 512


def test_synthesizer_matches_jax_with_an_injected_phase(asset_synths, monkeypatch):
    """`Synthesizer.tts` of two sentences on the asset against the JAX
    Synthesizer's, each side's Griffin-Lim phase replaced by the same draw
    (and no iterations, `asset_synths`): the same number of samples (each
    row cut to its mel_lengths, then to its endpoint, the sentences joined
    by 0.25 s of silence), the waveform within 5e-3 of its peak."""
    from your_voice_tts_torch import audio as port_audio
    from your_voice_tts_tpu.ops import dsp as jdsp

    jax_s, port = asset_synths

    def draw(shape):
        return np.random.default_rng(list(shape)).random(tuple(shape)).astype(np.float32)

    monkeypatch.setattr(port_audio.torch, "rand",
                        lambda shape, generator=None: torch.from_numpy(draw(shape)))
    monkeypatch.setattr(jdsp.jax.random, "uniform",
                        lambda key, shape, minval=0.0, maxval=1.0, **k:
                        jnp.asarray(draw(shape) * np.float32(maxval)))
    text = "The quick brown fox. It jumps over the dog!"
    ref, got = jax_s.tts(text), port.tts(text)
    assert got.shape == ref.shape and len(got) > 8000
    np.testing.assert_allclose(got, ref, atol=5e-3 * np.abs(ref).max())


def test_synthesize_cli_and_server_serve_the_asset(tmp_path):
    """bin/synthesize.py writes the asset's wav, and the HTTP server's
    /api/tts answers the bytes of `tts_to_wav_bytes` from a Synthesizer of
    the same seed; stream=1 answers one piece (no inference_truncated)."""
    import wave

    from your_voice_tts_torch.bin.synthesize import main
    from your_voice_tts_torch.infer.server import make_server
    from your_voice_tts_torch.infer.synthesizer import Synthesizer

    with open(os.path.join(ROOT, SMOKE), encoding="utf-8") as f:
        raw = "\n".join(line for line in f if not line.strip().startswith("//"))
    raw = raw.replace('"model": "Tacotron2"', '"model": "ParallelTTS"').replace(
        '"r": 2', '"r": 1').replace('"max_decoder_steps": 50', '"max_decoder_steps": 512')
    cfg_path = tmp_path / "parallel.json"
    cfg_path.write_text(raw)
    main(["Hi there. Go home.", str(cfg_path), ASSET, str(tmp_path / "out"), "--device", "cpu"])
    with wave.open(str(tmp_path / "out" / "out_000.wav")) as f:
        assert f.getframerate() == 8000 and f.getnframes() > 2000
    cfg = load_config(str(cfg_path))
    synth = Synthesizer(cfg, ASSET, device="cpu")
    want = Synthesizer(cfg, ASSET, device="cpu").tts_to_wav_bytes("Hi there.")
    srv = make_server(synth, host="127.0.0.1", port=0)
    threading.Thread(target=srv.serve_forever, daemon=True).start()
    try:
        base = f"http://127.0.0.1:{srv.server_address[1]}/api/tts?text=Hi%20there."
        with urllib.request.urlopen(base, timeout=120) as r:
            assert r.headers["Content-Type"] == "audio/wav"
            assert r.read() == want
    finally:
        srv.shutdown()
        srv.batcher.close()
        srv.server_close()
    assert len(list(synth.tts_streaming("One. Two."))) == 1


def test_cpu_artifact_matches_its_program_and_jax(tmp_path):
    """A conv-encoder ParallelTTS with the JAX model's weights exported on
    the CPU at (2, 16): the loaded artifact equals its unexported program
    (wav and lengths bit for bit), and the program's masked spectrogram
    equals the JAX model's inference with its tail at normalized silence
    (1e-4); the ids frontend and the manifest as the export writes them."""
    from your_voice_tts_torch.audio import AudioProcessor
    from your_voice_tts_torch.infer.export import (ExportedSynthesizer, export_serving,
                                                   make_serving_fn)

    jm, v, pm = pair("conv")
    cfg = config("port", "conv")
    cfg = dataclasses.replace(cfg, audio=dataclasses.replace(
        cfg.audio, fft_size=256, hop_length=64, win_length=256, sample_rate=8000,
        mel_fmax=None, griffin_lim_iters=4))
    ap = AudioProcessor(cfg.audio)
    manifest = export_serving(pm, cfg, ap, str(tmp_path), batch_sizes=(2,), text_buckets=(16,),
                              max_decoder_steps=40)
    assert manifest["r"] == 1 and manifest["max_decoder_steps"] == 40
    served = ExportedSynthesizer(str(tmp_path))
    program = make_serving_fn(pm, cfg, ap, max_decoder_steps=40)
    x = inputs("conv", seed=4)
    text, lens = x["text"][:2, :10], np.array([10, 7])
    text[1, 7:] = 0
    we, le = served(text, lens, seed=3)
    pad = np.zeros((2, 16), np.int64)
    pad[:, :10] = text
    with torch.no_grad():
        wl, ll = program(torch.from_numpy(pad), torch.from_numpy(lens), torch.tensor([3]))
        spec, ml = program.spectrogram(torch.from_numpy(pad), torch.from_numpy(lens),
                                       torch.tensor([3]))
    exact(we, wl, "wav")
    exact(le, ll, "mel_lengths")
    ref = jax.jit(functools.partial(jm.inference, max_decoder_steps=40))(
        v, jnp.asarray(pad), jnp.asarray(lens))
    exact(ml, ref["mel_lengths"], "lengths")
    fill = float(program.fill)
    want = np.where(frame_mask(ref["mel_lengths"], 40)[..., None],
                    np.asarray(ref["postnet_outputs"]), fill)
    close(spec, want, "spectrogram")
    wavs = served.tts_many(["Hi there.", "Go."])
    assert all(len(w) > 0 and len(w) % 64 == 0 and np.isfinite(w).all() for w in wavs)


def test_clip_adam_if_finite_matches_optax():
    """`ClipAdam(if_finite=True)` against optax.apply_if_finite(chain(
    clip_by_global_norm(1), adam(1e-2)), 10,000) over six steps, the third
    and fourth with a NaN or an inf gradient: the parameters, moments and
    count at 1e-6 after each step, the counters exact, the rejected steps
    leaving the parameters and the Adam state as they were, bit for bit."""
    import optax

    from your_voice_tts_torch.train.optim import ClipAdam

    rng = np.random.default_rng(0)
    shapes = [(3, 4), (5,)]
    p0 = [rng.standard_normal(s).astype(np.float32) for s in shapes]
    params = [torch.tensor(p) for p in p0]
    adam = ClipAdam(params, 1e-2, 1.0, if_finite=True)
    opt = optax.apply_if_finite(optax.chain(optax.clip_by_global_norm(1.0), optax.adam(1e-2)),
                                max_consecutive_errors=10_000)
    jp = [jnp.asarray(p) for p in p0]
    state = opt.init(jp)
    for step in range(6):
        g = [rng.standard_normal(s).astype(np.float32) * 3 for s in shapes]
        if step == 2:
            g[0][1, 2] = np.nan
        if step == 3:
            g[1][0] = np.inf
        before = [p.clone() for p in params] + [m.clone() for m in adam.mu + adam.nu]
        adam.step([torch.from_numpy(x) for x in g])
        upd, state = opt.update([jnp.asarray(x) for x in g], state, jp)
        jp = optax.apply_updates(jp, upd)
        inner = state.inner_state[1][0]
        for a, b in zip(params + adam.mu + adam.nu, jp + list(inner.mu) + list(inner.nu)):
            close(a, b, f"step {step}", 1e-6)
        if step in (2, 3):
            for a, b in zip(params + adam.mu + adam.nu, before):
                assert torch.equal(a, b)
        assert int(adam.count) == int(inner.count)
        assert int(adam.notfinite_count) == int(state.notfinite_count)
        assert int(adam.total_notfinite) == int(state.total_notfinite)
        assert bool(adam.last_finite) == bool(state.last_finite)
    assert int(adam.count) == 4 and int(adam.total_notfinite) == 2


@pytest.fixture(scope="module")
def cli_runs(tmp_path_factory):
    """Both packages' CLIs on one 8-item synthetic corpus at 8 kHz:
    extract_durations with the trained Tacotron2 teacher; then
    train_parallel for two steps of batch 8 from the trained asset (its
    parameters, BatchNorm state and Adam state), each side reading the
    other's durations, dropout off on both (their forwards called without
    a key / generator)."""
    from your_voice_tts_torch.bin import extract_durations, train_parallel
    from your_voice_tts_torch.data.synthetic import make_synthetic_corpus
    from your_voice_tts_tpu.bin import extract_durations as jax_extract
    from your_voice_tts_tpu.bin import train_parallel as jax_train

    tmp = tmp_path_factory.mktemp("parallel_cli")
    corpus = make_synthetic_corpus(str(tmp / "corpus"), n_items=8, sr=8000)
    out = {"tmp": tmp, "corpus": corpus}
    common = ["--config", SMOKE, "--checkpoint", TEACHER, "--data_path", corpus,
              "--batch_size", "8"]
    jax_extract.main(common + ["--output", str(tmp / "jax_durations.npz")])
    extract_durations.main(common + ["--output", str(tmp / "durations.npz"), "--device", "cpu"])
    train = ["--config_path", SMOKE, "--data_path", corpus, "--restore_path", ASSET,
             "--max_steps", "2", "--batch_size", "8"]
    with pytest.MonkeyPatch.context() as mp:
        jf, pf = jpt.ParallelTTS.forward, ppt.ParallelTTS.forward
        mp.setattr(jpt.ParallelTTS, "forward",
                   lambda self, *a, rng=None, **k: jf(self, *a, rng=None, **k))
        mp.setattr(ppt.ParallelTTS, "forward",
                   lambda self, *a, generator=None, **k: pf(self, *a, generator=None, **k))
        out["jax_parts"] = jax_train.main(train + [
            "--durations", str(tmp / "durations.npz"), "--output_path", str(tmp / "jax_run")])
        out["port_parts"] = train_parallel.main(train + [
            "--durations", str(tmp / "jax_durations.npz"), "--output_path",
            str(tmp / "port_run"), "--device", "cpu"])
    return out


def test_extract_durations_matches_the_jax_cli(cli_runs):
    """The two tools' .npz files: the same wav basenames, the same
    durations, each row summing to its mel length (the trained teacher's
    alignments have no argmax ties)."""
    tmp = cli_runs["tmp"]
    with np.load(tmp / "jax_durations.npz") as a, np.load(tmp / "durations.npz") as b:
        assert sorted(a.files) == sorted(b.files) == sorted(
            f[:-4] for f in os.listdir(os.path.join(cli_runs["corpus"], "wavs")))
        for k in a.files:
            assert b[k].dtype == np.int32
            exact(b[k], a[k], k)
            assert b[k].sum() > 0 and (b[k] >= 0).all()


def test_train_parallel_matches_the_jax_cli(cli_runs):
    """Two steps from the asset: the last step's loss parts within 1e-5
    relative, and the checkpoints the two CLIs write (checkpoint_30002.npz)
    with the same entries, the same meta but the date, and the same
    parameters, BatchNorm state and Adam state within 1e-5 of each
    leaf's scale (the conv biases ahead of BatchNorm, whose gradient is
    rounding noise that Adam scales up, within 2e-4); the counters
    exact."""
    jp, pp = cli_runs["jax_parts"], cli_runs["port_parts"]
    assert set(jp) == set(pp)
    for k, r in jp.items():
        assert abs(pp[k] - r) <= 1e-5 * abs(r), k
    tmp = cli_runs["tmp"]
    assert os.listdir(tmp / "jax_run") == os.listdir(tmp / "port_run") == [
        "checkpoint_30002.npz"]
    with np.load(tmp / "jax_run/checkpoint_30002.npz") as a, \
            np.load(tmp / "port_run/checkpoint_30002.npz") as b:
        assert set(a.files) == set(b.files)
        ma, mb = (json.loads(bytes(z["__meta__"]).decode()) for z in (a, b))
        ma.pop("date"), mb.pop("date")
        assert ma == mb == {"step": 30002, "epoch": 0, "r": 1, "model": "ParallelTTS"}
        for k in a.files:
            if k == "__meta__":
                continue
            assert a[k].dtype == b[k].dtype and a[k].shape == b[k].shape, k
            if a[k].dtype != np.float32:
                exact(b[k], a[k], k)
                continue
            noise = "['conv']['b']" in k and ("['encoder']" in k or "['postnet']" in k)
            tol = 2e-4 if noise else 1e-5 * max(float(np.abs(a[k]).max()), 1e-3)
            close(b[k], a[k], k, tol)


def test_train_parallel_checkpoints_cross_read(cli_runs):
    """The port's checkpoint loads strictly into the JAX CLI's templates
    (parameters, model state, apply_if_finite's Adam state), and the JAX
    CLI's into the port's `restore_trainer_checkpoint`, leaf for leaf."""
    import optax

    from your_voice_tts_torch.train.checkpoint import restore_trainer_checkpoint
    from your_voice_tts_torch.train.optim import ClipAdam
    from your_voice_tts_tpu.train.checkpoint import load_checkpoint as jax_load_checkpoint

    tmp = cli_runs["tmp"]
    cfg = asset_config(jax_load_config)
    jm = jax_setup_model(len(symbols), 0, cfg)
    v = jm.init(jax.random.PRNGKey(0))
    opt = optax.apply_if_finite(optax.chain(optax.clip_by_global_norm(1.0), optax.adam(1e-3)),
                                max_consecutive_errors=10_000)
    port_ckpt = str(tmp / "port_run/checkpoint_30002.npz")
    params, state, opt_state, meta = jax_load_checkpoint(
        port_ckpt, params=v["params"], model_state=v["state"], opt_state=opt.init(v["params"]))
    assert meta["step"] == 30002 and int(opt_state.inner_state[1][0].count) == 30002
    pm = setup_model(len(symbols), asset_config(load_config), device="cpu")
    adam = ClipAdam([p for p in pm.parameters() if p.requires_grad], 1e-3, 1.0, if_finite=True)
    restore_trainer_checkpoint(port_ckpt, {None: (pm, adam)})
    sd = params_from_jax(np_tree(params), np_tree(state), jax_layouts(pm))
    for k, t in pm.state_dict().items():
        exact(t, sd[k], k)
    names = [n for n, p in pm.named_parameters() if p.requires_grad]
    mu = params_from_jax(np_tree(opt_state.inner_state[1][0].mu), {}, jax_layouts(pm))
    for n, m in zip(names, adam.mu):
        exact(m, mu[n], n)
    restore_trainer_checkpoint(str(tmp / "jax_run/checkpoint_30002.npz"), {None: (pm, adam)})
    assert int(adam.count) == 30002 and int(adam.total_notfinite) == 0
    assert bool(adam.last_finite)


def test_train_parallel_dvectors_and_the_config_optimizer(cli_runs, tmp_path):
    """The port CLI trains a d-vector ParallelTTS (`--speakers_json`,
    uniform durations) one step, whose checkpoint the JAX package loads
    strictly into a d-vector model; `--use_config_optimizer` trains on
    the RAdam stack and resumes from its own checkpoint (the optimizer
    state in the port's section); a durations file lacking an item is
    refused up front."""
    from your_voice_tts_torch.bin import train_parallel
    from your_voice_tts_torch.data.synthetic import make_synthetic_corpus
    from your_voice_tts_tpu.train.checkpoint import load_checkpoint as jax_load_checkpoint

    corpus = make_synthetic_corpus(str(tmp_path / "corpus"), n_items=4, sr=8000, n_speakers=2)
    rng = np.random.default_rng(7)
    spk_json = tmp_path / "speakers.json"
    spk_json.write_text(json.dumps({f"SYN{i:02d}": rng.standard_normal(16).tolist()
                                    for i in range(2)}))
    base = ["--config_path", SMOKE, "--data_path", corpus, "--max_steps", "1", "--device", "cpu"]
    parts = train_parallel.main(base + ["--speakers_json", str(spk_json), "--output_path",
                                        str(tmp_path / "dvec")])
    assert np.isfinite(parts["loss"]) and "loss_duration" in parts
    cfg = jax_load_config(SMOKE)
    cfg = dataclasses.replace(cfg, model=dataclasses.replace(cfg.model, model="ParallelTTS"))
    jm = jax_setup_model(len(symbols), 0, cfg, speaker_embedding_dim=16)
    v = jm.init(jax.random.PRNGKey(0))
    params, _, _, meta = jax_load_checkpoint(str(tmp_path / "dvec/checkpoint_1.npz"),
                                             params=v["params"], model_state=v["state"])
    assert meta["step"] == 1 and params["spk_proj"]["w"].shape == (32 + 16, 32)
    first = train_parallel.main(base + ["--use_config_optimizer", "--output_path",
                                        str(tmp_path / "radam")])
    again = train_parallel.main(base + ["--use_config_optimizer", "--restore_path",
                                        str(tmp_path / "radam/checkpoint_1.npz")])
    assert np.isfinite(first["loss"]) and np.isfinite(again["loss"])
    with np.load(cli_runs["tmp"] / "durations.npz") as z:
        rows = {k: z[k] for k in list(z.files)[1:]}
    np.savez(tmp_path / "short.npz", **rows)
    with pytest.raises(KeyError, match="missing 1/8"):
        train_parallel.main(["--config_path", SMOKE, "--data_path", cli_runs["corpus"],
                             "--durations", str(tmp_path / "short.npz"), "--device", "cpu"])
