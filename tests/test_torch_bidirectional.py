"""The bidirectional decoder (the reference's `bidirectional_decoder`, the
DDC terms) in the port against the JAX package on the CPU: one training
step's outputs, loss parts (`decoder_b_loss` and `decoder_c_loss`
included), every gradient leaf (`decoder_backward`'s among them) and
BatchNorm statistics, with the backward decoder on the training kernels'
route (location attention: two forward and two backward scans a step) and
on the step loop (forward attention with the agent: none); the padded flip
it reads; eval mode without it; a JAX checkpoint of such a model read,
served, written back and read by the JAX package; the serving export with
the backward decoder unread; the CLI.

Tolerances as tests/test_torch_train_variants.py states them, whose
helpers run the steps (weights from the JAX `init`, numpy inputs from a
seed, dropout off).
"""

import dataclasses
import os
import warnings

import jax
import numpy as np
import pytest
import torch

import your_voice_tts_torch.models.decoder_grad as decoder_grad
from tests.test_torch_train_variants import corpus  # noqa: F401 (the shared fixture)
from tests.test_torch_train_variants import (OUTPUTS, assert_trained, batch_of, configs,
                                             hold_step, port_trainer, write_config)
from your_voice_tts_tpu.models import setup_model as jax_setup_model
from your_voice_tts_tpu.text import symbols as jax_symbols
from your_voice_tts_tpu.train.checkpoint import _flatten, restore_partial
from your_voice_tts_tpu.train.checkpoint import save_checkpoint as jax_save_checkpoint
from your_voice_tts_torch.models import setup_model
from your_voice_tts_torch.text import symbols
from your_voice_tts_torch.train.checkpoint import load_checkpoint, save_checkpoint

torch.set_num_threads(1)

BD = (("bidirectional_decoder", True),)
BD_OUTPUTS = OUTPUTS + ("decoder_backward_outputs", "alignments_backward")


@pytest.mark.parametrize("attention, scans", [("location", 2), ("forward_ta", 0)])
def test_train_step_matches_jax(corpus, monkeypatch, attention, scans):
    """One step of a bidirectional-decoder model against the JAX forward +
    criterion: the backward decoder's frames (flipped back) and alignments,
    the loss parts with the backward and consistency terms, every gradient
    leaf, `decoder_backward`'s included and non-zero. Location attention
    runs both decoders on the training kernels' route (their plain versions
    here: two forward and two backward scans a step); forward attention with
    the agent runs both as step loops (none)."""
    calls = {"fwd": 0, "bwd": 0}
    for name in ("fwd", "bwd"):
        fn = getattr(decoder_grad, f"taco2_train_{name}")
        monkeypatch.setattr(decoder_grad, f"taco2_train_{name}",
                            lambda *a, _fn=fn, _n=name, **k: calls.__setitem__(
                                _n, calls[_n] + 1) or _fn(*a, **k))
    model = BD + (() if attention == "location" else
                  (("use_forward_attn", True), ("transition_agent", True)))
    parts, ref = hold_step(corpus, model, outputs=BD_OUTPUTS)
    assert calls == {"fwd": scans, "bwd": scans}
    assert {"decoder_b_loss", "decoder_c_loss"} <= set(parts)
    back = [k for k in ref if k.startswith("['decoder_backward']")]
    assert len(back) == len([k for k in ref if k.startswith("['decoder']")])
    assert all(np.abs(ref[k]).max() > 0 for k in back if "stopnet" not in k)


def test_backward_decoder_reads_the_padded_mels_flipped(corpus):
    """The backward decoder reads the padded batch flipped along time, as
    the reference flips it: a short row's reversed sequence starts with its
    padding. Its frames come back flipped to forward time."""
    trainer = port_trainer(corpus, BD)
    seen = {}
    dec_b = trainer.model.decoder_backward
    dec_b.register_forward_pre_hook(lambda _m, args: seen.__setitem__("mels", args[2]))
    dec_b.register_forward_hook(lambda _m, _a, out: seen.__setitem__("frames", out[0]))
    b = trainer._tensors(batch_of())
    _, _, out = trainer._loss_fn(b, 2, None)
    assert torch.equal(seen["mels"], b["mel"].flip(1))
    short = int(b["mel_lengths"][2])                # 13 of 24 frames
    assert float(seen["mels"][2, :24 - short].abs().max()) == 0.0
    assert float(seen["mels"][2, 24 - short].abs().max()) > 0.0
    assert torch.equal(out["decoder_backward_outputs"], seen["frames"].flip(1).float())


def test_eval_does_not_run_the_backward_decoder(corpus, monkeypatch):
    """Eval mode (the Trainer's evaluation, and any forward outside
    training) never runs the backward decoder and returns none of its
    outputs or loss terms."""
    trainer = port_trainer(corpus, BD)
    monkeypatch.setattr(trainer.model.decoder_backward, "forward",
                        lambda *a, **k: pytest.fail("the backward decoder ran in eval mode"))
    b = trainer._tensors(batch_of())
    with torch.no_grad():
        out = trainer.model.eval()(b["text"], b["text_lengths"], b["mel"],
                                   mel_lengths=b["mel_lengths"], r=2)
    assert not {"decoder_backward_outputs", "alignments_backward"} & set(out)
    metrics = trainer.evaluate(2)
    assert "decoder_b_loss" not in metrics and np.isfinite(metrics["loss"])


def test_jax_checkpoint_round_trips_and_serves(corpus, tmp_path):
    """A bidirectional-decoder checkpoint written by the JAX package loads
    into the port strictly (`decoder_backward` and all), serves through
    `Synthesizer` (its decode reads the forward decoder only: the same
    frames as a model without the backward decoder on the same weights),
    and the port's own checkpoint of it loads back into the JAX package
    leaf for leaf."""
    from your_voice_tts_torch.infer.synthesizer import Synthesizer

    jcfg, cfg = configs(corpus, BD)
    v = jax_setup_model(len(jax_symbols), 0, jcfg).init(jax.random.PRNGKey(1))
    path = str(tmp_path / "bd.npz")
    jax_save_checkpoint(path, params=v["params"], model_state=v["state"], opt_state={},
                        step=3, epoch=0, r=2)
    synth = Synthesizer(cfg, path, device="cpu")
    wav = synth.tts("Be a voice, not an echo.")
    assert wav.ndim == 1 and wav.size > 0 and np.isfinite(wav).all()
    plain = setup_model(len(symbols), dataclasses.replace(cfg, model=dataclasses.replace(
        cfg.model, bidirectional_decoder=False)), device="cpu")
    plain.load_state_dict({k: x for k, x in synth.model.state_dict().items()
                           if not k.startswith("decoder_backward.")}, strict=True)
    b = batch_of()
    got, ref = (m.inference(b["text"], b["text_lengths"], max_decoder_steps=8, r=2)
                for m in (synth.model, plain))
    for k in ref:
        assert torch.equal(got[k], ref[k]), k

    back = str(tmp_path / "port.npz")
    save_checkpoint(back, synth.model, step=3, epoch=0, r=2)
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        params, state, meta = restore_partial(back, params=v["params"], model_state=v["state"])
    assert meta["step"] == 3
    assert any(k.startswith("['decoder_backward']") for k in _flatten(v["params"]))
    for tree, ref_tree in ((params, v["params"]), (state, v["state"])):
        got_flat, ref_flat = _flatten(tree), _flatten(ref_tree)
        assert set(got_flat) == set(ref_flat)
        for k, x in ref_flat.items():
            np.testing.assert_array_equal(got_flat[k], x, err_msg=k)
    model = setup_model(len(symbols), cfg, device="cpu")
    load_checkpoint(model, back)


def test_export_leaves_the_backward_decoder_unread(corpus, tmp_path):
    """`export_serving` exports a bidirectional-decoder model: its artifact
    serves the same wave as the unexported program of the same weights
    without the backward decoder."""
    from your_voice_tts_torch.audio import AudioProcessor
    from your_voice_tts_torch.infer.export import (ExportedSynthesizer, export_serving,
                                                   make_serving_fn)

    _, cfg = configs(corpus, BD)
    bd = setup_model(len(symbols), cfg, device="cpu", seed=4)
    plain = setup_model(len(symbols), dataclasses.replace(cfg, model=dataclasses.replace(
        cfg.model, bidirectional_decoder=False, max_decoder_steps=10)), device="cpu")
    plain.load_state_dict({k: x for k, x in bd.state_dict().items()
                           if not k.startswith("decoder_backward.")}, strict=True)
    ap = AudioProcessor(cfg.audio, "cpu")
    cfg = dataclasses.replace(cfg, model=dataclasses.replace(cfg.model, max_decoder_steps=10))
    out = str(tmp_path / "exp")
    export_serving(bd, cfg, ap, out, batch_sizes=(2,), text_buckets=(16,))
    b = batch_of(B=2)
    wav, lengths = ExportedSynthesizer(out)(b["text"].astype(np.int64),
                                            b["text_lengths"].astype(np.int64))
    with torch.no_grad():
        ref_wav, ref_lengths = make_serving_fn(plain, cfg, ap)(
            *(torch.from_numpy(b[k].astype(np.int64)) for k in ("text", "text_lengths")),
            torch.tensor([0]))
    np.testing.assert_array_equal(lengths, ref_lengths.numpy())
    np.testing.assert_allclose(wav, ref_wav.numpy(), atol=1e-6)
    assert np.isfinite(wav).all() and np.abs(wav).max() > 0


def test_cli_trains_a_bidirectional_decoder(tmp_path, capsys):
    """`bin/train.py --device cpu` on the smoke config with
    "bidirectional_decoder": 2 steps on a generated corpus, finite losses
    with the backward and consistency terms printed, a checkpoint that
    holds `decoder_backward`."""
    from your_voice_tts_torch.bin import train
    from your_voice_tts_torch.config import load_config

    cfg_path = write_config(tmp_path, {"bidirectional_decoder": True})
    train.main(["--config_path", cfg_path, "--max_steps", "2", "--device", "cpu",
                "--output_path", str(tmp_path / "runs")])
    printed = capsys.readouterr().out
    assert_trained(printed)
    assert "decoder_b_loss" in printed and "decoder_c_loss" in printed
    (run,) = os.listdir(tmp_path / "runs")
    model = setup_model(len(symbols), load_config(cfg_path), device="cpu")
    load_checkpoint(model, str(tmp_path / "runs" / run / "checkpoint_2.npz"))
