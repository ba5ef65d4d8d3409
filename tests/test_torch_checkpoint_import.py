"""The port's importer of upstream torch checkpoints (utils/torch_import.py,
bin/import_checkpoint.py) against the JAX package's on the CPU.

The source state dicts come from the torch replicas of the reference's
layers that the JAX package's own importer test builds
(tests/test_torch_import.py): Tacotron2 (with and without GST), the GE2E
speaker encoder, WaveRNN, MelGAN and Parallel WaveGAN (with and without
the aux context window). Each converter fills the port's own template
(`params_to_jax` of the port model, nested) and must give exactly the JAX
converter's arrays on its template: every leaf it fills equal, every leaf
it keeps at its initial value left as the port model's own. The port
model loaded from the import runs as the replica does, at the tolerances
the JAX package's importer test holds its own model to (the replica
forward: encoder 2e-5, the teacher-forced decoder 3e-5, postnet 2e-5,
speaker encoder 2e-5, MelGAN 5e-6, PWGAN 5e-6, GST 2e-5; the WaveRNN
upsampling network, float32, 1e-5). The CLI's .npz equals the JAX CLI's
key for key, the metadata too but its date.
"""

import json
import os

import jax
import numpy as np
import pytest
import torch

from test_torch_import import (CFG, N_CHARS, N_MELS, TorchGST, TorchMelGAN, TorchPWGAN,
                               TorchSpeakerEncoder, TorchTacotron2, TorchWaveRNN)
from your_voice_tts_tpu.bin.import_checkpoint import main as jax_main
from your_voice_tts_tpu.config import GSTConfig as JaxGSTConfig
from your_voice_tts_tpu.config import ModelConfig as JaxModelConfig
from your_voice_tts_tpu.models.tacotron2 import Tacotron2 as JaxTacotron2
from your_voice_tts_tpu.speaker_encoder.model import SpeakerEncoder as JaxSpeakerEncoder
from your_voice_tts_tpu.train.checkpoint import _flatten
from your_voice_tts_tpu.utils import torch_import as jti
from your_voice_tts_tpu.vocoder.models.melgan import MelganGenerator as JaxMelgan
from your_voice_tts_tpu.vocoder.models.pwgan import ParallelWaveganGenerator as JaxPWGAN
from your_voice_tts_tpu.vocoder.models.wavernn import WaveRNN as JaxWaveRNN
from your_voice_tts_torch.bin.import_checkpoint import main
from your_voice_tts_torch.config import GSTConfig, ModelConfig
from your_voice_tts_torch.models.tacotron2 import Tacotron2
from your_voice_tts_torch.speaker_encoder.model import SpeakerEncoder
from your_voice_tts_torch.train.checkpoint import jax_layouts, params_from_jax, params_to_jax
from your_voice_tts_torch.utils import torch_import as ti
from your_voice_tts_torch.vocoder.models.melgan import MelganGenerator
from your_voice_tts_torch.vocoder.models.pwgan import ParallelWaveganGenerator
from your_voice_tts_torch.vocoder.models.wavernn import WaveRNN

torch.set_num_threads(1)

WAVERNN = dict(n_mels=20, bits=9, rnn_dims=32, fc_dims=32, compute_dims=32, res_out_dims=16,
               num_res_blocks=2, pad=2, upsample_factors=(4, 4))
PWGAN = dict(n_mels=20, num_layers=6, stacks=2, residual_ch=8, gate_ch=16, skip_ch=8,
             kernel_size=3, upsample_factors=(4, 4, 4))
GST_CFG = dict(gst_embedding_dim=256, gst_num_heads=4)


def state_dict(replica, prefix=""):
    return {prefix + k: v.detach().numpy()
            for k, v in ti.strip_module_prefix(replica.state_dict()).items()}


def replica(kind, seed=0):
    """(the torch replica in eval mode, its numpy state dict) of `kind`,
    BatchNorm running statistics made non-trivial."""
    torch.manual_seed(seed)
    cls = {"tacotron2": TorchTacotron2, "tacotron2_gst": TorchTacotron2,
           "speaker_encoder": TorchSpeakerEncoder, "wavernn": TorchWaveRNN,
           "melgan": TorchMelGAN, "pwgan2": lambda: TorchPWGAN(aux_window=2),
           "pwgan0": lambda: TorchPWGAN(aux_window=0)}[kind]
    rep = cls().eval()
    for mod in rep.modules():
        if isinstance(mod, torch.nn.BatchNorm1d):
            mod.running_mean.normal_(0.0, 0.3)
            mod.running_var.uniform_(0.5, 2.0)
    sd = state_dict(rep)
    if kind == "tacotron2_gst":
        gst = TorchGST(n_mels=N_MELS, emb=256).eval()
        rep.gst = gst
        sd.update(state_dict(gst, "gst_layer."))
    return rep, sd


def models(kind):
    """(JAX model, the port's model on the CPU) at the replica's widths."""
    if kind.startswith("tacotron2"):
        gst = kind == "tacotron2_gst"
        kw = dict(use_gst=True) if gst else {}
        return (JaxTacotron2(N_CHARS, JaxModelConfig(**CFG), n_mels=N_MELS,
                             gst_cfg=JaxGSTConfig(**GST_CFG), **kw),
                Tacotron2(N_CHARS, ModelConfig(**CFG), n_mels=N_MELS, device="cpu",
                          gst_cfg=GSTConfig(**GST_CFG), **kw))
    if kind == "speaker_encoder":
        arch = dict(input_dim=20, proj_dim=16, lstm_dim=24, num_layers=2, recur_on_proj=False)
        return JaxSpeakerEncoder(**arch), SpeakerEncoder(**arch, device="cpu")
    if kind == "wavernn":
        return JaxWaveRNN(**WAVERNN), WaveRNN(**WAVERNN, device="cpu")
    if kind == "melgan":
        args = (20, (4, 4), 64, 2, 7)
        return JaxMelgan(*args), MelganGenerator(*args, device="cpu")
    aux = int(kind[-1])
    return (JaxPWGAN(**PWGAN, aux_context_window=aux),
            ParallelWaveganGenerator(**PWGAN, aux_context_window=aux, device="cpu"))


CONVERT = {"tacotron2": "convert_tacotron2_state_dict",
           "tacotron2_gst": "convert_tacotron2_state_dict",
           "speaker_encoder": "convert_speaker_encoder_state_dict",
           "wavernn": "convert_wavernn_state_dict", "melgan": "convert_melgan_state_dict",
           "pwgan2": "convert_pwgan_state_dict", "pwgan0": "convert_pwgan_state_dict"}


def convert(kind, sd):
    """Both converters on their own templates: ((JAX template, JAX output,
    JAX report), (port template, port output, port report), port model)."""
    jm, pm = models(kind)
    jt = jm.init(jax.random.PRNGKey(0))
    params, state = params_to_jax(pm)
    pt = ({"params": ti.nest(params), "state": ti.nest(state)} if kind.startswith("tacotron2")
          else ti.nest(params))
    jo, jr = getattr(jti, CONVERT[kind])(sd, jt)
    po, pr = getattr(ti, CONVERT[kind])(sd, pt)
    return (jt, jo, jr), (pt, po, pr), pm


@pytest.mark.parametrize("kind", list(CONVERT))
def test_converters_match_jax(kind):
    """Every converter's output against the JAX converter's on the same
    state dict: the same report, the same leaves; each leaf the JAX
    converter filled is np.array_equal, each it kept at its initial value
    (the GST projection the reference cannot express) is the port model's
    own initial value; the port model loads the result strictly."""
    _, sd = replica(kind)
    (jt, jo, jr), (pt, po, pr), pm = convert(kind, sd)
    assert pr == jr
    assert not pr["unused_source_keys"]
    jf, jtf, pf, ptf = (_flatten(jax.tree_util.tree_map(np.asarray, t)) for t in (jo, jt, po, pt))
    assert set(pf) == set(jf)
    # the GST projection (256 -> the encoder's 32) is a configuration the
    # reference cannot express: both converters keep their model's init
    kept = {"['params']['gst']['proj']['w']", "['params']['gst']['proj']['b']"}
    kept &= set(jf)
    assert bool(kept) == (kind == "tacotron2_gst")
    for k in jf:
        if k in kept:
            assert np.array_equal(jf[k], jtf[k]) and np.array_equal(pf[k], ptf[k]), k
        else:
            assert pf[k].dtype == jf[k].dtype and np.array_equal(pf[k], jf[k]), k
    params, state = (po["params"], po["state"]) if kind.startswith("tacotron2") else (po, {})
    pm.load_state_dict(params_from_jax(params, state, jax_layouts(pm)), strict=True)


def loaded(kind):
    rep, sd = replica(kind, seed=1)
    _, (_, po, _), pm = convert(kind, sd)
    params, state = (po["params"], po["state"]) if kind.startswith("tacotron2") else (po, {})
    pm.load_state_dict(params_from_jax(params, state, jax_layouts(pm)), strict=True)
    return rep, pm.eval()


@torch.no_grad()
def test_imported_tacotron2_runs_as_the_replica():
    """The imported Tacotron2: encoder, two teacher-forced decoder steps
    (prenet, both LSTMs, location attention, projection, stopnet) and
    postnet against the replica, and the imported GST's style."""
    rep, pm = loaded("tacotron2_gst")
    rng = np.random.default_rng(0)
    ids = torch.from_numpy(rng.integers(1, N_CHARS, (3, 11)))
    want = rep.encoder(rep.embedding(ids))
    got = pm.encoder(pm.embedding(ids), torch.tensor([11, 11, 11]))
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=2e-5)
    B, T = 2, 9
    enc = torch.from_numpy(rng.standard_normal((B, T, CFG["encoder_dim"])).astype(np.float32))
    mels = torch.from_numpy(rng.standard_normal((B, 2 * CFG["r"], N_MELS)).astype(np.float32))
    t_out, t_align, t_stop = rep.decoder(enc, mels)
    out, aligns, stops = pm.decoder(enc, torch.tensor([T, T]), mels, CFG["r"])
    np.testing.assert_allclose(out.reshape(B, 2, -1).numpy(), t_out.numpy(), atol=3e-5)
    np.testing.assert_allclose(aligns.numpy(), t_align.numpy(), atol=3e-5)
    np.testing.assert_allclose(stops.numpy(), t_stop.numpy(), atol=3e-5)
    x = torch.from_numpy(rng.standard_normal((2, 12, N_MELS)).astype(np.float32))
    np.testing.assert_allclose(pm.postnet(x).numpy(), rep.postnet(x).numpy(), atol=2e-5)
    mel = torch.from_numpy(rng.standard_normal((3, 40, N_MELS)).astype(np.float32))
    style = pm.gst.style(pm.gst.ref(mel))          # the reference has no projection
    np.testing.assert_allclose(style.numpy(), rep.gst(mel).numpy(), atol=2e-5)


@torch.no_grad()
@pytest.mark.parametrize("kind", ["speaker_encoder", "wavernn", "melgan", "pwgan2", "pwgan0"])
def test_imported_vocoders_and_encoder_run_as_the_replica(kind):
    """The imported speaker encoder's d-vectors, MelGAN's and PWGAN's audio
    (the same noise) and WaveRNN's upsampling network (its conditioning
    and aux features; the sample loop has its own tests) against the
    replica's."""
    rep, pm = loaded(kind)
    rng = np.random.default_rng(3)
    if kind == "speaker_encoder":
        mels = torch.from_numpy(rng.standard_normal((3, 25, 20)).astype(np.float32))
        np.testing.assert_allclose(pm(mels).numpy(), rep(mels).numpy(), atol=2e-5)
        return
    mel = torch.from_numpy(rng.standard_normal((2, 11, 20)).astype(np.float32))
    if kind == "melgan":
        np.testing.assert_allclose(pm(mel).numpy(), rep(mel.transpose(1, 2)).numpy()[:, 0],
                                   atol=5e-6)
    elif kind == "wavernn":
        cond, aux = pm.upsample(mel)
        t_cond, t_aux = rep.upsample(mel.transpose(1, 2))
        np.testing.assert_allclose(cond.numpy(), t_cond.numpy(), atol=1e-5)
        np.testing.assert_allclose(aux.numpy(), t_aux.numpy(), atol=1e-5)
    else:
        noise = torch.from_numpy(rng.standard_normal((2, 11 * 64)).astype(np.float32))
        want = rep(mel.transpose(1, 2), noise[:, None]).numpy()[:, 0]
        np.testing.assert_allclose(pm(mel, noise=noise).numpy(), want, atol=5e-6)


AUDIO = {"num_mels": 20, "fft_size": 256, "sample_rate": 8000, "hop_length": 64,
         "win_length": 256, "mel_fmax": None}


def cli_config(kind, tmp_path):
    """The config file each CLI reads for `kind`."""
    if kind == "tacotron2":
        cfg = {"model": "Tacotron2", **CFG, "audio": AUDIO}
    elif kind == "speaker_encoder":
        cfg = {"audio": AUDIO}
    else:
        hop = 16 if kind in ("melgan", "wavernn") else 64
        audio = dict(AUDIO, hop_length=hop, fft_size=4 * hop, win_length=4 * hop)
        w = {k: v for k, v in WAVERNN.items() if k != "n_mels"}
        cfg = {"model": kind, "audio": audio,
               "melgan": {"upsample_factors": [4, 4], "base_channels": 64,
                          "num_res_blocks": 2, "kernel_size": 7},
               "pwgan": {"upsample_factors": [4, 4, 4], "num_layers": 6, "stacks": 2,
                         "residual_channels": 8, "gate_channels": 16, "skip_channels": 8,
                         "kernel_size": 3, "aux_context_window": 2},
               "wavernn": dict(w, upsample_factors=list(w["upsample_factors"]))}
    path = tmp_path / f"{kind}.json"
    path.write_text(json.dumps(cfg))
    return str(path)


@pytest.mark.parametrize("kind", ["tacotron2", "speaker_encoder", "wavernn", "melgan", "pwgan"])
def test_cli_writes_the_jax_clis_npz(kind, tmp_path, capsys):
    """bin/import_checkpoint on a reference-style pickle ({"model": state
    dict, "r", "step", "epoch"}): the same keys and arrays as the JAX
    CLI's file, the same metadata but its date, the same report lines."""
    from your_voice_tts_torch.text import symbols

    torch.manual_seed(5)
    rep = (TorchTacotron2(n_chars=len(symbols)) if kind == "tacotron2"
           else replica("pwgan2" if kind == "pwgan" else kind)[0]).eval()
    src = tmp_path / "ref.pth.tar"
    torch.save({"model": rep.state_dict(), "r": 2, "step": 1234, "epoch": 7}, src)
    cfg = cli_config(kind, tmp_path)
    outs = {}
    for name, fn in (("jax", jax_main), ("port", main)):
        out = tmp_path / f"{name}.npz"
        fn([str(src), cfg, str(out), "--kind", kind])
        outs[name] = capsys.readouterr().out.replace(str(out), "OUT")
    assert outs["port"] == outs["jax"]
    with np.load(tmp_path / "jax.npz") as zj, np.load(tmp_path / "port.npz") as zp:
        assert set(zp.files) == set(zj.files)
        for k in zj.files:
            if k != "__meta__":
                assert zp[k].dtype == zj[k].dtype and np.array_equal(zp[k], zj[k]), k
        mj, mp = (json.loads(bytes(z["__meta__"]).decode()) for z in (zj, zp))
    mj.pop("date"), mp.pop("date")
    assert mp == mj and mp["step"] == 1234
