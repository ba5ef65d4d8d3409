"""Guards on the port's boundaries: it imports neither JAX nor the JAX
package, and its entry points never drop to the CPU by themselves."""

import ast
import dataclasses
import os
import pkgutil
import subprocess
import sys

import pytest
import torch

import your_voice_tts_torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.join(ROOT, "your_voice_tts_torch")
BLOCKED = ("jax", "jaxlib", "your_voice_tts_tpu")


def _blocked(name: str) -> bool:
    return any(name == b or name.startswith(b + ".") for b in BLOCKED)


def test_every_module_imports_with_jax_blocked():
    modules = ["your_voice_tts_torch"] + [
        m.name for m in pkgutil.walk_packages([PKG], "your_voice_tts_torch.")]
    code = (
        "import sys\n"
        "class Block:\n"
        "    def find_spec(self, name, path=None, target=None):\n"
        f"        if any(name == b or name.startswith(b + '.') for b in {BLOCKED!r}):\n"
        "            raise ImportError('blocked: ' + name)\n"
        "sys.meta_path.insert(0, Block())\n"
        "import importlib\n"
        f"for m in {modules!r}:\n"
        "    importlib.import_module(m)\n"
        "print('ok', len(sys.modules))\n")
    env = dict(os.environ, PYTHONPATH=ROOT)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         cwd=ROOT, env=env, timeout=120)
    assert out.returncode == 0, out.stderr
    assert len(modules) >= 20


def test_no_source_imports_jax():
    files = [os.path.join(ROOT, "chip_smoke.py")]
    for d, _, names in os.walk(PKG):
        files += [os.path.join(d, n) for n in names if n.endswith(".py")]
    for fn in files:
        with open(fn, encoding="utf-8") as f:
            tree = ast.parse(f.read(), fn)
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module or ""]
            else:
                continue
            assert not any(_blocked(n) for n in names), f"{fn}:{node.lineno} imports {names}"


def test_entry_points_refuse_to_fall_back_to_cpu(monkeypatch):
    from your_voice_tts_torch.config import load_config
    from your_voice_tts_torch.infer.synthesizer import Synthesizer

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        Synthesizer(load_config(os.path.join(ROOT, "configs/smoke_synthetic.json")))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        your_voice_tts_torch.resolve_device()
    assert your_voice_tts_torch.resolve_device("cpu").type == "cpu"
    from your_voice_tts_torch.bin import train
    from your_voice_tts_torch.train.trainer import Trainer

    with pytest.raises(RuntimeError, match="CUDA is not available"):
        Trainer(load_config(os.path.join(ROOT, "configs/smoke_synthetic.json")))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        train.main(["--config_path", os.path.join(ROOT, "configs/smoke_synthetic.json"),
                    "--output_path", os.path.join(ROOT, "build", "never")])
    assert not os.path.exists(os.path.join(ROOT, "build", "never"))


def test_vocoder_entry_points_refuse_to_fall_back_to_cpu(monkeypatch, tmp_path):
    from your_voice_tts_torch.bin import synthesize
    from your_voice_tts_torch.config import load_config
    from your_voice_tts_torch.infer.synthesizer import Synthesizer
    from your_voice_tts_torch.vocoder.config import VocoderConfig
    from your_voice_tts_torch.vocoder.synthesizer import VocoderSynthesizer

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    voc = VocoderConfig(model="wavernn")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        VocoderSynthesizer(voc)
    cfg = load_config(os.path.join(ROOT, "configs/smoke_synthetic.json"))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        Synthesizer(cfg, vocoder_config=dataclasses.replace(voc, audio=cfg.audio))
    vjson = tmp_path / "voc.json"
    vjson.write_text('{"model": "wavernn", "audio": {"num_mels": 20}}')
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        synthesize.main(["Hi.", os.path.join(ROOT, "configs/smoke_synthetic.json"),
                         os.path.join(ROOT, "assets/bench_trained_smoke.npz"),
                         str(tmp_path / "out"), "--vocoder_config", str(vjson)])
    assert not (tmp_path / "out").exists()
    assert VocoderSynthesizer(voc, device="cpu").model.I.weight.device.type == "cpu"


def test_tf32_is_off():
    assert torch.backends.cuda.matmul.allow_tf32 is False
    assert torch.backends.cudnn.allow_tf32 is False


def test_kernel_wrappers_refuse_cpu_tensors():
    """The CUDA wrappers take CUDA tensors only; CPU tensors go to the
    plain versions through the dispatching entry points."""
    from your_voice_tts_torch.ops.griffin_lim import griffin_lim_wave_cuda, packed_constants
    from your_voice_tts_torch.ops.taco2_decode import tacotron2_decode_cuda

    with pytest.raises(ValueError, match="CUDA tensors"):
        griffin_lim_wave_cuda(torch.ones(1, 4, 129), torch.zeros(4, 129),
                              packed_constants(256, 64, torch.ones(256).numpy()), n_iters=1)
    with pytest.raises(ValueError, match="CUDA tensors"):
        tacotron2_decode_cuda({}, torch.ones(1, 4, 8), torch.ones(1, 4, 8),
                              torch.ones(1, 4, dtype=torch.bool), r=1, max_steps=1)
    from your_voice_tts_torch.ops.taco2_train import taco2_train_bwd_cuda, taco2_train_fwd_cuda

    with pytest.raises(ValueError, match="CUDA tensors"):
        taco2_train_fwd_cuda({}, torch.ones(2, 1, 8), torch.ones(1, 4, 8), torch.ones(1, 4, 8),
                             torch.ones(1, 4))
    with pytest.raises(ValueError, match="CUDA tensors"):
        taco2_train_bwd_cuda({}, {}, torch.ones(2, 1, 8), torch.ones(2, 1, 8),
                             torch.ones(2, 1, 4), torch.ones(1, 4, 8), torch.ones(1, 4, 8),
                             torch.ones(1, 4))
    from your_voice_tts_torch.ops.wavernn_gen import generation_weights, wavernn_generate_cuda
    from your_voice_tts_torch.vocoder.models.wavernn import WaveRNN

    w = generation_weights(WaveRNN(n_mels=20, bits=8, rnn_dims=32, fc_dims=32, compute_dims=16,
                                   res_out_dims=16, num_res_blocks=1, device="cpu"))
    with pytest.raises(ValueError, match="CUDA tensors"):
        wavernn_generate_cuda(w, torch.zeros(2, 8, 20), torch.zeros(2, 8, 16), 0, bits=8)


@pytest.mark.parametrize("module", ["your_voice_tts_torch.models.tacotron",
                                    "your_voice_tts_torch.ops.taco1_decode",
                                    "your_voice_tts_torch.ops.griffin_lim"])
def test_tacotron_slice_modules_import_with_jax_blocked(module):
    code = (
        "import sys\n"
        "class Block:\n"
        "    def find_spec(self, name, path=None, target=None):\n"
        f"        if any(name == b or name.startswith(b + '.') for b in {BLOCKED!r}):\n"
        "            raise ImportError('blocked: ' + name)\n"
        "sys.meta_path.insert(0, Block())\n"
        f"import {module}\n"
        f"assert not any(m == 'jax' or m.startswith('jax.') for m in sys.modules)\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         cwd=ROOT, env=dict(os.environ, PYTHONPATH=ROOT), timeout=120)
    assert out.returncode == 0, out.stderr


def test_tacotron_entry_points_refuse_to_fall_back_to_cpu(monkeypatch):
    from your_voice_tts_torch.config import ModelConfig, load_config
    from your_voice_tts_torch.infer.synthesizer import Synthesizer
    from your_voice_tts_torch.models import setup_model
    from your_voice_tts_torch.models.tacotron import Tacotron

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    small = ModelConfig(model="Tacotron", r=2, memory_size=5, tacotron_width=32,
                        attention_dim=24)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        Tacotron(30, small, n_mels=20, num_freq=129)
    cfg = load_config(os.path.join(ROOT, "configs/smoke_synthetic.json"))
    cfg = dataclasses.replace(cfg, model=dataclasses.replace(
        cfg.model, model="Tacotron", memory_size=5, tacotron_width=32, attention_dim=24))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        setup_model(30, cfg)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        Synthesizer(cfg)
    assert setup_model(30, cfg, device="cpu").device.type == "cpu"


def test_tacotron_slice_kernel_wrappers_refuse_cpu_tensors():
    from your_voice_tts_torch.ops.griffin_lim import (gl_iteration_cuda, griffin_lim_full_cuda,
                                                      packed_constants, unpacked_constants)
    from your_voice_tts_torch.ops.taco1_decode import tacotron1_decode_cuda

    win = torch.ones(256).numpy()
    x = torch.ones(1, 4, 129)
    with pytest.raises(ValueError, match="CUDA tensors"):
        griffin_lim_full_cuda(x, torch.zeros(4, 129), packed_constants(256, 64, win), n_iters=1)
    with pytest.raises(ValueError, match="CUDA tensors"):
        gl_iteration_cuda(x, x, x, unpacked_constants(256, 64, win))
    with pytest.raises(ValueError, match="CUDA tensors"):
        tacotron1_decode_cuda({}, torch.ones(1, 4, 8), torch.ones(1, 4, 8),
                              torch.ones(1, 4, dtype=torch.bool), r=1, max_steps=1)


@pytest.mark.parametrize("module", ["your_voice_tts_torch.vocoder.models.melgan",
                                    "your_voice_tts_torch.vocoder.models.pwgan",
                                    "your_voice_tts_torch.speaker_encoder.model",
                                    "your_voice_tts_torch.utils.speakers",
                                    "your_voice_tts_torch.bin.compute_embeddings"])
def test_serving_slice_modules_import_with_jax_blocked(module):
    test_tacotron_slice_modules_import_with_jax_blocked(module)


def test_gan_vocoders_refuse_to_fall_back_to_cpu(monkeypatch):
    from your_voice_tts_torch.vocoder.config import VocoderConfig
    from your_voice_tts_torch.vocoder.models.melgan import MelganGenerator
    from your_voice_tts_torch.vocoder.models.pwgan import ParallelWaveganGenerator
    from your_voice_tts_torch.vocoder.synthesizer import VocoderSynthesizer

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for model in ("melgan", "pwgan"):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            VocoderSynthesizer(VocoderConfig(model=model))
        assert VocoderSynthesizer(VocoderConfig(model=model), device="cpu").model.device.type \
            == "cpu"
    for cls in (MelganGenerator, ParallelWaveganGenerator):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            cls()


def test_speaker_encoder_entry_points_refuse_to_fall_back_to_cpu(monkeypatch, tmp_path):
    from your_voice_tts_torch.bin import compute_embeddings
    from your_voice_tts_torch.config import load_config
    from your_voice_tts_torch.infer.synthesizer import Synthesizer
    from your_voice_tts_torch.speaker_encoder.model import SpeakerEncoder, load_encoder

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        SpeakerEncoder()
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        load_encoder(os.path.join(ROOT, "assets/speaker_encoder_smoke.npz"))
    out = tmp_path / "speakers.json"
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        compute_embeddings.main(["--config", os.path.join(ROOT, "configs/smoke_synthetic.json"),
                                 "--data_path", str(tmp_path), "--output", str(out)])
    assert not out.exists()
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        Synthesizer(load_config(os.path.join(ROOT, "configs/smoke_synthetic.json")),
                    speakers_json=os.path.join(ROOT, "assets/speakers_smoke.json"))
    assert load_encoder(os.path.join(ROOT, "assets/speaker_encoder_smoke.npz"),
                        device="cpu").device.type == "cpu"


@pytest.mark.parametrize("module", ["your_voice_tts_torch.infer.batching",
                                    "your_voice_tts_torch.infer.server",
                                    "your_voice_tts_torch.bin.server"])
def test_server_slice_modules_import_with_jax_blocked(module):
    test_tacotron_slice_modules_import_with_jax_blocked(module)


@pytest.mark.parametrize("module", ["your_voice_tts_torch.text",
                                    "your_voice_tts_torch.text.cmudict",
                                    "your_voice_tts_torch.models.gst"])
def test_phoneme_and_gst_slice_modules_import_with_jax_blocked(module):
    test_tacotron_slice_modules_import_with_jax_blocked(module)


@pytest.mark.parametrize("group,kw", [("data", dict(use_phonemes=True)),
                                      ("speakers", dict(use_gst=True)),
                                      ("model", dict(model="Tacotron", memory_size=5,
                                                     tacotron_width=32, attention_dim=24))])
def test_phoneme_gst_and_taco1_speaker_entry_points_refuse_to_fall_back_to_cpu(
        monkeypatch, group, kw):
    """A phoneme config, a GST config and a multi-speaker Tacotron(1) raise
    without CUDA and a device, and build on the CPU when asked."""
    from your_voice_tts_torch.config import load_config
    from your_voice_tts_torch.infer.synthesizer import Synthesizer

    cfg = load_config(os.path.join(ROOT, "configs/smoke_synthetic.json"))
    cfg = dataclasses.replace(cfg, **{group: dataclasses.replace(getattr(cfg, group), **kw)})
    spk = os.path.join(ROOT, "assets/speakers_smoke.json") if group == "model" else None
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        Synthesizer(cfg, speakers_json=spk)
    synth = Synthesizer(cfg, speakers_json=spk, device="cpu")
    assert synth.model.device.type == "cpu"


def test_training_slice_modules_import_with_jax_blocked():
    """The speaker-encoder training modules and utils/io, in one process
    (one `import a, b, ...`): each interpreter costs ~4 s of torch import."""
    test_tacotron_slice_modules_import_with_jax_blocked(", ".join(
        f"your_voice_tts_torch.{m}" for m in ("speaker_encoder.losses", "speaker_encoder.dataset",
                                              "speaker_encoder.train",
                                              "bin.train_speaker_encoder", "utils.io")))


def test_speaker_encoder_training_refuses_to_fall_back_to_cpu(monkeypatch, tmp_path):
    """SpeakerEncoderTrainer and bin/train_speaker_encoder raise without
    CUDA and a device (the CLI before it makes its run folder), and train
    on the CPU when asked; a conditioned Trainer raises likewise."""
    from your_voice_tts_torch.bin import train_speaker_encoder
    from your_voice_tts_torch.config import load_config
    from your_voice_tts_torch.speaker_encoder.model import SpeakerEncoder
    from your_voice_tts_torch.speaker_encoder.train import SpeakerEncoderTrainer
    from your_voice_tts_torch.train.trainer import Trainer

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    model = SpeakerEncoder(20, 16, 32, 1, device="cpu")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        SpeakerEncoderTrainer(model, None)
    assert SpeakerEncoderTrainer(model, None, device="cpu").params[0].device.type == "cpu"
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        train_speaker_encoder.main(["--config", os.path.join(ROOT, "configs/smoke_synthetic.json"),
                                    "--data_path", str(tmp_path), "--output_path",
                                    str(tmp_path / "runs")])
    assert not (tmp_path / "runs").exists()
    cfg = load_config(os.path.join(ROOT, "configs/smoke_synthetic.json"))
    cfg = dataclasses.replace(cfg, speakers=dataclasses.replace(
        cfg.speakers, use_speaker_embedding=True, use_gst=True))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        Trainer(cfg)


def test_export_slice_modules_import_with_jax_blocked():
    """The registered ops, the export and its CLI, in one process."""
    test_tacotron_slice_modules_import_with_jax_blocked(", ".join(
        f"your_voice_tts_torch.{m}" for m in ("ops.library", "infer.export",
                                              "bin.export_serving")))


def test_registered_ops_do_not_fall_back(monkeypatch):
    """ops/library.py's ops hand a tensor that is not on the CPU to the
    kernel wrapper, which raises (here for a meta tensor; on a card without
    the kernel library, its build's error): no plain version runs in its
    place."""
    from your_voice_tts_torch.ops import griffin_lim, library, taco1_decode, taco2_decode

    def never(*a, **k):
        raise AssertionError("a plain version ran in the kernel's place")

    for mod, names in ((taco2_decode, ("tacotron2_decode_plain",)),
                       (taco1_decode, ("tacotron1_decode_plain",)),
                       (griffin_lim, ("griffin_lim_wave_plain", "griffin_lim_full_plain",
                                      "gl_iteration_plain"))):
        for name in names:
            monkeypatch.setattr(mod, name, never)
    meta = lambda *s, **k: torch.zeros(*s, device="meta", **k)  # noqa: E731
    spec = library.flatten_weights({"dtype": torch.bfloat16, "dims": {"GK": 0, "OW": 4}})[0]
    enc, mask, seed = meta(2, 4, 8), meta(2, 4, dtype=torch.bool), torch.zeros(1, dtype=torch.int64)
    with pytest.raises(ValueError, match="tacotron2_decode_cuda takes CUDA tensors"):
        library.taco2_decode._init_fn([], enc, enc, mask, seed, spec, 1, 1, "sigmoid", 0.5,
                                      False, False, 1, 3, False, False, False)
    with pytest.raises(ValueError, match="CUDA tensors"):
        library.taco1_decode._init_fn([], enc, enc, mask, seed, spec, 1, 1, "sigmoid", 0.5,
                                      False)
    for T, n_fft, hop, what in ((4, 1024, 256, "griffin_lim_wave_cuda"),
                                (4, 256, 64, "griffin_lim_full_cuda"),
                                (1100, 256, 64, "gl_iteration_cuda")):
        F = n_fft // 2 + 1
        with pytest.raises(ValueError, match=f"{what} takes CUDA tensors"):
            library.griffin_lim._init_fn(meta(1, T, F), meta(T, F), torch.ones(n_fft), n_fft,
                                         hop, 1, 0.0)


def test_an_artifact_serves_without_model_code(tmp_path):
    """bin/export_serving writes a smoke-config artifact on the CPU; in a
    fresh interpreter, ExportedSynthesizer(dir) serves it and bin/server
    --export_dir --device cpu answers /api/tts with audio/wav and stream=1
    with 400, with no model code imported (no models/, vocoder/models/ or
    infer/synthesizer)."""
    from your_voice_tts_torch.bin import export_serving

    out = str(tmp_path / "exp")
    export_serving.main(["--config", os.path.join(ROOT, "configs/smoke_synthetic.json"),
                         "--checkpoint", os.path.join(ROOT, "assets/bench_trained_smoke.npz"),
                         "--out", out, "--batch", "1", "--text_bucket", "32",
                         "--max_decoder_steps", "8", "--device", "cpu"])
    assert sorted(os.listdir(out)) == ["manifest.json", "serve_b1_t32.pt2"]
    code = (
        "import socket, sys, threading, time, urllib.error, urllib.request\n"
        "from your_voice_tts_torch.infer.export import ExportedSynthesizer\n"
        f"wav = ExportedSynthesizer({out!r}).tts_many(['Hi there.'])[0]\n"
        "assert wav.ndim == 1 and wav.size > 0\n"
        "from your_voice_tts_torch.bin import server\n"
        "with socket.socket() as s:\n"
        "    s.bind(('127.0.0.1', 0))\n"
        "    port = s.getsockname()[1]\n"
        f"argv = ['--export_dir', {out!r}, '--device', 'cpu', '--host', '127.0.0.1',\n"
        "        '--port', str(port)]\n"
        "threading.Thread(target=server.main, args=(argv,), daemon=True).start()\n"
        "base = f'http://127.0.0.1:{port}/api/tts?text='\n"
        "for _ in range(600):\n"
        "    try:\n"
        "        r = urllib.request.urlopen(base + 'hi', timeout=60)\n"
        "        break\n"
        "    except urllib.error.URLError:\n"
        "        time.sleep(0.05)\n"
        "assert r.headers['Content-Type'] == 'audio/wav' and r.read()[:4] == b'RIFF'\n"
        "try:\n"
        "    urllib.request.urlopen(base + 'hi&stream=1', timeout=60)\n"
        "    raise SystemExit('stream=1 was answered')\n"
        "except urllib.error.HTTPError as e:\n"
        "    assert e.code == 400, e.code\n"
        "bad = [m for m in sys.modules if m.startswith(tuple('your_voice_tts_torch.' + p for p\n"
        "       in ('models', 'vocoder.models', 'infer.synthesizer')))]\n"
        "assert not bad, bad\n"
        "print('ok')\n")
    got = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, cwd=ROOT,
                         env=dict(os.environ, PYTHONPATH=ROOT), timeout=300)
    assert got.returncode == 0 and got.stdout.strip().endswith("ok"), got.stderr


def test_taco1_training_and_tool_modules_import_with_jax_blocked():
    """The statistics, import and preprocess CLIs, the importer, the
    quality metrics, the plots and the loggers, in one process."""
    test_tacotron_slice_modules_import_with_jax_blocked(", ".join(
        f"your_voice_tts_torch.{m}" for m in ("bin.compute_statistics", "bin.import_checkpoint",
                                              "bin.preprocess", "utils.torch_import",
                                              "utils.quality", "utils.visual", "utils.logging")))


def test_statistics_and_taco1_training_refuse_to_fall_back_to_cpu(monkeypatch, tmp_path):
    """bin/compute_statistics, a Tacotron(1) Trainer and bin/train.py on a
    Tacotron(1) config raise without CUDA and a device (the statistics
    before they write anything)."""
    from your_voice_tts_torch.bin import compute_statistics, train
    from your_voice_tts_torch.config import load_config
    from your_voice_tts_torch.data.synthetic import make_synthetic_corpus
    from your_voice_tts_torch.train.trainer import Trainer

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    corpus = make_synthetic_corpus(str(tmp_path / "corpus"), n_items=2, sr=8000)
    with open(os.path.join(ROOT, "configs/smoke_synthetic.json"), encoding="utf-8") as f:
        raw = "\n".join(line for line in f if not line.strip().startswith("//"))
    raw = raw.replace("SET_AT_RUNTIME", corpus).replace(
        '"model": "Tacotron2"', '"model": "Tacotron", "tacotron_width": 32, "memory_size": 5')
    cfg_path = tmp_path / "taco1.json"
    cfg_path.write_text(raw)
    out = tmp_path / "stats.npy"
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        compute_statistics.main(["--config_path", str(cfg_path), "--out_path", str(out)])
    assert not out.exists()
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        Trainer(load_config(str(cfg_path)))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        train.main(["--config_path", str(cfg_path), "--output_path", str(tmp_path / "runs")])
    compute_statistics.main(["--config_path", str(cfg_path), "--out_path", str(out),
                             "--device", "cpu"])
    assert out.exists()


def test_import_and_preprocess_are_host_only(monkeypatch, tmp_path):
    """bin/import_checkpoint and `bin/preprocess --audit` are host work and
    need no card: they run with CUDA absent and no device given. Warming
    the caches computes spectrograms, which run on CUDA: without CUDA it
    raises unless given --device cpu, before it writes anything."""
    from your_voice_tts_torch.bin import import_checkpoint, preprocess
    from your_voice_tts_torch.data.synthetic import make_synthetic_corpus
    from your_voice_tts_torch.speaker_encoder.model import load_encoder

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    torch.manual_seed(0)
    layers = torch.nn.ModuleList()
    for i in range(2):
        layer = torch.nn.Module()
        layer.lstm = torch.nn.LSTM(20 if i == 0 else 16, 24, batch_first=True)
        layer.linear = torch.nn.Linear(24, 16, bias=False)
        layers.append(layer)
    holder = torch.nn.Module()
    holder.layers = layers
    src = tmp_path / "enc.pth.tar"
    torch.save({"model": holder.state_dict(), "step": 3}, src)
    cfg_path = os.path.join(ROOT, "configs/smoke_synthetic.json")
    out = tmp_path / "enc.npz"
    import_checkpoint.main([str(src), cfg_path, str(out), "--kind", "speaker_encoder"])
    assert load_encoder(str(out), device="cpu").layers[0].lstm.hidden_size == 24
    corpus = make_synthetic_corpus(str(tmp_path / "corpus"), n_items=2, sr=8000)
    with open(cfg_path, encoding="utf-8") as f:
        raw = "\n".join(line for line in f if not line.strip().startswith("//"))
    smoke = tmp_path / "smoke.json"
    smoke.write_text(raw.replace("SET_AT_RUNTIME", corpus))
    assert preprocess.main(["--config_path", str(smoke), "--audit"]) == 0
    cache = tmp_path / "cache"
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        preprocess.main(["--config_path", str(smoke), "--cache_dir", str(cache)])
    assert not cache.exists()
    assert preprocess.main(["--config_path", str(smoke), "--cache_dir", str(cache),
                            "--device", "cpu"]) == 0
    assert any(f.startswith("mel_") for f in os.listdir(cache))


def test_decoder_training_routes_do_not_fall_back(monkeypatch):
    """Off the CPU the teacher-forced pass runs the training kernels or the
    step loop, never a plain version of a kernel: on meta tensors a
    bidirectional model's backward decoder (location attention) hands its
    scan to the forward kernel's wrapper, which raises; a forward-attention
    decoder runs its step loop and calls neither kernel nor plain version."""
    import dataclasses

    from your_voice_tts_torch.config import load_config
    from your_voice_tts_torch.models import decoder_grad
    from your_voice_tts_torch.models.tacotron2 import Tacotron2
    from your_voice_tts_torch.ops import taco2_train

    def never(*a, **k):
        raise AssertionError("a plain version ran in the kernel's place")

    for name in ("taco2_train_fwd_plain", "taco2_train_bwd_plain"):
        monkeypatch.setattr(taco2_train, name, never)
    m = load_config(os.path.join(ROOT, "configs/smoke_synthetic.json")).model
    meta = lambda *s, **k: torch.zeros(*s, device="meta", **k)  # noqa: E731
    enc, lengths, mels = meta(2, 6, 32), meta(2, dtype=torch.long), meta(2, 8, 20)
    bd = Tacotron2(40, dataclasses.replace(m, bidirectional_decoder=True), n_mels=20,
                   device="cpu").to("meta").train()
    with pytest.raises(ValueError, match="taco2_train_fwd_cuda takes CUDA tensors"):
        bd.decoder_backward(enc, lengths, mels.flip(1), 2)
    fwd = Tacotron2(40, dataclasses.replace(m, use_forward_attn=True, transition_agent=True),
                    n_mels=20, device="cpu").to("meta").train()
    monkeypatch.setattr(decoder_grad, "taco2_train_fwd", never)
    frames, aligns, stops = fwd.decoder(enc, lengths, mels, 2)
    assert frames.shape == (2, 8, 20) and aligns.shape == (2, 4, 6)


def test_taco1_decode_routes_do_not_fall_back(monkeypatch):
    """Tacotron(1)'s decoder on meta tensors, as it runs off the CPU: a
    location config hands its decode to kernel 8's dispatch (which sends a
    non-CPU tensor to the kernel) and trains through `decoder_step`, never
    the step loop; a Graves config decodes and trains on the step loop and
    never calls kernel 8, its dispatch or its plain version."""
    from your_voice_tts_torch.config import ModelConfig
    from your_voice_tts_torch.models import tacotron as taco
    from your_voice_tts_torch.ops import taco1_decode

    class Kernel8(Exception):
        pass

    def never(*a, **k):
        raise AssertionError("the other route ran")

    def kernel8(w, enc, *a, **k):
        assert enc.device.type == "meta"
        raise Kernel8

    monkeypatch.setattr(taco1_decode, "tacotron1_decode_plain", never)
    cfg = ModelConfig(model="Tacotron", r=2, memory_size=5, tacotron_width=32,
                      attention_dim=24)
    meta = lambda *s, **k: torch.zeros(*s, device="meta", **k)  # noqa: E731
    enc, lengths, mels = meta(2, 6, 32), meta(2, dtype=torch.long), meta(2, 8, 20)
    loc = taco.Tacotron(40, cfg, n_mels=20, num_freq=33, device="cpu").to("meta")
    assert loc.decoder.kernel_supported()
    monkeypatch.setattr(taco, "tacotron1_decode", kernel8)
    monkeypatch.setattr(taco.TacotronDecoder, "decode_weights", lambda self, dtype: {})
    monkeypatch.setattr(taco.TacotronDecoder, "_decode_loop", never)
    monkeypatch.setattr(taco.TacotronDecoder, "_loop", never)
    with pytest.raises(Kernel8):
        loc.decoder.inference(enc, lengths, 4, 2)
    frames, aligns, stops = loc.train().decoder(enc, lengths, mels, 2)
    assert frames.shape == (2, 8, 20) and aligns.shape == (2, 4, 6)
    monkeypatch.undo()
    monkeypatch.setattr(taco1_decode, "tacotron1_decode_plain", never)
    graves = taco.Tacotron(40, dataclasses.replace(cfg, attention_type="graves"), n_mels=20,
                           num_freq=33, device="cpu").to("meta")
    assert not graves.decoder.kernel_supported()
    monkeypatch.setattr(taco, "tacotron1_decode", never)
    monkeypatch.setattr(taco, "decoder_step", never)
    frames, aligns, stops, lens = graves.decoder.inference(enc, lengths, 4, 2)
    assert frames.shape == (2, 8, 20) and aligns.shape == (2, 4, 6) and lens.shape == (2,)
    frames, aligns, stops = graves.train().decoder(enc, lengths, mels, 2)
    assert frames.shape == (2, 8, 20) and stops.shape == (2, 4)


def test_vocoder_training_refuses_to_fall_back_to_cpu(monkeypatch, tmp_path):
    """GANTrainer, WaveRNNTrainer and bin/train_vocoder.py raise without
    CUDA and a device, the CLI before it makes its run folder."""
    from your_voice_tts_torch.bin import train_vocoder
    from your_voice_tts_torch.vocoder.config import load_vocoder_config
    from your_voice_tts_torch.vocoder.train_gan import GANTrainer
    from your_voice_tts_torch.vocoder.train_wavernn import WaveRNNTrainer

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = load_vocoder_config(os.path.join(ROOT, "configs/melgan_smoke.json"))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        GANTrainer(cfg, [])
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        WaveRNNTrainer(dataclasses.replace(cfg, model="wavernn"), [])
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        train_vocoder.main(["--config_path", os.path.join(ROOT, "configs/melgan_smoke.json"),
                            "--data_path", str(tmp_path), "--output_path",
                            str(tmp_path / "runs")])
    assert not (tmp_path / "runs").exists()
    assert GANTrainer(cfg, [], device="cpu").generator.conv_in.weight.device.type == "cpu"


def test_parallel_tts_modules_import_with_jax_blocked():
    """The ParallelTTS model and its two CLIs, in one process."""
    test_tacotron_slice_modules_import_with_jax_blocked(", ".join(
        f"your_voice_tts_torch.{m}" for m in ("models.parallel_tts", "bin.extract_durations",
                                              "bin.train_parallel")))


def test_parallel_tts_entry_points_refuse_to_fall_back_to_cpu(monkeypatch, tmp_path):
    """setup_model("ParallelTTS"), a ParallelTTS Synthesizer,
    bin/extract_durations and bin/train_parallel raise without CUDA and a
    device, the CLIs before they write anything."""
    from your_voice_tts_torch.bin import extract_durations, train_parallel
    from your_voice_tts_torch.config import load_config
    from your_voice_tts_torch.infer.synthesizer import Synthesizer
    from your_voice_tts_torch.models import setup_model

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    smoke = os.path.join(ROOT, "configs/smoke_synthetic.json")
    cfg = load_config(smoke)
    cfg = dataclasses.replace(cfg, model=dataclasses.replace(cfg.model, model="ParallelTTS"))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        setup_model(30, cfg)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        Synthesizer(cfg)
    out = tmp_path / "durations.npz"
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        extract_durations.main(["--config", smoke, "--checkpoint",
                                os.path.join(ROOT, "assets/bench_trained_smoke.npz"),
                                "--data_path", str(tmp_path), "--output", str(out)])
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        train_parallel.main(["--config_path", smoke, "--data_path", str(tmp_path),
                             "--output_path", str(tmp_path / "runs")])
    assert not out.exists() and not (tmp_path / "runs").exists()
    assert setup_model(30, cfg, device="cpu").device.type == "cpu"
