"""The port's parallel/mesh.py against the JAX package's on the CPU, and the
sharded serving route (`synthesis_batch(mesh=)`).

- `pad_batch_to_devices` against the JAX function, bit for bit, on
  batches that need phantom rows and on one that does not;
- `sync_batch_shapes`' padding rule (`pad_batch_shapes`) against the JAX
  function run as if in a two-process job (its process count and its
  all-gather answered by the test), bit for bit; in one process both are
  no-ops;
- `make_mesh`, `shard_batch` and `replicate`; the shards of distinct CUDA
  devices run in a thread a device with that device current (stand-ins
  for the cards);
- sharded serving on a mesh of two CPU devices, 5 texts padded to 6 by
  repeating row 0, dropout off, the trained smoke checkpoint: the
  postnet spectrograms against the JAX `synthesis_batch(mesh=make_mesh())`
  on its 8 virtual devices at tests/test_torch_synthesis.py's 1e-4 (float
  32, sum order only), the lengths exact; and against the port's unsharded
  call, 1e-5 (each shard runs its batch of 3 where the unsharded call runs
  5: the encoder's and the postnet's products round by batch size, ~6e-7
  here), lengths exact.
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from your_voice_tts_tpu.config import load_config as jax_load_config
from your_voice_tts_tpu.infer.synthesis import synthesis_batch as jax_synthesis_batch
from your_voice_tts_tpu.infer.synthesizer import Synthesizer as JaxSynthesizer
from your_voice_tts_tpu.parallel import mesh as jmesh
from your_voice_tts_torch.config import load_config
from your_voice_tts_torch.infer.synthesis import synthesis_batch
from your_voice_tts_torch.infer.synthesizer import Synthesizer
from your_voice_tts_torch.parallel import (make_mesh, pad_batch_to_devices, replicate,
                                           shard_batch, sync_batch_shapes)
from your_voice_tts_torch.parallel.mesh import pad_batch_shapes

torch.set_num_threads(1)

CONFIG, CKPT = "configs/smoke_synthetic.json", "assets/bench_trained_smoke.npz"
TEXTS = ["Hi there.", "The quick brown fox jumps over the lazy dog.", "Hello world",
         "A fourth sentence, a little longer.", "Five."]


def batch(B: int, T_text: int = 10, T_mel: int = 16, seed: int = 0) -> dict:
    rng = np.random.default_rng(seed)
    return {"text": rng.integers(1, 40, (B, T_text)).astype(np.int32),
            "text_lengths": rng.integers(1, T_text + 1, B).astype(np.int32),
            "mel": rng.normal(size=(B, T_mel, 4)).astype(np.float32),
            "mel_lengths": rng.integers(1, T_mel + 1, B).astype(np.int32),
            "linear": rng.normal(size=(B, T_mel, 6)).astype(np.float32),
            "stop_targets": (rng.uniform(size=(B, T_mel // 2)) > 0.5).astype(np.float32),
            "n_real": np.asarray(B)}


@pytest.mark.parametrize("B, n", [(5, 2), (5, 8), (3, 4), (8, 2)])
def test_pad_batch_to_devices_matches_jax(B, n):
    """Phantom rows: zeros, text_lengths 1, scalars kept, the JAX
    function's output bit for bit."""
    got = pad_batch_to_devices(batch(B), n)
    ref = jmesh.pad_batch_to_devices(batch(B), n)
    assert set(got) == set(ref)
    for k, r in ref.items():
        assert np.asarray(got[k]).dtype == np.asarray(r).dtype, k
        np.testing.assert_array_equal(got[k], r, err_msg=k)
    assert len(got["text"]) == -(-B // n) * n
    assert (got["text_lengths"][B:] == 1).all() and not got["mel_lengths"][B:].any()


@pytest.mark.parametrize("shapes", [(10, 16, 14, 20), (10, 16, 10, 16), (6, 12, 10, 16)])
def test_sync_pad_rule_matches_jax(shapes, monkeypatch):
    """A batch of text t / mel m padded to the group's largest (g_text,
    g_mel): the port's rule against the JAX `sync_batch_shapes` in a
    two-process job whose all-gather reports both processes' lengths;
    single-process calls of either return the batch itself."""
    from jax.experimental import multihost_utils

    t, m, g_text, g_mel = shapes
    b = batch(3, t, m, seed=2)
    assert sync_batch_shapes(b, 2) is b and jmesh.sync_batch_shapes(b, 2) is b
    monkeypatch.setattr(jax, "process_count", lambda: 2)
    monkeypatch.setattr(multihost_utils, "process_allgather",
                        lambda x: np.stack([x, np.array([g_text, g_mel], np.int32)]))
    ref = jmesh.sync_batch_shapes(b, 2)
    got = pad_batch_shapes(b, max(t, g_text), max(m, g_mel), 2)
    assert set(got) == set(ref)
    for k, r in ref.items():
        np.testing.assert_array_equal(got[k], r, err_msg=k)


def test_make_mesh_shard_batch_and_replicate():
    """A mesh of named devices (one named twice); shard_batch cuts the
    batch into contiguous shards on each device and refuses a batch that
    does not divide; replicate gives one replica a distinct device: the
    module itself on its own device, one copy for every entry of another
    (here the meta device), rebuilt when the module's weights change, and
    the mesh keeps no module alive."""
    import gc

    mesh = make_mesh(devices=["cpu", "cpu"])
    assert mesh.size == 2 and mesh.devices == (torch.device("cpu"),) * 2
    assert make_mesh(1, devices=["cpu", "cpu"]).size == 1
    b = batch(4)
    shards = shard_batch(b, mesh)
    for i, sh in enumerate(shards):
        np.testing.assert_array_equal(sh["text"].numpy(), b["text"][2 * i:2 * i + 2])
        assert sh["n_real"] is b["n_real"]
    with pytest.raises(ValueError, match="does not divide"):
        shard_batch(batch(3), mesh)
    lin = torch.nn.Linear(3, 2)
    assert replicate(mesh, lin) == [lin, lin]
    mesh = make_mesh(devices=["cpu", "meta", "cpu", "meta"])
    reps = replicate(mesh, lin)
    assert reps[0] is lin and reps[2] is lin and reps[1] is reps[3] and reps[1] is not lin
    assert reps[1].weight.device.type == "meta" and reps[1].weight.shape == lin.weight.shape
    assert replicate(mesh, lin)[1] is reps[1]
    with torch.no_grad():
        lin.weight.add_(1.0)
    again = replicate(mesh, lin)
    assert again[1] is not reps[1] and again[1] is again[3]
    del lin, reps, again
    gc.collect()
    assert len(mesh._replicas) == 0


def test_each_devices_shards_run_with_that_device_current(monkeypatch):
    """Shards on distinct CUDA devices run in a thread a device, each with
    its device made current, so that what launches on the current device
    (the CUDA kernels' launchers) runs on the shard's card and not on the
    thread's default cuda:0; the shards of one device run one after
    another. With no card here, the device context, the shards and the
    replicas are stand-ins, and each replica records the current device
    and the thread its inference sees."""
    import threading

    from your_voice_tts_torch import parallel
    from your_voice_tts_torch.infer import synthesis as syn

    current = threading.local()

    class Device:
        def __init__(self, device):
            self.index = torch.device(device).index

        def __enter__(self):
            self.prev, current.index = getattr(current, "index", 0), self.index

        def __exit__(self, *exc):
            current.index = self.prev

    seen = []

    class Replica:
        def __init__(self, device):
            self.device = device

        def inference(self, text, lengths, **kw):
            seen.append((self.device.index, getattr(current, "index", 0),
                         threading.current_thread().name))
            return {"postnet_outputs": torch.zeros(len(text), 3, 2),
                    "mel_lengths": torch.as_tensor(lengths)}

    def shards(rows, mesh):
        n = len(rows["text"]) // mesh.size
        return [{k: torch.as_tensor(v[i * n:(i + 1) * n]) for k, v in rows.items()}
                for i in range(mesh.size)]

    monkeypatch.setattr(torch.cuda, "device", Device)
    monkeypatch.setattr(parallel, "shard_batch", shards)
    monkeypatch.setattr(parallel, "replicate", lambda mesh, model: [Replica(d) for d in mesh.devices])
    mesh = make_mesh(devices=["cuda:0", "cuda:1", "cuda:0", "cuda:1"])
    text, lengths = np.ones((7, 4), np.int64), np.full(7, 4)
    out = syn._mesh_inference(mesh, None, text, lengths, {}, {})
    assert out["postnet_outputs"].shape == (7, 3, 2)
    assert sorted(s[:2] for s in seen) == [(0, 0), (0, 0), (1, 1), (1, 1)]
    threads = {d: {s[2] for s in seen if s[0] == d} for d in (0, 1)}
    assert all(len(t) == 1 for t in threads.values()) and threads[0] != threads[1]
    assert threading.main_thread().name not in threads[0] | threads[1]


@pytest.fixture(scope="module")
def synths():
    """(JAX Synthesizer, port Synthesizer) on the smoke checkpoint, dropout
    off, 64 decode steps."""
    def off(cfg):
        return dataclasses.replace(cfg, model=dataclasses.replace(
            cfg.model, prenet_dropout=False, max_decoder_steps=64))

    return (JaxSynthesizer(off(jax_load_config(CONFIG)), CKPT),
            Synthesizer(off(load_config(CONFIG)), CKPT, device="cpu",
                        decode_dtype=torch.float32))


def test_sharded_serving_matches_jax_and_the_unsharded_call(synths):
    """5 texts on a mesh of two CPU devices (padded to 6 by repeating row
    0): each postnet spectrogram against the JAX mesh route's (8 devices)
    and the port's unsharded call's, the lengths exact, the waveforms
    finite and of the unsharded call's lengths."""
    jax_s, port = synths
    ref = jax_synthesis_batch(jax_s.model, jax_s.variables, TEXTS, jax_s.cfg, jax_s.ap,
                              mesh=jmesh.make_mesh())
    mesh = make_mesh(devices=["cpu", "cpu"])
    kw = dict(max_decoder_steps=64, decode_dtype=torch.float32)
    got = synthesis_batch(port.model, TEXTS, port.cfg, port.ap, mesh=mesh, **kw)
    plain = synthesis_batch(port.model, TEXTS, port.cfg, port.ap, **kw)
    assert len(got) == len(ref) == len(plain) == 5
    for g, r, p in zip(got, ref, plain):
        assert g["mel_postnet_spec"].shape == r["mel_postnet_spec"].shape \
            == p["mel_postnet_spec"].shape
        np.testing.assert_allclose(g["mel_postnet_spec"], r["mel_postnet_spec"], atol=1e-4)
        np.testing.assert_allclose(g["mel_postnet_spec"], p["mel_postnet_spec"], atol=1e-5)
        assert g["wav"].shape == p["wav"].shape and np.isfinite(g["wav"]).all()
    assert len(mesh._replicas) == 1
