"""One rank of a gloo process group on the CPU, for the data-parallel cases
of tests/test_torch_distribute.py (one spawn of every rank for the whole
family). It imports the port and torch only.

    python tests/torch_dp_worker.py <job_dir> <rank> <world>

<job_dir>/job.pt holds {case name: case dict}, written by the test with
torch.save; each case names its `kind` and carries its config, its starting
weights (port layout) and its GLOBAL batch, of which this rank takes rows
[rank * n, (rank + 1) * n). The results go to <job_dir>/result<rank>.pt:
{case name: what the case returns}, weights in the JAX layout.
"""

import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def local(batch: dict, rank: int, world: int) -> dict:
    n = len(batch["text"] if "text" in batch else batch["mel"]) // world
    return {k: v[rank * n:(rank + 1) * n] for k, v in batch.items()}


def moments(model, adam) -> dict:
    """Adam's first and second moments in the JAX layout."""
    from your_voice_tts_torch.train.checkpoint import _swapped, params_to_jax

    out = {}
    for kind in ("mu", "nu"):
        with _swapped(model, getattr(adam, kind)):
            out[kind] = {k: v.copy() for k, v in params_to_jax(model)[0].items()}
    return out


def capture_grads(trainer) -> dict:
    """Make `trainer`'s optimizer record the gradients it is handed (after
    the ranks' sum), in the JAX layout, under "grads" of the dict
    returned."""
    from your_voice_tts_torch.train.checkpoint import _swapped, params_to_jax

    seen, step = {}, trainer.optimizer.step

    def recording(grads):
        with _swapped(trainer.model, [g.detach().float() for g in grads]):
            seen["grads"] = {k: v.copy() for k, v in params_to_jax(trainer.model)[0].items()}
        return step(grads)

    trainer.optimizer.step = recording
    return seen


def tts_case(case, rank, world):
    """One `Trainer.train_step` on this rank's rows, dropout off."""
    from your_voice_tts_torch.train.checkpoint import params_to_jax
    from your_voice_tts_torch.train.trainer import Trainer

    trainer = Trainer(case["cfg"], verbose=False, device="cpu")
    trainer.generator = None
    trainer.model.load_state_dict(case["state"], strict=True)
    seen = capture_grads(trainer)
    metrics = trainer.train_step(local(case["batch"], rank, world), case["r"])
    params, state = params_to_jax(trainer.model)
    return {"metrics": metrics, "params": params, "state": state, "step": trainer.step,
            "grads": seen["grads"]}


def gan_case(case, rank, world):
    """One `GANTrainer.train_step` (generator, then discriminator) on this
    rank's rows; the discriminator step regenerates its fake from
    case["g_after"] (the reference step's updated generator), as
    tests/test_torch_vocoder_train.py's `port_gan_step` holds it."""
    from your_voice_tts_torch.train.checkpoint import jax_layouts, params_from_jax, params_to_jax
    from your_voice_tts_torch.vocoder.train_gan import GANTrainer

    pt = GANTrainer(case["cfg"], case["items"], verbose=False, device="cpu")
    pt.generator.load_state_dict(case["g_state"], strict=True)
    pt.discriminator.load_state_dict(case["d_state"], strict=True)
    seen = {}
    d_loss = pt.d_loss

    def from_the_same_generator(*args, **kwargs):
        seen["g"] = {k: v.copy() for k, v in params_to_jax(pt.generator)[0].items()}
        pt.generator.load_state_dict(params_from_jax(case["g_after"], {},
                                                     jax_layouts(pt.generator)), strict=True)
        return d_loss(*args, **kwargs)

    pt.d_loss = from_the_same_generator
    b = local({"mel": case["mel"], "audio": case["audio"]}, rank, world)
    parts = pt.train_step(b["mel"], b["audio"])
    return {"parts": parts, "g": seen["g"], "d": params_to_jax(pt.discriminator)[0],
            "g_moments": moments(pt.generator, pt.g_opt),
            "d_moments": moments(pt.discriminator, pt.d_opt), "global_batch": pt.global_batch}


def wavernn_case(case, rank, world):
    """One `WaveRNNTrainer.train_step` on this rank's rows."""
    from your_voice_tts_torch.train.checkpoint import params_to_jax
    from your_voice_tts_torch.vocoder.train_wavernn import WaveRNNTrainer

    pt = WaveRNNTrainer(case["cfg"], case["items"], verbose=False, device="cpu")
    pt.model.load_state_dict(case["state"], strict=True)
    b = local({"mel": case["mel"], "audio": case["audio"]}, rank, world)
    loss = pt.train_step(b["mel"], b["audio"])
    return {"loss": loss, "params": params_to_jax(pt.model)[0],
            "moments": moments(pt.model, pt.optimizer)}


def ptts_case(case, rank, world):
    """bin/train_parallel.py's data-parallel step: the global batch padded
    to the world size and cut to this rank's rows (`local_rows`), then
    `step_grads` (dropout off)."""
    import torch

    from your_voice_tts_torch.bin.train_parallel import local_rows, step_grads
    from your_voice_tts_torch.models import setup_model
    from your_voice_tts_torch.models.parallel_tts import ParallelTTSLoss
    from your_voice_tts_torch.text import symbols

    model = setup_model(len(symbols), case["cfg"], device="cpu")
    model.load_state_dict(case["state"], strict=True)
    b = local_rows(case["batch"], world, rank)
    b = {k: torch.as_tensor(v) for k, v in b.items()}
    parts, grads = step_grads(model, ParallelTTSLoss(), b)
    names = [n for n, p in model.named_parameters() if p.requires_grad]
    return {"parts": {k: float(v) for k, v in parts.items()},
            "grads": {n: g.numpy() for n, g in zip(names, grads)}, "rows": len(b["text"])}


class _Fixed:
    """A speaker-encoder dataset whose every batch is `mels`."""

    def __init__(self, mels):
        self.mels = mels

    def sample_batch(self, N, M, rng):
        return self.mels


def ge2e_case(case, rank, world):
    """One `SpeakerEncoderTrainer` step (`fit(1)`, every rank drawing the
    same batch, N / world speakers embedded a rank)."""
    from your_voice_tts_torch.speaker_encoder.model import SpeakerEncoder, params_to_jax
    from your_voice_tts_torch.speaker_encoder.train import SpeakerEncoderTrainer

    mels = case["mels"]
    pm = SpeakerEncoder(*case["dims"], recur_on_proj=True, device="cpu")
    pm.load_state_dict(case["state"], strict=True)
    pt = SpeakerEncoderTrainer(pm, _Fixed(mels), lr=case["lr"], num_speakers_per_batch=len(mels),
                               num_utters_per_speaker=mels.shape[1], verbose=False,
                               device="cpu")
    loss = pt.fit(1)["loss"]
    return {"loss": loss, "params": params_to_jax(dict(pm.named_parameters())),
            "w": pt.loss_params["w"].item(), "mu": pt._jax_trees(pt.mu)}


def sync_case(case, rank, world):
    """`sync_batch_shapes` of this rank's own batch."""
    from your_voice_tts_torch.parallel import sync_batch_shapes

    return sync_batch_shapes(case["batches"][rank], case["r"])


CASES = {"tts": tts_case, "gan": gan_case, "wavernn": wavernn_case, "ptts": ptts_case,
         "ge2e": ge2e_case, "sync": sync_case}


def main() -> None:
    job_dir, rank, world = sys.argv[1], int(sys.argv[2]), int(sys.argv[3])
    sys.path.insert(0, ROOT)
    import torch
    import torch.distributed as dist

    torch.set_num_threads(1)
    job = torch.load(os.path.join(job_dir, "job.pt"), weights_only=False)
    dist.init_process_group("gloo", init_method=f"file://{job_dir}/store", world_size=world,
                            rank=rank)
    try:
        results = {name: CASES[case["kind"]](case, rank, world) for name, case in job.items()}
    finally:
        dist.destroy_process_group()
    torch.save(results, os.path.join(job_dir, f"result{rank}.pt"))


if __name__ == "__main__":
    main()
