"""Convert an upstream torch checkpoint (.pth.tar) to the port's .npz (the
JAX package's bin/import_checkpoint.py):

    python -m your_voice_tts_torch.bin.import_checkpoint ckpt.pth.tar config.json \\
        out.npz [--kind tacotron2|speaker_encoder|wavernn|melgan|pwgan] \\
        [--num_speakers N --speaker_embedding_dim D]

Reads the reference pickle ({"model": state_dict, "r", "step", ...}),
converts names and layouts through utils/torch_import.py into a template
of the port model's own JAX-layout leaves, loads the result into the port
model and writes it with `train.checkpoint.save_checkpoint`: the file every
consumer loads (bin/synthesize, bin/server, bin/train --restore_path, the
vocoder facade, `load_encoder`). Source keys that map to nothing, and
targets whose shape disagrees (kept at their initial values), are printed.
Host work only: the model is built on the CPU and nothing runs on a card.
"""

from __future__ import annotations

import argparse

KINDS = ("tacotron2", "speaker_encoder", "wavernn", "melgan", "pwgan")


def _report(report: dict) -> None:
    print(f"mapped {report['mapped']} source tensors")
    if report["unused_source_keys"]:
        print("WARNING: NOT transferred (no matching target):")
        for k in report["unused_source_keys"]:
            print(f"  - {k}")
    if report.get("shape_mismatches"):
        print("WARNING: shape mismatches (kept init values):")
        for k in report["shape_mismatches"]:
            print(f"  - {k}")


def _vocoder(kind: str, config_path: str):
    """The port's vocoder model of `kind` at the vocoder config's widths,
    on the CPU."""
    from ..vocoder.config import load_vocoder_config
    from ..vocoder.models.melgan import MelganGenerator
    from ..vocoder.models.pwgan import ParallelWaveganGenerator
    from ..vocoder.models.wavernn import WaveRNN

    vcfg = load_vocoder_config(config_path)
    n_mels = vcfg.audio.num_mels
    if kind == "melgan":
        g = vcfg.melgan
        return MelganGenerator(n_mels, g.upsample_factors, g.base_channels, g.num_res_blocks,
                               g.kernel_size, device="cpu")
    if kind == "pwgan":
        g = vcfg.pwgan
        return ParallelWaveganGenerator(
            n_mels, g.num_layers, g.stacks, g.residual_channels, g.gate_channels,
            g.skip_channels, g.kernel_size, g.upsample_factors,
            aux_context_window=g.aux_context_window, device="cpu")
    w = vcfg.wavernn
    return WaveRNN(n_mels, w.bits, w.rnn_dims, w.fc_dims, w.compute_dims, w.res_out_dims,
                   w.num_res_blocks, w.pad, w.upsample_factors, w.mode,
                   num_mixtures=w.num_mixtures, device="cpu")


def main(argv: list[str] | None = None) -> None:
    p = argparse.ArgumentParser(description="Import an upstream torch checkpoint to npz")
    p.add_argument("torch_checkpoint")
    p.add_argument("config_path")
    p.add_argument("out_path")
    p.add_argument("--kind", choices=KINDS, default="tacotron2")
    p.add_argument("--num_speakers", type=int, default=0)
    p.add_argument("--speaker_embedding_dim", type=int, default=0)
    args = p.parse_args(argv)

    from ..train.checkpoint import jax_layouts, params_from_jax, params_to_jax, save_checkpoint
    from ..utils import torch_import as ti

    sd, meta = ti.load_torch_state_dict(args.torch_checkpoint)
    extra = {"imported_from": args.torch_checkpoint}
    step, epoch = int(meta.get("step", 0)), int(meta.get("epoch", 0))

    if args.kind in ("melgan", "pwgan", "wavernn"):
        model = _vocoder(args.kind, args.config_path)
        convert = {"melgan": ti.convert_melgan_state_dict, "pwgan": ti.convert_pwgan_state_dict,
                   "wavernn": ti.convert_wavernn_state_dict}[args.kind]
        params, report = convert(sd, ti.nest(params_to_jax(model)[0]))
        _report(report)
        model.load_state_dict(params_from_jax(params, {}, jax_layouts(model)), strict=True)
        # the GAN trainer's checkpoint keeps the generator under 'g'
        save_checkpoint(args.out_path, model, step=step, epoch=epoch, r=1, extra=extra,
                        subtree=None if args.kind == "wavernn" else "g")
        print(f"wrote {args.out_path}")
        return

    from ..config import load_config

    cfg = load_config(args.config_path)
    if args.kind == "speaker_encoder":
        from ..speaker_encoder.model import SpeakerEncoder

        # the encoder's size from the source tensors themselves:
        # weight_ih_l0 [4H, in], linear.weight [proj, H]
        wih = next(v for k, v in sd.items() if k.endswith("lstm.weight_ih_l0")
                   and k.startswith("layers.0"))
        lin = next(v for k, v in sd.items() if "layers.0.linear" in k and k.endswith("weight"))
        n_layers = 1 + max(int(k.split(".")[1]) for k in sd if k.startswith("layers."))
        arch = {"input_dim": int(wih.shape[1]), "lstm_dim": int(wih.shape[0] // 4),
                "proj_dim": int(lin.shape[0]), "num_layers": n_layers, "recur_on_proj": False}
        model = SpeakerEncoder(**arch, device="cpu")
        params, report = ti.convert_speaker_encoder_state_dict(
            sd, ti.nest(params_to_jax(model)[0]))
        variables = {"params": params, "state": {}}
        extra["speaker_encoder"] = arch
    else:
        from ..models import setup_model
        from ..text import phonemes, symbols

        num_chars = len(phonemes) if cfg.data.use_phonemes else len(symbols)
        model = setup_model(num_chars, cfg, device="cpu", num_speakers=args.num_speakers,
                            speaker_embedding_dim=args.speaker_embedding_dim)
        params, state = params_to_jax(model)
        variables, report = ti.convert_tacotron2_state_dict(
            sd, {"params": ti.nest(params), "state": ti.nest(state)})
    _report(report)
    model.load_state_dict(params_from_jax(variables["params"], variables["state"],
                                          jax_layouts(model)), strict=True)
    save_checkpoint(args.out_path, model, step=step, epoch=epoch,
                    r=int(meta.get("r", cfg.model.r)), extra=extra)
    print(f"wrote {args.out_path}")


if __name__ == "__main__":
    main()
