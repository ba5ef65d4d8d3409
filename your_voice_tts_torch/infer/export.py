"""Serving export (the JAX package's infer/export.py): the end-to-end
synthesis program as torch.export artifacts.

One `ExportedProgram` per (batch, text bucket) shape, saved with
`torch.export.save` as `serve_b{B}_t{T}.pt2`, holds the whole serving
computation: embedding -> encoder -> decode (a ParallelTTS: durations ->
length regulator -> conv decoder) -> postnet -> tail mask -> Griffin-Lim
(or a MelGAN / PWGAN generator) -> de-emphasis, with the
weights as the program's own parameters and buffers. The decode and
Griffin-Lim kernels are ops of its graph (`ops/library.py`): an artifact
exported on `cuda` launches the hand-written kernels and serves on `cuda`
only; one exported on `cpu` runs their plain versions. Serving needs torch,
the op registrations, the text frontend and numpy; no model code, no
checkpoint (`ExportedSynthesizer`). `bin/export_serving.py` writes the
artifacts.

The JAX export's `platforms`, `use_pallas` and PRNG key become the model's
device and an int64 seed tensor [1]: it keys the decode's prenet dropout,
Tacotron(1)'s encoder prenet dropout, the Griffin-Lim phase (one pattern
every row shares) and PWGAN's noise, all drawn inside the program from the
hash PRNG (`ops/prng.py`).

As in the JAX export, each row's frames past its own stop are set to
normalized silence before the waveform stage, and Griffin-Lim runs over the
full steps * r frames: an artifact's audio is held against its own
unexported program (`make_serving_fn`), not against `Synthesizer.tts`,
which trims rows first.
"""

from __future__ import annotations

import json
import math
import os
import warnings

import numpy as np
import torch
from torch import nn

from ..ops import library  # noqa: F401  (registers the ops a loaded program calls)
from ..ops.prng import NOISE_SALTS, normal, seed_key

MANIFEST_NAME = "manifest.json"
SE_MANIFEST_NAME = "speaker_encoder.json"
SEED = "int64 [1]"


def mask_tail(spec, mel_lengths, fill):
    """Frames of each row past its mel_lengths -> `fill` (normalized
    silence: a float tensor, one value or one a bin): the decode runs until
    every row stops, so a row's frames past its own stop depend on its
    batchmates and would reach its audio through the overlap-add."""
    keep = torch.arange(spec.shape[1], device=spec.device)[None, :, None] < \
        mel_lengths[:, None, None]
    return torch.where(keep, spec, fill.to(spec.dtype))


class VocoderStage(nn.Module):
    """A MelGAN or PWGAN generator as the waveform stage: mel [B, T, n_mels]
    and the seed -> [B, T * hop]; PWGAN's noise is drawn from the seed
    (`ops.prng.normal`)."""

    def __init__(self, vocoder):
        super().__init__()
        self.kind = vocoder.cfg.model
        if self.kind not in ("melgan", "pwgan"):
            raise NotImplementedError(f"export supports melgan/pwgan vocoders, not "
                                      f"{self.kind!r}")
        self.generator = vocoder.model

    def forward(self, spec, seed):
        if self.kind == "melgan":
            return self.generator(spec)
        B, T, _ = spec.shape
        noise = normal((B, T * self.generator.hop), seed_key(seed), NOISE_SALTS, spec.device)
        return self.generator(spec, noise=noise)


class ServingProgram(nn.Module):
    """(text [B, T] int64, lengths [B] int64, [speaker ids [B] int64 or
    d-vectors [B, D] float32,] [style mel [B, F, n_mels] float32,] seed
    int64 [1]) -> (wav [B, L] float32, mel_lengths [B] int64), on the
    model's device. The model's traced inference (`inference(...,
    traced=)`), the tail mask, the waveform stage."""

    def __init__(self, model, traced, wave, *, max_steps: int, compute_dtype, decode_dtype,
                 speaker_mode, has_style: bool, fill):
        super().__init__()
        self.model, self.traced, self.wave = model, traced, wave
        self.max_steps, self.compute_dtype, self.decode_dtype = max_steps, compute_dtype, \
            decode_dtype
        self.speaker_mode, self.has_style = speaker_mode, has_style
        self.register_buffer("fill", torch.as_tensor(fill, dtype=torch.float32,
                                                     device=model.device))

    def spectrogram(self, text, lengths, *inputs):
        """The spectrogram stage: (the postnet's spectrogram [B, steps * r,
        F], each row's tail masked to silence, mel_lengths [B])."""
        *cond, seed = inputs
        kw = {}
        if self.speaker_mode is not None:
            kw["speaker_ids" if self.speaker_mode == "id" else "speaker_embeddings"] = cond.pop(0)
        if self.has_style:
            kw["style_mel"] = cond.pop(0)
        out = self.model.inference(text, lengths, max_decoder_steps=self.max_steps, seed=seed,
                                   decode_dtype=self.decode_dtype,
                                   compute_dtype=self.compute_dtype, traced=self.traced, **kw)
        return mask_tail(out["postnet_outputs"], out["mel_lengths"], self.fill), \
            out["mel_lengths"]

    def forward(self, text, lengths, *inputs):
        spec, mel_lengths = self.spectrogram(text, lengths, *inputs)
        return self.wave(spec, inputs[-1]), mel_lengths


def make_serving_fn(model, cfg, ap, *, max_decoder_steps=None, vocoder=None, speaker_mode=None,
                    style_frames=None, decode_dtype=torch.bfloat16) -> ServingProgram:
    """The end-to-end serving program (`ServingProgram`) on the model's
    device, unexported: what `export_serving` traces, and what an artifact
    is held against.

    vocoder: an optional VocoderSynthesizer whose MelGAN / PWGAN generator
    replaces Griffin-Lim (WaveRNN is excluded, as in the JAX export).
    speaker_mode: None, "id" (speaker ids [B]) or "dvector" (d-vectors
    [B, D]). style_frames: a GST model's style-mel input [B, style_frames,
    n_mels]. The config's `inference_compute_dtype` applies; Tacotron(1)'s
    linear head inverts without the mel pseudo-inverse; neural vocoders
    take a mel model. A Tacotron(1) that decodes on the step loop (Graves,
    the location attention's options) raises NotImplementedError. A
    ParallelTTS runs its float32 inference with its frame cap
    (`max_frames`, or max_decoder_steps frames), durations and all on the
    device, every shape static."""
    from ..audio import GriffinLimStage

    if speaker_mode not in (None, "id", "dvector"):
        raise ValueError(f"unknown speaker_mode {speaker_mode!r}")
    from ..models.tacotron import STEP_LOOP_EXPORT, Tacotron

    if isinstance(model, Tacotron) and not model.decoder.kernel_supported():
        raise NotImplementedError(STEP_LOOP_EXPORT)
    is_linear = getattr(model, "output_type", "mel") == "linear"
    compute_dtype = (torch.bfloat16 if cfg.model.inference_compute_dtype == "bfloat16"
                     else None)
    if vocoder is not None:
        if is_linear:
            raise NotImplementedError("neural vocoders take mel input")
        wave = VocoderStage(vocoder)
    else:
        wave = GriffinLimStage(ap, "linear" if is_linear else "mel")
    return ServingProgram(
        model, model.serving_weights(compute_dtype, decode_dtype), wave,
        max_steps=max_decoder_steps or getattr(model, "max_frames", cfg.model.max_decoder_steps),
        compute_dtype=compute_dtype, decode_dtype=decode_dtype, speaker_mode=speaker_mode,
        has_style=style_frames is not None,
        fill=ap._silence_fill("linear" if is_linear else "mel")).eval()


def _export(program: nn.Module, args: tuple, path: str) -> None:
    """torch.export `program` at `args` and save it; a tensor the program
    reads that is not one of its parameters or buffers (torch.export's
    "assigned during export" warning) would be missing from the file, so
    that warning raises."""
    with warnings.catch_warnings():
        warnings.filterwarnings("error", message=".*assigned during export")
        with torch.no_grad():
            ep = torch.export.export(program, args, strict=False)
    torch.export.save(ep, path)


def export_serving(model, cfg, ap, out_dir: str, *, batch_sizes=(1,), text_buckets=(128,),
                   max_decoder_steps=None, vocoder=None, speaker_mode=None, d_dim=None,
                   speakers=None, style_frames=None, decode_dtype=torch.bfloat16) -> dict:
    """Export one artifact per (batch, text bucket) shape into out_dir and
    write the manifest; returns it. Exports on the model's device: CUDA
    artifacts carry the kernels, CPU artifacts their plain versions.
    speaker_mode "id" / "dvector" adds a speaker input (d_dim required for
    "dvector"); `speakers` (name -> id or d-vector) goes into the manifest
    so that named speakers serve from the directory alone. style_frames
    adds a GST style-mel input. See `make_serving_fn`."""
    program = make_serving_fn(model, cfg, ap, max_decoder_steps=max_decoder_steps,
                              vocoder=vocoder, speaker_mode=speaker_mode,
                              style_frames=style_frames, decode_dtype=decode_dtype)
    if speaker_mode == "dvector" and not d_dim:
        raise ValueError("speaker_mode='dvector' needs d_dim")
    dev = model.device
    os.makedirs(out_dir, exist_ok=True)
    steps = program.max_steps
    n_mels = cfg.audio.num_mels
    entries = []
    for B in batch_sizes:
        for T in text_buckets:
            args = [torch.ones(B, T, dtype=torch.int64, device=dev),
                    torch.full((B,), T, dtype=torch.int64, device=dev)]
            if speaker_mode == "id":
                args.append(torch.zeros(B, dtype=torch.int64, device=dev))
            elif speaker_mode == "dvector":
                args.append(torch.zeros(B, d_dim, device=dev))
            if style_frames is not None:
                args.append(torch.zeros(B, style_frames, n_mels, device=dev))
            args.append(torch.zeros(1, dtype=torch.int64, device=dev))
            name = f"serve_b{B}_t{T}.pt2"
            _export(program, tuple(args), os.path.join(out_dir, name))
            entries.append({"file": name, "batch": B, "text_bucket": T})
    if vocoder is None:
        waveform, upsample = "griffin_lim", ap.hop_length
    else:
        waveform = vocoder.cfg.model
        upsample = math.prod(getattr(vocoder.cfg, waveform).upsample_factors)
    manifest = {
        "entries": entries,
        "platforms": [dev.type],
        "torch_version": torch.__version__,
        "sample_rate": cfg.audio.sample_rate,
        "hop_length": ap.hop_length,
        # the active reduction factor, which a checkpoint's meta may have set
        "r": getattr(model, "r", cfg.model.r),
        "max_decoder_steps": steps,
        "waveform": waveform,
        "samples_per_frame": upsample,
        "seed": SEED,
        "inputs": "text ids [B, T] int64 (zero-padded), lengths [B] int64"
                  + {"id": ", speaker ids [B] int64",
                     "dvector": f", d-vectors [B, {d_dim}] float32"}.get(speaker_mode, "")
                  + (f", style mel [B, {style_frames}, {n_mels}] float32"
                     if style_frames is not None else "")
                  + f", seed {SEED}",
        "outputs": "wav [B, L] float32, mel_lengths [B] int64",
    }
    if speaker_mode is not None:
        manifest["speaker_input"] = {"kind": speaker_mode, "dim": d_dim}
        if speakers:
            manifest["speakers"] = {k: (v if isinstance(v, int) else list(map(float, v)))
                                    for k, v in speakers.items()}
    if style_frames is not None:
        manifest["style_input"] = {"frames": style_frames, "num_mels": n_mels}
    manifest["num_chars"] = model.embedding.num_embeddings
    dcfg = getattr(cfg, "data", None)
    if dcfg is not None:
        # enough of the text frontend to reproduce the ids the program was
        # traced for (ExportedSynthesizer.text_to_ids)
        manifest["text"] = {
            "use_phonemes": dcfg.use_phonemes,
            "text_cleaner": dcfg.text_cleaner,
            "phoneme_language": dcfg.phoneme_language,
            "enable_eos_bos": dcfg.enable_eos_bos_chars,
            "cmudict_path": dcfg.cmudict_path,
            "g2p_backend": getattr(dcfg, "g2p_backend", None),
        }
    with open(os.path.join(out_dir, MANIFEST_NAME), "w", encoding="utf-8") as f:
        json.dump(manifest, f, indent=1)
    return manifest


def export_speaker_encoder(enc, out_dir: str, *, input_dim: int, batch_sizes=(8,),
                           num_frames: int = 160, overlap: float = 0.5) -> dict:
    """Export the GE2E speaker encoder (mel windows [B, F, M] -> L2-normed
    d-vectors [B, D]) on its device, one artifact a batch size, so that the
    cloning pipeline (reference audio -> d-vector -> speech) serves from
    artifacts alone. The windowing over an utterance stays on the host
    (`ExportedSpeakerEncoder.embed`), as `SpeakerEncoder.compute_embedding`
    does it."""
    dev = enc.device
    os.makedirs(out_dir, exist_ok=True)
    entries = []
    for B in batch_sizes:
        name = f"embed_b{B}_f{num_frames}.pt2"
        _export(enc.eval(), (torch.zeros(B, num_frames, input_dim, device=dev),),
                os.path.join(out_dir, name))
        entries.append({"file": name, "batch": B})
    manifest = {"entries": entries, "platforms": [dev.type], "torch_version": torch.__version__,
                "num_frames": num_frames, "input_dim": input_dim, "proj_dim": enc.proj_dim,
                "overlap": overlap}
    with open(os.path.join(out_dir, SE_MANIFEST_NAME), "w", encoding="utf-8") as f:
        json.dump(manifest, f, indent=1)
    return manifest


def _load_programs(artifact_dir: str, manifest: dict, key,
                   device=None) -> tuple[dict, torch.device]:
    """Each entry's program (`ExportedProgram.module()`) by key(entry), and
    the device it serves on: the one it was exported on. A CUDA artifact
    without CUDA raises, and so does another `device` than that one."""
    platform = manifest["platforms"][0]
    if device is not None and torch.device(device).type != platform:
        raise ValueError(f"{artifact_dir} was exported on {platform} and serves there only, "
                         f"not on {device}")
    if platform == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"{artifact_dir} was exported on cuda and serves on cuda only, "
                           "and CUDA is not available")
    fns = {}
    for e in manifest["entries"]:
        fns[key(e)] = torch.export.load(os.path.join(artifact_dir, e["file"])).module()
    return fns, torch.device(platform)


class ExportedSpeakerEncoder:
    """Compute d-vectors from an export_speaker_encoder() directory."""

    def __init__(self, artifact_dir: str):
        with open(os.path.join(artifact_dir, SE_MANIFEST_NAME), encoding="utf-8") as f:
            self.manifest = json.load(f)
        self._fns, self.device = _load_programs(artifact_dir, self.manifest, lambda e: e["batch"])

    @torch.no_grad()
    def _call_batched(self, wins: np.ndarray) -> np.ndarray:
        """wins [N, F, M] -> [N, D], chunked through the exported batches."""
        caps = sorted(self._fns)
        out, i = [], 0
        while i < len(wins):
            B = next((b for b in caps if b >= len(wins) - i), caps[-1])
            chunk = wins[i: i + B]
            pad = np.zeros((B, *wins.shape[1:]), np.float32)
            pad[: len(chunk)] = chunk
            got = self._fns[B](torch.from_numpy(pad).to(self.device))
            out.append(got.cpu().numpy()[: len(chunk)])
            i += len(chunk)
        return np.concatenate(out)

    def embed(self, mel: np.ndarray) -> np.ndarray:
        """Sliding-window utterance embedding [T, M] -> [D], the
        SpeakerEncoder.compute_embedding contract on host windows."""
        F = self.manifest["num_frames"]
        mel = np.asarray(mel, np.float32)
        T = mel.shape[0]
        if T <= F:
            reps = -(-F // T)
            wins = np.tile(mel, (reps, 1))[None, :F]
        else:
            hop = max(1, int(F * (1 - self.manifest["overlap"])))
            starts = list(range(0, T - F + 1, hop)) or [0]
            wins = np.stack([mel[s: s + F] for s in starts])
        embs = self._call_batched(wins)
        if len(embs) == 1:
            return embs[0]
        mean = embs.mean(axis=0)
        return mean / max(float(np.linalg.norm(mean)), 1e-8)


class ExportedSynthesizer:
    """Serve from an export_serving() directory, with no model code: the
    loaded programs, the manifest's text frontend and speaker table."""

    def __init__(self, artifact_dir: str, device=None):
        """device: the device the artifact was exported on (its manifest's
        platform), or None; another raises."""
        with open(os.path.join(artifact_dir, MANIFEST_NAME), encoding="utf-8") as f:
            self.manifest = json.load(f)
        self._fns, self.device = _load_programs(
            artifact_dir, self.manifest, lambda e: (e["batch"], e["text_bucket"]), device)

    def shapes(self):
        return sorted(self._fns)

    def text_to_ids(self, text: str) -> np.ndarray:
        """The ids of the frontend recorded in the manifest (the one the
        artifact was traced with)."""
        tcfg = self.manifest.get("text") or {}
        if tcfg.get("use_phonemes"):
            from ..text import default_g2p_backend, phoneme_to_sequence

            backend = default_g2p_backend(tcfg.get("phoneme_language", "en-us"),
                                          tcfg.get("cmudict_path"),
                                          prefer=tcfg.get("g2p_backend"))
            seq = phoneme_to_sequence(text, tcfg.get("text_cleaner", "phoneme_cleaners"),
                                      language=tcfg.get("phoneme_language", "en-us"),
                                      enable_eos_bos=tcfg.get("enable_eos_bos", False),
                                      backend=backend)
        else:
            from ..text import text_to_sequence

            seq = text_to_sequence(text, tcfg.get("text_cleaner", "basic_cleaners"))
        ids = np.asarray(seq, np.int64)
        n_chars = self.manifest.get("num_chars")
        if n_chars is not None and ids.size and int(ids.max()) >= n_chars:
            raise ValueError(
                f"text maps to id {int(ids.max())} but the exported model embeds only "
                f"{n_chars} symbols — the artifact was traced with a different symbol table "
                "than this frontend")
        return ids

    def _resolve_speaker(self, speaker):
        """Validate ONE request's speaker against the manifest: an int id, a
        d-vector [D], or None for a single-voice artifact. It raises per
        request (unknown name, wrong width), so under micro-batched serving
        a bad speaker fails alone."""
        spec = self.manifest.get("speaker_input")
        if spec is None:
            if speaker is not None:
                raise ValueError("this artifact closes over one voice; export with "
                                 "speaker_mode to serve multiple speakers")
            return None
        table = self.manifest.get("speakers") or {}
        if isinstance(speaker, str) and speaker in table:
            speaker = table[speaker]
        elif speaker is None:
            if not table:
                raise ValueError("artifact expects a speaker input and records no speaker "
                                 "table; pass one explicitly")
            speaker = next(iter(table.values()))
        if spec["kind"] == "id":
            try:  # HTTP query strings arrive as text: "2" means id 2
                return int(speaker)
            except (TypeError, ValueError):
                raise ValueError(f"unknown speaker {speaker!r}; known: "
                                 f"{sorted(table)}") from None
        if isinstance(speaker, str):  # d-vector artifacts need a table hit
            raise ValueError(f"unknown speaker {speaker!r}; known: {sorted(table)}")
        vec = np.asarray(speaker, np.float32)
        if vec.shape != (spec["dim"],):
            raise ValueError(f"d-vector of dim {spec['dim']} required, got {vec.shape}")
        return vec

    def tts_many(self, texts: list, speakers: list | None = None, seed: int = 0,
                 style_mel=None) -> list:
        """Several independent requests through ONE program call
        (bucket-padded): the device half of the HTTP server's micro-batching.
        `speakers` may mix names, ids and d-vectors (conditioning is per
        row). Returns one float32 waveform a request, cut to its frames."""
        if speakers is None:
            speakers = [None] * len(texts)
        if len(speakers) != len(texts):
            raise ValueError(f"{len(texts)} texts but {len(speakers)} speakers")
        resolved = [self._resolve_speaker(s) for s in speakers]
        seqs = [self.text_to_ids(t) for t in texts]
        B, T = len(texts), max((len(s) for s in seqs), default=1) or 1
        text_ids = np.zeros((B, T), np.int64)
        lens = np.zeros((B,), np.int64)
        for k, seq in enumerate(seqs):
            text_ids[k, : len(seq)] = seq
            lens[k] = len(seq)
        kw = {}
        spec = self.manifest.get("speaker_input")
        if spec is not None:
            if spec["kind"] == "id":
                kw["speaker_ids"] = np.asarray(resolved, np.int64)
            else:
                kw["d_vectors"] = np.stack(resolved).astype(np.float32)
        style_spec = self.manifest.get("style_input")
        if style_spec is not None:
            if style_mel is None:  # a neutral reference keeps GST servable
                style_mel = np.zeros((B, style_spec["frames"], style_spec["num_mels"]),
                                     np.float32)
            kw["style_mel"] = np.asarray(style_mel, np.float32)
        wav, mel_lens = self(text_ids, lens, seed=seed, **kw)
        spf = self.manifest.get("samples_per_frame", self.manifest["hop_length"])
        return [np.asarray(wav[k][: max(int(mel_lens[k]), 1) * spf], np.float32)
                for k in range(B)]

    def encode_wav_bytes(self, wav: np.ndarray) -> bytes:
        """float waveform -> 16-bit mono WAV container bytes (the
        Synthesizer's encoder, kept here so that serving an artifact imports
        no model code)."""
        import io
        import wave

        if wav.size == 0:
            wav = np.zeros((1,), np.float32)
        norm = wav * (32767 / max(0.01, float(np.max(np.abs(wav)))))
        buf = io.BytesIO()
        with wave.open(buf, "wb") as f:
            f.setnchannels(1)
            f.setsampwidth(2)
            f.setframerate(self.manifest["sample_rate"])
            f.writeframes(norm.astype(np.int16).tobytes())
        return buf.getvalue()

    def tts_to_wav_bytes(self, text: str, speaker=None, seed: int = 0, style_mel=None) -> bytes:
        """text -> WAV container bytes, as Synthesizer.tts_to_wav_bytes.
        `speaker`: a name of the manifest's table, an id or a d-vector, by
        the artifact's speaker input; `style_mel` [F, n_mels] for a GST
        artifact (a neutral all-zero reference without one)."""
        sty = None if style_mel is None else np.asarray(style_mel, np.float32)[None]
        wav = self.tts_many([text], [speaker], seed=seed, style_mel=sty)[0]
        return self.encode_wav_bytes(wav)

    @torch.no_grad()
    def __call__(self, text_ids: np.ndarray, lengths: np.ndarray, seed: int = 0,
                 speaker_ids=None, d_vectors=None, style_mel=None):
        """text_ids [B, T] -> (wav [B, L] float32, mel_lengths [B]), numpy.
        Picks the smallest exported shape that fits and pads into it; a
        batch larger than every exported batch is chunked through the
        largest. speaker_ids [B] / d_vectors [B, D] are required iff the
        artifact has that speaker input; style_mel [B, F, M] (tiled or cut
        to the exported window) iff it has a style input."""
        spec = self.manifest.get("speaker_input")
        style_spec = self.manifest.get("style_input")
        B, T = text_ids.shape
        t_fit = [s for s in self._fns if s[1] >= T]
        if not t_fit:
            raise ValueError(f"no exported shape fits (B={B}, T={T}); have {self.shapes()}")
        cap = max(s[0] for s in t_fit)
        if B > cap:
            part = lambda x, i: None if x is None else x[i: i + cap]  # noqa: E731
            parts = [self(text_ids[i: i + cap], lengths[i: i + cap], seed,
                          part(speaker_ids, i), part(d_vectors, i), part(style_mel, i))
                     for i in range(0, B, cap)]
            return (np.concatenate([p[0] for p in parts]),
                    np.concatenate([p[1] for p in parts]))
        Bs, Ts = min(s for s in t_fit if s[0] >= B)
        text = np.zeros((Bs, Ts), np.int64)
        text[:B, :T] = text_ids
        lens = np.zeros((Bs,), np.int64)
        lens[:B] = lengths
        args = [text, lens]
        if spec is not None:
            if spec["kind"] == "id":
                if speaker_ids is None:
                    raise ValueError("artifact expects speaker_ids [B]")
                sid = np.zeros((Bs,), np.int64)
                sid[:B] = np.asarray(speaker_ids, np.int64)
                args.append(sid)
            else:
                if d_vectors is None:
                    raise ValueError(f"artifact expects d_vectors [B, {spec['dim']}]")
                dv = np.zeros((Bs, spec["dim"]), np.float32)
                dv[:B] = np.asarray(d_vectors, np.float32)
                args.append(dv)
        elif speaker_ids is not None or d_vectors is not None:
            raise ValueError("artifact takes no speaker input")
        if style_spec is not None:
            if style_mel is None:
                raise ValueError(f"artifact expects style_mel [B, F, {style_spec['num_mels']}]")
            F = style_spec["frames"]
            style_mel = np.asarray(style_mel, np.float32)
            if style_mel.shape[1] < F:  # a short reference tiles into the window
                style_mel = np.tile(style_mel, (1, -(-F // style_mel.shape[1]), 1))
            sty = np.zeros((Bs, F, style_spec["num_mels"]), np.float32)
            sty[:B] = style_mel[:, :F]
            args.append(sty)
        elif style_mel is not None:
            raise ValueError("artifact takes no style input")
        args.append(np.asarray([seed], np.int64))
        wav, mel_lens = self._fns[(Bs, Ts)](*(torch.from_numpy(a).to(self.device)
                                              for a in args))
        return wav.cpu().numpy()[:B], mel_lens.cpu().numpy()[:B]
