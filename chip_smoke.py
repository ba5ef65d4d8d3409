#!/usr/bin/env python3
"""Drive the PyTorch port (your_voice_tts_torch) on one NVIDIA GPU.

    python3 chip_smoke.py            # from the repository root

Phases, each fatal on failure:
1. build: compile every CUDA source of the serving path (one nvcc each, in
   parallel) and print the build seconds and ptxas resource lines;
2. kernels: hold each kernel against its plain PyTorch version at serving
   shapes and time kernel, plain version and a library yardstick:
   - decode: configs/ljspeech_tacotron2.json at full width (r=2 of r_init 7),
     seeded random weights, B=8, text ~150 symbols, 250 steps, dropout on,
     and B=1 beside it: the launch plan, launches a decode (one), kernel
     and plain ms, the probe launches in us a step (the same grid and
     barriers with only the barriers, only the stage-input copies or only
     the products' weight reads kept) and each round's work and barrier
     wait on the SMs' clocks;
   - Griffin-Lim: B=8, T=500, n_fft 1024 / hop 256, 24 iterations,
     momentum 0.95, injected phase; each launch's device time (synthesis,
     OLA, analysis, emit; torch.profiler over the serial probe), held to
     the launches the loop's C call reports issuing;
   - taco1-decode: the Tacotron(1) decode, the same config with the model
     group replaced (Tacotron, width 256, memory 5, r = 7 of r_init 7),
     B=8 (the sentences below, T=160), 250 steps, dropout on, held at
     r = 7 and at r = 5, the memory size (r > memory and r <= memory roll
     the queue differently), and B=1 at r = 7: the launch plan, launches a
     decode (one), kernel and plain ms, us a step, the probe launches and
     each round's work and barrier wait, at B=8 and B=1;
   - gl-iteration: plain Griffin-Lim iterations past the 1,024-frame cap at
     the Tacotron(1) path's launch shapes: the 1,760-frame bucket of its
     1,750 frames, n_fft 1024 / hop 256, 24 iterations, B=8 and B=1; each
     launch's device time (synthesis, OLA, analysis; torch.profiler over
     the serial probe), held to the launches its C call reports issuing;
   - gl-full, beyond the path's shape: the whole FGLA loop returning the
     spectrum, B=8, T=500, n_fft 2048 / hop 275 / window 1102 (a 12.5 ms
     hop), 24 iterations, with each launch's device time (the unpack in
     place of the emit) held to the launches issued, as at the smoke
     path's shape in phase 3;
3. small input: the trained smoke checkpoint through Tacotron2.inference and
   Griffin-Lim on the kernels against the plain versions on the CPU; its
   hop 64 takes the gl-full kernel, whose launches this path counts; then
   the gl-full kernel against its plain version on the same card
   magnitudes at this path's launch shape (the 3 rows padded to 4, 96
   frames, n_fft 256 / hop 64, the config's 15 iterations), timed;
4. main path: Synthesizer.tts_many at full width (max_decoder_steps 250, so
   500 frames a row) answers one batch of 8 sentences and 5 batch-1
   requests, with every launch counter set to 0 just before and read just
   after; prints mel frames/s, real-time factor and p50 batch-1 latency;
   Griffin-Lim stays on the wave route.
4b. taco1-main: Synthesizer on the Tacotron(1) config (250 steps x r=7 =
   1,750 frames a row) answers the batch of 8 and 5 batch-1 requests, the
   counters set to 0 just before and read just after: the Tacotron(1)
   decode and the per-iteration Griffin-Lim kernels launched (3 x the
   config's iterations a call, from one ctypes call), the Tacotron2 decode
   did not; mel frames/s, real-time factor, p50 latency.

5. train-fwd: the training decoder's forward kernel at config #3's shape
   (configs/ljspeech_tacotron2.json at full width, r=2: B=32, T_in=128,
   200 decoder steps, bf16) with the same injected dropout masks as its
   plain version; max abs error of every stack, kernel, plain and bound ms,
   launches a call (2 a step plus one), the same launches without
   programmatic dependence (the same bits; each launch's device time,
   torch.profiler) and the fragment-ordered W copy's time;
6. train-bwd: the backward kernel on phase 5's residuals and seeded random
   cotangents against its plain version, rel L2 of every output, times,
   launches a call (4 a step), the same launches without programmatic
   dependence (the same bits; each launch's device time, torch.profiler)
   and the fragment-ordered W^T copy's time;
7. train main path: (b) Trainer(cfg, device="cuda").fit(max_steps=5) on a
   64-item synthetic corpus (sr 22050, up to 15 words, as bench.py makes
   it), batch 32, r=2, gradual training off: finite losses and gradient
   norms, moved parameters, a checkpoint, with the launch counters set to 0
   just before and read just after; (a) one train step at the bench shape
   (B=32, 128 symbols, 400 mel frames), dropout off, on the kernels and on
   the plain versions: loss and every gradient leaf compared; (c) the timed
   train step at that shape (train step ms, mel frames/s, launches). The
   fit synthesizes the test sentences after each evaluation
   (`Trainer.test_run`): kernel 1 and the Griffin-Lim kernel their frames
   route to launch in the same process as the training scans, no plain
   version called.
7c. taco1-train: (1) one Tacotron(1) train step at full width (width 256,
   memory 5, r = 7, num_freq 513; config #3's batch: B=32, 128 symbols,
   400 frames padded to 406, a linear target), card against CPU from the
   same seeded weights, float32, dropout off: every loss part 1e-4
   relative, all gradients 1e-3 rel L2; (3) the mel and linear statistics
   of a 64-item synthetic corpus (`bin/compute_statistics`), then
   Trainer.fit(max_steps=5) with them and test sentences after each
   evaluation (kernel 8 and the Griffin-Lim kernel `gl_route` picks for
   the decoded frames, no plain version called), its checkpoint served by
   Synthesizer (a batch of 8, 250 steps a row: kernels 8 and 4); (2) the
   timed train step, float32 and mixed precision (CUDA events, median of
   5), its wall and the device's busy share; (4) one step of a
   speaker-table and of a d-vector + GST Tacotron(1) at E = 512; (6)
   Tacotron2 served with the statistics: the magnitudes entering kernel 2
   against the CPU's from the same normalized mels, 1e-5 of the largest.
7b. train-cond (the "your voice" path): (a) kernels 5 and 6 against their
   plain versions at the speaker-conditioned memory widths, phases 5-6's
   inputs and tolerances otherwise: E = 768 (256-wide d-vectors) and
   E = 1,024 (the 512-wide speaker table) at T_in = 128, where the
   forward's attention stages the encoder's columns, and the forward at
   E = 1,024, T_in = 320, where it reads them from global memory; each
   plan's clusters, shared memory (the C layout functions against the
   Python copies) and staging route, kernel, plain and bound ms, launches
   a call, the forward's launches' device times beside E = 512's;
   (c) on a synthetic 4-speaker corpus (sr 22050, as bench.py makes it):
   SpeakerEncoderTrainer at full width (80 -> 3 x 768 / 256, N = M = 4,
   20 steps; a held batch's GE2E loss before and after; its checkpoint
   through load_encoder), each speaker's d-vector, then
   Trainer(speaker_embeddings=...).fit(max_steps=5) for the d-vector
   (E = 768), table (E = 1,024) and d-vector + GST configs (finite losses
   and gradient norms, moved parameters, a checkpoint, the table and the
   GST moved, the GST's running statistics off zero), each with its
   counters set to 0 just before and read just after, and after each fit
   (b) one train step at the bench shape, dropout off, on the kernels and
   on the plain versions: the loss and every gradient leaf, the table's and
   the GST's included, at phase 7(a)'s tolerances; then Synthesizer from
   the trained d-vector checkpoint answers a batch of 8 over the 4
   speakers (its decode and Griffin-Lim launches counted).
7d. train-variants: configs/ljspeech_tacotron2.json at full width (r = 2)
   with forward attention, the transition agent and the forward mask, and
   with Graves attention (K = 4), which train on the decoder's step loop
   (the JAX package's scan route), on a 40-clip synthetic corpus: one
   Trainer.train_step on 8 rows of config #3's batch, float32, dropout
   off, a Trainer on the card against one on the CPU from the same
   weights (each loss part 1e-4 relative, the gradients handed to the
   update 1e-4 rel L2), kernels 5 and 6 not launched; fit(max_steps=2)
   with its test sentences on kernel 1's variant branch and the
   Griffin-Lim kernel their frames route to (counters set to 0 just
   before, read just after; no plain version, no training kernel); the
   timed step at config #3's batch (mixed precision; CUDA events, median
   of 3; peak memory).
7e. train-bd: the bidirectional decoder, the same card-against-CPU step
   on kernels 5 and 6 (two forward and two backward scans a step), and
   its timed step beside the same model's without the backward decoder.
7f. train-accum: grad_accum_steps 2, the same card-against-CPU step (two
   micro-batches of 4 rows, one scan each way apiece), then config #3's
   batch and the same rows four times over (B = 128) at A = 1 and A = 2:
   step time, peak memory allocated and the step's own share of it.
7h. taco1-variants: Tacotron(1) at full width (width 256, memory 5,
   r = 7) with Graves (K = 4) and with forward attention, the agent, the
   mask and windowing, which decode and train on the step loop (the JAX
   package's scan route): the step loop forced onto the location config
   against kernel 8's plain version on the card (B=8, 250 steps, float32,
   dropout on, 1e-4); per variant the batch of 8 and 5 batch-1 requests
   through tts_many (kernel 8 never launched, kernel 4 one call a request,
   no plain version), one step card against CPU on 8 rows of config #3's
   batch (1e-4 / 1e-4) and the timed mixed step on the whole batch.
7i. vocoder-train: MelGAN, PWGAN and WaveRNN (mu-law, MoL, Gaussian) at
   VocoderConfig's full widths on the synthetic corpus (22,050 Hz, 80
   mels, hop 256), the discriminator from step 1 (a cut in depth): one
   step on 2 rows in float32 card against CPU (WaveRNN's gradients 1e-4
   rel L2; a GAN's against the CPU's float64 step, each device's
   discriminator step from the CPU's updated generator, and printed beside
   it, not gated, from the device's own; see `voc_card_vs_cpu`); the timed
   steps at B = 32 x 8,192 samples (a GAN's
   generator-only and G + D steps, WaveRNN's mixed step; CUDA events, peak
   memory); each trained checkpoint served through VocoderSynthesizer,
   WaveRNN's on kernel 7 held against its plain version.
7j. profiler: Trainer.capture_trace of one Tacotron2 step on kernels 5
   and 6: the trace file holds their kernels.
7k. parallel: ParallelTTS (configs/ljspeech_tacotron2.json with model
   ParallelTTS, r = 1, a 500-frame cap: 80 mels, 512 wide, six decoder
   blocks, duration predictor 256; seeded random weights, the duration
   head's bias at log 3): Synthesizer.tts_many (the batch of 8, 5 batch-1
   requests) through kernel 2 alone, no plain version called; card
   against CPU on the same weights and on the trained asset at its own
   config (durations and lengths equal, a differing duration only within
   1e-5 of a .5 tie; mels 1e-4 rel L2); one asset request past 1,024
   frames (kernel 4); bin/extract_durations with the trained Tacotron2
   teacher on the card (kernel 5, no plain version) and the CPU, the same
   rows, and the full-width teacher-forced pass's alignments card against
   CPU; bin/train_parallel, 3 steps at B = 32, one step's gradients card
   against CPU (1e-4 rel L2), the timed step and its busy share; the
   export at (8, 160) and the asset's at (2, 32), each bit for bit against
   its unexported program (kernels 2 and 3).
7g. mel-oracle: AudioProcessor.melspectrogram on the card against
   oracle/audio_ref.py (float64 numpy) for the three shipped Tacotron2
   configs on a seeded speech-like signal, <= 1e-3 max abs.

8. wavernn: the WaveRNN sample-loop kernel at full width (WaveRNNConfig
   defaults: n_mels 80, R = F = 512, 10-bit mu-law; seeded random weights,
   packed once) against its plain version on the folds of a 500-frame mel
   (22 rows of 6,600 steps) and of the bench's 1400-frame mel (60 rows):
   the launch plan (blocks, tile rows, shared memory, weight slice, barriers
   a step); mu-law greedy and sampled (classes identical over the first 64
   steps of every row, first divergent step and share of identical
   row-steps printed, mean |x| and std within 5%), MoL and Gaussian over
   256 steps for two input seeds (1e-4 over 22 rows, 2.5e-4 over 60);
   kernel ms and us a step, the probe launches (dot products, staging
   copies or sampling left out; the barrier floor, five grid.sync() a step
   and no work), bound ms; plain ms, and the whole `generate` on the
   1400-frame mel as seconds of audio per wall second;
9. vocoder main path: Synthesizer(full width, vocoder_config=WaveRNN) answers
   the batch of 8 and 5 batch-1 requests with the launch counters set to 0
   just before and read just after; mel frames/s, real-time factor, p50
   batch-1 latency; the decode and WaveRNN kernels launched, no
   Griffin-Lim kernel did.
10. melgan-main (BASELINE config #2): Synthesizer(full width,
   vocoder_config=the default MelganConfig, factors (8, 8, 2, 2) x 512
   channels) answers the batch of 8 and 5 batch-1 requests, the counters
   set to 0 just before and read just after: mel frames/s, real-time
   factor, p50; the decode launched, no Griffin-Lim kernel did. Then the
   generator alone on the padded [8, 500, 80] batch of decoded mels (bench
   config 2's shape), bench config 2 end to end (8 x 64 symbols, 250
   steps, decode + generator), and one PWGAN row at its default config
   (finite, T x hop samples), each timed;
11. cloning (config #5): (a) the decode kernel against its plain version
   at the speaker-conditioned widths E = 768 (256-wide d-vectors) and
   E = 1,024 (the 512-wide speaker table), B=8 and B=1, the decode phase's
   inputs and tolerances, with each plan's shared memory, WB_ROUNDS and
   PRE_SMEM and the kernel's ms beside E = 512's; (b) bin/compute_embeddings
   on the card (a 16-clip, 4-speaker synthetic corpus through a full-width
   random GE2E encoder, 80 -> 3 x 768 / 256) and Synthesizer(speakers_json=)
   answering the batch of 8 over 4 speakers and 5 batch-1 requests through
   Griffin-Lim; (c) the same with an id mapping (E = 1,024); (d) the
   trained assets with bench.py's cloning_extras procedure (16 trials) on
   the kernel route and on the plain route on the same card:
   cloning_mean_margin and cloning_selective_frac of each, every trial's
   margin sign equal;
11b. conditioned: (a) configs/ljspeech_tacotron2.json with use_phonemes
   set and the G2P backend pinned to CMUDictBackend (whether the machine
   has espeak cannot change the ids; their sha256 printed) through
   Synthesizer: the batch of 8 and 5 batch-1 requests; (b) a GST
   Tacotron2 at full width (E = 512, GST 256 / 4 heads / 10 tokens) with
   a seeded synthetic style wav: kernel 1 against plain on the
   style-shifted memory at B=8 and B=1 (the decode phase's tolerances),
   then the same requests with style_wav; (c) Tacotron(1) with its
   256-wide speaker table and with 256-wide d-vectors plus GST (both
   E = 512): kernel 8 against plain at B=8 and B=1, T=160, r = 7, 250
   steps (the taco1-decode phase's tolerances), each launch plan and
   time beside E = 256's, then a batch of 8 over 4 speakers through
   tts_many. Each path's counters set to 0 just before it and read just
   after; their launches join the kernel line.
12. melgan-asset: the trained MelGAN asset (configs/melgan_smoke.json)
   through VocoderSynthesizer on the card against the CPU on one mel,
   1e-4 (float32, TF32 off).
13. server: (a) the decode kernel with a stream in and out against its
   plain version at the decode phase's inputs and tolerances (plus 5e-3 on
   each stream tensor): B=8 and B=1, chunk 1 fresh and chunk 2 from chunk
   1's stream; every row stopping at once (the stream frozen at the first
   chunk boundary, equal to a 50-step launch's); a batch past one launch
   (a slice re-run from a fresh copy of its rows of the stream); kernel ms
   with and without a stream, and the kernel's own device time apart from
   the wrapper's copies; (b) make_server on a free local port with the
   main path's Synthesizer: two bursts of 8 concurrent /api/tts requests
   (coalesced), 5 sequential (p50), two four-sentence stream=1 requests
   (framing, header, a chunk a piece, the time to the first audio chunk),
   a stream with a speaker (E = 768) and one with an unknown speaker (500);
   the decode and Griffin-Lim kernels launched while serving.
14. attention-variants: kernel 1 against its plain version for windowing,
   forward attention (u = 0.5), forward attention with the transition
   agent and the forward mask, windowing with forward attention, softmax
   with windowing, and Graves (K = 4), each with its switches flipped in
   configs/ljspeech_tacotron2.json, at the decode phase's inputs and
   tolerances (B=8 and B=1, 250 steps, dropout on); forward and Graves
   are held over every step. A variant that takes a first maximum may fork
   where the kernel's and the plain version's first maxima differ: a
   window's fork is held up to and over that step (it ran with the same
   centre); a forward mask's before it, and the step itself must be a tie
   of the plain version's alignment before the mask (within the
   alignment tolerance). The fork is printed beside the step where the
   plain version forks from itself under a 1e-6 nudge of the memory.
   Kernel ms and each round's work and wait beside the location route's
   on the decode phase's inputs in the same phase, the bound. Then
   Synthesizer.tts_many (the 8 sentences, 5 batch-1 requests) for a Graves
   and a forward_ta_mask model, and one four-piece tts_streaming of the
   latter, the counters set to 0 just before each and read just after.
15. export: the serving program as torch.export artifacts, loaded without
   the model code, the kernels registered ops (`phase_export`): full-width
   Tacotron2 + Griffin-Lim at (8, 160) and (1, 160) (kernels 1, 2), the
   cloning artifact at E = 768 with the smoke speaker encoder's artifact,
   the smoke MelGAN and Griffin-Lim artifacts (kernel 3), Tacotron(1) at
   r = 7 (kernels 8, 4); each held against its unexported program (lengths
   exact, wav <= 1e-5) with its launches counted and no plain version
   called; export, artifact and live times; bin/server.py --export_dir
   answering a burst of 8 and refusing stream=1.

The decode's and the wave route's launches in the kernel line add up
the main, train (its test sentences), taco1-train, train-cond,
melgan-main, cloning, conditioned, server, attention-variants and export
paths' counts, the training scans' the train
phase's timed steps and the train-cond fits', the Tacotron(1) decode's and
gl-iteration's the taco1-main, taco1-train, conditioned and export paths'
counts, the
gl-full route's the small and export paths'
(each path's counters set to 0 just before it and read just after); the
decode's max_abs_err is the largest of the decode phase's and the
variants' and the GST holds, the Tacotron(1) decode's the largest of its
phase's and the E = 512 holds, the training scans' the largest of phases
5-6's and train-cond's. The training scans' launches also add phases
7e-7f's steps; the decode's and Griffin-Lim's phase 7d's test sentences.
Phase 7k's launches of kernels 2-5 (serving, the asset's long
request, the durations, the exports) join the kernel line too. The
WaveRNN kernel's count is the vocoder path's alone. Phases 7h-7j's
launches (gl-iteration's in 7h's serving, the WaveRNN kernel's in 7i's
served checkpoints, the training scans' in 7j's traced step) stay out of
the kernel line: they are printed and reported per phase
(chip_smoke.json "phase_launches").
Each phase prints its seconds.
Then the kernel line (JSON), the card's
name and power limit, and the contract line {"ok": true, "device": {...}}. Details also go to
chip_smoke.json in the output directory (--out, default build/chip_smoke).
Exits nonzero, printing no result, without CUDA or outside the repository.

    python3 chip_smoke.py --profile

adds, after the main path, one batch-of-8 call under torch.profiler: device
time by kernel, device busy share of the wall time, and the trace in
profile_trace.json in the output directory; the same for one batch of 8 on
the Tacotron(1) path (taco1_profile_trace.json), for one train step
at the bench shape (train_profile_trace.json) and for one batch-1 request
on the WaveRNN and the MelGAN paths (vocoder_profile_trace.json,
melgan_profile_trace.json).
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import math
import os
import statistics
import subprocess
import sys
import tempfile
import threading
import time

HBM_BYTES_PER_S = 3.35e12        # H100 SXM HBM3
BF16_FLOPS = 989e12              # dense bf16 tensor-core peak
F32_FLOPS = 67e12                # float32 outside the tensor cores
ROOT = os.path.dirname(os.path.abspath(__file__))


def cuda_ms(fn, reps: int) -> float:
    """Median milliseconds of fn() over `reps` runs, CUDA events, after one
    warm-up run."""
    import torch

    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def bound(bytes_moved: float, seconds_of_ops: float) -> tuple[float, str]:
    t_bytes = bytes_moved / HBM_BYTES_PER_S
    return (max(t_bytes, seconds_of_ops) * 1e3,
            "bytes" if t_bytes >= seconds_of_ops else "operations")


def check(ok: bool, what: str) -> None:
    if not ok:
        raise AssertionError(what)


def gl_counters():
    """The three Griffin-Lim routes' kernel wrappers (wave, full, per
    iteration), whose `.launches` count their launches."""
    from your_voice_tts_torch.ops.griffin_lim import (gl_iteration_cuda, griffin_lim_full_cuda,
                                                      griffin_lim_wave_cuda)

    return (griffin_lim_wave_cuda, griffin_lim_full_cuda, gl_iteration_cuda)


def phase_build(report):
    from your_voice_tts_torch.ops import cuda_build

    t0 = time.perf_counter()
    seconds = cuda_build.build_all()
    report["build_s"] = time.perf_counter() - t0
    print(f"[build] {report['build_s']:.1f} s wall; per source {seconds}")
    for name, log in cuda_build.build_logs.items():
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"[build] {name}: {line.strip()}")


def full_width_config():
    """ljspeech_tacotron2.json at r=2 (r_init 7 from its gradual schedule),
    250 decoder steps."""
    from your_voice_tts_torch.config import load_config

    cfg = load_config(os.path.join(ROOT, "configs/ljspeech_tacotron2.json"))
    return dataclasses.replace(cfg, model=dataclasses.replace(
        cfg.model, r=2, max_decoder_steps=250))


def no_chance_stops(model):
    """Random weights: set the stopnet bias to -10 so that no row stops by
    chance and every row decodes all its steps."""
    import torch

    with torch.no_grad():
        model.decoder.stopnet.bias.fill_(-10.0)
    return model


DECODE_B, DECODE_T, DECODE_STEPS = 8, 152, 250


def decode_inputs(B: int = DECODE_B, spk_dim: int | None = None, stop_all: bool = False,
                  variant: str | None = None, style_wav=None):
    """The decode phase's inputs: configs/ljspeech_tacotron2.json at full
    width (r=2 of r_init 7), seeded random weights (stopnet bias -10), a
    batch of 8 texts of 122-150 symbols padded to T=152 through the
    encoder; row 0 gets the folded stop row's context direction, so it
    stops at once. B=1 takes row 1 alone (it decodes all 250 steps).
    spk_dim conditions the model on 4 speakers: d-vectors of that width
    (seeded, unit length), or with 0 its own 512-wide table (ids 0-3 in
    turn), concatenated onto the memory: E = 512 + spk_dim, or 1,024.
    stop_all pushes every row as row 0, so that every row stops at once.
    variant names an attention variant (models/attention.py VARIANTS): its switches flip
    in the config, the keywords carry its norm and flags, and Graves has no
    pinp (None). style_wav makes it a GST model (256 / 4 heads / 10 tokens)
    whose style of that waveform is added to the memory (E stays 512).
    Returns (bf16 decode weights, enc, pinp, mask, decode keywords)."""
    import torch

    from your_voice_tts_torch.models import setup_model
    from your_voice_tts_torch.models.common import sequence_mask
    from your_voice_tts_torch.text import symbols

    cfg = full_width_config() if variant is None else variant_config(variant)
    if style_wav is not None:
        cfg = gst_config(cfg)
    spk = {} if spk_dim is None else dict(num_speakers=4, speaker_embedding_dim=spk_dim)
    model = no_chance_stops(setup_model(len(symbols), cfg, device="cuda", **spk))
    T = DECODE_T
    g = torch.Generator().manual_seed(1)
    lengths = torch.tensor([150, 146, 142, 138, 134, 130, 126, 122])
    text = torch.randint(1, model.embedding.num_embeddings, (8, T), generator=g)
    dec = model.decoder
    with torch.no_grad():
        enc = model.encoder(model.embedding(text.cuda()), lengths.cuda())
        if spk_dim:
            dvec = torch.randn(8, spk_dim, generator=g)
            enc = model._condition(enc, speaker_embeddings=(
                dvec / dvec.norm(dim=-1, keepdim=True)).cuda())
        elif spk_dim == 0:
            enc = model._condition(enc, speaker_ids=torch.arange(8) % 4)
        if style_wav is not None:
            enc = model._condition(enc, style_mel=style_mels(cfg, style_wav, 8))
        w32 = dec.decode_weights(torch.float32)
        H2, E = w32["dims"]["H2"], w32["dims"]["E"]
        c = w32["o_w"][-1, H2:H2 + E]
        enc[:8 if stop_all else 1] += 20.0 * c / (c @ c)
        rows = slice(0, 8) if B == 8 else slice(1, 1 + B)
        enc, lengths = enc[rows].contiguous(), lengths[rows]
        pinp = dec.attention.preprocess_inputs(enc)
    mask = sequence_mask(lengths.cuda(), T)
    kw = dict(r=2, max_steps=DECODE_STEPS, seed=7, prenet_dropout=True,
              thresh=cfg.model.stop_threshold)
    if variant is not None:
        kw.update(norm=dec.attention.norm, **dec.attn_kernel_flags())
    return dec.decode_weights(torch.bfloat16), enc, pinp, mask, kw


def decode_bound(w, enc, pinp, mask, steps: int,
                 options: bool = False) -> tuple[float, str, float, float]:
    """(bound ms, what bounds it, weight MB, ms to stream the weights every
    step): a step's products at the bf16 rate (Graves: l1 in the query's
    place, and l2), the location, energy and context work at the float32
    rate (Graves: its mixture, ~8 operations a component a position, in
    place of location and energies; `options`: forward attention's ~12 a
    position and the transition agent's E + H1 products); bytes: weights
    and inputs read once, outputs written once."""
    import torch

    d = w["dims"]
    NM, P, H1, H2, E, A, K, OW, GK = (d[k] for k in ("n_in", "P", "H1", "H2", "E", "A", "K",
                                                     "OW", "GK"))
    B, T = mask.shape
    macs = (P * NM + P * P + 4 * H1 * (P + E + H1) + A * H1
            + 4 * H2 * (H1 + E + H2) + (OW + 1) * (H2 + E) + 3 * GK * H1)
    attn_ops = 8 * T * GK if GK else T * A * (4 * K + 4)      # mixture; location, energies
    if options:
        attn_ops += 12 * T + 2 * (E + H1)
    f32_ops = attn_ops + 2 * T * E                            # and the context
    ops_s = steps * B * (2 * macs / BF16_FLOPS + f32_ops / F32_FLOPS)
    wbytes = sum(v.nbytes for v in w.values() if isinstance(v, torch.Tensor))
    io_bytes = (wbytes + enc.numel() * 2 + (0 if pinp is None else pinp.numel() * 4)
                + mask.numel() + 4 * steps * B * (OW + T + 1))
    bound_ms, bound_by = bound(io_bytes, ops_s)
    return bound_ms, bound_by, wbytes / 1e6, steps * wbytes / HBM_BYTES_PER_S * 1e3


def one_launch_rows(dims: dict, T: int, sms: int) -> int:
    """The most batch rows (whole tiles of 8) one decode launch holds at T;
    a larger batch runs as slices, a launch each."""
    from your_voice_tts_torch.ops.taco2_decode import launch_plan

    rows = 0
    while True:
        try:
            launch_plan(dims, rows + 8, T, sms)
        except ValueError:
            return rows
        rows += 8


def phase_decode(report):
    import torch

    from your_voice_tts_torch.ops.taco2_decode import (PROBES, launch_plan,
                                                       tacotron2_decode_cuda,
                                                       tacotron2_decode_plain,
                                                       tacotron2_decode_probe_cuda,
                                                       tacotron2_decode_profile_cuda)

    steps = DECODE_STEPS
    # tolerances: both sides round the same bf16 inputs and accumulate in
    # f32 in other orders; over 250 recurrent steps a rare 1-ulp bf16 flip
    # of an input moves a frame by ~1e-3 (the Pallas kernel-vs-scan bounds)
    tol = (5e-3, 2e-3, 2e-3)
    result, errs = {}, []
    for B in (DECODE_B, 1):
        w, enc, pinp, mask, kw = decode_inputs(B)
        T = mask.shape[1]
        sms = torch.cuda.get_device_properties(0).multi_processor_count
        plan = launch_plan(w["dims"], B, T, sms)
        if B == DECODE_B:
            report["decode_one_launch_rows"] = one_launch_rows(w["dims"], T, sms)
            print(f"[decode] one launch holds up to {report['decode_one_launch_rows']} rows "
                  f"at T={T} on {sms} SMs; a larger batch runs as slices, a launch each")
        print(f"[decode] B={B}: launch plan {plan['blocks']} blocks x {plan['threads']} "
              f"threads, {plan['tiles']} batch tile(s), shared memory {plan['smem_bytes']} B, "
              f"{plan['barriers_per_step']} barriers a step, weights read from L2 "
              f"{plan['weight_bytes_per_block'] / 1e3:.0f} KB a block a step, stage inputs "
              f"copied {plan['staged_bytes_per_block'] / 1e3:.1f} KB a block a step")
        before = tacotron2_decode_cuda.launches
        got = tacotron2_decode_cuda(w, enc, pinp, mask, **kw)
        per_decode = tacotron2_decode_cuda.launches - before
        ref = tacotron2_decode_plain(w, enc, pinp, mask, **kw)
        torch.cuda.synchronize()
        e = [float((a - b).abs().max()) for a, b in zip(got[:3], ref[:3])]
        errs += e
        print(f"[decode] B={B} T={T} steps={steps} lengths kernel {got[3].tolist()} "
              f"plain {ref[3].tolist()}; launches a decode {per_decode}")
        print(f"[decode] B={B} max_abs_err frames {e[0]:.3e} (tol {tol[0]}), alignments "
              f"{e[1]:.3e} (tol {tol[1]}), stops {e[2]:.3e} (tol {tol[2]})")
        check(torch.equal(got[3].cpu(), ref[3].cpu()), f"decode lengths differ (B={B})")
        stop_pattern = [1] + [steps] * 7 if B == 8 else [steps]
        check(got[3].tolist() == stop_pattern, "decode stop pattern")
        check(all(x <= t for x, t in zip(e, tol)), f"decode kernel disagrees with plain (B={B})")
        check(per_decode == 1, "one launch a decode")
        ms = cuda_ms(lambda: tacotron2_decode_cuda(w, enc, pinp, mask, **kw), 5)
        plain_ms = cuda_ms(lambda: tacotron2_decode_plain(w, enc, pinp, mask, **kw), 2) \
            if B == DECODE_B else None
        probes = {name: cuda_ms(lambda: tacotron2_decode_probe_cuda(
                      w, enc, pinp, mask, name, r=kw["r"], max_steps=steps), 3) * 1e3 / steps
                  for name in PROBES}
        rounds = tacotron2_decode_profile_cuda(w, enc, pinp, mask, **kw)["rounds"]
        bound_ms, bound_by, wmb, stream_ms = decode_bound(w, enc, pinp, mask, steps)
        print(f"[decode] B={B} us a step: full {ms * 1e3 / steps:.2f}; probes "
              + ", ".join(f"{k} {v:.2f}" for k, v in probes.items()))
        print(f"[decode] B={B} rounds, us a step (SM clocks; work mean / largest block, "
              f"barrier wait mean): " + "; ".join(
                  f"{k} {v['work_mean_us']:.2f} / {v['work_max_us']:.2f}, {v['wait_mean_us']:.2f}"
                  for k, v in rounds.items()))
        print(f"[decode] B={B} kernel_ms {ms:.2f}  plain_ms "
              f"{'%.2f' % plain_ms if plain_ms else 'not timed'}  bound_ms {bound_ms:.3f} "
              f"({bound_by}; weights read once)  weights-streamed-every-step_ms {stream_ms:.2f} "
              f"({wmb:.1f} MB bf16 weights x {steps} steps; they fit the 50 MB L2)  "
              f"library_ms none (no single PyTorch call computes the decode)")
        result[B] = dict(errs=e, ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                         bound_by=bound_by, weight_mb=wmb, weights_streamed_ms=stream_ms,
                         launches_per_decode=per_decode, probes_us_per_step=probes,
                         rounds_us_per_step=rounds,
                         us_per_step=ms * 1e3 / steps, launch=plan)
    main = result[DECODE_B]
    report["decode"] = dict(main, b1=result[1])
    return {"name": "tacotron2_decode_cuda", "route": "cuda",
            "source": "your_voice_tts_torch/csrc/taco2_decode.cu",
            "replaces": "your_voice_tts_tpu/ops/pallas/taco2_decode.py:438",
            "max_abs_err": max(errs), "ms": main["ms"], "plain_ms": main["plain_ms"],
            "bound_ms": main["bound_ms"], "bound_by": main["bound_by"], "library_ms": None}


def speech_like(B: int, T: int, n_fft: int, hop: int, sr: int, window=None):
    """|STFT| [B, T, n_fft/2 + 1] of B harmonic signals with vibrato and a
    syllable-rate envelope: a consistent spectrogram, as a decoder's mel
    gives one, unlike random magnitudes. `window` (length n_fft) defaults
    to the periodic Hann of n_fft."""
    import numpy as np
    import torch

    t = torch.arange(hop * (T - 1), dtype=torch.float64) / sr
    rows = []
    for b in range(B):
        f0 = 100.0 + 20.0 * b
        ph = 2 * np.pi * torch.cumsum(f0 * (1 + 0.03 * torch.sin(2 * np.pi * 5 * t)) / sr, 0)
        env = 0.2 + torch.sin(2 * np.pi * (1.1 + 0.2 * b) * t) ** 2
        rows.append(sum(torch.sin(k * ph) / k for k in range(1, 25)) * env)
    win = (torch.hann_window(n_fft, periodic=True, dtype=torch.float64) if window is None
           else torch.as_tensor(window, dtype=torch.float64))
    S = torch.stft(torch.stack(rows), n_fft, hop, window=win, center=True,
                   return_complex=True).abs().transpose(1, 2)
    return S[:, :T].float()


def spectral_convergence(y, mag, n_fft: int, hop: int, window=None) -> list[float]:
    """||(|STFT(y)| - mag)|| / ||mag|| per row, the repo's Griffin-Lim gate;
    `window` as for `speech_like`."""
    import torch

    win = (torch.hann_window(n_fft, periodic=True, device=y.device) if window is None
           else torch.as_tensor(window, dtype=torch.float32, device=y.device))
    S2 = torch.stft(y, n_fft, hop, window=win, center=True,
                    return_complex=True).abs().transpose(1, 2)[:, :mag.shape[1]]
    return ((S2 - mag).flatten(1).norm(dim=1) / mag.flatten(1).norm(dim=1)).tolist()


# Kernel 2 at the main path's shape (config #1: n_fft 1024, hop 256, 24
# iterations at momentum 0.95, a batch of 8 x 500 frames); kernel 3 at a
# 12.5 ms hop (n_fft 2048, hop 275, window 1102 at 22,050 Hz) and at the
# smoke path's launch shape (3 rows in a bucket of 4, 96 frames, n_fft 256,
# hop 64, 15 iterations); kernel 4 at the Tacotron(1) path's 1,760 frames
GL_WAVE = dict(B=8, T=500, n_fft=1024, hop=256, win=1024, iters=24, mom=0.95, seed=2)
GL_FULL = dict(B=8, T=500, n_fft=2048, hop=275, win=1102, iters=24, mom=0.95, seed=3)
GL_SMALL = dict(B=4, T=96, n_fft=256, hop=64, win=256, iters=15, mom=0.95, seed=5)
GL_LAUNCHES = ("synth", "ola", "analysis", "emit", "unpack")


def gl_inputs(B, T, n_fft, hop, win, seed, **_):
    """Speech-like magnitudes [B, T, n_fft/2 + 1] on the card, a shared
    seeded phase [T, n_fft/2 + 1], the packed bf16 constants, the window
    and the generator (for nudges after the phase)."""
    import numpy as np
    import torch

    from your_voice_tts_torch.ops.filters import hann_window
    from your_voice_tts_torch.ops.griffin_lim import packed_constants

    window = hann_window(win, n_fft).astype(np.float32)
    mag = speech_like(B, T, n_fft, hop, 22050, None if win == n_fft else window).cuda()
    g = torch.Generator().manual_seed(seed)
    phase = (torch.rand(T, n_fft // 2 + 1, generator=g) * 2 * np.pi).cuda()
    return mag, phase, packed_constants(n_fft, hop, window, torch.bfloat16, "cuda"), window, g


def gl_launch_times(run) -> dict:
    """Device time of each Griffin-Lim launch of one call of `run`
    (torch.profiler): synthesis, OLA, analysis, emit, unpack, and "other"
    (the set-up's PyTorch kernels). The product kernel's second template
    argument tells its analysis from its synthesis; an older checkout's
    kernel 4 (gli_synth, gli_ola, gli_analysis) counts under the same
    three kinds."""
    def key(name):
        if "fgla_gemm_kernel<" in name:
            args = name.split("fgla_gemm_kernel<")[1].split(">")[0].split(",")
            return "analysis" if args[1].strip() == "true" else "synth"
        return next((k for k in GL_LAUNCHES if f"{k}_kernel" in name), "other")

    return kernel_times(run, key, GL_LAUNCHES + ("other",))


def hold_gl_launches(tag: str, route: str, serial, issued: int, n_iters: int) -> dict:
    """Prints a Griffin-Lim loop's device time a launch (`gl_launch_times`
    of its serial probe, `serial`) and fails unless one profile saw the
    launches the C call reported issuing (`issued`, one call of the counted
    route at the same shape), kind by kind as the route's schedule lists
    them: `fgla_schedule` for "wave" and "full" (`gl_fgla`),
    `gl_iteration_schedule` for "iteration" (`gl_plain`). The profiler can
    drop kernel records from a profile (61 of 72 seen once), so a profile
    that saw fewer is taken again, three times at most. Returns the times."""
    from your_voice_tts_torch.ops.griffin_lim import fgla_schedule, gl_iteration_schedule

    entry = "gl_plain" if route == "iteration" else "gl_fgla"
    plan = (gl_iteration_schedule(n_iters) if route == "iteration"
            else fgla_schedule(n_iters, route))
    want = {k: plan.count(k) for k in GL_LAUNCHES}
    for profiles in range(1, 4):
        times = gl_launch_times(serial)
        seen = {k: times[k]["launches"] for k in GL_LAUNCHES}
        if not all(seen[k] <= want[k] for k in GL_LAUNCHES) or seen == want:
            break
    parts = ", ".join(f"{k} {v['us_a_launch']:.1f} us x {v['launches']}"
                      for k, v in times.items() if v["launches"])
    print(f"[{tag}] {route}: device time a launch (serial probe, torch.profiler, profile "
          f"{profiles}): {parts}; launches {entry} issued {issued}; one ctypes call a call "
          f"({entry}), by construction")
    check(seen == want and sum(seen.values()) == issued,
          f"{tag}: the profiler's launches {seen} are not the {issued} {entry} issued")
    return times


def phase_griffin_lim(report):
    import torch

    from your_voice_tts_torch.ops.griffin_lim import (fgla_serial_cuda, griffin_lim_wave_cuda,
                                                      griffin_lim_wave_plain)

    B, T, n_fft, hop, iters, mom = (GL_WAVE[k] for k in ("B", "T", "n_fft", "hop", "iters",
                                                           "mom"))
    mag, phase, consts, _, g = gl_inputs(**GL_WAVE)
    out = {}
    for n in (1, iters):
        got = griffin_lim_wave_cuda(mag, phase, consts, n_iters=n, momentum=mom)
        ref = griffin_lim_wave_plain(mag, phase, consts, n_iters=n, momentum=mom)
        check(got.shape == (B, hop * (T - 1)) and bool(torch.isfinite(got).all()),
              "Griffin-Lim output shape / finiteness")
        out[n] = (got, ref)
    # the loop's own sensitivity: the plain version from magnitudes nudged
    # by a relative 1e-4
    nudged = mag * (1 + 1e-4 * torch.randn(mag.shape, generator=g).cuda())
    y_n = griffin_lim_wave_plain(nudged, phase, consts, n_iters=iters, momentum=mom)
    sens = float((y_n - out[iters][1]).norm() / out[iters][1].norm())
    got, ref = out[1]
    rel1 = float((got - ref).norm() / ref.norm())
    err1 = float((got - ref).abs().max())
    conv_k = spectral_convergence(out[iters][0], mag, n_fft, hop)
    conv_p = spectral_convergence(out[iters][1], mag, n_fft, hop)
    gap = max(abs(a - b) for a, b in zip(conv_k, conv_p))
    # tolerances: after one iteration both sides hold the same bf16 loop
    # state up to f32 sum order (rel L2 1e-2); over 24 FGLA iterations the
    # loop amplifies any rounding difference (printed below: the waveform
    # moved by a 1e-4 nudge of the magnitudes), so there the kernel is held
    # to the plain version's reconstruction quality: spectral convergence
    # within 0.02 of it on every row, and under the repo's 0.25 gate
    print(f"[griffin-lim] 1 iteration: rel L2 err {rel1:.3e} (tol 1e-2), max_abs_err "
          f"{err1:.3e} of peak {float(ref.abs().max()):.3e}")
    print(f"[griffin-lim] {iters} iterations: spectral convergence kernel "
          f"{[round(x, 4) for x in conv_k]} plain {[round(x, 4) for x in conv_p]}; "
          f"largest gap {gap:.4f} (tol 0.02); waveform rel L2 kernel vs plain "
          f"{float((out[iters][0] - out[iters][1]).norm() / out[iters][1].norm()):.3e}, "
          f"plain vs plain from magnitudes nudged by 1e-4 {sens:.3e}")
    check(rel1 <= 1e-2, "Griffin-Lim kernel disagrees with plain after one iteration")
    check(gap <= 0.02 and max(conv_k) <= 0.25, "Griffin-Lim kernel quality differs from plain")
    ms = cuda_ms(lambda: griffin_lim_wave_cuda(mag, phase, consts, n_iters=iters,
                                               momentum=mom), 5)
    plain_ms = cuda_ms(lambda: griffin_lim_wave_plain(mag, phase, consts, n_iters=iters,
                                                      momentum=mom), 3)
    M = B * T
    a = torch.randn(M, n_fft, device="cuda").to(torch.bfloat16)
    m = consts["Mw"]

    def library():
        for _ in range(2 * iters + 1):
            torch.matmul(a, m)

    lib_ms = cuda_ms(library, 5)
    ops_s = (2 * iters + 1) * 2 * M * n_fft * n_fft / BF16_FLOPS
    io_bytes = (mag.numel() * 4 + phase.numel() * 4 + 2 * n_fft * n_fft * 2
                + B * hop * (T - 1) * 4)
    bound_ms, bound_by = bound(io_bytes, ops_s)
    print(f"[griffin-lim] B={B} T={T} iters={iters} kernel_ms {ms:.2f}  plain_ms "
          f"{plain_ms:.2f}  bound_ms {bound_ms:.3f} ({bound_by})  library_ms {lib_ms:.2f} "
          f"(torch.matmul bf16 on the same {2 * iters + 1} [{M}x{n_fft}]x[{n_fft}x{n_fft}] "
          f"products; a yardstick for the products only)")
    issued = griffin_lim_wave_cuda.launches
    griffin_lim_wave_cuda(mag, phase, consts, n_iters=iters, momentum=mom)
    issued = griffin_lim_wave_cuda.launches - issued
    per = hold_gl_launches("griffin-lim", "wave", lambda: fgla_serial_cuda(
        mag, phase, consts, n_iters=iters, momentum=mom, route="wave"), issued, iters)
    report["griffin_lim"] = dict(rel_l2_1iter=rel1, max_abs_err_1iter=err1, sensitivity=sens,
                                 conv_kernel=conv_k, conv_plain=conv_p, ms=ms,
                                 plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by,
                                 library_ms=lib_ms, launch_us=per, launches_a_call=issued)
    return {"name": "griffin_lim_wave_cuda", "route": "cuda",
            "source": "your_voice_tts_torch/csrc/griffin_lim.cu",
            "replaces": "your_voice_tts_tpu/ops/pallas/griffin_lim.py:450",
            "max_abs_err": err1, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": lib_ms}


def phase_small_input(report):
    """Trained smoke checkpoint: the kernels on the card against the plain
    versions on the CPU, same bf16 working type and seeds."""
    import numpy as np
    import torch

    from your_voice_tts_torch.audio import AudioProcessor
    from your_voice_tts_torch.config import load_config
    from your_voice_tts_torch.infer.synthesis import _pad_texts, text_to_seq
    from your_voice_tts_torch.models import setup_model
    from your_voice_tts_torch.text import symbols
    from your_voice_tts_torch.train.checkpoint import load_checkpoint

    cfg = load_config(os.path.join(ROOT, "configs/smoke_synthetic.json"))
    texts = ["The quick brown fox jumps over the lazy dog.", "Hello world, this is a test",
             "A cat sat."]
    text, lengths = _pad_texts([text_to_seq(t, cfg) for t in texts])
    outs = {}
    for c in gl_counters():
        c.launches = 0
    for dev in ("cuda", "cpu"):
        model = setup_model(len(symbols), cfg, device=dev)
        load_checkpoint(model, os.path.join(ROOT, "assets/bench_trained_smoke.npz"))
        o = model.inference(text, lengths, seed=3)
        mel = o["postnet_outputs"].cpu()
        wavs = AudioProcessor(cfg.audio, dev, seed=4).inv_melspectrogram_batch(
            [m.T.numpy() for m in mel[:, :96]])
        outs[dev] = (mel, o["mel_lengths"].cpu(), torch.from_numpy(np.stack(wavs)))
    gl_launches = {c.__name__: c.launches for c in gl_counters()}
    (mg, lg, wg), (mc, lc, wc) = outs["cuda"], outs["cpu"]
    mel_err = float((mg - mc).abs().max())
    wav_rel = float((wg - wc).norm() / wc.norm())
    print(f"[small] smoke checkpoint: mel lengths card {lg.tolist()} cpu {lc.tolist()}; "
          f"postnet max_abs_err {mel_err:.3e} (tol 5e-2); wav rel L2 err {wav_rel:.3e} (tol 5e-2)")
    check(torch.equal(lg, lc), "smoke mel lengths differ between card and CPU")
    check(mel_err <= 5e-2 and wav_rel <= 5e-2 and bool(torch.isfinite(wg).all()),
          "smoke outputs differ between card and CPU")
    # the smoke config's hop 64 puts its waveform columns off 128-sample
    # boundaries: the whole-loop route that returns the spectrum (kernel 3)
    print(f"[small] Griffin-Lim launches (3 rows, batch bucket 4, hop 64): {gl_launches}")
    check(gl_launches["griffin_lim_full_cuda"] > 0 and gl_launches["griffin_lim_wave_cuda"] == 0
          and gl_launches["gl_iteration_cuda"] == 0, "smoke path Griffin-Lim route")

    # kernel 3 against its plain version on the same card inputs, at the
    # launch shape of this path: the card's mels padded to the batch bucket
    # with normalized silence, as AudioProcessor pads them, through its own
    # magnitudes
    ap = AudioProcessor(cfg.audio, "cuda")
    tb = 96
    buf = torch.full((4, tb, mg.shape[-1]), ap._silence_fill(), device="cuda")
    buf[:len(texts)] = mg[:, :tb].cuda()
    mag = ap.gl_magnitudes("mel", buf)
    phase = torch.rand(mag.shape[1:], generator=torch.Generator().manual_seed(5)) * 2 * np.pi
    held = hold_gl_full("small", mag, phase.cuda(), ap.gl_consts["packed"], ap.window,
                        cfg.audio.griffin_lim_iters, cfg.audio.griffin_lim_momentum,
                        rows=len(texts), gate=None)
    report["small"] = dict(mel_err=mel_err, wav_rel=wav_rel, lengths=lg.tolist(),
                           launches=gl_launches, gl_full=held)
    return ({"griffin_lim_full_cuda": gl_launches["griffin_lim_full_cuda"]},
            {"name": "griffin_lim_full_cuda", "route": "cuda",
             "source": "your_voice_tts_torch/csrc/griffin_lim.cu",
             "replaces": "your_voice_tts_tpu/ops/pallas/griffin_lim.py:353",
             "max_abs_err": held["max_abs_err_1iter"], "ms": held["ms"],
             "plain_ms": held["plain_ms"], "bound_ms": held["bound_ms"],
             "bound_by": held["bound_by"], "library_ms": held["library_ms"]})


SENTENCES = [
    "Printing, in the only sense with which we are at present concerned, differs "
    "from most if not from all the arts and crafts represented in the exhibition.",
    "The earliest book printed with movable types, the Gutenberg Bible, was printed "
    "in Latin and differs in many respects from the later books of the period.",
    "It was a fine summer morning when the travellers set out from the village, "
    "carrying with them little more than bread, water and a map of the hills.",
    "Scientists at the observatory reported that the comet would pass within sight "
    "of the earth next spring, and invited the public to watch from the hills.",
    "The committee met again on Tuesday to discuss the budget for the new library, "
    "but the members could not agree on the cost of the building or its design.",
    "Along the river the old mills had fallen silent, and only the sound of water "
    "over the stones reminded the town of the work that had once been done there.",
    "She opened the letter slowly, read it twice without a word, and then folded it "
    "carefully before placing it in the drawer beside the window of her study.",
    "Every morning the baker rose before dawn to light the ovens, and by six o'clock "
    "the smell of fresh bread had filled every street of the little harbour town.",
]


def phase_main_path(report):
    import torch

    from your_voice_tts_torch.infer.synthesis import _pad_texts, text_to_seq
    from your_voice_tts_torch.infer.synthesizer import Synthesizer
    from your_voice_tts_torch.ops.griffin_lim import griffin_lim_wave_cuda
    from your_voice_tts_torch.ops.taco2_decode import tacotron2_decode_cuda

    synth = Synthesizer(full_width_config(), device="cuda")
    no_chance_stops(synth.model)
    synth.tts_many(SENTENCES[:1])                  # one-time set-up, not measured
    torch.cuda.synchronize()

    tacotron2_decode_cuda.launches = 0
    for c in gl_counters():
        c.launches = 0
    t0 = time.perf_counter()
    batch = synth.tts_many(SENTENCES)
    t_batch = time.perf_counter() - t0
    lat = []
    for s in SENTENCES[:5]:
        t0 = time.perf_counter()
        one = synth.tts_many([s])
        lat.append(time.perf_counter() - t0)
    launches = {"tacotron2_decode_cuda": tacotron2_decode_cuda.launches,
                "griffin_lim_wave_cuda": griffin_lim_wave_cuda.launches}
    other_routes = {c.__name__: c.launches for c in gl_counters()[1:]}

    # mel frames of the batch, counted from the decode (the waveforms are
    # trimmed): no row of the random weights stops, so 250 steps x r=2 each
    text, lengths = _pad_texts([text_to_seq(t, synth.cfg) for t in SENTENCES])
    mel_lengths = synth.model.inference(text, lengths)["mel_lengths"]
    frames = int(mel_lengths.sum())
    check(mel_lengths.tolist() == [500] * len(SENTENCES), "main path mel lengths")
    sr, hop = synth.ap.sample_rate, synth.ap.hop_length
    audio_s = sum(len(w) for w in batch) / sr
    check(all(w.ndim == 1 and len(w) > 0 and bool(torch.isfinite(torch.from_numpy(w)).all())
              for w in batch + one), "main path waveforms")
    check(all(len(w) <= hop * (500 - 1) for w in batch), "main path waveform lengths")
    p50 = statistics.median(lat)
    print(f"[main] batch of 8: {t_batch * 1e3:.1f} ms, {frames / t_batch:.0f} mel frames/s, "
          f"{audio_s:.2f} s of audio, real-time factor {audio_s / t_batch:.1f}x realtime")
    print(f"[main] batch-1 latency p50 {p50 * 1e3:.1f} ms (all: "
          f"{', '.join(f'{x * 1e3:.1f}' for x in lat)} ms)")
    print(f"[main] launches on the main path: {launches}")
    check(all(n > 0 for n in launches.values()), "a kernel of the main path never launched")
    check(not any(other_routes.values()), f"main path left the wave route: {other_routes}")
    report["main"] = dict(batch_ms=t_batch * 1e3, mel_frames_per_s=frames / t_batch,
                          rtf_x_realtime=audio_s / t_batch, p50_batch1_ms=p50 * 1e3,
                          batch1_ms=[x * 1e3 for x in lat], launches=launches)
    return launches


# ------------------------------------------------- Tacotron(1), Griffin-Lim routes

TACO1_STEPS, TACO1_R = 250, 7           # 1,750 frames a row: the per-iteration route
TACO1_MEMORY = 5


def taco1_config():
    """configs/ljspeech_tacotron2.json with the model group replaced by
    Tacotron(1) at the reference's width 256: memory 5, r = 7 of r_init 7
    (its gradual schedule), 250 decoder steps."""
    from your_voice_tts_torch.config import load_config

    cfg = load_config(os.path.join(ROOT, "configs/ljspeech_tacotron2.json"))
    return dataclasses.replace(cfg, model=dataclasses.replace(
        cfg.model, model="Tacotron", tacotron_width=256, memory_size=TACO1_MEMORY, r=TACO1_R,
        max_decoder_steps=TACO1_STEPS))


def taco1_inputs(B: int = 8, spk_dim: int | None = None, style_wav=None):
    """The taco1-decode phase's inputs: `taco1_config` at full width, seeded
    random weights (stopnet bias -10), the 8 sentences through the CBHG
    encoder (T=160); row 0 gets the folded stop row's direction through
    the projection's context columns, so it stops at once. B=1 takes row 1
    alone (it decodes all 250 steps). spk_dim conditions the model on 4
    speakers (256-wide d-vectors, seeded and of unit length, or with 0
    its 256-wide table, ids 0-3 in turn) and style_wav adds GST: the memory
    is E = 256 + 256 = 512. Returns (bf16 decode weights, enc, pinp, mask,
    decode keywords but r)."""
    import torch

    from your_voice_tts_torch.infer.synthesis import _pad_texts, text_to_seq
    from your_voice_tts_torch.models import setup_model
    from your_voice_tts_torch.models.common import sequence_mask
    from your_voice_tts_torch.text import symbols

    cfg = taco1_config() if style_wav is None else gst_config(taco1_config())
    spk = {} if spk_dim is None else dict(num_speakers=4, speaker_embedding_dim=spk_dim)
    model = no_chance_stops(setup_model(len(symbols), cfg, device="cuda", **spk))
    text, lengths = _pad_texts([text_to_seq(t, cfg) for t in SENTENCES])
    text, lengths = torch.as_tensor(text).cuda(), torch.as_tensor(lengths).cuda()
    dec = model.decoder
    cond = {}
    if spk_dim:
        dvec = torch.randn(8, spk_dim, generator=torch.Generator().manual_seed(2))
        cond["speaker_embeddings"] = (dvec / dvec.norm(dim=-1, keepdim=True)).cuda()
    elif spk_dim == 0:
        cond["speaker_ids"] = torch.arange(8) % 4
    if style_wav is not None:
        cond["style_mel"] = style_mels(cfg, style_wav, 8)
    with torch.no_grad():
        gen = torch.Generator(device="cuda").manual_seed(1)
        enc = model._encode(text, generator=gen, **cond)
        w32 = dec.decode_weights(torch.float32)
        H, E, D = (w32["dims"][k] for k in ("H", "E", "D"))
        v = w32["pj_w"][:, H:H + E].T @ w32["m_w"][-1, :D]
        enc[0] += 60.0 * v / (v @ v)
        rows = slice(0, 8) if B == 8 else slice(1, 1 + B)
        enc, lengths = enc[rows].contiguous(), lengths[rows]
        pinp = dec.attention.preprocess_inputs(enc)
    mask = sequence_mask(lengths, text.shape[1])
    kw = dict(max_steps=TACO1_STEPS, seed=7, prenet_dropout=True,
              thresh=cfg.model.stop_threshold)
    return dec.decode_weights(torch.bfloat16), enc, pinp, mask, kw


def taco1_bound(w, enc, pinp, mask, steps: int) -> tuple[float, str, float]:
    """(bound ms, what bounds it, weight MB) of a Tacotron(1) decode: a
    step's products at the bf16 rate, the location, energy and context
    work at the float32 rate; bytes: weights and inputs read once, outputs
    written once."""
    import torch

    d = w["dims"]
    NQ, P1, P2, H, E, A, K, D, OW = (d[k] for k in ("NQ", "P1", "P2", "H", "E", "A", "K", "D",
                                                    "OW"))
    B, T = mask.shape
    macs = (P1 * NQ + P2 * P1 + 3 * H * (P2 + E + H) + A * H + D * (H + E)
            + 2 * 6 * D * D + (OW + 1) * D)
    f32_ops = T * A * (4 * K + 4) + 2 * T * E            # location, energies, context
    ops_s = steps * B * (2 * macs / BF16_FLOPS + f32_ops / F32_FLOPS)
    wbytes = sum(v.nbytes for v in w.values() if isinstance(v, torch.Tensor))
    io_bytes = (wbytes + enc.numel() * 2 + pinp.numel() * 4 + mask.numel()
                + 4 * steps * B * (OW + T + 1))
    bound_ms, bound_by = bound(io_bytes, ops_s)
    return bound_ms, bound_by, wbytes / 1e6


def phase_taco1_decode(report):
    import torch

    from your_voice_tts_torch.ops.taco1_decode import (PROBES, _blocks, launch_plan,
                                                       tacotron1_decode_cuda,
                                                       tacotron1_decode_plain,
                                                       tacotron1_decode_probe_cuda,
                                                       tacotron1_decode_profile_cuda)

    steps = TACO1_STEPS
    # tolerances as for the Tacotron2 decode: the same bf16 inputs on both
    # sides, f32 sums in other orders, the same hash-PRNG dropout masks
    tol = (5e-3, 2e-3, 2e-3)
    held, result = {}, {}
    # r = 7 above the memory of 5 frames (the path's r: the queue keeps the
    # step's last 5 frames), then r = 5 (the whole queue replaced each
    # step), at B=8; r = 7 at B=1
    for B, r in ((8, TACO1_R), (8, TACO1_MEMORY), (1, TACO1_R)):
        w, enc, pinp, mask, kw = taco1_inputs(B)
        T = mask.shape[1]
        kw = dict(kw, r=r)
        before = tacotron1_decode_cuda.launches
        got = tacotron1_decode_cuda(w, enc, pinp, mask, **kw)
        per_decode = tacotron1_decode_cuda.launches - before
        ref = tacotron1_decode_plain(w, enc, pinp, mask, **kw)
        torch.cuda.synchronize()
        errs = [float((a - b).abs().max()) for a, b in zip(got[:3], ref[:3])]
        print(f"[taco1-decode] B={B} T={T} steps={steps} r={r} memory={TACO1_MEMORY} lengths "
              f"(r-groups) kernel {got[3].tolist()} plain {ref[3].tolist()}; launches a "
              f"decode {per_decode}")
        print(f"[taco1-decode] B={B} r={r} max_abs_err frames {errs[0]:.3e} (tol {tol[0]}), "
              f"alignments {errs[1]:.3e} (tol {tol[1]}), stops {errs[2]:.3e} (tol {tol[2]})")
        check(torch.equal(got[3].cpu(), ref[3].cpu()), f"taco1 decode lengths differ (r={r})")
        stop_pattern = [1] + [steps] * 7 if B == 8 else [steps]
        check(got[3].tolist() == stop_pattern, f"taco1 decode stop pattern (B={B}, r={r})")
        check(all(e <= t for e, t in zip(errs, tol)),
              f"taco1 decode kernel disagrees with plain (B={B}, r={r})")
        check(per_decode == 1, "one launch a Tacotron(1) decode")
        held[f"B{B}_r{r}"] = errs
        if r != TACO1_R:
            continue
        plan = launch_plan(w["dims"], B, T, _blocks(enc.device))
        print(f"[taco1-decode] B={B}: launch plan {plan['blocks']} blocks x {plan['threads']} "
              f"threads, {plan['tiles']} batch tile(s), shared memory {plan['smem_bytes']} B "
              f"(resident weights {plan['RES'] * 512} B a block at most), "
              f"{plan['barriers_per_step']} barriers a step, stage inputs copied "
              f"{plan['staged_bytes_per_block'] / 1e3:.1f} KB a block a step at most")
        ms = cuda_ms(lambda: tacotron1_decode_cuda(w, enc, pinp, mask, **kw), 5)
        plain_ms = cuda_ms(lambda: tacotron1_decode_plain(w, enc, pinp, mask, **kw), 2)
        probes = {name: cuda_ms(lambda: tacotron1_decode_probe_cuda(
                      w, enc, pinp, mask, name, r=r, max_steps=steps), 3) * 1e3 / steps
                  for name in PROBES}
        rounds = tacotron1_decode_profile_cuda(w, enc, pinp, mask, **kw)["rounds"]
        bound_ms, bound_by, wmb = taco1_bound(w, enc, pinp, mask, steps)
        print(f"[taco1-decode] B={B} us a step: full {ms * 1e3 / steps:.2f}; probes "
              + ", ".join(f"{k} {v:.2f}" for k, v in probes.items()))
        print(f"[taco1-decode] B={B} rounds, us a step (SM clocks; work mean / largest block, "
              f"barrier wait mean): " + "; ".join(
                  f"{k} {v['work_mean_us']:.2f} / {v['work_max_us']:.2f}, {v['wait_mean_us']:.2f}"
                  for k, v in rounds.items()))
        print(f"[taco1-decode] B={B} kernel_ms {ms:.2f}  plain_ms {plain_ms:.2f}  bound_ms "
              f"{bound_ms:.3f} ({bound_by}; {wmb:.1f} MB bf16 weights read once)  "
              f"library_ms none (no single PyTorch call computes the decode)")
        result[B] = dict(ms=ms, plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by,
                         weight_mb=wmb, T=T, launches_per_decode=per_decode,
                         us_per_step=ms * 1e3 / steps, probes_us_per_step=probes,
                         rounds_us_per_step=rounds, launch=plan)
    main = result[8]
    report["taco1_decode"] = dict(main, errs=held, b1=result[1])
    return {"name": "tacotron1_decode_cuda", "route": "cuda",
            "source": "your_voice_tts_torch/csrc/taco1_decode.cu",
            "replaces": "your_voice_tts_tpu/ops/pallas/taco1_decode.py:211",
            "max_abs_err": max(max(e) for e in held.values()), "ms": main["ms"],
            "plain_ms": main["plain_ms"], "bound_ms": main["bound_ms"],
            "bound_by": main["bound_by"], "library_ms": None}


def hold_gl_full(tag: str, mag, phase, consts: dict, window, iters: int, mom: float, *,
                 rows: int, gate: float | None) -> dict:
    """Kernel 3 against its plain version on the same card inputs (mag
    [B, T, Kf], shared phase [T, Kf], packed constants): the spectrum after
    one iteration to rel L2 1e-2, as the wave route is held (phase
    griffin-lim); after `iters` FGLA iterations and the istft, spectral
    convergence within 0.02 of the plain version's on the first `rows` rows
    (the real ones), and under `gate` where given; kernel, plain, library
    and bound ms. Returns the readings."""
    import torch

    from your_voice_tts_torch.ops.dsp import istft
    from your_voice_tts_torch.ops.griffin_lim import (fgla_serial_cuda, griffin_lim_full_cuda,
                                                      griffin_lim_full_plain)

    B, T, Kf = mag.shape
    n_fft, hop = consts["n_fft"], consts["hop"]
    win = torch.as_tensor(window, dtype=torch.float32, device=mag.device)
    run = lambda fn, m, n, **kw: fn(m, phase, consts, n_iters=n, momentum=mom, **kw)  # noqa: E731
    out = {}
    for n in (1, iters):
        got, ref = run(griffin_lim_full_cuda, mag, n), run(griffin_lim_full_plain, mag, n)
        check(got.shape == (B, T, Kf) and got.dtype == torch.complex64
              and bool(torch.isfinite(torch.view_as_real(got)).all()),
              f"{tag}: gl-full output shape / type / finiteness")
        out[n] = (got, ref)
    got, ref = out[1]
    rel1 = float((got - ref).abs().norm() / ref.abs().norm())
    err1 = float((got - ref).abs().max())
    y_k, y_p = (istft(x, n_fft, hop, win) for x in out[iters])
    g = torch.Generator().manual_seed(3)
    nudged = mag * (1 + 1e-4 * torch.randn(mag.shape, generator=g).to(mag.device))
    y_n = istft(run(griffin_lim_full_plain, nudged, iters), n_fft, hop, win)
    sens = float((y_n - y_p).norm() / y_p.norm())
    conv_k = spectral_convergence(y_k, mag, n_fft, hop, win)
    conv_p = spectral_convergence(y_p, mag, n_fft, hop, win)
    gap = max(abs(a - b) for a, b in list(zip(conv_k, conv_p))[:rows])
    print(f"[{tag}] gl-full B={B} T={T} n_fft={n_fft} hop={hop}: 1 iteration: spectrum rel L2 "
          f"err {rel1:.3e} (tol 1e-2), max_abs_err {err1:.3e} of peak "
          f"{float(ref.abs().max()):.3e}")
    print(f"[{tag}] gl-full {iters} iterations (momentum {mom}) + istft: spectral convergence "
          f"kernel {[round(x, 4) for x in conv_k]} plain {[round(x, 4) for x in conv_p]}; "
          f"largest gap over the first {rows} rows {gap:.4f} (tol 0.02"
          f"{'' if gate is None else f'; kernel under {gate}'}); waveform rel L2 kernel vs "
          f"plain {float((y_k - y_p).norm() / y_p.norm()):.3e}, plain vs plain from "
          f"magnitudes nudged by 1e-4 {sens:.3e}")
    check(rel1 <= 1e-2, f"{tag}: gl-full kernel disagrees with plain after one iteration")
    check(gap <= 0.02 and (gate is None or max(conv_k[:rows]) <= gate),
          f"{tag}: gl-full kernel quality differs from plain")
    ms = cuda_ms(lambda: run(griffin_lim_full_cuda, mag, iters), 5)
    plain_ms = cuda_ms(lambda: run(griffin_lim_full_plain, mag, iters), 3)
    M = B * T
    a = torch.randn(M, n_fft, device=mag.device).to(torch.bfloat16)
    m = consts["Mw"]

    def library():
        for _ in range(2 * iters):
            torch.matmul(a, m)

    lib_ms = cuda_ms(library, 5)
    ops_s = 2 * iters * 2 * M * n_fft * n_fft / BF16_FLOPS
    io_bytes = mag.numel() * 4 + phase.numel() * 4 + 2 * n_fft * n_fft * 2 + M * Kf * 8
    bound_ms, bound_by = bound(io_bytes, ops_s)
    print(f"[{tag}] gl-full B={B} T={T} n_fft={n_fft} hop={hop} iters={iters} kernel_ms "
          f"{ms:.3f}  plain_ms {plain_ms:.3f}  bound_ms {bound_ms:.4f} ({bound_by})  library_ms "
          f"{lib_ms:.3f} (torch.matmul bf16 on the same {2 * iters} [{M}x{n_fft}]x"
          f"[{n_fft}x{n_fft}] products; a yardstick for the products only)")
    issued = griffin_lim_full_cuda.launches
    run(griffin_lim_full_cuda, mag, iters)
    issued = griffin_lim_full_cuda.launches - issued
    per = hold_gl_launches(tag, "full", lambda: run(fgla_serial_cuda, mag, iters, route="full"),
                           issued, iters)
    return dict(shape=[B, T, n_fft, hop, iters], rel_l2_1iter=rel1, max_abs_err_1iter=err1,
                sensitivity=sens, conv_kernel=conv_k, conv_plain=conv_p, ms=ms,
                plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by, library_ms=lib_ms,
                launch_us=per, launches_a_call=issued)


def phase_gl_full(report):
    """Kernel 3 beyond the smoke path's shape (phase small holds it there):
    a 12.5 ms hop (n_fft 2048, hop 275, window 1102 at 22,050 Hz), B=8,
    T=500, 24 FGLA iterations at momentum 0.95, on consistent magnitudes."""
    mag, phase, consts, window, _ = gl_inputs(**GL_FULL)
    report["gl_full_12ms_hop"] = hold_gl_full("gl-full", mag, phase, consts, window,
                                              GL_FULL["iters"], GL_FULL["mom"], rows=GL_FULL["B"],
                                              gate=0.25)


def gl_iteration_inputs():
    """Kernel 4's inputs at the Tacotron(1) path's frame bucket (1,760 for
    its 1,750 frames): speech-like magnitudes [8, T, Kf] on the card, a
    shared seeded phase, the unpacked bf16 constants, the window, the
    generator and the config's iterations."""
    import numpy as np
    import torch

    from your_voice_tts_torch.audio import FRAME_BUCKET
    from your_voice_tts_torch.ops.filters import hann_window
    from your_voice_tts_torch.ops.griffin_lim import unpacked_constants

    a = taco1_config().audio
    n_fft, (hop, win_len) = a.fft_size, a.resolved_hop_win()
    T = -(-TACO1_STEPS * TACO1_R // FRAME_BUCKET) * FRAME_BUCKET
    window = hann_window(win_len, n_fft).astype(np.float32)
    mags = speech_like(8, T, n_fft, hop, a.sample_rate, window).cuda()
    g = torch.Generator().manual_seed(4)
    phase = (torch.rand(T, n_fft // 2 + 1, generator=g) * 2 * np.pi).cuda()
    consts = unpacked_constants(n_fft, hop, window, torch.bfloat16, "cuda")
    return mags, phase, consts, window, g, a.griffin_lim_iters


def phase_gl_iteration(report):
    """Kernel 4 at the Tacotron(1) path's launch shapes: the frame bucket of
    its 250 steps x r=7 = 1,750 frames (1,760), the config's n_fft / hop /
    window and Griffin-Lim iterations, for the batch of 8 and for one row
    (the batch-1 requests), from one shared phase."""
    import torch

    from your_voice_tts_torch.ops.dsp import istft
    from your_voice_tts_torch.ops.griffin_lim import (gl_iteration_cuda, gl_iteration_plain,
                                                      gl_iteration_serial_cuda, gl_route)

    mags, phase, consts, window, g, iters = gl_iteration_inputs()
    n_fft, hop, T = consts["n_fft"], consts["hop"], mags.shape[1]
    check(gl_route(T, n_fft, hop) == "iteration", "the Tacotron(1) path's Griffin-Lim route")
    Kf = n_fft // 2 + 1
    win = torch.from_numpy(window).cuda()
    nudge = 1 + 1e-4 * torch.randn(mags.shape, generator=g).cuda()
    start = lambda m: (m * torch.cos(phase), m * torch.sin(phase))  # noqa: E731
    run = lambda fn, m, n: fn(*start(m), m, consts, n_iters=n)  # noqa: E731
    wav = lambda F_: istft(torch.complex(*F_), n_fft, hop, win)  # noqa: E731
    held = {}
    for B in (8, 1):
        mag = mags[:B]
        out = {n: (run(gl_iteration_cuda, mag, n), run(gl_iteration_plain, mag, n))
               for n in (1, iters)}
        for n, (got, _) in out.items():
            check(all(x.shape == (B, T, Kf) and bool(torch.isfinite(x).all()) for x in got),
                  "gl-iteration output shape / finiteness")
        (gr, gi), (rr, ri) = out[1]
        rel1 = float(torch.cat([gr - rr, gi - ri]).norm() / torch.cat([rr, ri]).norm())
        err1 = float(torch.maximum((gr - rr).abs(), (gi - ri).abs()).max())
        y_k, y_p = wav(out[iters][0]), wav(out[iters][1])
        y_n = wav(run(gl_iteration_plain, mag * nudge[:B], iters))
        sens = float((y_n - y_p).norm() / y_p.norm())
        conv0 = spectral_convergence(wav(start(mag)), mag, n_fft, hop, win)
        conv_k = spectral_convergence(y_k, mag, n_fft, hop, win)
        conv_p = spectral_convergence(y_p, mag, n_fft, hop, win)
        gap = max(abs(x - y) for x, y in zip(conv_k, conv_p))
        # held as the wave route is: one iteration to rel L2 1e-2; after the
        # config's plain iterations the kernel's reconstruction is within
        # 0.02 of the plain version's spectral convergence on every row, and
        # better than the starting phase's on every row
        print(f"[gl-iteration] B={B} T={T} (M={B * T} rows) 1 iteration: rel L2 err "
              f"{rel1:.3e} (tol 1e-2), max_abs_err {err1:.3e} of peak {float(mag.max()):.3e}")
        print(f"[gl-iteration] B={B} {iters} iterations: spectral convergence start "
              f"{[round(x, 4) for x in conv0]} kernel {[round(x, 4) for x in conv_k]} plain "
              f"{[round(x, 4) for x in conv_p]}; largest gap {gap:.4f} (tol 0.02); waveform "
              f"rel L2 kernel vs plain {float((y_k - y_p).norm() / y_p.norm()):.3e}, plain vs "
              f"plain from magnitudes nudged by 1e-4 {sens:.3e}")
        check(rel1 <= 1e-2, f"gl-iteration kernel disagrees with plain after one iteration "
                            f"(B={B})")
        check(gap <= 0.02 and all(k < c for k, c in zip(conv_k, conv0)),
              f"gl-iteration kernel quality differs from plain (B={B})")
        ms = cuda_ms(lambda: run(gl_iteration_cuda, mag, iters), 5)
        plain_ms = cuda_ms(lambda: run(gl_iteration_plain, mag, iters), 3)
        M = B * T
        fb = torch.randn(M, consts["syn"].shape[0], device="cuda").to(torch.bfloat16)
        gb = torch.randn(M, n_fft, device="cuda").to(torch.bfloat16)

        def library():
            for _ in range(iters):
                torch.matmul(fb, consts["syn"])
                torch.matmul(gb, consts["ana"])

        lib_ms = cuda_ms(library, 5)
        # two [M, N] x [N, N] products an iteration: N columns carry the
        # Kf = N/2 + 1 bins' work (the packed plane and the Nyquist bin
        # beside it)
        ops_s = iters * 2 * 2 * M * n_fft * n_fft / BF16_FLOPS
        io_bytes = 5 * M * Kf * 4 + 2 * (2 * Kf) * n_fft * 2
        bound_ms, bound_by = bound(io_bytes, ops_s)
        print(f"[gl-iteration] B={B} T={T} n_fft={n_fft} hop={hop} iters={iters} kernel_ms "
              f"{ms:.2f}  plain_ms {plain_ms:.2f}  bound_ms {bound_ms:.3f} ({bound_by}; "
              f"{n_fft} columns a product)  library_ms {lib_ms:.2f} "
              f"(torch.matmul bf16 on the same {2 * iters} padded products; a yardstick for "
              f"the products only)")
        issued = gl_iteration_cuda.launches
        run(gl_iteration_cuda, mag, iters)
        issued = gl_iteration_cuda.launches - issued
        per = hold_gl_launches(f"gl-iteration B={B}", "iteration",
                               lambda: run(gl_iteration_serial_cuda, mag, iters), issued, iters)
        held[B] = dict(rel_l2_1iter=rel1, max_abs_err_1iter=err1, sensitivity=sens,
                       conv_start=conv0, conv_kernel=conv_k, conv_plain=conv_p, ms=ms,
                       plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by,
                       library_ms=lib_ms, launch_us=per, launches_a_call=issued)
    report["gl_iteration"] = dict(T=T, n_fft=n_fft, hop=hop, iters=iters,
                                  **{f"B{B}": v for B, v in held.items()})
    b8 = held[8]
    return {"name": "gl_iteration_cuda", "route": "cuda",
            "source": "your_voice_tts_torch/csrc/griffin_lim.cu",
            "replaces": "your_voice_tts_tpu/ops/pallas/griffin_lim.py:72",
            "max_abs_err": max(v["max_abs_err_1iter"] for v in held.values()),
            "ms": b8["ms"], "plain_ms": b8["plain_ms"], "bound_ms": b8["bound_ms"],
            "bound_by": b8["bound_by"], "library_ms": b8["library_ms"]}


def phase_taco1_main(report):
    """Synthesizer on a Tacotron(1) config: text -> linear spectrogram ->
    Griffin-Lim past the whole-loop cap (per-iteration kernel) -> wav."""
    import torch

    from your_voice_tts_torch.infer.synthesis import _pad_texts, text_to_seq
    from your_voice_tts_torch.infer.synthesizer import Synthesizer
    from your_voice_tts_torch.ops.taco1_decode import tacotron1_decode_cuda
    from your_voice_tts_torch.ops.taco2_decode import tacotron2_decode_cuda

    synth = Synthesizer(taco1_config(), device="cuda")
    no_chance_stops(synth.model)
    synth.tts_many(SENTENCES[:1])                  # one-time set-up, not measured
    torch.cuda.synchronize()

    counters = (tacotron1_decode_cuda, tacotron2_decode_cuda) + gl_counters()
    for c in counters:
        c.launches = 0
    t0 = time.perf_counter()
    batch = synth.tts_many(SENTENCES)
    t_batch = time.perf_counter() - t0
    lat = []
    for s in SENTENCES[:5]:
        t0 = time.perf_counter()
        one = synth.tts_many([s])
        lat.append(time.perf_counter() - t0)
    seen = {c.__name__: c.launches for c in counters}

    n_frames = TACO1_STEPS * TACO1_R
    text, lengths = _pad_texts([text_to_seq(t, synth.cfg) for t in SENTENCES])
    mel_lengths = synth.model.inference(text, lengths)["mel_lengths"]
    check(mel_lengths.tolist() == [n_frames] * len(SENTENCES), "taco1 path mel lengths")
    frames = int(mel_lengths.sum())
    sr, hop = synth.ap.sample_rate, synth.ap.hop_length
    audio_s = sum(len(w) for w in batch) / sr
    check(all(w.ndim == 1 and len(w) > 0 and bool(torch.isfinite(torch.from_numpy(w)).all())
              for w in batch + one), "taco1 path waveforms")
    check(all(len(w) <= hop * (n_frames - 1) for w in batch), "taco1 path waveform lengths")
    p50 = statistics.median(lat)
    # random weights make quiet noise, which the silence trim cuts short:
    # the factor over the decoded frames is the one that compares
    decoded_s = frames * hop / sr
    print(f"[taco1-main] batch of 8 (r={TACO1_R}, {n_frames} frames a row): "
          f"{t_batch * 1e3:.1f} ms, {frames / t_batch:.0f} mel frames/s, real-time factor "
          f"{decoded_s / t_batch:.1f}x realtime over the {decoded_s:.2f} s decoded "
          f"({audio_s / t_batch:.1f}x over the {audio_s:.2f} s left after the silence trim)")
    print(f"[taco1-main] batch-1 latency p50 {p50 * 1e3:.1f} ms (all: "
          f"{', '.join(f'{x * 1e3:.1f}' for x in lat)} ms)")
    print(f"[taco1-main] launches on the Tacotron(1) path: {seen}")
    # kernel 4: one gl_plain call (one ctypes call) a tts_many call, 3 n
    # dependent launches each
    calls, iters = 1 + len(lat), synth.cfg.audio.griffin_lim_iters
    print(f"[taco1-main] gl_iteration_cuda: {calls} calls, launches a call "
          f"{seen['gl_iteration_cuda'] / calls:g} (3 x {iters} iterations, counted by "
          f"gl_plain), ctypes calls a call 1 (was 3 x {iters} = {3 * iters})")
    check(seen["tacotron1_decode_cuda"] > 0 and seen["gl_iteration_cuda"] == calls * 3 * iters
          and seen["tacotron2_decode_cuda"] == 0 and seen["griffin_lim_wave_cuda"] == 0
          and seen["griffin_lim_full_cuda"] == 0, "Tacotron(1) path kernels")
    report["taco1_main"] = dict(batch_ms=t_batch * 1e3, mel_frames_per_s=frames / t_batch,
                                rtf_x_realtime=decoded_s / t_batch,
                                rtf_trimmed_x_realtime=audio_s / t_batch,
                                p50_batch1_ms=p50 * 1e3,
                                batch1_ms=[x * 1e3 for x in lat], launches=seen)
    launches = {k: seen[k] for k in ("tacotron1_decode_cuda", "gl_iteration_cuda")}
    return launches, synth


def phase_taco1_profile(report, synth, out_dir: str):
    """One batch-of-8 call on the Tacotron(1) path under torch.profiler."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        synth.tts_many(SENTENCES)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    prof.export_chrome_trace(os.path.join(out_dir, "taco1_profile_trace.json"))
    rows = device_rows(prof)
    busy_ms = sum(dev(e) for e in rows)
    print(f"[taco1-profile] batch of 8: wall {wall_ms:.1f} ms, device busy {busy_ms:.1f} ms "
          f"(idle share {1 - busy_ms / wall_ms:.3f})")
    for e in rows[:16]:
        print(f"[taco1-profile]   {dev(e):8.2f} ms  {e.count:6d} calls  {e.key[:90]}")
    report["taco1_profile"] = dict(wall_ms=wall_ms, busy_ms=busy_ms,
                                   kernels={e.key: [dev(e), e.count] for e in rows[:40]})


# ------------------------------------------------------------------ vocoder

SERVE_FRAMES, BENCH_FRAMES = 500, 1400      # a main-path row; bench.py's WaveRNN mel


def wavernn_inputs(model, frames: int, seed: int):
    """Folds of a seeded N(0, 1) mel of `frames` frames (plus the `pad`
    context frames each side) through the model's conditioning network:
    (cond, aux) [n_folds, target + 2 overlap, *] on the card."""
    import torch

    from your_voice_tts_torch.vocoder.config import WaveRNNConfig
    from your_voice_tts_torch.vocoder.models.wavernn import fold_with_overlap

    w = WaveRNNConfig()
    g = torch.Generator().manual_seed(seed)
    mel = torch.randn(frames + 2 * model.pad, model.n_mels, generator=g).cuda()
    with torch.no_grad():
        cond, aux = model.upsample(mel[None])
    return (fold_with_overlap(cond[0], w.target, w.overlap).contiguous(),
            fold_with_overlap(aux[0], w.target, w.overlap).contiguous())


def wavernn_bound(w, B: int, L: int) -> tuple[float, str]:
    """Float32 multiply-adds of every row-step (input layer, both GRUs'
    input and hidden products, fc1-3) at 67 TFLOP/s; bytes: the weights,
    the conditioning stream and the samples, each once."""
    macs = sum(t.numel() for t in w.values() if t.dim() == 2) + w["i_w0"].numel()
    wbytes = sum(t.numel() * 4 for t in w.values())
    C = w["i_wc"].shape[1] + 3 * (w["g2_wx"].shape[1] - w["g2_wh"].shape[1])
    return bound(wbytes + B * L * (C + 1) * 4, 2 * macs * B * L / F32_FLOPS)


def hold_wavernn(tag: str, w, cond, aux, bits: int, packed) -> tuple[dict, float]:
    """The kernel against its plain version on the same draws, mu-law
    greedy and sampled over every step: no row diverges before step 64
    (float32 sums in another order flip a near-tie now and then, and a row
    follows its own samples from there), mean |x| and std within 5%.
    Returns the readings and the plain version's ms (the last of the two)."""
    import torch

    from your_voice_tts_torch.ops.wavernn_gen import wavernn_generate_cuda, wavernn_generate_plain
    from your_voice_tts_torch.vocoder.models.wavernn import encode_mulaw

    out, plain_ms = {}, None
    L = cond.shape[1]
    for greedy in (True, False):
        got = wavernn_generate_cuda(w, cond, aux, 7, bits=bits, greedy=greedy, packed=packed)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        ref = wavernn_generate_plain(w, cond, aux, 7, bits=bits, greedy=greedy)
        torch.cuda.synchronize()
        plain_ms = (time.perf_counter() - t0) * 1e3
        same = encode_mulaw(got, bits) == encode_mulaw(ref, bits)
        first = [int((~r).nonzero()[0]) if not bool(r.all()) else L for r in same]
        stats = [(float(x.abs().mean()), float(x.std())) for x in (got, ref)]
        gap = max(abs(a - b) / b for a, b in zip(*stats))
        ok = (min(first) >= 64 and gap <= 0.05 and bool(torch.isfinite(got).all())
              and float(got.abs().max()) <= 1.0)
        name = "greedy" if greedy else "sampled"
        print(f"[wavernn] {tag} mu-law {name}: first divergent step per row {first} (tol: "
              f"none before 64); identical row-steps {float(same.float().mean()):.5f}; mean "
              f"|x| / std kernel {stats[0][0]:.4f} / {stats[0][1]:.4f}, plain "
              f"{stats[1][0]:.4f} / {stats[1][1]:.4f} (tol 5%); max abs err "
              f"{float((got - ref).abs().max()):.3e}")
        check(ok, f"WaveRNN kernel disagrees with plain ({tag}, mu-law {name})")
        out[name] = dict(first_divergent=first, identical=float(same.float().mean()),
                         stats=stats, max_abs_err=float((got - ref).abs().max()))
    return out, plain_ms


def wavernn_breakdown(tag: str, w, cond, aux, bits: int, packed, ms: float) -> dict:
    """us a step of the full launch and of its probe launches, the same
    kernel with parts of each step left out (dot products, staging copies,
    sampling); `barriers_only` is the barrier floor: the same grid, five
    grid.sync() a step, no work. A part costs about full - probe."""
    from your_voice_tts_torch.ops.wavernn_gen import PROBES, wavernn_probe_cuda

    L = cond.shape[1]
    probes = {name: cuda_ms(lambda: wavernn_probe_cuda(w, cond, aux, name, bits=bits,
                                                       packed=packed), 1) * 1e3 / L
              for name in PROBES}
    print(f"[wavernn] {tag} us a step: full {ms * 1e3 / L:.2f}; probes "
          + ", ".join(f"{k} {v:.2f}" for k, v in probes.items()))
    return dict(us_per_step=ms * 1e3 / L, probes_us_per_step=probes)


def phase_wavernn(report):
    import torch

    from your_voice_tts_torch.ops.wavernn_gen import (generation_weights, launch_shape,
                                                      wavernn_generate_cuda,
                                                      wavernn_generate_plain)
    from your_voice_tts_torch.vocoder.config import WaveRNNConfig
    from your_voice_tts_torch.vocoder.models.wavernn import WaveRNN

    c = WaveRNNConfig()
    model = WaveRNN(device="cuda", seed=3)
    w = generation_weights(model)
    packed = model.packed_weights(w)
    per_shape, errs, plain_ms = {}, [], None
    for frames, seed, reps in ((SERVE_FRAMES, 4, 3), (BENCH_FRAMES, 8, 2)):
        cond, aux = wavernn_inputs(model, frames, seed)
        B, L = cond.shape[:2]
        tag = f"B={B}"
        shape = launch_shape(B, L, model.n_mels, model.aux_dims, model.rnn_dims,
                             w["fc1_w"].shape[0], model.n_classes)
        print(f"[wavernn] {tag}: {B} folds x {L} steps; launch plan: {shape['blocks']} blocks "
              f"x {shape['threads']} threads, {shape['blocks_per_sm']} block(s) per SM, "
              f"shared memory {shape['smem_bytes']} B, tile rows {shape['tile_rows']} "
              f"({shape['tiles']} tiles), weights streamed from L2 every stage (slice "
              f"{shape['weight_slice_bytes']} B a block; only the input layer's rows stay "
              f"resident), {shape['barriers_per_step']} barriers a step")
        check(shape["barriers_per_step"] <= 5, "five grid barriers a step at most")
        out, pm = hold_wavernn(tag, w, cond, aux, c.bits, packed)
        plain_ms = plain_ms or pm
        errs.append(out["greedy"]["max_abs_err"])
        # the same draws on both sides, float32 sums in another order, 256
        # steps of continuous feedback; two input seeds a shape. 1e-4 over 22
        # rows; over 60 rows the largest of 60 chaotic rows reads higher, and
        # the six-barrier kernel read 1.74e-4 on these inputs (MoL, input
        # seed 6) with samples bit-identical to this kernel's: 2.5e-4 there.
        tol = 1e-4 if frames == SERVE_FRAMES else 2.5e-4
        for mode in ("mol", "gauss"):
            m = WaveRNN(mode=mode, device="cuda", seed=5)
            wm = generation_weights(m)
            for in_seed in (6, 16):
                cm, am = wavernn_inputs(m, frames, seed=in_seed)
                cm, am = cm[:, :256].contiguous(), am[:, :256].contiguous()
                err = float((wavernn_generate_cuda(wm, cm, am, 7, bits=c.bits, mode=mode)
                             - wavernn_generate_plain(wm, cm, am, 7, bits=c.bits, mode=mode))
                            .abs().max())
                print(f"[wavernn] {tag} {mode} sampled, input seed {in_seed}, {cm.shape[0]} "
                      f"rows x 256 steps: max abs err {err:.3e} (tol {tol:g})")
                check(err <= tol, f"WaveRNN kernel disagrees with plain ({tag}, {mode})")
                out[f"{mode}_seed{in_seed}"] = err
                errs.append(err)
        ms = cuda_ms(lambda: wavernn_generate_cuda(w, cond, aux, 7, bits=c.bits, packed=packed),
                     reps)
        bound_ms, bound_by = wavernn_bound(w, B, L)
        parts = wavernn_breakdown(tag, w, cond, aux, c.bits, packed, ms)
        print(f"[wavernn] {tag} L={L}: kernel_ms {ms:.2f} ({ms * 1e3 / L:.2f} us a step)  "
              f"bound_ms {bound_ms:.2f} ({bound_by})  barrier floor "
              f"{parts['probes_us_per_step']['barriers_only'] * L / 1e3:.2f} ms")
        per_shape[B] = dict(launch=shape, comparisons=out, ms=ms, bound_ms=bound_ms,
                            bound_by=bound_by, **parts)
    serve, bench = per_shape.values()
    mel = torch.randn(BENCH_FRAMES, model.n_mels, generator=torch.Generator().manual_seed(9))
    model.generate(mel.cuda(), 1)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    wav = model.generate(mel.cuda(), 1)
    torch.cuda.synchronize()
    gen_s = time.perf_counter() - t0
    rtf = len(wav) / 22050 / gen_s
    print(f"[wavernn] serving shape: kernel_ms {serve['ms']:.2f}  plain_ms {plain_ms:.2f}  "
          f"bound_ms {serve['bound_ms']:.2f} ({serve['bound_by']})  library_ms none (no single "
          f"PyTorch call feeds a sample back)")
    print(f"[wavernn] generate on the {BENCH_FRAMES}-frame mel: {gen_s * 1e3:.1f} ms for "
          f"{len(wav)} samples, wavernn_fold_rtf {rtf:.1f}x realtime at 22050 Hz "
          f"(kernel {bench['ms']:.2f} ms of it)")
    report["wavernn"] = dict(shapes={str(k): v for k, v in per_shape.items()}, ms=serve["ms"],
                             plain_ms=plain_ms, bound_ms=serve["bound_ms"],
                             bound_by=serve["bound_by"], bench_ms=bench["ms"],
                             bench_bound_ms=bench["bound_ms"], generate_ms=gen_s * 1e3,
                             wavernn_fold_rtf=rtf)
    return {"name": "wavernn_generate_cuda", "route": "cuda",
            "source": "your_voice_tts_torch/csrc/wavernn_gen.cu",
            "replaces": "your_voice_tts_tpu/ops/pallas/wavernn_gen.py:229",
            "max_abs_err": max(errs), "ms": serve["ms"], "plain_ms": plain_ms,
            "bound_ms": serve["bound_ms"], "bound_by": serve["bound_by"], "library_ms": None}


def serve_requests(synth, speakers=None, style_wav=None):
    """The batch of 8 sentences and 5 batch-1 requests through tts_many
    (`speakers`: one a sentence, or None; style_wav: a GST model's style
    reference); returns (batch waveforms, batch seconds, batch-1 seconds,
    batch-1 waveforms)."""
    t0 = time.perf_counter()
    batch = synth.tts_many(SENTENCES, speakers, style_wav=style_wav)
    t_batch = time.perf_counter() - t0
    lat, ones = [], []
    for i, s in enumerate(SENTENCES[:5]):
        t0 = time.perf_counter()
        ones += synth.tts_many([s], None if speakers is None else [speakers[i]],
                               style_wav=style_wav)
        lat.append(time.perf_counter() - t0)
    return batch, t_batch, lat, ones


def serving_numbers(tag: str, synth, served, launches: dict) -> dict:
    """Checks the waveforms of `serve_requests` (finite, no longer than the 500
    decoded frames) and prints mel frames/s, real-time factor and p50 as
    the main path does (every row decodes all 250 steps)."""
    import numpy as np

    batch, t_batch, lat, ones = served
    sr, hop = synth.ap.sample_rate, synth.ap.hop_length
    frames = SERVE_FRAMES * len(SENTENCES)
    audio_s = sum(len(w) for w in batch) / sr
    check(all(w.ndim == 1 and len(w) > 0 and bool(np.isfinite(w).all()) for w in batch + ones),
          f"{tag} waveforms")
    check(all(len(w) <= SERVE_FRAMES * hop for w in batch), f"{tag} waveform lengths")
    p50 = statistics.median(lat)
    print(f"[{tag}] batch of 8: {t_batch * 1e3:.1f} ms, {frames / t_batch:.0f} mel frames/s, "
          f"{audio_s:.2f} s of audio, real-time factor {audio_s / t_batch:.1f}x realtime")
    print(f"[{tag}] batch-1 latency p50 {p50 * 1e3:.1f} ms (all: "
          f"{', '.join(f'{x * 1e3:.1f}' for x in lat)} ms)")
    print(f"[{tag}] launches: {launches}")
    return dict(batch_ms=t_batch * 1e3, mel_frames_per_s=frames / t_batch,
                rtf_x_realtime=audio_s / t_batch, p50_batch1_ms=p50 * 1e3,
                batch1_ms=[x * 1e3 for x in lat], launches=launches)


def serve_counted(tag: str, synth, speakers=None, kernels=(), style_wav=None) -> dict:
    """`serve_requests` after a one-time set-up call, with the launch counters of the
    decode, of `kernels` and of every Griffin-Lim route set to 0 just before
    and read just after; `serving_numbers` of it."""
    import torch

    from your_voice_tts_torch.ops.taco2_decode import tacotron2_decode_cuda

    synth.tts_many(SENTENCES[:1], None if speakers is None else speakers[:1],
                   style_wav=style_wav)
    torch.cuda.synchronize()
    counters = (tacotron2_decode_cuda, *kernels) + gl_counters()
    for c in counters:
        c.launches = 0
    served = serve_requests(synth, speakers, style_wav)
    return serving_numbers(tag, synth, served, {c.__name__: c.launches for c in counters})


def phase_vocoder_path(report):
    from your_voice_tts_torch.infer.synthesizer import Synthesizer
    from your_voice_tts_torch.ops.wavernn_gen import wavernn_generate_cuda
    from your_voice_tts_torch.vocoder.config import VocoderConfig

    cfg = full_width_config()
    synth = Synthesizer(cfg, vocoder_config=VocoderConfig(model="wavernn", audio=cfg.audio),
                        device="cuda")
    no_chance_stops(synth.model)
    numbers = serve_counted("vocoder", synth, kernels=(wavernn_generate_cuda,))
    launches = numbers["launches"]
    check(launches["tacotron2_decode_cuda"] > 0 and launches["wavernn_generate_cuda"] > 0
          and not any(launches[c.__name__] for c in gl_counters()), "vocoder path kernels")
    report["vocoder"] = numbers
    return launches, synth


def phase_vocoder_profile(report, synth, out_dir: str, tag: str = "vocoder"):
    """One batch-1 request on a vocoder path (`tag`: vocoder, WaveRNN; melgan)
    under torch.profiler."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        synth.tts_many(SENTENCES[:1])
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    prof.export_chrome_trace(os.path.join(out_dir, f"{tag}_profile_trace.json"))
    rows = device_rows(prof)
    busy_ms = sum(dev(e) for e in rows)
    print(f"[{tag}-profile] batch-1 request: wall {wall_ms:.1f} ms, device busy "
          f"{busy_ms:.1f} ms (idle share {1 - busy_ms / wall_ms:.3f})")
    for e in rows[:12]:
        print(f"[{tag}-profile]   {dev(e):8.2f} ms  {e.count:6d} calls  {e.key[:90]}")
    report[f"{tag}_profile"] = dict(wall_ms=wall_ms, busy_ms=busy_ms,
                                    kernels={e.key: [dev(e), e.count] for e in rows[:40]})


# ----------------------------------------- MelGAN / PWGAN serving, speaker cloning


def phase_melgan_main(report):
    """Config #2: Synthesizer with the default MelGAN vocoder at full width."""
    import numpy as np
    import torch

    from your_voice_tts_torch.infer.synthesis import _pad_texts, text_to_seq
    from your_voice_tts_torch.infer.synthesizer import Synthesizer
    from your_voice_tts_torch.vocoder.config import VocoderConfig
    from your_voice_tts_torch.vocoder.synthesizer import VocoderSynthesizer

    cfg = full_width_config()
    # the default MelganConfig: factors (8, 8, 2, 2) = the hop 256, 512 channels
    synth = Synthesizer(cfg, vocoder_config=VocoderConfig(model="melgan", audio=cfg.audio),
                        device="cuda")
    no_chance_stops(synth.model)
    gen = synth.vocoder.model
    check(gen.hop == synth.ap.hop_length, "MelGAN hop")
    numbers = serve_counted("melgan-main", synth)
    seen = numbers["launches"]
    check(seen["tacotron2_decode_cuda"] > 0 and not any(
        seen[c.__name__] for c in gl_counters()), "MelGAN path: the decode, no Griffin-Lim")

    # the generator alone at bench config 2's shape: one call on the padded
    # [8, 500, 80] batch of the decoded mels
    text, lengths = _pad_texts([text_to_seq(t, synth.cfg) for t in SENTENCES])
    mels = synth.model.inference(text, lengths)["postnet_outputs"]
    sr = synth.ap.sample_rate
    with torch.no_grad():
        wav = gen(mels)
        check(tuple(wav.shape) == (8, SERVE_FRAMES * gen.hop)
              and bool(torch.isfinite(wav).all()), "MelGAN batch output")
        gen_ms = cuda_ms(lambda: gen(mels), 5)
        row_ms = cuda_ms(lambda: gen(mels[:1]), 5)        # the path vocodes a row a call
    gen_audio_s = wav.numel() / sr
    # bench config 2 end to end: 8 rows of 64 random symbols, 250 steps, the
    # generator on the decoder's padded output
    g = torch.Generator().manual_seed(8)
    text64 = torch.randint(1, synth.model.embedding.num_embeddings, (8, 64), generator=g)
    lens64 = torch.full((8,), 64)

    def taco_melgan():
        with torch.no_grad():
            return gen(synth.model.inference(text64, lens64)["postnet_outputs"])

    bench_ms = cuda_ms(taco_melgan, 3)
    bench_audio_s = 8 * DECODE_STEPS * 2 * gen.hop / sr
    print(f"[melgan-main] generator alone on [8, {SERVE_FRAMES}, 80]: {gen_ms:.2f} ms "
          f"({gen_audio_s / gen_ms * 1e3:.0f}x realtime), on one row {row_ms:.2f} ms; "
          f"bench config 2 (8 x 64 symbols, "
          f"{DECODE_STEPS} steps, decode + generator): {bench_ms:.2f} ms, "
          f"{bench_audio_s / bench_ms * 1e3:.1f}x realtime")

    # one PWGAN row at its default config (30 layers in 3 stacks, factors
    # (4, 4, 4, 4) = the hop), random weights, noise from the facade's generator
    pw = VocoderSynthesizer(VocoderConfig(model="pwgan", audio=cfg.audio), device="cuda")
    row = mels[1].T.cpu().numpy()
    pw_wav = pw.mel_to_wav(row)
    check(pw_wav.shape == (SERVE_FRAMES * pw.model.hop,) and bool(np.isfinite(pw_wav).all()),
          "PWGAN row")
    pw_ms = cuda_ms(lambda: pw.mel_to_wav(row), 3)
    print(f"[melgan-main] PWGAN row ({SERVE_FRAMES} frames -> {len(pw_wav)} samples): "
          f"{pw_ms:.2f} ms ({len(pw_wav) / sr / pw_ms * 1e3:.0f}x realtime)")
    report["melgan_main"] = dict(numbers, generator_ms=gen_ms,
                                 generator_x_realtime=gen_audio_s / gen_ms * 1e3,
                                 generator_row_ms=row_ms,
                                 bench_config2_ms=bench_ms,
                                 bench_config2_x_realtime=bench_audio_s / bench_ms * 1e3,
                                 pwgan_row_ms=pw_ms)
    return seen, synth


def phase_melgan_asset(report):
    """The trained MelGAN asset on the card against the same port on the CPU."""
    import glob

    import numpy as np

    from your_voice_tts_torch.audio import AudioProcessor
    from your_voice_tts_torch.data.synthetic import make_synthetic_corpus
    from your_voice_tts_torch.vocoder.config import load_vocoder_config
    from your_voice_tts_torch.vocoder.synthesizer import VocoderSynthesizer

    cfg = os.path.join(ROOT, "configs/melgan_smoke.json")
    ckpt = os.path.join(ROOT, "assets/bench_trained_melgan.npz")
    ap = AudioProcessor(load_vocoder_config(cfg).audio)
    with tempfile.TemporaryDirectory() as tmp:
        make_synthetic_corpus(tmp, n_items=1, sr=8000, seed=11)
        mel = ap.melspectrogram(ap.load_wav(glob.glob(os.path.join(tmp, "wavs", "*.wav"))[0]))
    card = VocoderSynthesizer(cfg, ckpt, device="cuda").mel_to_wav(mel)
    cpu = VocoderSynthesizer(cfg, ckpt, device="cpu").mel_to_wav(mel)
    err = float(np.abs(card - cpu).max())
    # float32 on both sides, TF32 off: cuDNN's sums in another order only
    tol = 1e-4
    print(f"[melgan-asset] trained asset, mel [20, {mel.shape[1]}] -> {len(card)} samples "
          f"(peak {np.abs(cpu).max():.3f}): card vs CPU max_abs_err {err:.3e} (tol {tol})")
    check(card.shape == cpu.shape and err <= tol, "trained MelGAN differs between card and CPU")
    report["melgan_asset"] = dict(max_abs_err=err, tol=tol, samples=len(card))


CLONING_E = ((256, 768), (0, 1024))    # (spk_dim, E): GE2E d-vectors, the 512-wide table


@contextlib.contextmanager
def plain_decode_on_card():
    """Tacotron2.inference's decode through its plain PyTorch version on the
    card's tensors: the comparison route of the cloning phase (serving never
    takes it; this script switches it here and back)."""
    import your_voice_tts_torch.models.tacotron2 as t2
    from your_voice_tts_torch.ops.taco2_decode import tacotron2_decode_plain

    saved = t2.tacotron2_decode
    t2.tacotron2_decode = tacotron2_decode_plain
    try:
        yield
    finally:
        t2.tacotron2_decode = saved


def hold_conditioned_decode(report) -> dict:
    """(a) kernel 1 against its plain version at E = 768 and 1,024, B=8
    and B=1, with the decode phase's inputs, steps and tolerances."""
    import torch

    from your_voice_tts_torch.ops.taco2_decode import (launch_plan, tacotron2_decode_cuda,
                                                       tacotron2_decode_plain)

    tol = (5e-3, 2e-3, 2e-3)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    base = report["decode"]
    rows = {}
    for spk_dim, E in CLONING_E:
        for B in (DECODE_B, 1):
            w, enc, pinp, mask, kw = decode_inputs(B, spk_dim)
            check(w["dims"]["E"] == E and enc.shape[-1] == E, f"conditioned width E={E}")
            plan = launch_plan(w["dims"], B, mask.shape[1], sms)
            before = tacotron2_decode_cuda.launches
            got = tacotron2_decode_cuda(w, enc, pinp, mask, **kw)
            per_decode = tacotron2_decode_cuda.launches - before
            ref = tacotron2_decode_plain(w, enc, pinp, mask, **kw)
            e = [float((a - b).abs().max()) for a, b in zip(got[:3], ref[:3])]
            stop_pattern = [1] + [DECODE_STEPS] * 7 if B == DECODE_B else [DECODE_STEPS]
            print(f"[cloning] E={E} B={B}: plan shared memory {plan['smem_bytes']} B, "
                  f"WB_ROUNDS {plan['WB_ROUNDS']}, PRE_SMEM {plan['PRE_SMEM']}; lengths kernel "
                  f"{got[3].tolist()} plain {ref[3].tolist()}; max_abs_err frames {e[0]:.3e}, "
                  f"alignments {e[1]:.3e}, stops {e[2]:.3e} (tol {tol})")
            check(torch.equal(got[3].cpu(), ref[3].cpu()) and got[3].tolist() == stop_pattern,
                  f"conditioned decode lengths (E={E}, B={B})")
            check(all(x <= t for x, t in zip(e, tol)) and per_decode == 1,
                  f"conditioned decode kernel disagrees with plain (E={E}, B={B})")
            ms = cuda_ms(lambda: tacotron2_decode_cuda(w, enc, pinp, mask, **kw), 5)
            plain_ms = cuda_ms(lambda: tacotron2_decode_plain(w, enc, pinp, mask, **kw), 1) \
                if B == DECODE_B else None
            bound_ms, bound_by, wmb, _ = decode_bound(w, enc, pinp, mask, DECODE_STEPS)
            e512 = base["ms"] if B == DECODE_B else base["b1"]["ms"]
            print(f"[cloning] E={E} B={B}: kernel_ms {ms:.2f} (E=512: {e512:.2f})  plain_ms "
                  f"{'%.2f' % plain_ms if plain_ms else 'not timed'}  bound_ms {bound_ms:.3f} "
                  f"({bound_by}; {wmb:.1f} MB bf16 weights)")
            rows[f"E{E}_B{B}"] = dict(errs=e, ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                                      bound_by=bound_by, weight_mb=wmb, e512_ms=e512,
                                      smem_bytes=plan["smem_bytes"],
                                      WB_ROUNDS=plan["WB_ROUNDS"], PRE_SMEM=plan["PRE_SMEM"])
    return rows


def cloning_trials(model, enc, dvecs: dict, cfg) -> list[float]:
    """bench.py's cloning_extras: one synthesis a speaker and sentence with
    the speaker's d-vector, the mel re-embedded by the trained encoder at 40
    frames; each trial's cos(target) - max cos(other speaker)."""
    import numpy as np

    from your_voice_tts_torch.infer.synthesis import text_to_seq

    names = sorted(dvecs)
    margins = []
    for spk in names:
        for sent in ("the quick brown fox jumps over a lazy dog.",
                     "seven wizards brew magic tonic under calm evening skies."):
            seq = text_to_seq(sent, cfg)
            out = model.inference(np.asarray(seq)[None], [len(seq)],
                                  speaker_embeddings=dvecs[spk][None])
            n = int(out["mel_lengths"][0]) or out["postnet_outputs"].shape[1]
            e = enc.compute_embedding(out["postnet_outputs"][0, :n], num_frames=40).cpu().numpy()
            sims = {o: float(e @ dvecs[o]) for o in names}
            margins.append(sims[spk] - max(v for o, v in sims.items() if o != spk))
    return margins


def phase_cloning(report):
    """Config #5: kernel 1 at the conditioned widths, then cloning through
    Synthesizer with a d-vector mapping written by bin/compute_embeddings
    (E=768) and with an id mapping (E=1,024), then the trained assets'
    selectivity on the kernel route and on the plain route."""
    import io

    import numpy as np

    from your_voice_tts_torch.bin import compute_embeddings
    from your_voice_tts_torch.config import load_config
    from your_voice_tts_torch.data.synthetic import make_synthetic_corpus
    from your_voice_tts_torch.infer.synthesizer import Synthesizer
    from your_voice_tts_torch.models import setup_model
    from your_voice_tts_torch.ops.taco2_decode import tacotron2_decode_cuda
    from your_voice_tts_torch.speaker_encoder.model import load_encoder
    from your_voice_tts_torch.text import symbols
    from your_voice_tts_torch.train.checkpoint import load_checkpoint
    from your_voice_tts_torch.utils.speakers import load_speaker_mapping, parse_speakers

    out = {"kernel": hold_conditioned_decode(report)}
    cfg = full_width_config()
    launches: dict = {}
    with tempfile.TemporaryDirectory() as tmp:
        # (b) d-vectors of a full-width random GE2E encoder (80 -> 3 x 768 / 256)
        corpus = make_synthetic_corpus(os.path.join(tmp, "corpus"), n_items=16, sr=22050,
                                       n_speakers=4, seed=5)
        dvec_json = os.path.join(tmp, "dvectors.json")
        t0 = time.perf_counter()
        log = io.StringIO()
        with contextlib.redirect_stdout(log):
            compute_embeddings.main(["--config",
                                     os.path.join(ROOT, "configs/ljspeech_tacotron2.json"),
                                     "--data_path", corpus, "--formatter", "synthetic",
                                     "--output", dvec_json])
        embed_s = time.perf_counter() - t0
        mapping = load_speaker_mapping(dvec_json)
        check(sorted(mapping) == [f"SYN{i:02d}" for i in range(4)]
              and all(len(c) == 4 and all(len(v["embedding"]) == 256 for v in c.values())
                      for c in mapping.values()), "compute_embeddings mapping")
        print(f"[cloning] bin/compute_embeddings on the card: 16 clips, 4 speakers, 256-wide "
              f"d-vectors in {embed_s:.2f} s ({log.getvalue().strip().splitlines()[-1].strip()})")
        id_json = os.path.join(tmp, "ids.json")
        with open(id_json, "w") as f:
            json.dump({f"SYN{i:02d}": i for i in range(4)}, f)
        for tag, path, speakers, E in (
                ("cloning-dvec", dvec_json, [f"SYN{i % 4:02d}" for i in range(8)], 768),
                ("cloning-id", id_json, [i % 4 for i in range(8)], 1024)):
            synth = Synthesizer(cfg, speakers_json=path, device="cuda")
            no_chance_stops(synth.model)
            check(synth.model.decoder.decode_weights(synth.decode_dtype)["dims"]["E"] == E,
                  f"{tag} width")
            numbers = serve_counted(tag, synth, speakers)
            seen = numbers["launches"]
            check(seen["tacotron2_decode_cuda"] > 0 and seen["griffin_lim_wave_cuda"] > 0
                  and not seen["griffin_lim_full_cuda"] and not seen["gl_iteration_cuda"],
                  f"{tag} kernels")
            out[tag] = dict(numbers, E=E)
            for k, v in seen.items():
                launches[k] = launches.get(k, 0) + v
            del synth

    # (d) the trained assets, bench.py's cloning_extras procedure
    _, dvecs = parse_speakers(load_speaker_mapping(
        os.path.join(ROOT, "assets/speakers_smoke.json")))
    spk_dim = len(next(iter(dvecs.values())))
    smoke = load_config(os.path.join(ROOT, "configs/smoke_synthetic.json"))
    smoke = dataclasses.replace(
        smoke, model=dataclasses.replace(smoke.model, max_decoder_steps=256),
        speakers=dataclasses.replace(smoke.speakers, use_speaker_embedding=True,
                                     use_external_speaker_embedding_file=True,
                                     speaker_embedding_dim=spk_dim))
    model = setup_model(len(symbols), smoke, device="cuda", num_speakers=len(dvecs),
                        speaker_embedding_dim=spk_dim)
    meta = load_checkpoint(model, os.path.join(ROOT, "assets/bench_trained_multispeaker.npz"))
    model.set_r(meta.get("r", smoke.model.r))
    enc = load_encoder(os.path.join(ROOT, "assets/speaker_encoder_smoke.npz"), device="cuda")
    tacotron2_decode_cuda.launches = 0
    kernel = cloning_trials(model, enc, dvecs, smoke)
    n_kernel = tacotron2_decode_cuda.launches
    with plain_decode_on_card():
        plain = cloning_trials(model, enc, dvecs, smoke)
    check(n_kernel == len(kernel) and tacotron2_decode_cuda.launches == n_kernel,
          "cloning trials: one kernel launch a trial, none on the plain route")
    launches["tacotron2_decode_cuda"] += n_kernel
    for name, m in (("kernel", kernel), ("plain", plain)):
        print(f"[cloning] trained assets, {name} route: cloning_mean_margin {np.mean(m):.3f}, "
              f"cloning_selective_frac {sum(x > 0 for x in m) / len(m):.2f} over {len(m)} "
              f"trials (margins {', '.join(f'{x:+.3f}' for x in m)})")
        out[f"assets_{name}"] = dict(mean_margin=float(np.mean(m)),
                                     selective_frac=sum(x > 0 for x in m) / len(m), margins=m)
    check([x > 0 for x in kernel] == [x > 0 for x in plain],
          "a cloning trial's margin sign differs between the kernel and the plain route")
    out["launches"] = launches
    report["cloning"] = out
    return launches


# ------------------------------------------------- phonemes, GST, Tacotron(1) with speakers

STYLE_SECONDS = 2.0


def gst_config(cfg):
    """`cfg` with Global Style Tokens on (the GSTConfig defaults: 256 wide,
    4 heads, 10 tokens)."""
    return dataclasses.replace(cfg, speakers=dataclasses.replace(cfg.speakers, use_gst=True))


def style_wav(sr: int, seed: int = 3):
    """A seeded synthetic style reference of STYLE_SECONDS: ten harmonics
    of a pitch gliding 95-145 Hz under a syllable-rate envelope, and a
    little noise; peak 0.5."""
    import numpy as np

    rng = np.random.default_rng(seed)
    t = np.arange(int(STYLE_SECONDS * sr)) / sr
    f0 = 120.0 + 25.0 * np.sin(2 * np.pi * 0.7 * t + rng.uniform(0, 2 * np.pi))
    phase = 2 * np.pi * np.cumsum(f0) / sr
    y = sum(np.sin(k * phase + rng.uniform(0, 2 * np.pi)) / k for k in range(1, 11))
    y *= 0.6 + 0.4 * np.sin(2 * np.pi * 4.0 * t) ** 2
    y += 0.02 * rng.standard_normal(t.shape)
    return (0.5 * y / np.abs(y).max()).astype(np.float32)


def style_mels(cfg, wav, B: int):
    """The style mel of `wav` as synthesis_batch computes it, [B, T, n_mels]
    on the card."""
    import numpy as np
    import torch

    from your_voice_tts_torch.audio import AudioProcessor

    mel = AudioProcessor(cfg.audio, "cuda").melspectrogram(wav).T.astype(np.float32)
    return torch.from_numpy(mel).cuda()[None].expand(B, -1, -1)


def ids_checksum(cfg) -> tuple[str, int]:
    """sha256 (16 hex digits) of the 8 sentences' ids under `cfg`, and how
    many ids there are."""
    import hashlib

    import numpy as np

    from your_voice_tts_torch.infer.synthesis import text_to_seq

    seqs = [np.asarray(text_to_seq(t, cfg), np.int32) for t in SENTENCES]
    h = hashlib.sha256()
    for q in seqs:
        h.update(np.int32(len(q)).tobytes() + q.tobytes())
    return h.hexdigest()[:16], sum(len(q) for q in seqs)


def hold_taco1_e512(report) -> tuple[dict, float]:
    """(c) kernel 8 against its plain version at E = 512: the speaker table
    and GST-styled d-vectors, B=8 and B=1, T=160, r = 7, 250 steps, the
    taco1-decode phase's tolerances; each plan and time beside E = 256's
    from the same run."""
    import torch

    from your_voice_tts_torch.ops.taco1_decode import (_blocks, launch_plan,
                                                       tacotron1_decode_cuda,
                                                       tacotron1_decode_plain)
    from your_voice_tts_torch.ops.taco2_decode import batch_slices

    tol = (5e-3, 2e-3, 2e-3)
    base = report["taco1_decode"]
    wav = style_wav(22050)
    rows, errs = {}, []
    for tag, spk_dim, sty in (("table", 0, None), ("dvec_gst", 256, wav)):
        for B in (8, 1):
            w, enc, pinp, mask, kw = taco1_inputs(B, spk_dim, sty)
            kw = dict(kw, r=TACO1_R)
            E, T = w["dims"]["E"], mask.shape[1]
            check(E == 512 and enc.shape[-1] == 512, f"taco1 {tag} width E={E}")
            G = _blocks(enc.device)
            plan = launch_plan(w["dims"], B, T, G)
            slices = batch_slices(w["dims"], B, T, G, plan=launch_plan)
            before = tacotron1_decode_cuda.launches
            got = tacotron1_decode_cuda(w, enc, pinp, mask, **kw)
            per_decode = tacotron1_decode_cuda.launches - before
            ref = tacotron1_decode_plain(w, enc, pinp, mask, **kw)
            torch.cuda.synchronize()
            e = [float((a - b).abs().max()) for a, b in zip(got[:3], ref[:3])]
            errs += e
            pattern = [1] + [TACO1_STEPS] * 7 if B == 8 else [TACO1_STEPS]
            print(f"[conditioned] taco1 {tag} E={E} B={B} T={T}: plan {plan['blocks']} blocks, "
                  f"shared memory {plan['smem_bytes']} B (resident {plan['RES'] * 512} B), "
                  f"XLD {plan['XLD']}, CPB {plan['CPB']}, ALN {plan['ALN']}, PIN_SMEM "
                  f"{plan['PIN_SMEM']}, slices {slices}; lengths kernel {got[3].tolist()} plain "
                  f"{ref[3].tolist()}; max_abs_err frames {e[0]:.3e}, alignments {e[1]:.3e}, "
                  f"stops {e[2]:.3e} (tol {tol}); launches a decode {per_decode}")
            check(torch.equal(got[3].cpu(), ref[3].cpu()) and got[3].tolist() == pattern,
                  f"taco1 decode lengths at E=512 ({tag}, B={B})")
            check(all(x <= t for x, t in zip(e, tol)) and per_decode == 1,
                  f"taco1 decode kernel disagrees with plain at E=512 ({tag}, B={B})")
            ms = cuda_ms(lambda: tacotron1_decode_cuda(w, enc, pinp, mask, **kw), 5)
            plain_ms = (cuda_ms(lambda: tacotron1_decode_plain(w, enc, pinp, mask, **kw), 1)
                        if B == 8 and tag == "table" else None)
            bound_ms, bound_by, wmb = taco1_bound(w, enc, pinp, mask, TACO1_STEPS)
            e256 = base["ms"] if B == 8 else base["b1"]["ms"]
            print(f"[conditioned] taco1 {tag} E=512 B={B}: kernel_ms {ms:.2f} (E=256 in this "
                  f"run: {e256:.2f})  plain_ms {'%.2f' % plain_ms if plain_ms else 'not timed'}  "
                  f"bound_ms {bound_ms:.3f} ({bound_by}; {wmb:.1f} MB bf16 weights)")
            rows[f"{tag}_B{B}"] = dict(errs=e, ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                                       bound_by=bound_by, weight_mb=wmb, e256_ms=e256,
                                       smem_bytes=plan["smem_bytes"], RES=plan["RES"],
                                       slices=slices, blocks=plan["blocks"])
    return rows, max(errs)


def hold_gst_decode(report, wav) -> tuple[dict, float]:
    """(b) kernel 1 against its plain version on GST-shifted memory (E =
    512), B=8 and B=1, the decode phase's inputs, steps and tolerances."""
    import torch

    from your_voice_tts_torch.ops.taco2_decode import tacotron2_decode_cuda, tacotron2_decode_plain

    tol = (5e-3, 2e-3, 2e-3)
    rows, errs = {}, []
    for B in (DECODE_B, 1):
        w, enc, pinp, mask, kw = decode_inputs(B, style_wav=wav)
        before = tacotron2_decode_cuda.launches
        got = tacotron2_decode_cuda(w, enc, pinp, mask, **kw)
        per_decode = tacotron2_decode_cuda.launches - before
        ref = tacotron2_decode_plain(w, enc, pinp, mask, **kw)
        e = [float((a - b).abs().max()) for a, b in zip(got[:3], ref[:3])]
        errs += e
        pattern = [1] + [DECODE_STEPS] * 7 if B == DECODE_B else [DECODE_STEPS]
        print(f"[conditioned] GST E={enc.shape[-1]} B={B}: lengths kernel {got[3].tolist()} "
              f"plain {ref[3].tolist()}; max_abs_err frames {e[0]:.3e}, alignments {e[1]:.3e}, "
              f"stops {e[2]:.3e} (tol {tol})")
        check(torch.equal(got[3].cpu(), ref[3].cpu()) and got[3].tolist() == pattern,
              f"GST decode lengths (B={B})")
        check(all(x <= t for x, t in zip(e, tol)) and per_decode == 1,
              f"decode kernel disagrees with plain on GST memory (B={B})")
        ms = cuda_ms(lambda: tacotron2_decode_cuda(w, enc, pinp, mask, **kw), 5)
        base = report["decode"]["ms"] if B == DECODE_B else report["decode"]["b1"]["ms"]
        print(f"[conditioned] GST B={B}: kernel_ms {ms:.2f} (no style, this run: {base:.2f})")
        rows[f"B{B}"] = dict(errs=e, ms=ms, base_ms=base)
    return rows, max(errs)


def gst_breakdown(synth, wav, p50_ms: float, reps: int = 5) -> dict:
    """The two pieces a GST request adds to a plain one, timed apart at
    batch 1 and at the batch of 8 (medians of `reps`): the style mel
    (`ap.melspectrogram` of the style wav, host wall time from a
    synchronized start, its device work and copy back included) and
    `add_style` (the GST once on the [1, T, n_mels] mel at the config's
    compute dtype and the sum into the memory, as `synthesis_batch` runs
    it: host wall time and CUDA-event time), beside the GST path's
    batch-1 p50 over the main path's (the same widths without a style).
    Then the whole cost end to end: 2 x `reps` + 2 batch-1 requests to the
    same model, alternately with the style wav and without it (the GST
    branch skipped, its warning silenced), p50 of each."""
    import logging

    import numpy as np
    import torch

    from your_voice_tts_torch.infer.synthesis import _pad_texts, text_to_seq
    from your_voice_tts_torch.models.common import add_style, compute_copy

    model = synth.model
    dt = torch.bfloat16 if synth.cfg.model.inference_compute_dtype == "bfloat16" else None
    cast = ((lambda name: getattr(model, name)) if dt is None      # noqa: E731
            else (lambda name: compute_copy(model, name, dt)))
    mel = synth.ap.melspectrogram(wav).T[None].astype(np.float32)
    out = {}
    for B in (1, len(SENTENCES)):
        text, lengths = _pad_texts([text_to_seq(t, synth.cfg) for t in SENTENCES[:B]])
        with torch.no_grad():
            enc = cast("encoder")(cast("embedding")(torch.as_tensor(text, device="cuda")),
                                  torch.as_tensor(lengths, device="cuda"))
        walls = {"mel": [], "style": []}
        dev = []
        for _ in range(reps + 1):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            synth.ap.melspectrogram(wav)
            walls["mel"].append(time.perf_counter() - t0)
            torch.cuda.synchronize()
            ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
            t0 = time.perf_counter()
            ev[0].record()
            with torch.no_grad():
                add_style(model, enc, mel, cast)
            ev[1].record()
            torch.cuda.synchronize()
            walls["style"].append(time.perf_counter() - t0)
            dev.append(ev[0].elapsed_time(ev[1]))
        row = dict(mel_ms=statistics.median(walls["mel"][1:]) * 1e3,
                   add_style_ms=statistics.median(walls["style"][1:]) * 1e3,
                   add_style_device_ms=statistics.median(dev[1:]))
        print(f"[conditioned] GST pieces at B={B}: style mel {row['mel_ms']:.2f} ms, "
              f"add_style {row['add_style_ms']:.2f} ms host wall ({row['add_style_device_ms']:.2f} "
              f"ms between CUDA events), {mel.shape[1]} style frames")
        out[f"B{B}"] = row
    print(f"[conditioned] GST batch-1 p50 over the main path's: {p50_ms:.1f} ms")
    out["p50_over_main_ms"] = p50_ms
    lat: dict = {"style": [], "none": []}
    log = logging.getLogger("your_voice_tts_torch.models.common")
    level = log.level
    log.setLevel(logging.ERROR)
    try:
        for i in range(2 * reps + 2):
            for kind in (("style", "none") if i % 2 else ("none", "style")):
                t0 = time.perf_counter()
                synth.tts_many([SENTENCES[i % 5]], style_wav=wav if kind == "style" else None)
                lat[kind].append(time.perf_counter() - t0)
    finally:
        log.setLevel(level)
    ab = {k: statistics.median(v) * 1e3 for k, v in lat.items()}
    print(f"[conditioned] GST A/B at batch 1 (the same model, {len(lat['style'])} pairs "
          f"interleaved): p50 with the style {ab['style']:.1f} ms, without {ab['none']:.1f} ms: "
          f"{ab['style'] - ab['none']:+.1f} ms")
    out["ab_p50_ms"] = ab
    return out


def phase_conditioned(report):
    """(a) a phoneme Synthesizer (CMUDict pinned), (b) a GST Tacotron2 held
    and served with a style wav, (c) kernel 8 at E = 512 and a
    multi-speaker Tacotron(1) served; each path's counters set to 0 just
    before it and read just after."""
    from your_voice_tts_torch.infer.synthesizer import Synthesizer
    from your_voice_tts_torch.ops.griffin_lim import gl_iteration_cuda
    from your_voice_tts_torch.ops.taco1_decode import tacotron1_decode_cuda
    from your_voice_tts_torch.ops.taco2_decode import tacotron2_decode_cuda
    from your_voice_tts_torch.text import CMUDictBackend, phonemes

    out: dict = {}
    launches: dict = {}

    def add(seen):
        for k, v in seen.items():
            launches[k] = launches.get(k, 0) + v

    # (a) phonemes
    cfg = full_width_config()
    cfg = dataclasses.replace(cfg, data=dataclasses.replace(
        cfg.data, use_phonemes=True, g2p_backend="CMUDictBackend"))
    synth = Synthesizer(cfg, device="cuda")
    no_chance_stops(synth.model)
    from your_voice_tts_torch.infer.synthesis import g2p_backend

    g2p = g2p_backend(synth.cfg)
    digest, n_ids = ids_checksum(synth.cfg)
    check(isinstance(g2p, CMUDictBackend)
          and synth.model.embedding.num_embeddings == len(phonemes), "phoneme model")
    numbers = serve_counted("phonemes", synth)
    seen = numbers["launches"]
    print(f"[conditioned] phonemes: {n_ids} ids over the 8 sentences, sha256 {digest}; "
          f"CMUDict OOV rate {g2p.oov_rate:.3f} over {g2p.word_count} words")
    check(seen["tacotron2_decode_cuda"] > 0 and seen["griffin_lim_wave_cuda"] > 0
          and not seen["griffin_lim_full_cuda"] and not seen["gl_iteration_cuda"],
          "phoneme path kernels")
    out["phonemes"] = dict(numbers, ids_sha256=digest, n_ids=n_ids, oov_rate=g2p.oov_rate)
    add(seen)
    del synth

    # (b) GST Tacotron2: kernel 1 on style-shifted memory, then served
    wav = style_wav(cfg.audio.sample_rate)
    out["gst_kernel"], gst_err = hold_gst_decode(report, wav)
    synth = Synthesizer(gst_config(full_width_config()), device="cuda")
    no_chance_stops(synth.model)
    check(synth.model.decoder.decode_weights(synth.decode_dtype)["dims"]["E"] == 512,
          "GST width")
    numbers = serve_counted("gst", synth, style_wav=wav)
    seen = numbers["launches"]
    check(seen["tacotron2_decode_cuda"] > 0 and seen["griffin_lim_wave_cuda"] > 0,
          "GST path kernels")
    out["gst"] = numbers
    add(seen)
    out["gst_pieces"] = gst_breakdown(synth, wav, numbers["p50_batch1_ms"]
                                      - report["main"]["p50_batch1_ms"])
    del synth

    # (c) kernel 8 at E = 512, then a multi-speaker Tacotron(1) served
    out["taco1_kernel"], taco1_err = hold_taco1_e512(report)
    with tempfile.TemporaryDirectory() as tmp:
        ids = os.path.join(tmp, "ids.json")
        with open(ids, "w") as f:
            json.dump({f"SYN{i:02d}": i for i in range(4)}, f)
        synth = Synthesizer(taco1_config(), speakers_json=ids, device="cuda")
    no_chance_stops(synth.model)
    check(synth.model.decoder.decode_weights(synth.decode_dtype)["dims"]["E"] == 512,
          "multi-speaker Tacotron(1) width")
    speakers = [i % 4 for i in range(len(SENTENCES))]
    synth.tts_many(SENTENCES[:1], speakers[:1])         # one-time set-up, not measured
    import torch

    torch.cuda.synchronize()
    counters = (tacotron1_decode_cuda, tacotron2_decode_cuda) + gl_counters()
    for c in counters:
        c.launches = 0
    t0 = time.perf_counter()
    batch = synth.tts_many(SENTENCES, speakers)
    t_batch = time.perf_counter() - t0
    seen = {c.__name__: c.launches for c in counters}
    frames = TACO1_STEPS * TACO1_R * len(SENTENCES)
    check(all(w.ndim == 1 and len(w) > 0 and bool(torch.isfinite(torch.from_numpy(w)).all())
              for w in batch), "multi-speaker Tacotron(1) waveforms")
    check(seen["tacotron1_decode_cuda"] > 0 and seen["gl_iteration_cuda"] > 0
          and not seen["tacotron2_decode_cuda"], "multi-speaker Tacotron(1) kernels")
    decoded_s = frames * synth.ap.hop_length / synth.ap.sample_rate
    print(f"[conditioned] taco1 with speakers: batch of 8 over 4 speakers {t_batch * 1e3:.1f} ms, "
          f"{frames / t_batch:.0f} mel frames/s, real-time factor {decoded_s / t_batch:.1f}x "
          f"over the {decoded_s:.2f} s decoded; launches {seen}")
    out["taco1_speakers"] = dict(batch_ms=t_batch * 1e3, mel_frames_per_s=frames / t_batch,
                                 rtf_x_realtime=decoded_s / t_batch, launches=seen)
    add(seen)
    del synth
    out["launches"] = launches
    report["conditioned"] = out
    return launches, gst_err, taco1_err


# ------------------------------------------------- the HTTP server, kernel 1's stream

STREAM_TOL = (5e-3, 2e-3, 2e-3, 5e-3)   # frames, alignments, stops, stream tensors
STREAM_TEXT = ("The committee met again on Tuesday. The members could not agree on the cost. "
               "Along the river the old mills had fallen silent. Every morning the baker rose "
               "before dawn.")


def stream_tensors(stream) -> list:
    (h1, c1), (h2, c2), frame = stream
    return [h1, c1, h2, c2, frame]


def stream_errs(got, ref) -> list[float]:
    """Max abs errors of (frames, alignments, stops) and of the five stream
    tensors (h1, c1, h2, c2, frame), after checking lengths and shapes."""
    import torch

    check(torch.equal(got[3].cpu(), ref[3].cpu()), "stream decode lengths differ")
    check(all(a.shape == b.shape and a.dtype == b.dtype
              for a, b in zip(stream_tensors(got[4]), stream_tensors(ref[4]))),
          "stream shapes differ")
    return ([float((a - b).abs().max()) for a, b in zip(got[:3], ref[:3])]
            + [float((a - b).abs().max())
               for a, b in zip(stream_tensors(got[4]), stream_tensors(ref[4]))])


def hold_stream(tag: str, errs: list[float]) -> None:
    tol = STREAM_TOL[:3] + (STREAM_TOL[3],) * 5
    print(f"[server] {tag}: max_abs_err frames {errs[0]:.3e}, alignments {errs[1]:.3e}, stops "
          f"{errs[2]:.3e}; stream h1 {errs[3]:.3e}, c1 {errs[4]:.3e}, h2 {errs[5]:.3e}, c2 "
          f"{errs[6]:.3e}, frame {errs[7]:.3e} (tol {STREAM_TOL})")
    check(all(e <= t for e, t in zip(errs, tol)), f"stream decode disagrees with plain ({tag})")


def hold_stream_decode(report) -> dict:
    """(a) kernel 1's stream branch against its plain version at the decode
    phase's full-width inputs: B=8 and B=1, chunk 1 fresh and chunk 2 from
    chunk 1's stream; every row stopping at once (the freeze at the first
    chunk boundary); a batch past one launch with a stream (a slice re-run
    from a fresh copy of its rows); kernel ms with and without a stream."""
    import torch

    from your_voice_tts_torch.ops.taco2_decode import (batch_slices, tacotron2_decode_cuda,
                                                       tacotron2_decode_plain)

    out = {}
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    for B in (DECODE_B, 1):
        w, enc, pinp, mask, kw = decode_inputs(B)
        kw = dict(kw, return_stream=True)
        before = tacotron2_decode_cuda.launches
        got1 = tacotron2_decode_cuda(w, enc, pinp, mask, **kw)
        ref1 = tacotron2_decode_plain(w, enc, pinp, mask, **kw)
        got2 = tacotron2_decode_cuda(w, enc, pinp, mask, stream=got1[4], **kw)
        ref2 = tacotron2_decode_plain(w, enc, pinp, mask, stream=ref1[4], **kw)
        check(tacotron2_decode_cuda.launches - before == 2, "one launch a stream decode")
        stop_pattern = [1] + [DECODE_STEPS] * 7 if B == DECODE_B else [DECODE_STEPS]
        check(got1[3].tolist() == stop_pattern, "stream stop pattern")
        for tag, got, ref in (("chunk 1", got1, ref1), ("chunk 2", got2, ref2)):
            e = stream_errs(got, ref)
            hold_stream(f"B={B} {tag}", e)
            out[f"B{B}_{tag.replace(' ', '')}_errs"] = e
        check(not torch.allclose(got2[0], got1[0], atol=1e-2), "chunk 2 ignored its stream")
        bare = tacotron2_decode_cuda(w, enc, pinp, mask, **dict(kw, return_stream=False))
        check(all(torch.equal(a, b) for a, b in zip(bare, got1[:4])),
              "asking for the stream changed the outputs")
        plain_kw = dict(kw, return_stream=False)
        ms = cuda_ms(lambda: tacotron2_decode_cuda(w, enc, pinp, mask, **plain_kw), 5)
        stream_ms = cuda_ms(lambda: tacotron2_decode_cuda(w, enc, pinp, mask,
                                                          stream=got1[4], **kw), 5)
        dev_ms = decode_device_ms({"bare": lambda: tacotron2_decode_cuda(
                                       w, enc, pinp, mask, **plain_kw),
                                   "stream": lambda: tacotron2_decode_cuda(
                                       w, enc, pinp, mask, stream=got1[4], **kw)})
        shown = {tag: "not measured" if v is None else
                 f"{v[0]:.3f} ms, the wrapper's other kernels {v[1]:.3f} ms in {v[2]} launches"
                 for tag, v in dev_ms.items()}
        print(f"[server] B={B}: kernel_ms {ms:.2f} without a stream, {stream_ms:.2f} with one "
              f"in and out (CUDA events around the call); the decode kernel's device time "
              f"without a stream {shown['bare']}; with one {shown['stream']} (torch.profiler, "
              f"median of the calls it saw) ({report['nvidia_smi']})")
        out[f"B{B}_ms"], out[f"B{B}_stream_ms"], out[f"B{B}_device"] = ms, stream_ms, dev_ms

    # every row stops at its first step: the kernel leaves at the first chunk
    # boundary (step 50) and its stream is the state there
    w, enc, pinp, mask, kw = decode_inputs(DECODE_B, stop_all=True)
    kw = dict(kw, stream=decode_stream(w, DECODE_B), return_stream=True)
    got = tacotron2_decode_cuda(w, enc, pinp, mask, **kw)
    ref = tacotron2_decode_plain(w, enc, pinp, mask, **kw)
    check(got[3].tolist() == [1] * DECODE_B and not got[1][50:].any(), "every row stops at once")
    e = stream_errs(got, ref)
    hold_stream("B=8, every row stops: frozen at step 50", e)
    fifty = tacotron2_decode_cuda(w, enc, pinp, mask, **dict(kw, max_steps=50))
    check(all(torch.equal(a, b) for a, b in zip(stream_tensors(fifty[4]),
                                                stream_tensors(got[4]))),
          "the stream is not the state at the all-done boundary")
    out["freeze_errs"] = e

    # a batch past one launch: rows of the all-stop memory, then of the
    # decode phase's, 100 steps; the first slice leaves at step 50 and runs
    # again to 100 from a fresh copy of its rows of the stream
    _, enc8, pinp8, mask8, kw8 = decode_inputs(DECODE_B)
    rows = report["decode_one_launch_rows"] + 8
    slices = batch_slices(w["dims"], rows, mask.shape[1], sms)
    check(len(slices) == 2, f"sliced stream batch: {slices}")
    n0 = slices[0][1]
    tile = lambda t, n: t.repeat(-(-n // 8), *[1] * (t.dim() - 1))[:n]  # noqa: E731
    big = [torch.cat([tile(a, n0), tile(b, rows - n0)])
           for a, b in ((enc, enc8), (pinp, pinp8), (mask, mask8))]
    kw = dict(kw8, max_steps=100, stream=decode_stream(w, rows), return_stream=True)
    before = tacotron2_decode_cuda.launches
    got = tacotron2_decode_cuda(w, *big, **kw)
    launches = tacotron2_decode_cuda.launches - before
    ref = tacotron2_decode_plain(w, *big, **kw)
    check(launches == 3, f"sliced stream batch: {launches} launches, 3 expected")
    e = stream_errs(got, ref)
    hold_stream(f"B={rows} in slices {slices}, {launches} launches", e)
    out["sliced"] = dict(rows=rows, slices=slices, launches=launches, errs=e)
    return out


def decode_device_ms(calls: dict, reps: int = 3) -> dict:
    """{tag: (the decode kernel's device ms, the wrapper's other kernels'
    ms, their launches)} of each call under torch.profiler, the calls
    alternated `reps` times; the median over the profiles that saw the
    decode's one launch (the profiler can miss one), None if none did."""
    split = lambda name: "decode" if "decode_kernel" in name else "other"  # noqa: E731
    seen: dict = {tag: [] for tag in calls}
    for _ in range(reps):
        for tag, call in calls.items():
            t = kernel_times(call, split, ("decode", "other"))
            if t["decode"]["launches"] == 1:
                seen[tag].append((t["decode"]["ms_a_call"], t["other"]["ms_a_call"],
                                  t["other"]["launches"]))
    return {tag: (statistics.median(v[0] for v in got), statistics.median(v[1] for v in got),
                  got[0][2]) if got else None for tag, got in seen.items()}


def decode_stream(w, B: int, seed: int = 4):
    """A seeded stream state on the card at the decode's widths."""
    import torch

    d = w["dims"]
    g = torch.Generator().manual_seed(seed)
    h1, h2 = (torch.tanh(torch.randn(B, H, generator=g)).cuda() for H in (d["H1"], d["H2"]))
    c1, c2 = (torch.randn(B, H, generator=g).cuda() for H in (d["H1"], d["H2"]))
    return (h1, c1), (h2, c2), torch.randn(B, d["n_in"], generator=g).cuda()


def http_get(base: str, path: str, timeout: float = 300):
    """(status, content type, body, seconds) of one GET."""
    import urllib.error
    import urllib.request

    t0 = time.perf_counter()
    try:
        with urllib.request.urlopen(base + path, timeout=timeout) as r:
            return r.status, r.headers["Content-Type"], r.read(), time.perf_counter() - t0
    except urllib.error.HTTPError as e:
        return e.code, e.headers["Content-Type"], e.read(), time.perf_counter() - t0


def http_stream(base: str, path: str, timeout: float = 300):
    """A stream=1 request read off the socket: (status line and headers, the
    chunks of the chunked body, the seconds from the request's send at which
    each chunk was whole, and at which the body ended)."""
    import socket

    port = int(base.rsplit(":", 1)[1])
    with socket.create_connection(("127.0.0.1", port), timeout=timeout) as s:
        t0 = time.perf_counter()
        s.sendall(f"GET {path} HTTP/1.1\r\nHost: x\r\n\r\n".encode())
        buf, head, chunks, at = b"", None, [], []
        while True:
            got = s.recv(1 << 16)
            check(bool(got), "the stream closed before its last chunk")
            buf += got
            if head is None:
                if b"\r\n\r\n" not in buf:
                    continue
                head, _, buf = buf.partition(b"\r\n\r\n")
            while b"\r\n" in buf:
                size, _, rest = buf.partition(b"\r\n")
                n = int(size, 16)
                if len(rest) < n + 2:
                    break
                check(rest[n:n + 2] == b"\r\n", "chunk framing")
                buf = rest[n + 2:]
                if n == 0:
                    return head.decode(), chunks, at, time.perf_counter() - t0
                chunks.append(rest[:n])
                at.append(time.perf_counter() - t0)


def phase_server(report) -> dict:
    """(a) `hold_stream_decode`; (b) make_server on 127.0.0.1 with the main
    path's full-width Synthesizer (Griffin-Lim): two bursts of 8 concurrent
    /api/tts requests (200, RIFF, coalesced; the first is the collator
    thread's first device work), 5 sequential ones (p50), two stream=1
    requests of four sentences (framing, header, one chunk a piece, the time
    to the first audio chunk), and one stream=1 request with a speaker on a
    d-vector Synthesizer (E = 768), one with an unknown speaker (500); the
    launch counters set to 0 just before the server runs and read just
    after."""
    import urllib.parse

    import numpy as np
    import torch

    from your_voice_tts_torch.infer.server import _wav_stream_header, make_server
    from your_voice_tts_torch.infer.synthesizer import Synthesizer, stream_pieces
    from your_voice_tts_torch.ops.taco2_decode import tacotron2_decode_cuda
    from your_voice_tts_torch.utils.speakers import save_speaker_mapping

    smi = report["nvidia_smi"]
    out = {"kernel": hold_stream_decode(report)}
    cfg = full_width_config()
    synth = Synthesizer(cfg, device="cuda")
    no_chance_stops(synth.model)
    with tempfile.TemporaryDirectory() as tmp:
        g = torch.Generator().manual_seed(6)
        vecs = torch.nn.functional.normalize(torch.randn(4, 256, generator=g), dim=-1)
        spk_json = os.path.join(tmp, "speakers.json")
        save_speaker_mapping(spk_json, {f"SPK{i}": v.tolist() for i, v in enumerate(vecs)})
        spk = Synthesizer(cfg, speakers_json=spk_json, device="cuda")
    no_chance_stops(spk.model)
    check(spk.model.decoder.decode_weights(spk.decode_dtype)["dims"]["E"] == 768,
          "the speaker synthesizer's width")
    for s in (synth, spk):                          # one-time set-up, not measured
        s.tts_many(SENTENCES[:1], None if s is synth else ["SPK0"])
        list(s.tts_streaming("Set up.", speaker=None if s is synth else "SPK0"))
    torch.cuda.synchronize()
    servers = [make_server(s, host="127.0.0.1", port=0) for s in (synth, spk)]
    threads = [threading.Thread(target=srv.serve_forever, daemon=True) for srv in servers]
    for t in threads:
        t.start()
    base, spk_base = (f"http://127.0.0.1:{srv.server_address[1]}" for srv in servers)
    def q(text, **kw):
        return "/api/tts?" + urllib.parse.urlencode(dict(text=text, **kw))

    counters = (tacotron2_decode_cuda,) + gl_counters()

    def burst():
        """8 concurrent /api/tts requests: (wall seconds, batch sizes)."""
        results = [None] * len(SENTENCES)

        def fetch(k):
            results[k] = http_get(base, q(SENTENCES[k]))

        workers = [threading.Thread(target=fetch, args=(k,)) for k in range(len(SENTENCES))]
        seen = len(servers[0].batcher.batch_sizes)
        t0 = time.perf_counter()
        for t in workers:
            t.start()
        for t in workers:
            t.join(300)
        wall = time.perf_counter() - t0
        sizes = servers[0].batcher.batch_sizes[seen:]
        check(all(r is not None and r[0] == 200 and r[1] == "audio/wav" and r[2][:4] == b"RIFF"
                  and r[2][8:12] == b"WAVE" for r in results), "concurrent /api/tts requests")
        check(max(sizes) > 1, f"concurrent requests did not coalesce: batches {sizes}")
        return wall, sizes

    try:
        for c in counters:
            c.launches = 0
        # twice: the first burst is the collator thread's first device work
        bursts = [burst(), burst()]
        lat = []
        for s in SENTENCES[:5]:
            status, ctype, body, sec = http_get(base, q(s))
            check(status == 200 and body[:4] == b"RIFF", "sequential /api/tts request")
            lat.append(sec)
        # twice: each request runs on a new handler thread
        streams = [http_stream(base, q(STREAM_TEXT, stream=1)) for _ in range(2)]
        head, chunks, at, end = streams[0]
        pieces = stream_pieces(STREAM_TEXT)
        check(head.startswith("HTTP/1.1 200") and "Transfer-Encoding: chunked" in head
              and "Content-Length" not in head, "stream=1 headers")
        check(chunks[0] == _wav_stream_header(synth.ap.sample_rate), "streamed WAV header")
        check(len(pieces) == 4 and len(chunks) == 1 + len(pieces)
              and all(len(c) > 0 for c in chunks[1:]), f"{len(chunks) - 1} chunks for 4 pieces")
        pcm = np.frombuffer(b"".join(chunks[1:]), "<i2")
        check(np.abs(pcm).max() > 0, "streamed audio is silent")
        check([len(c) for c in streams[1][1]] == [len(c) for c in chunks], "a second stream")
        spk_head, spk_chunks, spk_at, spk_end = http_stream(
            spk_base, q(STREAM_TEXT, stream=1, speaker_id="SPK2"))
        check(spk_head.startswith("HTTP/1.1 200") and len(spk_chunks) == 1 + len(pieces),
              "stream=1 with a speaker")
        status, _, body, _ = http_get(spk_base, q("Hi.", stream=1, speaker_id="NOBODY"))
        check(status == 500 and b"unknown speaker" in body, "an unknown speaker's stream")
        torch.cuda.synchronize()
        launches = {c.__name__: c.launches for c in counters}
    finally:
        for srv in servers:
            srv.shutdown()
            srv.batcher.close()
            srv.server_close()
    check(launches["tacotron2_decode_cuda"] > 0 and launches["griffin_lim_wave_cuda"] > 0,
          f"the server's kernels: {launches}")
    p50 = statistics.median(lat)
    audio_s = len(pcm) / synth.ap.sample_rate
    for i, (wall, sizes) in enumerate(bursts):
        print(f"[server] 8 concurrent /api/tts requests, burst {i + 1}: {wall * 1e3:.1f} ms "
              f"wall, batches {sizes} ({smi})")
    print(f"[server] sequential /api/tts p50 {p50 * 1e3:.1f} ms (all: "
          f"{', '.join(f'{x * 1e3:.1f}' for x in lat)} ms) ({smi})")
    for i, (_, _, at_i, end_i) in enumerate(streams):
        print(f"[server] stream=1 request {i + 1}, {len(pieces)} pieces, {audio_s:.2f} s of "
              f"audio: first audio chunk at {at_i[1] * 1e3:.1f} ms, whole request "
              f"{end_i * 1e3:.1f} ms (chunks at {', '.join(f'{x * 1e3:.1f}' for x in at_i)} "
              f"ms) ({smi})")
    print(f"[server] stream=1 with speaker SPK2 (d-vectors, E=768): first audio chunk at "
          f"{spk_at[1] * 1e3:.1f} ms, whole request {spk_end * 1e3:.1f} ms ({smi})")
    print(f"[server] launches while serving: {launches}")
    out.update(burst_ms=[b[0] * 1e3 for b in bursts], batch_sizes=[b[1] for b in bursts],
               p50_ms=p50 * 1e3, seq_ms=[x * 1e3 for x in lat],
               ttfa_ms=[st[2][1] * 1e3 for st in streams],
               stream_ms=[st[3] * 1e3 for st in streams],
               chunk_ms=[x * 1e3 for x in at], spk_ttfa_ms=spk_at[1] * 1e3,
               spk_stream_ms=spk_end * 1e3, launches=launches, nvidia_smi=smi)
    report["server"] = out
    return launches


# -------------------------------------------- the serving export (torch.export)

EXPORT_T = 160           # the text bucket: the 8 sentences' ids, 147-156, fit


@contextlib.contextmanager
def plain_calls():
    """Count the calls of every plain version a serving op could fall to
    (the decodes', the three Griffin-Lim routes'): yields the dict of counts,
    and puts the functions back after."""
    from your_voice_tts_torch.ops import griffin_lim, taco1_decode, taco2_decode

    seen: dict = {}
    saved = []
    for mod, name in ((taco2_decode, "tacotron2_decode_plain"),
                      (taco1_decode, "tacotron1_decode_plain"),
                      (griffin_lim, "griffin_lim_wave_plain"),
                      (griffin_lim, "griffin_lim_full_plain"),
                      (griffin_lim, "gl_iteration_plain")):
        fn = getattr(mod, name)
        seen[name] = 0

        def counted(*a, _fn=fn, _name=name, **k):
            seen[_name] += 1
            return _fn(*a, **k)
        saved.append((mod, name, fn))
        setattr(mod, name, counted)
    try:
        yield seen
    finally:
        for mod, name, fn in saved:
            setattr(mod, name, fn)


def serve_counters():
    """The decodes' and the three Griffin-Lim routes' kernel wrappers."""
    from your_voice_tts_torch.ops.taco1_decode import tacotron1_decode_cuda
    from your_voice_tts_torch.ops.taco2_decode import tacotron2_decode_cuda

    return (tacotron2_decode_cuda, tacotron1_decode_cuda) + gl_counters()


def text_batch(exp, texts, T: int = EXPORT_T):
    """The artifact's own frontend over `texts`, zero-padded to [B, T]."""
    import numpy as np

    seqs = [exp.text_to_ids(t) for t in texts]
    text = np.zeros((len(texts), T), np.int64)
    for i, s in enumerate(seqs):
        text[i, :len(s)] = s
    return text, np.asarray([len(s) for s in seqs], np.int64)


def hold_artifact(tag: str, exp, program, text, lens, *cond, seed: int = 3,
                  kernels: dict) -> dict:
    """One call of the loaded artifact with the launch counters set to 0
    just before and read just after, and no plain version called, against
    the unexported program on the same inputs: lengths exact, wav max abs
    <= 1e-5. `kernels`: counter name -> True (must launch) / False (must
    not)."""
    import numpy as np
    import torch

    counters = serve_counters()
    torch.cuda.synchronize()
    for c in counters:
        c.launches = 0
    with plain_calls() as plain:
        kw = {}
        if cond:
            key = "speaker_ids" if cond[0].dtype == np.int64 else "d_vectors"
            kw[key] = cond[0]
            if len(cond) > 1:
                kw["style_mel"] = cond[1]
        wav, ml = exp(text, lens, seed=seed, **kw)
        torch.cuda.synchronize()
        launches = {c.__name__: c.launches for c in counters}
    with torch.no_grad():
        ref_wav, ref_ml = program(*(torch.from_numpy(a).cuda() for a in (text, lens) + cond),
                                  torch.tensor([seed], device="cuda"))
    err = float(np.abs(wav - ref_wav.cpu().numpy()).max())
    print(f"[export] {tag}: artifact against its unexported program: wav {tuple(wav.shape)} "
          f"max abs {err:.3e} (tol 1e-5), mel_lengths {ml.tolist()}; launches {launches}; "
          f"plain calls {sum(plain.values())}")
    check(np.array_equal(ml, ref_ml.cpu().numpy()), f"{tag}: artifact mel lengths")
    check(err <= 1e-5 and bool(np.isfinite(wav).all()) and float(np.abs(wav).max()) > 0,
          f"{tag}: artifact wav against its unexported program")
    check(not any(plain.values()), f"{tag}: a plain version ran: {plain}")
    for name, must in kernels.items():
        check((launches[name] > 0) == must, f"{tag}: {name} launches {launches[name]}")
    return dict(wav_err=err, mel_lengths=ml.tolist(), launches=launches)


def phase_export(report) -> dict:
    """The serving export on the card: torch.export artifacts of the
    serving program, loaded without the model code, carrying the
    hand-written kernels as registered ops (`ops/library.py`). Each
    artifact is held against its unexported program (make_serving_fn) on
    the same inputs, with the launch counters set to 0 just before the
    artifact's call and read just after, and no plain version called:
    (1) full-width Tacotron2 + Griffin-Lim at (B=8, T=160) and (B=1,
    T=160): kernels 1 and 2; the export's seconds, the artifact's program
    at B=8 and B=1, the unexported program at B=8, the artifact's and the
    live Synthesizer's tts_many of the 8 sentences (CUDA events, median of
    5); (2) the cloning artifact with 256-wide d-vectors (E = 768) over 4
    speakers, and the smoke speaker encoder's artifact against the live
    encoder (1e-5); (3) the smoke MelGAN artifact (no Griffin-Lim kernel);
    (4) Tacotron(1) at r = 7, 250 steps: kernels 8 and 4; (5) the smoke
    config's artifact: kernel 3; (6) bin/server.py --export_dir on the
    full-width artifacts in its own process: a burst of 8 concurrent
    /api/tts requests, WAV bytes, stream=1 answering 400. Returns the
    launches of the artifacts' calls, which join the kernel line."""
    import socket
    import threading

    import numpy as np
    import torch

    from your_voice_tts_torch.infer.export import (ExportedSpeakerEncoder, ExportedSynthesizer,
                                                   export_serving, export_speaker_encoder,
                                                   make_serving_fn)
    from your_voice_tts_torch.infer.synthesizer import Synthesizer
    from your_voice_tts_torch.speaker_encoder.model import load_encoder
    from your_voice_tts_torch.utils.speakers import save_speaker_mapping

    smi = report["nvidia_smi"]
    out: dict = {}
    launches: dict = {}

    def add(held):
        for k, n in held["launches"].items():
            launches[k] = launches.get(k, 0) + n

    tmp = tempfile.mkdtemp(prefix="yvt_export_")
    try:
        # (1) full-width Tacotron2 + Griffin-Lim
        cfg = full_width_config()
        synth = Synthesizer(cfg, device="cuda")
        no_chance_stops(synth.model)
        d1 = os.path.join(tmp, "taco2")
        t0 = time.perf_counter()
        manifest = export_serving(synth.model, synth.cfg, synth.ap, d1, batch_sizes=(8, 1),
                                  text_buckets=(EXPORT_T,))
        export_s = time.perf_counter() - t0
        sizes = {e["file"]: os.path.getsize(os.path.join(d1, e["file"]))
                 for e in manifest["entries"]}
        t0 = time.perf_counter()
        exp = ExportedSynthesizer(d1)
        load_s = time.perf_counter() - t0
        check(manifest["platforms"] == ["cuda"] and exp.device.type == "cuda",
              "a cuda artifact")
        program = make_serving_fn(synth.model, synth.cfg, synth.ap)
        text, lens = text_batch(exp, SENTENCES)
        exp(text[:1], lens[:1])                            # one-time set-up, not measured
        held8 = hold_artifact("taco2 B=8", exp, program, text, lens, kernels={
            "tacotron2_decode_cuda": True, "griffin_lim_wave_cuda": True,
            "griffin_lim_full_cuda": False, "gl_iteration_cuda": False})
        held1 = hold_artifact("taco2 B=1", exp, program, text[1:2], lens[1:2], kernels={
            "tacotron2_decode_cuda": True, "griffin_lim_wave_cuda": True})
        check(held8["mel_lengths"] == [SERVE_FRAMES] * 8, "taco2 artifact mel lengths")
        add(held8)
        add(held1)
        args = lambda B: [torch.from_numpy(a).cuda() for a in (text[:B], lens[:B])] + [  # noqa
            torch.tensor([3], device="cuda")]
        a8, a1 = args(8), args(1)
        with torch.no_grad():
            times = {
                "artifact_b8_ms": cuda_ms(lambda: exp._fns[(8, EXPORT_T)](*a8), 3),
                "artifact_b1_ms": cuda_ms(lambda: exp._fns[(1, EXPORT_T)](*a1), 3),
                "unexported_b8_ms": cuda_ms(lambda: program(*a8), 3),
                "artifact_tts_many_b8_ms": cuda_ms(lambda: exp.tts_many(SENTENCES), 3),
                "live_tts_many_b8_ms": cuda_ms(lambda: synth.tts_many(SENTENCES), 3),
            }
        print(f"[export] full width: export of (8, {EXPORT_T}) and (1, {EXPORT_T}) "
              f"{export_s:.2f} s, load {load_s:.2f} s, files "
              f"{', '.join(f'{k} {v / 2 ** 20:.1f} MiB' for k, v in sizes.items())}")
        print(f"[export] full width, CUDA events, median of 3: artifact program B=8 "
              f"{times['artifact_b8_ms']:.2f} ms, B=1 {times['artifact_b1_ms']:.2f} ms; "
              f"unexported program B=8 {times['unexported_b8_ms']:.2f} ms; tts_many of the 8 "
              f"sentences: artifact {times['artifact_tts_many_b8_ms']:.2f} ms, live "
              f"Synthesizer {times['live_tts_many_b8_ms']:.2f} ms ({smi})")
        out["taco2"] = dict(export_s=export_s, load_s=load_s, file_bytes=sizes, b8=held8,
                            b1=held1, **times)
        del program, synth

        # (2) cloning: 256-wide d-vectors (E = 768); the smoke speaker encoder
        g = torch.Generator().manual_seed(6)
        vecs = torch.nn.functional.normalize(torch.randn(4, 256, generator=g), dim=-1)
        spk_json = os.path.join(tmp, "speakers.json")
        save_speaker_mapping(spk_json, {f"SPK{i}": v.tolist() for i, v in enumerate(vecs)})
        spk = Synthesizer(cfg, speakers_json=spk_json, device="cuda")
        no_chance_stops(spk.model)
        d2 = os.path.join(tmp, "cloning")
        export_serving(spk.model, spk.cfg, spk.ap, d2, batch_sizes=(8,),
                       text_buckets=(EXPORT_T,), speaker_mode="dvector", d_dim=256,
                       speakers=spk.speaker_embeddings)
        cexp = ExportedSynthesizer(d2)
        check(spk.model.decoder.decode_weights(spk.decode_dtype)["dims"]["E"] == 768,
              "the cloning model's width")
        dv = np.stack([np.asarray(cexp._resolve_speaker(f"SPK{i % 4}")) for i in range(8)])
        cprog = make_serving_fn(spk.model, spk.cfg, spk.ap, speaker_mode="dvector")
        held = hold_artifact("cloning E=768 B=8", cexp, cprog, text, lens, dv, kernels={
            "tacotron2_decode_cuda": True, "griffin_lim_wave_cuda": True})
        add(held)
        many = cexp.tts_many(SENTENCES, [f"SPK{i % 4}" for i in range(8)])
        check(len(many) == 8 and all(len(w) > 0 and np.isfinite(w).all() for w in many),
              "cloning artifact tts_many")
        del cprog, spk
        enc = load_encoder(os.path.join(ROOT, "assets/speaker_encoder_smoke.npz"),
                           device="cuda")
        d_se = os.path.join(tmp, "encoder")
        export_speaker_encoder(enc, d_se, input_dim=enc.layers[0].lstm.input_size,
                               batch_sizes=(4,), num_frames=160)
        sexp = ExportedSpeakerEncoder(d_se)
        rng = np.random.default_rng(3)
        se_err = 0.0
        for T in (90, 500):                 # the tile path; 5 windows in chunks of 4
            mel = rng.standard_normal((T, enc.layers[0].lstm.input_size)).astype(np.float32)
            live = enc.compute_embedding(mel, num_frames=160).cpu().numpy()
            se_err = max(se_err, float(np.abs(sexp.embed(mel) - live).max()))
        print(f"[export] smoke speaker encoder artifact against compute_embedding: max abs "
              f"{se_err:.3e} (tol 1e-5)")
        check(se_err <= 1e-5, "speaker encoder artifact")
        out["cloning"] = dict(held, encoder_err=se_err)

        # (3) the smoke MelGAN artifact; (5) the smoke config's Griffin-Lim artifact
        scfg = os.path.join(ROOT, "configs/smoke_synthetic.json")
        sckpt = os.path.join(ROOT, "assets/bench_trained_smoke.npz")
        for tag, voc in (("melgan", os.path.join(ROOT, "configs/melgan_smoke.json")),
                         ("smoke", None)):
            ssynth = Synthesizer(scfg, sckpt, vocoder_config=voc, vocoder_checkpoint=(
                os.path.join(ROOT, "assets/bench_trained_melgan.npz") if voc else None),
                device="cuda")
            dd = os.path.join(tmp, tag)
            export_serving(ssynth.model, ssynth.cfg, ssynth.ap, dd, batch_sizes=(8,),
                           text_buckets=(EXPORT_T,), vocoder=ssynth.vocoder)
            sexp2 = ExportedSynthesizer(dd)
            stext, slens = text_batch(sexp2, SENTENCES)
            held = hold_artifact(tag, sexp2, make_serving_fn(
                ssynth.model, ssynth.cfg, ssynth.ap, vocoder=ssynth.vocoder), stext, slens,
                kernels={"tacotron2_decode_cuda": True,
                         "griffin_lim_full_cuda": voc is None,
                         "griffin_lim_wave_cuda": False, "gl_iteration_cuda": False})
            add(held)
            out[tag] = held

        # (4) Tacotron(1) at r = 7: kernels 8 and 4
        tsynth = Synthesizer(taco1_config(), device="cuda")
        no_chance_stops(tsynth.model)
        d4 = os.path.join(tmp, "taco1")
        t0 = time.perf_counter()
        export_serving(tsynth.model, tsynth.cfg, tsynth.ap, d4, batch_sizes=(8,),
                       text_buckets=(EXPORT_T,))
        t1_export_s = time.perf_counter() - t0
        texp = ExportedSynthesizer(d4)
        tprog = make_serving_fn(tsynth.model, tsynth.cfg, tsynth.ap)
        text, lens = text_batch(texp, SENTENCES)
        held = hold_artifact("taco1 r=7 B=8", texp, tprog, text, lens, kernels={
            "tacotron1_decode_cuda": True, "gl_iteration_cuda": True,
            "tacotron2_decode_cuda": False, "griffin_lim_wave_cuda": False})
        add(held)
        with torch.no_grad():
            t8 = [torch.from_numpy(a).cuda() for a in (text, lens)] + [
                torch.tensor([3], device="cuda")]
            t1_ms = cuda_ms(lambda: texp._fns[(8, EXPORT_T)](*t8), 3)
        print(f"[export] Tacotron(1) r=7: export {t1_export_s:.2f} s, artifact program B=8 "
              f"{t1_ms:.2f} ms ({smi})")
        out["taco1"] = dict(held, export_s=t1_export_s, artifact_b8_ms=t1_ms)
        del tprog, tsynth

        # (6) bin/server.py --export_dir on the full-width artifacts
        with socket.socket() as s:
            s.bind(("127.0.0.1", 0))
            port = s.getsockname()[1]
        log = open(os.path.join(tmp, "server.log"), "w+")
        proc = subprocess.Popen(
            [sys.executable, "-m", "your_voice_tts_torch.bin.server", "--export_dir", d1,
             "--host", "127.0.0.1", "--port", str(port)], cwd=ROOT, stdout=log,
            stderr=subprocess.STDOUT, env=dict(os.environ, PYTHONPATH=ROOT))
        base = f"http://127.0.0.1:{port}"
        try:
            t0 = time.perf_counter()
            while True:
                check(proc.poll() is None, "the --export_dir server exited")
                check(time.perf_counter() - t0 < 300, "the --export_dir server did not start")
                try:
                    if http_get(base, "/", timeout=5)[0] == 200:
                        break
                except OSError:
                    time.sleep(0.2)
            up_s = time.perf_counter() - t0
            import urllib.parse
            results: list = [None] * len(SENTENCES)

            def fetch(k):
                results[k] = http_get(base, "/api/tts?" + urllib.parse.urlencode(
                    {"text": SENTENCES[k]}))

            for rnd in range(2):       # the first burst is the collator's first device work
                workers = [threading.Thread(target=fetch, args=(k,))
                           for k in range(len(SENTENCES))]
                t0 = time.perf_counter()
                for w in workers:
                    w.start()
                for w in workers:
                    w.join(300)
                burst_ms = (time.perf_counter() - t0) * 1e3
                check(all(r is not None and r[0] == 200 and r[1] == "audio/wav"
                          and r[2][:4] == b"RIFF" and r[2][8:12] == b"WAVE" and len(r[2]) > 44
                          for r in results), "the --export_dir server's burst")
                print(f"[export] bin/server.py --export_dir: burst {rnd + 1} of 8 concurrent "
                      f"/api/tts requests {burst_ms:.1f} ms wall ({smi})")
            status, _, body, _ = http_get(base, "/api/tts?text=Hi.&stream=1")
            check(status == 400 and b"cannot stream" in body, "stream=1 from an artifact")
            out["server"] = dict(up_s=up_s, burst_ms=burst_ms)
            print(f"[export] the server came up in {up_s:.1f} s; stream=1 answered {status}")
        finally:
            proc.terminate()
            try:
                proc.wait(30)
            except subprocess.TimeoutExpired:
                proc.kill()
                proc.wait(30)
            log.seek(0)
            tail = log.read()[-2000:]
            log.close()
        check(proc.returncode is not None, "the --export_dir server did not stop")
        out["server"]["log_tail"] = tail
    finally:
        import shutil

        shutil.rmtree(tmp, ignore_errors=True)
    print(f"[export] launches from the artifacts' calls: {launches}")
    out["launches"] = launches
    report["export"] = out
    return launches


# ------------------------------------------------ kernel 1's attention variants

# the variants held, each with its switches (VARIANTS) flipped in
# configs/ljspeech_tacotron2.json
SMOKE_VARIANTS = ("windowing", "forward", "forward_ta_mask", "window_forward",
                  "softmax_window", "graves")
DECODE_TOL = (5e-3, 2e-3, 2e-3)          # the decode phase's: frames, alignments, stops


def variant_config(variant: str):
    """full_width_config with an attention variant's switches flipped."""
    from your_voice_tts_torch.models.attention import VARIANTS

    cfg = full_width_config()
    return dataclasses.replace(cfg, model=dataclasses.replace(cfg.model,
                                                              **VARIANTS[variant]))


def hold_variants(report) -> tuple[list[float], dict]:
    """Kernel 1 against its plain version for each attention variant at the
    decode phase's inputs (full width, B=8 and B=1, 250 steps, dropout on):
    errors over the steps `held_steps` holds, a forward mask's fork a tie,
    launches a decode, kernel ms beside the location route's on the decode
    phase's inputs, the bound.
    Returns (every held error, the numbers)."""
    import torch

    from your_voice_tts_torch.ops.taco2_decode import (ATTN_OPTIONS, attention_route,
                                                       first_fork, held_steps, launch_plan,
                                                       tacotron2_decode_cuda,
                                                       tacotron2_decode_plain,
                                                       tacotron2_decode_profile_cuda)

    smi, steps = report["nvidia_smi"], DECODE_STEPS
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    def show_rounds(tag, rounds):
        print(f"[attention-variants] {tag} rounds, us a step (work mean / largest block, "
              f"barrier wait mean): " + "; ".join(
                  f"{k.split()[0]} {v['work_mean_us']:.2f} / {v['work_max_us']:.2f}, "
                  f"{v['wait_mean_us']:.2f}" for k, v in rounds.items()))

    loc_ms = {}
    for B in (DECODE_B, 1):
        w, enc, pinp, mask, kw = decode_inputs(B)
        loc_ms[B] = cuda_ms(lambda: tacotron2_decode_cuda(w, enc, pinp, mask, **kw), 5)
        show_rounds(f"location route B={B}",
                    tacotron2_decode_profile_cuda(w, enc, pinp, mask, **kw)["rounds"])
    errs, out = [], {}
    for variant in SMOKE_VARIANTS:
        for B in (DECODE_B, 1):
            w, enc, pinp, mask, kw = decode_inputs(B, variant=variant)
            attn = {k: v for k, v in kw.items() if k in ATTN_OPTIONS}
            route = attention_route(w, **attn)
            plan = launch_plan(w["dims"], B, mask.shape[1], sms, route)
            before = tacotron2_decode_cuda.launches
            got = tacotron2_decode_cuda(w, enc, pinp, mask, **kw)
            per_decode = tacotron2_decode_cuda.launches - before
            premask = []
            ref = tacotron2_decode_plain(w, enc, pinp, mask, premask=premask, **kw)
            torch.cuda.synchronize()
            # held_steps: every step of a variant that takes no maximum; up
            # to a window's fork and over it; before a forward mask's fork,
            # which must be a tie of the plain version's alignment
            n, fork, gap = held_steps(got, ref, premask, **attn)
            tag = f"{variant} B={B}"
            e = [float((a[:n] - b[:n]).abs().max()) for a, b in zip(got[:3], ref[:3])]
            spread = None
            if fork is not None:
                # the plain version's own fork under a 1e-6 relative nudge of
                # the memory, for scale
                g = torch.Generator().manual_seed(11)
                nudge = 1 + 1e-6 * torch.randn(enc.shape, generator=g).to(enc.device)
                spread = first_fork(
                    tacotron2_decode_plain(w, enc * nudge, pinp, mask, **kw)[1], ref[1])
            print(f"[attention-variants] {tag}: route {route}, shared memory "
                  f"{plan['smem_bytes']} B, WB_ROUNDS {plan['WB_ROUNDS']}, launches a decode "
                  f"{per_decode}; lengths kernel {got[3].tolist()} plain {ref[3].tolist()}; "
                  + ("no fork" if fork is None else
                     f"first fork at step {fork}: held over steps 0-{n - 1}"
                     + ("" if gap is None else f", the plain version's pre-mask tie gap "
                        f"there {gap:.3e}")
                     + f" (the plain version under a 1e-6 nudge of the memory forks at "
                     f"step {spread})")
                  + f"; max_abs_err frames {e[0]:.3e}, alignments {e[1]:.3e}, stops "
                  f"{e[2]:.3e} (tol {DECODE_TOL})")
            check(n > 0, f"{tag}: forked at step 0")
            check(all(x <= t for x, t in zip(e, DECODE_TOL)), f"{tag}: kernel disagrees")
            check(gap is None or gap <= DECODE_TOL[1],
                  f"{tag}: the forward mask forked at step {fork} on no tie (gap {gap})")
            check(per_decode == 1, f"{tag}: one launch a decode")
            if fork is None:
                check(torch.equal(got[3].cpu(), ref[3].cpu()), f"{tag}: lengths differ")
            if B == DECODE_B:
                check(int(got[3][0]) == 1, f"{tag}: row 0 stops at once")
            errs += e
            ms = cuda_ms(lambda: tacotron2_decode_cuda(w, enc, pinp, mask, **kw), 5)
            bound_ms, bound_by, wmb, _ = decode_bound(w, enc, pinp, mask, steps,
                                                      options=route == 1)
            print(f"[attention-variants] {tag}: kernel_ms {ms:.2f} beside the location "
                  f"route's {loc_ms[B]:.2f} on the decode phase's inputs; bound_ms "
                  f"{bound_ms:.3f} ({bound_by}; {wmb:.1f} MB bf16 weights) ({smi})")
            rounds = tacotron2_decode_profile_cuda(w, enc, pinp, mask, **kw)["rounds"]
            show_rounds(tag, rounds)
            out[tag] = dict(route=route, fork=fork, held_steps=n, tie_gap=gap,
                            nudged_fork=spread, errs=e, ms=ms,
                            location_ms=loc_ms[B],
                            rounds_us_per_step=rounds,
                            bound_ms=bound_ms, bound_by=bound_by, weight_mb=wmb,
                            launches_per_decode=per_decode, smem_bytes=plan["smem_bytes"],
                            lengths=got[3].tolist())
    return errs, out


def phase_attention_variants(report) -> tuple[dict, float]:
    """(a) `hold_variants`; (b) Synthesizer.tts_many on the main path's 8
    sentences and 5 batch-1 requests for a Graves model and a
    forward_ta_mask model (seeded random weights, Griffin-Lim), and one
    four-piece tts_streaming of the forward_ta_mask model, the launch
    counters set to 0 just before each and read just after. Returns (the
    launches, the largest held error)."""
    import numpy as np
    import torch

    from your_voice_tts_torch.infer.synthesizer import Synthesizer, stream_pieces
    from your_voice_tts_torch.ops.taco2_decode import tacotron2_decode_cuda

    errs, holds = hold_variants(report)
    launches = {"tacotron2_decode_cuda": 0, "griffin_lim_wave_cuda": 0}
    serving = {}
    for variant in ("graves", "forward_ta_mask"):
        synth = Synthesizer(variant_config(variant), device="cuda")
        no_chance_stops(synth.model)
        numbers = serve_counted(f"attention-variants {variant}", synth)
        seen = numbers["launches"]
        check(seen["tacotron2_decode_cuda"] > 0 and seen["griffin_lim_wave_cuda"] > 0,
              f"{variant} path: {seen}")
        serving[variant] = numbers
        for k in launches:
            launches[k] += seen[k]
    pieces = stream_pieces(STREAM_TEXT)
    list(synth.tts_streaming("Set up."))               # one-time set-up, not measured
    torch.cuda.synchronize()
    counters = (tacotron2_decode_cuda,) + gl_counters()
    for c in counters:
        c.launches = 0
    t0 = time.perf_counter()
    at, chunks = [], []
    for wav in synth.tts_streaming(STREAM_TEXT):
        chunks.append(wav)
        at.append(time.perf_counter() - t0)
    seen = {c.__name__: c.launches for c in counters}
    check(len(pieces) == 4 and len(chunks) == 4
          and all(c.ndim == 1 and len(c) > 0 and bool(np.isfinite(c).all()) for c in chunks),
          f"forward_ta_mask stream: {len(chunks)} chunks for {len(pieces)} pieces")
    check(seen["tacotron2_decode_cuda"] == 4 and seen["griffin_lim_wave_cuda"] > 0,
          f"forward_ta_mask stream launches: {seen}")
    for k in launches:
        launches[k] += seen[k]
    print(f"[attention-variants] forward_ta_mask tts_streaming, 4 pieces: chunks at "
          f"{', '.join(f'{x * 1e3:.1f}' for x in at)} ms; launches {seen} "
          f"({report['nvidia_smi']})")
    print(f"[attention-variants] launches on the variants' paths: {launches}")
    report["attention_variants"] = dict(holds=holds, serving=serving,
                                        stream_chunk_ms=[x * 1e3 for x in at],
                                        launches=launches)
    return launches, max(errs)


def dev(e) -> float:
    """A profiler row's own device time, ms."""
    return getattr(e, "self_device_time_total", 0.0) / 1e3


def device_busy(trace_path: str) -> tuple[float, float, int]:
    """A torch.profiler chrome trace's kernels: the ms the device ran at
    least one (the union of their intervals), their summed ms, their count."""
    with open(trace_path) as f:
        events = json.load(f)["traceEvents"]
    spans = sorted((e["ts"], e["ts"] + e["dur"]) for e in events if e.get("cat") == "kernel")
    busy, lo, hi = 0.0, None, None
    for a, b in spans:
        if hi is None or a > hi:
            busy += 0.0 if hi is None else hi - lo
            lo, hi = a, b
        else:
            hi = max(hi, b)
    busy += 0.0 if hi is None else hi - lo
    return busy / 1e3, sum(b - a for a, b in spans) / 1e3, len(spans)


def device_rows(prof):
    """The profile's kernel rows (device events), longest first. The rows
    of CPU operators also carry the device time of the kernels launched
    under them, so summing every row would count those kernels twice."""
    from torch.autograd import DeviceType

    return sorted((e for e in prof.key_averages()
                   if e.device_type == DeviceType.CUDA and dev(e) > 0), key=dev, reverse=True)


def phase_profile(report, out_dir: str):
    """One batch-of-8 tts_many call under torch.profiler."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from your_voice_tts_torch.infer.synthesizer import Synthesizer

    synth = Synthesizer(full_width_config(), device="cuda")
    no_chance_stops(synth.model)
    synth.tts_many(SENTENCES[:2])
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        synth.tts_many(SENTENCES)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    prof.export_chrome_trace(os.path.join(out_dir, "profile_trace.json"))
    rows = device_rows(prof)
    busy_ms = sum(dev(e) for e in rows)
    print(f"[profile] batch of 8: wall {wall_ms:.1f} ms, device busy {busy_ms:.1f} ms "
          f"(idle share {1 - busy_ms / wall_ms:.3f})")
    for e in rows[:16]:
        print(f"[profile]   {dev(e):8.2f} ms  {e.count:6d} calls  {e.key[:90]}")
    report["profile"] = dict(wall_ms=wall_ms, busy_ms=busy_ms,
                             kernels={e.key: [dev(e), e.count] for e in rows[:40]})


# ------------------------------------------------------------------ training

TRAIN_B, TRAIN_T_TEXT, TRAIN_T_MEL = 32, 128, 400     # bench.py's config #3 shape


def train_config():
    """ljspeech_tacotron2.json at r=2, batch 32, gradual training off."""
    from your_voice_tts_torch.config import load_config

    cfg = load_config(os.path.join(ROOT, "configs/ljspeech_tacotron2.json"))
    return dataclasses.replace(
        cfg, model=dataclasses.replace(cfg.model, r=2),
        training=dataclasses.replace(cfg.training, gradual_training=None, batch_size=TRAIN_B))


def core_inputs(model, steps: int, B: int, T: int, seed: int):
    """The decoder core's bf16 weights laid out for the kernels, and seeded
    inputs at full width: prenet stack (post-ReLU), encoder memory in
    (-1, 1), its projection, lengths T .. T - 28, dropout multipliers."""
    import torch

    from your_voice_tts_torch.models.common import sequence_mask
    from your_voice_tts_torch.ops.taco2_train import prepare_train_weights

    dec = model.decoder
    bf = lambda t: None if t is None else t.detach().to(torch.bfloat16)  # noqa: E731
    ar, dr, a = dec.attention_rnn, dec.decoder_rnn, dec.attention
    w = prepare_train_weights(tuple(map(bf, (ar.weight_ih, ar.weight_hh, ar.bias))),
                              *map(bf, a.energy_weights()),
                              tuple(map(bf, (dr.weight_ih, dr.weight_hh, dr.bias))))
    g = torch.Generator().manual_seed(seed)
    P, E, H1, H2 = (w["dims"][k] for k in ("P", "E", "H1", "H2"))
    x = {"prenet_t": torch.relu(torch.randn(steps, B, P, generator=g)),
         "enc": torch.tanh(torch.randn(B, T, E, generator=g))}
    x = {k: v.to(torch.bfloat16).cuda() for k, v in x.items()}
    with torch.no_grad():
        x["pinp"] = x["enc"] @ bf(a.inputs.weight).T
    lengths = T - 4 * (torch.arange(B) % 8)
    x["maskf"] = sequence_mask(lengths, T).float().cuda()
    x["m_a"], x["m_d"] = (torch.where(torch.rand(steps, B, H, generator=g) < 0.9, 1 / 0.9, 0.0)
                          .to(torch.bfloat16).cuda() for H in (H1, H2))
    return w, x


def core_bound(w, B: int, T: int, steps: int, io_bytes: float, backward: bool):
    """(bound ms, bound_by) of one scan, per row-step. Products of bf16
    operands at the bf16 tensor-core peak: the LSTM products (forward, or
    with the transposed weights), the query projection, the location
    features (the rounded [att, cum] against the bf16 folded filter u; the
    Pallas kernel's band matmul) and, backward, the location correlation
    (rounded d_tanh against u) and d_q2 (rounded d_pq against q_w). Float32
    work outside the tensor cores: the energies (adds, tanh, the float32 v),
    the context weighted by the float32 alignments (backward: d_align's
    context term) and, backward, d_tanh, d_pq and the band sums. Bytes read
    and written once."""
    P, E, H1, H2, A, K = (w["dims"][k] for k in ("P", "E", "H1", "H2", "A", "K"))
    macs = 4 * H1 * (P + E + H1) + 4 * H2 * (H1 + E + H2) + A * H1 + T * A * 2 * K
    f32_ops = T * A * 5 + 2 * T * E
    if backward:
        macs += A * H1 + T * A * 2 * K
        f32_ops += T * A * 5 + 2 * T * K
    ops_s = steps * B * (2 * macs / BF16_FLOPS + f32_ops / F32_FLOPS)
    return bound(io_bytes, ops_s)


def nbytes(*ts) -> int:
    import torch

    return sum(t.numel() * t.element_size() for t in ts if isinstance(t, torch.Tensor))


FWD_LAUNCHES = ("lstm", "attn_fwd")


def fwd_launch_times(run) -> dict:
    """Device time of the forward's launches over one call of `run` under
    torch.profiler: {launch: {us_a_launch (mean), ms_a_call, launches}} for
    the LSTM products' launches (both LSTMs of a launch together), the
    attention's, and "other" (conversions, zeroed scratch)."""
    def key(name):
        return "lstm" if "lstm" in name else "attn_fwd" if "attn_fwd" in name else "other"

    return kernel_times(run, key, FWD_LAUNCHES + ("other",))


def kernel_times(run, key, keys) -> dict:
    """Device time of each kernel event of one call of `run` under
    torch.profiler, grouped by key(kernel name), called in time order:
    {key: {us_a_launch (mean), ms_a_call, launches}}."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    run()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        run()
        torch.cuda.synchronize()
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "trace.json")
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f)["traceEvents"]
    durs = {k: [] for k in keys}
    for e in sorted((e for e in events if e.get("cat") == "kernel"), key=lambda e: e["ts"]):
        durs[key(e["name"])].append(float(e["dur"]))
    return {k: {"us_a_launch": statistics.mean(v) if v else 0.0, "ms_a_call": sum(v) / 1e3,
                "launches": len(v)} for k, v in durs.items()}


def hold_train_fwd(tag: str, w, x) -> dict:
    """The forward kernel against its plain version on `core_inputs`' x:
    each stack's max abs error and rel L2 against the tolerances below,
    launches a call (2 a step plus one). Returns the kernel's stacks, the
    errors and the launches."""
    import torch

    from your_voice_tts_torch.ops.taco2_train import taco2_train_fwd_cuda, taco2_train_fwd_plain

    args = (w, x["prenet_t"], x["enc"], x["pinp"], x["maskf"], x["m_a"], x["m_d"])
    steps = x["prenet_t"].shape[0]
    before = taco2_train_fwd_cuda.launches
    got = taco2_train_fwd_cuda(*args)
    launches = taco2_train_fwd_cuda.launches - before
    ref = taco2_train_fwd_plain(*args)
    torch.cuda.synchronize()
    # tolerances: both sides round the same bf16 inputs at the same points
    # and sum in float32 in other orders; a 1-ulp flip of a stored bf16
    # value (2^-8 of it) feeds later steps, so each stack is held to 8 ulps
    # of its largest magnitude (2^-5 of it) in max abs error and 1e-2 in rel
    # L2; the float32 alignments to 2e-3 (the decode kernel's bound)
    errs, ok = {}, True
    for k in ref:
        e = float((got[k].float() - ref[k].float()).abs().max())
        peak = float(ref[k].float().abs().max())
        rel = float((got[k].float() - ref[k].float()).norm() / ref[k].float().norm())
        tol = 2e-3 if k == "align" else peak / 32
        errs[k] = dict(max_abs_err=e, tol=tol, peak=peak, rel_l2=rel)
        ok = ok and e <= tol and rel <= 1e-2
        print(f"[{tag}] {k:5s} max_abs_err {e:.3e} (tol {tol:.3e}, peak {peak:.3e}) "
              f"rel L2 {rel:.3e} (tol 1e-2)")
    check(ok, f"{tag}: training forward kernel disagrees with plain")
    check(launches == 2 * steps + 1,
          f"{tag}: {launches} launches a call, expected {2 * steps + 1}")
    return dict(got=got, errs=errs, launches=launches, args=args)


def phase_train_fwd(report, state):
    import torch

    from your_voice_tts_torch.models import setup_model
    from your_voice_tts_torch.ops.taco2_train import (mma_fragments, taco2_train_fwd_cuda,
                                                      taco2_train_fwd_plain,
                                                      taco2_train_fwd_probe_cuda)
    from your_voice_tts_torch.text import symbols

    steps, B, T = TRAIN_T_MEL // 2, TRAIN_B, TRAIN_T_TEXT
    model = setup_model(len(symbols), train_config(), device="cuda", seed=1)
    w, x = core_inputs(model, steps, B, T, seed=11)
    held = hold_train_fwd("train-fwd", w, x)
    got, errs, launches, args = held["got"], held["errs"], held["launches"], held["args"]
    # the same launches without programmatic dependence: the same bits (no
    # atomics), and each launch's device time on its own
    serial = lambda: taco2_train_fwd_probe_cuda(*args, probe="serial")  # noqa: E731
    same = serial()
    check(all(torch.equal(same[k], got[k]) for k in got),
          "train-fwd: dependent launches change the result")
    ms = cuda_ms(lambda: taco2_train_fwd_cuda(*args), 5)
    serial_ms = cuda_ms(serial, 5)
    plain_ms = cuda_ms(lambda: taco2_train_fwd_plain(*args), 2)
    per_launch = fwd_launch_times(serial)
    # the forward's fragment copy, made by prepare_train_weights on every
    # train step (the interleaved rows without their padding)
    P, E, H1, H2 = (w["dims"][k] for k in ("P", "E", "H1", "H2"))
    frag_ms = cuda_ms(lambda: (mma_fragments(w["a_w"][:, :P + E + H1]),
                               mma_fragments(w["d_w"][:, :H1 + E + H2])), 5)
    io = nbytes(x["prenet_t"], x["enc"], x["pinp"], x["maskf"], x["m_a"], x["m_d"],
                *(w[k] for k in ("a_w", "a_b", "d_w", "d_b", "q_w", "u", "v_w", "v_b")),
                *got.values())
    bound_ms, bound_by = core_bound(w, B, T, steps, io, backward=False)
    print(f"[train-fwd] B={B} T_in={T} steps={steps} kernel_ms {ms:.2f}  plain_ms "
          f"{plain_ms:.2f}  bound_ms {bound_ms:.3f} ({bound_by}; {io / 1e6:.0f} MB moved)  "
          f"library_ms none (no single PyTorch call computes the scan)  launches a call "
          f"{launches}  fragment-ordered W copy {frag_ms:.3f} ms a train step  serial "
          f"launches {serial_ms:.2f} ms, each:")
    for k, v in per_launch.items():
        print(f"[train-fwd]   {k:15s} {v['us_a_launch']:8.2f} us a launch  "
              f"{v['ms_a_call']:7.2f} ms a call  {v['launches']:5d} launches")
    report["train_fwd"] = dict(errs=errs, ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                               bound_by=bound_by, io_mb=io / 1e6, launches_a_call=launches,
                               per_launch=per_launch, fragment_copy_ms=frag_ms,
                               serial_ms=serial_ms)
    state.update(model=model, w=w, x=x, fwd=got)
    return {"name": "taco2_train_fwd_cuda", "route": "cuda",
            "source": "your_voice_tts_torch/csrc/taco2_train.cu",
            "replaces": "your_voice_tts_tpu/ops/pallas/taco2_train.py:172",
            "max_abs_err": max(v["max_abs_err"] for v in errs.values()), "ms": ms,
            "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by,
            "library_ms": None}


def train_bwd_args(w, x, fwd):
    """The backward's arguments on the forward's residuals (`fwd`, the
    forward kernel's stacks on core_inputs' x) and seeded random
    cotangents."""
    import torch

    sh = lambda s: torch.cat([torch.zeros_like(s[:1]), s[:-1]])  # noqa: E731
    res = {k: fwd[k] for k in ("g_a", "g_d", "c_a", "c_d")}
    res.update(c_a_prev=sh(fwd["c_a"]), c_d_prev=sh(fwd["c_d"]), att_prev=sh(fwd["align"]),
               cum_prev=sh(torch.cumsum(fwd["align"], 0)))
    g = torch.Generator().manual_seed(12)
    cot = [torch.randn(*fwd[k].shape, generator=g).to(fwd[k].dtype).cuda()
           for k in ("dech", "ctx", "align")]
    return (w, res, *cot, x["enc"], x["pinp"], x["maskf"], x["m_a"], x["m_d"])


BWD_LAUNCHES = ("cell_bwd", "matT_decoder", "attn_bwd", "matT_attention")


def bwd_launch_times(run) -> dict:
    """Device time of each of the backward's four launches over one call of
    `run` under torch.profiler (`kernel_times`; the W^T product kernel's
    launches alternate decoder, attention), and "other" for the call's
    other kernels (conversions, zeroed carries)."""
    n_mat = [0]

    def key(name):
        if "cell_bwd" in name:
            return "cell_bwd"
        if "attn_bwd" in name:
            return "attn_bwd"
        if "matT" in name:
            n_mat[0] += 1
            return BWD_LAUNCHES[1 + 2 * ((n_mat[0] - 1) % 2)]
        return "other"

    return kernel_times(run, key, BWD_LAUNCHES + ("other",))


def hold_train_bwd(tag: str, w, x, fwd) -> dict:
    """The backward kernel against its plain version on the forward's
    residuals `fwd` and seeded random cotangents: each output's rel L2
    against the tolerance below, launches a call (4 a step)."""
    import torch

    from your_voice_tts_torch.ops.taco2_train import taco2_train_bwd_cuda, taco2_train_bwd_plain

    steps = fwd["align"].shape[0]
    args = train_bwd_args(w, x, fwd)
    before = taco2_train_bwd_cuda.launches
    got = taco2_train_bwd_cuda(*args)
    launches = taco2_train_bwd_cuda.launches - before
    ref = taco2_train_bwd_plain(*args)
    torch.cuda.synchronize()
    # tolerance: rel L2 5e-2 per output. The reverse scan stores every gate
    # cotangent in bf16 and feeds it to the next step's products, so the
    # forward's 1-ulp flips compound over 200 reverse steps; the plain and
    # kernel versions differ only in float32 sum order
    errs, ok = {}, True
    for k in ref:
        rel = float((got[k].float() - ref[k].float()).norm() / ref[k].float().norm())
        e = float((got[k].float() - ref[k].float()).abs().max())
        errs[k] = dict(rel_l2=rel, max_abs_err=e)
        ok = ok and rel <= 5e-2
        print(f"[{tag}] {k:8s} rel L2 {rel:.3e} (tol 5e-2)  max_abs_err {e:.3e}")
    check(ok, f"{tag}: training backward kernel disagrees with plain")
    check(launches == 4 * steps, f"{tag}: {launches} launches a call, expected {4 * steps}")
    return dict(got=got, errs=errs, launches=launches, args=args)


def phase_train_bwd(report, state):
    import torch

    from your_voice_tts_torch.ops.taco2_train import (mma_fragments, taco2_train_bwd_cuda,
                                                      taco2_train_bwd_plain,
                                                      taco2_train_bwd_probe_cuda)

    w, x, fwd = state["w"], state["x"], state["fwd"]
    steps, B, T = fwd["align"].shape
    held = hold_train_bwd("train-bwd", w, x, fwd)
    got, errs, launches, args = held["got"], held["errs"], held["launches"], held["args"]
    res, cot = args[1], args[2:5]
    # the same launches without programmatic dependence: the same bits (no
    # atomics), and each launch's device time on its own
    serial = lambda: taco2_train_bwd_probe_cuda(*args, probe="serial")  # noqa: E731
    same = serial()
    check(all(torch.equal(same[k], got[k]) for k in got),
          "train-bwd: dependent launches change the result")
    run = lambda: taco2_train_bwd_cuda(*args)  # noqa: E731
    ms = cuda_ms(run, 5)
    serial_ms = cuda_ms(serial, 5)
    plain_ms = cuda_ms(lambda: taco2_train_bwd_plain(*args), 2)
    per_launch = bwd_launch_times(serial)
    H1, H2 = w["dims"]["H1"], w["dims"]["H2"]
    frag_ms = cuda_ms(lambda: (mma_fragments(w["a_wT"][:, :4 * H1]),
                               mma_fragments(w["d_wT"][:, :4 * H2])), 5)
    io = nbytes(*cot, x["enc"], x["pinp"], x["maskf"], x["m_a"], x["m_d"], *res.values(),
                w["a_wT"], w["d_wT"], w["q_w"], w["u"], w["v_w"], *got.values())
    bound_ms, bound_by = core_bound(w, B, T, steps, io, backward=True)
    print(f"[train-bwd] kernel_ms {ms:.2f}  plain_ms {plain_ms:.2f}  bound_ms {bound_ms:.3f} "
          f"({bound_by}; {io / 1e6:.0f} MB moved)  library_ms none  launches a call "
          f"{launches}  fragment-ordered W^T copy {frag_ms:.3f} ms an optimizer step  "
          f"serial launches {serial_ms:.2f} ms, each:")
    for k, v in per_launch.items():
        print(f"[train-bwd]   {k:15s} {v['us_a_launch']:8.2f} us a launch  "
              f"{v['ms_a_call']:7.2f} ms a call  {v['launches']:5d} launches")
    report["train_bwd"] = dict(errs=errs, ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                               bound_by=bound_by, io_mb=io / 1e6, launches_a_call=launches,
                               per_launch=per_launch, fragment_copy_ms=frag_ms,
                               serial_ms=serial_ms)
    return {"name": "taco2_train_bwd_cuda", "route": "cuda",
            "source": "your_voice_tts_torch/csrc/taco2_train.cu",
            "replaces": "your_voice_tts_tpu/ops/pallas/taco2_train.py:468",
            "max_abs_err": max(v["max_abs_err"] for v in errs.values()), "ms": ms,
            "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by,
            "library_ms": None}


def bench_batch(seed: int = 0) -> dict:
    """bench.py's config #3 batch: random symbols and N(0, 1) mels, every row
    full length."""
    import numpy as np

    from your_voice_tts_torch.text import symbols

    rng = np.random.default_rng(seed)
    B, Tt, Tm = TRAIN_B, TRAIN_T_TEXT, TRAIN_T_MEL
    return {"text": rng.integers(1, len(symbols), (B, Tt)).astype(np.int32),
            "text_lengths": np.full((B,), Tt, np.int32),
            "mel": rng.standard_normal((B, Tm, 80)).astype(np.float32),
            "mel_lengths": np.full((B,), Tm, np.int32),
            "stop_targets": np.zeros((B, Tm // 2), np.float32)}


def first_update_off(before, grads, after, lr0: float, clip: float, wd: float):
    """The first optimizer update against the schedule. RAdam's first step
    is the unrectified m_hat = g, so p1 = p0 - lr(0) * (clip(g) + wd * p0),
    here in float64 and rounded once to float32. Returns (parameters off
    that prediction by more than one float32 spacing plus 1e-6 of their
    move, the float32 rounding of the step's own scalars; parameters
    predicted to move by a spacing or more, which show the step was taken;
    parameters; the gradient norm)."""
    import torch

    g64 = [g.double() for g in grads]
    gnorm = math.sqrt(sum(float((g * g).sum()) for g in g64))
    scale = clip / gnorm if clip and gnorm >= clip else 1.0
    off = n_big = n_el = 0
    for p0, g, p1 in zip(before, g64, after):
        move = -lr0 * (g * scale + (wd or 0.0) * p0.double())
        pred = (p0.double() + move).float()
        spacing = torch.nextafter(pred.abs(), torch.full_like(pred, math.inf)) - pred.abs()
        off += int(((p1 - pred).abs().double() > spacing + 1e-6 * move.abs()).sum())
        n_big += int(((pred - p0).abs() >= spacing).sum())
        n_el += p0.numel()
    return off, n_big, n_el, gnorm


def phase_train_main(report, tmp: str):
    import torch

    import your_voice_tts_torch.models.decoder_grad as dg
    from your_voice_tts_torch.data.synthetic import make_synthetic_corpus
    from your_voice_tts_torch.nn.core import BatchNorm1d
    from your_voice_tts_torch.ops.taco2_train import (taco2_train_bwd_cuda,
                                                      taco2_train_bwd_plain,
                                                      taco2_train_fwd_cuda,
                                                      taco2_train_fwd_plain)
    from your_voice_tts_torch.train.trainer import Trainer

    counters = (taco2_train_fwd_cuda, taco2_train_bwd_cuda)
    # (b) fit on a synthetic corpus
    cfg = train_config()
    corpus = make_synthetic_corpus(os.path.join(tmp, "corpus"), n_items=64, sr=22050,
                                   max_words=15)
    ds = dataclasses.replace(cfg.data.datasets[0], name="synthetic", path=corpus)
    cfg = dataclasses.replace(cfg, data=dataclasses.replace(cfg.data, datasets=(ds,)))
    out_dir = os.path.join(tmp, "run")
    trainer = Trainer(cfg, output_path=out_dir, device="cuda")
    before = [p.detach().clone() for p in trainer.params]
    steps_seen: list[dict] = []
    train_step = trainer.train_step
    trainer.train_step = lambda batch, r: steps_seen.append(train_step(batch, r)) or \
        steps_seen[-1]
    opt = trainer.optimizer
    opt_step, first, applied = opt.step, {}, []

    def step_and_keep_the_first(grads):
        """The optimizer's step; keeps the first step's gradients and the
        parameters after it."""
        keep = not first
        if keep:
            first["grads"] = [g.detach().clone() for g in grads]
        applied.append(opt_step(grads))
        if keep:
            first["after"] = [p.detach().clone() for p in opt.params]
        return applied[-1]

    opt.step = step_and_keep_the_first
    # the test sentences after each evaluation: kernels 1 and the
    # routed Griffin-Lim kernel in the same process as the training scans
    tests: list = []
    test_run = trainer.test_run
    trainer.test_run = lambda s: tests.append(test_run(s)) or tests[-1]
    torch.cuda.synchronize()
    for c in counters + serve_counters():
        c.launches = 0
    with plain_calls() as plain:
        t0 = time.perf_counter()
        trainer.fit(max_steps=5)
        torch.cuda.synchronize()
        fit_s = time.perf_counter() - t0
    fit_launches = {c.__name__: c.launches for c in counters}
    test_launches = {c.__name__: c.launches for c in serve_counters()}
    trainer.train_step, opt.step, trainer.test_run = train_step, opt_step, test_run
    routes = gl_routes(tests, trainer.ap)
    print(f"[train] test sentences in the fit: {len(tests)} test runs, frames a row "
          f"{[[r['mel_postnet_spec'].shape[1] for r in res] for res in tests]}, Griffin-Lim "
          f"routes {routes}; launches {test_launches}; plain versions called {plain}")
    check(tests and test_launches["tacotron2_decode_cuda"] > 0
          and all(test_launches[ROUTE_KERNEL[k]] > 0 for k in routes)
          and not any(plain.values()), "the fit's test sentences did not run on the kernels")
    moved = max(float((p.detach() - q).abs().max()) for p, q in zip(trainer.params, before))
    ckpts = sorted(f for f in os.listdir(out_dir) if f.endswith(".npz"))
    print(f"[train] fit(max_steps=5): {fit_s:.1f} s; per step loss "
          f"{[round(m['loss'], 4) for m in steps_seen]} grad_norm "
          f"{[round(m['grad_norm'], 4) for m in steps_seen]}; largest parameter move "
          f"{moved:.3e}; checkpoints {ckpts}; launches {fit_launches}")
    check(len(steps_seen) == 5 and all(math.isfinite(m[k]) for m in steps_seen
                                       for k in ("loss", "grad_norm")),
          "fit losses / gradient norms not finite")
    check(moved > 0 and "checkpoint_5.npz" in ckpts, "fit moved no parameter or saved nothing")
    check(all(n > 0 for n in fit_launches.values()), "fit never launched a training kernel")
    lr0 = trainer.lr_fn(0)
    off, n_big, n_el, gnorm = first_update_off(before, first["grads"], first["after"], lr0,
                                               cfg.training.grad_clip, cfg.training.wd)
    print(f"[train] optimizer: {opt.count} updates applied ({applied}); first update at "
          f"lr(0) {lr0:.3e}, |g| {gnorm:.4f} (clip {cfg.training.grad_clip}): {off} of {n_el} "
          f"parameters off the prediction (tol 0); {n_big} predicted to move by one float32 "
          f"spacing or more")
    check(opt.count == 5 and all(applied) and off == 0 and n_big > 0,
          "the optimizer's steps do not follow the schedule")

    # (a) one train step, dropout off, on the kernels (twice: the card's own
    # run-to-run spread) and on the plain versions
    # Each BatchNorm's output is kept too: its bias gradient is the sum of
    # the output's cotangent over every (row, frame), which the readings
    # below set beside the cotangent's own agreement
    b = trainer._tensors(bench_batch())
    grads, d_bn = {}, {}
    bns = {n: m for n, m in trainer.model.named_modules() if isinstance(m, BatchNorm1d)}
    seen: dict = {}
    hooks = [m.register_forward_hook(lambda _m, _i, y, n=n: seen.__setitem__(n, y))
             for n, m in bns.items()]
    routes = (("kernel", (dg.taco2_train_fwd, dg.taco2_train_bwd)),
              ("kernel again", (dg.taco2_train_fwd, dg.taco2_train_bwd)),
              ("plain", (taco2_train_fwd_plain, taco2_train_bwd_plain)))
    for route, (fwd, bwd) in routes:
        kept = dg.taco2_train_fwd, dg.taco2_train_bwd
        dg.taco2_train_fwd, dg.taco2_train_bwd = fwd, bwd
        try:
            total, _, _ = trainer._loss_fn(b, 2, None)
            g = torch.autograd.grad(total, trainer.params + [seen[n] for n in bns])
            grads[route] = (total.item(), [x.float() for x in g[:len(trainer.params)]])
            d_bn[route] = [x.float() for x in g[len(trainer.params):]]
        finally:
            dg.taco2_train_fwd, dg.taco2_train_bwd = kept
    for h in hooks:
        h.remove()
    (lk, gk), (_, gk2), (lp, gp) = grads["kernel"], grads["kernel again"], grads["plain"]
    rel = lambda a, c: float((a - c).norm() / c.norm().clamp_min(1e-30))  # noqa: E731
    names = [n for n, p in trainer.model.named_parameters() if p.requires_grad]
    gscale = max(float(c.abs().max()) for c in gp)
    # a leaf's error as the JAX package's _grad_check measures it
    # (tests/test_taco2_train_kernel.py:55-78): max abs error over the
    # leaf's own largest magnitude, or over 1e-2 of the largest gradient
    # anywhere for a leaf near zero (a conv bias ahead of batch-statistics
    # BatchNorm has an exact gradient of 0 and holds rounding noise only)
    leaf = {n: float((a - c).abs().max()) / max(float(c.abs().max()), 1e-2 * gscale)
            for n, a, c in zip(names, gk, gp)}
    # BatchNorm bias readings: rel L2 kernel vs plain and kernel vs kernel,
    # the _grad_check measure, the gradient's norm; the cotangent summed
    # into it (rel L2 kernel vs plain) and its cancellation, the norm of
    # the per-channel sums of |cotangent| over the norm of the per-channel
    # sums
    by_name = dict(zip(names, zip(gk, gk2, gp)))
    big = max(names, key=lambda n: float(by_name[n][2].norm()))
    bn_read = {}
    for n, dk, dp in zip(bns, d_bn["kernel"], d_bn["plain"]):
        a, a2, c = by_name[n + ".bias"]
        axes = tuple(range(dp.dim() - 1))
        bn_read[n + ".bias"] = dict(
            rel_l2=rel(a, c), rel_l2_kernel_again=rel(a2, a), grad_check=leaf[n + ".bias"],
            norm=float(c.norm()), cotangent_rel_l2=rel(dk, dp),
            cancellation=float(dp.abs().sum(axes).norm() / dp.sum(axes).norm()))
    print(f"[train] BatchNorm bias gradients, kernel vs plain (largest gradient leaf {big}, "
          f"norm {float(by_name[big][2].norm()):.3e}):")
    for n, v in bn_read.items():
        print(f"[train]   {n}: rel L2 {v['rel_l2']:.3e} (kernel vs kernel "
              f"{v['rel_l2_kernel_again']:.1e}), _grad_check {v['grad_check']:.3e}, norm "
              f"{v['norm']:.3e}; its cotangent rel L2 {v['cotangent_rel_l2']:.3e}, "
              f"cancellation {v['cancellation']:.1f}")
    noise = max(float((a - a2).abs().max()) for a, a2 in zip(gk, gk2))
    cat = lambda gs: torch.cat([x.flatten() for x in gs])  # noqa: E731
    glob = rel(cat(gk), cat(gp))
    loss_rel = abs(lk - lp) / abs(lp)
    worst = max(leaf, key=leaf.get)
    # tolerances: loss rel 1e-3; all gradients together rel L2 5e-2 (the
    # backward kernel's own bound); every leaf within 0.08 (the JAX
    # package's bf16 bound for its kernel route against autodiff)
    top = sorted(leaf.items(), key=lambda kv: -kv[1])[:5]
    print(f"[train] one step at B={TRAIN_B} T_text={TRAIN_T_TEXT} T_mel={TRAIN_T_MEL}, "
          f"dropout off: loss kernel {lk:.6f} plain {lp:.6f} (rel {loss_rel:.2e}, tol 1e-3); "
          f"all gradients rel L2 kernel vs plain {glob:.3e} (tol 5e-2); {len(leaf)} leaves, "
          f"largest leaf error {leaf[worst]:.3e} ({worst}; tol 0.08), median "
          f"{statistics.median(leaf.values()):.3e}; kernel vs kernel max abs difference "
          f"{noise:.3e}")
    print("[train] largest leaf errors: " + "; ".join(f"{n} {d:.2e}" for n, d in top))
    check(loss_rel <= 1e-3 and glob <= 5e-2 and leaf[worst] <= 0.08,
          "kernel and plain train steps disagree")

    # (c) the timed train step at the bench shape
    batch = bench_batch()
    for _ in range(2):
        trainer.train_step(batch, 2)
    torch.cuda.synchronize()
    for c in counters:
        c.launches = 0
    times = []
    for _ in range(5):
        t0 = time.perf_counter()
        m = trainer.train_step(batch, 2)          # ends in a host read of the metrics
        times.append(time.perf_counter() - t0)
    launches = {c.__name__: c.launches for c in counters}
    step_ms = statistics.median(times) * 1e3
    frames_s = TRAIN_B * TRAIN_T_MEL / (step_ms / 1e3)
    print(f"[train] timed train step (B={TRAIN_B}, T_text={TRAIN_T_TEXT}, T_mel={TRAIN_T_MEL}, "
          f"bf16 mixed precision, dropout on): train_step_ms {step_ms:.1f} (all "
          f"{', '.join(f'{t * 1e3:.1f}' for t in times)}), train_mel_frames_per_s "
          f"{frames_s:.0f}, loss {m['loss']:.4f}; launches {launches}")
    check(all(n > 0 for n in launches.values()) and math.isfinite(m["loss"]),
          "timed train step")
    report["train"] = dict(fit_s=fit_s, fit_steps=steps_seen, fit_launches=fit_launches,
                           test_launches=test_launches, test_routes=routes,
                           loss_kernel=lk, loss_plain=lp, grad_rel_l2=glob,
                           grad_leaf_err=leaf, bn_bias=bn_read,
                           first_update=dict(lr0=lr0, off=off, n_big=n_big, n_el=n_el),
                           kernel_vs_kernel_max_abs=noise,
                           train_step_ms=step_ms, step_ms_all=[t * 1e3 for t in times],
                           train_mel_frames_per_s=frames_s, launches=launches)
    return trainer, dict(launches, **{k: n for k, n in test_launches.items() if n})


# ----------------------------------------- training the "your voice" path

SPK_DIM = 256          # the GE2E encoder's d-vector width (E = 512 + 256 = 768)
N_SPK = 4


def lstm_smem(dims: dict, B: int, plan: dict) -> int:
    """The forward's LSTM launch's dynamic shared memory (bf16), as
    csrc/taco2_train.cu `fwd_scan` sizes it from `lstm_mma_smem`: the larger
    product's staged k-tiles of its batch rows, or its partial sums."""
    ntl, cs = min(8, -(-B // 8)), plan["cluster"]
    P, E, H1, H2 = (dims[k] for k in ("P", "E", "H1", "H2"))

    def one(n):
        per = -(-(-(-n // 16)) // cs)
        return max(ntl * 8 * (per * 16 + 8) * 2, 128 * (ntl * 8 + 1) * 4)

    return max(one(P + E + H1), one(H1 + E + H2))


def hold_wide_train_kernels(report) -> tuple[dict, dict]:
    """Kernels 5 and 6 at the conditioned memory widths, phases 5-6's inputs
    otherwise: E = 768 (256-wide d-vectors) and E = 1,024 (the 512-wide
    speaker table) at T_in = 128, where the forward's attention stages the
    encoder's columns in shared memory, and the forward at E = 1,024 and
    T_in = 320, past the staged limit (global memory). Each plan's clusters,
    shared memory (the C layout function against `attn_fwd_smem` /
    `attn_bwd_smem`) and staging route; kernel, plain and bound ms,
    launches a call; the forward's launches' device times beside E = 512's.
    Returns ({kernel name: largest max abs error}, the numbers)."""
    import torch

    from your_voice_tts_torch.models import setup_model
    from your_voice_tts_torch.ops.taco2_train import (SMEM_LIMIT, _lib, attn_bwd_smem,
                                                      attn_fwd_smem, bwd_plan, fwd_plan,
                                                      t_in_limits, taco2_train_bwd_cuda,
                                                      taco2_train_bwd_plain,
                                                      taco2_train_fwd_cuda,
                                                      taco2_train_fwd_plain,
                                                      taco2_train_fwd_probe_cuda)
    from your_voice_tts_torch.text import symbols

    steps, B = TRAIN_T_MEL // 2, TRAIN_B
    lib = _lib()
    errs = {"taco2_train_fwd_cuda": 0.0, "taco2_train_bwd_cuda": 0.0}
    out: dict = {}
    e512 = report["train_fwd"]["per_launch"]
    for spk_kw, Ts in ((dict(speaker_embedding_dim=SPK_DIM), (128,)), ({}, (128, 320))):
        model = setup_model(len(symbols), train_config(), device="cuda", seed=1,
                            num_speakers=N_SPK, **spk_kw)
        for T in Ts:
            w, x = core_inputs(model, steps, B, T, seed=11)
            d = w["dims"]
            P, E, H1, H2, A, K = (d[k] for k in ("P", "E", "H1", "H2", "A", "K"))
            tag = f"train-wide E={E} T_in={T}"
            plan = fwd_plan(d, B, T)
            acs = plan["attn"]["cluster"]
            f_smem, staged = attn_fwd_smem(T, A, K, H1, E, acs, 2)
            c_smem = lib.taco2_train_attn_fwd_smem(T, A, K, H1, E, acs, 1)
            check(c_smem == f_smem, f"{tag}: attn_fwd_smem {f_smem} != the C layout's {c_smem}")
            l_smem = lstm_smem(d, B, plan)
            limits = t_in_limits(d, 2)
            print(f"[{tag}] plan: LSTM cluster {plan['cluster']} (k-tiles a = "
                  f"{plan['a']['k_tiles']}, d = {plan['d']['k_tiles']}; after the wait "
                  f"{len(plan['a']['after_wait'][0])} / {len(plan['d']['after_wait'][0])} a "
                  f"block), LSTM shared memory {l_smem} B; attention cluster {acs}, shared "
                  f"memory {f_smem} B of {SMEM_LIMIT}, encoder columns "
                  f"{'staged' if staged else 'from global memory'} (staged up to T_in "
                  f"{limits['fwd_staged']}, runs up to {limits['fwd']})")
            fwd = hold_train_fwd(tag, w, x)
            args = fwd["args"]
            errs["taco2_train_fwd_cuda"] = max(errs["taco2_train_fwd_cuda"], max(
                v["max_abs_err"] for v in fwd["errs"].values()))
            ms = cuda_ms(lambda: taco2_train_fwd_cuda(*args), 5)
            plain_ms = cuda_ms(lambda: taco2_train_fwd_plain(*args), 2)
            per_launch = fwd_launch_times(
                lambda: taco2_train_fwd_probe_cuda(*args, probe="serial"))
            io = nbytes(x["prenet_t"], x["enc"], x["pinp"], x["maskf"], x["m_a"], x["m_d"],
                        *(w[k] for k in ("a_w", "a_b", "d_w", "d_b", "q_w", "u", "v_w",
                                         "v_b")), *fwd["got"].values())
            bound_ms, bound_by = core_bound(w, B, T, steps, io, backward=False)
            weights_mb = nbytes(w["a_w"], w["d_w"]) / 1e6
            print(f"[{tag}] forward kernel_ms {ms:.2f}  plain_ms {plain_ms:.2f}  bound_ms "
                  f"{bound_ms:.3f} ({bound_by}; {io / 1e6:.0f} MB moved; LSTM weights "
                  f"{weights_mb:.1f} MB a step)  launches a call {fwd['launches']}; serial "
                  f"launches, us a launch (E = 512 at T_in 128 beside): " + ", ".join(
                      f"{k} {v['us_a_launch']:.2f} ({e512[k]['us_a_launch']:.2f})"
                      for k, v in per_launch.items() if k != "other"))
            row = dict(E=E, T_in=T, fwd_ms=ms, fwd_plain_ms=plain_ms, fwd_bound_ms=bound_ms,
                       fwd_bound_by=bound_by, fwd_launches=fwd["launches"],
                       fwd_errs=fwd["errs"], per_launch=per_launch, lstm_cluster=plan["cluster"],
                       lstm_smem=l_smem, attn_cluster=acs, attn_smem=f_smem, staged=staged,
                       limits=limits, lstm_weights_mb=weights_mb)
            if T == TRAIN_T_TEXT:
                bplan = bwd_plan(d, B, T)
                ldq = w["q_w"].shape[1]
                b_smem = attn_bwd_smem(T, A, K, E, ldq, H1, bplan["attn"]["cluster"], 2)
                check(b_smem == lib.taco2_train_attn_bwd_smem(T, A, K, E, ldq, H1,
                                                              bplan["attn"]["cluster"], 1),
                      f"{tag}: attn_bwd_smem differs from the C layout's")
                bwd = hold_train_bwd(tag, w, x, fwd["got"])
                bargs = bwd["args"]
                errs["taco2_train_bwd_cuda"] = max(errs["taco2_train_bwd_cuda"], max(
                    v["max_abs_err"] for v in bwd["errs"].values()))
                bms = cuda_ms(lambda: taco2_train_bwd_cuda(*bargs), 5)
                bplain_ms = cuda_ms(lambda: taco2_train_bwd_plain(*bargs), 2)
                res, cot = bargs[1], bargs[2:5]
                bio = nbytes(*cot, x["enc"], x["pinp"], x["maskf"], x["m_a"], x["m_d"],
                             *res.values(), w["a_wT"], w["d_wT"], w["q_w"], w["u"], w["v_w"],
                             *bwd["got"].values())
                bbound, bbound_by = core_bound(w, B, T, steps, bio, backward=True)
                print(f"[{tag}] backward plan: W^T clusters a {bplan['a']['cluster']} / d "
                      f"{bplan['d']['cluster']} ({bplan['a']['k_tiles']} / "
                      f"{bplan['d']['k_tiles']} k-tiles), attention cluster "
                      f"{bplan['attn']['cluster']}, shared memory {b_smem} B of {SMEM_LIMIT} "
                      f"(runs up to T_in {limits['bwd']}); kernel_ms {bms:.2f}  plain_ms "
                      f"{bplain_ms:.2f}  bound_ms {bbound:.3f} ({bbound_by}; {bio / 1e6:.0f} MB "
                      f"moved)  launches a call {bwd['launches']}")
                row.update(bwd_ms=bms, bwd_plain_ms=bplain_ms, bwd_bound_ms=bbound,
                           bwd_bound_by=bbound_by, bwd_launches=bwd["launches"],
                           bwd_errs=bwd["errs"], bwd_attn_smem=b_smem)
            out[f"E{E}_T{T}"] = row
            del fwd, w, x
        del model
        torch.cuda.empty_cache()
    check(any(not r["staged"] for r in out.values()) and any(r["staged"] for r in out.values()),
          "train-wide: both staging routes of the forward's attention held")
    return errs, out


def conditioned_cfg(kind: str, corpus: str, cache: str):
    """train_config() on the 4-speaker corpus, conditioned: "table" (the
    512-wide speaker table, E = 1,024), "dvec" (256-wide d-vectors,
    E = 768) or "dvec+gst" (those and GST, 256 / 4 heads / 10 tokens); mels
    cached in `cache`."""
    cfg = train_config()
    ds = dataclasses.replace(cfg.data.datasets[0], name="synthetic", path=corpus)
    sp = dict(use_speaker_embedding=True)
    if kind != "table":
        sp.update(use_external_speaker_embedding_file=True, speaker_embedding_dim=SPK_DIM)
    if kind.endswith("gst"):
        sp["use_gst"] = True
    return dataclasses.replace(
        cfg, data=dataclasses.replace(cfg.data, datasets=(ds,), phoneme_cache_path=cache),
        speakers=dataclasses.replace(cfg.speakers, **sp))


def hold_conditioned_step(tag: str, trainer, batch: dict) -> dict:
    """One train step's loss and every gradient leaf on the kernels and on
    the plain versions, dropout off, with phase 7(a)'s measure and
    tolerances; the speaker and GST leaves printed apart."""
    import torch

    import your_voice_tts_torch.models.decoder_grad as dg
    from your_voice_tts_torch.ops.taco2_train import taco2_train_bwd_plain, taco2_train_fwd_plain

    b = trainer._tensors(batch)
    grads = {}
    for route, fns in (("kernel", (dg.taco2_train_fwd, dg.taco2_train_bwd)),
                       ("plain", (taco2_train_fwd_plain, taco2_train_bwd_plain))):
        kept = dg.taco2_train_fwd, dg.taco2_train_bwd
        dg.taco2_train_fwd, dg.taco2_train_bwd = fns
        try:
            total, _, _ = trainer._loss_fn(b, 2, None)
            g = torch.autograd.grad(total, trainer.params)
            grads[route] = (total.item(), [x.float() for x in g])
        finally:
            dg.taco2_train_fwd, dg.taco2_train_bwd = kept
    (lk, gk), (lp, gp) = grads["kernel"], grads["plain"]
    names = [n for n, p in trainer.model.named_parameters() if p.requires_grad]
    gscale = max(float(c.abs().max()) for c in gp)
    leaf = {n: float((a - c).abs().max()) / max(float(c.abs().max()), 1e-2 * gscale)
            for n, a, c in zip(names, gk, gp)}
    cat = lambda gs: torch.cat([x.flatten() for x in gs])  # noqa: E731
    glob = float((cat(gk) - cat(gp)).norm() / cat(gp).norm())
    loss_rel = abs(lk - lp) / abs(lp)
    worst = max(leaf, key=leaf.get)
    cond = {n: e for n, e in leaf.items() if n.startswith(("speaker_embedding", "gst."))}
    E = trainer.model.decoder.attention_rnn.weight_ih.shape[1] - trainer.cfg.model.prenet_dim
    print(f"[{tag}] one step (E = {E}, B={TRAIN_B}, T_text={TRAIN_T_TEXT}, "
          f"T_mel={TRAIN_T_MEL}, bf16 mixed precision, dropout off): loss kernel {lk:.6f} "
          f"plain {lp:.6f} (rel {loss_rel:.2e}, tol 1e-3); all gradients rel L2 {glob:.3e} "
          f"(tol 5e-2); {len(leaf)} leaves, largest leaf error {leaf[worst]:.3e} ({worst}; "
          f"tol 0.08); conditioning leaves: " + (", ".join(
              f"{n} {e:.2e}" for n, e in sorted(cond.items(), key=lambda kv: -kv[1])[:4])
              + f" ({len(cond)} leaves, largest {max(cond.values()):.2e})" if cond else "none"))
    check(loss_rel <= 1e-3 and glob <= 5e-2 and leaf[worst] <= 0.08,
          f"{tag}: kernel and plain train steps disagree")
    m = trainer.model
    want = ({"speaker_embedding.weight"} if m.num_speakers and not
            m.use_external_speaker_embedding else set()) | \
        ({"gst.style.tokens", "gst.proj.weight"} if m.use_gst else set())
    check(want <= set(cond), f"{tag}: conditioning leaves {sorted(want - set(cond))} not held")
    return dict(E=E, loss_kernel=lk, loss_plain=lp, loss_rel=loss_rel, grad_rel_l2=glob,
                worst_leaf=worst, worst_leaf_err=leaf[worst], conditioning_leaves=cond)


def train_speaker_encoder_on_card(corpus: str, tmp: str) -> tuple[dict, dict]:
    """SpeakerEncoderTrainer at full width (80 -> 3 x 768 / 256), N = 4,
    M = 4, 160 frames, 20 steps at lr 1e-3; the GE2E loss of one fixed
    held batch before and after; its checkpoint through load_encoder; each
    speaker's d-vector as the normalized mean of its clips' embeddings."""
    import numpy as np
    import torch

    from your_voice_tts_torch.audio import AudioProcessor
    from your_voice_tts_torch.data.formatters import synthetic
    from your_voice_tts_torch.speaker_encoder.dataset import SpeakerEncoderDataset
    from your_voice_tts_torch.speaker_encoder.model import SpeakerEncoder, load_encoder
    from your_voice_tts_torch.speaker_encoder.train import SpeakerEncoderTrainer

    ap = AudioProcessor(train_config().audio, "cuda")
    t0 = time.perf_counter()
    ds = SpeakerEncoderDataset(synthetic(corpus), ap, num_frames=160)
    ds_s = time.perf_counter() - t0
    enc = SpeakerEncoder(input_dim=80, device="cuda")
    tr = SpeakerEncoderTrainer(enc, ds, lr=1e-3, num_speakers_per_batch=N_SPK,
                               num_utters_per_speaker=4, verbose=False, device="cuda")
    held = torch.as_tensor(ds.sample_batch(N_SPK, 4, np.random.default_rng(7)), device="cuda")
    with torch.no_grad():
        before = float(tr.loss(held))
    rng, losses = np.random.default_rng(0), []
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(20):
        losses.append(tr.train_step(ds.sample_batch(N_SPK, 4, rng)))
    torch.cuda.synchronize()
    step_ms = (time.perf_counter() - t0) / 20 * 1e3
    with torch.no_grad():
        after = float(tr.loss(held))
    path = tr.save(os.path.join(tmp, "speaker_encoder.npz"))
    loaded = load_encoder(path, device="cuda")
    same = all(torch.equal(a, b) for a, b in zip(enc.state_dict().values(),
                                                  loaded.state_dict().values()))
    dvecs = {}
    for spk in ds.speakers:
        embs = torch.stack([loaded.compute_embedding(m) for m in ds.by_speaker[spk]]).mean(0)
        dvecs[spk] = (embs / embs.norm().clamp_min(1e-8)).cpu().numpy().astype(np.float32)
    names = sorted(dvecs)
    cos = np.array([[float(dvecs[a] @ dvecs[b]) for b in names] for a in names])
    print(f"[train-cond] GE2E: {len(ds.speakers)} speakers, {sum(map(len, ds.by_speaker.values()))} "
          f"clips (mels {ds_s:.2f} s); 20 steps at N=4 M=4, {step_ms:.1f} ms a step; loss by "
          f"step {', '.join(f'{x:.3f}' for x in losses)}; held batch {before:.4f} -> {after:.4f}; "
          f"checkpoint loads back {'equal' if same else 'DIFFERENT'}; d-vector cosines off "
          f"the diagonal {np.round(cos[~np.eye(len(names), dtype=bool)], 3).tolist()}")
    check(all(math.isfinite(x) for x in losses) and after < before,
          "GE2E training: the held batch's loss did not fall")
    check(same and tr.step == 20, "speaker encoder checkpoint")
    return dvecs, dict(losses=losses, held_before=before, held_after=after, step_ms=step_ms,
                       dvector_cos=cos.tolist())


def phase_train_conditioned(report, tmp: str) -> tuple[dict, dict]:
    """Phase 7b: (a) kernels 5 and 6 at E = 768 / 1,024; (c) the "your
    voice" path on a synthetic 4-speaker corpus: the GE2E encoder, the
    d-vectors, Trainer.fit(max_steps=5) for the d-vector, table and
    d-vector + GST configs, a batch of 8 over the 4 speakers through
    Synthesizer from the trained d-vector checkpoint; (b) after each fit,
    one train step at the bench shape on the kernels and on the plain
    versions. Each path's counters set to 0 just before it, read just
    after. Returns ({kernel: largest max abs error}, launches)."""
    import numpy as np
    import torch

    from your_voice_tts_torch.data.synthetic import make_synthetic_corpus
    from your_voice_tts_torch.infer.synthesizer import Synthesizer
    from your_voice_tts_torch.ops.taco2_decode import tacotron2_decode_cuda
    from your_voice_tts_torch.ops.taco2_train import taco2_train_bwd_cuda, taco2_train_fwd_cuda
    from your_voice_tts_torch.train.trainer import Trainer
    from your_voice_tts_torch.utils.speakers import save_speaker_mapping

    errs, out = hold_wide_train_kernels(report)
    result = {"kernels": out}
    corpus = make_synthetic_corpus(os.path.join(tmp, "corpus4"), n_items=64, sr=22050,
                                   n_speakers=N_SPK, max_words=15)
    dvecs, result["ge2e"] = train_speaker_encoder_on_card(corpus, tmp)
    batch = bench_batch()
    batch["speaker_ids"] = np.arange(TRAIN_B, dtype=np.int32) % N_SPK
    counters = (taco2_train_fwd_cuda, taco2_train_bwd_cuda)
    launches = {c.__name__: 0 for c in counters}
    ckpt = {}
    for kind in ("dvec", "table", "dvec+gst"):
        cfg = conditioned_cfg(kind, corpus, os.path.join(tmp, "mels"))
        run = os.path.join(tmp, f"run-{kind}")
        trainer = Trainer(cfg, output_path=run, device="cuda", verbose=False,
                          speaker_embeddings=None if kind == "table" else dvecs)
        before = [p.detach().clone() for p in trainer.params]
        gst_bn = None
        if trainer.model.use_gst:
            gst_bn = trainer.model.gst.ref.convs[0].bn
            check(float(gst_bn.running_mean.abs().max()) == 0.0, "GST running mean starts at 0")
        seen: list = []
        step = trainer.train_step
        trainer.train_step = lambda b, r: seen.append(step(b, r)) or seen[-1]
        torch.cuda.synchronize()
        for c in counters:
            c.launches = 0
        t0 = time.perf_counter()
        trainer.fit(max_steps=5)
        torch.cuda.synchronize()
        fit_s = time.perf_counter() - t0
        fit_launches = {c.__name__: c.launches for c in counters}
        trainer.train_step = step
        moved = max(float((p.detach() - q).abs().max()) for p, q in zip(trainer.params, before))
        cond_moved = {n: float((p.detach() - q).abs().max())
                      for (n, p), q in zip(((n, p) for n, p in trainer.model.named_parameters()
                                            if p.requires_grad), before)
                      if n.startswith(("speaker_embedding", "gst."))}
        ckpts = sorted(f for f in os.listdir(run) if f.endswith(".npz"))
        gst_stat = None if gst_bn is None else float(gst_bn.running_mean.abs().max())
        E = trainer.model.decoder.attention_rnn.weight_ih.shape[1] - cfg.model.prenet_dim
        print(f"[train-cond] {kind} (E = {E}): fit(max_steps=5) {fit_s:.1f} s; loss "
              f"{[round(m['loss'], 4) for m in seen]} grad_norm "
              f"{[round(m['grad_norm'], 4) for m in seen]}; largest parameter move "
              f"{moved:.3e}, of the conditioning leaves {max(cond_moved.values(), default=0):.3e}"
              f"; checkpoints {ckpts}; GST running mean max {gst_stat}; launches {fit_launches}")
        check(len(seen) == 5 and all(math.isfinite(m[k]) for m in seen
                                     for k in ("loss", "grad_norm")),
              f"{kind}: fit losses / gradient norms not finite")
        check(moved > 0 and "checkpoint_5.npz" in ckpts, f"{kind}: fit moved or saved nothing")
        check(kind != "table" or cond_moved.get("speaker_embedding.weight", 0) > 0,
              "the speaker table did not move")
        check(gst_bn is None or (gst_stat > 0 and cond_moved["gst.style.tokens"] > 0
                                 and cond_moved["gst.proj.weight"] > 0),
              f"{kind}: GST running statistics or parameters did not move")
        check(all(n > 0 for n in fit_launches.values()), f"{kind}: no training kernel launched")
        for k, n in fit_launches.items():
            launches[k] += n
        if kind != "table":
            batch["speaker_embeddings"] = np.stack(
                [dvecs[f"SYN{i % N_SPK:02d}"] for i in range(TRAIN_B)])
        step_held = hold_conditioned_step(f"train-cond {kind}", trainer, batch)
        batch.pop("speaker_embeddings", None)
        result[kind] = dict(fit_s=fit_s, fit_steps=seen, fit_launches=fit_launches,
                            moved=moved, conditioning_moved=cond_moved, gst_running_mean=gst_stat,
                            step=step_held)
        ckpt[kind] = os.path.join(run, "checkpoint_5.npz")
        del trainer
        torch.cuda.empty_cache()

    # the clone: the trained d-vector checkpoint through Synthesizer
    spk_json = os.path.join(tmp, "dvectors.json")
    save_speaker_mapping(spk_json, {n: {"mean": v.tolist()} for n, v in dvecs.items()})
    cfg = conditioned_cfg("dvec", corpus, os.path.join(tmp, "mels"))
    cfg = dataclasses.replace(cfg, model=dataclasses.replace(cfg.model, max_decoder_steps=250))
    synth = Synthesizer(cfg, tts_checkpoint=ckpt["dvec"], speakers_json=spk_json, device="cuda")
    speakers = [f"SYN{i % N_SPK:02d}" for i in range(len(SENTENCES))]
    synth.tts_many(SENTENCES[:1], speakers[:1])
    torch.cuda.synchronize()
    clone_counters = (tacotron2_decode_cuda,) + gl_counters()
    for c in clone_counters:
        c.launches = 0
    t0 = time.perf_counter()
    wavs = synth.tts_many(SENTENCES, speakers)
    clone_ms = (time.perf_counter() - t0) * 1e3
    clone_launches = {c.__name__: c.launches for c in clone_counters}
    print(f"[train-cond] clone: the trained d-vector checkpoint, a batch of 8 over "
          f"{N_SPK} speakers in {clone_ms:.1f} ms, {sum(len(w) for w in wavs)} samples; "
          f"launches {clone_launches}")
    check(len(wavs) == len(SENTENCES) and all(w.ndim == 1 and len(w) > 0
                                               and bool(np.isfinite(w).all()) for w in wavs),
          "the clone's waveforms")
    check(clone_launches["tacotron2_decode_cuda"] > 0
          and clone_launches["griffin_lim_wave_cuda"] > 0, "the clone's kernels")
    for k, n in clone_launches.items():
        launches[k] = launches.get(k, 0) + n
    result.update(clone_ms=clone_ms, clone_launches=clone_launches, launches=launches)
    report["train_conditioned"] = result
    return errs, launches


# ------------------------------------------------------- Tacotron(1) training

TACO1_T_MEL = 406          # config #3's 400 frames padded to whole steps of r = 7


def gl_routes(runs, ap) -> dict:
    """{Griffin-Lim route: frame buckets} that `AudioProcessor.inv_*_batch`
    gives the rows of test runs' synthesis results (each row's frames,
    bucketed)."""
    from your_voice_tts_torch.ops.griffin_lim import gl_route

    out: dict = {}
    for r in (r for results in runs for r in results):
        tb = ap._frame_bucket(r["mel_postnet_spec"].shape[1])
        out.setdefault(gl_route(tb, ap.cfg.fft_size, ap.hop_length), set()).add(tb)
    return {k: sorted(v) for k, v in out.items()}


ROUTE_KERNEL = {"wave": "griffin_lim_wave_cuda", "full": "griffin_lim_full_cuda",
                "iteration": "gl_iteration_cuda"}


def taco1_train_cfg(corpus: str | None = None, stats_path: str | None = None, **training):
    """taco1_config() (width 256, memory 5, r = 7 of r_init 7, num_freq 513)
    for training: batch 32, gradual training off; the synthetic corpus and
    the statistics where given."""
    cfg = taco1_config()
    tr = dict(gradual_training=None, batch_size=TRAIN_B, **training)
    cfg = dataclasses.replace(cfg, training=dataclasses.replace(cfg.training, **tr))
    if corpus is not None:
        ds = dataclasses.replace(cfg.data.datasets[0], name="synthetic", path=corpus)
        cfg = dataclasses.replace(cfg, data=dataclasses.replace(cfg.data, datasets=(ds,)))
    if stats_path is not None:
        cfg = dataclasses.replace(cfg, audio=dataclasses.replace(cfg.audio,
                                                                 stats_path=stats_path))
    return cfg


def taco1_batch(seed: int = 0) -> dict:
    """Config #3's batch for Tacotron(1): 32 rows of 128 random symbols,
    400 N(0, 1) mel frames padded to 406 (58 steps of r = 7), a N(0, 1)
    linear target [32, 406, 513], the stop targets of 400 frames."""
    import numpy as np

    from your_voice_tts_torch.text import symbols

    rng = np.random.default_rng(seed)
    B, Tt, Tm = TRAIN_B, TRAIN_T_TEXT, TACO1_T_MEL
    valid = (np.arange(Tm) < TRAIN_T_MEL)[None, :, None]
    steps = -(-TRAIN_T_MEL // TACO1_R)
    return {"text": rng.integers(1, len(symbols), (B, Tt)).astype(np.int32),
            "text_lengths": np.full((B,), Tt, np.int32),
            "mel": (rng.standard_normal((B, Tm, 80)) * valid).astype(np.float32),
            "linear": (rng.standard_normal((B, Tm, 513)) * valid).astype(np.float32),
            "mel_lengths": np.full((B,), TRAIN_T_MEL, np.int32),
            "stop_targets": np.broadcast_to(np.arange(Tm // TACO1_R) >= steps - 1,
                                            (B, Tm // TACO1_R)).astype(np.float32)}


def taco1_step(trainer, batch: dict) -> tuple[dict, list]:
    """One teacher-forced step through the Trainer's own `_loss_fn` (its
    linear target, priority band and precision), dropout off: the loss
    parts and the gradients of `trainer.params`."""
    import torch

    total, parts, _ = trainer._loss_fn(trainer._tensors(batch), TACO1_R, None)
    grads = torch.autograd.grad(total, trainer.params)
    return {k: float(v.detach()) for k, v in parts.items()}, grads


def hold_taco1_step(result: dict, corpus: str) -> None:
    """(1) One full-width Tacotron(1) train step, card against CPU: a
    float32 Trainer on each device (the CPU one's weights loaded into the
    card's), the same batch, dropout off, TF32 off: every loss part within
    1e-4 relative, all gradients within 1e-3 rel L2."""
    import torch

    from your_voice_tts_torch.train.trainer import Trainer

    cfg = taco1_train_cfg(corpus, mixed_precision=False)
    batch = taco1_batch()
    trainers = {"cpu": Trainer(cfg, device="cpu", verbose=False),
                "cuda": Trainer(cfg, device="cuda", verbose=False)}
    trainers["cuda"].model.load_state_dict(trainers["cpu"].model.state_dict())
    names = [n for n, p in trainers["cpu"].model.named_parameters() if p.requires_grad]
    got, secs = {}, {}
    for dev in ("cuda", "cpu"):
        t0 = time.perf_counter()
        got[dev] = taco1_step(trainers[dev], batch)
        secs[dev] = time.perf_counter() - t0
    del trainers
    (pc, gc), (pk, gk) = got["cpu"], got["cuda"]
    rel = {k: abs(pk[k] - v) / max(abs(v), 1e-30) for k, v in pc.items()}
    cat = lambda gs: torch.cat([g.double().flatten().cpu() for g in gs])  # noqa: E731
    glob = float((cat(gk) - cat(gc)).norm() / cat(gc).norm())
    # a leaf's rel L2 (a conv bias ahead of batch-statistics BatchNorm has
    # an exact gradient of 0: its rel L2 compares rounding noise)
    leaf = {n: float((a.double().cpu() - c.double()).norm() / c.double().norm().clamp_min(1e-30))
            for n, a, c in zip(names, gk, gc)}
    worst = max(leaf, key=leaf.get)
    gmax = max(float(c.abs().max()) for c in gc)
    print(f"[taco1-train] one step at full width (B={TRAIN_B}, T_text={TRAIN_T_TEXT}, "
          f"T_mel={TRAIN_T_MEL} padded to {TACO1_T_MEL}, {TACO1_T_MEL // TACO1_R} decoder steps "
          f"of r = {TACO1_R}, float32, dropout off): loss parts card {pk}; rel to the CPU's "
          + ", ".join(f"{k} {v:.2e}" for k, v in rel.items()) + f" (tol 1e-4); all gradients "
          f"rel L2 {glob:.3e} (tol 1e-3), largest leaf rel L2 {leaf[worst]:.3e} ({worst}, "
          f"its largest gradient {float(gc[names.index(worst)].abs().max()):.2e} against "
          f"{gmax:.2e} anywhere); CPU step "
          f"{secs['cpu']:.1f} s, card {secs['cuda']:.2f} s (first call)")
    check(max(rel.values()) <= 1e-4 and glob <= 1e-3, "Tacotron(1) step: card and CPU disagree")
    result["step"] = dict(parts_card=pk, parts_cpu=pc, parts_rel=rel, grad_rel_l2=glob,
                          worst_leaf=worst, worst_leaf_rel_l2=leaf[worst])


def time_taco1_steps(trainer, result: dict) -> None:
    """(2) Trainer.train_step at config #3's batch (dropout on), float32
    and mixed precision: CUDA events, median of 5 after one warm step; the
    wall (median of the same 5, host clock); one more step under
    torch.profiler for the device's busy share (the union of its kernels'
    intervals)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    batch = taco1_batch(1)
    out = {}
    for mixed in (False, True):
        trainer.cfg = dataclasses.replace(trainer.cfg, training=dataclasses.replace(
            trainer.cfg.training, mixed_precision=mixed))
        trainer.train_step(batch, TACO1_R)
        torch.cuda.synchronize()
        ev, wall = [], []
        for _ in range(5):
            s, e = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            t0 = time.perf_counter()
            s.record()
            m = trainer.train_step(batch, TACO1_R)        # ends in a host read
            e.record()
            e.synchronize()
            wall.append((time.perf_counter() - t0) * 1e3)
            ev.append(s.elapsed_time(e))
        with tempfile.TemporaryDirectory() as tmp:
            with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                t0 = time.perf_counter()
                trainer.train_step(batch, TACO1_R)
                torch.cuda.synchronize()
                pwall = (time.perf_counter() - t0) * 1e3
            trace = os.path.join(tmp, "trace.json")
            prof.export_chrome_trace(trace)
            busy, summed, n_k = device_busy(trace)
        tag = "mixed" if mixed else "f32"
        out[tag] = dict(step_ms=statistics.median(ev), step_ms_all=ev,
                        wall_ms=statistics.median(wall), profiled_wall_ms=pwall, busy_ms=busy,
                        busy_share=busy / pwall, kernels=n_k, loss=m["loss"])
        print(f"[taco1-train] timed step, {'bf16 mixed precision' if mixed else 'float32'}: "
              f"{out[tag]['step_ms']:.1f} ms (CUDA events, median of 5; all "
              f"{', '.join(f'{x:.1f}' for x in ev)}), wall {out[tag]['wall_ms']:.1f} ms; "
              f"profiled step {pwall:.1f} ms, device busy {busy:.1f} ms (busy share "
              f"{busy / pwall:.3f}, {n_k} kernels, summed {summed:.1f} ms); "
              f"{TACO1_T_MEL // TACO1_R} decoder steps; loss {m['loss']:.4f}")
        check(math.isfinite(m["loss"]), "timed Tacotron(1) step: loss not finite")
    result["timed"] = out


def conditioned_taco1_steps(result: dict, corpus: str) -> None:
    """(4) A speaker-table and a d-vector + GST Tacotron(1) at full width
    (E = 512 each), bf16 mixed precision: one step each through a Trainer
    on the 4-speaker `corpus` (d-vectors drawn from a seed), the loss and
    the gradient norm finite."""
    import numpy as np
    import torch

    from your_voice_tts_torch.data.formatters import synthetic
    from your_voice_tts_torch.train.trainer import Trainer

    result["conditioned"] = {}
    names = sorted({item[2] for item in synthetic(corpus)})
    rng = np.random.default_rng(3)
    dvecs = {n: (v / np.linalg.norm(v)).astype(np.float32)
             for n, v in zip(names, rng.standard_normal((len(names), SPK_DIM)))}
    b = taco1_batch(2)
    b["speaker_ids"] = np.arange(TRAIN_B, dtype=np.int32) % N_SPK
    for kind in ("table", "dvec+gst"):
        c = taco1_train_cfg(corpus, mixed_precision=True)
        sp = dict(use_speaker_embedding=True)
        if kind == "dvec+gst":
            c = gst_config(c)
            sp.update(use_external_speaker_embedding_file=True, speaker_embedding_dim=SPK_DIM)
        c = dataclasses.replace(c, speakers=dataclasses.replace(c.speakers, **sp))
        trainer = Trainer(c, device="cuda", verbose=False,
                          speaker_embeddings=None if kind == "table" else dvecs)
        kb = dict(b)
        if kind == "dvec+gst":
            kb["speaker_embeddings"] = np.stack([dvecs[names[i]] for i in b["speaker_ids"]])
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        parts, grads = taco1_step(trainer, kb)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        gnorm = float(torch.sqrt(sum((g.float() ** 2).sum() for g in grads)))
        model = trainer.model
        E = model.decoder.attention_rnn.weight_ih.shape[1] - model.cfg.tacotron_width // 2
        print(f"[taco1-train] {kind} (E = {E}, {trainer.num_speakers} speakers, bf16 mixed "
              f"precision): one step {secs:.2f} s (first call), loss {parts['loss']:.4f}, "
              f"gradient norm {gnorm:.4f}")
        check(math.isfinite(parts["loss"]) and math.isfinite(gnorm) and E == 512
              and trainer.num_speakers == N_SPK, f"conditioned Tacotron(1) step {kind}")
        result["conditioned"][kind] = dict(E=E, loss=parts["loss"], grad_norm=gnorm)
        del trainer, model


def phase_taco1_train(report, tmp: str) -> dict:
    """Tacotron(1) training: (1) a full-width step, card against CPU; (3)
    Trainer.fit(max_steps=5) on a 64-item synthetic corpus with the mel and
    linear statistics computed over it and test sentences after each
    evaluation (kernel 8 and the Griffin-Lim kernel the frames route to,
    no plain version), then its checkpoint served by Synthesizer, 250 steps
    a row; (2) the timed step, float32 and mixed precision; (4) one step of
    a speaker-table and a d-vector + GST model at full width; (6) serving
    Tacotron2 with the statistics: the magnitudes entering kernel 2 against
    the CPU's. Returns the launches of kernels 1, 2, 4 and 8 on these paths."""
    import numpy as np
    import torch

    from your_voice_tts_torch.audio import AudioProcessor
    from your_voice_tts_torch.bin.compute_statistics import compute_statistics
    from your_voice_tts_torch.data.formatters import synthetic
    from your_voice_tts_torch.data.synthetic import make_synthetic_corpus
    from your_voice_tts_torch.infer.synthesizer import Synthesizer
    from your_voice_tts_torch.train.trainer import Trainer

    result: dict = {}
    launches = {c.__name__: 0 for c in serve_counters()}
    # the step checks' Trainers read an 8-clip, 4-speaker corpus (the
    # batches themselves are taco1_batch's)
    small = make_synthetic_corpus(os.path.join(tmp, "corpus-step"), n_items=8, sr=22050,
                                  n_speakers=N_SPK)
    hold_taco1_step(result, small)

    # (3) statistics over the corpus, then fit with test sentences
    corpus = make_synthetic_corpus(os.path.join(tmp, "corpus"), n_items=64, sr=22050,
                                   max_words=15)
    t0 = time.perf_counter()
    stats = compute_statistics(taco1_train_cfg(corpus), synthetic(corpus), device="cuda")
    stats_s = time.perf_counter() - t0
    stats_path = os.path.join(tmp, "scale_stats.npy")
    np.save(stats_path, stats, allow_pickle=True)
    print(f"[taco1-train] statistics over {stats['n_frames']} frames of 64 clips in "
          f"{stats_s:.2f} s: mel mean {float(stats['mel_mean'].mean()):.2f} dB, std "
          f"{float(stats['mel_std'].mean()):.2f}; linear mean "
          f"{float(stats['linear_mean'].mean()):.2f}, std {float(stats['linear_std'].mean()):.2f}")
    check(all(np.isfinite(stats[k]).all() and stats[k].shape == (n,) for k, n in
              (("mel_mean", 80), ("mel_std", 80), ("linear_mean", 513), ("linear_std", 513))),
          "statistics")
    cfg = taco1_train_cfg(corpus, stats_path, test_delay_epochs=0)
    run = os.path.join(tmp, "run")
    trainer = Trainer(cfg, output_path=run, device="cuda", verbose=False)
    check(None not in trainer.ap.host_stats.values(),
          "the trainer's audio processor holds no statistics")
    steps, tests = [], []
    step, test_run = trainer.train_step, trainer.test_run
    trainer.train_step = lambda b, r: steps.append(step(b, r)) or steps[-1]
    trainer.test_run = lambda s: tests.append(test_run(s)) or tests[-1]
    counters = serve_counters()
    torch.cuda.synchronize()
    for c in counters:
        c.launches = 0
    with plain_calls() as plain:
        t0 = time.perf_counter()
        trainer.fit(max_steps=5)
        torch.cuda.synchronize()
        fit_s = time.perf_counter() - t0
    fit_launches = {c.__name__: c.launches for c in counters}
    trainer.train_step, trainer.test_run = step, test_run
    routes = gl_routes(tests, trainer.ap)
    frames = [[r["mel_postnet_spec"].shape[1] for r in res] for res in tests]
    ckpts = sorted(f for f in os.listdir(run) if f.endswith(".npz"))
    print(f"[taco1-train] fit(max_steps=5) with statistics and test sentences: {fit_s:.1f} s; "
          f"loss {[round(m['loss'], 4) for m in steps]}, postnet (linear) loss "
          f"{[round(m['postnet_loss'], 4) for m in steps]}, grad_norm "
          f"{[round(m['grad_norm'], 4) for m in steps]}; {len(tests)} test runs, frames a row "
          f"{frames}, Griffin-Lim routes {routes}; launches {fit_launches}; plain versions "
          f"called {plain}; checkpoints {ckpts}")
    check(len(steps) == 5 and all(math.isfinite(m[k]) for m in steps
                                  for k in ("loss", "grad_norm")), "Tacotron(1) fit losses")
    check("checkpoint_5.npz" in ckpts and tests, "Tacotron(1) fit: no checkpoint or test run")
    check(all(np.isfinite(r["wav"]).all() and len(r["wav"]) > 0 for res in tests for r in res),
          "test sentences' waveforms")
    check(fit_launches["tacotron1_decode_cuda"] > 0 and fit_launches["tacotron2_decode_cuda"] == 0
          and all(fit_launches[ROUTE_KERNEL[k]] > 0 for k in routes)
          and all(n == 0 for k, n in fit_launches.items()
                  if k in ROUTE_KERNEL.values() and k not in {ROUTE_KERNEL[r] for r in routes}),
          f"test_run's kernels: {fit_launches}, routes {routes}")
    check(not any(plain.values()), f"a plain version ran in the fit: {plain}")
    for k, n in fit_launches.items():
        launches[k] += n
    result["fit"] = dict(fit_s=fit_s, steps=steps, frames=frames, routes=routes,
                         launches=fit_launches, stats_s=stats_s)
    # (2) the timed step on the same trainer
    time_taco1_steps(trainer, result)
    del trainer
    torch.cuda.empty_cache()

    # the checkpoint served, 250 steps a row
    synth = Synthesizer(dataclasses.replace(cfg, model=dataclasses.replace(
        cfg.model, max_decoder_steps=TACO1_STEPS)), os.path.join(run, "checkpoint_5.npz"),
        device="cuda")
    no_chance_stops(synth.model)
    synth.tts_many(SENTENCES[:1])
    torch.cuda.synchronize()
    for c in counters:
        c.launches = 0
    with plain_calls() as plain:
        t0 = time.perf_counter()
        wavs = synth.tts_many(SENTENCES)
        serve_ms = (time.perf_counter() - t0) * 1e3
    served = {c.__name__: c.launches for c in counters}
    print(f"[taco1-train] the trained checkpoint served (statistics, r = {TACO1_R}, "
          f"{TACO1_STEPS} steps = {TACO1_STEPS * TACO1_R} frames a row): a batch of 8 in "
          f"{serve_ms:.1f} ms; launches {served}; plain versions called {plain}")
    check(len(wavs) == 8 and all(np.isfinite(w).all() and len(w) > 0 for w in wavs),
          "the trained checkpoint's waveforms")
    check(served["tacotron1_decode_cuda"] > 0 and served["gl_iteration_cuda"] > 0
          and not any(plain.values()), "the trained checkpoint's kernels")
    for k, n in served.items():
        launches[k] += n
    result["served"] = dict(batch_ms=serve_ms, launches=served)
    del synth

    conditioned_taco1_steps(result, small)

    # (6) Tacotron2 served with the statistics: the magnitudes entering
    # kernel 2, card against the CPU's from the same normalized mels
    scfg = dataclasses.replace(full_width_config(), audio=dataclasses.replace(
        full_width_config().audio, stats_path=stats_path))
    synth = Synthesizer(scfg, device="cuda")
    no_chance_stops(synth.model)
    synth.tts_many(SENTENCES[:1])
    seen = []
    magnitudes = synth.ap.gl_magnitudes
    synth.ap.gl_magnitudes = lambda kind, spec: seen.append(
        (kind, spec.cpu(), magnitudes(kind, spec))) or seen[-1][2]
    torch.cuda.synchronize()
    for c in counters:
        c.launches = 0
    with plain_calls() as plain:
        wavs = synth.tts_many(SENTENCES)
    stats_launches = {c.__name__: c.launches for c in counters}
    cpu_ap = AudioProcessor(scfg.audio, "cpu")
    errs = []
    for kind, spec, mag in seen:
        ref = cpu_ap.gl_magnitudes(kind, spec)
        errs.append(float((mag.cpu() - ref).abs().max() / ref.abs().max()))
    print(f"[taco1-train] Tacotron2 served with the statistics: {len(seen)} Griffin-Lim calls "
          f"on {[tuple(s.shape) for _, s, _ in seen]}; magnitudes entering the kernel, card "
          f"against CPU, max abs over the largest {max(errs):.3e} (tol 1e-5); launches "
          f"{stats_launches}; plain versions called {plain}")
    check(max(errs) <= 1e-5, "statistics-denormalized magnitudes: card and CPU disagree")
    check(stats_launches["tacotron2_decode_cuda"] > 0 and stats_launches["griffin_lim_wave_cuda"]
          > 0 and not any(plain.values()) and all(np.isfinite(w).all() for w in wavs),
          "Tacotron2 with statistics")
    for k, n in stats_launches.items():
        launches[k] += n
    result["stats_serving"] = dict(mag_err=max(errs), launches=stats_launches)
    result["launches"] = launches
    report["taco1_train"] = result
    return launches


def phase_train_profile(report, trainer, out_dir: str):
    """One train step at the bench shape under torch.profiler."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    batch = bench_batch()
    trainer.train_step(batch, 2)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        trainer.train_step(batch, 2)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    trace = os.path.join(out_dir, "train_profile_trace.json")
    prof.export_chrome_trace(trace)
    rows = device_rows(prof)
    # the scans' dependent launches overlap: busy is the union of the
    # kernels' intervals, not their summed times
    busy_ms, summed_ms, _ = device_busy(trace)
    print(f"[train-profile] one train step: wall {wall_ms:.1f} ms, device busy "
          f"{busy_ms:.1f} ms (idle share {1 - busy_ms / wall_ms:.3f}; kernel times summed "
          f"{summed_ms:.1f} ms)")
    for e in rows[:20]:
        print(f"[train-profile]   {dev(e):8.2f} ms  {e.count:6d} calls  {e.key[:90]}")
    report["train_profile"] = dict(wall_ms=wall_ms, busy_ms=busy_ms, summed_ms=summed_ms,
                                   kernels={e.key: [dev(e), e.count] for e in rows[:40]})


# ------------------------------- Tacotron2 training: the rest of it (7d-7g)

A8_MODELS = {"forward_ta_mask": dict(use_forward_attn=True, transition_agent=True,
                                     forward_attn_mask=True),
             "graves": dict(attention_type="graves")}
CPU_ROWS = 8            # rows of the bench batch the card-against-CPU steps take
A8_TOL = 1e-4           # card against CPU: each loss part (relative), the gradients (rel L2)


def a8_cfg(corpus: str, model: dict | None = None, **training):
    """train_config() (configs/ljspeech_tacotron2.json at full width, r = 2,
    batch 32, gradual training off) reading `corpus`, with the model fields
    `model` and the training fields `training` set."""
    cfg = train_config()
    ds = dataclasses.replace(cfg.data.datasets[0], name="synthetic", path=corpus)
    return dataclasses.replace(cfg, data=dataclasses.replace(cfg.data, datasets=(ds,)),
                               model=dataclasses.replace(cfg.model, **(model or {})),
                               training=dataclasses.replace(cfg.training, **training))


def train_counters():
    """Kernels 5 and 6's wrappers."""
    from your_voice_tts_torch.ops.taco2_train import taco2_train_bwd_cuda, taco2_train_fwd_cuda

    return taco2_train_fwd_cuda, taco2_train_bwd_cuda


def scans(launches: dict, T_r: int) -> tuple[float, float]:
    """(forward scans, backward scans) in kernel 5's and 6's launches: a
    forward scan launches 2 T_r + 1 times, a backward scan 4 T_r."""
    return (launches["taco2_train_fwd_cuda"] / (2 * T_r + 1),
            launches["taco2_train_bwd_cuda"] / (4 * T_r))


def card_vs_cpu_step(tag: str, cfg, batch: dict) -> dict:
    """One Trainer.train_step (its micro-batches where grad_accum_steps > 1)
    on a float32 Trainer on each device, the CPU one's weights loaded into
    the card's, the same batch, dropout off (no generator), TF32 off: the
    loss parts and gradient norm it returns, each within A8_TOL relative,
    and the gradients it hands to the optimizer's one update, within A8_TOL
    rel L2 over all leaves. Returns the readings and the card step's
    launches of kernels 5 and 6."""
    import torch

    from your_voice_tts_torch.train.trainer import Trainer

    cfg = dataclasses.replace(cfg, training=dataclasses.replace(cfg.training,
                                                                mixed_precision=False))
    trainers = {"cpu": Trainer(cfg, device="cpu", verbose=False),
                "cuda": Trainer(cfg, device="cuda", verbose=False)}
    trainers["cuda"].model.load_state_dict(trainers["cpu"].model.state_dict())
    got, secs, launches = {}, {}, {}
    for dev, t in trainers.items():
        t.generator = None
        seen: dict = {}
        step = t.optimizer.step

        def keep(grads, _step=step, _seen=seen):
            _seen["grads"] = [g.detach().double().cpu() for g in grads]
            return _step(grads)

        t.optimizer.step = keep
        if dev == "cuda":
            torch.cuda.synchronize()
            for c in train_counters():
                c.launches = 0
        t0 = time.perf_counter()
        metrics = t.train_step(batch, 2)
        if dev == "cuda":
            torch.cuda.synchronize()
            launches = {c.__name__: c.launches for c in train_counters()}
        secs[dev] = time.perf_counter() - t0
        got[dev] = metrics, seen["grads"]
    names = [n for n, p in trainers["cpu"].model.named_parameters() if p.requires_grad]
    del trainers
    (mc, gc), (mk, gk) = got["cpu"], got["cuda"]
    rel = {k: abs(mk[k] - v) / max(abs(v), 1e-30) for k, v in mc.items()}
    cat = lambda gs: torch.cat([g.flatten() for g in gs])  # noqa: E731
    glob = float((cat(gk) - cat(gc)).norm() / cat(gc).norm())
    leaf = {n: float((a - c).norm() / c.norm().clamp_min(1e-30)) for n, a, c in zip(names, gk, gc)}
    worst = max(leaf, key=leaf.get)
    T_r = batch["mel"].shape[1] // 2
    print(f"[{tag}] one step at full width (B={batch['mel'].shape[0]}, T_text="
          f"{batch['text'].shape[1]}, T_mel={batch['mel'].shape[1]}, {T_r} decoder steps, "
          f"float32, dropout off), card against CPU: loss parts card "
          f"{ {k: round(v, 6) for k, v in mk.items()} }; rel "
          + ", ".join(f"{k} {v:.2e}" for k, v in rel.items()) + f" (tol {A8_TOL}); all "
          f"gradients rel L2 {glob:.3e} (tol {A8_TOL}), largest leaf rel L2 {leaf[worst]:.3e} "
          f"({worst}); kernel 5 / 6 scans on the card {scans(launches, T_r)} (launches "
          f"{launches}); CPU step {secs['cpu']:.1f} s, card {secs['cuda']:.2f} s (first call)")
    check(max(rel.values()) <= A8_TOL and glob <= A8_TOL, f"{tag}: card and CPU steps disagree")
    return dict(parts_card=mk, parts_cpu=mc, parts_rel=rel, grad_rel_l2=glob, worst_leaf=worst,
                worst_leaf_rel_l2=leaf[worst], launches=launches, scans=scans(launches, T_r),
                cpu_s=secs["cpu"], card_s=secs["cuda"])


def timed_steps(tag: str, trainer, batch: dict, reps: int = 3, r: int = 2) -> dict:
    """Trainer.train_step on `batch` (the Trainer's precision, dropout on):
    one warm step, then `reps` steps timed by CUDA events (median) and the
    host clock, the peak memory allocated over them
    (torch.cuda.max_memory_allocated after a reset) and that peak less
    what was allocated before them (parameters, optimizer state: the
    step's own memory), kernel 5's and 6's scans a step (`launches`
    counts the timed steps'); then one more step under torch.profiler: the
    device's busy ms (the union of its kernels' intervals), its kernels."""
    import gc

    import torch
    from torch.profiler import ProfilerActivity, profile

    trainer.train_step(batch, r)
    gc.collect()                    # Trainers of earlier readings, not yet collected
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated() / 2 ** 30
    torch.cuda.reset_peak_memory_stats()
    for c in train_counters():
        c.launches = 0
    ev, wall = [], []
    for _ in range(reps):
        s, e = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        t0 = time.perf_counter()
        s.record()
        m = trainer.train_step(batch, r)            # ends in a host read of the metrics
        e.record()
        e.synchronize()
        wall.append((time.perf_counter() - t0) * 1e3)
        ev.append(s.elapsed_time(e))
    launches = {c.__name__: c.launches for c in train_counters()}
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    with tempfile.TemporaryDirectory() as tmp:
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            trainer.train_step(batch, r)
            torch.cuda.synchronize()
            pwall = (time.perf_counter() - t0) * 1e3
        trace = os.path.join(tmp, "trace.json")
        prof.export_chrome_trace(trace)
        busy, _, n_k = device_busy(trace)
    per_step = {k: n / reps for k, n in launches.items()}
    out = dict(step_ms=statistics.median(ev), step_ms_all=ev, wall_ms=statistics.median(wall),
               peak_gib=peak, step_gib=peak - base, launches=launches,
               scans=scans(per_step, batch["mel"].shape[1] // r), loss=m["loss"],
               profiled_wall_ms=pwall, busy_ms=busy, busy_share=busy / pwall, kernels=n_k)
    print(f"[{tag}] timed step (B={batch['mel'].shape[0]}, T_mel={batch['mel'].shape[1]}, "
          f"{'bf16 mixed precision' if trainer.cfg.training.mixed_precision else 'float32'}, "
          f"dropout on): {out['step_ms']:.1f} ms (CUDA events, median of {reps}; all "
          f"{', '.join(f'{x:.1f}' for x in ev)}), wall {out['wall_ms']:.1f} ms; peak memory "
          f"allocated {peak:.3f} GiB, {peak - base:.3f} of it the step's own; kernel 5 / 6 "
          f"scans a step {out['scans']}; profiled step {pwall:.1f} ms, device busy "
          f"{busy:.1f} ms (busy share {busy / pwall:.3f}, {n_k} kernels); loss {m['loss']:.4f}")
    check(math.isfinite(m["loss"]), f"{tag}: timed step loss not finite")
    return out


def phase_train_variants(report, corpus: str) -> dict:
    """7d. Tacotron2 on the attention variants (forward attention with the
    agent and the forward mask; Graves, K = 4) at full width, each on the
    step loop (the JAX package's scan route): (a) one step card against
    CPU on CPU_ROWS rows of the bench batch, kernels 5 and 6 not launched;
    (b) Trainer.fit(max_steps=2) with the test sentences after its
    evaluation: kernel 1 (the variant's branch) and the Griffin-Lim kernel
    the frames route to launched, no plain version, no training kernel;
    (c) the timed step on the bench batch (mixed precision). Returns the
    decode's and Griffin-Lim's launches."""
    import torch

    from your_voice_tts_torch.train.trainer import Trainer

    bench = bench_batch()
    small = {k: v[:CPU_ROWS] for k, v in bench.items()}
    launches = {c.__name__: 0 for c in serve_counters()}
    out: dict = {}
    for name, flags in A8_MODELS.items():
        tag = f"train-variants {name}"
        step = card_vs_cpu_step(tag, a8_cfg(corpus, flags), small)
        check(not any(step["launches"].values()), f"{tag}: a training kernel launched")
        trainer = Trainer(a8_cfg(corpus, flags), device="cuda", verbose=False)
        check(not trainer.model.decoder.fast_grad_supported(), f"{tag}: not on the step loop")
        tests: list = []
        test_run = trainer.test_run
        trainer.test_run = lambda s, _run=test_run: tests.append(_run(s)) or tests[-1]
        torch.cuda.synchronize()
        for c in train_counters() + serve_counters():
            c.launches = 0
        with plain_calls() as plain:
            t0 = time.perf_counter()
            metrics = trainer.fit(max_steps=2)
            torch.cuda.synchronize()
            fit_s = time.perf_counter() - t0
        fit_train = {c.__name__: c.launches for c in train_counters()}
        fit_serve = {c.__name__: c.launches for c in serve_counters()}
        trainer.test_run = test_run
        routes = gl_routes(tests, trainer.ap)
        print(f"[{tag}] fit(max_steps=2): {fit_s:.1f} s, loss {metrics.get('loss')}; test "
              f"sentences {len(tests)} runs, frames a row "
              f"{[[r['mel_postnet_spec'].shape[1] for r in res] for res in tests]}, Griffin-Lim "
              f"routes {routes}; launches {fit_serve}, training kernels {fit_train}; plain "
              f"versions called {plain}")
        check(tests and fit_serve["tacotron2_decode_cuda"] > 0
              and all(fit_serve[ROUTE_KERNEL[k]] > 0 for k in routes)
              and not any(plain.values()) and not any(fit_train.values())
              and math.isfinite(metrics["loss"]), f"{tag}: the fit or its test sentences")
        for k, n in fit_serve.items():
            launches[k] += n
        timed = timed_steps(tag, trainer, bench)
        check(not any(timed["launches"].values()), f"{tag}: a training kernel launched")
        out[name] = dict(step=step, fit_s=fit_s, fit_launches=fit_serve, test_routes=routes,
                         timed=timed)
        del trainer
    report["train_variants"] = out
    return launches


def phase_train_bd(report, corpus: str) -> dict:
    """7e. The bidirectional decoder at full width on kernels 5 and 6: (a)
    one step card against CPU (CPU_ROWS rows), two forward and two backward
    scans; (b) the timed step on the bench batch (mixed precision) beside
    the same model's without the backward decoder. Returns kernels 5 and
    6's launches."""
    from your_voice_tts_torch.train.trainer import Trainer

    bench = bench_batch()
    step = card_vs_cpu_step("train-bd", a8_cfg(corpus, {"bidirectional_decoder": True}),
                            {k: v[:CPU_ROWS] for k, v in bench.items()})
    check(step["scans"] == (2.0, 2.0), "train-bd: not two scans each way a step")
    timed = {}
    for bd in (True, False):
        trainer = Trainer(a8_cfg(corpus, {"bidirectional_decoder": bd}), device="cuda",
                          verbose=False)
        timed[bd] = timed_steps(f"train-bd {'with' if bd else 'without'} the backward decoder",
                                trainer, bench)
        del trainer
    check(timed[True]["scans"] == (2.0, 2.0) and timed[False]["scans"] == (1.0, 1.0),
          "train-bd: scans a timed step")
    print(f"[train-bd] step {timed[True]['step_ms']:.1f} ms with the backward decoder, "
          f"{timed[False]['step_ms']:.1f} ms without (x{timed[True]['step_ms'] / timed[False]['step_ms']:.2f})")
    report["train_bd"] = dict(step=step, timed_bd=timed[True], timed_plain=timed[False])
    return {k: step["launches"][k] + timed[True]["launches"][k] + timed[False]["launches"][k]
            for k in step["launches"]}


def phase_train_accum(report, corpus: str) -> dict:
    """7f. Gradient accumulation at full width: (a) an A = 2 step card
    against CPU (CPU_ROWS rows, two micro-batches of 4), one forward and
    one backward scan a micro-batch; (b) config #3's batch (B = 32, mixed
    precision) at A = 1 and A = 2, and the same rows four times over
    (B = 128, where the step's own memory outweighs the parameters and
    optimizer state): step time and peak memory allocated. Returns kernels
    5 and 6's launches."""
    import numpy as np

    from your_voice_tts_torch.train.trainer import Trainer

    bench = bench_batch()
    step = card_vs_cpu_step("train-accum", a8_cfg(corpus, grad_accum_steps=2),
                            {k: v[:CPU_ROWS] for k, v in bench.items()})
    check(step["scans"] == (2.0, 2.0), "train-accum: not one scan each way a micro-batch")
    launches = dict(step["launches"])
    timed: dict = {}
    for B, batch in ((TRAIN_B, bench), (4 * TRAIN_B, {k: np.concatenate([v] * 4)
                                                      for k, v in bench.items()})):
        for A in (1, 2):
            trainer = Trainer(a8_cfg(corpus, grad_accum_steps=A, batch_size=B), device="cuda",
                              verbose=False)
            t = timed[f"B={B} A={A}"] = timed_steps(f"train-accum B = {B}, A = {A}", trainer,
                                                    batch)
            del trainer
            check(t["scans"] == (float(A), float(A)), f"train-accum: scans a step at A = {A}")
            for k, n in t["launches"].items():
                launches[k] += n
        one, two = timed[f"B={B} A=1"], timed[f"B={B} A=2"]
        print(f"[train-accum] B = {B}: A = 1 {one['step_ms']:.1f} ms, peak {one['peak_gib']:.3f} "
              f"GiB ({one['step_gib']:.3f} the step's own); A = 2 {two['step_ms']:.1f} ms "
              f"(x{two['step_ms'] / one['step_ms']:.2f}), peak {two['peak_gib']:.3f} GiB "
              f"({two['step_gib']:.3f}; x{two['step_gib'] / one['step_gib']:.2f})")
    report["train_accum"] = dict(step=step, timed=timed)
    return launches


def phase_mel_oracle(report) -> None:
    """7g. The mel parity gate (BASELINE.json: <= 1e-3 max abs) on the card:
    AudioProcessor.melspectrogram on CUDA against oracle/audio_ref.py's
    float64 numpy AudioProcessorRef, for configs/ljspeech_tacotron2.json,
    ljspeech_tacotron2_b384.json and smoke_synthetic.json, on a seeded
    speech-like signal (`style_wav`) at each config's sample rate."""
    import numpy as np

    from oracle.audio_ref import AudioProcessorRef
    from your_voice_tts_torch.audio import AudioProcessor
    from your_voice_tts_torch.config import load_config

    out = {}
    for name in ("ljspeech_tacotron2.json", "ljspeech_tacotron2_b384.json",
                 "smoke_synthetic.json"):
        c = load_config(os.path.join(ROOT, "configs", name)).audio
        hop, win = c.resolved_hop_win()
        ref_ap = AudioProcessorRef(
            sample_rate=c.sample_rate, num_mels=c.num_mels, fft_size=c.fft_size,
            hop_length=hop, win_length=win, preemphasis=c.preemphasis,
            ref_level_db=c.ref_level_db, min_level_db=c.min_level_db, power=c.power,
            signal_norm=c.signal_norm, symmetric_norm=c.symmetric_norm, max_norm=c.max_norm,
            clip_norm=c.clip_norm, mel_fmin=c.mel_fmin, mel_fmax=c.mel_fmax,
            spec_gain=c.spec_gain)
        y = style_wav(c.sample_rate, seed=11)
        got = AudioProcessor(c, "cuda").melspectrogram(y)
        ref = ref_ap.melspectrogram(y.astype(np.float64))
        check(got.shape == ref.shape, f"mel-oracle {name}: shape {got.shape} vs {ref.shape}")
        out[name] = float(np.max(np.abs(got - ref)))
        print(f"[mel-oracle] {name}: mel {got.shape} on the card against the oracle, max abs "
              f"{out[name]:.3e} (gate 1e-3)")
        check(out[name] <= 1e-3, f"mel-oracle {name}: over the gate")
    report["mel_oracle"] = out


# ------------------------- Tacotron(1) variants, vocoder training, the profiler

T1_VARIANTS = {"graves": dict(attention_type="graves", attention_heads=4),
               "forward_ta_mask_window": dict(use_forward_attn=True, transition_agent=True,
                                              forward_attn_mask=True, windowing=True)}


def taco1_variant_cfg(flags: dict, corpus: str | None = None, **training):
    """taco1_train_cfg() (width 256, memory 5, r = 7, batch 32) with the
    model fields `flags` set."""
    cfg = taco1_train_cfg(corpus, **training)
    return dataclasses.replace(cfg, model=dataclasses.replace(cfg.model, **flags))


def hold_step_loop_route(report) -> dict:
    """The step loop's own check on the card: the taco1-decode phase's
    location-sensitive model (seeded random weights, the 8 sentences, 250
    steps of r = 7, prenet dropout on, seed 7), its decoder forced onto the
    step loop, against kernel 8's plain version on the same card inputs
    with float32 weights: frames, alignments and stop probabilities max
    abs (tol 1e-4), lengths equal."""
    import torch

    from your_voice_tts_torch.infer.synthesis import _pad_texts, text_to_seq
    from your_voice_tts_torch.models import setup_model
    from your_voice_tts_torch.models.common import sequence_mask
    from your_voice_tts_torch.ops.taco1_decode import tacotron1_decode_plain
    from your_voice_tts_torch.text import symbols

    cfg = taco1_config()
    model = no_chance_stops(setup_model(len(symbols), cfg, device="cuda"))
    text, lengths = _pad_texts([text_to_seq(t, cfg) for t in SENTENCES])
    text, lengths = torch.as_tensor(text).cuda(), torch.as_tensor(lengths).cuda()
    dec = model.decoder
    with torch.no_grad():
        enc = model._encode(text)
        pinp = dec.attention.preprocess_inputs(enc)
        B, T = text.shape
        t0 = time.perf_counter()
        out, al, st, ln = tacotron1_decode_plain(
            dec.decode_weights(torch.float32), enc, pinp, sequence_mask(lengths, T), r=TACO1_R,
            max_steps=TACO1_STEPS, norm=dec.attention.norm, thresh=cfg.model.stop_threshold,
            prenet_dropout=True, seed=7)
        plain_s = time.perf_counter() - t0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        got = dec._decode_loop(enc, lengths, TACO1_STEPS, TACO1_R, seed=7)
        torch.cuda.synchronize()
        loop_s = time.perf_counter() - t0
    ref = (out[..., :cfg.audio.num_mels * TACO1_R], al, st)
    errs = [float((a - b).abs().max()) for a, b in zip(got[:3], ref)]
    same_len = bool(torch.equal(got[3], ln))
    print(f"[taco1-variants] the step loop forced onto the location config against kernel "
          f"8's plain version on the card (B={B}, T={T}, {TACO1_STEPS} steps of r = {TACO1_R}, "
          f"float32, dropout on, seed 7): max abs frames {errs[0]:.3e}, alignments "
          f"{errs[1]:.3e}, stop probabilities {errs[2]:.3e} (tol 1e-4), lengths equal "
          f"{same_len}; step loop {loop_s:.2f} s, plain version {plain_s:.2f} s")
    check(max(errs) <= 1e-4 and same_len, "step loop and kernel 8's plain version disagree")
    return dict(max_abs=errs, loop_s=loop_s, plain_s=plain_s)


def serve_taco1_variant(tag: str, cfg) -> dict:
    """A Tacotron(1) Synthesizer on the step loop (seeded random weights,
    no row stops by chance): one set-up call, then the batch of 8 and 5
    batch-1 requests through tts_many with every serving counter set to 0
    just before and read just after, and every plain version counted."""
    import numpy as np
    import torch

    from your_voice_tts_torch.infer.synthesizer import Synthesizer

    synth = Synthesizer(cfg, device="cuda")
    no_chance_stops(synth.model)
    check(not synth.model.decoder.kernel_supported(), f"{tag}: not on the step loop")
    synth.tts_many(SENTENCES[:1])
    torch.cuda.synchronize()
    for c in serve_counters():
        c.launches = 0
    with plain_calls() as plain:
        batch, t_batch, lat, ones = serve_requests(synth)
    seen = {c.__name__: c.launches for c in serve_counters()}
    frames = TACO1_STEPS * TACO1_R * len(SENTENCES)
    decoded_s = frames * synth.ap.hop_length / synth.ap.sample_rate
    p50 = statistics.median(lat)
    calls, iters = 1 + len(lat), synth.cfg.audio.griffin_lim_iters
    print(f"[{tag}] batch of 8 ({TACO1_STEPS * TACO1_R} frames a row): {t_batch * 1e3:.1f} ms, "
          f"{frames / t_batch:.0f} mel frames/s, real-time factor {decoded_s / t_batch:.1f}x "
          f"over the {decoded_s:.2f} s decoded; batch-1 p50 {p50 * 1e3:.1f} ms (all: "
          f"{', '.join(f'{x * 1e3:.1f}' for x in lat)} ms); launches {seen}; plain versions "
          f"called {plain}")
    check(all(w.ndim == 1 and len(w) > 0 and bool(np.isfinite(w).all()) for w in batch + ones)
          and seen["tacotron1_decode_cuda"] == 0 and seen["tacotron2_decode_cuda"] == 0
          and seen["gl_iteration_cuda"] == calls * 3 * iters and not any(plain.values()),
          f"{tag}: the step loop's serving path")
    out = dict(batch_ms=t_batch * 1e3, mel_frames_per_s=frames / t_batch,
               rtf_x_realtime=decoded_s / t_batch, p50_batch1_ms=p50 * 1e3,
               batch1_ms=[x * 1e3 for x in lat], launches=seen)
    del synth
    return out


def taco1_card_vs_cpu(tag: str, cfg, batch: dict) -> dict:
    """One teacher-forced step (the Trainer's `_loss_fn`, dropout off) of a
    float32 Tacotron(1) Trainer on each device, the CPU one's weights in
    the card's, TF32 off: each loss part within A8_TOL relative, all
    gradients within A8_TOL rel L2."""
    import torch

    from your_voice_tts_torch.train.trainer import Trainer

    cfg = dataclasses.replace(cfg, training=dataclasses.replace(cfg.training,
                                                                mixed_precision=False))
    trainers = {"cpu": Trainer(cfg, device="cpu", verbose=False),
                "cuda": Trainer(cfg, device="cuda", verbose=False)}
    trainers["cuda"].model.load_state_dict(trainers["cpu"].model.state_dict())
    check(not trainers["cuda"].model.decoder.kernel_supported(), f"{tag}: not on the step loop")
    got, secs = {}, {}
    for dev in ("cuda", "cpu"):
        t0 = time.perf_counter()
        got[dev] = taco1_step(trainers[dev], batch)
        secs[dev] = time.perf_counter() - t0
    del trainers
    (pc, gc), (pk, gk) = got["cpu"], got["cuda"]
    rel = {k: abs(pk[k] - v) / max(abs(v), 1e-30) for k, v in pc.items()}
    cat = lambda gs: torch.cat([g.double().flatten().cpu() for g in gs])  # noqa: E731
    glob = float((cat(gk) - cat(gc)).norm() / cat(gc).norm())
    print(f"[{tag}] one step at full width (B={batch['mel'].shape[0]}, T_text="
          f"{batch['text'].shape[1]}, T_mel={batch['mel'].shape[1]}, "
          f"{batch['mel'].shape[1] // TACO1_R} steps of r = {TACO1_R}, float32, dropout off), "
          f"card against CPU: loss parts rel " + ", ".join(f"{k} {v:.2e}" for k, v in rel.items())
          + f" (tol {A8_TOL}); all gradients rel L2 {glob:.3e} (tol {A8_TOL}); CPU "
          f"{secs['cpu']:.1f} s, card {secs['cuda']:.2f} s (first call)")
    check(max(rel.values()) <= A8_TOL and glob <= A8_TOL, f"{tag}: card and CPU disagree")
    return dict(parts_card=pk, parts_rel=rel, grad_rel_l2=glob, cpu_s=secs["cpu"],
                card_s=secs["cuda"])


def phase_taco1_variants(report, corpus: str) -> dict:
    """7h. Tacotron(1) at full width (width 256, memory 5, r = 7) with
    Graves (K = 4) and with forward_ta_mask + windowing, on the step loop:
    (a) the route's own check (`hold_step_loop_route`); for each variant
    (b) the batch of 8 and 5 batch-1 requests through tts_many, kernel 8
    never launched, kernel 4 a call; (c) one step card against CPU on
    CPU_ROWS rows of config #3's batch; (d) the timed mixed-precision step
    on the whole batch (B = 32, 128 symbols, 406 frames). Returns the
    serving launches."""
    from your_voice_tts_torch.train.trainer import Trainer

    out = {"route": hold_step_loop_route(report)}
    launches = {c.__name__: 0 for c in serve_counters()}
    bench = taco1_batch()
    for name, flags in T1_VARIANTS.items():
        tag = f"taco1-variants {name}"
        served = serve_taco1_variant(tag, dataclasses.replace(
            taco1_config(), model=dataclasses.replace(taco1_config().model, **flags)))
        for k, n in served["launches"].items():
            launches[k] += n
        step = taco1_card_vs_cpu(tag, taco1_variant_cfg(flags, corpus),
                                 {k: v[:CPU_ROWS] for k, v in bench.items()})
        trainer = Trainer(taco1_variant_cfg(flags, corpus, mixed_precision=True),
                          device="cuda", verbose=False)
        timed = timed_steps(tag, trainer, bench, r=TACO1_R)
        check(not any(timed["launches"].values()), f"{tag}: a training kernel launched")
        del trainer
        out[name] = dict(serve=served, step=step, timed=timed)
    report["taco1_variants"] = out
    return launches


VOC_MODELS = ("melgan", "pwgan", "wavernn", "wavernn-mol", "wavernn-gauss")
VOC_B, VOC_SEQ = 32, 8192


def voc_cfg(name: str, **training):
    """VocoderConfig's defaults, the reference's full widths at 22,050 Hz,
    80 mels, hop 256 (MelGAN base 512, factors 8 8 2 2, 3 scales, disc 16;
    PWGAN 30 layers in 3 stacks, 64 / 128 / 64, factors 4 4 4 4; WaveRNN
    512 / 512, factors 4 8 8, 10-bit mu-law or its MoL / Gaussian head) for
    `name` ("wavernn-mol": mode mol), B = 32 x 8,192 samples, the
    discriminator from step 1 (a cut in depth: the reference's 200,000)."""
    from your_voice_tts_torch.vocoder.config import VocoderConfig

    model, _, mode = name.partition("-")
    cfg = VocoderConfig(model=model)
    cfg = dataclasses.replace(cfg, training=dataclasses.replace(
        cfg.training, **{"batch_size": VOC_B, "seq_len": VOC_SEQ,
                         "steps_to_start_discriminator": 1, **training}))
    if mode:
        cfg = dataclasses.replace(cfg, wavernn=dataclasses.replace(cfg.wavernn, mode=mode))
    return cfg


def voc_trainer(cfg, items, device):
    from your_voice_tts_torch.vocoder.train_gan import GANTrainer
    from your_voice_tts_torch.vocoder.train_wavernn import WaveRNNTrainer

    return (WaveRNNTrainer if cfg.model == "wavernn" else GANTrainer)(
        cfg, items, verbose=False, device=device)


def voc_nets(trainer) -> list:
    return [trainer.model] if hasattr(trainer, "model") else [trainer.generator,
                                                              trainer.discriminator]


def voc_step_grads(trainer, mel, audio, noise, g_state=None) -> tuple[dict, list, dict]:
    """One train_step (the discriminator's too) recording the gradients
    each optimizer is handed: (metrics, [gradients], the generator's
    weights as the discriminator step starts). A GAN's discriminator step
    regenerates its fake with the updated generator; given `g_state` (the
    CPU step's), the generator takes those weights as that step starts,
    so that every device's discriminator step sees the same generator (the
    generator's first Adam update amplifies its gradients' last bits where
    they are near Adam's eps)."""
    import torch

    seen: list = []
    opts = [trainer.optimizer] if hasattr(trainer, "model") else [trainer.g_opt, trainer.d_opt]
    saved = [o.step for o in opts]
    for o, step in zip(opts, saved):
        o.step = lambda g, _s=step: seen.extend(x.detach().double().cpu() for x in g) or _s(g)
    at_d: dict = {}
    if hasattr(trainer, "model"):
        metrics = {"loss": trainer.train_step(mel, audio)}
    else:
        d_loss = trainer.d_loss

        def same_generator(*a, **k):
            gen = trainer.generator
            at_d.update({n: t.detach().cpu().clone() for n, t in gen.state_dict().items()})
            if g_state is not None:
                with torch.no_grad():
                    for n, t in gen.state_dict().items():
                        t.copy_(g_state[n])
            return d_loss(*a, **k)

        trainer.d_loss = same_generator
        metrics = trainer.train_step(mel, audio, noise=noise)
        del trainer.d_loss
    for o, step in zip(opts, saved):
        o.step = step
    return metrics, seen, at_d


def voc_card_vs_cpu(name: str, items) -> dict:
    """One step of `name`'s trainer on 2 rows in float32 (WaveRNN's of 2,048
    samples, the GANs' of 8,192), card against CPU
    from the same weights on the same batch (PWGAN's noise injected, one
    draw a side), TF32 off: each metric within A8_TOL relative; the
    gradients within A8_TOL rel L2 for WaveRNN. A GAN's step reaches its
    STFT loss, whose L1 of log-magnitudes is ill-conditioned in float32
    (1/|X| at spectral nulls): its gradients are held against the CPU's
    float64 step (the networks and the losses in float64), the card's no
    farther from it than max(A8_TOL, 2 x the CPU float32 step's distance);
    each device's discriminator step starts from the CPU step's updated
    generator (`voc_step_grads`). Beside it, not gated, a second card
    trainer's discriminator step from its own updated generator is read
    against the CPU's from its own."""
    import copy

    import numpy as np
    import torch

    # WaveRNN's two 512-wide GRUs take ~15 s a step on the CPU over 8,192
    # samples: its comparison runs on 2,048 (a cut in depth, not in width)
    seq = VOC_SEQ // 4 if name.startswith("wavernn") else VOC_SEQ
    cfg = voc_cfg(name, batch_size=2, seq_len=seq, mixed_precision=False,
                  steps_to_start_discriminator=0)
    cpu, card = voc_trainer(cfg, items, "cpu"), voc_trainer(cfg, items, "cuda")
    own = voc_trainer(cfg, items, "cuda") if cfg.model != "wavernn" else None
    for a, b in zip(voc_nets(cpu), voc_nets(card)):
        b.load_state_dict(a.state_dict())
    for a, b in zip(voc_nets(cpu), voc_nets(own) if own else []):
        b.load_state_dict(a.state_dict())
    mel, audio = cpu.dataset.sample_batch(2, np.random.default_rng(0))
    g = np.random.default_rng(1)
    noise = tuple(torch.from_numpy(g.standard_normal(audio.shape).astype(np.float32))
                  for _ in range(2))
    runs = {}
    f64 = None
    if cfg.model != "wavernn":
        f64 = copy.deepcopy(cpu)
        for n in voc_nets(f64):
            n.double()
        f64.dtype = torch.float64
    t0 = time.perf_counter()
    runs["cpu"] = voc_step_grads(cpu, mel, audio, noise)
    cpu_s = time.perf_counter() - t0
    g_state = runs["cpu"][2] or None
    t0 = time.perf_counter()
    runs["cuda"] = voc_step_grads(card, mel, audio, tuple(x.cuda() for x in noise), g_state)
    card_s = time.perf_counter() - t0
    if f64 is not None:
        runs["f64"] = voc_step_grads(f64, mel, audio, tuple(x.double() for x in noise), g_state)
    (mc, gc, _), (mk, gk, _) = runs["cpu"], runs["cuda"]
    rel = {k: abs(mk[k] - v) / max(abs(v), 1e-30) for k, v in mc.items()}
    cat = lambda gs: torch.cat([x.flatten() for x in gs])  # noqa: E731
    dist = lambda a, b: float((cat(a) - cat(b)).norm() / cat(b).norm())  # noqa: E731
    glob = dist(gk, gc)
    msg = (f"[vocoder-train] {name}: one step on 2 x {seq} samples, float32, card against "
           f"CPU: metrics rel " + ", ".join(f"{k} {v:.2e}" for k, v in rel.items())
           + f" (tol {A8_TOL}); gradients rel L2 {glob:.3e}")
    out = dict(metrics_rel=rel, grad_rel_l2=glob, cpu_s=cpu_s, card_s=card_s)
    if f64 is None:
        print(msg + f" (tol {A8_TOL}); CPU {cpu_s:.1f} s, card {card_s:.2f} s")
        check(max(rel.values()) <= A8_TOL and glob <= A8_TOL, f"{name}: card and CPU disagree")
        return out
    g64 = runs["f64"][1]
    card64, cpu64 = dist(gk, g64), dist(gc, g64)
    gate = max(A8_TOL, 2 * cpu64)
    # not gated: the card's discriminator step from the card's own updated
    # generator, against the CPU's from its own, what the shared generator
    # keeps out of the gated reading (the generator's first Adam update
    # moves a weight by lr * sign(g) where g is near Adam's eps)
    mo, go_, _ = voc_step_grads(own, mel, audio, tuple(x.cuda() for x in noise))
    n_g = len(cpu.g_params)
    own_d = dict(disc_loss_rel=abs(mo["disc_loss"] - mc["disc_loss"]) / abs(mc["disc_loss"]),
                 d_grad_rel_l2=dist(go_[n_g:], gc[n_g:]),
                 g_grad_rel_l2=dist(go_[:n_g], gc[:n_g]))
    print(msg + f"; against the CPU's float64 step: card {card64:.3e}, CPU float32 "
          f"{cpu64:.3e} (tol max({A8_TOL}, 2 x the CPU's) = {gate:.3e}); CPU {cpu_s:.1f} s, "
          f"card {card_s:.2f} s; not gated, each device's discriminator step from its own "
          f"updated generator: disc_loss rel {own_d['disc_loss_rel']:.3e}, the discriminator's "
          f"gradients rel L2 {own_d['d_grad_rel_l2']:.3e} (the generator's "
          f"{own_d['g_grad_rel_l2']:.3e})")
    check(max(rel.values()) <= A8_TOL and card64 <= gate, f"{name}: card and CPU disagree")
    out.update(card_vs_f64=card64, cpu_vs_f64=cpu64, own_generator=own_d)
    return out


def time_voc_steps(name: str, items) -> tuple[dict, object]:
    """`name`'s trainer at B = 32 x 8,192 samples on the card (GANs float32,
    their default; WaveRNN bf16 mixed precision, its default): CUDA events
    a step, the median of 3 after one warm step; a GAN's generator-only
    steps (before the discriminator's start, here 4) and G + D steps
    apart; the peak memory allocated over the timed steps. Returns the
    readings and the trainer."""
    import numpy as np
    import torch

    wavernn = name.startswith("wavernn")
    cfg = voc_cfg(name, **({} if wavernn else {"steps_to_start_discriminator": 4}))
    trainer = voc_trainer(cfg, items, "cuda")
    mel, audio = trainer.dataset.sample_batch(VOC_B, np.random.default_rng(3))

    def step():
        return (trainer.train_step(mel, audio) if wavernn
                else trainer.train_step(mel, audio, seed=trainer.step))

    out = {}
    for phase in (("step",) if wavernn else ("g_only", "g_d")):
        step()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        ev = []
        for _ in range(3):
            s, e = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            s.record()
            m = step()                              # ends in a host read of the metrics
            e.record()
            e.synchronize()
            ev.append(s.elapsed_time(e))
        m = m if isinstance(m, dict) else {"loss": m}
        out[phase] = dict(step_ms=statistics.median(ev), step_ms_all=ev,
                          peak_gib=torch.cuda.max_memory_allocated() / 2 ** 30, metrics=m)
        check(all(math.isfinite(v) for v in m.values()), f"{name} {phase}: a loss not finite")
        check(("disc_loss" in m) == (phase == "g_d"), f"{name} {phase}: the wrong steps ran")
    print(f"[vocoder-train] {name} at B={VOC_B} x {VOC_SEQ} samples "
          f"({'bf16 mixed precision' if wavernn else 'float32'}): " + "; ".join(
              f"{k} {v['step_ms']:.1f} ms a step (CUDA events, median of 3; all "
              f"{', '.join(f'{x:.1f}' for x in v['step_ms_all'])}), peak {v['peak_gib']:.3f} GiB"
              for k, v in out.items()) + f"; last metrics {m}")
    return out, trainer


def serve_trained_vocoder(name: str, trainer, tmp: str) -> dict:
    """The trainer's checkpoint through VocoderSynthesizer on the card: a
    120-frame mel -> waveform, finite, 120 x 256 samples; WaveRNN's
    mu-law model launches kernel 7, which is held against its plain
    version on a short mel (the first 512 steps of a 20-frame mel's fold)
    as the wavernn phase holds it. Returns kernel 7's launches."""
    import numpy as np
    import torch

    from your_voice_tts_torch.ops.wavernn_gen import generation_weights, wavernn_generate_cuda
    from your_voice_tts_torch.vocoder.synthesizer import VocoderSynthesizer

    path = trainer.save(os.path.join(tmp, f"{name}.npz"))
    synth = VocoderSynthesizer(trainer.cfg, path, device="cuda")
    mel = np.random.default_rng(5).normal(size=(80, 120)).astype(np.float32)
    wavernn_generate_cuda.launches = 0
    t0 = time.perf_counter()
    wav = synth.mel_to_wav(mel)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    n = wavernn_generate_cuda.launches
    print(f"[vocoder-train] {name}: its checkpoint through VocoderSynthesizer, a 120-frame mel "
          f"-> {len(wav)} samples in {secs * 1e3:.1f} ms (first call); kernel 7 launches {n}")
    check(wav.shape == (120 * 256,) and bool(np.isfinite(wav).all()), f"{name}: served wav")
    check((n > 0) == name.startswith("wavernn"), f"{name}: kernel 7 launches")
    if name == "wavernn":
        model = synth.model
        w = generation_weights(model)
        cond, aux = wavernn_inputs(model, 20, 6)
        hold_wavernn("trained mu-law checkpoint", w, cond[:, :512].contiguous(),
                     aux[:, :512].contiguous(), model.bits, model.packed_weights(w))
    return {"wavernn_generate_cuda": n}


def phase_vocoder_train(report, corpus: str) -> dict:
    """7i. Vocoder training at full width (`voc_cfg`) on the synthetic
    22,050 Hz corpus: for MelGAN, PWGAN and WaveRNN (mu-law, MoL,
    Gaussian) (a) one step card against CPU (`voc_card_vs_cpu`); (b) the
    timed steps (`time_voc_steps`); (c) the trained checkpoint served
    (`serve_trained_vocoder`). Returns kernel 7's launches."""
    from your_voice_tts_torch.data.formatters import ljspeech

    items = ljspeech(corpus)
    out, launches = {}, {"wavernn_generate_cuda": 0}
    with tempfile.TemporaryDirectory() as tmp:
        for name in VOC_MODELS:
            step = voc_card_vs_cpu(name, items)
            timed, trainer = time_voc_steps(name, items)
            served = serve_trained_vocoder(name, trainer, tmp)
            launches["wavernn_generate_cuda"] += served["wavernn_generate_cuda"]
            out[name] = dict(step=step, timed=timed, served_launches=served)
            del trainer
    report["vocoder_train"] = out
    return launches


def phase_profiler(report, corpus: str) -> dict:
    """7j. Trainer.capture_trace around one Tacotron2 train step on the
    kernels (config #3's batch, mixed precision, after a warm step): the
    trace file it writes, its size, and its kernel events of the training
    scans (kernel 5: lstm and attn_fwd; kernel 6: cell_bwd, matT and
    attn_bwd), each present; the step's launches of kernels 5 and 6 by
    their wrappers' counts. Returns those launches."""
    import torch

    from your_voice_tts_torch.train.trainer import Trainer

    trainer = Trainer(a8_cfg(corpus), device="cuda", verbose=False)
    bench = bench_batch()
    trainer.train_step(bench, 2)
    torch.cuda.synchronize()
    for c in train_counters():
        c.launches = 0
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        m = trainer.capture_trace(tmp, trainer.train_step, bench, 2)
        secs = time.perf_counter() - t0
        (name,) = os.listdir(tmp)
        size = os.path.getsize(os.path.join(tmp, name))
        with open(os.path.join(tmp, name)) as f:
            events = json.load(f)["traceEvents"]
    launches = {c.__name__: c.launches for c in train_counters()}
    kernels = [e["name"] for e in events if e.get("cat") == "kernel"]
    own = {k: sum(k in n for n in kernels) for k in ("lstm_mma_kernel", "attn_fwd_kernel",
                                                     "cell_bwd_kernel", "matT",
                                                     "attn_bwd_kernel")}
    print(f"[profiler] capture_trace of one train step: {secs:.2f} s, {name} {size / 2 ** 20:.1f} "
          f"MiB, {len(events)} events, {len(kernels)} kernel events; the training scans' "
          f"kernels in it {own}; launches by the wrappers {launches}; loss {m['loss']:.4f}")
    check(all(own.values()) and all(launches.values()) and math.isfinite(m["loss"]),
          "capture_trace: the trace lacks the training kernels")
    report["profiler"] = dict(seconds=secs, bytes=size, events=len(events),
                              kernel_events=len(kernels), own=own, launches=launches)
    del trainer
    return launches

# ------------------------------------------------------------------ ParallelTTS

PAR_FRAMES = 500          # the full-width frame cap: max_decoder_steps 500 x r 1
PAR_DUR = 3.0             # random weights: exp(duration bias) = 3, ~2 frames a symbol
PAR_TIE = 1e-5            # a duration may differ only across a .5 tie this close
PAR_ROWS = 4              # rows of the card-against-CPU training step


def parallel_config(cfg=None, **model):
    """configs/ljspeech_tacotron2.json (or `cfg`) with model ParallelTTS and
    r = 1, 500 frames at most a row unless `model` says otherwise: 80 mels,
    embedding / encoder / postnet 512, six decoder blocks, the duration
    predictor 256."""
    from your_voice_tts_torch.config import load_config

    cfg = cfg or load_config(os.path.join(ROOT, "configs/ljspeech_tacotron2.json"))
    return dataclasses.replace(cfg, model=dataclasses.replace(
        cfg.model, **dict(dict(model="ParallelTTS", r=1, max_decoder_steps=PAR_FRAMES),
                          **model)))


def asset_parallel_config():
    """The trained asset's config (bench.py builds it so): the smoke config
    with model ParallelTTS, max_decoder_steps 512, r 1."""
    from your_voice_tts_torch.config import load_config

    return parallel_config(load_config(os.path.join(ROOT, "configs/smoke_synthetic.json")),
                           max_decoder_steps=512)


def pre_round(model, text, lengths):
    """(exp(log-duration) - 1) of each symbol, the value inference rounds."""
    import torch

    from your_voice_tts_torch.models.common import sequence_mask

    t = torch.as_tensor(text, dtype=torch.long, device=model.device)
    n = torch.as_tensor(lengths, dtype=torch.long, device=model.device)
    with torch.no_grad():
        enc = model._encode(t, n, None, None, None)
        return (torch.exp(model.duration(enc, sequence_mask(n, t.shape[1]))) - 1.0).cpu()


def hold_parallel_inference(tag: str, card, cpu, texts, cfg) -> dict:
    """ParallelTTS.inference of `texts` on the card against the same
    weights on the CPU (float32, TF32 off): durations and mel_lengths
    equal, or a differing duration within PAR_TIE of its .5 tie (its
    distance printed; rows with one are left out of the mel hold); the
    postnet mels of the other rows within A8_TOL rel L2."""
    import torch

    from your_voice_tts_torch.infer.synthesis import _pad_texts, text_to_seq

    text, lengths = _pad_texts([text_to_seq(t, cfg) for t in texts])
    got, ref = card.inference(text, lengths), cpu.inference(text, lengths)
    d_card, d_cpu = got["durations"].cpu(), ref["durations"]
    diff = (d_card != d_cpu).nonzero().tolist()
    ties = []
    if diff:
        pre = pre_round(cpu, text, lengths)
        ties = [abs(float(pre[b, t]) % 1.0 - 0.5) for b, t in diff]
    same = [b for b in range(len(texts)) if not any(r == b for r, _ in diff)]
    a, b = got["postnet_outputs"].cpu()[same], ref["postnet_outputs"][same]
    rel = float((a - b).norm() / b.norm())
    frames = ref["mel_lengths"].tolist()
    print(f"[parallel] {tag}: {len(texts)} rows, {sum(frames)} frames ({frames}); card against "
          f"CPU: durations differ at {len(diff)} symbols (distance from the .5 tie "
          f"{[f'{x:.2e}' for x in ties]}, tol {PAR_TIE}), mel_lengths equal "
          f"{bool(torch.equal(got['mel_lengths'].cpu(), ref['mel_lengths']))}; postnet mels of "
          f"{len(same)} rows rel L2 {rel:.3e} (tol {A8_TOL}), max abs "
          f"{float((a - b).abs().max()):.3e}")
    check(all(x < PAR_TIE for x in ties), f"{tag}: a duration differs away from a tie")
    check(bool(torch.equal(got["mel_lengths"].cpu(), ref["mel_lengths"])) or bool(diff),
          f"{tag}: mel_lengths differ")
    check(rel <= A8_TOL and bool(torch.isfinite(got["postnet_outputs"]).all()),
          f"{tag}: card and CPU mels disagree")
    return dict(rows=len(texts), frames=frames, duration_diffs=len(diff), tie_distances=ties,
                mel_rel_l2=rel)


def parallel_pair(cfg, seed: int = 0):
    """(card model, CPU model) with the same seeded random weights, the
    duration head's bias at log(PAR_DUR)."""
    import torch

    from your_voice_tts_torch.models import setup_model
    from your_voice_tts_torch.text import symbols

    cpu = setup_model(len(symbols), cfg, device="cpu", seed=seed)
    with torch.no_grad():
        cpu.duration.proj.bias.fill_(math.log(PAR_DUR))
    card = setup_model(len(symbols), cfg, device="cuda", seed=seed)
    card.load_state_dict(cpu.state_dict())
    return card, cpu


def parallel_serving(report) -> dict:
    """(1) Synthesizer.tts_many at full width: the batch of 8 sentences and
    5 batch-1 requests through Griffin-Lim, the counters set to 0 just
    before and read just after, no plain version called: kernel 2 only;
    the mels card against CPU; (2) the trained asset at its own config,
    card against CPU, then one request at a 2,048-frame cap that passes
    1,024 frames: kernel 4."""
    import numpy as np
    import torch

    from your_voice_tts_torch.infer.synthesis import _pad_texts, text_to_seq
    from your_voice_tts_torch.infer.synthesizer import Synthesizer

    cfg = parallel_config()
    card, cpu = parallel_pair(cfg)
    synth = Synthesizer(cfg, device="cuda")
    synth.model.load_state_dict(card.state_dict())
    synth.tts_many(SENTENCES[:1])                  # one-time set-up, not measured
    torch.cuda.synchronize()
    counters = serve_counters()
    for c in counters:
        c.launches = 0
    with plain_calls() as plain:
        batch, t_batch, lat, ones = serve_requests(synth)
        torch.cuda.synchronize()
    launches = {c.__name__: c.launches for c in counters}
    text, lengths = _pad_texts([text_to_seq(t, cfg) for t in SENTENCES])
    frames = int(card.inference(text, lengths)["mel_lengths"].sum())
    sr = synth.ap.sample_rate
    audio_s = sum(len(w) for w in batch) / sr
    p50 = statistics.median(lat)
    print(f"[parallel] serving at full width: batch of 8 {t_batch * 1e3:.1f} ms, "
          f"{frames / t_batch:.0f} mel frames/s ({frames} frames), {audio_s:.2f} s of audio, "
          f"real-time factor {audio_s / t_batch:.1f}x realtime; batch-1 p50 {p50 * 1e3:.1f} ms "
          f"(all: {', '.join(f'{x * 1e3:.1f}' for x in lat)} ms); launches {launches}; plain "
          f"calls {sum(plain.values())}")
    check(all(w.ndim == 1 and len(w) > 0 and bool(np.isfinite(w).all()) for w in batch + ones),
          "parallel serving waveforms")
    check(launches["griffin_lim_wave_cuda"] > 0 and not any(
        n for k, n in launches.items() if k != "griffin_lim_wave_cuda"),
          f"parallel serving: kernel 2 alone should launch: {launches}")
    check(not any(plain.values()), f"parallel serving: a plain version ran: {plain}")
    from torch.profiler import ProfilerActivity, profile

    with tempfile.TemporaryDirectory() as tmp:
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            synth.tts_many(SENTENCES)
            torch.cuda.synchronize()
            pwall = (time.perf_counter() - t0) * 1e3
        prof.export_chrome_trace(os.path.join(tmp, "trace.json"))
        busy, _, n_k = device_busy(os.path.join(tmp, "trace.json"))
    rows = device_rows(prof)
    print(f"[parallel] profiled batch of 8 (its second call): wall {pwall:.1f} ms, device busy "
          f"{busy:.1f} ms (idle share {1 - busy / pwall:.3f}, {n_k} kernels); longest: "
          + "; ".join(f"{dev(e):.2f} ms x{e.count} {e.key[:60]}" for e in rows[:6]))
    out = dict(profile=dict(wall_ms=pwall, busy_ms=busy, kernels=n_k,
                            top={e.key: [dev(e), e.count] for e in rows[:12]}))
    out["serve"] = dict(batch_ms=t_batch * 1e3, mel_frames=frames,
                        mel_frames_per_s=frames / t_batch, rtf_x_realtime=audio_s / t_batch,
                        p50_batch1_ms=p50 * 1e3, batch1_ms=[x * 1e3 for x in lat],
                        launches=launches)
    out["hold"] = hold_parallel_inference("full width, random weights", card, cpu, SENTENCES,
                                          cfg)
    del synth, card, cpu

    acfg = asset_parallel_config()
    asset = os.path.join(ROOT, "assets/bench_trained_parallel.npz")
    card = Synthesizer(acfg, asset, device="cuda").model
    cpu = Synthesizer(acfg, asset, device="cpu").model
    out["asset"] = hold_parallel_inference("trained asset", card, cpu, SENTENCES, acfg)
    long_cfg = parallel_config(acfg, max_decoder_steps=2048)
    synth = Synthesizer(long_cfg, asset, device="cuda")
    long_text = " ".join(s.replace(".", ",") for s in SENTENCES)
    synth.tts_many(["Hi."])
    torch.cuda.synchronize()
    for c in counters:
        c.launches = 0
    with plain_calls() as plain:
        wav = synth.tts_many([long_text])[0]
        torch.cuda.synchronize()
    long_launches = {c.__name__: c.launches for c in counters}
    t, n = _pad_texts([text_to_seq(long_text, long_cfg)])
    n_frames = int(synth.model.inference(t, n)["mel_lengths"][0])
    print(f"[parallel] trained asset, one request of {len(long_text)} characters at a 2,048-frame "
          f"cap: {n_frames} frames, {len(wav)} samples; launches {long_launches}; plain calls "
          f"{sum(plain.values())}")
    check(n_frames > 1024 and long_launches["gl_iteration_cuda"] > 0 and not any(plain.values())
          and bool(np.isfinite(wav).all()), "parallel: a row past 1,024 frames on kernel 4")
    out["long"] = dict(frames=n_frames, launches=long_launches)
    for k, n in long_launches.items():
        launches[k] += n
    out["launches"] = launches
    return out


def parallel_durations(report) -> dict:
    """(3) bin/extract_durations with the trained Tacotron2 teacher
    (assets/bench_trained_smoke.npz) over an 8-clip synthetic corpus at
    its 8 kHz, on the card (kernel 5 counted, no plain version of it
    called) and on the CPU: the same rows. Then the teacher-forced pass of
    a full-width Tacotron2 with random weights on 4 rows of config #3's
    batch (200 decoder steps), card against CPU: the alignments within
    A8_TOL rel L2 (random weights give near-flat rows whose argmax is a
    tie, so durations are held on the trained teacher only)."""
    import numpy as np
    import torch

    from your_voice_tts_torch.bin import extract_durations
    from your_voice_tts_torch.data.synthetic import make_synthetic_corpus
    from your_voice_tts_torch.models import setup_model
    from your_voice_tts_torch.ops import taco2_train
    from your_voice_tts_torch.ops.taco2_train import taco2_train_fwd_cuda
    from your_voice_tts_torch.text import symbols

    out = {}
    with tempfile.TemporaryDirectory() as tmp:
        corpus = make_synthetic_corpus(os.path.join(tmp, "corpus"), n_items=8, sr=8000)
        args = ["--config", os.path.join(ROOT, "configs/smoke_synthetic.json"), "--checkpoint",
                os.path.join(ROOT, "assets/bench_trained_smoke.npz"), "--data_path", corpus,
                "--batch_size", "8"]
        torch.cuda.synchronize()
        taco2_train_fwd_cuda.launches = 0
        plain_fwd = taco2_train.taco2_train_fwd_plain
        seen = []
        taco2_train.taco2_train_fwd_plain = lambda *a, **k: (seen.append(1), plain_fwd(*a, **k))[1]
        try:
            t0 = time.perf_counter()
            card = extract_durations.main(args + ["--output", os.path.join(tmp, "card.npz"),
                                                  "--device", "cuda"])
            torch.cuda.synchronize()
            card_s = time.perf_counter() - t0
            n_card = taco2_train_fwd_cuda.launches
            card_plain = len(seen)
            t0 = time.perf_counter()
            cpu = extract_durations.main(args + ["--output", os.path.join(tmp, "cpu.npz"),
                                                 "--device", "cpu"])
            cpu_s = time.perf_counter() - t0
        finally:
            taco2_train.taco2_train_fwd_plain = plain_fwd
    same = sorted(card) == sorted(cpu) and all(np.array_equal(card[k], cpu[k]) for k in card)
    print(f"[parallel] extract_durations, trained teacher, 8 clips: card {card_s:.2f} s "
          f"(kernel 5 launches {n_card}, plain calls {card_plain}), CPU {cpu_s:.1f} s; "
          f"{len(card)} rows, {sum(int(v.sum()) for v in card.values())} frames, equal "
          f"{same}")
    check(n_card > 0 and card_plain == 0, "extract_durations: kernel 5 did not carry the pass")
    check(same, "extract_durations: card and CPU durations differ")
    out["trained"] = dict(card_s=card_s, cpu_s=cpu_s, launches=n_card, rows=len(card))

    cfg = train_config()
    cpu_m = setup_model(len(symbols), cfg, device="cpu", seed=5)
    card_m = setup_model(len(symbols), cfg, device="cuda", seed=5)
    card_m.load_state_dict(cpu_m.state_dict())
    b = {k: v[:4, :200] if k == "mel" else v[:4] for k, v in bench_batch(6).items()}
    b["mel_lengths"][:] = 200
    aligns = {}
    for dev, m in (("cpu", cpu_m), ("cuda", card_m)):
        t = {k: torch.as_tensor(b[k]).to(dev) for k in ("text", "text_lengths", "mel",
                                                          "mel_lengths")}
        if dev == "cuda":
            torch.cuda.synchronize()
            taco2_train_fwd_cuda.launches = 0
        with torch.no_grad():
            aligns[dev] = m(t["text"].long(), t["text_lengths"], t["mel"], t["mel_lengths"],
                            r=2)["alignments"].float().cpu()
    n_wide = taco2_train_fwd_cuda.launches
    rel = float((aligns["cuda"] - aligns["cpu"]).norm() / aligns["cpu"].norm())
    err = float((aligns["cuda"] - aligns["cpu"]).abs().max())
    print(f"[parallel] teacher-forced pass at full width (random weights, B=4, 128 symbols, "
          f"200 frames, r 2): alignments card against CPU rel L2 {rel:.3e} (tol {A8_TOL}), "
          f"max abs {err:.3e}; kernel 5 launches {n_wide}")
    check(rel <= A8_TOL and n_wide > 0, "full-width teacher pass: card and CPU disagree")
    out["full_width"] = dict(align_rel_l2=rel, align_max_abs=err, launches=n_wide)
    out["launches"] = {"taco2_train_fwd_cuda": n_card + n_wide}
    return out


def kink_inputs(model, b: dict):
    """The values at the kinks of one training-mode pass's loss, flattened
    (float64, CPU): the input of every ReLU (the ConvLN blocks' LayerNorm
    outputs, the encoder blocks' BatchNorm outputs) and the L1 losses'
    residuals. A float32 pass that puts one of them on the other side of
    zero from the exact pass changes the gradient by a step, not by a
    rounding: one element in 10^5-10^6 moves the rel L2 by ~1e-3."""
    import torch

    from your_voice_tts_torch.nn.core import LayerNorm

    acts = []
    hooks = [m.register_forward_hook(lambda mod, i, o: acts.append(o.detach().double().cpu()
                                                                   .flatten()))
             for n, m in model.named_modules()
             if isinstance(m, LayerNorm) or (n.startswith("encoder.blocks") and n.endswith(".bn"))]
    model.train()
    try:
        with torch.no_grad():
            out = model(b["text"], b["text_lengths"], b["durations"], max_frames=b["mel"].shape[1])
    finally:
        for h in hooks:
            h.remove()
    acts += [(out[k] - b["mel"]).double().cpu().flatten()
             for k in ("decoder_outputs", "postnet_outputs")]
    return torch.cat(acts)


def parallel_training(report, corpus: str) -> dict:
    """(4) bin/train_parallel at full width on the 40-clip 22,050 Hz
    corpus, batch 32, 3 steps: finite losses and a checkpoint; one step
    (`step_grads`, dropout off) on PAR_ROWS rows of a config #3 batch with
    uniform durations, card against CPU: in float64 the gradients within
    A8_TOL rel L2; in float32 the loss parts within A8_TOL relative and the
    gradients against the CPU's float64 step within max(A8_TOL, 2 x the CPU
    float32 step's distance), unless the card's float32 pass puts a ReLU
    input or an L1 residual across its kink (`kink_inputs`; their count
    printed): the gradient is discontinuous there, and one such element
    moves the rel L2 by ~1e-3 on either device;
    the timed step at config #3's batch (B = 32, 128 symbols, 400 frames:
    step_grads + the optimizer; CUDA events, median of 3) and a profiled
    step's device busy share."""
    import copy

    import torch
    from torch.profiler import ProfilerActivity, profile

    from your_voice_tts_torch.bin import train_parallel
    from your_voice_tts_torch.bin.train_parallel import step_grads
    from your_voice_tts_torch.models.parallel_tts import ParallelTTSLoss, uniform_durations
    from your_voice_tts_torch.train.optim import ClipAdam

    out = {}
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        parts = train_parallel.main([
            "--config_path", os.path.join(ROOT, "configs/ljspeech_tacotron2.json"),
            "--data_path", corpus, "--batch_size", "32", "--max_steps", "3",
            "--output_path", tmp, "--device", "cuda"])
        secs = time.perf_counter() - t0
        saved = os.listdir(tmp)
    print(f"[parallel] bin/train_parallel at full width, batch 32, 3 steps: {secs:.1f} s "
          f"(data set-up included); last losses { {k: round(v, 4) for k, v in parts.items()} }; "
          f"wrote {saved}")
    check(all(math.isfinite(v) for v in parts.values()) and saved == ["checkpoint_3.npz"],
          "train_parallel: losses or checkpoint")
    out["cli"] = dict(seconds=secs, parts=parts)

    cfg = parallel_config()
    card, cpu = parallel_pair(cfg, seed=2)
    bench = bench_batch(7)
    bench["durations"] = uniform_durations(bench["text_lengths"], bench["mel_lengths"],
                                           bench["text"].shape[1]).numpy()

    def tensors(rows, dev):
        b = {k: torch.as_tensor(bench[k][:rows]).to(dev) for k in
             ("text", "text_lengths", "mel", "mel_lengths", "durations")}
        b["text"] = b["text"].long()
        return b

    crit = ParallelTTSLoss()
    batches = {d: tensors(PAR_ROWS, d) for d in ("cpu", "cuda")}
    batches.update({f"{d}64": dict(b, mel=b["mel"].double()) for d, b in batches.items()})
    models = {"cpu": cpu, "cuda": card, "cpu64": copy.deepcopy(cpu).double(),
              "cuda64": copy.deepcopy(card).double()}
    steps = {k: step_grads(m, crit, batches[k]) for k, m in models.items()}
    cat = lambda gs: torch.cat([g.detach().double().cpu().flatten() for g in gs])  # noqa: E731
    dist = lambda a, b: float((cat(steps[a][1]) - cat(steps[b][1])).norm()  # noqa: E731
                              / cat(steps[b][1]).norm())
    f64, glob, card64, cpu32 = (dist("cuda64", "cpu64"), dist("cuda", "cpu"),
                                dist("cuda", "cpu64"), dist("cpu", "cpu64"))
    flips = int(((kink_inputs(card, batches["cuda"]) > 0)
                 != (kink_inputs(models["cpu64"], batches["cpu64"]) > 0)).sum())
    gate = max(A8_TOL, 2 * cpu32)
    rel = {k: abs(float(steps["cuda"][0][k]) - float(v)) / abs(float(v))
           for k, v in steps["cpu"][0].items()}
    print(f"[parallel] one step at full width on {PAR_ROWS} rows (128 symbols, 400 frames, "
          f"dropout off), card against CPU: float64 gradients rel L2 {f64:.3e} (tol {A8_TOL}); "
          f"float32 loss parts rel " + ", ".join(f"{k} {v:.2e}" for k, v in rel.items())
          + f" (tol {A8_TOL}), gradients rel L2 {glob:.3e}, against the CPU's float64 step: "
          f"card {card64:.3e}, CPU {cpu32:.3e} (tol max({A8_TOL}, 2 x the CPU's) = {gate:.3e} "
          f"where the card's float32 pass crosses no kink); ReLU inputs and L1 residuals on "
          f"the other side of their kink from the CPU's float64 pass: {flips}")
    check(f64 <= A8_TOL and max(rel.values()) <= A8_TOL and (flips > 0 or card64 <= gate),
          "parallel step: card and CPU disagree")
    out["card_vs_cpu"] = dict(parts_rel=rel, f64_grad_rel_l2=f64, grad_rel_l2=glob,
                              card_vs_f64=card64, cpu_vs_f64=cpu32, kink_flips=flips)
    del cpu, models, steps

    params = [p for p in card.parameters() if p.requires_grad]
    adam = ClipAdam(params, 1e-3, 1.0, if_finite=True)
    g = torch.Generator(device="cuda").manual_seed(42)
    b = tensors(TRAIN_B, "cuda")

    def step():
        parts, grads = step_grads(card, crit, b, g)
        adam.step(grads)
        return float(parts["loss"])

    step()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ev = []
    for _ in range(3):
        s, e = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        s.record()
        loss = step()                              # ends in a host read of the loss
        e.record()
        e.synchronize()
        ev.append(s.elapsed_time(e))
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    with tempfile.TemporaryDirectory() as tmp:
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            step()
            torch.cuda.synchronize()
            pwall = (time.perf_counter() - t0) * 1e3
        trace = os.path.join(tmp, "trace.json")
        prof.export_chrome_trace(trace)
        busy, _, n_k = device_busy(trace)
    ms = statistics.median(ev)
    print(f"[parallel] timed step (B={TRAIN_B}, 128 symbols, 400 frames, float32, dropout on, "
          f"ClipAdam if_finite): {ms:.1f} ms (CUDA events, median of 3; all "
          f"{', '.join(f'{x:.1f}' for x in ev)}), {TRAIN_B * 400 / ms * 1e3:.0f} mel frames/s; "
          f"peak memory allocated {peak:.3f} GiB; profiled step {pwall:.1f} ms, device busy "
          f"{busy:.1f} ms (busy share {busy / pwall:.3f}, {n_k} kernels); loss {loss:.4f}; "
          f"non-finite steps {int(adam.total_notfinite)}")
    check(math.isfinite(loss) and int(adam.count) == 5, "parallel timed steps")
    out["timed"] = dict(step_ms=ms, step_ms_all=ev, peak_gib=peak, profiled_wall_ms=pwall,
                        busy_ms=busy, busy_share=busy / pwall, kernels=n_k)
    return out


def parallel_export(report) -> dict:
    """(5) The serving export of a full-width ParallelTTS (the serving
    weights) at (8, EXPORT_T) on the card, loaded without the model code,
    held against its unexported program bit for bit on the 8 sentences:
    kernel 2 through yvt::griffin_lim, no plain version; then the trained
    asset's artifact at the smoke shape (2, 32), kernel 3."""
    from your_voice_tts_torch.audio import AudioProcessor
    from your_voice_tts_torch.infer.export import (ExportedSynthesizer, export_serving,
                                                   make_serving_fn)
    from your_voice_tts_torch.infer.synthesizer import Synthesizer

    out = {}
    launches = {c.__name__: 0 for c in serve_counters()}
    cfg = parallel_config()
    card, _ = parallel_pair(cfg)
    acfg = asset_parallel_config()
    asset = Synthesizer(acfg, os.path.join(ROOT, "assets/bench_trained_parallel.npz"),
                        device="cuda").model
    cases = (("full width", card, cfg, 8, EXPORT_T, SENTENCES, "griffin_lim_wave_cuda"),
             ("trained asset", asset, acfg, 2, 32, ["Hi there.", "Go home now."],
              "griffin_lim_full_cuda"))
    with tempfile.TemporaryDirectory() as tmp:
        for tag, model, c, B, T, texts, kernel in cases:
            ap = AudioProcessor(c.audio, "cuda")
            d = os.path.join(tmp, tag.replace(" ", "_"))
            t0 = time.perf_counter()
            export_serving(model, c, ap, d, batch_sizes=(B,), text_buckets=(T,))
            export_s = time.perf_counter() - t0
            exp = ExportedSynthesizer(d)
            program = make_serving_fn(model, c, ap)
            text, lens = text_batch(exp, texts, T)
            held = hold_artifact(f"parallel {tag}", exp, program, text, lens,
                                 kernels={kernel: True})
            check(held["wav_err"] == 0.0, f"parallel {tag}: artifact not bit for bit")
            for k, n in held["launches"].items():
                launches[k] += n
            print(f"[parallel] {tag} export at ({B}, {T}): {export_s:.1f} s")
            out[tag] = dict(export_s=export_s, **held)
    out["launches"] = launches
    return out


def phase_parallel(report, corpus: str) -> dict:
    """7k. parallel: ParallelTTS (configs/ljspeech_tacotron2.json with model
    ParallelTTS, r = 1, a 500-frame cap: 80 mels, 512 wide, six decoder
    blocks, duration predictor 256; seeded random weights, the duration
    head's bias at log 3): serving (kernel 2; the trained asset, card
    against CPU; a row past 1,024 frames, kernel 4), teacher durations
    (kernel 5), training (card against CPU, the timed step) and the export
    (kernels 2 and 3), each step's counters set to 0 just before and read
    just after. Returns the launches of kernels 2-5."""
    out = {"serving": parallel_serving(report), "durations": parallel_durations(report),
           "training": parallel_training(report, corpus), "export": parallel_export(report)}
    launches: dict = {}
    for part in ("serving", "durations", "export"):
        for k, n in out[part].pop("launches").items():
            launches[k] = launches.get(k, 0) + n
    print(f"[parallel] launches of this phase: {launches}")
    out["launches"] = launches
    report["parallel"] = out
    return launches


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--profile", action="store_true",
                    help="add a torch.profiler breakdown of one batch-of-8 call")
    ap.add_argument("--out", default=os.path.join(ROOT, "build", "chip_smoke"),
                    help="directory for chip_smoke.json and the profiler trace")
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    try:
        import your_voice_tts_torch  # noqa: F401
    except ImportError as e:
        print(f"chip_smoke: {e}: run it from a checkout of the repository", file=sys.stderr)
        return 1

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True, timeout=60).stdout.strip().splitlines()[0]
    report: dict = {"device": torch.cuda.get_device_name(0), "phase_s": {}, "nvidia_smi": smi}

    def timed(name, fn, *a):
        t0 = time.perf_counter()
        result = fn(*a)
        report["phase_s"][name] = time.perf_counter() - t0
        print(f"[{name}] phase {report['phase_s'][name]:.1f} s")
        return result

    timed("build", phase_build, report)
    kernels = [timed("decode", phase_decode, report),
               timed("griffin-lim", phase_griffin_lim, report),
               timed("taco1-decode", phase_taco1_decode, report),
               timed("gl-iteration", phase_gl_iteration, report)]
    timed("gl-full", phase_gl_full, report)
    small_launches, gl_full_kernel = timed("small", phase_small_input, report)
    kernels.append(gl_full_kernel)
    launches = timed("main", phase_main_path, report)
    launches.update(small_launches)
    os.makedirs(args.out, exist_ok=True)
    if args.profile:
        timed("profile", phase_profile, report, args.out)
    taco1_launches, taco1_synth = timed("taco1-main", phase_taco1_main, report)
    launches.update(taco1_launches)
    if args.profile:
        timed("taco1-profile", phase_taco1_profile, report, taco1_synth, args.out)
    del taco1_synth
    state: dict = {}
    kernels += [timed("train-fwd", phase_train_fwd, report, state),
                timed("train-bwd", phase_train_bwd, report, state)]
    state.clear()
    with tempfile.TemporaryDirectory() as tmp:
        trainer, train_launches = timed("train", phase_train_main, report, tmp)
        if args.profile:
            timed("train-profile", phase_train_profile, report, trainer, args.out)
    del trainer
    for k, n in train_launches.items():
        launches[k] = launches.get(k, 0) + n
    # Tacotron(1) training: kernels 8, 4 or 2 from its test sentences and
    # its checkpoint served; kernels 1 and 2 with the statistics
    with tempfile.TemporaryDirectory() as tmp:
        for k, n in timed("taco1-train", phase_taco1_train, report, tmp).items():
            launches[k] = launches.get(k, 0) + n
    # phase 7b: kernels 5 and 6 at E = 768 / 1,024, the "your voice" path
    with tempfile.TemporaryDirectory() as tmp:
        wide_errs, voice_launches = timed("train-cond", phase_train_conditioned, report, tmp)
    for kern in kernels:
        if kern["name"] in wide_errs:
            kern["max_abs_err"] = max(kern["max_abs_err"], wide_errs[kern["name"]])
    for k in ("taco2_train_fwd_cuda", "taco2_train_bwd_cuda"):
        launches[k] += voice_launches[k]
    # phases 7d-7g: the attention variants on the step loop (their test
    # sentences on kernels 1 and 2), the bidirectional decoder and
    # accumulation on kernels 5 and 6, the mel oracle gate
    with tempfile.TemporaryDirectory() as tmp:
        from your_voice_tts_torch.data.synthetic import make_synthetic_corpus

        corpus = make_synthetic_corpus(os.path.join(tmp, "corpus"), n_items=40, sr=22050,
                                       max_words=15)
        a8_launches = [timed("train-variants", phase_train_variants, report, corpus),
                       timed("train-bd", phase_train_bd, report, corpus),
                       timed("train-accum", phase_train_accum, report, corpus)]
        # phases 7h-7j: Tacotron(1) with Graves and the location options on
        # the step loop (kernel 4 from its serving), vocoder training (kernel
        # 7 from the trained WaveRNN served), capture_trace (kernels 5, 6).
        # Each phase's launches stand in the report under its own name and
        # stay out of the kernel line, whose counts keep the paths they had.
        report["phase_launches"] = {
            name: timed(name, fn, report, corpus)
            for name, fn in (("taco1-variants", phase_taco1_variants),
                             ("vocoder-train", phase_vocoder_train),
                             ("profiler", phase_profiler))}
        # phase 7k: ParallelTTS served, its durations extracted, trained and
        # exported: kernels 2-5, added to the kernel line
        a8_launches.append(timed("parallel", phase_parallel, report, corpus))
    for seen in a8_launches:
        for k, n in seen.items():
            launches[k] = launches.get(k, 0) + n
    print(f"[launches] phases 7h-7j, apart from the kernel line: "
          f"{json.dumps(report['phase_launches'])}")
    timed("mel-oracle", phase_mel_oracle, report)
    kernels.append(timed("wavernn", phase_wavernn, report))
    voc_launches, synth = timed("vocoder", phase_vocoder_path, report)
    launches["wavernn_generate_cuda"] = voc_launches["wavernn_generate_cuda"]
    if args.profile:
        timed("vocoder-profile", phase_vocoder_profile, report, synth, args.out)
    del synth
    # configs #2 and #5 and the HTTP server: kernel 1's and Griffin-Lim's
    # launches on their paths add up
    melgan_launches, synth = timed("melgan-main", phase_melgan_main, report)
    if args.profile:
        timed("melgan-profile", phase_vocoder_profile, report, synth, args.out, "melgan")
    del synth
    cloning_launches = timed("cloning", phase_cloning, report)
    # phonemes, GST and Tacotron(1) with speakers: kernels 1, 2, 4 and 8
    cond_launches, gst_err, taco1_err = timed("conditioned", phase_conditioned, report)
    kernels[0]["max_abs_err"] = max(kernels[0]["max_abs_err"], gst_err)
    kernels[2]["max_abs_err"] = max(kernels[2]["max_abs_err"], taco1_err)
    for seen in (melgan_launches, cloning_launches, cond_launches, voice_launches,
                 timed("server", phase_server, report)):
        for k in ("tacotron2_decode_cuda", "griffin_lim_wave_cuda", "tacotron1_decode_cuda",
                  "gl_iteration_cuda"):
            launches[k] += seen.get(k, 0)
    variant_launches, variant_err = timed("attention-variants", phase_attention_variants,
                                          report)
    for k, n in variant_launches.items():
        launches[k] += n
    kernels[0]["max_abs_err"] = max(kernels[0]["max_abs_err"], variant_err)
    timed("melgan-asset", phase_melgan_asset, report)
    # the serving export: kernels 1-4 and 8 launched from loaded artifacts
    for k, n in timed("export", phase_export, report).items():
        launches[k] += n
    for k in kernels:
        k["launches"] = launches[k["name"]]
    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err", "ms",
            "plain_ms", "bound_ms", "bound_by", "library_ms")
    report["kernels"] = [{k: kern[k] for k in keys} for kern in kernels]
    with open(os.path.join(args.out, "chip_smoke.json"), "w") as f:
        json.dump(report, f, indent=1, default=str)
    print(json.dumps({"kernels": report["kernels"]}))
    print(smi)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
