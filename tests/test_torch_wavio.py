"""The port's WAV decoding (`read_wav`, `AudioProcessor.load_wav`,
`load_wav_batch`) against the JAX package's AudioProcessor, which decodes
through its native codec.

Files are generated from a numpy seed in every format the reference reads:
PCM 8-bit (unsigned), 16, 24 and 32-bit, IEEE float32 and float64, stereo,
and WAVE_FORMAT_EXTENSIBLE. At the file's own rate both sides must agree to
1e-7 (each sample is one integer scaled by a power of two); through the
resampler to 1e-4, since scipy's resample_poly (the port) and the native
resampler (the reference) round the same filter differently.
"""

import dataclasses
import struct
import threading

import numpy as np
import pytest

from your_voice_tts_tpu import native
from your_voice_tts_tpu.audio import AudioProcessor as JaxAudioProcessor
from your_voice_tts_tpu.config import AudioConfig as JaxAudioConfig
from your_voice_tts_torch.audio import AudioProcessor, read_wav
from your_voice_tts_torch.config import AudioConfig

pytestmark = pytest.mark.skipif(
    not native.available(), reason=f"the JAX package's native codec: {native.build_error()}")

SR = 16000
KSDATAFORMAT_TAIL = bytes.fromhex("000000001000800000aa00389b71")   # the GUID after the tag


def wav_bytes(data: bytes, sr: int, channels: int, bits: int, tag: int,
              extensible: bool = False, extra_chunk: bool = False) -> bytes:
    block = channels * bits // 8
    if extensible:
        fmt = (struct.pack("<HHIIHH", 0xFFFE, channels, sr, sr * block, block, bits)
               + struct.pack("<HHI", 22, bits, 0) + struct.pack("<H", tag) + KSDATAFORMAT_TAIL)
    else:
        fmt = struct.pack("<HHIIHH", tag, channels, sr, sr * block, block, bits)
    body = b"WAVE" + b"fmt " + struct.pack("<I", len(fmt)) + fmt
    if extra_chunk:                       # an odd-sized chunk the reader must skip
        body += b"LIST" + struct.pack("<I", 5) + b"abcde\x00"
    body += b"data" + struct.pack("<I", len(data)) + data
    return b"RIFF" + struct.pack("<I", len(body)) + body


def encode(kind: str, x: np.ndarray) -> tuple[bytes, int, int]:
    """x [n, channels] in [-1, 1] -> (sample bytes, bits, format tag)."""
    if kind == "pcm8":
        return np.clip(np.round(x * 127 + 128), 0, 255).astype(np.uint8).tobytes(), 8, 1
    if kind == "pcm16":
        return (x * 32767).astype("<i2").tobytes(), 16, 1
    if kind == "pcm24":
        v = (x * 8388607).astype(np.int32).reshape(-1)
        b = np.stack([v & 0xFF, (v >> 8) & 0xFF, (v >> 16) & 0xFF], 1).astype(np.uint8)
        return b.tobytes(), 24, 1
    if kind == "pcm32":
        return (x * 2147483000).astype("<i4").tobytes(), 32, 1
    if kind == "float32":
        return x.astype("<f4").tobytes(), 32, 3
    return x.astype("<f8").tobytes(), 64, 3


CASES = [  # (name, kind, channels, extensible, extra chunk)
    ("pcm8", "pcm8", 1, False, False),
    ("pcm16", "pcm16", 1, False, True),
    ("pcm24", "pcm24", 1, False, False),
    ("pcm32", "pcm32", 1, False, False),
    ("float32", "float32", 1, False, False),
    ("float64", "float64", 1, False, False),
    ("stereo_pcm16", "pcm16", 2, False, False),
    ("stereo_float32", "float32", 2, False, True),
    ("extensible_pcm24", "pcm24", 1, True, False),
    ("extensible_float32_stereo", "float32", 2, True, False),
]


def write_case(tmp_path, name, kind, channels, extensible, extra, seed, sr=SR, n=3001):
    rng = np.random.default_rng(seed)
    x = np.clip(0.4 * rng.standard_normal((n, channels)), -1, 1)
    data, bits, tag = encode(kind, x)
    path = tmp_path / f"{name}.wav"
    path.write_bytes(wav_bytes(data, sr, channels, bits, tag, extensible, extra))
    return str(path)


def processors(**kw):
    return (JaxAudioProcessor(JaxAudioConfig(sample_rate=SR, **kw)),
            AudioProcessor(AudioConfig(sample_rate=SR, **kw)))


@pytest.mark.parametrize("name,kind,channels,extensible,extra", CASES,
                         ids=[c[0] for c in CASES])
def test_load_wav_matches_jax_at_the_file_rate(tmp_path, name, kind, channels, extensible,
                                               extra):
    path = write_case(tmp_path, name, kind, channels, extensible, extra, seed=len(name))
    jax_ap, ap = processors()
    ref = jax_ap.load_wav(path)
    got = ap.load_wav(path)
    assert got.dtype == np.float32 and got.shape == ref.shape == (3001,)
    np.testing.assert_allclose(got, ref, atol=1e-7, rtol=0)
    x, sr = read_wav(path)
    assert sr == SR
    np.testing.assert_array_equal(x, got)


def test_load_wav_resampled_matches_jax(tmp_path):
    """A 24-bit stereo file at 22050 Hz read at 16 kHz."""
    path = write_case(tmp_path, "rs", "pcm24", 2, False, False, seed=3, sr=22050)
    jax_ap, ap = processors()
    ref, got = jax_ap.load_wav(path), ap.load_wav(path)
    assert got.shape == ref.shape
    np.testing.assert_allclose(got, ref, atol=1e-4, rtol=0)


def test_load_wav_sound_norm_matches_jax(tmp_path):
    path = write_case(tmp_path, "n", "pcm8", 1, False, False, seed=4)
    jax_ap, ap = processors(do_sound_norm=True)
    np.testing.assert_allclose(ap.load_wav(path), jax_ap.load_wav(path), atol=1e-7, rtol=0)


def test_load_wav_batch_matches_jax_on_threads(tmp_path, monkeypatch):
    paths = [write_case(tmp_path, *c, seed=i) for i, c in enumerate(CASES)]
    jax_ap, ap = processors()
    ref = jax_ap.load_wav_batch(paths)
    threads = set()
    real = ap.load_wav

    def spy(p, sr=None):
        threads.add(threading.get_ident())
        return real(p, sr)

    monkeypatch.setattr(ap, "load_wav", spy)
    got = ap.load_wav_batch(paths)
    assert threading.get_ident() not in threads      # decoded on the pool's threads
    assert len(got) == len(ref) == len(paths)
    for g, r in zip(got, ref):
        np.testing.assert_allclose(g, r, atol=1e-7, rtol=0)


@pytest.mark.parametrize("blob,what", [
    (b"RIFX\x00\x00\x00\x00WAVE", "not a RIFF/WAVE file"),
    (wav_bytes(b"\x00" * 8, SR, 1, 16, 2), "unsupported WAV format"),
    (wav_bytes(b"\x00" * 8, SR, 1, 12, 1), "unsupported WAV format"),
    (b"RIFF" + struct.pack("<I", 4) + b"WAVE", "missing fmt chunk"),
])
def test_read_wav_refuses_what_the_reference_refuses(tmp_path, blob, what):
    path = tmp_path / "bad.wav"
    path.write_bytes(blob)
    with pytest.raises(ValueError, match=what):
        read_wav(str(path))
    with pytest.raises(native.NativeWavError):
        native.decode(str(path))


def test_truncated_data_chunk_decodes_its_whole_frames(tmp_path):
    full = write_case(tmp_path, "t", "pcm16", 2, False, False, seed=9)
    blob = open(full, "rb").read()
    path = tmp_path / "cut.wav"
    path.write_bytes(blob[:-5])                    # the last frame is cut
    x, sr = read_wav(str(path))
    ref, _ = read_wav(full)
    np.testing.assert_array_equal(x, ref[: len(x)])
    assert len(x) == len(ref) - 2


def test_audio_config_fields_match():
    assert [f.name for f in dataclasses.fields(AudioConfig)] == \
        [f.name for f in dataclasses.fields(JaxAudioConfig)]
