"""The port's `check_config` against the JAX package's: one case per
rejection, each bad config refused by both; the shipped configs pass both;
the port's training CLI refuses a bad config before it trains."""

import json
import os

import pytest

from your_voice_tts_tpu.config import _strip_json_comments
from your_voice_tts_tpu.config import check_config as jax_check_config
from your_voice_tts_tpu.config import config_from_dict as jax_config_from_dict
from your_voice_tts_torch.config import check_config, config_from_dict

SMOKE = "configs/smoke_synthetic.json"
SHIPPED = ["configs/smoke_synthetic.json", "configs/ljspeech_tacotron2.json",
           "configs/ljspeech_tacotron2_b384.json"]


def raw(path=SMOKE) -> dict:
    with open(path, encoding="utf-8") as f:
        return json.loads(_strip_json_comments(f.read()))


def with_audio(**kw):
    def edit(d):
        d["audio"].update(kw)
    return edit


def with_top(**kw):
    def edit(d):
        d.update(kw)
    return edit


# one case per rejection of the reference's check_config (config.py:337)
BAD = {
    "audio_size_not_positive": with_audio(num_mels=0),
    "hop_past_win": with_audio(hop_length=300, win_length=256),
    "mel_fmax_past_nyquist": with_audio(mel_fmax=4001.0),
    "unknown_model": with_top(model="Tacotron3"),
    "r_below_one": with_top(r=0),
    "unknown_attention_type": with_top(attention_type="dynamic"),
    "unknown_prenet_type": with_top(prenet_type="layer_norm"),
    "unknown_attention_norm": with_top(attention_norm="relu"),
    "unknown_inference_compute_dtype": with_top(inference_compute_dtype="float16"),
    "malformed_gradual_training_row": with_top(gradual_training=[[0, 7, 64], [10000, 5]]),
}


@pytest.mark.parametrize("case", sorted(BAD))
def test_both_reject(case):
    d = raw()
    BAD[case](d)
    with pytest.raises(ValueError) as jax_err:
        jax_check_config(jax_config_from_dict(d))
    with pytest.raises(ValueError) as port_err:
        check_config(config_from_dict(d))
    assert str(port_err.value) == str(jax_err.value)


@pytest.mark.parametrize("path", SHIPPED)
def test_shipped_configs_pass_both(path):
    jax_check_config(jax_config_from_dict(raw(path)))
    check_config(config_from_dict(raw(path)))


def test_train_cli_refuses_a_bad_config_before_training(tmp_path):
    from your_voice_tts_torch.bin.train import main

    d = raw()
    BAD["r_below_one"](d)
    path = tmp_path / "bad.json"
    path.write_text(json.dumps(d))
    runs = tmp_path / "runs"
    with pytest.raises(ValueError, match="r must be >= 1"):
        main(["--config_path", str(path), "--output_path", str(runs), "--device", "cpu",
              "--max_steps", "1"])
    assert not os.path.exists(runs)
