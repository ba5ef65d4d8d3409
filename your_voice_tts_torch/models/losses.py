"""Training losses (the JAX package's models/losses.py): masked L1 / MSE
with optional per-sample length normalization, masked stop-token BCE with
logits and pos_weight, guided-attention loss, and the composite
TacotronLoss with the guided-attention weight decayed by step.

Inside a data-parallel train step (`parallel.mesh.global_batch`) every
divisor is the global batch's: the counts are summed over the ranks
(`global_count`, clamped at 1 after the sum, since a rank of phantom rows
counts 0) and each rank's loss is its share of the global one."""

from __future__ import annotations

import torch
import torch.nn.functional as F

from ..parallel.mesh import active, global_count, global_mean
from .common import sequence_mask


def _masked(err, mask, target, seq_len_norm: bool):
    if seq_len_norm:
        norm_w = mask / mask.sum(dim=1, keepdim=True).clamp_min(1.0)
        n = target.shape[0] * target.shape[2]
        if active():
            n = global_count(torch.tensor(float(n), device=err.device))
        return (err * norm_w / n).sum()
    return err.sum() / global_count(mask.sum() * target.shape[2]).clamp_min(1.0)


def masked_l1(x, target, lengths, seq_len_norm: bool = False):
    """sum(|x - t| * mask) / (valid frames * channels), or per-sample
    length-normalized weighting when seq_len_norm."""
    mask = sequence_mask(lengths, target.shape[1]).to(x.dtype)[..., None]
    return _masked((x - target).abs() * mask, mask, target, seq_len_norm)


def masked_mse(x, target, lengths, seq_len_norm: bool = False):
    mask = sequence_mask(lengths, target.shape[1]).to(x.dtype)[..., None]
    return _masked((x - target) ** 2 * mask, mask, target, seq_len_norm)


def masked_bce_logits(logits, targets, lengths, pos_weight: float = 1.0):
    """Stop-token BCE with pos_weight on the positive (stop) class.
    logits / targets [B, T_r]; lengths in decoder steps."""
    mask = sequence_mask(lengths, targets.shape[1]).to(logits.dtype)
    loss = -(pos_weight * targets * F.logsigmoid(logits)
             + (1.0 - targets) * F.logsigmoid(-logits))
    return (loss * mask).sum() / global_count(mask.sum()).clamp_min(1.0)


def guided_attention_loss(alignments, input_lengths, decoder_lengths, sigma: float = 0.4):
    """Soft-diagonal attention prior over alignments [B, T_dec, T_in]."""
    B, T_dec, T_in = alignments.shape
    dev = alignments.device
    n = torch.arange(T_dec, device=dev)[None, :, None] \
        / decoder_lengths.clamp_min(1)[:, None, None]
    t = torch.arange(T_in, device=dev)[None, None, :] / input_lengths.clamp_min(1)[:, None, None]
    W = 1.0 - torch.exp(-((n - t) ** 2) / (2.0 * sigma ** 2))
    mask = (sequence_mask(input_lengths, T_in)[:, None, :]
            & sequence_mask(decoder_lengths, T_dec)[:, :, None]).to(alignments.dtype)
    return (alignments * W * mask).sum() / global_count(mask.sum()).clamp_min(1.0)


class TacotronLoss:
    """Decoder + postnet regression (MSE for Tacotron2, L1 for Tacotron),
    the bidirectional decoder's backward and consistency terms when its
    outputs are present, stopnet BCE, and guided attention whose weight
    decays linearly to 0 over 10 * ga_decay_steps steps."""

    def __init__(self, model_name: str = "Tacotron2", loss_masking: bool = True,
                 seq_len_norm: bool = False, stopnet: bool = True,
                 stopnet_pos_weight: float = 10.0, ga_alpha: float = 10.0,
                 ga_sigma: float = 0.4, ga_decay_steps: int = 10000,
                 decoder_alpha: float = 0.25, postnet_alpha: float = 0.25):
        self.use_mse = model_name == "Tacotron2"
        self.loss_masking, self.seq_len_norm = loss_masking, seq_len_norm
        self.stopnet, self.pos_weight = stopnet, stopnet_pos_weight
        self.ga_alpha, self.ga_sigma, self.ga_decay_steps = ga_alpha, ga_sigma, ga_decay_steps
        self.decoder_alpha, self.postnet_alpha = decoder_alpha, postnet_alpha

    def _reg(self, x, target, lengths):
        if self.loss_masking:
            fn = masked_mse if self.use_mse else masked_l1
            return fn(x, target, lengths, self.seq_len_norm)
        return global_mean((x - target) ** 2 if self.use_mse else (x - target).abs())

    def __call__(self, outputs: dict, mel_target, mel_lengths, stop_targets, input_lengths,
                 step=None, r: int = 1, linear_target=None, n_priority_freq: int = 0):
        """outputs: the model's forward dict (float32); stop_targets
        [B, T_r]; linear_target: Tacotron's linear spectrogram, which its
        postnet regresses (half full band, half the band below
        n_priority_freq). Returns (total, dict of components)."""
        decoder_loss = self._reg(outputs["decoder_outputs"], mel_target, mel_lengths)
        post = outputs["postnet_outputs"]
        if linear_target is not None:
            postnet_loss = self._reg(post, linear_target, mel_lengths)
            if n_priority_freq > 0:
                postnet_loss = 0.5 * postnet_loss + 0.5 * self._reg(
                    post[..., :n_priority_freq], linear_target[..., :n_priority_freq],
                    mel_lengths)
        else:
            postnet_loss = self._reg(post, mel_target, mel_lengths)
        total = self.decoder_alpha * decoder_loss + self.postnet_alpha * postnet_loss
        parts = {"decoder_loss": decoder_loss, "postnet_loss": postnet_loss}
        if "decoder_backward_outputs" in outputs:
            dec_b = outputs["decoder_backward_outputs"]
            backward_loss = self._reg(dec_b, mel_target, mel_lengths)
            consistency = self._reg(dec_b, outputs["decoder_outputs"].detach(), mel_lengths)
            total = total + self.decoder_alpha * backward_loss + consistency
            parts["decoder_b_loss"] = backward_loss
            parts["decoder_c_loss"] = consistency
        dec_steps = (mel_lengths + r - 1) // r
        if self.stopnet:
            stop_loss = masked_bce_logits(outputs["stop_logits"], stop_targets, dec_steps,
                                          self.pos_weight)
            total = total + stop_loss
            parts["stopnet_loss"] = stop_loss
        if self.ga_alpha > 0:
            ga = guided_attention_loss(outputs["alignments"], input_lengths, dec_steps,
                                       self.ga_sigma)
            weight = self.ga_alpha
            if step is not None and self.ga_decay_steps > 0:
                weight = self.ga_alpha * max(0.0, 1.0 - step / (10.0 * self.ga_decay_steps))
            total = total + weight * ga
            parts["ga_loss"] = ga
        parts["loss"] = total
        return total, parts
