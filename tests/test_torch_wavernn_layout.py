"""Host side of the WaveRNN sample-loop kernel, on the CPU: the kernel's
weight layout (`pack_weights`: rows zero-padded to a multiple of 4 floats,
a GRU unit's three gate rows side by side) and the model's cache of it
(`WaveRNN.packed_weights`). The kernel itself is held against its plain
version in tests/test_torch_cuda.py, on the card."""

import numpy as np
import pytest
import torch

from your_voice_tts_torch.ops.wavernn_gen import (generation_weights, pack_weights,
                                                  padded_widths, wavernn_generate,
                                                  wavernn_generate_plain)
from your_voice_tts_torch.vocoder.models.wavernn import WaveRNN

WIDTHS = [(20, 32, 32), (18, 30, 26), (7, 9, 13), (80, 512, 512)]


def small_weights(n_mels, rnn, fc, bits=6, seed=0):
    model = WaveRNN(n_mels=n_mels, bits=bits, rnn_dims=rnn, fc_dims=fc, compute_dims=8,
                    res_out_dims=16, num_res_blocks=1, device="cpu", seed=seed)
    return model, generation_weights(model)


def unpad(a, k):
    """The first k columns of a padded matrix, after checking the rest is 0."""
    a = a.numpy()
    assert a.shape[-1] % 4 == 0 and not a[..., k:].any()
    return a[..., :k]


@pytest.mark.parametrize("n_mels,rnn,fc", WIDTHS)
def test_packed_matrices_rebuild_every_weight(n_mels, rnn, fc):
    """Each padded matrix gives back its weight row for row; each GRU
    matrix [H, 3, K] holds unit u's gate rows r, z, n (rows u, H + u,
    2H + u of the [3H, k] weight) side by side."""
    _, w = small_weights(n_mels, rnn, fc)
    A = w["g2_wx"].shape[1] - rnn
    KI, KR, K2, KF, KF3 = padded_widths(n_mels, A, rnn, fc)
    mats = pack_weights(w)["mats"]
    assert [tuple(m.shape) for m in mats] == [
        (rnn, KI), (rnn, 3, KR), (rnn, 3, KR), (rnn, 3, K2), (rnn, 3, KR), (fc, K2), (fc, KF),
        (2 ** 6, KF3)]
    assert all(m.dtype == torch.float32 and m.is_contiguous() for m in mats)
    for m, k in zip(mats[:1] + mats[5:], ("i_wc", "fc1_w", "fc2_w", "fc3_w")):
        np.testing.assert_array_equal(unpad(m, w[k].shape[1]), w[k].numpy())
    for m, k in zip(mats[1:5], ("g1_wx", "g1_wh", "g2_wx", "g2_wh")):
        gates = unpad(m, w[k].shape[1])
        for u in (0, rnn // 2, rnn - 1):
            for g in range(3):
                np.testing.assert_array_equal(gates[u, g], w[k][g * rnn + u].numpy())


@pytest.mark.parametrize("n_mels,rnn,fc", WIDTHS[:3])
def test_packed_biases_are_the_kernels_vectors(n_mels, rnn, fc):
    """i_w0, i_b, the four GRU biases as [H, 3] (a unit's gates side by
    side), then fc1-3's biases, all contiguous with no offset."""
    _, w = small_weights(n_mels, rnn, fc)
    b = pack_weights(w)["bias"]
    assert [tuple(t.shape) for t in b] == [(rnn,), (rnn,), *[(rnn, 3)] * 4, (fc,), (fc,),
                                           (2 ** 6,)]
    np.testing.assert_array_equal(b[0].numpy(), w["i_w0"].numpy())
    for t, k in zip(b[2:6], ("g1_bx", "g1_bh", "g2_bx", "g2_bh")):
        np.testing.assert_array_equal(t.numpy(), w[k].reshape(3, rnn).T.numpy())
    np.testing.assert_array_equal(b[8].numpy(), w["fc3_b"].numpy())
    assert all(t.is_contiguous() and t.storage_offset() == 0 for t in b)


@pytest.mark.parametrize("M,A,R,Fd,want", [
    (80, 32, 512, 512, (112, 512, 544, 544, 512)), (20, 4, 32, 32, (24, 32, 36, 36, 32)),
    (18, 4, 30, 26, (24, 32, 36, 32, 28)), (7, 1, 9, 13, (8, 12, 12, 16, 16))])
def test_padded_widths(M, A, R, Fd, want):
    assert padded_widths(M, A, R, Fd) == want


def test_model_keeps_its_packed_weights_until_a_parameter_changes():
    """WaveRNN.packed_weights packs once and reuses the layout; an in-place
    edit, a state-dict load or a new tensor makes it pack again, and the
    new layout holds the new values."""
    model, _ = small_weights(20, 32, 32, seed=1)
    first = model.packed_weights()
    assert model.packed_weights() is first
    with torch.no_grad():
        model.fc2.weight[3, 5] += 1.0
    second = model.packed_weights()
    assert second is not first
    assert second["mats"][6][3, 5] == model.fc2.weight[3, 5]
    other, _ = small_weights(20, 32, 32, seed=2)
    model.load_state_dict(other.state_dict())
    third = model.packed_weights()
    assert third is not second
    for a, b in zip(third["mats"] + third["bias"], other.packed_weights()["mats"]
                    + other.packed_weights()["bias"]):
        np.testing.assert_array_equal(a.numpy(), b.numpy())
    model.rnn1.weight_hh = torch.nn.Parameter(model.rnn1.weight_hh.detach() * 2)
    assert model.packed_weights() is not third


def test_cpu_dispatch_runs_the_plain_loop_whatever_the_layout():
    """On CPU tensors `wavernn_generate` is the plain version, with or
    without a packed layout."""
    model, w = small_weights(20, 32, 32, bits=6, seed=3)
    g = torch.Generator().manual_seed(4)
    cond, aux = torch.randn(2, 12, 20, generator=g), torch.randn(2, 12, 16, generator=g)
    ref = wavernn_generate_plain(w, cond, aux, 5, bits=6)
    for packed in (None, model.packed_weights(w)):
        assert torch.equal(wavernn_generate(w, cond, aux, 5, bits=6, packed=packed), ref)
