"""The port's features, acoustic model, checkpoint reader and greedy decode
(`speechless_tpu_torch`) against the JAX package on the same numpy inputs.

Tolerances: features atol 2e-4 on valid frames (fp32 DFT and mel matmuls summed in
another order than XLA's; z-normalized values are O(1)); logits atol/rtol 1e-4 (fp32
convolutions, TF32 off on both sides); padded frames, frame counts, checkpoint arrays
and greedy tokens exactly equal.
"""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from speechless_tpu.features.spectrogram import features_batch as jax_features_batch
from speechless_tpu.models import wav2letter as jax_w2l
from speechless_tpu.ops.decode import greedy_decode as jax_greedy_decode
from speechless_tpu.train.checkpoint import save_params_npz
from speechless_tpu_torch.features.spectrogram import features_batch
from speechless_tpu_torch.models import wav2letter as w2l
from speechless_tpu_torch.ops.decode import greedy_decode
from speechless_tpu_torch.train.checkpoint import load_params, load_params_npz

torch.backends.cudnn.allow_tf32 = False
torch.backends.cuda.matmul.allow_tf32 = False

# A narrow stack that keeps the stride-2 k=48 striding conv and a k=32 wide conv.
SMALL_LAYERS = (
    w2l.ConvSpec("striding_conv", 16, 48, 2),
    w2l.ConvSpec("inner_conv_1", 16, 7, 1),
    w2l.ConvSpec("big_conv_1", 24, 32, 1),
    w2l.ConvSpec("big_conv_2", 24, 1, 1),
    w2l.ConvSpec("output_conv", 29, 1, 1, "linear"),
)


def _jax_config(layers, input_size=128, graphemes=29):
    return jax_w2l.Wav2LetterConfig(
        input_size_per_time_step=input_size, grapheme_set_size=graphemes,
        layers=tuple(jax_w2l.ConvSpec(s.name, s.filters, s.kernel_size, s.stride,
                                      s.activation, False) for s in layers))


def _wavs(lengths, max_len, seed=0):
    rng = np.random.default_rng(seed)
    wavs = np.zeros((len(lengths), max_len), np.float32)
    for row, length in enumerate(lengths):
        t = np.arange(length) / 16000.0
        wavs[row, :length] = (0.3 * np.sin(2 * np.pi * rng.uniform(100, 3000) * t)
                              + 0.05 * rng.normal(size=length))
    return wavs, np.asarray(lengths, np.int32)


@pytest.mark.parametrize("lengths,max_len", [
    ([4000, 2500, 5120, 300], 5120),   # uneven rows, one shorter than the reflect pad
    ([1, 129, 700], 1024),             # a 1-sample row and rows in one bucket
])
def test_features_match_jax(lengths, max_len):
    wavs, lens = _wavs(lengths, max_len)
    want, want_counts = jax_features_batch(jnp.asarray(wavs), jnp.asarray(lens))
    got, got_counts = features_batch(torch.from_numpy(wavs), torch.from_numpy(lens))
    want, got = np.asarray(want), got.numpy()
    np.testing.assert_array_equal(np.asarray(want_counts), got_counts.numpy())
    assert got.shape == want.shape and got.dtype == np.float32
    for row, count in enumerate(np.asarray(want_counts)):
        np.testing.assert_allclose(got[row, :count], want[row, :count], atol=2e-4, rtol=0)
        assert not got[row, count:].any()


@pytest.mark.parametrize("layers", [SMALL_LAYERS, None], ids=["small", "full_width"])
def test_model_logits_match_jax(layers):
    """``layers=None`` is the full-width 11-conv stack (250/2000 filters) at 1 row."""
    jax_config = _jax_config(layers) if layers else jax_w2l.Wav2LetterConfig(128, 29)
    config = w2l.Wav2LetterConfig(128, 29, layers=layers)
    params = w2l.init_params(config, seed=3)
    batch, frames = (3, 37) if layers else (1, 20)
    features = np.random.default_rng(1).normal(size=(batch, frames, 128)).astype(np.float32)
    want = np.asarray(jax_w2l.apply(jax_config, [{k: jnp.asarray(v) for k, v in p.items()}
                                                 for p in params], jnp.asarray(features)))
    model = w2l.build_model(config, params, device="cpu")
    with torch.no_grad():
        got = model(torch.from_numpy(features)).numpy()
    assert got.shape == want.shape == (batch, (frames + 1) // 2, 29)
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=1e-4)


def test_features_and_model_turn_tf32_off_themselves():
    """Every matmul and convolution of the serving path runs with TF32 off even when
    the caller turned it on, and the caller's flags come back afterwards."""
    from torch.overrides import TorchFunctionMode

    flags_seen = []

    class RecordFlags(TorchFunctionMode):
        def __torch_function__(self, func, types, args=(), kwargs=None):
            if getattr(func, "__name__", None) in ("matmul", "__matmul__", "conv1d"):
                flags_seen.append((torch.backends.cuda.matmul.allow_tf32,
                                   torch.backends.cudnn.allow_tf32))
            return func(*args, **(kwargs or {}))

    wavs, lens = _wavs([900, 2000], 2048)
    model = w2l.build_model(w2l.Wav2LetterConfig(128, 29, layers=SMALL_LAYERS),
                            w2l.init_params(w2l.Wav2LetterConfig(128, 29,
                                                                 layers=SMALL_LAYERS), 0),
                            device="cpu")
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = True
    try:
        with RecordFlags(), torch.no_grad():
            model(features_batch(torch.from_numpy(wavs), torch.from_numpy(lens))[0])
        assert (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32) \
            == (True, True)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    assert len(flags_seen) == 2 + len(SMALL_LAYERS)
    assert set(flags_seen) == {(False, False)}


def test_config_geometry_matches_jax():
    ours = w2l.Wav2LetterConfig(128, 29)
    theirs = jax_w2l.Wav2LetterConfig(128, 29)
    assert [(s.name, s.filters, s.kernel_size, s.stride, s.activation)
            for s in ours.layers] == [(s.name, s.filters, s.kernel_size, s.stride,
                                       s.activation) for s in theirs.layers]
    assert ours.input_to_prediction_length_ratio == theirs.input_to_prediction_length_ratio
    lengths = torch.tensor([0, 1, 513, 1025])
    np.testing.assert_array_equal(
        w2l.prediction_lengths(ours, lengths).numpy(),
        np.asarray(jax_w2l.prediction_lengths(theirs, jnp.asarray(lengths.numpy()))))


@pytest.mark.parametrize("length,kernel,stride", [(10, 48, 2), (11, 48, 2), (7, 7, 1),
                                                  (5, 1, 1), (3, 32, 1)])
def test_same_padding_matches_xla(length, kernel, stride):
    x = jnp.ones((1, length, 1))
    w = jnp.ones((kernel, 1, 1))
    want = np.asarray(jax.lax.conv_general_dilated(
        x, w, (stride,), "SAME", dimension_numbers=("NWC", "WIO", "NWC")))[0, :, 0]
    low, high = w2l.same_padding(length, kernel, stride)
    got = torch.nn.functional.conv1d(
        torch.nn.functional.pad(torch.ones(1, 1, length), (low, high)),
        torch.ones(1, 1, kernel), stride=stride)[0, 0].numpy()
    np.testing.assert_array_equal(got, want)


def test_weight_bridge_round_trips():
    config = w2l.Wav2LetterConfig(128, 29, layers=SMALL_LAYERS)
    params = w2l.init_params(config, seed=0)
    model = w2l.build_model(config, params, device="cpu")
    assert model.layers[0].weight.shape == (16, 128, 48)
    for before, after in zip(params, w2l.params_to_jax(model)):
        np.testing.assert_array_equal(before["w"], after["w"])
        np.testing.assert_array_equal(before["b"], after["b"])


def test_checkpoint_written_by_jax_loads(tmp_path):
    config = w2l.Wav2LetterConfig(128, 29, layers=SMALL_LAYERS)
    params = w2l.init_params(config, seed=5)
    save_params_npz(tmp_path / "weights-epoch3.npz", params)
    for loaded in (load_params(tmp_path, 3),
                   load_params_npz(tmp_path / "weights-epoch3.npz")):
        assert len(loaded) == len(params)
        for want, got in zip(params, loaded):
            np.testing.assert_array_equal(want["w"], got["w"])
            np.testing.assert_array_equal(want["b"], got["b"])


def test_quantized_checkpoint_loads(tmp_path):
    """An int8 checkpoint's ``w_q``/``w_scale`` layers load as saved (they were refused
    before quantized serving was ported) and build the int8 serving layer."""
    w_q = np.arange(-3, 3, dtype=np.int8).reshape(1, 2, 3)
    np.savez(tmp_path / "q.npz", **{"layer0.w_q": w_q,
                                    "layer0.w_scale": np.ones(3, np.float32),
                                    "layer0.b": np.zeros(3, np.float32)})
    loaded = load_params_npz(tmp_path / "q.npz")
    assert sorted(loaded[0]) == ["b", "w_q", "w_scale"] and loaded[0]["w_q"].dtype == np.int8
    np.testing.assert_array_equal(loaded[0]["w_q"], w_q)
    config = w2l.Wav2LetterConfig(2, 3, layers=(w2l.ConvSpec("output_conv", 3, 1, 1,
                                                             "linear"),))
    model = w2l.build_model(config, loaded, device="cpu")
    assert isinstance(model.layers[0], w2l.QuantizedConv1d)
    np.testing.assert_array_equal(model.layers[0].w_q.numpy(), w_q.transpose(2, 1, 0))


def test_greedy_decode_matches_jax():
    rng = np.random.default_rng(2)
    log_probs = rng.normal(size=(4, 30, 6)).astype(np.float32)
    log_probs[:, ::3, 5] += 4.0           # blank-heavy frames
    log_probs[1, 4:9, 2] += 9.0           # a run of repeats to collapse
    lengths = np.asarray([30, 17, 0, 1], np.int32)
    want = jax_greedy_decode(jnp.asarray(log_probs), jnp.asarray(lengths), 5)
    got = greedy_decode(torch.from_numpy(log_probs), torch.from_numpy(lengths), 5)
    for w, g in zip(want, got):
        assert g.dtype == torch.int32
        np.testing.assert_array_equal(np.asarray(w), g.numpy())
