"""Int8 serving in the port: `speechless_tpu_torch/models/quantize.py`, the int8 layers
of `models/wav2letter.py` and the quantized `Transcriber`, against the JAX package's
`models/quantize.py`, `w2l.apply` on quantized params and quantized `Transcriber` on the
same numpy inputs.

Tolerances: quantized params bitwise; the weight-only forward's logits within 1e-5 of
the largest logit's magnitude (the dequantized weights are bitwise JAX's, and the fp32
convolutions sum in another order: 1.62e-5 on logits up to 8.2 here, where the float
model's gap is 1.67e-5); the int8 path's int32 sums bitwise given JAX's ``x_q``, and
the port's own ``x_q`` at most one step from JAX's (the fp32 trunk may round otherwise);
the int8 path's logits within 1e-4 (1.9e-6 measured here); transcripts exactly equal.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from speechless_tpu.features.spectrogram import features_batch as jax_features_batch
from speechless_tpu.models import quantize as jax_quantize
from speechless_tpu.models import wav2letter as jax_w2l
from speechless_tpu.serving import Transcriber as JaxTranscriber
from speechless_tpu.train.checkpoint import save_params_npz
from speechless_tpu_torch.features.spectrogram import features_batch
from speechless_tpu_torch.models import quantize
from speechless_tpu_torch.models import wav2letter as w2l
from speechless_tpu_torch.serving import Transcriber, grouped_padded_batches
from speechless_tpu_torch.train.checkpoint import load_params_npz

ALPHABET = list("abcdefghijklmnopqrstuvwxyz '")
LAYERS = (w2l.ConvSpec("striding_conv", 16, 48, 2),
          w2l.ConvSpec("inner_conv_1", 16, 7, 1),
          w2l.ConvSpec("big_conv_1", 24, 32, 1),
          w2l.ConvSpec("big_conv_2", 24, 1, 1),
          w2l.ConvSpec("output_conv", len(ALPHABET) + 1, 1, 1, "linear"))
BUCKETS = (16384,)
LOGIT_TOLERANCE = 1e-4


def _jax_config(int8_compute=False):
    return jax_w2l.Wav2LetterConfig(
        128, len(ALPHABET) + 1, int8_compute=int8_compute, layers=tuple(
            jax_w2l.ConvSpec(s.name, s.filters, s.kernel_size, s.stride, s.activation,
                             False) for s in LAYERS))


def _audio(seconds, seed):
    rng = np.random.default_rng(seed)
    t = np.arange(int(seconds * 16000)) / 16000.0
    tones = sum(0.2 * np.sin(2 * np.pi * f * t) for f in rng.uniform(100, 3000, 3))
    return (tones + 0.05 * rng.normal(size=t.size)).astype(np.float32)


AUDIOS = [_audio(s, i) for i, s in enumerate((1.0, 0.6, 0.85, 0.3, 1.02, 0.7, 0.9))]


@pytest.fixture(scope="module")
def params():
    """Seeded weights with nonzero biases (so that the empty rows of a padded group
    have activations of their own) and an output layer scaled for peaky frames."""
    config = w2l.Wav2LetterConfig(128, len(ALPHABET) + 1, layers=LAYERS)
    params = w2l.init_params(config, seed=21)
    rng = np.random.default_rng(22)
    for layer in params:
        layer["b"] = rng.normal(0.0, 0.05, layer["b"].shape).astype(np.float32)
    params[-1]["w"] = params[-1]["w"] * 10.0
    return params


def _jax_params(params):
    return [{k: jnp.asarray(v) for k, v in layer.items()} for layer in params]


def _features(seed=3):
    wavs = np.zeros((3, 12000), np.float32)
    lengths = np.asarray([12000, 7000, 3100], np.int32)
    for row, length in enumerate(lengths):
        wavs[row, :length] = _audio(length / 16000.0, seed + row)
    features, _ = features_batch(torch.from_numpy(wavs), torch.from_numpy(lengths))
    return features.numpy()


def test_quantize_functions_are_bitwise_jax(params):
    extra = params + [{"asg_transitions": np.ones((4, 4), np.float32)}]
    ours, theirs = quantize.quantize_params_int8(extra), jax_quantize.quantize_params_int8(
        _jax_params(params) + [{"asg_transitions": np.ones((4, 4), np.float32)}])
    assert len(ours) == len(theirs)
    for mine, jax_layer in zip(ours, theirs):
        assert sorted(mine) == sorted(jax_layer)
        for key in mine:
            assert mine[key].dtype == np.asarray(jax_layer[key]).dtype
            np.testing.assert_array_equal(mine[key], np.asarray(jax_layer[key]))
    for mine, jax_layer in zip(quantize.dequantize_params(ours),
                               jax_quantize.dequantize_params(theirs)):
        for key in mine:
            np.testing.assert_array_equal(mine[key], np.asarray(jax_layer[key]))
    assert quantize.quantization_error(params) == jax_quantize.quantization_error(
        _jax_params(params))
    assert quantize.INT8_MAX == jax_quantize.INT8_MAX


def test_params_from_jax_takes_the_int8_layout(params):
    qparams = quantize.quantize_params_int8(params)
    state = w2l.params_from_jax(qparams)
    for i, layer in enumerate(qparams):
        assert state["layers.{}.w_q".format(i)].dtype == torch.int8
        np.testing.assert_array_equal(state["layers.{}.w_q".format(i)].numpy(),
                                      layer["w_q"].transpose(2, 1, 0))
        np.testing.assert_array_equal(state["layers.{}.w_scale".format(i)].numpy(),
                                      layer["w_scale"])
        np.testing.assert_array_equal(state["layers.{}.bias".format(i)].numpy(), layer["b"])
    config = w2l.Wav2LetterConfig(128, len(ALPHABET) + 1, layers=LAYERS)
    model = w2l.build_model(config, qparams, device="cpu")
    assert all(isinstance(conv, w2l.QuantizedConv1d) for conv in model.layers)
    weight = model.layers[2].dequantized(torch.float32).numpy().transpose(2, 1, 0)
    np.testing.assert_array_equal(weight, np.asarray(
        jax_quantize.dequantize_params([{"w_q": qparams[2]["w_q"],
                                         "w_scale": qparams[2]["w_scale"]}])[0]["w"]))
    with pytest.raises(ValueError, match="int8"):
        w2l.params_from_jax([{"w_q": qparams[0]["w_q"].astype(np.int16),
                              "w_scale": qparams[0]["w_scale"], "b": qparams[0]["b"]}])


def test_weight_only_forward_matches_jax(params):
    qparams = quantize.quantize_params_int8(params)
    features = _features()
    want = np.asarray(jax_w2l.apply(_jax_config(), _jax_params(qparams),
                                    jnp.asarray(features)))
    config = w2l.Wav2LetterConfig(128, len(ALPHABET) + 1, layers=LAYERS)
    with torch.inference_mode():
        got = w2l.build_model(config, qparams, device="cpu")(torch.from_numpy(features))
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5 * np.abs(want).max(), rtol=0)


def _jax_big_conv_inputs(qparams, features):
    """JAX's activations entering big_conv_1 and big_conv_2 under int8_compute, from
    JAX's own layers (`_layer_apply`), with JAX's x_q and int32 sums for each."""
    config = _jax_config(int8_compute=True)
    x = jnp.asarray(features)
    found = []
    for spec, layer in zip(config.layers, _jax_params(qparams)):
        if spec.name.startswith("big_conv"):
            scale = jnp.maximum(jnp.max(jnp.abs(x)).astype(jnp.float32), 1e-12) / 127.0
            x_q = jnp.clip(jnp.round(x.astype(jnp.float32) / scale), -127.0, 127.0
                           ).astype(jnp.int8)
            acc = jax.lax.conv_general_dilated(
                x_q, layer["w_q"], window_strides=(spec.stride,), padding="SAME",
                dimension_numbers=("NWC", "WIO", "NWC"), preferred_element_type=jnp.int32)
            found.append((np.asarray(x_q), np.asarray(acc)))
        x = jax_w2l._layer_apply(config, spec, layer, x, None)
    return found


def test_int8_compute_forward_matches_jax(params):
    qparams = quantize.quantize_params_int8(params)
    features = _features()
    want = np.asarray(jax_w2l.apply(_jax_config(int8_compute=True), _jax_params(qparams),
                                    jnp.asarray(features)))
    config = w2l.Wav2LetterConfig(128, len(ALPHABET) + 1, layers=LAYERS, int8_compute=True)
    model = w2l.build_model(config, qparams, device="cpu")
    weight_only = w2l.build_model(dataclasses.replace(config, int8_compute=False), qparams,
                                  device="cpu")
    x = torch.from_numpy(features).transpose(1, 2)
    no_masks = [None] * len(LAYERS)
    with torch.inference_mode():
        got = model(torch.from_numpy(features)).numpy()
        # The input of each big conv, as the port's forward computes it.
        inputs = [model._layers(x, 0, layer, no_masks) for layer in (2, 3)]
        # The trunk stays weight-only: its output is the weight-only model's, bitwise.
        assert torch.equal(inputs[0], weight_only._layers(x, 0, 2, no_masks))
    jax_inner = _jax_big_conv_inputs(qparams, features)
    assert len(jax_inner) == 2
    for index, (x_in, (jax_x_q, jax_sums)) in enumerate(zip(inputs, jax_inner)):
        # Given JAX's x_q, the port's int32 sums equal JAX's conv bitwise.
        mine = w2l.int8_conv_sums(torch.from_numpy(jax_x_q.copy()).transpose(1, 2),
                                  model.layers[2 + index].w_q, LAYERS[2 + index])
        assert mine.dtype == torch.int32
        np.testing.assert_array_equal(mine.numpy(), jax_sums)
        x_q, _ = w2l.quantize_activations(x_in)
        steps = np.abs(x_q.transpose(1, 2).numpy().astype(np.int32) - jax_x_q)
        assert steps.max() <= 1, "x_q differs from JAX's by {} steps".format(steps.max())
    gap = float(np.abs(got - want).max())
    assert gap <= LOGIT_TOLERANCE, gap


def test_short_groups_pad_under_int8_compute(params):
    """The activation scale spans the padded batch, so under int8_compute a short group
    pads with empty rows to batch_size, as JAX does; without int8_compute it does not."""
    groups = list(grouped_padded_batches(AUDIOS[:3], lambda n: 16384, 4))
    assert [w.shape[0] for _, w, _ in groups] == [3]
    groups = list(grouped_padded_batches(AUDIOS[:3], lambda n: 16384, 4, pad_rows=True))
    assert [w.shape[0] for _, w, _ in groups] == [4]
    assert not groups[0][1][3].any() and groups[0][2][3] == 0


@pytest.fixture(scope="module")
def transcribers(params):
    """The weight-only and int8-compute transcribers of both packages (one JAX compile
    per program)."""
    config = w2l.Wav2LetterConfig(128, len(ALPHABET) + 1, layers=LAYERS)
    out = {}
    for name, options in (("weights", dict(quantize_weights=True)),
                          ("int8", dict(int8_compute=True))):
        out[name] = (Transcriber(config, params, ALPHABET, device="cpu",
                                 sample_buckets=BUCKETS, **options),
                     JaxTranscriber(_jax_config(), _jax_params(params), ALPHABET,
                                    sample_buckets=BUCKETS, **options))
    return out


@pytest.mark.parametrize("mode", ["weights", "int8"])
def test_quantized_transcripts_match_jax(transcribers, mode):
    ours, theirs = transcribers[mode]
    assert ours.quantized and theirs.quantized
    assert ours.int8_compute == theirs.int8_compute == (mode == "int8")
    assert ours.config.int8_compute == theirs.config.int8_compute
    # Seven utterances at batch_size 4: a full group of 4 and a short group of 3.
    want = theirs.transcribe_batch(AUDIOS, batch_size=4)
    got = ours.transcribe_batch(AUDIOS, batch_size=4)
    assert [text for text, _ in got] == [text for text, _ in want]
    assert any(len(text) > 3 for text, _ in got)
    np.testing.assert_allclose([c for _, c in got], [c for _, c in want], atol=1e-4)
    for mine, jax_lp in zip(ours.frame_log_probs_batch(AUDIOS[4:], batch_size=4),
                            theirs.frame_log_probs_batch(AUDIOS[4:], batch_size=4)):
        np.testing.assert_allclose(mine, jax_lp, atol=LOGIT_TOLERANCE, rtol=0)
    np.testing.assert_allclose(ours.frame_log_probs(AUDIOS[0]),
                               theirs.frame_log_probs(AUDIOS[0]), atol=LOGIT_TOLERANCE,
                               rtol=0)
    assert ours.transcribe_audio(AUDIOS[1]) == theirs.transcribe_audio(AUDIOS[1])


@pytest.mark.parametrize("mode", ["weights", "int8"])
def test_int8_compute_dispatches_padded_groups(transcribers, mode):
    """Every batched route dispatches the short group of 3 at batch_size 4 with an empty
    fourth row under int8_compute (the scale spans it in JAX too), and with 3 rows on
    weight-only serving, where rows do not interact."""
    ours, _ = transcribers[mode]
    shapes = []
    dispatch = ours._log_probs

    def spy(wavs, lengths):
        shapes.append(wavs.shape[0])
        return dispatch(wavs, lengths)

    ours._log_probs = spy
    try:
        ours.transcribe_batch(AUDIOS[4:], batch_size=4)
        ours.frame_log_probs_batch(AUDIOS[4:], batch_size=4)
        ours.frame_tokens_batch(AUDIOS[4:], batch_size=4)
    finally:
        del ours._log_probs
    assert shapes == [4 if mode == "int8" else 3] * 3


def test_quantized_npz_loads_and_serves(tmp_path, params, transcribers):
    """An .npz of w_q/w_scale layers (the JAX package's writer) loads, and a
    Transcriber serves it as it serves the params it was quantized from."""
    qparams = jax_quantize.quantize_params_int8(_jax_params(params))
    save_params_npz(tmp_path / "weights-epoch1.npz", qparams)
    loaded = load_params_npz(tmp_path / "weights-epoch1.npz")
    for mine, jax_layer in zip(loaded, qparams):
        assert sorted(mine) == ["b", "w_q", "w_scale"]
        assert mine["w_q"].dtype == np.int8
        for key in mine:
            np.testing.assert_array_equal(mine[key], np.asarray(jax_layer[key]))
    config = w2l.Wav2LetterConfig(128, len(ALPHABET) + 1, layers=LAYERS)
    served = Transcriber(config, loaded, ALPHABET, device="cpu", sample_buckets=BUCKETS)
    ours, _ = transcribers["weights"]
    np.testing.assert_array_equal(served.frame_log_probs(AUDIOS[0]),
                                  ours.frame_log_probs(AUDIOS[0]))
