"""The port's raw-wave model family and activations (`models/wav2letter.py`:
``use_raw_wave_input``, ``activation``), its batches (`data/batching.py`), the packed
resident corpus (`data/device_dataset.py`), its train step and its facade, against the
JAX package's on the CPU, on the same numpy inputs.

Tolerances, with their reasons:
* logits: atol 1e-5 (fp32 convolutions summed in another order; the thin models' logits
  are O(1));
* the train step: loss rtol 1e-5, parameters atol 1e-2 * lr after one Adam step (as in
  `test_torch_train.py`);
* the facade on the same weights: eval losses rtol 1e-4 (as in `test_torch_system.py`);
* layer geometry, SAME output lengths, batches, buckets, the packed corpus and
  predictions: equal.
"""
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from speechless_tpu.data import batching as jax_batching
from speechless_tpu.data import device_dataset as jax_device_dataset
from speechless_tpu.models import wav2letter as jax_w2l
from speechless_tpu.text.graphemes import CtcGraphemeCodec as JaxCtcGraphemeCodec
from speechless_tpu.train import trainer as jax_trainer
from speechless_tpu_torch.data import batching, device_dataset
from speechless_tpu_torch.models import wav2letter as w2l
from speechless_tpu_torch.text.graphemes import CtcGraphemeCodec
from speechless_tpu_torch.train import trainer

ACTIVATIONS = ["relu", "elu", "linear", "softmax"]
LR = 1e-3


def _thin_layers(activation="relu", classes=5):
    """The raw-wave geometry (wave conv k=250 s=160, striding conv k=48 s=2) at narrow
    widths."""
    return (w2l.ConvSpec("wave_conv", 8, 250, 160, activation),
            w2l.ConvSpec("striding_conv", 8, 48, 2, activation),
            w2l.ConvSpec("output_conv", classes, 1, 1, "linear"))


def _configs(layers):
    config = w2l.Wav2LetterConfig(1, layers[-1].filters, layers=layers,
                                  use_raw_wave_input=True)
    jax_config = jax_w2l.Wav2LetterConfig(
        input_size_per_time_step=1, grapheme_set_size=layers[-1].filters,
        use_raw_wave_input=True,
        layers=tuple(jax_w2l.ConvSpec(s.name, s.filters, s.kernel_size, s.stride,
                                      s.activation, False) for s in layers))
    return config, jax_config


def _jax_params(params):
    return [{k: jnp.asarray(v) for k, v in layer.items()} for layer in params]


def _spec_tuple(config):
    return [(s.name, s.filters, s.kernel_size, s.stride, s.activation, s.dropout_before)
            for s in config.layers]


@pytest.mark.parametrize("activation", ACTIVATIONS)
@pytest.mark.parametrize("dropout", [None, 0.1])
def test_layer_geometry_matches_jax(activation, dropout):
    """The full stack: wave conv first, the activation on every hidden conv, dropout
    flags, the stride ratio 320, remat blocks, freezing masks and FLOP counts."""
    ours = w2l.Wav2LetterConfig(1, 29, use_raw_wave_input=True, activation=activation,
                                dropout=dropout)
    theirs = jax_w2l.Wav2LetterConfig(1, 29, use_raw_wave_input=True, activation=activation,
                                      dropout=dropout)
    assert _spec_tuple(ours) == _spec_tuple(theirs)
    assert ours.layer_names[0] == "wave_conv" and len(ours.layers) == 12
    assert ours.input_to_prediction_length_ratio == theirs.input_to_prediction_length_ratio \
        == 320
    assert w2l._remat_block_starts(ours) == jax_w2l._remat_block_starts(theirs) == [0, 9]
    assert w2l.trainable_mask(ours, 9) == jax_w2l.trainable_mask(theirs, 9)
    assert w2l.conv_flops_per_example(ours, 131072) == \
        jax_w2l.conv_flops_per_example(theirs, 131072)
    mel = w2l.Wav2LetterConfig(128, 29, activation=activation)
    assert _spec_tuple(mel) == _spec_tuple(jax_w2l.Wav2LetterConfig(128, 29,
                                                                    activation=activation))


@pytest.mark.parametrize("samples", [159, 160, 161, 3200, 3201, 3519])
def test_wave_conv_output_length_matches_jax(samples):
    """SAME padding at stride 160 for sample counts that are and are not multiples of
    160: the same frames out, and `prediction_lengths` (samples // 320)."""
    config, jax_config = _configs(_thin_layers())
    params = w2l.init_params(config, seed=2)
    wave = np.random.default_rng(samples).normal(size=(1, samples, 1)).astype(np.float32)
    want = np.asarray(jax_w2l.apply(jax_config, _jax_params(params), jnp.asarray(wave)))
    with torch.no_grad():
        got = w2l.build_model(config, params, device="cpu")(torch.from_numpy(wave)).numpy()
    assert got.shape == want.shape == (1, -(-(-(-samples // 160)) // 2), 5)
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)
    lengths = np.array([samples, samples // 2], np.int32)
    np.testing.assert_array_equal(
        w2l.prediction_lengths(config, torch.from_numpy(lengths)).numpy(),
        np.asarray(jax_w2l.prediction_lengths(jax_config, jnp.asarray(lengths))))


@pytest.mark.parametrize("activation", ACTIVATIONS)
def test_forward_matches_jax(activation):
    """The thin raw-wave model's logits in fp32 for each activation (softmax over the
    channels) on rows of 6,400 samples."""
    config, jax_config = _configs(_thin_layers(activation))
    params = w2l.init_params(config, seed=4)
    waves = np.random.default_rng(5).normal(size=(3, 6400, 1)).astype(np.float32)
    want = np.asarray(jax_w2l.apply(jax_config, _jax_params(params), jnp.asarray(waves)))
    with torch.no_grad():
        got = w2l.build_model(config, params, device="cpu")(torch.from_numpy(waves)).numpy()
    assert got.shape == want.shape == (3, 20, 5)
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)


class FakeWave:
    """A `LabeledSpectrogram` stand-in of the raw-wave family (as `tests/test_raw_wave.py`
    has one)."""

    def __init__(self, wave, label):
        self._wave = wave.astype(np.float32)
        self.label = label

    def z_normalized_raw_wave(self):
        wave = self._wave - self._wave.mean()
        std = wave.std()
        return (wave / (std if std > 0 else 1.0)).reshape(-1, 1)


class HintedList(list):
    """A batch carrying the sharded generator's ``bucket_hints`` (frames, labels)."""
    bucket_hints = (200, 70)


def _waves(count=6):
    rng = np.random.RandomState(0)
    labels = ["ab", "ba", "a", "b", "ab a", "ba"]
    return [FakeWave(rng.randn(int(rng.randint(3000, 20000))), labels[i % len(labels)])
            for i in range(count)]


def test_raw_wave_batches_and_buckets_match_jax():
    """`batch_from_spectrograms(raw_wave=True)` bitwise, on the sample buckets (the frame
    buckets x 128), with and without the bucket hints (frames scaled by 128)."""
    assert batching.RAW_WAVE_SAMPLE_BUCKETS == jax_batching.RAW_WAVE_SAMPLE_BUCKETS
    examples = _waves()
    codec, jax_codec = CtcGraphemeCodec(list(" ab")), JaxCtcGraphemeCodec(list(" ab"))
    for batch in (examples, HintedList(examples)):
        got, got_labels = batching.batch_from_spectrograms(batch, codec, raw_wave=True)
        want, want_labels = jax_batching.batch_from_spectrograms(batch, jax_codec,
                                                                 raw_wave=True)
        assert got_labels == want_labels
        for got_field, want_field in zip(got, want):
            assert got_field.dtype == want_field.dtype
            np.testing.assert_array_equal(got_field, want_field)
    # The hints floor the buckets: 200 frames -> 25,600 samples -> the 256-frame bucket.
    assert got.inputs.shape == (6, 256 * 128, 1) and got.labels.shape == (6, 128)


@pytest.mark.parametrize("compute_dtype", ["float32", "bfloat16"])
def test_packed_resident_corpus_matches_jax(compute_dtype):
    """`build_device_dataset(raw_wave=True)` on the CPU: the (samples, 1) rows on the
    sample-bucket grid, fp16 under bf16 compute, bitwise JAX's."""
    examples = _waves()
    codec, jax_codec = CtcGraphemeCodec(list(" ab")), JaxCtcGraphemeCodec(list(" ab"))
    got, megabytes = device_dataset.build_device_dataset(
        examples, codec, "cpu", compute_dtype=getattr(torch, compute_dtype), raw_wave=True)
    want, jax_megabytes = jax_device_dataset.build_device_dataset(
        examples, jax_codec, compute_dtype=getattr(jnp, compute_dtype), raw_wave=True)
    assert megabytes == jax_megabytes
    for got_field, want_field in zip(got, want):
        want_field = np.asarray(want_field)
        assert got_field.numpy().dtype == want_field.dtype
        np.testing.assert_array_equal(got_field.numpy(), want_field)
    assert got.inputs.shape == (6, 192 * 128, 1)


def test_train_step_matches_jax():
    """One update of the thin raw-wave model on a raw batch: loss, then parameters."""
    chars = list(" ab")
    config, jax_config = _configs(_thin_layers(classes=len(chars) + 1))
    params = w2l.init_params(config, seed=6)
    batch, _ = batching.batch_from_spectrograms(_waves(4), CtcGraphemeCodec(chars),
                                                raw_wave=True, time_buckets=(20480,))
    jax_optimizer = jax_trainer.make_optimizer(LR)
    jax_state = jax_trainer.init_train_state(jax_config, jax_optimizer, jax.random.PRNGKey(0),
                                             params=_jax_params(params))
    jax_state, jax_metrics = jax_trainer.make_train_step(jax_config, jax_optimizer,
                                                         donate=False)(
        jax_state, jax_trainer.Batch(*map(jnp.asarray, batch)))
    state = trainer.init_train_state(config, trainer.make_optimizer(LR), params=params,
                                     device="cpu")
    state, metrics = trainer.make_train_step(config, None, device="cpu")(state,
                                                                         trainer.Batch(*batch))
    np.testing.assert_allclose(float(metrics["loss"]), float(jax_metrics["loss"]), rtol=1e-5)
    for want, got in zip(jax_state.params, state.params):
        for key in ("w", "b"):
            np.testing.assert_allclose(got[key], np.asarray(want[key]), rtol=0,
                                       atol=1e-2 * LR)


@pytest.fixture(scope="module")
def raw_facade(tmp_path_factory):
    """The port's raw-wave facade (published widths, fp32) trained one epoch of 2
    batches of 2 on the resident path, over the 4-utterance tree of
    `tests/test_system.py` (the host path's batches are `test_train_step_matches_jax`'s
    and `test_raw_wave_batches_and_buckets_match_jax`'s)."""
    from speechless_tpu_torch.configuration import Configuration, DataDirectories
    from speechless_tpu_torch.data import LibriSpeechCorpus, TrainingTestSplit
    from speechless_tpu_torch.system import Wav2Letter

    from test_corpus import make_librispeech_tree

    data = tmp_path_factory.mktemp("raw_facade") / "data"
    make_librispeech_tree(data / "corpus" / "English" / "mini",
                          ["hey there", "what's up", "all good", "yes"])
    config = Configuration(
        name="English", directories=DataDirectories(data), batch_size=2,
        training_batches_per_epoch=2, corpus_from_directory=lambda d: LibriSpeechCorpus(
            base_directory=d, corpus_name="mini",
            training_test_split=TrainingTestSplit.overfit(3)))
    wav2letter = Wav2Letter(1, config.allowed_characters, use_raw_wave_input=True,
                            device="cpu")
    config.train(wav2letter, run_name="raw", epoch_limit=1, callback_step=2,
                 device_resident=True)
    yield config, wav2letter, data
    shutil.rmtree(data)  # full-width checkpoints


def test_facade_raw_wave_train_and_predict(raw_facade):
    """The run checkpoints, the model predicts text, and the JAX facade loading the
    port's epoch-1 checkpoint predicts the same texts with the same eval losses."""
    from speechless_tpu.configuration import Configuration as JaxConfiguration
    from speechless_tpu.configuration import DataDirectories as JaxDataDirectories
    from speechless_tpu.data import LibriSpeechCorpus as JaxLibriSpeechCorpus
    from speechless_tpu.data import TrainingTestSplit as JaxTrainingTestSplit
    from speechless_tpu.system import Wav2Letter as JaxWav2Letter
    from speechless_tpu_torch.system import Wav2Letter

    config, wav2letter, data = raw_facade
    assert (data / "nets" / "raw" / "weights-epoch1.npz").exists()
    assert isinstance(wav2letter.predict(config.corpus.examples[0]), str)
    jax_config = JaxConfiguration(
        name="English", directories=JaxDataDirectories(data), batch_size=2,
        training_batches_per_epoch=2, corpus_from_directory=lambda d: JaxLibriSpeechCorpus(
            base_directory=d, corpus_name="mini",
            training_test_split=JaxTrainingTestSplit.overfit(3)))
    directory = data / "nets" / "raw"
    port = Wav2Letter(1, config.allowed_characters, use_raw_wave_input=True,
                      load_model_from_directory=directory, load_epoch=1, device="cpu")
    theirs = JaxWav2Letter(1, jax_config.allowed_characters, use_raw_wave_input=True,
                           load_model_from_directory=directory, load_epoch=1)
    got = port.test_and_predict_batch(config.batch_generator.labeled_test_spectrograms)
    want = theirs.test_and_predict_batch(jax_config.batch_generator.labeled_test_spectrograms)
    assert [r.predicted for r in got.results] == [r.predicted for r in want.results]
    np.testing.assert_allclose([r.loss for r in got.results],
                               [r.loss for r in want.results], rtol=1e-4)


def test_facade_guards():
    """The raw-wave family takes (samples, 1) inputs and no SpecAugment, as in JAX."""
    from speechless_tpu_torch.system import Wav2Letter

    with pytest.raises(ValueError, match="must be 1"):
        Wav2Letter(128, list(" ab"), use_raw_wave_input=True, device="cpu")
    with pytest.raises(ValueError, match="mel-feature"):
        Wav2Letter(1, list(" ab"), use_raw_wave_input=True, spec_augment=True, device="cpu")
    with pytest.raises(ValueError, match="Unknown activation"):
        w2l._activate(torch.zeros(1, 2, 3), "tanh")
