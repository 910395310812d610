"""The port's device-resident corpus and training options against the JAX package's on
the CPU: `data/device_dataset.py` (packing), `trainer.make_device_epoch_step` on JAX's
sampled indices, SpecAugment on JAX's uniform draws, dropout on JAX's keep masks, remat,
and the facade's device-resident training.

Tolerances, with their reasons:
* packed corpora and SpecAugment outputs: equal (the same numpy padding; the same fp32
  floor and compare arithmetic on the same draws);
* per-step losses of the resident epoch: rtol 1e-5, and parameters after it: atol
  1e-2 * lr, as `test_torch_train.py` holds the single step (fp32 convolutions and CTC
  sums in another order, which Adam turns into at most a small fraction of one step);
* logits with dropout on JAX's masks: atol 1e-5 of the largest logit (fp32 convolutions
  in another order);
* gradients with and without remat: equal (the recompute runs the same CPU kernels on
  the same inputs).
JAX draws its batch indices, masks and uniforms from keys that torch cannot reproduce,
so every cross-package comparison feeds JAX's draws to the port; the port's own draws
are held to their contracts (without replacement, inside the length, seeded).
"""
import csv

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from speechless_tpu.data.device_dataset import build_device_dataset as jax_build
from speechless_tpu.data.device_dataset import pack_dataset as jax_pack
from speechless_tpu.models import wav2letter as jax_w2l
from speechless_tpu.ops.specaugment import SpecAugment as JaxSpecAugment
from speechless_tpu.ops.specaugment import apply_spec_augment as jax_apply_spec_augment
from speechless_tpu.text.graphemes import CtcGraphemeEncoding
from speechless_tpu.train import trainer as jax_trainer
from speechless_tpu_torch.data import device_dataset
from speechless_tpu_torch.data.batching import batch_from_spectrograms
from speechless_tpu_torch.data.device_dataset import (DeviceDataset, build_device_dataset,
                                                      pack_dataset)
from speechless_tpu_torch.models import wav2letter as w2l
from speechless_tpu_torch.ops import ctc_kernels
from speechless_tpu_torch.ops.specaugment import (Draws, SpecAugment, apply_spec_augment,
                                                  masks)
from speechless_tpu_torch.system import Wav2Letter
from speechless_tpu_torch.text.graphemes import CtcGraphemeCodec
from speechless_tpu_torch.train import trainer

from conftest import FakeSpectrogram

ALPHABET = list("abcd")
LR = 1e-3
FEATURES = 8
LAYERS = (w2l.ConvSpec("striding_conv", 16, 48, 2, "relu", True),
          w2l.ConvSpec("inner_conv_1", 12, 7, 1, "relu", True),
          w2l.ConvSpec("big_conv_1", 24, 7, 1),
          w2l.ConvSpec("output_conv", len(ALPHABET) + 1, 1, 1, "linear"))


def _configs(dropout=None, remat=False, compute_dtype=torch.float32):
    config = w2l.Wav2LetterConfig(FEATURES, len(ALPHABET) + 1, layers=LAYERS,
                                  compute_dtype=compute_dtype, dropout=dropout, remat=remat)
    jax_config = jax_w2l.Wav2LetterConfig(
        input_size_per_time_step=FEATURES, grapheme_set_size=len(ALPHABET) + 1,
        dropout=dropout, remat=remat,
        compute_dtype=jnp.bfloat16 if compute_dtype == torch.bfloat16 else jnp.float32,
        layers=tuple(jax_w2l.ConvSpec(*spec.__dict__.values()) for spec in LAYERS))
    return config, jax_config


def _examples(count=8, seed=0):
    rng = np.random.RandomState(seed)
    labels = ["ab", "ba", "abc", "c", "cab", "bc", "dd", "a"]
    return [FakeSpectrogram(rng.randn(int(rng.randint(20, 41)), FEATURES).astype(np.float32),
                            labels[i % len(labels)]) for i in range(count)]


def _jax_params(params):
    return [{k: jnp.asarray(v) for k, v in layer.items()} for layer in params]


@pytest.mark.parametrize("dtype, buckets", [(np.float32, None), (np.float16, None),
                                            (np.float32, (16, 24, 48))])
def test_pack_dataset_is_bitwise_the_jax_packing(dtype, buckets):
    examples = _examples(count=7)
    spectrograms = [e.z_normalized_transposed_spectrogram() for e in examples]
    labels = [e.label for e in examples]
    options = {"dtype": dtype} if buckets is None else {"dtype": dtype,
                                                        "time_buckets": buckets}
    got = pack_dataset(spectrograms, labels, CtcGraphemeCodec(ALPHABET), **options)
    want = jax_pack(spectrograms, labels, CtcGraphemeEncoding(ALPHABET), **options)
    for mine, theirs in zip(got, want):
        assert mine.dtype == theirs.dtype and mine.shape == theirs.shape
        np.testing.assert_array_equal(mine, theirs)
    assert got.nbytes() == want.nbytes() and got.example_count == 7


def test_build_device_dataset_ships_fp16_under_bf16():
    examples = _examples()
    codec = CtcGraphemeCodec(ALPHABET)
    dataset, megabytes = build_device_dataset(examples, codec, "cpu",
                                              compute_dtype=torch.bfloat16)
    want, want_megabytes = jax_build(examples, CtcGraphemeEncoding(ALPHABET),
                                     compute_dtype=jnp.bfloat16)
    assert dataset.inputs.dtype == torch.float16 and isinstance(dataset, DeviceDataset)
    for mine, theirs in zip(dataset, want):
        np.testing.assert_array_equal(mine.numpy(), np.asarray(theirs))
    assert megabytes == want_megabytes == dataset.nbytes() / 1e6
    host, _ = batch_from_spectrograms(examples, codec)
    rows = dataset.input_lengths.numpy()
    assert rows.tolist() == host.input_lengths.tolist()


def test_a_corpus_that_does_not_fit_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "mem_get_info", lambda device: (10 << 30, 80 << 30))
    device_dataset.check_fits(1 << 30, "cuda:0")
    with pytest.raises(MemoryError, match="host pipeline"):
        device_dataset.check_fits(3 << 30, "cuda:0")
    device_dataset.check_fits(1 << 40, "cpu")


def _jax_epoch_indices(rng, count, batch_size, steps):
    """The indices JAX's `make_device_epoch_step` draws for ``rng``."""
    return np.stack([np.asarray(jax.random.choice(key, count, (batch_size,), replace=False))
                     for key in jax.random.split(rng, steps)])


@pytest.mark.parametrize("trainable", [None, (False, True, True, True)])
def test_device_epoch_step_matches_jax_on_its_indices(trainable):
    """3 updates of 4 rows over a resident corpus of 8: JAX's epoch draws its indices
    from a key; the port takes the same indices. Step losses, the mean and parameters."""
    config, jax_config = _configs()
    examples = _examples()
    params = w2l.init_params(config, seed=1)
    dataset, _ = build_device_dataset(examples, CtcGraphemeCodec(ALPHABET), "cpu")
    jax_dataset, _ = jax_build(examples, CtcGraphemeEncoding(ALPHABET))
    key = jax.random.PRNGKey(9)
    jax_opt = jax_trainer.make_optimizer(LR, trainable=trainable)
    jax_state = jax_trainer.init_train_state(jax_config, jax_opt, jax.random.PRNGKey(0),
                                             params=_jax_params(params))
    jax_state, jax_metrics = jax_trainer.make_device_epoch_step(
        jax_config, jax_opt, batch_size=4, steps=3, donate=False)(jax_state, jax_dataset, key)
    port_opt = trainer.make_optimizer(LR, trainable=trainable)
    state = trainer.init_train_state(config, port_opt, params=params, device="cpu")
    epoch = trainer.make_device_epoch_step(config, port_opt, batch_size=4, steps=3)
    launches = ctc_kernels.ctc_alpha.launches
    state, metrics = epoch(state, dataset, indices=_jax_epoch_indices(key, 8, 4, 3))
    assert ctc_kernels.ctc_alpha.launches == launches  # CPU tensors: the plain version
    np.testing.assert_allclose(metrics["step_losses"].numpy(),
                               np.asarray(jax_metrics["step_losses"]), rtol=1e-5)
    np.testing.assert_allclose(float(metrics["loss"]), float(jax_metrics["loss"]), rtol=1e-5)
    for want, got in zip(jax_state.params, state.params):
        for k in ("w", "b"):
            np.testing.assert_allclose(got[k], np.asarray(want[k]), rtol=0, atol=1e-2 * LR)
    assert state.step == int(jax_state.step) == 3
    if trainable is not None:
        np.testing.assert_array_equal(state.params[0]["w"], params[0]["w"])


def test_device_epoch_step_draws_without_replacement():
    generator = torch.Generator().manual_seed(3)
    seen = set()
    for _ in range(10):
        indices = trainer.sample_indices(6, 4, 3, generator)
        assert indices.shape == (3, 4) and indices.dtype == torch.int64
        assert all(len(set(row.tolist())) == 4 for row in indices)
        seen.update(indices.flatten().tolist())
    assert seen == set(range(6))
    again = trainer.sample_indices(6, 4, 3, torch.Generator().manual_seed(3))
    np.testing.assert_array_equal(again.numpy(),
                                  trainer.sample_indices(6, 4, 3, torch.Generator()
                                                         .manual_seed(3)).numpy())
    config = _configs()[0]
    state = trainer.init_train_state(config, trainer.make_optimizer(LR), device="cpu")
    dataset, _ = build_device_dataset(_examples(), CtcGraphemeCodec(ALPHABET), "cpu")
    epoch = trainer.make_device_epoch_step(config, trainer.make_optimizer(LR), 4, 2)
    state, metrics = epoch(state, dataset, torch.Generator().manual_seed(0))
    assert state.step == 2 and np.isfinite(metrics["step_losses"].numpy()).all()


def test_device_epoch_step_refuses_a_batch_larger_than_the_corpus():
    config = _configs()[0]
    optimizer = trainer.make_optimizer(LR)
    state = trainer.init_train_state(config, optimizer, device="cpu")
    dataset, _ = build_device_dataset(_examples(count=3), CtcGraphemeCodec(ALPHABET), "cpu")
    with pytest.raises(ValueError, match="exceeds corpus size"):
        trainer.make_device_epoch_step(config, optimizer, 4, 1)(
            state, dataset, torch.Generator())
    with pytest.raises(ValueError, match="indices of shape"):
        trainer.make_device_epoch_step(config, optimizer, 2, 2)(
            state, dataset, indices=np.zeros((1, 2), np.int32))


def _jax_draws(key, batch, config):
    """The uniforms JAX's `apply_spec_augment` draws from ``key``."""
    def pair(rng, count):
        width_rng, start_rng = jax.random.split(rng)
        return (np.asarray(jax.random.uniform(width_rng, (batch, count))),
                np.asarray(jax.random.uniform(start_rng, (batch, count))))

    freq_rng, time_rng = jax.random.split(key)
    return Draws(*map(torch.tensor, pair(freq_rng, config.frequency_mask_count)
                      + pair(time_rng, config.time_mask_count)))


@pytest.mark.parametrize("options", [
    {}, {"frequency_mask_width": 20, "time_mask_fraction": 0.1},
    {"frequency_mask_count": 0, "time_mask_fraction": 0.5, "time_mask_count": 3},
    {"frequency_mask_width": 200, "frequency_mask_count": 3, "time_mask_count": 1}])
def test_spec_augment_equals_jax_on_its_draws(options):
    rng = np.random.RandomState(0)
    inputs = rng.randn(4, 200, 128).astype(np.float32)
    lengths = np.array([200, 150, 90, 7], np.int32)
    for i, n in enumerate(lengths):
        inputs[i, n:] = 0.0
    for seed in range(3):
        key = jax.random.PRNGKey(seed)
        want = np.asarray(jax_apply_spec_augment(key, jnp.asarray(inputs),
                                                 jnp.asarray(lengths),
                                                 JaxSpecAugment(**options)))
        got = apply_spec_augment(torch.from_numpy(inputs), torch.from_numpy(lengths),
                                 SpecAugment(**options),
                                 draws=_jax_draws(key, 4, SpecAugment(**options)))
        np.testing.assert_array_equal(got.numpy(), want)
    assert SpecAugment() == SpecAugment(**JaxSpecAugment().__dict__)


def test_spec_augment_from_a_generator_stays_inside_each_length():
    inputs = torch.ones((3, 60, 16), dtype=torch.float16)
    lengths = torch.tensor([60, 30, 5], dtype=torch.int32)
    config = SpecAugment(frequency_mask_count=0, time_mask_fraction=0.5, time_mask_count=3)
    first = apply_spec_augment(inputs, lengths, config,
                               generator=torch.Generator().manual_seed(1))
    assert first.dtype == torch.float16
    for row, length in enumerate(lengths.tolist()):
        assert (first[row, length:] == 1).all()
        assert (first[row, :length] == 0).any(dim=1).sum() <= 3 * (length // 2)
    again = apply_spec_augment(inputs, lengths, config,
                               generator=torch.Generator().manual_seed(1))
    assert torch.equal(first, again)
    time, frequency = masks(Draws(*(torch.zeros(3, c) for c in (2, 2, 1, 1))), lengths, 60,
                            16, SpecAugment(time_mask_count=1))
    assert not time.any() and not frequency.any()  # width floor(0 * ...) = 0
    with pytest.raises(ValueError, match="generator or the draws"):
        apply_spec_augment(inputs, lengths, config)


def _jax_dropout_masks(jax_config, key, batch, frames):
    """JAX's keep masks: `apply` splits ``key`` into one key a layer and draws a
    Bernoulli(1 - rate) mask of each dropped layer's input shape."""
    keys = jax.random.split(key, len(jax_config.layers))
    shapes = w2l.Wav2LetterConfig(FEATURES, 5, layers=LAYERS).layer_input_shapes(batch,
                                                                                   frames)
    return [torch.tensor(np.asarray(jax.random.bernoulli(
        k, 1.0 - jax_config.dropout, shape))) if spec.dropout_before else None
        for k, spec, shape in zip(keys, jax_config.layers, shapes)]


@pytest.mark.parametrize("remat", [False, True])
def test_dropout_on_jax_masks_matches_jax_logits(remat):
    config, jax_config = _configs(dropout=0.3, remat=remat)
    params = w2l.init_params(config, seed=2)
    inputs = np.random.default_rng(1).normal(size=(3, 41, FEATURES)).astype(np.float32)
    key = jax.random.PRNGKey(4)
    want = np.asarray(jax_w2l.apply(jax_config, _jax_params(params), jnp.asarray(inputs),
                                    train=True, dropout_rng=key))
    model = w2l.build_model(config, params, device="cpu")
    got = model(torch.from_numpy(inputs), train=True,
                dropout_masks=_jax_dropout_masks(jax_config, key, 3, 41)).detach().numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5 * np.abs(want).max())
    inference = model(torch.from_numpy(inputs)).detach().numpy()
    np.testing.assert_allclose(inference, np.asarray(jax_w2l.apply(
        jax_config, _jax_params(params), jnp.asarray(inputs))), rtol=0,
        atol=1e-5 * np.abs(want).max())
    assert not np.allclose(got, inference)
    with pytest.raises(ValueError, match="generator or the masks"):
        model(torch.from_numpy(inputs), train=True)


@pytest.mark.parametrize("compute_dtype", [torch.float32, torch.bfloat16])
def test_remat_gradients_equal_the_stored_ones(compute_dtype):
    """Loss and every parameter gradient with remat equal those without it, with
    dropout on the same masks and with the first layer frozen."""
    batch = trainer.Batch(*map(torch.from_numpy, (
        np.random.default_rng(3).normal(size=(2, 40, FEATURES)).astype(np.float32),
        np.array([40, 33], np.int32), np.array([[0, 1, 2], [3, -1, -1]], np.int32),
        np.array([3, 1], np.int32))))
    gradients = {}
    for remat in (False, True):
        config = _configs(dropout=0.2, remat=remat, compute_dtype=compute_dtype)[0]
        model = w2l.build_model(config, w2l.init_params(config, seed=5), device="cpu")
        model.layers[0].weight.requires_grad_(False)
        masks_ = w2l.draw_dropout_masks(config, 2, 40, torch.Generator().manual_seed(7),
                                        "cpu")
        loss, _ = trainer.loss_fn(config, model, batch, dropout_masks=masks_)
        loss.backward()
        gradients[remat] = [loss.detach()] + [p.grad for p in model.parameters()
                                              if p.requires_grad]
    assert len(gradients[True]) == len(gradients[False]) == 8  # the loss, 7 gradients
    for with_remat, stored in zip(gradients[True], gradients[False]):
        assert torch.equal(with_remat, stored)


def test_train_steps_augment_and_drop_out_from_the_state_generator():
    """`make_train_step` with SpecAugment and dropout draws from the state's generator:
    the same seed gives the same losses, and they differ from a plain step's."""
    config = _configs(dropout=0.2)[0]
    examples = _examples()
    batch, _ = batch_from_spectrograms(examples[:4], CtcGraphemeCodec(ALPHABET))
    losses = {}
    for name, spec_augment, seed in (("a", SpecAugment(frequency_mask_width=3), 0),
                                     ("b", SpecAugment(frequency_mask_width=3), 0),
                                     ("c", SpecAugment(frequency_mask_width=3), 1)):
        state = trainer.init_train_state(config, trainer.make_optimizer(LR), seed=seed,
                                         params=w2l.init_params(config, 0), device="cpu")
        step = trainer.make_train_step(config, trainer.make_optimizer(LR), device="cpu",
                                       spec_augment=spec_augment)
        losses[name] = [float(step(state, batch)[1]["loss"]) for _ in range(2)]
    assert losses["a"] == losses["b"] and losses["a"] != losses["c"]
    assert np.isfinite(losses["c"]).all()


def _facade(tmp_path, **kwargs):
    """A port facade on the narrow model (as `tests/test_device_dataset.py` narrows the
    JAX one)."""
    facade = Wav2Letter(FEATURES, ALPHABET, learning_rate=LR, device="cpu", **kwargs)
    facade.config = _configs(dropout=kwargs.get("dropout"),
                             remat=kwargs.get("remat", False))[0]
    facade.optimizer = trainer.make_optimizer(LR)
    facade.state = trainer.init_train_state(facade.config, facade.optimizer, device="cpu")
    facade._eval_step = trainer.make_eval_step(facade.config)
    return facade


def test_system_train_device_resident_end_to_end(tmp_path, caplog):
    facade = _facade(tmp_path, spec_augment=True, dropout=0.1, remat=True)
    examples = _examples()
    facade.train([], preview_labeled_spectrogram_batch=examples[:2],
                 tensor_board_log_directory=tmp_path / "logs", net_directory=tmp_path / "nets",
                 batches_per_epoch=3, epoch_limit=2, callback_step=1,
                 device_resident_examples=examples, batch_size=4)
    assert (tmp_path / "nets" / "weights-epoch1.npz").exists()
    assert (tmp_path / "nets" / "weights-epoch2.npz").exists()
    with (tmp_path / "logs" / "scalars.csv").open() as f:
        rows = list(csv.DictReader(f))
    assert [(row["epoch"], row["step"]) for row in rows] == [("1", "3"), ("2", "6")]
    assert all(np.isfinite(float(row["loss"])) for row in rows)
    assert "Device-resident corpus: 8 examples" in caplog.text
    assert "utterances/s (device-resident)" in caplog.text
    assert "Average over 2 examples" in caplog.text


def test_system_refuses_a_resident_batch_larger_than_the_corpus(tmp_path):
    facade = _facade(tmp_path)
    examples = _examples(count=2)
    with pytest.raises(ValueError, match="exceeds corpus size"):
        facade.train([], preview_labeled_spectrogram_batch=examples,
                     tensor_board_log_directory=tmp_path / "logs",
                     net_directory=tmp_path / "nets", batches_per_epoch=2,
                     device_resident_examples=examples, batch_size=4)
    assert not (tmp_path / "logs").exists()
