"""The port's training step (`speechless_tpu_torch.train`) against the JAX package's
(`speechless_tpu.train`) on the CPU: same numpy weights and batches, fp32, a 3-layer
narrow wav2letter.

Tolerances, with their reasons:
* loss: rtol 1e-5 (fp32 convolutions and CTC sums in another order);
* gradients: rtol 1e-4, atol 1e-5 times the layer's largest gradient;
* parameters after 3 Adam steps: atol 1e-2 * lr. Adam divides each gradient element by
  its own running RMS, so an element whose gradient is near zero moves by up to lr on
  a rounding difference; the bound is a small fraction of one step;
* optimizer leaves (Adam moments): rtol 1e-4 with an atol of 1e-4 of the leaf's largest
  magnitude (the same rounding, squared in nu);
* learning rates: rtol 1e-6 (optax computes them in fp32);
* bf16 logits: 2 % of the largest logit. Both sides round each conv output and bias to
  bf16 (8 bits of mantissa, 0.4 %), but at other places.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from speechless_tpu.models import wav2letter as jax_w2l
from speechless_tpu.train import checkpoint as jax_checkpoint
from speechless_tpu.train import trainer as jax_trainer
from speechless_tpu_torch.models import wav2letter as w2l
from speechless_tpu_torch.train import checkpoint, trainer

LAYERS = (w2l.ConvSpec("striding_conv", 16, 48, 2),
          w2l.ConvSpec("big_conv_1", 24, 7, 1),
          w2l.ConvSpec("output_conv", 6, 1, 1, "linear"))
FEATURES = 8
LR = 1e-3


def _configs(features=FEATURES, compute_dtype=torch.float32):
    config = w2l.Wav2LetterConfig(features, 6, layers=LAYERS, compute_dtype=compute_dtype)
    jax_config = jax_w2l.Wav2LetterConfig(
        input_size_per_time_step=features, grapheme_set_size=6,
        compute_dtype=jnp.bfloat16 if compute_dtype == torch.bfloat16 else jnp.float32,
        layers=tuple(jax_w2l.ConvSpec(s.name, s.filters, s.kernel_size, s.stride,
                                      s.activation, False) for s in LAYERS))
    return config, jax_config


def _batch(seed=0, batch=4, frames=40, features=FEATURES):
    """Rows of 40/30/21/36 frames (T' = 20/15/10/18) with 5/3/1/4 labels."""
    rng = np.random.default_rng(seed)
    label_lengths = np.array([5, 3, 1, 4][:batch], np.int32)
    labels = rng.integers(0, 5, (batch, 5)).astype(np.int32)
    labels[np.arange(5)[None] >= label_lengths[:, None]] = -1
    inputs = rng.normal(size=(batch, frames, features)).astype(np.float32)
    lengths = np.array([40, 30, 21, 36][:batch], np.int32)
    return inputs, lengths, labels, label_lengths


def _jax_params(params):
    return [{k: jnp.asarray(v) for k, v in layer.items()} for layer in params]


def _assert_params_close(jax_params, port_params, lr=LR):
    for want, got in zip(jax_params, port_params):
        for key in ("w", "b"):
            np.testing.assert_allclose(got[key], np.asarray(want[key]), rtol=0,
                                       atol=1e-2 * lr)


def _assert_leaves_close(jax_opt_state, port_leaves):
    want = jax.tree_util.tree_leaves(jax_opt_state)
    assert len(want) == len(port_leaves)
    for w, g in zip(want, port_leaves):
        w = np.asarray(w)
        assert w.shape == g.shape and w.dtype == g.dtype
        np.testing.assert_allclose(g, w, rtol=1e-4, atol=1e-4 * max(np.abs(w).max(), 1e-30))


def _run_both(options, criterion="ctc", steps=3, batches=None):
    """``steps`` updates of both packages from the same weights; returns both states and
    both step functions."""
    config, jax_config = _configs()
    params = w2l.init_params(config, seed=1)
    learning_rate = options.pop("schedule", None)
    jax_opt = jax_trainer.make_optimizer(
        jax_trainer.make_lr_schedule(**learning_rate) if learning_rate else LR, **options)
    port_opt = trainer.make_optimizer(
        trainer.make_lr_schedule(**learning_rate) if learning_rate else LR, **options)
    jax_state = jax_trainer.init_train_state(jax_config, jax_opt, jax.random.PRNGKey(0),
                                             params=_jax_params(params))
    port_state = trainer.init_train_state(config, port_opt, params=params, device="cpu")
    jax_step = jax_trainer.make_train_step(jax_config, jax_opt, donate=False,
                                           criterion=criterion)
    port_step = trainer.make_train_step(config, port_opt, device="cpu")
    batches = batches or [_batch(seed) for seed in range(steps)]
    for batch in batches:
        jax_state, jax_metrics = jax_step(jax_state, jax_trainer.Batch(*map(jnp.asarray,
                                                                             batch)))
        port_state, port_metrics = port_step(port_state, trainer.Batch(*batch))
        np.testing.assert_allclose(float(port_metrics["loss"]), float(jax_metrics["loss"]),
                                   rtol=1e-5)
    return jax_state, port_state, jax_step, port_step


@pytest.mark.parametrize("criterion", ["ctc", "ctc_pallas"])
def test_train_step_matches_jax(criterion):
    """Loss and gradients of the first batch, then parameters and Adam state after 3
    steps, against the JAX step on the scan CTC and on the Pallas kernels."""
    config, jax_config = _configs()
    params = w2l.init_params(config, seed=1)
    batch = _batch(0)
    (_, _), grads = jax.jit(jax.value_and_grad(
        lambda p: jax_trainer.loss_fn(jax_config, p, jax_trainer.Batch(*map(jnp.asarray,
                                                                             batch)),
                                      train=False, criterion=criterion), has_aux=True))(
        _jax_params(params))
    model = w2l.build_model(config, params, device="cpu")
    loss, _ = trainer.loss_fn(config, model, trainer.Batch(*map(torch.from_numpy, batch)))
    loss.backward()
    for want, conv in zip(grads, model.layers):
        for key, got in (("w", conv.weight.grad.numpy().transpose(2, 1, 0)),
                         ("b", conv.bias.grad.numpy())):
            want_array = np.asarray(want[key])
            np.testing.assert_allclose(got, want_array, rtol=1e-4,
                                       atol=1e-5 * np.abs(want_array).max())
    jax_state, port_state = _run_both({}, criterion)[:2]
    _assert_params_close(jax_state.params, port_state.params)
    _assert_leaves_close(jax_state.opt_state, port_state.opt_state.leaves())
    assert port_state.step == int(jax_state.step) == 3


@pytest.mark.parametrize("options", [
    {"gradient_clip_norm": 0.05},
    {"trainable": [False, True, True]},
    {"trainable": [True, False, True], "gradient_clip_norm": 0.05},
    {"schedule": {"base_learning_rate": LR, "warmup_steps": 2, "decay": "cosine",
                  "decay_steps": 5}},
], ids=["clip", "freeze", "freeze_clip", "warmup_cosine"])
def test_optimizer_options_match_optax(options):
    jax_state, port_state = _run_both(dict(options))[:2]
    _assert_params_close(jax_state.params, port_state.params)
    _assert_leaves_close(jax_state.opt_state, port_state.opt_state.leaves())
    for flag, before, after in zip(options.get("trainable", [True] * 3),
                                   w2l.init_params(_configs()[0], seed=1), port_state.params):
        assert np.array_equal(before["w"], after["w"]) != flag  # frozen layers never move


@pytest.mark.parametrize("schedule", [
    {"base_learning_rate": 1e-3},
    {"base_learning_rate": 1e-3, "warmup_steps": 10},
    {"base_learning_rate": 1e-3, "warmup_steps": 10, "decay": "cosine", "decay_steps": 100},
    {"base_learning_rate": 3e-4, "decay": "cosine", "decay_steps": 50,
     "end_value_fraction": 0.1},
], ids=["constant", "warmup", "warmup_cosine", "cosine"])
def test_learning_rate_schedules_match_optax(schedule):
    want = jax_trainer.make_lr_schedule(**schedule)
    got = trainer.make_lr_schedule(**schedule)
    if not callable(want):
        assert got == want
        return
    for count in (0, 1, 5, 9, 10, 11, 37, 55, 99, 100, 1000):
        np.testing.assert_allclose(got(count), float(want(count)), rtol=1e-6, atol=1e-12)
    with pytest.raises(ValueError, match="decay_steps"):
        trainer.make_lr_schedule(1e-3, decay="cosine")


def test_accumulation_matches_optax_and_one_double_batch():
    """k=2: two half batches step like one batch of both (the port), and the state after
    each micro-step matches optax.MultiSteps (parameters and leaves)."""
    inputs, lengths, labels, label_lengths = _batch(0)
    halves = [(inputs[rows], lengths[rows], labels[rows], label_lengths[rows])
              for rows in (slice(0, 2), slice(2, 4))]
    jax_state, port_state = _run_both({"accumulate_steps": 2},
                                      batches=halves + halves[:1])[:2]
    _assert_params_close(jax_state.params, port_state.params)
    _assert_leaves_close(jax_state.opt_state, port_state.opt_state.leaves())
    assert port_state.opt_state.mini_step == 1 and port_state.opt_state.updates == 1

    config = _configs()[0]
    params = w2l.init_params(config, seed=1)
    full = trainer.init_train_state(config, trainer.make_optimizer(LR), params=params,
                                    device="cpu")
    trainer.make_train_step(config, None, device="cpu")(full, trainer.Batch(*_batch(0)))
    optimizer = trainer.make_optimizer(LR, accumulate_steps=2)
    accumulated = trainer.init_train_state(config, optimizer, params=params, device="cpu")
    step = trainer.make_train_step(config, optimizer, device="cpu")
    step(accumulated, trainer.Batch(*halves[0]))
    for before, after in zip(params, accumulated.params):  # no update mid-accumulation
        np.testing.assert_array_equal(before["w"], after["w"])
    step(accumulated, trainer.Batch(*halves[1]))
    _assert_params_close(full.params, accumulated.params)
    with pytest.raises(ValueError, match="accumulate_steps"):
        trainer.make_optimizer(LR, accumulate_steps=0)


def _wav_batches(steps=2, batch=2, samples=3000, seed=0):
    rng = np.random.default_rng(seed)
    t = np.arange(samples) / 16000.0
    wavs = (0.3 * np.sin(2 * np.pi * rng.uniform(100, 3000, (steps, batch, 1)) * t)
            + 0.05 * rng.normal(size=(steps, batch, samples))).astype(np.float32)
    wav_lengths = np.tile(np.array([samples, samples - 700], np.int32), (steps, 1))
    labels = rng.integers(0, 5, (steps, batch, 4)).astype(np.int32)
    label_lengths = np.tile(np.array([4, 2], np.int32), (steps, 1))
    labels[:, 1, 2:] = -1
    return wavs, wav_lengths, labels, label_lengths


def test_multi_wav_step_matches_jax():
    """k=2 fused updates from raw audio (features on the device) per call, against
    JAX's `make_multi_wav_step` on the Pallas CTC: step losses, mean, parameters."""
    config, jax_config = _configs(features=128)
    params = w2l.init_params(config, seed=2)
    stacked = _wav_batches()
    jax_opt = jax_trainer.make_optimizer(LR)
    jax_state = jax_trainer.init_train_state(jax_config, jax_opt, jax.random.PRNGKey(0),
                                             params=_jax_params(params))
    jax_state, jax_metrics = jax_trainer.make_multi_wav_step(
        jax_config, jax_opt, donate=False, criterion="ctc_pallas")(
        jax_state, jax_trainer.WavBatch(*map(jnp.asarray, stacked)))
    port_opt = trainer.make_optimizer(LR)
    port_state = trainer.init_train_state(config, port_opt, params=params, device="cpu")
    port_state, port_metrics = trainer.make_multi_wav_step(config, port_opt, device="cpu")(
        port_state, trainer.WavBatch(*stacked))
    assert port_metrics["step_losses"].shape == (2,)
    np.testing.assert_allclose(port_metrics["step_losses"].numpy(),
                               np.asarray(jax_metrics["step_losses"]), rtol=1e-5)
    np.testing.assert_allclose(float(port_metrics["loss"]), float(jax_metrics["loss"]),
                               rtol=1e-5)
    _assert_params_close(jax_state.params, port_state.params)
    assert port_state.step == 2
    # One update from the first micro-batch alone: `make_wav_train_step`.
    single = trainer.init_train_state(config, port_opt, params=params, device="cpu")
    single, metrics = trainer.make_wav_train_step(config, port_opt, device="cpu")(
        single, trainer.WavBatch(*(field[0] for field in stacked)))
    np.testing.assert_allclose(float(metrics["loss"]), float(port_metrics["step_losses"][0]),
                               rtol=1e-6)
    assert single.step == 1 and metrics["per_example_loss"].shape == (2,)


def test_multi_step_matches_jax():
    """k=3 updates per call over feature batches stacked on a leading steps axis (the
    facade's ``multi_step``), against JAX's `make_multi_step`: step losses, mean,
    parameters and Adam state."""
    config, jax_config = _configs()
    params = w2l.init_params(config, seed=3)
    stacked = tuple(np.stack(fields) for fields in zip(*[_batch(seed) for seed in range(3)]))
    jax_opt = jax_trainer.make_optimizer(LR)
    jax_state = jax_trainer.init_train_state(jax_config, jax_opt, jax.random.PRNGKey(0),
                                             params=_jax_params(params))
    jax_state, jax_metrics = jax_trainer.make_multi_step(jax_config, jax_opt, donate=False)(
        jax_state, jax_trainer.Batch(*map(jnp.asarray, stacked)))
    port_opt = trainer.make_optimizer(LR)
    port_state = trainer.init_train_state(config, port_opt, params=params, device="cpu")
    port_state, port_metrics = trainer.make_multi_step(config, port_opt, device="cpu")(
        port_state, trainer.Batch(*stacked))
    np.testing.assert_allclose(port_metrics["step_losses"].numpy(),
                               np.asarray(jax_metrics["step_losses"]), rtol=1e-5)
    np.testing.assert_allclose(float(port_metrics["loss"]), float(jax_metrics["loss"]),
                               rtol=1e-5)
    _assert_params_close(jax_state.params, port_state.params)
    _assert_leaves_close(jax_state.opt_state, port_state.opt_state.leaves())
    assert port_state.step == int(jax_state.step) == 3


def test_infeasible_row_is_masked_and_gradients_stay_finite():
    """Row 0 needs 5 labels + 4 repeats = 9 frames and has 4: its loss is 0, every
    gradient is finite, and the other rows keep their losses (the JAX package's guard,
    `tests/test_train.py::TestInfeasibleLabelGuard`)."""
    config, jax_config = _configs()
    params = w2l.init_params(config, seed=1)
    inputs, lengths, labels, label_lengths = _batch(0)
    bad_lengths = lengths.copy()
    bad_lengths[0] = 8  # T' = 4
    labels = labels.copy()
    labels[0] = [0, 0, 1, 1, 2]
    batch = (inputs, bad_lengths, labels, label_lengths)
    model = w2l.build_model(config, params, device="cpu")
    loss, per_example = trainer.loss_fn(config, model, trainer.Batch(*map(torch.from_numpy,
                                                                          batch)))
    loss.backward()
    assert per_example[0].item() == 0.0 and np.isfinite(loss.item())
    assert all(torch.isfinite(p.grad).all() for p in model.parameters())
    _, want = jax.jit(lambda p, b: jax_trainer.loss_fn(jax_config, p, b, train=False,
                                                       criterion="ctc_pallas"))(
        _jax_params(params), jax_trainer.Batch(*map(jnp.asarray, batch)))
    np.testing.assert_allclose(per_example.detach().numpy(), np.asarray(want), rtol=1e-5)


def test_bf16_forward_matches_jax_bf16():
    config, jax_config = _configs(compute_dtype=torch.bfloat16)
    params = w2l.init_params(config, seed=1)
    inputs = _batch(0)[0]
    want = np.asarray(jax_w2l.apply(jax_config, _jax_params(params), jnp.asarray(inputs)))
    model = w2l.build_model(config, params, device="cpu")
    got = model(torch.from_numpy(inputs))
    assert got.dtype == torch.float32 and model.layers[0].weight.dtype == torch.float32
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=0,
                               atol=2e-2 * np.abs(want).max())
    got.sum().backward()  # gradients reach the fp32 parameters
    assert all(p.grad is not None and p.grad.dtype == torch.float32
               for p in model.parameters())


def test_eval_step_matches_jax():
    config, jax_config = _configs()
    params = w2l.init_params(config, seed=1)
    batch = _batch(0)
    want = jax_trainer.make_eval_step(jax_config)(_jax_params(params),
                                                  jax_trainer.Batch(*map(jnp.asarray, batch)))
    got = trainer.make_eval_step(config)(w2l.build_model(config, params, device="cpu"),
                                         trainer.Batch(*map(torch.from_numpy, batch)))
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]), atol=1e-5)
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
    np.testing.assert_allclose(got[2].numpy(), np.asarray(want[2]), rtol=1e-5)


@pytest.mark.parametrize("options", [{}, {"gradient_clip_norm": 0.05},
                                     {"trainable": [False, True, True],
                                      "accumulate_steps": 2}],
                         ids=["adam", "clip", "freeze_accumulate"])
def test_checkpoints_resume_across_packages(tmp_path, options):
    """Two steps in one package, a checkpoint, then the third step in the other package:
    the result equals three steps in one package, in both directions."""
    config = _configs()[0]
    batches = [_batch(seed) for seed in range(3)]
    jax_state, port_state, jax_step, port_step = _run_both(dict(options),
                                                           batches=batches[:2])
    jax_opt = jax_trainer.make_optimizer(LR, **options)
    port_opt = trainer.make_optimizer(LR, **options)

    # The port's checkpoint, resumed by JAX.
    checkpoint.save_checkpoint(tmp_path / "port", 2, port_state.params,
                               port_state.opt_state.leaves(), step=port_state.step)
    resumed = jax_trainer.TrainState(
        step=jnp.asarray(jax_checkpoint.load_step(tmp_path / "port", 2), jnp.int32),
        params=jax_checkpoint.load_params(tmp_path / "port", 2),
        opt_state=jax_checkpoint.load_opt_state(
            tmp_path / "port", 2, jax_opt.init(jax_checkpoint.load_params(tmp_path / "port",
                                                                          2))),
        dropout_rng=jax.random.PRNGKey(0))
    assert resumed.opt_state is not None
    resumed, _ = jax_step(resumed, jax_trainer.Batch(*map(jnp.asarray, batches[2])))

    # JAX's checkpoint, resumed by the port.
    jax_checkpoint.save_checkpoint(tmp_path / "jax", 2, jax_state.params,
                                   jax_state.opt_state, step=int(jax_state.step))
    port_resumed = trainer.init_train_state(
        config, port_opt, params=checkpoint.load_params(tmp_path / "jax", 2), device="cpu")
    assert checkpoint.load_opt_state(tmp_path / "jax", 2, port_resumed.opt_state) is not None
    port_resumed.step = checkpoint.load_step(tmp_path / "jax", 2)
    port_step(port_resumed, trainer.Batch(*batches[2]))

    # Both equal three uninterrupted steps in one package.
    jax_straight, _ = jax_step(jax_state, jax_trainer.Batch(*map(jnp.asarray, batches[2])))
    port_straight, _ = port_step(port_state, trainer.Batch(*batches[2]))
    _assert_params_close(jax_straight.params, resumed.params)
    _assert_params_close(port_straight.params, port_resumed.params)
    assert int(resumed.step) == port_resumed.step == 3
    # Another optimizer's state is refused, not loaded quietly.
    other = {} if "accumulate_steps" in options else {"accumulate_steps": 3}
    mismatched = trainer.init_train_state(config, trainer.make_optimizer(LR, **other),
                                          params=port_resumed.params, device="cpu")
    with pytest.raises(ValueError, match="leaves"):
        checkpoint.load_opt_state(tmp_path / "jax", 2, mismatched.opt_state)


def test_model_helpers_match_jax():
    ours, theirs = w2l.Wav2LetterConfig(128, 29), jax_w2l.Wav2LetterConfig(128, 29)
    for frames in (1, 1025):
        assert w2l.conv_flops_per_example(ours, frames) == \
            jax_w2l.conv_flops_per_example(theirs, frames)
        assert w2l.conv_flops_per_example(ours, frames, train=False) == \
            jax_w2l.conv_flops_per_example(theirs, frames, train=False)
    assert w2l.trainable_mask(ours, 3) == jax_w2l.trainable_mask(theirs, 3)


def test_unported_criteria_raise():
    """Every criterion of the JAX trainer but its TPU-only CTC spellings is ported
    (``asg`` and ``asg_trainable``: `test_torch_asg.py`); an unknown one raises, and so
    does ``asg_trainable`` on a model without ASG tables."""
    config = _configs()[0]
    model = w2l.build_model(config, w2l.init_params(config, seed=1), device="cpu")
    batch = trainer.Batch(*map(torch.from_numpy, _batch(0)))
    assert trainer.CRITERIA == ("ctc", "asg", "asg_trainable")
    with pytest.raises(ValueError, match="needs a model with ASG tables"):
        trainer.loss_fn(config, model, batch, criterion="asg_trainable")
    for criterion in ("nope", "ctc_pallas"):
        with pytest.raises(ValueError, match="Unknown criterion"):
            trainer.make_eval_step(config, criterion=criterion)
        with pytest.raises(ValueError, match="Unknown criterion"):
            trainer.make_train_step(config, None, criterion=criterion, device="cpu")
