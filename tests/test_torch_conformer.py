"""The port's Conformer-CTC (`speechless_tpu_torch.models.conformer`) and its training
through the port's trainer, against the plain reference `plain_conformer.py`, on the CPU
at a small size (d 64, 4 heads, 2 blocks, K 7) with seeded random weights in which every
bias, norm scale and position bias is drawn (none left at its constant start).

Tolerances, with their reasons:
* logits and loss: rtol 1e-5, with an atol of 1e-5 of the largest logit (fp32 on both
  sides; the sums run in another order: SDPA's fused scores, the shifted position term,
  the convs' and BatchNorm's reductions);
* gradients: rtol 1e-4 with an atol of 1e-5 of the leaf's largest gradient (fp32 backward
  through 2 blocks: the forward's rounding, amplified by the softmax and the norms);
* the first Adam step: Adam's first moment over 1 - b1 (the gradient the step used) as
  the gradients; each element's change within 1e-3 of the learning rate wherever the
  reference gradient is above 1e-3 of its leaf's largest (Adam's first step moves an
  element by lr * g / (|g| + eps), so a near-zero gradient's rounding can flip its sign);
* BatchNorm's running averages: rtol 1e-5, atol 1e-6 (means and variances of fp32
  values);
* bf16 compute: 3 % of the largest logit (bf16's 8-bit mantissa, 0.4 % a rounding,
  through two blocks).
"""
import math

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

import plain_conformer as plain
from speechless_tpu_torch.data.device_dataset import DeviceDataset
from speechless_tpu_torch.models import conformer
from speechless_tpu_torch.models import wav2letter as w2l
from speechless_tpu_torch.ops.ctc_kernels import ctc_loss_from_logits
from speechless_tpu_torch.train import trainer
from speechless_tpu_torch.utils import trace

FEATURES = 12
CLASSES = 6
LR = 1e-3
SMALL = conformer.ConformerConfig(feat_in=FEATURES, d_model=64, n_heads=4, n_layers=2,
                                  conv_kernel=7, subsampling_channels=8,
                                  grapheme_set_size=CLASSES)
# Rows of 40, 27 and 9 frames: 10, 7 and 3 output frames of the padded 10.
LENGTHS = (40, 27, 9)
LABEL_COUNTS = (4, 3, 1)


def random_params(config=SMALL, seed=0):
    """`init_params`' Glorot weights, with every other tensor drawn about its start."""
    generator = torch.Generator().manual_seed(seed + 1)
    params = conformer.init_params(config, seed)
    for name, value in params.items():
        if value.dim() == 1 or "pos_bias" in name:
            params[name] = value + 0.2 * torch.randn(value.shape, generator=generator)
    return params


def make_batch(seed=0, lengths=LENGTHS, frames=40, label_counts=LABEL_COUNTS):
    generator = torch.Generator().manual_seed(seed)
    count = len(lengths)
    inputs = torch.randn((count, frames, FEATURES), generator=generator)
    lengths = torch.tensor(lengths, dtype=torch.int32)
    inputs[torch.arange(frames)[None, :] >= lengths[:, None]] = 0.0
    label_counts = torch.tensor(label_counts[:count], dtype=torch.int32)
    labels = torch.randint(0, CLASSES - 1, (count, 4), generator=generator, dtype=torch.int32)
    labels[torch.arange(4)[None, :] >= label_counts[:, None]] = -1
    return trainer.Batch(inputs, lengths, labels, label_counts)


def reference_loss(params, batch, running=None):
    logits, frames = plain.forward(params, batch.inputs, batch.input_lengths, running)
    losses = torch.nn.functional.ctc_loss(
        logits.log_softmax(-1).transpose(0, 1), batch.labels.long().clamp(min=0),
        frames, batch.label_lengths.long(), blank=CLASSES - 1, reduction="none")
    return logits, losses.mean()


# A key bias shifts each query's scores by one constant, which softmax ignores; the
# batch mean of BatchNorm's training statistics removes the depthwise conv's bias. Either
# leaf's gradient is rounding on both sides, so it is held near 0 and not compared.
ROUNDING_ONLY = ("linear_k.bias", "depthwise_conv.bias")


def leaf_close(got, want, what):
    scale = float(want.abs().max())
    torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-5 * scale + 1e-12, msg=what)


@pytest.mark.parametrize("lengths,label_counts",
                         [(LENGTHS, LABEL_COUNTS), ((40, 40, 40), LABEL_COUNTS),
                          ((40, 1, 23), (4, 1, 3))],
                         ids=["uneven", "unpadded", "one-frame-row"])
def test_logits_loss_and_gradients_match_the_reference(lengths, label_counts):
    params = random_params()
    batch = make_batch(lengths=lengths, label_counts=label_counts)
    model = conformer.build_model(SMALL, params, device="cpu")
    got_logits = model(batch.inputs, train=True, input_lengths=batch.input_lengths)
    loss, _ = trainer.loss_fn(SMALL, model, batch)
    loss.backward()
    reference = {name: value.clone().requires_grad_(True) for name, value in params.items()}
    want_logits, want_loss = reference_loss(reference, batch)
    want_loss.backward()
    scale = float(want_logits.detach().abs().max())
    torch.testing.assert_close(got_logits.detach(), want_logits.detach(), rtol=1e-5,
                               atol=1e-5 * scale)
    torch.testing.assert_close(loss.detach(), want_loss.detach(), rtol=1e-5, atol=0.0)
    largest = max(float(p.grad.abs().max()) for p in reference.values())
    for name, param in model.named_parameters():
        if name.endswith(ROUNDING_ONLY):
            for grad in (param.grad, reference[name].grad):
                assert float(grad.abs().max()) <= 1e-6 * largest, name
            continue
        assert float(param.grad.abs().max()) > 0, name
        leaf_close(param.grad, reference[name].grad, name)


def test_rel_shift_is_the_offset_gather():
    generator = torch.Generator().manual_seed(3)
    t = 9
    scores = torch.randn((2, 3, t, 2 * t - 1), generator=generator)
    padded = torch.nn.functional.pad(scores, (1, 0))
    i, j = torch.arange(t)[:, None], torch.arange(t)[None, :]
    assert torch.equal(conformer.rel_shift(padded), scores[:, :, i, (t - 1) - (i - j)])
    nemo = padded.view(2, 3, 2 * t, t)[:, :, 1:].view(2, 3, t, 2 * t - 1)[..., :t]
    assert torch.equal(conformer.rel_shift(padded), nemo)


def test_the_sinusoids_are_nemos():
    torch.testing.assert_close(conformer.relative_positions(7, 16, "cpu"),
                               plain.sinusoids(7, 16), rtol=0, atol=2e-6)


def test_a_padded_query_row_attends_to_nothing():
    """Every row's padded queries (and a one-frame row's all but one) leave the
    attention core as zeros: the attention's output there is its projection's bias."""
    params = random_params()
    model = conformer.build_model(SMALL, params, device="cpu")
    batch = make_batch(lengths=(40, 1, 23))
    captured = []
    handle = model.layers[0].self_attn.register_forward_hook(
        lambda module, args, out: captured.append(out))
    model(batch.inputs, input_lengths=batch.input_lengths)
    handle.remove()
    frames = conformer.prediction_lengths(batch.input_lengths)
    bias = params["layers.0.self_attn.linear_out.bias"]
    for row, own in enumerate(frames.tolist()):
        assert torch.equal(captured[0][row, own:], bias.expand_as(captured[0][row, own:]))
        assert not torch.allclose(captured[0][row, :own], bias.expand(own, -1))


def test_batch_norm_running_averages_match_the_reference():
    params = random_params()
    batch = make_batch()
    model = conformer.build_model(SMALL, params, device="cpu")
    for _ in range(2):
        model(batch.inputs, train=True, input_lengths=batch.input_lengths)
    d = SMALL.d_model
    running = {name: (torch.zeros(d), torch.ones(d)) for name in plain.batch_norm_names(params)}
    for _ in range(2):
        plain.forward(params, batch.inputs, batch.input_lengths, running)
    for index, block in enumerate(model.layers):
        mean, var = running["layers.{}.conv.batch_norm".format(index)]
        norm = block.conv.batch_norm
        torch.testing.assert_close(norm.running_mean, mean, rtol=1e-5, atol=1e-6)
        torch.testing.assert_close(norm.running_var, var, rtol=1e-5, atol=1e-6)


def test_output_lengths_follow_nemos_formula():
    lengths = torch.arange(1, 200, dtype=torch.int32)
    want = torch.floor((torch.floor((lengths.double() - 1) / 2 + 1) - 1) / 2 + 1).int()
    assert torch.equal(conformer.prediction_lengths(lengths), want)
    assert torch.equal(plain.out_lengths(lengths), want)
    model = conformer.build_model(SMALL, random_params(), device="cpu")
    assert torch.equal(model.prediction_lengths(lengths), want)
    logits = model(torch.zeros((1, 2464, FEATURES)))
    assert logits.shape == (1, 616, CLASSES)


def resident(batch):
    return DeviceDataset(batch.inputs.clone(), batch.input_lengths.clone(),
                         batch.labels.clone(), batch.label_lengths.clone())


def test_one_adam_step_through_the_resident_epoch_step():
    params = random_params()
    batch = make_batch()
    optimizer = trainer.make_optimizer(LR)
    state = trainer.init_train_state(SMALL, optimizer, seed=5, params=params, device="cpu")
    epoch = trainer.make_device_epoch_step(SMALL, optimizer, batch_size=3, steps=1)
    state, out = epoch(state, resident(batch), indices=[[0, 1, 2]])
    reference = {name: value.clone().requires_grad_(True) for name, value in params.items()}
    _, want_loss = reference_loss(reference, batch)
    want_loss.backward()
    torch.testing.assert_close(out["loss"], want_loss.detach(), rtol=1e-5, atol=0.0)
    adam = state.opt_state.adam.state
    for name, param in state.model.named_parameters():
        if name.endswith(ROUNDING_ONLY):
            continue
        want = reference[name].grad
        leaf_close(adam[param]["exp_avg"] / 0.1, want, name)
        change = param.detach() - params[name]
        decided = want.abs() > 1e-3 * want.abs().max()
        torch.testing.assert_close(change[decided], -LR * torch.sign(want[decided]),
                                   rtol=0.0, atol=1e-3 * LR, msg=name)
        assert float(change.abs().max()) <= LR + 1e-6  # the change is rounded to fp32
    assert state.step == 1


def w2l_state():
    layers = (w2l.ConvSpec("striding_conv", 8, 5, 2), w2l.ConvSpec("big_conv_1", 8, 3, 1),
              w2l.ConvSpec("output_conv", CLASSES, 1, 1, "linear"))
    config = w2l.Wav2LetterConfig(FEATURES, CLASSES, layers=layers)
    optimizer = trainer.make_optimizer(LR)
    return config, optimizer, trainer.init_train_state(config, optimizer, seed=2,
                                                       device="cpu")


def test_a_conformer_and_a_wav2letter_state_train_side_by_side():
    """Two families in one process, their calls interleaved: each state ends where the
    same family trained alone ends."""
    dataset = resident(make_batch(seed=1))
    calls = ([[0, 1], [2, 0]], [[1, 2], [0, 2]])  # two calls of two steps of two rows

    def conformer_state():
        optimizer = trainer.make_optimizer(LR)
        return SMALL, optimizer, trainer.init_train_state(
            SMALL, optimizer, seed=3, params=random_params(seed=4), device="cpu")

    def train(states, order):
        epochs = [trainer.make_device_epoch_step(config, optimizer, 2, 2)
                  for config, optimizer, _ in states]
        for which, call in order:
            epochs[which](states[which][2], dataset, indices=calls[call])
        return [state for _, _, state in states]

    alone = train([w2l_state(), conformer_state()], [(0, 0), (0, 1), (1, 0), (1, 1)])
    mixed = train([w2l_state(), conformer_state()], [(0, 0), (1, 0), (0, 1), (1, 1)])
    for one, other in zip(alone, mixed):
        assert one.step == other.step == 4
        for (name, a), b in zip(one.model.named_parameters(), other.model.parameters()):
            assert torch.equal(a, b), name


def test_counters_and_spans_while_a_profiler_records():
    model = conformer.build_model(SMALL, random_params(), device="cpu")
    batch = make_batch()
    with profile(activities=[ProfilerActivity.CPU]):
        model(batch.inputs, input_lengths=batch.input_lengths)
        recorded = trace.snapshot()
    counters = recorded["counters"]
    assert counters["conformer.attn_pairs"] == 3 * 10 * 10
    assert counters["conformer.attn_pairs_own"] == 10 ** 2 + 7 ** 2 + 3 ** 2
    names = [kept["name"] for kept in recorded["spans"]]
    assert names.count("conformer.subsample") == 1
    assert names.count("conformer.attention") == names.count("conformer.conv") == 2
    model(batch.inputs, input_lengths=batch.input_lengths)  # profiler off: nothing kept
    assert trace.snapshot()["counters"] == counters


def test_dropout_draws_from_the_generator():
    config = conformer.ConformerConfig(**{**SMALL.__dict__, "dropout": 0.3})
    params = random_params()
    batch = make_batch()

    def run(seed, train=True):
        model = conformer.build_model(config, params, device="cpu")
        generator = torch.Generator().manual_seed(seed)
        return model(batch.inputs, train=train, generator=generator,
                     input_lengths=batch.input_lengths)

    assert torch.equal(run(1), run(1))
    assert not torch.equal(run(1), run(2))
    assert torch.equal(run(1, train=False), run(2, train=False))
    with pytest.raises(ValueError, match="generator"):
        conformer.build_model(config, params, device="cpu")(batch.inputs, train=True)


def test_bf16_compute_stays_near_the_fp32_reference():
    config = conformer.ConformerConfig(**{**SMALL.__dict__, "compute_dtype": torch.bfloat16})
    params = random_params()
    batch = make_batch()
    with torch.no_grad():
        got = conformer.build_model(config, params, device="cpu")(
            batch.inputs, train=True, input_lengths=batch.input_lengths)
        want, _ = plain.forward(params, batch.inputs, batch.input_lengths)
    assert got.dtype == torch.float32
    scale = float(want.abs().max())
    assert float((got - want).abs().max()) <= 0.03 * scale
    assert not torch.equal(got, want)


def test_eval_step_reads_running_averages_and_the_ctc_kernels_route():
    params = random_params()
    batch = make_batch()
    model = conformer.build_model(SMALL, params, device="cpu")
    log_probs, lengths, per_example = trainer.make_eval_step(SMALL)(model, batch)
    logits = model(batch.inputs, input_lengths=batch.input_lengths)
    torch.testing.assert_close(log_probs, logits.log_softmax(-1))
    assert lengths.tolist() == [10, 7, 3]
    want = ctc_loss_from_logits(logits, lengths, batch.labels, batch.label_lengths,
                                CLASSES - 1)
    torch.testing.assert_close(per_example, want)


def test_init_and_build_check_the_parameters():
    params = conformer.init_params(SMALL, 0)
    count = sum(value.numel() for value in params.values())
    assert count == sum(p.numel() for p in conformer.Conformer(SMALL, device="cpu")
                        .parameters())
    assert torch.equal(params["layers.1.norm_out.weight"], torch.ones(SMALL.d_model))
    assert not params["layers.0.self_attn.pos_bias_u"].any()
    limit = math.sqrt(6.0 / (64 + 256))
    weight = params["layers.0.feed_forward1.linear1.weight"]
    assert 0.9 * limit < float(weight.abs().max()) <= limit
    with pytest.raises(ValueError, match="lack"):
        conformer.build_model(SMALL, {k: v for k, v in params.items()
                                      if k != "decoder.bias"}, device="cpu")
    with pytest.raises(ValueError, match="shape"):
        conformer.build_model(SMALL, dict(params, **{"decoder.bias": torch.zeros(3)}),
                              device="cpu")


def test_the_large_config_counts_nemos_parameters():
    large = conformer.Conformer(conformer.ConformerConfig(), device="meta")
    count = sum(p.numel() for p in large.parameters())
    assert 121_000_000 < count < 122_000_000
    assert len(large.parameter_layers()) == 20


def test_a_conformer_refuses_a_mesh():
    with pytest.raises(ValueError, match="mesh"):
        trainer.init_train_state(SMALL, trainer.make_optimizer(LR), params=random_params(),
                                 device="cpu", mesh=object())
