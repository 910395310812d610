"""The data-gradient route of the bf16 training path's stride-1 convs
(`speechless_tpu_torch/ops/conv_dgrad.py`) on the CPU, where the kernel's plain version
`dgrad_reference` stands in for ``csrc/conv_dgrad.cu``: its gradient against autograd
through ``F.pad`` + ``F.conv1d``, `gradcheck`, the forward and weight gradient bitwise
the previous path's, the route by shape, the trace counters, a frozen input, remat, and
a whole bf16 training step against the previous path. The kernel itself runs only on
the card (`chip_smoke.py --dgrad-only`, phase L)."""
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from speechless_tpu_torch.models import wav2letter as w2l
from speechless_tpu_torch.ops import conv_dgrad
from speechless_tpu_torch.train import trainer
from speechless_tpu_torch.utils import trace

FEATURES = 8
# big_conv_1's 32 taps and an inner conv's 7 take the kernel's route; a 3-tap conv,
# narrower than any the kernel was measured at, keeps cuDNN's.
LAYERS = (w2l.ConvSpec("striding_conv", 16, 48, 2, "relu", True),
          w2l.ConvSpec("inner_conv_1", 12, 7, 1, "relu", True),
          w2l.ConvSpec("inner_conv_2", 12, 3, 1, "relu", True),
          w2l.ConvSpec("big_conv_1", 24, 32, 1),
          w2l.ConvSpec("big_conv_2", 24, 1, 1),
          w2l.ConvSpec("output_conv", 6, 1, 1, "linear"))


def _padding(taps):
    return w2l.same_padding(1, taps, 1)


def _previous(x, weight, padding):
    """The path the Function replaced: autograd through ``F.pad`` and ``F.conv1d``."""
    return F.conv1d(F.pad(x, padding), weight)


def _case(batch, cout, cin, taps, frames, dtype, seed=0):
    generator = torch.Generator().manual_seed(seed)
    x = torch.randn((batch, cin, frames), generator=generator).to(dtype)
    weight = (torch.randn((cout, cin, taps), generator=generator)
              / (cin * taps) ** 0.5).to(dtype)
    grad = torch.randn((batch, cout, frames), generator=generator).to(dtype)
    return x, weight, grad


def _gradients(conv, x, weight, grad, padding):
    x, weight = x.clone().requires_grad_(), weight.clone().requires_grad_()
    out = conv(x, weight, padding)
    out.backward(grad)
    return out.detach(), x.grad, weight.grad


@pytest.mark.parametrize("frames", [9, 5, 1], ids=["odd", "below_taps", "one"])
@pytest.mark.parametrize("cout", [2000, 1000, 37])
@pytest.mark.parametrize("taps", [7, 32])
def test_data_gradient_equals_autograd_through_pad_and_conv(taps, cout, frames):
    """In fp32 the Function's data gradient, and `dgrad_reference` called alone, equal
    autograd through ``F.pad`` + ``F.conv1d`` within 1e-6 of the largest |dX| (sums of up
    to 64,000 products in other orders)."""
    x, weight, grad = _case(2, cout, 250, taps, frames, torch.float32)
    padding = _padding(taps)
    _, want, _ = _gradients(_previous, x, weight, grad, padding)
    _, got, _ = _gradients(conv_dgrad.same_conv1d, x, weight, grad, padding)
    alone = conv_dgrad.dgrad_reference(grad, weight, padding[0])
    atol = 1e-6 * float(want.abs().max())
    torch.testing.assert_close(got, want, rtol=1e-6, atol=atol)
    torch.testing.assert_close(alone, want, rtol=1e-6, atol=atol)


@pytest.mark.parametrize("taps", [3, 32], ids=["cudnn_route", "kernel_route"])
def test_gradcheck_in_fp64(taps):
    x, weight, _ = _case(2, 4, 3, taps, 5, torch.float64, seed=1)
    assert conv_dgrad.takes_kernel(weight) == (taps == 32)
    assert torch.autograd.gradcheck(
        lambda a, b: conv_dgrad.same_conv1d(a, b, _padding(taps)),
        (x.requires_grad_(), weight.requires_grad_()))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("taps", [3, 7, 32])
def test_forward_and_weight_gradient_are_bitwise_the_previous_paths(taps, dtype):
    x, weight, grad = _case(2, 40, 24, taps, 19, dtype, seed=2)
    padding = _padding(taps)
    want = _gradients(_previous, x, weight, grad, padding)
    got = _gradients(conv_dgrad.same_conv1d, x, weight, grad, padding)
    assert torch.equal(got[0], want[0]) and torch.equal(got[2], want[2])
    if taps < conv_dgrad.KERNEL_MIN_TAPS:  # cuDNN's route: the previous path's call
        assert torch.equal(got[1], want[1])


def test_the_route_follows_the_shape():
    """big_conv_1's 32 taps and the inner convs' 7 take the kernel at up to 256 input
    channels; fewer taps, or wider inputs, keep cuDNN's data gradient."""
    def weight(cout, cin, taps):
        return torch.empty((cout, cin, taps))

    assert conv_dgrad.takes_kernel(weight(2000, 250, 32))
    assert conv_dgrad.takes_kernel(weight(250, 250, 7))
    assert conv_dgrad.takes_kernel(weight(2000, 256, 32))
    assert not conv_dgrad.takes_kernel(weight(250, 250, 3))
    assert not conv_dgrad.takes_kernel(weight(2000, 257, 32))


def test_weight_layout_is_the_kernels():
    """``(K, 256, Cout')``, ``W[co, ci, k]`` at ``[k, ci, co]``, zeros in the padding."""
    weight = torch.randn((37, 250, 32))
    layout = conv_dgrad.weight_layout(weight)
    assert layout.shape == (32, 256, 40) and layout.dtype == torch.bfloat16
    assert layout.is_contiguous()
    assert torch.equal(layout[:, :250, :37], weight.to(torch.bfloat16).permute(2, 1, 0))
    assert not layout[:, 250:].any() and not layout[:, :, 37:].any()


def test_a_tensor_on_another_device_is_refused():
    with pytest.raises(ValueError, match="CPU or CUDA"):
        conv_dgrad.conv_dgrad(torch.empty((1, 4, 3), device="meta"),
                              torch.empty((4, 2, 32), device="meta"), 15)


def _counted(run):
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        run()
    counters = trace.snapshot()["counters"]
    return {name: counters.get(name, 0) for name in ("conv.dgrad_kernel",
                                                     "conv.dgrad_cudnn")}


def test_counters_count_each_routes_data_gradients():
    """A bf16 backward through the stack counts big_conv_1's and the 7-tap inner conv's
    data gradients on the kernel's route and the 3-tap conv's on cuDNN's; the K = 1
    convs are not the Function's. Nothing counts while no profiler records."""
    config = w2l.Wav2LetterConfig(FEATURES, 6, layers=LAYERS, compute_dtype=torch.bfloat16)
    model = w2l.build_model(config, w2l.init_params(config, 3), device="cpu")
    inputs = torch.randn((2, 40, FEATURES))
    counts = _counted(lambda: model(inputs, train=True).sum().backward())
    assert counts == {"conv.dgrad_kernel": 2, "conv.dgrad_cudnn": 1}
    trace.clear()
    model(inputs, train=True).sum().backward()
    assert trace.snapshot()["counters"] == {}


def test_a_frozen_input_computes_no_data_gradient(monkeypatch):
    """With the layers below big_conv_1 frozen its input needs no gradient: the weight
    gradient is computed, the data gradient on neither route."""
    def refuse(*_):
        raise AssertionError("a data gradient was computed for a frozen input")

    monkeypatch.setattr(conv_dgrad, "conv_dgrad", refuse)
    config = w2l.Wav2LetterConfig(FEATURES, 6, layers=LAYERS, compute_dtype=torch.bfloat16)
    model = w2l.build_model(config, w2l.init_params(config, 4), device="cpu")
    for conv in model.layers[:3]:
        conv.weight.requires_grad_(False)
        conv.bias.requires_grad_(False)
    counts = _counted(lambda: model(torch.randn((2, 40, FEATURES)),
                                    train=True).sum().backward())
    assert counts == {"conv.dgrad_kernel": 0, "conv.dgrad_cudnn": 0}
    assert model.layers[3].weight.grad is not None and model.layers[0].weight.grad is None


def _batch(seed):
    rng = np.random.default_rng(seed)
    return trainer.Batch(*map(torch.from_numpy, (
        rng.normal(size=(3, 64, FEATURES)).astype(np.float32),
        np.array([64, 50, 33], np.int32),
        np.array([[0, 1, 2, 3], [4, 2, -1, -1], [1, -1, -1, -1]], np.int32),
        np.array([4, 2, 1], np.int32))))


def test_remat_gradients_are_bitwise_the_plain_steps():
    """Through the kernel's route (big_conv_1's 32 taps) the loss and every gradient
    with remat equal those without it, dropout on the same masks."""
    batch = _batch(5)
    gradients = {}
    for remat in (False, True):
        config = w2l.Wav2LetterConfig(FEATURES, 6, layers=LAYERS, dropout=0.2,
                                      remat=remat, compute_dtype=torch.bfloat16)
        model = w2l.build_model(config, w2l.init_params(config, 6), device="cpu")
        masks = w2l.draw_dropout_masks(config, 3, 64, torch.Generator().manual_seed(8),
                                       "cpu")
        loss, _ = trainer.loss_fn(config, model, batch, dropout_masks=masks)
        loss.backward()
        gradients[remat] = [loss.detach()] + [p.grad for p in model.parameters()]
    assert len(gradients[True]) == 13  # the loss, 12 gradients
    for with_remat, stored in zip(gradients[True], gradients[False]):
        assert torch.equal(with_remat, stored)


def test_bf16_training_steps_equal_the_previous_paths(monkeypatch):
    """Three bf16 Adam steps through the route (big_conv_1's data gradient on the plain
    version) against the same steps through ``F.pad`` + ``F.conv1d``: losses within 1e-3
    relative, parameters within 2e-2 of each tensor's largest change (the bf16 step
    tests' tolerance; dX rounds to bf16 in both, from fp32 sums in other orders)."""
    config = w2l.Wav2LetterConfig(FEATURES, 6, layers=LAYERS, compute_dtype=torch.bfloat16)
    params = w2l.init_params(config, 7)
    runs = {}
    for name in ("route", "previous"):
        if name == "previous":
            monkeypatch.setattr(w2l, "same_conv1d", _previous)
        optimizer = trainer.make_optimizer(1e-3)
        state = trainer.init_train_state(config, optimizer, params=params, device="cpu")
        step = trainer.make_train_step(config, optimizer, device="cpu")
        losses = []
        for seed in range(3):
            state, metrics = step(state, _batch(seed))
            losses.append(float(metrics["loss"]))
        runs[name] = (np.array(losses), state.params)
    np.testing.assert_allclose(runs["route"][0], runs["previous"][0], rtol=1e-3)
    for got, want, start in zip(runs["route"][1], runs["previous"][1], params):
        for key in ("w", "b"):
            change = np.abs(want[key] - start[key]).max()
            np.testing.assert_allclose(got[key], want[key], rtol=0, atol=2e-2 * change)
