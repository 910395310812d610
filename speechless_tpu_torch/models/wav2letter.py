"""The wav2letter acoustic model as a `torch.nn.Module` (port of
`speechless_tpu/models/wav2letter.py`).

Geometry matches the JAX package's mel-input model: a striding conv (250, k=48,
stride 2), 7 inner convs (250, k=7), big_conv_1 (2000, k=32), big_conv_2 (2000, k=1) and
a linear output conv (grapheme_set_size, k=1), ReLU between them. Every conv is
SAME-padded by XLA's rule. Compute is IEEE fp32 by default, the serving path: the
forward turns TF32 off itself (`precision.ieee_fp32`). With ``compute_dtype=bfloat16``
(the training path on the card) the parameters stay fp32 and are cast inside the
forward, so gradients reach the fp32 parameters; each conv runs in bf16 and adds its
bias in bf16 after the conv, as `jax.lax.conv_general_dilated` and the JAX ``x + b`` do,
and the logits come back in fp32.

The public layout stays the JAX one — ``(batch, time, channels)`` in and out — and the
weight bridge (`params_from_jax` / `params_to_jax`) moves the JAX package's
``[{"w": (K, Cin, Cout), "b": (Cout,)}, ...]`` parameter list to and from this module's
state (`nn.Conv1d` weights are ``(Cout, Cin, K)``). The raw-wave frontend, other
activations, dropout, remat, int8 compute and tensor-parallel constraints of the JAX
model are not ported yet (ROADMAP.md, item 3).
"""
from dataclasses import dataclass, field
from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..precision import ieee_fp32

MAIN_FILTER_COUNT = 250
BIG_FILTER_COUNT = 2000

Params = List[Dict[str, np.ndarray]]


@dataclass(frozen=True)
class ConvSpec:
    name: str
    filters: int
    kernel_size: int
    stride: int = 1
    activation: str = "relu"  # or "linear"


@dataclass(frozen=True)
class Wav2LetterConfig:
    """Architecture and compute type of one model instance (``layers`` overrides the
    default stack; ``compute_dtype`` is float32 or bfloat16)."""
    input_size_per_time_step: int
    grapheme_set_size: int
    layers: Tuple[ConvSpec, ...] = field(default=None)
    compute_dtype: torch.dtype = torch.float32

    def __post_init__(self):
        if self.layers is None:
            object.__setattr__(self, "layers", tuple(self._build_layers()))

    def _build_layers(self) -> List[ConvSpec]:
        layers = [ConvSpec("striding_conv", MAIN_FILTER_COUNT, 48, 2)]
        for i in range(1, 8):
            layers.append(ConvSpec("inner_conv_{}".format(i), MAIN_FILTER_COUNT, 7, 1))
        layers.append(ConvSpec("big_conv_1", BIG_FILTER_COUNT, 32, 1))
        layers.append(ConvSpec("big_conv_2", BIG_FILTER_COUNT, 1, 1))
        layers.append(ConvSpec("output_conv", self.grapheme_set_size, 1, 1, "linear"))
        return layers

    @property
    def input_to_prediction_length_ratio(self) -> int:
        """Frames in per prediction out: the product of the strides."""
        ratio = 1
        for spec in self.layers:
            ratio *= spec.stride
        return ratio


def same_padding(length: int, kernel_size: int, stride: int) -> Tuple[int, int]:
    """XLA's SAME rule: total = max((ceil(T/s) - 1) * s + k - T, 0), low = total // 2."""
    total = max((-(-length // stride) - 1) * stride + kernel_size - length, 0)
    return total // 2, total - total // 2


def _activate(x: torch.Tensor, activation: str) -> torch.Tensor:
    if activation == "relu":
        return F.relu(x)
    if activation == "linear":
        return x
    raise ValueError("Unknown activation: {}".format(activation))


class Wav2Letter(nn.Module):
    """``(batch, time, features) -> (batch, time / stride_ratio, graphemes)`` logits."""

    def __init__(self, config: Wav2LetterConfig, *, device):
        super().__init__()
        self.config = config
        convs = []
        in_channels = config.input_size_per_time_step
        for spec in config.layers:
            convs.append(nn.Conv1d(in_channels, spec.filters, spec.kernel_size,
                                   stride=spec.stride, device=device))
            in_channels = spec.filters
        self.layers = nn.ModuleList(convs)

    def forward(self, inputs: torch.Tensor) -> torch.Tensor:
        dtype = self.config.compute_dtype
        x = inputs.to(dtype).transpose(1, 2)
        with ieee_fp32():
            for spec, conv in zip(self.config.layers, self.layers):
                x = F.pad(x, same_padding(x.shape[2], spec.kernel_size, spec.stride))
                if dtype == torch.float32:
                    x = conv(x)
                else:
                    x = (F.conv1d(x, conv.weight.to(dtype), None, spec.stride)
                         + conv.bias.to(dtype)[:, None])
                x = _activate(x, spec.activation)
        return x.to(torch.float32).transpose(1, 2)


def init_params(config: Wav2LetterConfig, seed: int) -> Params:
    """Glorot-uniform weights and zero biases (Keras Conv1D defaults) in the JAX
    package's layout, drawn from ``numpy.random.default_rng(seed)``."""
    rng = np.random.default_rng(seed)
    params = []
    in_channels = config.input_size_per_time_step
    for spec in config.layers:
        fan_in = spec.kernel_size * in_channels
        fan_out = spec.kernel_size * spec.filters
        limit = np.sqrt(6.0 / (fan_in + fan_out))
        w = rng.uniform(-limit, limit, (spec.kernel_size, in_channels, spec.filters))
        params.append({"w": w.astype(np.float32),
                       "b": np.zeros(spec.filters, np.float32)})
        in_channels = spec.filters
    return params


def params_from_jax(params: Sequence[Dict[str, np.ndarray]]) -> Dict[str, torch.Tensor]:
    """The JAX package's ``[{"w": (K, Cin, Cout), "b": (Cout,)}]`` list as a
    `Wav2Letter` state dict (conv weights transposed to ``(Cout, Cin, K)``)."""
    state = {}
    for i, layer in enumerate(params):
        if "w" not in layer:
            raise NotImplementedError(
                "layer {} holds {}: only float conv weights are ported (quantized "
                "serving: ROADMAP.md, Transcriber routes)".format(i, sorted(layer)))
        w = np.asarray(layer["w"], np.float32)
        state["layers.{}.weight".format(i)] = torch.from_numpy(
            np.ascontiguousarray(w.transpose(2, 1, 0)))
        state["layers.{}.bias".format(i)] = torch.from_numpy(
            np.asarray(layer["b"], np.float32).copy())
    return state


def params_to_jax(model: Wav2Letter) -> Params:
    """Inverse of `params_from_jax`: the module's weights in the JAX layout (numpy)."""
    return [{"w": conv.weight.detach().cpu().numpy().transpose(2, 1, 0).copy(),
             "b": conv.bias.detach().cpu().numpy().copy()} for conv in model.layers]


def build_model(config: Wav2LetterConfig, params: Params, *, device) -> Wav2Letter:
    """A `Wav2Letter` on ``device`` holding ``params`` (JAX layout), in eval mode."""
    model = Wav2Letter(config, device=device)
    model.load_state_dict(params_from_jax(params))
    return model.eval()


def prediction_lengths(config: Wav2LetterConfig,
                       input_lengths: torch.Tensor) -> torch.Tensor:
    """Valid output frames per example: ``input_length // stride_ratio``."""
    return input_lengths // config.input_to_prediction_length_ratio


def trainable_mask(config: Wav2LetterConfig, frozen_layer_count: int) -> List[bool]:
    """Per-layer trainability flags: the first ``frozen_layer_count`` layers are frozen."""
    return [i >= frozen_layer_count for i in range(len(config.layers))]


def conv_flops_per_example(config: Wav2LetterConfig, input_frames: int,
                           train: bool = True) -> float:
    """Analytic conv FLOPs for one example, the MFU numerator (bias, activations and the
    features are left out): ``2 * T_out * K * C_in * C_out`` per layer, times 3 for
    training (the input-gradient and weight-gradient convs cost one forward each)."""
    flops = 0.0
    frames = input_frames
    in_channels = config.input_size_per_time_step
    for spec in config.layers:
        frames = (frames + spec.stride - 1) // spec.stride  # SAME padding
        flops += 2.0 * frames * spec.kernel_size * in_channels * spec.filters
        in_channels = spec.filters
    return flops * (3.0 if train else 1.0)
