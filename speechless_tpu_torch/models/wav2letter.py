"""The wav2letter acoustic model as a `torch.nn.Module` (port of
`speechless_tpu/models/wav2letter.py`).

Geometry matches the JAX package's model: with ``use_raw_wave_input`` a raw-wave
frontend conv first (250, k=250, stride 160, over ``(samples, 1)`` waveforms), then a
striding conv (250, k=48, stride 2), 7 inner convs (250, k=7), big_conv_1 (2000, k=32),
big_conv_2 (2000, k=1) and a linear output conv (grapheme_set_size, k=1), with
``activation`` (relu, elu, linear or softmax over the channels) after every hidden
conv. Every conv is SAME-padded by XLA's rule, so a layer of stride s turns T frames
into ceil(T / s). Compute is IEEE fp32 by default, the serving path: the forward turns
TF32 off itself (`precision.ieee_fp32`). With ``compute_dtype=bfloat16`` (the training
path on the card) the parameters stay fp32 and are cast inside the forward, so
gradients reach the fp32 parameters; each conv runs in bf16 and adds its bias in bf16
after the conv, as `jax.lax.conv_general_dilated` and the JAX ``x + b`` do, and the
logits come back in fp32. A bf16 stride-1 conv with more than one tap runs as
`ops/conv_dgrad.py::same_conv1d`, whose data gradient takes the hand-written kernel
where the conv's shape asks for it (big_conv_1 and the inner convs).

The public layout stays the JAX one — ``(batch, time, channels)`` in and out — and the
weight bridge (`params_from_jax` / `params_to_jax`) moves the JAX package's
``[{"w": (K, Cin, Cout), "b": (Cout,)}, ...]`` parameter list to and from this module's
state (`nn.Conv1d` weights are ``(Cout, Cin, K)``). A trainable-ASG run's list ends in
the criterion's pseudo-layer ``{"asg_transitions": (C, C), "asg_initials": (C,)}``;
the module holds it as `AsgTables` (``model.asg``), which the forward does not touch
and the optimizer trains beside the convs.

Training (``forward(..., train=True)``) adds the JAX model's two options:
* dropout before every non-big conv (``ConvSpec.dropout_before``) at rate
  ``config.dropout``, the surviving activations scaled by 1 / (1 - rate). The keep masks
  come from an explicit `torch.Generator` or are passed in (JAX's layout, one boolean
  ``(batch, frames, channels)`` tensor per layer), since torch cannot reproduce JAX's
  keys;
* remat (``config.remat``): `torch.utils.checkpoint` over the blocks of
  `_remat_block_starts`, the narrow front and the wide tail from big_conv_1, so the
  backward recomputes each block from its input instead of storing its activations.
  The masks are drawn before any block runs, so a recompute applies the same ones.

Serving takes the int8 layout of `models/quantize.py` too: a layer given as ``{"w_q",
"w_scale", "b"}`` becomes a `QuantizedConv1d`, which keeps ``w_q`` (int8) and
``w_scale`` on the device and dequantizes in the forward as JAX does, ``(w_q * w_scale)``
in fp32, then cast to the compute type. With ``config.int8_compute`` the big convs run
as int8 x int8 products accumulated in int32 (`int8_conv`), with the activations
quantized per tensor; the trunk stays weight-only, as in JAX.

Tensor parallelism (`parallel/mesh.py`): built with a `ModelSplit`, the module holds
this model rank's shards of the wide tail, ``big_conv_1``'s output channels and
``big_conv_2``'s input channels, so the ``(B, 2000/tp, T')`` activation between them
stays split with no collective; Megatron's f on ``big_conv_1``'s input and g after
``big_conv_2``'s product carry the collectives, and ``big_conv_2``'s bias is added
once, after g's sum. JAX's ``tp_activation_constraint`` pins that layout under GSPMD;
here it holds by construction, and the flag only asks that the model be built split.

The transfer helpers (`character_remap_indices`, `remap_output_layer`) remap the output
layer's per-character filters between character sets.
"""
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from ..ops.conv_dgrad import same_conv1d
from ..parallel.mesh import (ModelSplit, all_gather, copy_to_model_group, param_specs,
                             reduce_from_model_group, split_axis)
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
    activation: str = "relu"  # or "elu", "linear", "softmax"
    dropout_before: bool = False


@dataclass(frozen=True)
class Wav2LetterConfig:
    """Architecture, compute type and training options of one model instance
    (``layers`` overrides the default stack; ``use_raw_wave_input`` puts the wave conv
    first, for ``(samples, 1)`` inputs; ``activation`` follows every hidden conv;
    ``compute_dtype`` is float32 or bfloat16; ``dropout`` is the rate before the non-big
    convs, None for none; ``remat`` recomputes activations in the backward;
    ``int8_compute``, for inference on int8 weights, runs the big convs as int8
    products: see `int8_conv`; ``tp_activation_constraint`` asks that the model be
    built tensor-parallel, JAX's flag: see the module docstring)."""
    input_size_per_time_step: int
    grapheme_set_size: int
    layers: Tuple[ConvSpec, ...] = field(default=None)
    compute_dtype: torch.dtype = torch.float32
    dropout: Optional[float] = None
    remat: bool = False
    int8_compute: bool = False
    use_raw_wave_input: bool = False
    activation: str = "relu"
    tp_activation_constraint: bool = False

    def __post_init__(self):
        if self.layers is None:
            object.__setattr__(self, "layers", tuple(self._build_layers()))

    def _build_layers(self) -> List[ConvSpec]:
        act = self.activation
        use_dropout = self.dropout is not None
        layers = []
        if self.use_raw_wave_input:
            layers.append(ConvSpec("wave_conv", MAIN_FILTER_COUNT, 250, 160, act, use_dropout))
        layers.append(ConvSpec("striding_conv", MAIN_FILTER_COUNT, 48, 2, act, use_dropout))
        for i in range(1, 8):
            layers.append(ConvSpec("inner_conv_{}".format(i), MAIN_FILTER_COUNT, 7, 1,
                                   act, use_dropout))
        layers.append(ConvSpec("big_conv_1", BIG_FILTER_COUNT, 32, 1, act))
        layers.append(ConvSpec("big_conv_2", BIG_FILTER_COUNT, 1, 1, act))
        layers.append(ConvSpec("output_conv", self.grapheme_set_size, 1, 1, "linear"))
        return layers

    @property
    def layer_names(self) -> List[str]:
        return [spec.name for spec in self.layers]

    @property
    def input_to_prediction_length_ratio(self) -> int:
        """Frames in per prediction out: the product of the strides."""
        ratio = 1
        for spec in self.layers:
            ratio *= spec.stride
        return ratio

    def init_params(self, seed: int) -> Params:
        return init_params(self, seed)

    def build_model(self, params: Params, *, device) -> "Wav2Letter":
        """`build_model`, replicated: the trainer's way to build any model family."""
        return build_model(self, params, device=device)

    def layer_input_shapes(self, batch: int, frames: int) -> List[Tuple[int, int, int]]:
        """Each layer's input shape ``(batch, frames, channels)`` (JAX's layout) for an
        input of ``frames`` frames: the shapes of the dropout masks."""
        shapes, channels = [], self.input_size_per_time_step
        for spec in self.layers:
            shapes.append((batch, frames, channels))
            frames, channels = -(-frames // spec.stride), spec.filters  # SAME padding
        return shapes


def _remat_block_starts(config: Wav2LetterConfig) -> List[int]:
    """Checkpoint-block boundaries: the narrow (250-filter) front, then the wide tail
    from big_conv_1, whose (B, T', 2000) activations dominate training memory."""
    names = config.layer_names
    return [0, names.index("big_conv_1")] if "big_conv_1" in names else [0]


def draw_dropout_masks(config: Wav2LetterConfig, batch: int, frames: int,
                       generator: torch.Generator, device) -> List[Optional[torch.Tensor]]:
    """Keep masks for one forward: a boolean ``(batch, frames_i, channels_i)`` tensor
    (True = kept, probability 1 - rate) for each layer with ``dropout_before``, None for
    the others, drawn from ``generator`` on ``device``."""
    keep = 1.0 - config.dropout
    return [torch.rand(shape, generator=generator, device=device) < keep
            if spec.dropout_before else None
            for spec, shape in zip(config.layers, config.layer_input_shapes(batch, frames))]


def same_padding(length: int, kernel_size: int, stride: int) -> Tuple[int, int]:
    """XLA's SAME rule: total = max((ceil(T/s) - 1) * s + k - T, 0), low = total // 2."""
    total = max((-(-length // stride) - 1) * stride + kernel_size - length, 0)
    return total // 2, total - total // 2


def _activate(x: torch.Tensor, activation: str) -> torch.Tensor:
    """``activation`` on ``x`` of layout ``(batch, channels, frames)``: the softmax is
    over the channels, JAX's last axis of ``(batch, frames, channels)``."""
    if activation == "relu":
        return F.relu(x)
    if activation == "elu":
        return F.elu(x)
    if activation == "linear":
        return x
    if activation == "softmax":
        return torch.softmax(x, dim=1)
    raise ValueError("Unknown activation: {}".format(activation))


# `torch._int_mm` on CUDA needs more than 16 rows; shorter inputs are padded with zero
# rows, whose sums are sliced away.
_INT_MM_MIN_ROWS = 17


class QuantizedConv1d(nn.Module):
    """A conv layer served from int8 weights (`models/quantize.py`'s layout): buffers
    ``w_q`` ``(Cout, Cin, K)`` int8, ``w_scale`` ``(Cout,)`` fp32 and ``bias`` ``(Cout,)``
    fp32, a quarter of the fp32 weights' device memory."""

    def __init__(self, in_channels: int, out_channels: int, kernel_size: int, *, device):
        super().__init__()
        self.register_buffer("w_q", torch.zeros((out_channels, in_channels, kernel_size),
                                                dtype=torch.int8, device=device))
        self.register_buffer("w_scale", torch.ones(out_channels, device=device))
        self.register_buffer("bias", torch.zeros(out_channels, device=device))

    def dequantized(self, dtype: torch.dtype) -> torch.Tensor:
        """The weight as JAX's forward forms it: ``(w_q * w_scale)`` in fp32, then cast
        to ``dtype``. It is formed on every call (one elementwise pass over the int8
        weights), never stored."""
        return (self.w_q.to(torch.float32) * self.w_scale[:, None, None]).to(dtype)


def int8_matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a`` ``(M, K)`` int8 times ``b`` ``(K, N)`` int8, summed in int32 (exact:
    ``K * 127**2`` stays below 2**31 for every layer of the model). `torch._int_mm`:
    cuBLAS on the card (K and N must be multiples of 8 there), oneDNN on the CPU."""
    rows = a.shape[0]
    if rows < _INT_MM_MIN_ROWS:
        a = F.pad(a, (0, 0, 0, _INT_MM_MIN_ROWS - rows))
    return torch._int_mm(a, b)[:rows]


def quantize_activations(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-tensor symmetric int8 quantization of ``x``, as JAX's int8 path does it:
    ``(x_q, scale)`` with ``scale = max(max|x|, 1e-12) / 127`` in fp32 and ``x_q =
    clip(round(x / scale), -127, 127)`` as int8 (torch and jnp both round half to
    even). The scale covers the whole tensor, padded frames and rows included."""
    scale = torch.clamp(x.abs().amax().to(torch.float32), min=1e-12) / 127.0
    x_q = torch.clamp(torch.round(x.to(torch.float32) / scale), -127.0, 127.0)
    return x_q.to(torch.int8), scale


def int8_conv_sums(x_q: torch.Tensor, w_q: torch.Tensor, spec: ConvSpec) -> torch.Tensor:
    """The int32 sums of a SAME-padded conv of ``x_q`` ``(batch, Cin, frames)`` int8
    with ``w_q`` ``(Cout, Cin, K)`` int8: the padded input unfolded to ``(batch *
    frames', Cin * K)`` (15 frames left and 16 right for big_conv_1's K = 32), times
    ``w_q`` as ``(Cin * K, Cout)``. Returns ``(batch, frames', Cout)`` int32."""
    batch, _, frames = x_q.shape
    padded = F.pad(x_q, same_padding(frames, spec.kernel_size, spec.stride))
    columns = padded.unfold(2, spec.kernel_size, spec.stride)    # (B, Cin, T', K)
    out_frames = columns.shape[2]
    columns = columns.permute(0, 2, 1, 3).reshape(batch * out_frames, -1)
    sums = int8_matmul(columns, w_q.reshape(w_q.shape[0], -1).t())
    return sums.reshape(batch, out_frames, -1)


def int8_conv(x: torch.Tensor, conv: QuantizedConv1d, spec: ConvSpec,
              dtype: torch.dtype) -> torch.Tensor:
    """The int8 path of a big conv, as `speechless_tpu/models/wav2letter.py` computes it:
    ``x`` ``(batch, channels, frames)`` quantized per tensor (`quantize_activations`),
    its int32 sums with ``w_q`` (`int8_conv_sums`) rescaled by ``scale * w_scale`` (that
    product formed first), cast to ``dtype``, biased and activated. Since the scale
    spans the whole batch, a result depends on the batch it ran in."""
    x_q, scale = quantize_activations(x)
    acc = int8_conv_sums(x_q, conv.w_q, spec)
    y = (acc.to(torch.float32) * (scale * conv.w_scale)).to(dtype)
    return _activate((y + conv.bias.to(dtype)).transpose(1, 2), spec.activation)


def is_asg_layer(layer) -> bool:
    """Whether a JAX-layout layer is a trainable-ASG run's criterion pseudo-layer."""
    return "asg_transitions" in layer


class AsgTables(nn.Module):
    """A trainable-ASG run's log-score tables (`ops/asg.py`): ``transitions`` ``(C, C)``
    (``[to, from]``) and ``initials`` ``(C,)``, fp32 parameters."""

    def __init__(self, class_count: int, *, device):
        super().__init__()
        self.transitions = nn.Parameter(torch.zeros((class_count, class_count),
                                                    device=device))
        self.initials = nn.Parameter(torch.zeros(class_count, device=device))


class Wav2Letter(nn.Module):
    """``(batch, time, features) -> (batch, time / stride_ratio, graphemes)`` logits.
    ``quantized`` marks the layers served from int8 weights (`QuantizedConv1d`), for
    inference only; ``asg_tables`` adds a trainable-ASG run's `AsgTables` as
    ``self.asg`` (None otherwise), which the forward does not use;
    ``tensor_parallel`` (a `ModelSplit`) holds this model rank's shards of the wide
    tail (`parallel.mesh.param_specs`), and every rank of its group must run each
    forward and backward together."""

    def __init__(self, config: Wav2LetterConfig, *, device,
                 quantized: Optional[Sequence[bool]] = None, asg_tables: bool = False,
                 tensor_parallel: Optional[ModelSplit] = None):
        super().__init__()
        self.config = config
        quantized = quantized or [False] * len(config.layers)
        if config.tp_activation_constraint and tensor_parallel is None:
            raise ValueError("tp_activation_constraint needs a tensor-parallel model "
                             "(a mesh with a model axis)")
        if tensor_parallel is not None and any(quantized):
            raise ValueError("int8 layers are served replicated, not tensor-parallel")
        self.tensor_parallel = tensor_parallel
        parts = tensor_parallel.size if tensor_parallel is not None else 1
        specs = param_specs(config.layer_names)
        convs = []
        in_channels = config.input_size_per_time_step
        for spec, int8, split in zip(config.layers, quantized, specs):
            # The weight's split axis in the JAX layout (K, Cin, Cout).
            axis = split_axis(split["w"])
            if axis is not None and (in_channels, spec.filters)[axis - 1] % parts:
                raise ValueError("{}: {} channels do not split over {} model ranks".format(
                    spec.name, (in_channels, spec.filters)[axis - 1], parts))
            cin = in_channels // parts if axis == 1 else in_channels
            cout = spec.filters // parts if axis == 2 else spec.filters
            if int8:
                convs.append(QuantizedConv1d(cin, cout, spec.kernel_size, device=device))
            else:
                convs.append(nn.Conv1d(cin, cout, spec.kernel_size, stride=spec.stride,
                                       device=device))
            in_channels = spec.filters
        self.layers = nn.ModuleList(convs)
        self.asg = AsgTables(config.grapheme_set_size, device=device) if asg_tables else None

    def split_axes(self) -> Dict[nn.Parameter, int]:
        """The tensor-parallel parameters and the axis of each that is split (torch's
        ``(Cout, Cin, K)`` layout); empty when the model is not split."""
        if self.tensor_parallel is None:
            return {}
        axes = {}
        for conv, split in zip(self.layers, param_specs(self.config.layer_names)):
            weight_axis, bias_axis = split_axis(split["w"]), split_axis(split["b"])
            if weight_axis is not None:
                axes[conv.weight] = _KERNEL_AXES[weight_axis]
            if bias_axis is not None:
                axes[conv.bias] = bias_axis
        return axes

    def full_tensor(self, param: torch.Tensor, value: torch.Tensor) -> torch.Tensor:
        """``value`` (shaped like ``param``: the parameter itself, a gradient or an
        optimizer moment) gathered whole over the model group when ``param`` is split,
        else ``value``. A collective: every rank of the group calls it."""
        axis = self.split_axes().get(param)
        if axis is None:
            return value
        return all_gather(value.detach(), self.tensor_parallel.group, "model",
                          "gather a split tensor", dim=axis)

    def local_part(self, param: torch.Tensor, full: torch.Tensor) -> torch.Tensor:
        """This model rank's part of ``full`` (torch layout, the whole tensor of
        ``param``): `full_tensor`'s inverse."""
        axis = self.split_axes().get(param)
        if axis is None:
            return full
        part = full.shape[axis] // self.tensor_parallel.size
        return full.narrow(axis, self.tensor_parallel.rank * part, part).contiguous()

    def parameter_layers(self) -> List[List[Tuple[torch.Tensor, bool]]]:
        """The parameters of each layer of the JAX layout, the ASG pseudo-layer last,
        each in ``jax.tree_util.tree_leaves`` order (``b`` before ``w``; ``asg_initials``
        before ``asg_transitions``), with a flag marking the conv weights (JAX keeps them
        as ``(K, Cin, Cout)``)."""
        layers = [[(conv.bias, False), (conv.weight, True)] for conv in self.layers]
        if self.asg is not None:
            layers.append([(self.asg.initials, False), (self.asg.transitions, False)])
        return layers

    def prediction_lengths(self, input_lengths: torch.Tensor) -> torch.Tensor:
        return prediction_lengths(self.config, input_lengths)

    def forward(self, inputs: torch.Tensor, train: bool = False,
                dropout_masks: Optional[Sequence[Optional[torch.Tensor]]] = None,
                generator: Optional[torch.Generator] = None,
                input_lengths: Optional[torch.Tensor] = None) -> torch.Tensor:
        """``train=True`` applies dropout (masks given, else drawn from ``generator``)
        and remat, as the config asks; otherwise the forward is the inference one.
        ``input_lengths`` are not read: every conv sees the zero-padded frames, and the
        lengths matter only to the loss."""
        config = self.config
        x = inputs.to(config.compute_dtype).transpose(1, 2)
        masks = [None] * len(config.layers)
        if train and config.dropout:
            if dropout_masks is None:
                if generator is None:
                    raise ValueError("training with dropout needs a generator or the masks")
                dropout_masks = draw_dropout_masks(config, x.shape[0], x.shape[2], generator,
                                                   x.device)
            masks = list(dropout_masks)
        if not (train and config.remat):
            return self._layers(x, 0, len(config.layers), masks)
        starts = _remat_block_starts(config) + [len(config.layers)]
        for start, end in zip(starts, starts[1:]):
            x = checkpoint(self._layers, x, start, end, masks, use_reentrant=False)
        return x

    def _layers(self, x: torch.Tensor, start: int, end: int,
                masks: Sequence[Optional[torch.Tensor]]) -> torch.Tensor:
        """Layers ``start`` to ``end`` on ``x`` (``(batch, channels, frames)`` in the
        compute type); the last layer's output returns as fp32 ``(batch, frames,
        classes)``."""
        config = self.config
        dtype = config.compute_dtype
        split = self.tensor_parallel
        with ieee_fp32():
            for index in range(start, end):
                spec, conv = config.layers[index], self.layers[index]
                if split is not None and spec.name == "big_conv_1":
                    x = copy_to_model_group(x, split)
                if masks[index] is not None:
                    x = torch.where(masks[index].transpose(1, 2), x / (1.0 - config.dropout),
                                    0.0).to(dtype)
                if isinstance(conv, QuantizedConv1d):
                    if config.int8_compute and spec.name.startswith("big_conv"):
                        x = int8_conv(x, conv, spec, dtype)
                        continue
                    x = F.pad(x, same_padding(x.shape[2], spec.kernel_size, spec.stride))
                    x = F.conv1d(x, conv.dequantized(dtype), None, spec.stride) \
                        + conv.bias.to(dtype)[:, None]
                    x = _activate(x, spec.activation)
                    continue
                padding = same_padding(x.shape[2], spec.kernel_size, spec.stride)
                if dtype != torch.float32 and spec.stride == 1 and spec.kernel_size > 1:
                    # The data gradient on the hand-written kernel where its shape rule
                    # takes it (`ops/conv_dgrad.py`).
                    x = same_conv1d(x, conv.weight.to(dtype), padding) \
                        + conv.bias.to(dtype)[:, None]
                    x = _activate(x, spec.activation)
                    continue
                x = F.pad(x, padding)
                if split is not None and spec.name == "big_conv_2":
                    # Row-parallel: the partial products summed over the model group,
                    # then the (replicated) bias once.
                    x = reduce_from_model_group(
                        F.conv1d(x, conv.weight.to(dtype), None, spec.stride), split)
                    x = x + conv.bias.to(dtype)[:, None]
                elif dtype == torch.float32:
                    x = conv(x)
                else:
                    x = (F.conv1d(x, conv.weight.to(dtype), None, spec.stride)
                         + conv.bias.to(dtype)[:, None])
                x = _activate(x, spec.activation)
        if end == len(config.layers):
            return x.to(torch.float32).transpose(1, 2)
        return x


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


def init_params_from_generator(config: Wav2LetterConfig,
                               generator: torch.Generator) -> Params:
    """`init_params`' Glorot-uniform weights and zero biases, drawn from a CPU
    ``generator`` (the transfer load's fresh layers)."""
    params = []
    in_channels = config.input_size_per_time_step
    for spec in config.layers:
        fan_in = spec.kernel_size * in_channels
        fan_out = spec.kernel_size * spec.filters
        limit = np.sqrt(6.0 / (fan_in + fan_out))
        u = torch.rand((spec.kernel_size, in_channels, spec.filters), generator=generator,
                       dtype=torch.float64)
        params.append({"w": ((2.0 * u - 1.0) * limit).numpy().astype(np.float32),
                       "b": np.zeros(spec.filters, np.float32)})
        in_channels = spec.filters
    return params


# A JAX conv kernel (K, Cin, Cout) is a torch one (Cout, Cin, K) with its axes reversed.
_KERNEL_AXES = (2, 1, 0)


def jax_layout_sources(params: Sequence[Dict[str, np.ndarray]]
                       ) -> Dict[str, Tuple[int, str, Optional[Tuple[int, int, int]]]]:
    """Where each `Wav2Letter` state-dict entry of `params_from_jax` comes from in the
    JAX layout: ``{name: (layer index, key, axes permutation or None)}``, in the state
    dict's order."""
    sources = {}
    for i, layer in enumerate(params):
        prefix = "layers.{}.".format(i)
        if is_asg_layer(layer):
            if i != len(params) - 1:
                raise ValueError("the ASG pseudo-layer must be the last layer, got it at "
                                 "{} of {}".format(i, len(params)))
            sources["asg.transitions"] = (i, "asg_transitions", None)
            sources["asg.initials"] = (i, "asg_initials", None)
            continue
        if "w_q" in layer:
            sources[prefix + "w_q"] = (i, "w_q", _KERNEL_AXES)
            sources[prefix + "w_scale"] = (i, "w_scale", None)
        elif "w" in layer:
            sources[prefix + "weight"] = (i, "w", _KERNEL_AXES)
        else:
            raise ValueError("layer {} holds {}: neither float (w) nor int8 (w_q, "
                             "w_scale) conv weights".format(i, sorted(layer)))
        sources[prefix + "bias"] = (i, "b", None)
    return sources


def params_from_jax(params: Sequence[Dict[str, np.ndarray]]) -> Dict[str, torch.Tensor]:
    """The JAX package's ``[{"w": (K, Cin, Cout), "b": (Cout,)}]`` list as a
    `Wav2Letter` state dict (conv weights transposed to ``(Cout, Cin, K)``). An int8
    layer ``{"w_q": (K, Cin, Cout) int8, "w_scale": (Cout,), "b"}`` gives the
    `QuantizedConv1d` buffers ``w_q`` ``(Cout, Cin, K)`` int8 and ``w_scale`` fp32. A
    trailing ASG pseudo-layer gives ``asg.transitions`` and ``asg.initials``
    (`jax_layout_sources`)."""
    state = {}
    for name, (i, key, axes) in jax_layout_sources(params).items():
        array = np.asarray(params[i][key])
        if key == "w_q":
            if array.dtype != np.int8:
                raise ValueError("layer {}: w_q must be int8, got {}".format(
                    i, array.dtype))
        else:
            array = array.astype(np.float32)
        state[name] = torch.from_numpy(np.ascontiguousarray(
            array.transpose(axes) if axes else array))
    return state


def params_to_jax(model: Wav2Letter) -> Params:
    """Inverse of `params_from_jax`: the module's weights in the JAX layout (numpy), with
    the ASG pseudo-layer last when the model has one. A tensor-parallel model's split
    tensors are gathered whole (a collective over its model group)."""
    def host(param):
        return model.full_tensor(param, param).detach().cpu().numpy()

    params = [{"w": host(conv.weight).transpose(2, 1, 0).copy(),
               "b": host(conv.bias).copy()} for conv in model.layers]
    if model.asg is not None:
        params.append({"asg_transitions": model.asg.transitions.detach().cpu().numpy().copy(),
                       "asg_initials": model.asg.initials.detach().cpu().numpy().copy()})
    return params


def build_model(config: Wav2LetterConfig, params: Params, *, device,
                tensor_parallel: Optional[ModelSplit] = None) -> Wav2Letter:
    """A `Wav2Letter` on ``device`` holding ``params`` (JAX layout, float or int8 layers,
    optionally ending in the ASG pseudo-layer), in eval mode. With ``tensor_parallel``,
    ``params`` are this model rank's shards (`parallel.mesh.shard_params`)."""
    asg_tables = bool(params) and is_asg_layer(params[-1])
    convs = params[:-1] if asg_tables else params
    model = Wav2Letter(config, device=device, quantized=["w_q" in layer for layer in convs],
                       asg_tables=asg_tables, tensor_parallel=tensor_parallel)
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


def character_remap_indices(source_characters: List[str],
                            target_characters: List[str]) -> List[Optional[int]]:
    """For each target character, the source index holding its filters (None if absent)."""
    source_index = {}
    for i, c in enumerate(source_characters):
        if c in source_index:
            raise ValueError("Duplicate character in source charset: {}".format(c))
        source_index[c] = i
    return [source_index.get(c) for c in target_characters]


def remap_output_layer(output_params: Dict[str, np.ndarray], source_characters: List[str],
                       target_characters: List[str]) -> Dict[str, np.ndarray]:
    """The output conv's per-grapheme filters (JAX layout, ``w`` of shape ``(K, Cin,
    classes)``) remapped to ``target_characters``: characters in both sets keep their
    filters, new characters get zero weights and bias, and the CTC blank (the last class
    on both sides) maps to the blank."""
    w = np.asarray(output_params["w"])
    b = np.asarray(output_params["b"])
    indices = character_remap_indices(source_characters, target_characters)
    target_size = len(target_characters) + 1  # + blank
    new_w = np.zeros(w.shape[:2] + (target_size,), dtype=w.dtype)
    new_b = np.zeros((target_size,), dtype=b.dtype)
    for target_idx, source_idx in enumerate(indices):
        if source_idx is not None:
            new_w[:, :, target_idx] = w[:, :, source_idx]
            new_b[target_idx] = b[source_idx]
    new_w[:, :, -1] = w[:, :, -1]  # blank -> blank
    new_b[-1] = b[-1]
    return {"w": new_w, "b": new_b}
