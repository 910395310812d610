"""Conformer-CTC as a `torch.nn.Module`: the encoder of Gulati et al. (arXiv:2005.08100)
as NVIDIA NeMo's ``ConformerEncoder`` and ``ConformerLayer`` compute it, with a
character CTC head (NeMo's ``conformer_ctc_char.yaml``; the "Large" row is the default
config: 18 blocks of width 512, 8 heads, 121.5 M parameters).

* Subsampling (NeMo's "striding", 4x): features ``(B, T, 80)`` as one image channel ->
  Conv2d(1 -> C, 3, stride 2, padding 1) -> ReLU -> Conv2d(C -> C, 3, stride 2, padding
  1) -> ReLU -> channels x frequencies flattened per frame -> Linear -> x sqrt(d_model).
  A row of L frames keeps ``(L - 1) // 2 + 1`` frames after each conv
  (`prediction_lengths`).
* Each block, with LN a LayerNorm of its own:
  ``r = x + FF1(LN(x)) / 2; r = r + MHSA(LN(r)); r = r + Conv(LN(r));
  r = r + FF2(LN(r)) / 2; x = LN(r)``. FF is Linear(d -> 4d), Swish, Linear(4d -> d).
* MHSA is Transformer-XL's relative-position attention with per-layer untied biases u
  and v: ``s_ij = ((q_i + u) . k_j + (q_i + v) . p_(i-j)) / sqrt(d_k)``, where
  ``p_r = W_pos sinusoid(r)`` for ``r`` from ``T' - 1`` down to ``-(T' - 1)`` (sin on the
  even channels, cos on the odd, frequencies ``10000^(-2i/d)``; W_pos has no bias). The
  p term is one matmul over all ``2T' - 1`` offsets (scaled through ``q + v``), aligned by
  NeMo's `rel_shift`, and filled with -10000 wherever the query or the key lies past its
  row's length. The attention core is one ``F.scaled_dot_product_attention`` call with
  ``q + u`` as its query and that term as its additive float mask (NeMo's
  ``use_pytorch_sdpa`` route), pinned to a backend that takes a float mask and returns
  its gradient: the memory-efficient (CUTLASS) kernels on the card, the math route on
  the CPU. Rows past a row's length are zeroed after it, then the output projection.
* The convolution module: pointwise 1 x 1 conv d -> 2d (a Linear over ``(B, T, C)``),
  GLU over the channels, padded frames set to 0, depthwise conv (K taps, SAME), BatchNorm
  over all ``B x T'`` positions, padding included (batch statistics and a running-average
  update with momentum 0.1 in training, the running averages otherwise), Swish,
  pointwise d -> d.
* Head: a 1 x 1 conv d -> classes (a Linear), logits ``(B, T', classes)`` in fp32, the
  CTC blank last.

Padded frames are not zeroed in the residual stream, as in NeMo: they reach BatchNorm's
statistics through the depthwise conv's edges and bias, so they are part of the result.

Precision: parameters are fp32; with ``compute_dtype=bfloat16`` every GEMM, conv and the
attention core run in bf16 (weights cast inside the forward, so gradients reach the fp32
parameters), while the residual stream, LayerNorm, BatchNorm and its statistics stay
fp32, and the logits come back in fp32. Dropout (``config.dropout``, NeMo's ``dropout``
and ``dropout_pre_encoder``) acts in training on each residual branch, inside each FF and
after the subsampling, its masks drawn from the caller's generator; NeMo's attention
dropout is not ported.

While a profiler records (`utils/trace.py`) the forward keeps the spans
``conformer.subsample``, ``conformer.attention`` and ``conformer.conv`` (each block's)
and counts ``conformer.attn_pairs`` (rows x T'^2, the query-key pairs the attention
computes) and ``conformer.attn_pairs_own`` (the sum of each row's own T'^2, on the card).

Parameters are a state dict (`init_params`, `build_model`): ``pre_encode.*``,
``layers.<i>.*`` and ``decoder.*``, every tensor in torch's layout.
"""
import math
from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..utils import trace

Params = Dict[str, torch.Tensor]

MASK_FILL = -10000.0  # NeMo's INF_VAL: the score of a masked query-key pair
BATCH_NORM_MOMENTUM = 0.1
BATCH_NORM_EPS = 1e-5
LAYER_NORM_EPS = 1e-5


@dataclass(frozen=True)
class ConformerConfig:
    """Widths, depth, compute type and dropout rate of one Conformer-CTC model.
    ``grapheme_set_size`` counts the output classes, the CTC blank last (the name the
    trainer reads, as `Wav2LetterConfig` has it)."""
    feat_in: int = 80
    d_model: int = 512
    n_heads: int = 8
    n_layers: int = 18
    ff_expansion: int = 4
    conv_kernel: int = 31
    subsampling_channels: int = 512
    grapheme_set_size: int = 29
    compute_dtype: torch.dtype = torch.float32
    dropout: float = 0.0

    def __post_init__(self):
        if self.d_model % self.n_heads:
            raise ValueError("d_model {} does not split into {} heads".format(
                self.d_model, self.n_heads))
        if self.conv_kernel % 2 == 0:
            raise ValueError("the depthwise conv needs an odd kernel for SAME padding, got "
                             "{}".format(self.conv_kernel))

    @property
    def subsampled_features(self) -> int:
        return subsampled(subsampled(self.feat_in))

    def init_params(self, seed: int) -> Params:
        return init_params(self, seed)

    def build_model(self, params: Params, *, device) -> "Conformer":
        return build_model(self, params, device=device)


def subsampled(length):
    """Frames (or frequencies) left by one Conv2d of kernel 3, stride 2, padding 1."""
    return (length - 1) // 2 + 1


def prediction_lengths(input_lengths: torch.Tensor) -> torch.Tensor:
    """Valid output frames per row: `subsampled` twice."""
    return subsampled(subsampled(input_lengths))


def rel_shift(x: torch.Tensor) -> torch.Tensor:
    """NeMo's shift of scores over the offsets ``T - 1 .. -(T - 1)``, so that column ``j``
    of row ``i`` holds offset ``i - j``, and its first ``T`` columns. ``x`` ``(B, H, T,
    2T)`` has one column in front of the offsets (NeMo pads a zero column; the port's
    matmul writes one). NeMo views that as ``(2T, T)``, drops the first row and views
    the rest as ``(T, 2T - 1)``: element ``(i, j)`` is element ``T + i (2T - 1) + j`` of
    each ``(b, h)`` block, which one strided view reads (its backward scatters once)."""
    b, h, t, columns = x.shape
    if not x.is_contiguous():
        raise ValueError("rel_shift reads a contiguous (B, H, T, 2T) tensor")
    return x.as_strided((b, h, t, t), (h * t * columns, t * columns, columns - 1, 1),
                        x.storage_offset() + t)


def relative_positions(frames: int, d_model: int, device) -> torch.Tensor:
    """The sinusoids of offsets ``frames - 1`` down to ``-(frames - 1)``: ``(2 frames - 1,
    d_model)`` fp32, sin on the even channels and cos on the odd."""
    positions = torch.arange(frames - 1, -frames, -1, dtype=torch.float32,
                             device=device)[:, None]
    div_term = torch.exp(torch.arange(0, d_model, 2, dtype=torch.float32, device=device)
                         * -(math.log(10000.0) / d_model))
    table = torch.zeros(2 * frames - 1, d_model, device=device)
    table[:, 0::2] = torch.sin(positions * div_term)
    table[:, 1::2] = torch.cos(positions * div_term)
    return table


def _attention_backends(device: torch.device) -> list:
    """The SDPA backends that take a float mask and return its gradient: the
    memory-efficient kernels on the card, the math route elsewhere."""
    from torch.nn.attention import SDPBackend

    if device.type == "cuda":
        return [SDPBackend.EFFICIENT_ATTENTION]
    return [SDPBackend.MATH]


def _dropout(x: torch.Tensor, rate: float, generator: Optional[torch.Generator]
             ) -> torch.Tensor:
    """Inverted dropout at ``rate`` with a keep mask drawn from ``generator``."""
    if generator is None:
        raise ValueError("training with dropout needs a generator")
    keep = torch.rand(x.shape, generator=generator, device=x.device) >= rate
    return torch.where(keep, x / (1.0 - rate), 0.0).to(x.dtype)


def _linear(x: torch.Tensor, layer: nn.Linear, dtype: torch.dtype) -> torch.Tensor:
    bias = None if layer.bias is None else layer.bias.to(dtype)
    return F.linear(x.to(dtype), layer.weight.to(dtype), bias)


def _layer_norm(x: torch.Tensor, norm: nn.LayerNorm) -> torch.Tensor:
    return F.layer_norm(x, norm.normalized_shape, norm.weight, norm.bias, LAYER_NORM_EPS)


class Subsampling(nn.Module):
    def __init__(self, config: ConformerConfig, *, device):
        super().__init__()
        channels = config.subsampling_channels
        self.conv1 = nn.Conv2d(1, channels, 3, stride=2, padding=1, device=device)
        self.conv2 = nn.Conv2d(channels, channels, 3, stride=2, padding=1, device=device)
        self.out = nn.Linear(channels * config.subsampled_features, config.d_model,
                             device=device)

    def forward(self, inputs: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
        """``(B, T, F)`` features -> ``(B, T', d_model)`` in ``dtype``."""
        x = inputs.to(dtype).unsqueeze(1)
        for conv in (self.conv1, self.conv2):
            x = F.relu(F.conv2d(x, conv.weight.to(dtype), conv.bias.to(dtype), stride=2,
                                padding=1))
        b, c, t, f = x.shape
        return _linear(x.transpose(1, 2).reshape(b, t, c * f), self.out, dtype)


class FeedForward(nn.Module):
    def __init__(self, config: ConformerConfig, *, device):
        super().__init__()
        inner = config.d_model * config.ff_expansion
        self.linear1 = nn.Linear(config.d_model, inner, device=device)
        self.linear2 = nn.Linear(inner, config.d_model, device=device)

    def forward(self, x, dtype, dropout: float, generator) -> torch.Tensor:
        x = F.silu(_linear(x, self.linear1, dtype))
        if dropout:
            x = _dropout(x, dropout, generator)
        return _linear(x, self.linear2, dtype)


class RelPositionAttention(nn.Module):
    def __init__(self, config: ConformerConfig, *, device):
        super().__init__()
        d, heads = config.d_model, config.n_heads
        self.heads = heads
        self.linear_q = nn.Linear(d, d, device=device)
        self.linear_k = nn.Linear(d, d, device=device)
        self.linear_v = nn.Linear(d, d, device=device)
        self.linear_out = nn.Linear(d, d, device=device)
        self.linear_pos = nn.Linear(d, d, bias=False, device=device)
        self.pos_bias_u = nn.Parameter(torch.zeros(heads, d // heads, device=device))
        self.pos_bias_v = nn.Parameter(torch.zeros(heads, d // heads, device=device))

    def forward(self, x: torch.Tensor, positions: torch.Tensor, pair_masked: torch.Tensor,
                row_masked: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
        """``x`` ``(B, T, d)``; ``positions`` the `relative_positions` table;
        ``pair_masked`` ``(B, 1, T, T)`` True where the query or the key is padding;
        ``row_masked`` ``(B, 1, T, 1)`` True where the query is."""
        b, t, d = x.shape
        heads, d_k = self.heads, d // self.heads
        q = _linear(x, self.linear_q, dtype).view(b, t, heads, d_k)
        k = _linear(x, self.linear_k, dtype).view(b, t, heads, d_k).transpose(1, 2)
        v = _linear(x, self.linear_v, dtype).view(b, t, heads, d_k).transpose(1, 2)
        p = _linear(positions, self.linear_pos, dtype).view(2 * t - 1, heads, d_k)
        # A zero offset row in front of p makes the matmul write the zero column NeMo's
        # rel_shift pads in, at an aligned width of 2T and with no copy.
        p = F.pad(p, (0, 0, 0, 0, 1, 0))
        q_u = (q + self.pos_bias_u).to(dtype).transpose(1, 2)
        # The scale folded into q + v: one rounding, where NeMo rounds the scores again.
        q_v = ((q + self.pos_bias_v) * (1.0 / math.sqrt(d_k))).to(dtype).transpose(1, 2)
        position_term = torch.where(pair_masked, MASK_FILL,
                                    rel_shift(torch.matmul(q_v, p.permute(1, 2, 0))))
        from torch.nn.attention import sdpa_kernel

        with sdpa_kernel(_attention_backends(x.device)):
            out = F.scaled_dot_product_attention(q_u, k, v, attn_mask=position_term)
        out = out.masked_fill(row_masked, 0.0).transpose(1, 2).reshape(b, t, d)
        return _linear(out, self.linear_out, dtype)


class ConvModule(nn.Module):
    def __init__(self, config: ConformerConfig, *, device):
        super().__init__()
        d = config.d_model
        self.pointwise_conv1 = nn.Linear(d, 2 * d, device=device)
        self.depthwise_conv = nn.Conv1d(d, d, config.conv_kernel, groups=d, device=device)
        self.batch_norm = nn.BatchNorm1d(d, momentum=BATCH_NORM_MOMENTUM, eps=BATCH_NORM_EPS,
                                         device=device)
        self.pointwise_conv2 = nn.Linear(d, d, device=device)

    def forward(self, x: torch.Tensor, frame_masked: torch.Tensor, dtype: torch.dtype,
                train: bool) -> torch.Tensor:
        """``x`` ``(B, T, d)``; ``frame_masked`` ``(B, T, 1)`` True on padding."""
        x = F.glu(_linear(x, self.pointwise_conv1, dtype), dim=-1)
        x = x.masked_fill(frame_masked, 0.0).transpose(1, 2)
        conv = self.depthwise_conv
        x = F.conv1d(x, conv.weight.to(dtype), conv.bias.to(dtype),
                     padding=conv.kernel_size[0] // 2, groups=conv.groups)
        norm = self.batch_norm
        x = F.batch_norm(x.float(), norm.running_mean, norm.running_var, norm.weight,
                         norm.bias, training=train, momentum=BATCH_NORM_MOMENTUM,
                         eps=BATCH_NORM_EPS)
        return _linear(F.silu(x).transpose(1, 2), self.pointwise_conv2, dtype)


class ConformerBlock(nn.Module):
    def __init__(self, config: ConformerConfig, *, device):
        super().__init__()
        d = config.d_model

        def norm():
            return nn.LayerNorm(d, eps=LAYER_NORM_EPS, device=device)

        self.norm_feed_forward1 = norm()
        self.feed_forward1 = FeedForward(config, device=device)
        self.norm_self_att = norm()
        self.self_attn = RelPositionAttention(config, device=device)
        self.norm_conv = norm()
        self.conv = ConvModule(config, device=device)
        self.norm_feed_forward2 = norm()
        self.feed_forward2 = FeedForward(config, device=device)
        self.norm_out = norm()

    def forward(self, x: torch.Tensor, positions, masks: Tuple[torch.Tensor, ...],
                dtype: torch.dtype, train: bool, dropout: float,
                generator: Optional[torch.Generator]) -> torch.Tensor:
        """``x`` ``(B, T, d)`` fp32 -> the block's output, fp32. ``dropout`` is the rate
        in force (0 outside training)."""
        pair_masked, row_masked, frame_masked = masks

        def branch(h):
            return _dropout(h, dropout, generator) if dropout else h

        r = x + 0.5 * branch(self.feed_forward1(_layer_norm(x, self.norm_feed_forward1),
                                                dtype, dropout, generator))
        with trace.span("conformer.attention"):
            h = self.self_attn(_layer_norm(r, self.norm_self_att), positions, pair_masked,
                               row_masked, dtype)
        r = r + branch(h)
        with trace.span("conformer.conv"):
            h = self.conv(_layer_norm(r, self.norm_conv), frame_masked, dtype, train)
        r = r + branch(h)
        r = r + 0.5 * branch(self.feed_forward2(_layer_norm(r, self.norm_feed_forward2),
                                                dtype, dropout, generator))
        return _layer_norm(r, self.norm_out)


class Conformer(nn.Module):
    """``(batch, time, features) -> (batch, time', classes)`` fp32 logits."""

    asg = None  # the trainer's slot for trainable ASG tables: the Conformer has none

    def __init__(self, config: ConformerConfig, *, device):
        super().__init__()
        self.config = config
        self.pre_encode = Subsampling(config, device=device)
        self.layers = nn.ModuleList(ConformerBlock(config, device=device)
                                    for _ in range(config.n_layers))
        self.decoder = nn.Linear(config.d_model, config.grapheme_set_size, device=device)

    def prediction_lengths(self, input_lengths: torch.Tensor) -> torch.Tensor:
        return prediction_lengths(input_lengths)

    def parameter_layers(self) -> List[List[Tuple[torch.Tensor, bool]]]:
        """The parameters by layer (the subsampling, each block, the head), for the
        optimizer's freezing mask; no flag is set (no parameter has a JAX layout)."""
        groups = [self.pre_encode, *self.layers, self.decoder]
        return [[(param, False) for param in group.parameters()] for group in groups]

    def split_axes(self) -> dict:
        return {}  # never tensor-parallel

    def forward(self, inputs: torch.Tensor, train: bool = False,
                generator: Optional[torch.Generator] = None,
                input_lengths: Optional[torch.Tensor] = None) -> torch.Tensor:
        """``train=True`` uses BatchNorm's batch statistics (updating its running
        averages) and applies dropout, its masks drawn from ``generator``.
        ``input_lengths`` (``(B,)`` valid frames) default to the whole padded length."""
        config, dtype = self.config, self.config.compute_dtype
        batch, frames = inputs.shape[:2]
        if input_lengths is None:
            input_lengths = torch.full((batch,), frames, dtype=torch.int32,
                                       device=inputs.device)
        with trace.span("conformer.subsample"):
            x = self.pre_encode(inputs, dtype).float() * math.sqrt(config.d_model)
        dropout = config.dropout if train else 0.0
        if dropout:
            x = _dropout(x, dropout, generator)
        t = x.shape[1]
        lengths = prediction_lengths(input_lengths)
        valid = torch.arange(t, device=x.device)[None, :] < lengths[:, None]   # (B, T')
        masks = (~(valid[:, None, :, None] & valid[:, None, None, :]),
                 ~valid[:, None, :, None], ~valid[:, :, None])
        if trace.recording():
            trace.count("conformer.attn_pairs", batch * t * t)
            trace.count("conformer.attn_pairs_own", (lengths.to(torch.int64) ** 2).sum())
        positions = relative_positions(t, config.d_model, x.device)
        for block in self.layers:
            x = block(x, positions, masks, dtype, train, dropout, generator)
        return _linear(x, self.decoder, dtype).float()


def _glorot(shape, fan_in: int, fan_out: int, generator: torch.Generator) -> torch.Tensor:
    limit = math.sqrt(6.0 / (fan_in + fan_out))
    return (torch.rand(shape, generator=generator, dtype=torch.float64) * 2 - 1) * limit


def init_params(config: ConformerConfig, seed: int) -> Params:
    """Glorot-uniform weights (a conv's fans count its taps, a depthwise conv's one
    channel's), zero biases and position biases u, v (NeMo's), LayerNorm and BatchNorm
    scales 1 and shifts 0; drawn on the CPU from a generator seeded with ``seed``."""
    generator = torch.Generator().manual_seed(seed)
    model = Conformer(config, device="meta")
    params = {}
    for name, param in model.named_parameters():
        shape = tuple(param.shape)
        if name.endswith("depthwise_conv.weight"):
            value = _glorot(shape, shape[2], shape[2], generator)
        elif name.endswith("weight") and len(shape) >= 2:
            taps = math.prod(shape[2:])
            value = _glorot(shape, shape[1] * taps, shape[0] * taps, generator)
        elif "norm" in name.split(".")[-2] and name.endswith("weight"):
            value = torch.ones(shape)
        else:
            value = torch.zeros(shape)
        params[name] = value.to(torch.float32)
    return params


def build_model(config: ConformerConfig, params: Params, *, device) -> Conformer:
    """A `Conformer` on ``device`` holding ``params`` (every parameter by its state-dict
    name; BatchNorm's running averages start at mean 0, variance 1), in eval mode."""
    model = Conformer(config, device=device)
    expected = dict(model.named_parameters())
    if set(params) != set(expected):
        raise ValueError("params hold {} unknown and lack {} of the model's".format(
            sorted(set(params) - set(expected))[:5], sorted(set(expected) - set(params))[:5]))
    with torch.no_grad():
        for name, param in expected.items():
            value = torch.as_tensor(params[name])
            if tuple(value.shape) != tuple(param.shape):
                raise ValueError("{}: shape {}, the model's {}".format(
                    name, tuple(value.shape), tuple(param.shape)))
            param.copy_(value)
    return model.eval()
