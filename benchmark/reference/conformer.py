"""Conformer-CTC in plain PyTorch: the reference the Conformer training cell's outputs are
held to, with the cell's weights, its three reference steps and its control. It loads
nothing of the port; parameters go by the port's state-dict names (`param_shapes`).

The forward is what NeMo's ``ConformerEncoder`` (``rel_pos`` attention, ``striding``
subsampling, ``xscaling``, full context) and a 1 x 1 conv CTC head compute, in training
mode (BatchNorm's batch statistics). It departs from NeMo's code, not its result, where
the port follows NeMo's code: the scores are plain matmuls and an explicit softmax (no
SDPA); the position term is an explicit gather of offset ``i - j`` out of ``(q + v) p^T``
over all offsets (NeMo's ``rel_shift`` aligns it); masks are explicit ``(B, T', T')``
pair masks whose masked scores are replaced by -10000 (NeMo's matmul route; its SDPA
route adds -10000 to ``q . k``, the same softmax wherever a row has a valid key), and
padded queries' rows are zeroed after the softmax; BatchNorm is its formula over all
``B x T'`` positions, padding included; the pointwise convs are matmuls. Each block is
recomputed in the backward (`torch.utils.checkpoint`): fp32 scores of 32 rows at 616
frames would not otherwise fit beside the corpus. Rows are never split: BatchNorm couples
them.

``precision`` as in `w2l.py`: ``"fp32"`` is IEEE fp32 (TF32 off); ``"fp8"`` rounds both
operands of every GEMM (the attention's score, position and value products too) and
conv to float8 e4m3 under a per-tensor scale (the control, one step below the bf16 the
configuration states).
"""
import math
import statistics
from typing import Dict, List, Tuple

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from . import train as plain_train
from . import w2l

MASK_FILL = -10000.0
EPS = 1e-5


def param_shapes(config: dict) -> List[Tuple[str, tuple, str]]:
    """``(name, shape, kind)`` of every parameter by its name in the port's state dict;
    ``kind`` is ``weight``, ``depthwise``, ``bias``, ``scale``, ``shift`` or
    ``position_bias``."""
    d, channels = config["d_model"], config["subsampling_conv_channels"]
    heads, inner = config["n_heads"], config["ff_expansion_factor"] * config["d_model"]
    frequencies = (((config["feat_in"] - 1) // 2 + 1) - 1) // 2 + 1
    shapes = [("pre_encode.conv1.weight", (channels, 1, 3, 3), "weight"),
              ("pre_encode.conv1.bias", (channels,), "bias"),
              ("pre_encode.conv2.weight", (channels, channels, 3, 3), "weight"),
              ("pre_encode.conv2.bias", (channels,), "bias")]

    def linear(name, n_in, n_out, bias=True):
        shapes.append((name + ".weight", (n_out, n_in), "weight"))
        if bias:
            shapes.append((name + ".bias", (n_out,), "bias"))

    def norm(name):
        shapes.extend([(name + ".weight", (d,), "scale"), (name + ".bias", (d,), "shift")])

    linear("pre_encode.out", channels * frequencies, d)
    for index in range(config["n_layers"]):
        block = "layers.{}.".format(index)
        for ff in ("1", "2"):
            norm(block + "norm_feed_forward" + ff)
            linear(block + "feed_forward" + ff + ".linear1", d, inner)
            linear(block + "feed_forward" + ff + ".linear2", inner, d)
        norm(block + "norm_self_att")
        for part in ("q", "k", "v", "out"):
            linear(block + "self_attn.linear_" + part, d, d)
        linear(block + "self_attn.linear_pos", d, d, bias=False)
        shapes.extend((block + "self_attn.pos_bias_" + bias, (heads, d // heads),
                       "position_bias") for bias in ("u", "v"))
        norm(block + "norm_conv")
        linear(block + "conv.pointwise_conv1", d, 2 * d)
        shapes.append((block + "conv.depthwise_conv.weight", (d, 1, config["conv_kernel_size"]),
                       "depthwise"))
        shapes.append((block + "conv.depthwise_conv.bias", (d,), "bias"))
        shapes.extend([(block + "conv.batch_norm.weight", (d,), "scale"),
                       (block + "conv.batch_norm.bias", (d,), "shift")])
        linear(block + "conv.pointwise_conv2", d, d)
        norm(block + "norm_out")
    linear("decoder", d, config["classes"])
    return shapes


# Draws for the tensors that are not Glorot weights: (low, high) of a uniform.
DRAWS = {"bias": (-0.1, 0.1), "scale": (0.9, 1.1), "shift": (-0.1, 0.1),
         "position_bias": (-0.5, 0.5)}


def draw_params(config: dict, generator: torch.Generator, device) -> Dict[str, torch.Tensor]:
    """The cell's weights, drawn on ``device`` in one call from ``generator``:
    Glorot-uniform weights (fans count a conv's taps; the depthwise conv's are one
    channel's) and every other tensor uniform over its `DRAWS` range."""
    shapes = param_shapes(config)
    sizes = [math.prod(shape) for _, shape, _ in shapes]
    flat = torch.rand(sum(sizes), generator=generator, device=device)
    params, offset = {}, 0
    for (name, shape, kind), size in zip(shapes, sizes):
        unit = flat[offset:offset + size].view(shape)
        offset += size
        if kind in ("weight", "depthwise"):
            taps = math.prod(shape[2:])
            fan_in, fan_out = shape[1] * taps, (shape[1] if kind == "depthwise" else
                                                shape[0]) * taps
            limit = math.sqrt(6.0 / (fan_in + fan_out))
            params[name] = unit * (2 * limit) - limit
        else:
            low, high = DRAWS[kind]
            params[name] = low + unit * (high - low)
    return params


def out_lengths(lengths: torch.Tensor) -> torch.Tensor:
    for _ in range(2):
        lengths = torch.div(lengths - 1, 2, rounding_mode="floor") + 1
    return lengths


def sinusoids(frames: int, d_model: int, device) -> torch.Tensor:
    """Row ``k`` is the sinusoid of offset ``frames - 1 - k`` (sin even, cos odd)."""
    offsets = torch.arange(frames - 1, -frames, -1, dtype=torch.float64, device=device)
    index = torch.arange(d_model, device=device)
    angle = offsets[:, None] * torch.pow(10000.0, -(index - index % 2) / d_model)[None]
    return torch.where(index % 2 == 0, torch.sin(angle), torch.cos(angle)).float()


class Forward:
    """The forward at one ``precision`` over a parameter dict."""

    def __init__(self, params: Dict[str, torch.Tensor], precision: str):
        self.params, self.precision = params, precision

    def rounded(self, x):
        return w2l.fp8_rounded(x) if self.precision == "fp8" else x

    def linear(self, x, name):
        y = self.rounded(x) @ self.rounded(self.params[name + ".weight"]).t()
        bias = self.params.get(name + ".bias")
        return y if bias is None else y + bias

    def layer_norm(self, x, name):
        mean = x.mean(-1, keepdim=True)
        var = ((x - mean) ** 2).mean(-1, keepdim=True)
        return ((x - mean) / torch.sqrt(var + EPS) * self.params[name + ".weight"]
                + self.params[name + ".bias"])

    def feed_forward(self, x, name):
        h = self.linear(x, name + ".linear1")
        return self.linear(h * torch.sigmoid(h), name + ".linear2")

    def attention(self, x, name, valid, positions):
        b, t, d = x.shape
        u, v = self.params[name + ".pos_bias_u"], self.params[name + ".pos_bias_v"]
        heads, d_k = u.shape
        q = self.linear(x, name + ".linear_q").view(b, t, heads, d_k)
        k = self.linear(x, name + ".linear_k").view(b, t, heads, d_k).transpose(1, 2)
        values = self.linear(x, name + ".linear_v").view(b, t, heads, d_k).transpose(1, 2)
        p = self.linear(positions, name + ".linear_pos").view(2 * t - 1, heads, d_k)
        r = self.rounded
        content = r((q + u).transpose(1, 2)) @ r(k.transpose(-1, -2))      # (B, H, T, T)
        every_offset = torch.einsum("bihd,khd->bhik", r(q + v), r(p))     # (B, H, T, 2T-1)
        i = torch.arange(t, device=x.device)[:, None]
        j = torch.arange(t, device=x.device)[None, :]
        scores = (content + every_offset[:, :, i, (t - 1) - (i - j)]) / math.sqrt(d_k)
        pair_valid = (valid[:, :, None] & valid[:, None, :])[:, None]
        scores = torch.where(pair_valid, scores, torch.full_like(scores, MASK_FILL))
        weights = torch.softmax(scores, dim=-1)
        weights = torch.where(valid[:, None, :, None], weights, torch.zeros_like(weights))
        out = (r(weights) @ r(values)).transpose(1, 2).reshape(b, t, d)
        return self.linear(out, name + ".linear_out")

    def conv_module(self, x, name, valid):
        h = self.linear(x, name + ".pointwise_conv1")
        half = h.shape[-1] // 2
        h = h[..., :half] * torch.sigmoid(h[..., half:])
        h = torch.where(valid[:, :, None], h, torch.zeros_like(h)).transpose(1, 2)
        weight = self.params[name + ".depthwise_conv.weight"]
        h = F.conv1d(self.rounded(h), self.rounded(weight),
                     self.params[name + ".depthwise_conv.bias"],
                     padding=weight.shape[-1] // 2, groups=weight.shape[0])
        mean = h.mean(dim=(0, 2), keepdim=True)
        var = ((h - mean) ** 2).mean(dim=(0, 2), keepdim=True)
        h = ((h - mean) / torch.sqrt(var + EPS)
             * self.params[name + ".batch_norm.weight"][None, :, None]
             + self.params[name + ".batch_norm.bias"][None, :, None])
        h = h * torch.sigmoid(h)
        return self.linear(h.transpose(1, 2), name + ".pointwise_conv2")

    def block(self, x, index, valid, positions):
        name = "layers.{}".format(index)
        r = x + 0.5 * self.feed_forward(self.layer_norm(x, name + ".norm_feed_forward1"),
                                        name + ".feed_forward1")
        r = r + self.attention(self.layer_norm(r, name + ".norm_self_att"),
                               name + ".self_attn", valid, positions)
        r = r + self.conv_module(self.layer_norm(r, name + ".norm_conv"), name + ".conv",
                                 valid)
        r = r + 0.5 * self.feed_forward(self.layer_norm(r, name + ".norm_feed_forward2"),
                                        name + ".feed_forward2")
        return self.layer_norm(r, name + ".norm_out")

    def __call__(self, inputs: torch.Tensor, lengths: torch.Tensor, layers: int):
        """``inputs (B, T, F)`` -> logits ``(B, T', C)`` fp32 and the output lengths."""
        x = inputs.to(torch.float32).unsqueeze(1)
        for conv in ("pre_encode.conv1", "pre_encode.conv2"):
            x = F.relu(F.conv2d(self.rounded(x), self.rounded(self.params[conv + ".weight"]),
                                self.params[conv + ".bias"], stride=2, padding=1))
        b, c, t, f = x.shape
        x = self.linear(x.permute(0, 2, 1, 3).reshape(b, t, c * f), "pre_encode.out")
        x = x * math.sqrt(x.shape[-1])
        frames = out_lengths(lengths.to(torch.int64))
        valid = torch.arange(t, device=x.device)[None, :] < frames[:, None]
        positions = sinusoids(t, x.shape[-1], x.device)
        for index in range(layers):
            x = checkpoint(self.block, x, index, valid, positions, use_reentrant=False)
        return self.linear(x, "decoder"), frames


def steps(weights: Dict[str, torch.Tensor], config: dict, batches, learning_rate: float,
          precision: str = "fp32") -> dict:
    """``len(batches)`` reference steps from ``weights``: each the forward, log-softmax
    and CTC in float64 (`train.ctc_losses`, infeasible labels scoring 0), the batch mean,
    the backward and a plain Adam (`train.BETAS`, `train.EPS`, bias-corrected). Returns
    the losses, the first gradient and the parameters after the last step."""
    params = {name: w.detach().clone().requires_grad_(True) for name, w in weights.items()}
    moments = {name: (torch.zeros_like(p), torch.zeros_like(p)) for name, p in params.items()}
    (b1, b2), losses, first_gradient = plain_train.BETAS, [], None
    forward = Forward(params, precision)
    with w2l.arithmetic(precision):
        for step, (features, frames, labels, label_counts) in enumerate(batches, start=1):
            logits, out_frames = forward(features, frames, config["n_layers"])
            loss = plain_train.ctc_losses(logits, out_frames, labels, label_counts, 1).mean()
            loss.backward()
            losses.append(float(loss.detach()))
            with torch.no_grad():
                if first_gradient is None:
                    first_gradient = {name: p.grad.clone() for name, p in params.items()}
                for name, p in params.items():
                    m, v = moments[name]
                    m.mul_(b1).add_(p.grad, alpha=1 - b1)
                    v.mul_(b2).addcmul_(p.grad, p.grad, value=1 - b2)
                    p.sub_(learning_rate * (m / (1 - b1 ** step))
                           / ((v / (1 - b2 ** step)).sqrt() + plain_train.EPS))
                    p.grad = None
    return {"losses": losses, "first_gradient": first_gradient,
            "after": {name: p.detach() for name, p in params.items()}}


def numbers(program: dict, reference: dict, weights: Dict[str, torch.Tensor]) -> list:
    """``loss_gap``, ``grad_gap`` and ``change_gap`` as `train.numbers` defines them, over
    every parameter by name; leaves whose reference gradient is under `train.QUIET_LEAF`
    of the median leaf's (a key bias, which softmax ignores, and the depthwise conv's
    bias, which BatchNorm's batch mean removes) are left out."""
    names = list(weights)
    ref_grad = [reference["first_gradient"][name] for name in names]
    norms = [float(g.norm()) for g in ref_grad]
    median = statistics.median(norms)
    kept = [n >= plain_train.QUIET_LEAF * median for n in norms]
    change = [[run["after"][name] - weights[name] for name in names]
              for run in (program, reference)]
    loss_gap = max(abs(p - r) / abs(r) for p, r in zip(program["losses"],
                                                        reference["losses"]))
    return [("loss_gap", loss_gap),
            ("grad_gap", plain_train.worst_leaf_gap(
                [program["first_gradient"][name] for name in names], ref_grad, kept)),
            ("change_gap", plain_train.worst_leaf_gap(change[0], change[1], kept))]


def _batches(cell) -> list:
    return [(f.to(torch.float32), n, l, c) for f, n, l, c in cell.check_batches]


def compare(cell) -> list:
    """The correctness check: the reference's three fp32 steps on the cell's check rows
    against the program's, which `drivers/train_conformer_resident.py` kept."""
    reference = steps(cell.weights, cell.config, _batches(cell), cell.learning_rate)
    program = {"losses": cell.losses, "first_gradient": cell.first_gradient,
               "after": cell.after_check}
    return numbers(program, reference, cell.weights)


def control(cell, precision: str) -> list:
    """The control: the reference computed in ``precision`` put in the program's place."""
    args = (cell.weights, cell.config, _batches(cell), cell.learning_rate)
    return numbers(steps(*args, precision=precision), steps(*args), cell.weights)
