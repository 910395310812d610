"""Conformer-CTC in plain PyTorch, float32 with TF32 off: the reference that
`speechless_tpu_torch.models.conformer` is held to. It imports nothing of either package.

It computes what NeMo's ``ConformerEncoder`` (``self_attention_model: rel_pos``,
``subsampling: striding``, ``xscaling: true``, full context) and a 1 x 1 conv CTC head
compute, from the weights by the port's state-dict names. It departs from NeMo's code,
not its result, where the port follows NeMo's code, so that the two routes differ:

* no ``scaled_dot_product_attention``: the scores are ``(q + u) k^T`` plus the position
  term, divided by sqrt(d_k), then an explicit softmax and the value product;
* the position term by an explicit gather of offset ``i - j`` for each query ``i`` and
  key ``j`` out of ``(q + v) p^T`` over all offsets, where NeMo (and the port) align it
  with ``rel_shift``;
* masks built from the lengths as explicit ``(B, T', T')`` pair masks: a masked score is
  replaced by -10000 (NeMo's matmul route; its SDPA route adds -10000 to ``q . k``,
  which gives the same softmax wherever a row has a valid key), and the rows of padded
  queries are zeroed after the softmax;
* BatchNorm by its formula: the batch mean and biased variance over all ``B x T'``
  positions (padding included, as NeMo's ``BatchNorm1d`` sees them), and the running
  averages updated with the unbiased variance and momentum 0.1;
* the pointwise convs as matmuls over ``(B, T', C)``; no dropout.
"""
import math
from typing import Dict, List, Optional, Tuple

import torch
import torch.nn.functional as F

MASK_FILL = -10000.0
EPS = 1e-5
MOMENTUM = 0.1


def out_lengths(lengths: torch.Tensor) -> torch.Tensor:
    """Frames after the two stride-2 convs: ``floor((L - 1) / 2) + 1``, twice."""
    for _ in range(2):
        lengths = torch.div(lengths - 1, 2, rounding_mode="floor") + 1
    return lengths


def sinusoids(frames: int, d_model: int) -> torch.Tensor:
    """Row ``k`` is the sinusoid of offset ``frames - 1 - k``."""
    offsets = torch.arange(frames - 1, -frames, -1, dtype=torch.float64)
    index = torch.arange(d_model)
    angle = offsets[:, None] * torch.pow(10000.0, -(index - index % 2) / d_model)[None]
    return torch.where(index % 2 == 0, torch.sin(angle), torch.cos(angle)).float()


def layer_norm(x, params, name):
    mean = x.mean(-1, keepdim=True)
    var = ((x - mean) ** 2).mean(-1, keepdim=True)
    return (x - mean) / torch.sqrt(var + EPS) * params[name + ".weight"] + params[name + ".bias"]


def linear(x, params, name):
    y = x @ params[name + ".weight"].t()
    bias = params.get(name + ".bias")
    return y if bias is None else y + bias


def swish(x):
    return x * torch.sigmoid(x)


def feed_forward(x, params, name):
    return linear(swish(linear(x, params, name + ".linear1")), params, name + ".linear2")


def attention(x, params, name, valid):
    """Relative-position self-attention over ``x`` ``(B, T, d)``; ``valid`` ``(B, T)``."""
    b, t, d = x.shape
    u, v = params[name + ".pos_bias_u"], params[name + ".pos_bias_v"]
    heads, d_k = u.shape
    q = linear(x, params, name + ".linear_q").view(b, t, heads, d_k)
    k = linear(x, params, name + ".linear_k").view(b, t, heads, d_k).transpose(1, 2)
    values = linear(x, params, name + ".linear_v").view(b, t, heads, d_k).transpose(1, 2)
    p = (sinusoids(t, d).to(x.device) @ params[name + ".linear_pos.weight"].t()).view(
        2 * t - 1, heads, d_k)
    content = (q + u).transpose(1, 2) @ k.transpose(-1, -2)              # (B, H, T, T)
    every_offset = torch.einsum("bihd,khd->bhik", q + v, p)              # (B, H, T, 2T-1)
    i = torch.arange(t)[:, None]
    j = torch.arange(t)[None, :]
    column = (t - 1) - (i - j)              # the row of offset i - j in the sinusoids
    position = every_offset[:, :, i, column]
    scores = (content + position) / math.sqrt(d_k)
    pair_valid = (valid[:, :, None] & valid[:, None, :])[:, None]
    scores = torch.where(pair_valid, scores, torch.full_like(scores, MASK_FILL))
    weights = torch.softmax(scores, dim=-1)
    weights = torch.where(valid[:, None, :, None], weights, torch.zeros_like(weights))
    out = (weights @ values).transpose(1, 2).reshape(b, t, d)
    return linear(out, params, name + ".linear_out")


def batch_norm(x, params, name, running: Optional[dict]):
    """``x`` ``(B, C, T)``; updates ``running[name]`` = (mean, var) when given."""
    mean = x.mean(dim=(0, 2))
    var = ((x - mean[None, :, None]) ** 2).mean(dim=(0, 2))
    if running is not None:
        count = x.shape[0] * x.shape[2]
        old_mean, old_var = running[name]
        running[name] = ((1 - MOMENTUM) * old_mean + MOMENTUM * mean.detach(),
                         (1 - MOMENTUM) * old_var
                         + MOMENTUM * var.detach() * count / (count - 1))
    normal = (x - mean[None, :, None]) / torch.sqrt(var[None, :, None] + EPS)
    return normal * params[name + ".weight"][None, :, None] + params[name + ".bias"][None, :, None]


def conv_module(x, params, name, valid, running):
    h = linear(x, params, name + ".pointwise_conv1")
    half = h.shape[-1] // 2
    h = h[..., :half] * torch.sigmoid(h[..., half:])
    h = torch.where(valid[:, :, None], h, torch.zeros_like(h)).transpose(1, 2)
    weight = params[name + ".depthwise_conv.weight"]
    h = F.conv1d(h, weight, params[name + ".depthwise_conv.bias"],
                 padding=weight.shape[-1] // 2, groups=weight.shape[0])
    h = swish(batch_norm(h, params, name + ".batch_norm", running))
    return linear(h.transpose(1, 2), params, name + ".pointwise_conv2")


def block(x, params, name, valid, running):
    r = x + 0.5 * feed_forward(layer_norm(x, params, name + ".norm_feed_forward1"), params,
                               name + ".feed_forward1")
    r = r + attention(layer_norm(r, params, name + ".norm_self_att"), params,
                      name + ".self_attn", valid)
    r = r + conv_module(layer_norm(r, params, name + ".norm_conv"), params, name + ".conv",
                        valid, running)
    r = r + 0.5 * feed_forward(layer_norm(r, params, name + ".norm_feed_forward2"), params,
                               name + ".feed_forward2")
    return layer_norm(r, params, name + ".norm_out")


def layer_count(params: Dict[str, torch.Tensor]) -> int:
    return 1 + max(int(name.split(".")[1]) for name in params if name.startswith("layers."))


def forward(params: Dict[str, torch.Tensor], inputs: torch.Tensor, lengths: torch.Tensor,
            running: Optional[dict] = None) -> Tuple[torch.Tensor, torch.Tensor]:
    """``inputs`` ``(B, T, F)``, ``lengths`` ``(B,)`` -> logits ``(B, T', classes)`` and
    the output lengths, in training mode (batch statistics). ``running`` maps each
    BatchNorm's name to its (mean, var) running averages, updated in place."""
    saved = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    try:
        x = inputs.float().unsqueeze(1)
        for conv in ("pre_encode.conv1", "pre_encode.conv2"):
            x = F.relu(F.conv2d(x, params[conv + ".weight"], params[conv + ".bias"],
                                stride=2, padding=1))
        b, c, t, f = x.shape
        x = linear(x.permute(0, 2, 1, 3).reshape(b, t, c * f), params, "pre_encode.out")
        x = x * math.sqrt(x.shape[-1])
        frames = out_lengths(lengths.long())
        valid = torch.arange(t, device=x.device)[None, :] < frames[:, None]
        for index in range(layer_count(params)):
            x = block(x, params, "layers.{}".format(index), valid, running)
        return linear(x, params, "decoder"), frames
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved


def batch_norm_names(params: Dict[str, torch.Tensor]) -> List[str]:
    return ["layers.{}.conv.batch_norm".format(i) for i in range(layer_count(params))]
