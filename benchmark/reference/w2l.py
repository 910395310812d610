"""The wav2letter stack in plain PyTorch: the reference the cells' outputs are held to.

Each layer is ``conv1d`` over ``(batch, channels, frames)`` with XLA's SAME padding
(total ``max((ceil(T/s) - 1) s + k - T, 0)``, the smaller half in front), its bias,
then ReLU, except the last layer, which is linear (arXiv:1609.03193; speechless
``net.py``). Weights are torch's ``(C_out, C_in, K)``.

``precision`` selects the arithmetic: ``"fp32"`` is IEEE fp32 (TF32 off for the call);
the controls, one precision step below what a configuration states, are ``"tf32"``
(TF32 on) and ``"fp8"`` (every conv's input and weight rounded to float8 e4m3 with a
per-tensor scale, the gradient passing straight through the rounding).
"""
import contextlib
from typing import List, Sequence, Tuple

import torch
import torch.nn.functional as F

FP8_MAX = 448.0  # largest finite float8 e4m3fn value

Weights = List[Tuple[torch.Tensor, torch.Tensor]]


@contextlib.contextmanager
def arithmetic(precision: str):
    """TF32 on for ``"tf32"``, off otherwise, restored on exit."""
    saved = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    allow = precision == "tf32"
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = allow
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved


def fp8_rounded(x: torch.Tensor) -> torch.Tensor:
    """``x`` rounded to float8 e4m3 under a per-tensor scale, in ``x``'s type; the
    gradient passes unchanged."""
    scale = x.detach().abs().amax().clamp(min=1e-30) / FP8_MAX
    rounded = (x.detach() / scale).to(torch.float8_e4m3fn).to(x.dtype) * scale
    return x + (rounded - x).detach()


def same_padding(frames: int, kernel_size: int, stride: int) -> Tuple[int, int]:
    total = max((-(-frames // stride) - 1) * stride + kernel_size - frames, 0)
    return total // 2, total - total // 2


def forward(weights: Weights, layers: Sequence[dict], inputs: torch.Tensor,
            precision: str = "fp32") -> torch.Tensor:
    """``inputs (B, T, F)`` -> logits ``(B, T', C)`` in fp32."""
    x = inputs.to(torch.float32).transpose(1, 2)
    with arithmetic(precision):
        for index, ((w, b), layer) in enumerate(zip(weights, layers)):
            x = F.pad(x, same_padding(x.shape[2], layer["kernel_size"], layer["stride"]))
            if precision == "fp8":
                x, w = fp8_rounded(x), fp8_rounded(w)
            x = F.conv1d(x, w, b, layer["stride"])
            if index < len(layers) - 1:
                x = F.relu(x)
    return x.transpose(1, 2)


def glorot_weights(layers: Sequence[dict], input_size: int, generator: torch.Generator,
                   device) -> Weights:
    """Glorot-uniform weights and zero biases (Keras' Conv1D defaults), drawn on
    ``device`` in one call from ``generator``."""
    shapes, channels = [], input_size
    for layer in layers:
        shapes.append((layer["filters"], channels, layer["kernel_size"]))
        channels = layer["filters"]
    sizes = [c_out * c_in * k for c_out, c_in, k in shapes]
    flat = torch.rand(sum(sizes), generator=generator, device=device)
    weights, offset = [], 0
    for (c_out, c_in, k), size in zip(shapes, sizes):
        limit = (6.0 / (k * c_in + k * c_out)) ** 0.5
        w = (flat[offset:offset + size] * (2 * limit) - limit).view(c_out, c_in, k)
        weights.append((w, torch.zeros(c_out, device=device)))
        offset += size
    return weights
