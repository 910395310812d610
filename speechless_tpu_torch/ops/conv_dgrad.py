"""A SAME-padded stride-1 conv whose data gradient runs on a hand-written Hopper kernel.

`same_conv1d` is the bf16 training path's conv for a stride-1 layer with more than one
tap: forward ``F.pad`` then ``F.conv1d`` (cuDNN on the card, as before), backward the
weight gradient by ``aten.convolution_backward`` (the call autograd made before, cuDNN
on the card) and the data gradient by `conv_dgrad`. `conv_dgrad` launches
``csrc/conv_dgrad.cu`` for CUDA tensors and runs the plain version `dgrad_reference` for
CPU tensors; a CUDA tensor reaches the kernel or the call raises. It writes the
gradient of the unpadded input directly, so SAME's padded frames are never computed.
``conv_dgrad.launches`` counts kernel launches.

The route is decided by the conv's shape (`takes_kernel`): the kernel computes a data
gradient when the conv has at least `KERNEL_MIN_TAPS` taps and at most 256 input
channels (the kernel's N). Any other keeps cuDNN's data gradient, from the same
``convolution_backward`` call as its weight gradient. While a profiler records
(`utils/trace.py`), each data gradient counts ``conv.dgrad_kernel`` (the kernel's route:
the kernel on the card, `dgrad_reference` on the CPU) or ``conv.dgrad_cudnn`` (left to
``convolution_backward``). A frozen input asks for no data gradient and counts nothing.
"""
from typing import Tuple

import torch
import torch.nn.functional as F

from ..utils import trace
from . import _kernels

# The kernel's N: input channels, zero-padded to this.
KERNEL_CHANNELS = 256
# The width rule: a conv with fewer taps keeps cuDNN's data gradient. On an H100 (SXM,
# 700 W) at the training cell's 64 x 1,536 frames the whole call (dY's frame-major copy,
# W's layout and the kernel) took 5.005 ms for big_conv_1's 32 taps (2000 -> 250
# channels) against cuDNN's 154.08 ms, and 0.2200 ms for an inner conv's 7 taps
# (250 -> 250) against cuDNN's 0.3272 ms. No narrower width was measured.
KERNEL_MIN_TAPS = 7


def takes_kernel(weight: torch.Tensor) -> bool:
    """Whether a stride-1 conv of ``weight`` ``(Cout, Cin, K)`` takes its data gradient
    from the kernel (else from cuDNN)."""
    return weight.shape[2] >= KERNEL_MIN_TAPS and weight.shape[1] <= KERNEL_CHANNELS


def dgrad_reference(grad_out: torch.Tensor, weight: torch.Tensor,
                    pad_low: int) -> torch.Tensor:
    """The plain version of the kernel: d(loss)/d(x) ``(B, Cin, T)`` of a stride-1 conv
    of the input ``x`` padded by ``pad_low`` frames below (SAME), from its output's
    gradient ``grad_out`` ``(B, Cout, T)`` and ``weight`` ``(Cout, Cin, K)``.
    ``dX[:, ci, s] = sum_k sum_co W[co, ci, k] dY[:, co, s + pad_low - k]`` (zero outside
    the frames), tap by tap, summed in fp32 (fp64 for fp64 inputs) and rounded once to
    ``grad_out``'s type."""
    batch, _, frames = grad_out.shape
    _, in_channels, taps = weight.shape
    dtype = torch.promote_types(grad_out.dtype, torch.float32)
    grad, kernel = grad_out.to(dtype), weight.to(dtype)
    total = grad.new_zeros((batch, in_channels, frames))
    for k in range(taps):
        shift = pad_low - k  # frame s reads the output gradient at s + shift
        low, high = max(0, -shift), min(frames, frames - shift)
        if low < high:
            total[:, :, low:high] += torch.einsum(
                "oc,bot->bct", kernel[:, :, k], grad[:, :, low + shift:high + shift])
    return total.to(grad_out.dtype)


def weight_layout(weight: torch.Tensor) -> torch.Tensor:
    """``weight`` ``(Cout, Cin, K)`` as the kernel reads it: ``(K, 256, Cout')`` bf16,
    ``W[co, ci, k]`` at ``[k, ci, co]``, zero for the padded input channels and for the
    output channels up to ``Cout'``, the next multiple of 8 (TMA's 16-byte strides)."""
    out_channels, in_channels, _ = weight.shape
    return F.pad(weight.to(torch.bfloat16).permute(2, 1, 0),
                 (0, -out_channels % 8, 0, KERNEL_CHANNELS - in_channels)).contiguous()


def conv_dgrad(grad_out: torch.Tensor, weight: torch.Tensor, pad_low: int) -> torch.Tensor:
    """`dgrad_reference`'s gradient: the kernel for CUDA tensors (bf16 ``grad_out`` and
    ``weight``, at most 256 input channels), the plain version for CPU tensors."""
    if grad_out.device.type == "cpu":
        return dgrad_reference(grad_out, weight, pad_low)
    if grad_out.device.type != "cuda":
        raise ValueError("conv_dgrad runs on CPU or CUDA tensors, got {}".format(
            grad_out.device))
    batch, out_channels, frames = grad_out.shape
    _, in_channels, taps = weight.shape
    if grad_out.dtype != torch.bfloat16 or weight.dtype != torch.bfloat16 \
            or weight.device != grad_out.device or weight.shape[0] != out_channels \
            or in_channels > KERNEL_CHANNELS:
        raise ValueError(
            "conv_dgrad: expected bf16 grad_out (B, Cout, T) and weight (Cout, Cin<={}, K) "
            "on one device, got {} {} and {} {}".format(
                KERNEL_CHANNELS, grad_out.dtype, tuple(grad_out.shape), weight.dtype,
                tuple(weight.shape)))
    # The kernel shifts dY by a frame a tap, and TMA moves the contiguous dimension only
    # in 16-byte steps: the launch first copies dY frame-major into `rows`, whose rows
    # are 16-byte multiples (Cout' a multiple of 8).
    cout_stride = out_channels + -out_channels % 8
    grad = grad_out.contiguous()
    rows = torch.empty((batch, frames, cout_stride), dtype=torch.bfloat16,
                       device=grad_out.device)
    layout = weight_layout(weight)
    grad_in = torch.empty((batch, in_channels, frames), dtype=torch.bfloat16,
                          device=grad_out.device)
    with torch.cuda.device(grad_out.device):
        status = _kernels.function("conv_dgrad")(
            grad.data_ptr(), rows.data_ptr(), layout.data_ptr(), grad_in.data_ptr(), batch,
            out_channels, in_channels, frames, cout_stride, taps, pad_low,
            torch.cuda.current_stream().cuda_stream)
    if status != 0:
        raise RuntimeError("conv_dgrad kernel launch failed with CUDA error {}".format(status))
    conv_dgrad.launches += 1
    return grad_in


conv_dgrad.launches = 0


class SameConv1d(torch.autograd.Function):
    """``F.conv1d(F.pad(x, padding), weight)`` for stride 1, with the data gradient on
    `conv_dgrad` when `takes_kernel` (see the module docstring)."""

    @staticmethod
    def forward(ctx, x: torch.Tensor, weight: torch.Tensor,
                padding: Tuple[int, int]) -> torch.Tensor:
        padded = F.pad(x, padding)
        ctx.save_for_backward(padded, weight)
        ctx.pad_low, ctx.frames = padding[0], x.shape[2]
        return F.conv1d(padded, weight)

    @staticmethod
    def backward(ctx, grad: torch.Tensor):
        padded, weight = ctx.saved_tensors
        input_grad, weight_grad = ctx.needs_input_grad[:2]
        routed = input_grad and takes_kernel(weight)
        grad_padded, grad_weight, _ = torch.ops.aten.convolution_backward(
            grad, padded, weight, None, [1], [0], [1], False, [0], 1,
            [input_grad and not routed, weight_grad, False])
        grad_x = None
        if routed:
            grad_x = conv_dgrad(grad, weight, ctx.pad_low)
            trace.count("conv.dgrad_kernel", 1)
        elif input_grad:
            grad_x = grad_padded[:, :, ctx.pad_low:ctx.pad_low + ctx.frames].contiguous()
            trace.count("conv.dgrad_cudnn", 1)
        return grad_x, grad_weight, None


def same_conv1d(x: torch.Tensor, weight: torch.Tensor,
                padding: Tuple[int, int]) -> torch.Tensor:
    """A stride-1 conv of ``x`` ``(B, Cin, T)`` padded by ``padding`` (SAME's frames
    below and above) with ``weight`` ``(Cout, Cin, K)``, no bias: `SameConv1d`."""
    return SameConv1d.apply(x, weight, padding)
