"""CTC loss on the hand-written CUDA kernels (port of `speechless_tpu/ops/ctc_pallas.py`).

`ctc_alpha` launches ``csrc/ctc_alpha.cu`` (K1, the forward recursion) and
`ctc_beta_grad` launches ``csrc/ctc_beta_grad.cu`` (K2, the reverse recursion, fused
with the occupancy contraction into the gradient) for CUDA tensors; for CPU tensors they
run the plain versions `ops/ctc.py::forward_reference` (`alpha_reference`, then
`final_log_prob`) and `beta_reference` then `occupancy_gradient`. There is no fallback: a CUDA tensor reaches
the kernel or the call raises. `ctc_loss` is the `ops/ctc.py::CtcLoss` autograd function
on these two: its forward launches K1, which also writes each row's final log-sum-exp of
the last two states of the frozen α; its backward launches the fused kernel on the
backward's current stream. ``ctc_alpha.launches`` and ``ctc_beta_grad.launches`` count
kernel launches. The sharded wrapper of the JAX package is not ported (DDP takes its
place).
"""
from typing import Tuple, Union

import torch

from . import _kernels
from .ctc import (CtcLoss, beta_reference, check_inputs, forward_reference,
                  occupancy_gradient)

# One thread walks up to 16 states; 2U+1 above this is refused (shared memory).
MAX_STATES = 16 * 1024


def _check(name: str, log_probs, lengths, extended, skip, s_counts, *more) -> None:
    """Raise unless every tensor is contiguous, of its type and shape, on one device.
    ``more``: further (tensor, dtype, shape) triples."""
    batch, t_max, class_count = log_probs.shape
    s_count = extended.shape[1]
    expected = ((log_probs, torch.float32, (batch, t_max, class_count)),
                (lengths, torch.int32, (batch,)), (extended, torch.int32, (batch, s_count)),
                (skip, torch.bool, (batch, s_count)), (s_counts, torch.int32, (batch,)),
                *more)
    for tensor, dtype, shape in expected:
        if tensor.device != log_probs.device or tensor.dtype != dtype \
                or tuple(tensor.shape) != shape or not tensor.is_contiguous():
            raise ValueError(
                "{}: expected a contiguous {} tensor of shape {} on {}, got {} {} on {}"
                .format(name, dtype, shape, log_probs.device, tensor.dtype,
                        tuple(tensor.shape), tensor.device))
    if s_count > MAX_STATES:
        raise ValueError("{}: {} states per row; the kernel takes at most {}".format(
            name, s_count, MAX_STATES))


def _run(name: str, log_probs, *arguments) -> None:
    """Launch ``name`` on the current stream of ``log_probs``' device; raise on failure.
    ``arguments``: tensors (passed as pointers, None as a null pointer) and ints."""
    values = [a if isinstance(a, int) else (0 if a is None else a.data_ptr())
              for a in arguments]
    with torch.cuda.device(log_probs.device):
        status = _kernels.function(name)(log_probs.data_ptr(), *values,
                                         torch.cuda.current_stream().cuda_stream)
    if status != 0:
        raise RuntimeError("{} kernel launch failed with CUDA error {}".format(name, status))


def _route(name: str, log_probs) -> bool:
    """True for the kernel (CUDA), False for the plain version (CPU); raises otherwise."""
    if log_probs.device.type == "cuda":
        return True
    if log_probs.device.type == "cpu":
        return False
    raise ValueError("{} runs on CPU or CUDA tensors, got {}".format(name, log_probs.device))


def ctc_alpha(log_probs: torch.Tensor, lengths: torch.Tensor, extended: torch.Tensor,
              skip: torch.Tensor, s_counts: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(T, B, S)`` α and the ``(B,)`` log P(label) of `final_log_prob`: kernel K1 for
    CUDA tensors, `forward_reference` for CPU tensors. Takes fp32 ``log_probs``, int32
    ``lengths``/``extended``/``s_counts`` and a bool ``skip``, contiguous, on one
    device."""
    if not _route("ctc_alpha", log_probs):
        return forward_reference(log_probs, lengths, extended, skip, s_counts)
    _check("ctc_alpha", log_probs, lengths, extended, skip, s_counts)
    batch, t_max, class_count = log_probs.shape
    s_count = extended.shape[1]
    alphas = torch.empty((t_max, batch, s_count), dtype=torch.float32,
                         device=log_probs.device)
    final = torch.empty((batch,), dtype=torch.float32, device=log_probs.device)
    _run("ctc_alpha", log_probs, extended, skip, lengths, s_counts, alphas, final, batch,
         t_max, class_count, s_count)
    ctc_alpha.launches += 1
    return alphas, final


def ctc_beta_grad(log_probs: torch.Tensor, lengths: torch.Tensor, extended: torch.Tensor,
                  skip: torch.Tensor, s_counts: torch.Tensor, alphas: torch.Tensor,
                  final: torch.Tensor, grad_out: torch.Tensor, with_betas: bool = False
                  ) -> Union[torch.Tensor, Tuple[torch.Tensor, torch.Tensor]]:
    """d(loss)/d(log_probs), ``(B, T, C)``, from K1's ``alphas`` ``(T, B, S)``, the
    final log-probabilities ``final`` ``(B,)`` and the loss's ``grad_out`` ``(B,)``: the
    fused backward kernel for CUDA tensors, `beta_reference` then `occupancy_gradient`
    for CPU tensors. Other arguments as `ctc_alpha`. With ``with_betas`` it also returns
    β ``(T, B, S)`` (a check's entry: the train step does not ask for it); past a row's
    length β is NEG_INF on the kernel and unspecified on the plain version (the gradient
    masks it)."""
    if not _route("ctc_beta_grad", log_probs):
        betas = beta_reference(log_probs, lengths, extended, skip, s_counts)
        grad = occupancy_gradient(log_probs, lengths, extended, s_counts, alphas, betas,
                                  final, grad_out)
        return (grad, betas) if with_betas else grad
    batch, t_max, class_count = log_probs.shape
    s_count = extended.shape[1]
    grad_out = grad_out.to(torch.float32).contiguous()  # autograd may hand an expanded one
    _check("ctc_beta_grad", log_probs, lengths, extended, skip, s_counts,
           (alphas, torch.float32, (t_max, batch, s_count)),
           (final, torch.float32, (batch,)), (grad_out, torch.float32, (batch,)))
    grad = torch.empty_like(log_probs)
    betas = torch.empty((t_max, batch, s_count), dtype=torch.float32,
                        device=log_probs.device) if with_betas else None
    _run("ctc_beta_grad", log_probs, extended, skip, lengths, s_counts, alphas, final,
         grad_out, grad, betas, batch, t_max, class_count, s_count)
    ctc_beta_grad.launches += 1
    return (grad, betas) if with_betas else grad


ctc_alpha.launches = 0
ctc_beta_grad.launches = 0


def ctc_loss(log_probs: torch.Tensor, logit_lengths: torch.Tensor, labels: torch.Tensor,
             label_lengths: torch.Tensor, blank: int) -> torch.Tensor:
    """Per-example CTC negative log likelihood ``(B,)`` on K1 and the fused backward
    (CUDA) or the plain versions (CPU). Same contract as `ops/ctc.py::ctc_loss`."""
    check_inputs(log_probs, labels)
    return CtcLoss.apply(log_probs.contiguous(), logit_lengths, labels, label_lengths,
                         blank, ctc_alpha, ctc_beta_grad)


def ctc_loss_from_logits(logits: torch.Tensor, logit_lengths: torch.Tensor,
                         labels: torch.Tensor, label_lengths: torch.Tensor,
                         blank: int) -> torch.Tensor:
    """`ctc_loss` on raw logits: ``log_softmax`` in front."""
    return ctc_loss(torch.log_softmax(logits, dim=-1), logit_lengths, labels,
                    label_lengths, blank)
