"""CTC loss on the hand-written CUDA kernels K1/K2 (port of
`speechless_tpu/ops/ctc_pallas.py`).

`ctc_alpha` launches ``csrc/ctc_alpha.cu`` (K1, the forward recursion) and `ctc_beta`
launches ``csrc/ctc_beta.cu`` (K2, the reverse one) for CUDA tensors; for CPU tensors
they run the plain versions `ops/ctc.py::alpha_reference`/`beta_reference`. There is no
fallback: a CUDA tensor reaches the kernel or the call raises. `ctc_loss` is the
`ops/ctc.py::CtcLoss` autograd function on these two: its forward launches K1 and takes
the final log-sum-exp of the last two states of the frozen α, its backward launches K2
on the backward's current stream and contracts the occupancies in PyTorch, as the JAX
package did in XLA. ``ctc_alpha.launches`` and ``ctc_beta.launches`` count kernel
launches. The sharded wrapper of the JAX package is not ported (DDP takes its place).
"""
import torch

from . import _kernels
from .ctc import CtcLoss, alpha_reference, beta_reference, check_inputs

# One thread walks up to 16 states; 2U+1 above this is refused (shared memory).
MAX_STATES = 16 * 1024


def _launch(name: str, log_probs, lengths, extended, skip, s_counts) -> torch.Tensor:
    batch, t_max, class_count = log_probs.shape
    s_count = extended.shape[1]
    expected = ((log_probs, torch.float32, (batch, t_max, class_count)),
                (lengths, torch.int32, (batch,)), (extended, torch.int32, (batch, s_count)),
                (skip, torch.bool, (batch, s_count)), (s_counts, torch.int32, (batch,)))
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
    out = torch.empty((t_max, batch, s_count), dtype=torch.float32, device=log_probs.device)
    with torch.cuda.device(log_probs.device):
        status = _kernels.function(name)(
            log_probs.data_ptr(), extended.data_ptr(), skip.data_ptr(), lengths.data_ptr(),
            s_counts.data_ptr(), out.data_ptr(), batch, t_max, class_count, s_count,
            torch.cuda.current_stream().cuda_stream)
    if status != 0:
        raise RuntimeError("{} kernel launch failed with CUDA error {}".format(name, status))
    return out


def _route(name: str, log_probs) -> bool:
    """True for the kernel (CUDA), False for the plain version (CPU); raises otherwise."""
    if log_probs.device.type == "cuda":
        return True
    if log_probs.device.type == "cpu":
        return False
    raise ValueError("{} runs on CPU or CUDA tensors, got {}".format(name, log_probs.device))


def ctc_alpha(log_probs: torch.Tensor, lengths: torch.Tensor, extended: torch.Tensor,
              skip: torch.Tensor, s_counts: torch.Tensor) -> torch.Tensor:
    """``(T, B, S)`` α: kernel K1 for CUDA tensors, `alpha_reference` for CPU tensors.
    Takes fp32 ``log_probs``, int32 ``lengths``/``extended``/``s_counts`` and a bool
    ``skip``, contiguous, on one device."""
    if not _route("ctc_alpha", log_probs):
        return alpha_reference(log_probs, lengths, extended, skip, s_counts)
    out = _launch("ctc_alpha", log_probs, lengths, extended, skip, s_counts)
    ctc_alpha.launches += 1
    return out


def ctc_beta(log_probs: torch.Tensor, lengths: torch.Tensor, extended: torch.Tensor,
             skip: torch.Tensor, s_counts: torch.Tensor) -> torch.Tensor:
    """``(T, B, S)`` β: kernel K2 for CUDA tensors, `beta_reference` for CPU tensors.
    Same arguments as `ctc_alpha`; β past a row's length is NEG_INF on the kernel and
    unspecified on the plain version (the gradient masks it)."""
    if not _route("ctc_beta", log_probs):
        return beta_reference(log_probs, lengths, extended, skip, s_counts)
    out = _launch("ctc_beta", log_probs, lengths, extended, skip, s_counts)
    ctc_beta.launches += 1
    return out


ctc_alpha.launches = 0
ctc_beta.launches = 0


def ctc_loss(log_probs: torch.Tensor, logit_lengths: torch.Tensor, labels: torch.Tensor,
             label_lengths: torch.Tensor, blank: int) -> torch.Tensor:
    """Per-example CTC negative log likelihood ``(B,)`` on K1/K2 (CUDA) or the plain
    recursions (CPU). Same contract as `ops/ctc.py::ctc_loss`."""
    check_inputs(log_probs, labels)
    return CtcLoss.apply(log_probs.contiguous(), logit_lengths, labels, label_lengths,
                         blank, ctc_alpha, ctc_beta)


def ctc_loss_from_logits(logits: torch.Tensor, logit_lengths: torch.Tensor,
                         labels: torch.Tensor, label_lengths: torch.Tensor,
                         blank: int) -> torch.Tensor:
    """`ctc_loss` on raw logits: ``log_softmax`` in front."""
    return ctc_loss(torch.log_softmax(logits, dim=-1), logit_lengths, labels,
                    label_lengths, blank)
