"""CTC loss in plain PyTorch (port of `speechless_tpu/ops/ctc.py`): the CPU path of the
training step and the plain version the CUDA kernels K1/K2 are held against.

Conventions are the JAX package's: blank is the **last** class, labels arrive as a
``-1``-padded ``(batch, U)`` int32 matrix with per-row label and frame lengths, and the
loss is the per-utterance negative log likelihood. Log-space values use the finite
``NEG_INF = -1e30`` instead of ``-inf``, so that an infeasible row's occupancies stay
finite (``(a - 1e30) + 1e30``) and the trainer's feasibility mask zeroes them without
NaNs.

Where `speechless_tpu/ops/ctc.py` (the `lax.scan` recursion) and
`speechless_tpu/ops/ctc_pallas.py` (the TPU kernels) disagree, this module follows the
kernels: each row's α freezes from its length on and the final log-probability is read
from the last α slice, so a zero-length row gets the lse of α_0's last two states
(the scan version returns 1e30). The forward is `forward_reference` (`alpha_reference`,
then `final_log_prob`), the backward `gradient_reference` (`beta_reference`, then
`occupancy_gradient`); `ops/ctc_kernels.py` runs the same contract on the card.
"""
from typing import Callable, Tuple

import torch
import torch.nn.functional as F

from ..precision import ieee_fp32

NEG_INF = -1e30


def _logsumexp2(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    m_safe = torch.clamp(torch.maximum(a, b), min=NEG_INF)
    return m_safe + torch.log(torch.exp(a - m_safe) + torch.exp(b - m_safe))


def _logsumexp3(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    m_safe = torch.clamp(torch.maximum(torch.maximum(a, b), c), min=NEG_INF)
    return m_safe + torch.log(torch.exp(a - m_safe) + torch.exp(b - m_safe)
                              + torch.exp(c - m_safe))


def extended_labels(labels: torch.Tensor, blank: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Interleave blanks: ``(B, U) -> (B, 2U+1)`` int32 states plus the bool skip mask.

    ``extended[2s] = blank``, ``extended[2s+1] = labels[s]`` with ``-1`` padding read as
    the blank. ``skip[s]`` is True where α may jump from ``s-2``: a non-blank state at
    ``s >= 2`` whose label differs from the previous label.
    """
    batch, label_max = labels.shape
    padded = torch.where(labels < 0, torch.full_like(labels, blank), labels).to(torch.int32)
    extended = torch.full((batch, 2 * label_max + 1), blank, dtype=torch.int32,
                          device=labels.device)
    extended[:, 1::2] = padded
    skip = torch.zeros(extended.shape, dtype=torch.bool, device=labels.device)
    skip[:, 3::2] = padded[:, 1:] != padded[:, :-1]
    return extended, skip


def emissions(log_probs: torch.Tensor, extended: torch.Tensor) -> torch.Tensor:
    """``E[b, t, s] = log_probs[b, t, extended[b, s]]``: ``(B, T, C) -> (B, T, S)``."""
    batch, t_max, _ = log_probs.shape
    index = extended.to(torch.int64)[:, None, :].expand(batch, t_max, extended.shape[1])
    return log_probs.gather(2, index)


def _shift_right(x: torch.Tensor, amount: int) -> torch.Tensor:
    """Column ``s`` reads column ``s - amount``; the first ``amount`` become NEG_INF."""
    return F.pad(x, (amount, 0), value=NEG_INF)[:, :x.shape[1]]


def _shift_left(x: torch.Tensor, amount: int) -> torch.Tensor:
    """Column ``s`` reads column ``s + amount``; the last ``amount`` become NEG_INF."""
    return F.pad(x, (0, amount), value=NEG_INF)[:, amount:]


def alpha_reference(log_probs: torch.Tensor, lengths: torch.Tensor, extended: torch.Tensor,
                    skip: torch.Tensor, s_counts: torch.Tensor) -> torch.Tensor:
    """The α recursion (plain version of kernel K1, `ctc_pallas.py::_alpha_kernel`).

    Args:
      log_probs: ``(B, T, C)`` float32 log-probabilities.
      lengths: ``(B,)`` valid frames per row; a row's α freezes from ``t = length`` on.
      extended, skip: `extended_labels` of the ``-1``-padded labels.
      s_counts: ``(B,)`` live states per row, ``2 * label_length + 1``.
    Returns:
      ``(T, B, S)`` float32 α; states ``>= s_counts`` hold NEG_INF.
    """
    emit = emissions(log_probs, extended)
    s_range = torch.arange(extended.shape[1], device=log_probs.device)[None, :]
    live = s_range < s_counts[:, None]
    alpha = torch.where((s_range < 2) & live, emit[:, 0], NEG_INF)
    alphas = [alpha]
    for t in range(1, log_probs.shape[1]):
        skipped = torch.where(skip, _shift_right(alpha, 2), NEG_INF)
        new_alpha = _logsumexp3(alpha, _shift_right(alpha, 1), skipped) + emit[:, t]
        new_alpha = torch.where(live, new_alpha, NEG_INF)
        alpha = torch.where((t < lengths)[:, None], new_alpha, alpha)
        alphas.append(alpha)
    return torch.stack(alphas)


def beta_terminal(s_counts: torch.Tensor, s_count: int) -> torch.Tensor:
    """``(B, S)``: 0 at each row's last two live states, NEG_INF elsewhere."""
    s_range = torch.arange(s_count, device=s_counts.device)[None, :]
    last = s_counts[:, None]
    terminal = (s_range == last - 1) | (s_range == torch.clamp(last - 2, min=0))
    return torch.where(terminal & (s_range < last), 0.0, NEG_INF)


def beta_reference(log_probs: torch.Tensor, lengths: torch.Tensor, extended: torch.Tensor,
                   skip: torch.Tensor, s_counts: torch.Tensor) -> torch.Tensor:
    """The reverse β recursion (plain version of kernel K2, `ctc_pallas.py::_beta_kernel`).

    β_t[s] = lse(β_{t+1}[s] + E_{t+1}[s], β_{t+1}[s+1] + E_{t+1}[s+1],
    skip[s+2] ? β_{t+1}[s+2] + E_{t+1}[s+2]), with the terminal injected at
    ``t = length - 1`` and ``E_T`` read as ``E_{T-1}``. Past a row's length β is not
    meaningful; the gradient masks it. Same arguments as `alpha_reference`.
    """
    emit = emissions(log_probs, extended)
    t_max, s_count = log_probs.shape[1], extended.shape[1]
    s_range = torch.arange(s_count, device=log_probs.device)[None, :]
    live = s_range < s_counts[:, None]
    terminal = beta_terminal(s_counts, s_count)
    skip_from = _shift_left(skip.to(torch.float32), 2) > 0  # skip_from[s] = skip[s+2]
    beta = terminal
    betas = [None] * t_max
    for t in range(t_max - 1, -1, -1):
        scored = beta + emit[:, min(t + 1, t_max - 1)]
        computed = _logsumexp3(scored, _shift_left(scored, 1),
                               torch.where(skip_from, _shift_left(scored, 2), NEG_INF))
        beta = torch.where((t == lengths - 1)[:, None], terminal, computed)
        beta = torch.where(live, beta, NEG_INF)
        betas[t] = beta
    return torch.stack(betas)


def final_log_prob(last_alpha: torch.Tensor, s_counts: torch.Tensor) -> torch.Tensor:
    """``(B,)`` log P(label): lse of the last two live states of the frozen α."""
    index = s_counts.to(torch.int64)[:, None]
    last = last_alpha.gather(1, index - 1)[:, 0]
    second = last_alpha.gather(1, torch.clamp(index - 2, min=0))[:, 0]
    second = torch.where(s_counts >= 2, second, NEG_INF)
    return _logsumexp2(last, second)


def occupancy_gradient(log_probs: torch.Tensor, lengths: torch.Tensor,
                       extended: torch.Tensor, s_counts: torch.Tensor,
                       alphas: torch.Tensor, betas: torch.Tensor, final: torch.Tensor,
                       grad_out: torch.Tensor) -> torch.Tensor:
    """d(loss)/d(log_probs), ``(B, T, C)``: ``-exp(α + β - logZ)`` summed over the states
    of each class, zero past each row's length, times ``grad_out``. The contraction with
    the one-hot labels is one fp32 batched matmul with TF32 off (a fixed summation
    order: no atomics)."""
    batch, t_max, class_count = log_probs.shape
    s_range = torch.arange(extended.shape[1], device=log_probs.device)[None, None, :]
    gamma = alphas + betas - final[None, :, None]
    gamma = torch.where(s_range < s_counts[None, :, None], gamma, NEG_INF)
    classes = torch.arange(class_count, device=log_probs.device, dtype=extended.dtype)
    one_hot = (extended[:, :, None] == classes).to(torch.float32)  # (B, S, C)
    with ieee_fp32():
        occupancy = torch.bmm(torch.exp(gamma).transpose(0, 1), one_hot)  # (B, T, C)
    valid = (torch.arange(t_max, device=log_probs.device)[None, :]
             < lengths[:, None])[:, :, None]
    return torch.where(valid, -occupancy, 0.0) * grad_out[:, None, None]


def forward_reference(log_probs: torch.Tensor, lengths: torch.Tensor,
                      extended: torch.Tensor, skip: torch.Tensor, s_counts: torch.Tensor
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The forward pass in plain PyTorch (plain version of kernel K1): ``(T, B, S)`` α
    from `alpha_reference` and the ``(B,)`` log P(label) from `final_log_prob`."""
    alphas = alpha_reference(log_probs, lengths, extended, skip, s_counts)
    return alphas, final_log_prob(alphas[-1], s_counts)


def gradient_reference(log_probs: torch.Tensor, lengths: torch.Tensor,
                       extended: torch.Tensor, skip: torch.Tensor, s_counts: torch.Tensor,
                       alphas: torch.Tensor, final: torch.Tensor,
                       grad_out: torch.Tensor) -> torch.Tensor:
    """The backward pass in plain PyTorch (plain version of the fused backward kernel,
    `ctc_pallas.py::_beta_kernel` and the XLA contraction after it): `beta_reference`,
    then `occupancy_gradient`. Returns d(loss)/d(log_probs), ``(B, T, C)``."""
    betas = beta_reference(log_probs, lengths, extended, skip, s_counts)
    return occupancy_gradient(log_probs, lengths, extended, s_counts, alphas, betas, final,
                              grad_out)


class CtcLoss(torch.autograd.Function):
    """Per-row CTC NLL with the JAX package's custom gradient. ``forward_fn`` runs the α
    recursion and returns α and log P(label); ``grad_fn`` runs the whole backward (β and
    the occupancy contraction): `forward_reference`/`gradient_reference` here, the
    kernel wrappers in `ops/ctc_kernels.py`."""

    @staticmethod
    def forward(ctx, log_probs, lengths, labels, label_lengths, blank: int,
                forward_fn: Callable, grad_fn: Callable):
        lengths, labels, label_lengths = (
            x.to(device=log_probs.device, dtype=torch.int32)
            for x in (lengths, labels, label_lengths))
        extended, skip = extended_labels(labels, blank)
        s_counts = (2 * label_lengths + 1).to(torch.int32)
        alphas, final = forward_fn(log_probs, lengths, extended, skip, s_counts)
        ctx.save_for_backward(log_probs, lengths, extended, skip, s_counts, alphas, final)
        ctx.gradient_fn = grad_fn
        return -final

    @staticmethod
    def backward(ctx, grad_out):
        log_probs, lengths, extended, skip, s_counts, alphas, final = ctx.saved_tensors
        grads = ctx.gradient_fn(log_probs, lengths, extended, skip, s_counts, alphas, final,
                                grad_out)
        return grads, None, None, None, None, None, None


def check_inputs(log_probs: torch.Tensor, labels: torch.Tensor) -> None:
    if log_probs.dim() != 3 or labels.dim() != 2 or labels.shape[0] != log_probs.shape[0]:
        raise ValueError("ctc_loss takes log_probs (B, T, C) and labels (B, U), got {} and "
                         "{}".format(tuple(log_probs.shape), tuple(labels.shape)))
    if log_probs.shape[1] < 1:
        raise ValueError("ctc_loss needs at least one frame")


def ctc_loss(log_probs: torch.Tensor, logit_lengths: torch.Tensor, labels: torch.Tensor,
             label_lengths: torch.Tensor, blank: int) -> torch.Tensor:
    """Per-example CTC negative log likelihood, ``(B,)`` float32, on the plain
    recursions (any device). Same arguments as the JAX `ctc_loss`."""
    check_inputs(log_probs, labels)
    return CtcLoss.apply(log_probs, logit_lengths, labels, label_lengths, blank,
                         forward_reference, gradient_reference)


def ctc_loss_from_logits(logits: torch.Tensor, logit_lengths: torch.Tensor,
                         labels: torch.Tensor, label_lengths: torch.Tensor,
                         blank: int) -> torch.Tensor:
    """`ctc_loss` on raw logits: ``log_softmax`` in front."""
    return ctc_loss(torch.log_softmax(logits, dim=-1), logit_lengths, labels,
                    label_lengths, blank)
