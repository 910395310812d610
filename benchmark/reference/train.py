"""The training cells' check: three steps of the plain reference from the same weights on
the same rows, against the program's first three steps.

Each step is the plain stack (`w2l.forward`), log-softmax and CTC in float64
(``F.ctc_loss``, lengths ``frames // 2`` as the reference model's stride gives them,
infeasible labels scoring 0 as in the port), the batch mean, the backward, and a plain
Adam (b1 0.9, b2 0.999, eps 1e-8, bias-corrected) on the trainable layers.

The numbers compared (each no worse than its limit):

* ``loss_gap``: the largest relative gap of a step's loss;
* ``grad_gap``: of the first gradient (the optimizer's, from its state after one
  step), the largest gap between a leaf's norm in the program and in the reference,
  over the larger of that leaf's reference norm and the median leaf's;
* ``change_gap``: the same of each leaf's change over the three steps;
* ``frozen_moved``: frozen leaves that moved (limit 0).

Leaves whose reference gradient is under a thousandth of the median leaf's are left out
of the gaps: Adam moves them by round-off alone.
"""
import statistics
from typing import List, Optional, Sequence

import torch
import torch.nn.functional as F

from . import w2l as plain

BETAS = (0.9, 0.999)
EPS = 1e-8
QUIET_LEAF = 1e-3  # share of the median leaf's gradient norm below which a leaf is out


def ctc_losses(logits: torch.Tensor, frames: torch.Tensor, labels: torch.Tensor,
               label_counts: torch.Tensor, stride: int) -> torch.Tensor:
    """Per-utterance CTC negative log-likelihood (float64), the blank the last class."""
    log_probs = logits.to(torch.float64).log_softmax(-1)
    lengths = (frames.to(torch.int64) // stride)
    counts = label_counts.to(torch.int64)
    targets = labels.to(torch.int64).clamp(min=0)
    losses = F.ctc_loss(log_probs.transpose(0, 1), targets, lengths, counts,
                        blank=logits.shape[-1] - 1, reduction="none", zero_infinity=False)
    repeats = ((labels[:, 1:] == labels[:, :-1]) & (labels[:, 1:] >= 0)).sum(dim=1)
    return torch.where(counts + repeats <= lengths, losses, torch.zeros_like(losses))


def steps(weights, layers: Sequence[dict], batches, trainable: Sequence[bool],
          learning_rate: float, precision: str = "fp32") -> dict:
    """Three (or ``len(batches)``) reference steps: losses, the first gradient and the
    parameters after the last step, each leaf as ``[w, b]`` per layer (None where the
    layer is frozen)."""
    stride = 1
    for layer in layers:
        stride *= layer["stride"]
    params = [[w.detach().clone().requires_grad_(flag), b.detach().clone().requires_grad_(flag)]
              for (w, b), flag in zip(weights, trainable)]
    moments = [[(torch.zeros_like(p), torch.zeros_like(p)) if flag else None for p in pair]
               for pair, flag in zip(params, trainable)]
    losses, first_gradient = [], None
    for step, (features, frames, labels, label_counts) in enumerate(batches, start=1):
        logits = plain.forward([tuple(pair) for pair in params], layers, features, precision)
        loss = ctc_losses(logits, frames, labels, label_counts, stride).mean()
        loss.backward()
        losses.append(float(loss.detach()))
        with torch.no_grad():
            if first_gradient is None:
                first_gradient = [[p.grad.clone() if flag else None for p in pair]
                                  for pair, flag in zip(params, trainable)]
            for pair, pair_moments, flag in zip(params, moments, trainable):
                if not flag:
                    continue
                for p, (m, v) in zip(pair, pair_moments):
                    m.mul_(BETAS[0]).add_(p.grad, alpha=1 - BETAS[0])
                    v.mul_(BETAS[1]).addcmul_(p.grad, p.grad, value=1 - BETAS[1])
                    m_hat = m / (1 - BETAS[0] ** step)
                    v_hat = v / (1 - BETAS[1] ** step)
                    p.sub_(learning_rate * m_hat / (v_hat.sqrt() + EPS))
                    p.grad = None
    return {"losses": losses, "first_gradient": first_gradient,
            "after": [[p.detach() for p in pair] for pair in params]}


def worst_leaf_gap(program: List[Optional[torch.Tensor]],
                   reference: List[torch.Tensor], kept: List[bool]) -> float:
    """The largest |‖program leaf‖ - ‖reference leaf‖| over the larger of the leaf's
    reference norm and the median kept leaf's; a missing program leaf has norm 0."""
    norms = [float(r.norm()) for r in reference]
    median = statistics.median(n for n, keep in zip(norms, kept) if keep)
    worst = 0.0
    for p, r_norm, keep in zip(program, norms, kept):
        if not keep:
            continue
        p_norm = 0.0 if p is None else float(p.norm())
        worst = max(worst, abs(p_norm - r_norm) / max(r_norm, median))
    return worst


def numbers(program: dict, reference: dict, weights, trainable: Sequence[bool]) -> list:
    """The compared numbers of a program run (or a control) against the reference's."""
    flags = [flag for flag in trainable for _ in (0, 1)]
    ref_grad = [g for pair in reference["first_gradient"] for g in pair]
    grad_norms = [float(g.norm()) if flag else 0.0 for g, flag in zip(ref_grad, flags)]
    median = statistics.median(n for n, flag in zip(grad_norms, flags) if flag)
    kept = [flag and n >= QUIET_LEAF * median for n, flag in zip(grad_norms, flags)]
    initial = [p for pair in weights for p in pair]
    prog_grad = [g for pair in program["first_gradient"] for g in pair]
    prog_after = [p for pair in program["after"] for p in pair]
    ref_after = [p for pair in reference["after"] for p in pair]
    prog_change = [a - w for a, w in zip(prog_after, initial)]
    ref_change = [a - w for a, w in zip(ref_after, initial)]
    loss_gap = max(abs(p - r) / abs(r) for p, r in zip(program["losses"],
                                                        reference["losses"]))
    frozen_moved = sum(int(not torch.equal(a, w)) for a, w, flag
                       in zip(prog_after, initial, flags) if not flag)
    return [("loss_gap", loss_gap),
            ("grad_gap", worst_leaf_gap(prog_grad, [g if g is not None else torch.zeros(1)
                                                    for g in ref_grad], kept)),
            ("change_gap", worst_leaf_gap(prog_change, ref_change, kept)),
            ("frozen_moved", frozen_moved)]


def compare(cell, precision: str = "fp32") -> list:
    """The correctness check: the reference's three steps on the cell's check rows against
    the program's, which `drivers/train_resident.py` kept."""
    batches = [(f.to(torch.float32), n, l, c) for f, n, l, c in cell.check_batches]
    reference = steps(cell.weights, cell.layers, batches, cell.trainable,
                      cell.train["learning_rate"], precision)
    program = {"losses": cell.losses, "first_gradient": cell.first_gradient,
               "after": cell.after_check}
    return numbers(program, reference, cell.weights, cell.trainable)


def control(cell, precision: str) -> list:
    """The control: the reference computed in ``precision`` put in the program's place."""
    batches = [(f.to(torch.float32), n, l, c) for f, n, l, c in cell.check_batches]
    args = (cell.weights, cell.layers, batches, cell.trainable, cell.train["learning_rate"])
    return numbers(steps(*args, precision=precision), steps(*args, precision="fp32"),
                   cell.weights, cell.trainable)
