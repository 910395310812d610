"""The ASG (Auto SeGmentation) criterion and its Viterbi decode in plain PyTorch (port of
`speechless_tpu/ops/asg.py`; Collobert et al., arXiv:1609.03193 §2.3):

    loss = logadd over ALL length-T paths (free graph)
         - logadd over the paths that label the utterance (constrained graph)

with per-step scores ``emit[t, c] + trans[c -> c']`` and ``init[c]`` at t = 0. Both graphs
are frame loops of tensor ops on the emissions' device (the JAX package's `lax.scan`s,
which XLA compiled on the TPU; no Pallas kernel is involved), vectorized over (batch,
states): the free graph's step is a (B, C, C) log-matmul, the constrained graph's a stay
and an advance over the label states. Gradients reach the emissions and both tables by
autograd through the loops.

Conventions are the JAX package's:
* the reference's probability tables are column-stochastic ``(C+1, C+1)`` and ``(C+1,)``
  arrays whose index 0 is a pseudo-state (`default_asg_transition_probabilities`); the
  graphs consume ``(C, C)`` / ``(C,)`` log-score tables (`log_score_tables`), with
  ``trans[to, from]``, and zero probabilities become ``NEG_INF``;
* log-space values use the finite ``NEG_INF = -1e30``, never ``-inf``: the logsumexp of
  a dead state stays finite and so does its gradient;
* each row freezes from its frame length on, and its total is read from the frozen
  state after the loop. The JAX scans read it at ``t == length - 1``; the freeze makes
  the two the same values, for rows of 1 to T frames (other rows keep ``NEG_INF`` in
  both);
* a row whose label is empty or longer than its frame count has no alignment and
  scores 0.

No loop reads a value back to the host: every step is queued on the device, and only
the caller fetches the result.
"""
from typing import Optional, Tuple

import numpy as np
import torch

NEG_INF = -1e30


def default_asg_transition_probabilities(grapheme_set_size: int,
                                         seed: int = 0) -> np.ndarray:
    """Random column-stochastic transition table in the reference's layout: ``(C+1,
    C+1)`` float64, row and column 0 zero."""
    rand = np.random.RandomState(seed)
    table = rand.randint(1, 15, (grapheme_set_size + 1, grapheme_set_size + 1)).astype(
        np.float64)
    table[0, :] = 0.0
    table[:, 0] = 0.0
    norms = np.concatenate(([1.0], table[:, 1:].sum(axis=0)))
    return table / norms


def default_asg_initial_probabilities(grapheme_set_size: int, seed: int = 0) -> np.ndarray:
    """Random initial-state distribution in the reference's layout: ``(C+1,)`` float64,
    entry 0 zero."""
    rand = np.random.RandomState(seed)
    initial = rand.randint(1, 15, grapheme_set_size + 1).astype(np.float64)
    initial[0] = 0.0
    return initial / initial.sum()


def _log(x: torch.Tensor) -> torch.Tensor:
    """Elementwise log in fp32 (JAX casts the float64 tables to fp32 first), with
    ``NEG_INF`` where ``x <= 0``."""
    x = x.to(torch.float32)
    return torch.where(x > 0, torch.log(torch.clamp(x, min=torch.finfo(torch.float32).tiny)),
                       NEG_INF)


def log_score_tables(transition_probabilities, initial_probabilities
                     ) -> Tuple[np.ndarray, np.ndarray]:
    """Reference-layout (C+1) probability tables as the ``(C, C)`` / ``(C,)`` fp32
    log-score tables that `asg_loss` consumes directly: the parameterization in which
    the tables are trained."""
    trans = _log(torch.as_tensor(np.asarray(transition_probabilities))[1:, 1:])
    init = _log(torch.as_tensor(np.asarray(initial_probabilities))[1:])
    return trans.numpy(), init.numpy()


def log_tables_on(device, class_count: int, transition_probabilities=None,
                  initial_probabilities=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """The log-score tables of the given probability tables (default: the reference's
    random ones for ``class_count`` classes) as fp32 tensors on ``device``: a fixed-table
    run converts them once, not on every step."""
    if transition_probabilities is None:
        transition_probabilities = default_asg_transition_probabilities(class_count)
    if initial_probabilities is None:
        initial_probabilities = default_asg_initial_probabilities(class_count)
    trans, init = log_score_tables(transition_probabilities, initial_probabilities)
    return torch.from_numpy(trans).to(device), torch.from_numpy(init).to(device)


def _frozen_total(final: torch.Tensor, logit_lengths: torch.Tensor,
                  t_max: int) -> torch.Tensor:
    """``final`` where the row has 1 to ``t_max`` frames, else ``NEG_INF``."""
    return torch.where((logit_lengths >= 1) & (logit_lengths <= t_max), final, NEG_INF)


def _free_graph_logadd(emissions: torch.Tensor, logit_lengths: torch.Tensor,
                       trans_log: torch.Tensor, init_log: torch.Tensor) -> torch.Tensor:
    """logadd over all paths: scores ``(B, T, C) -> (B,)``."""
    t_max = emissions.shape[1]
    active = torch.arange(t_max, device=emissions.device)[:, None] < logit_lengths[None, :]
    score = emissions[:, 0] + init_log[None, :]
    for t in range(1, t_max):
        # (B, C_from) + (C_to, C_from) -> lse over the source class -> (B, C_to)
        new_score = torch.logsumexp(score[:, None, :] + trans_log[None, :, :], dim=2) \
            + emissions[:, t]
        score = torch.where(active[t][:, None], new_score, score)
    return _frozen_total(torch.logsumexp(score, dim=1), logit_lengths, t_max)


def _constrained_graph_logadd(emissions: torch.Tensor, logit_lengths: torch.Tensor,
                              labels: torch.Tensor, label_lengths: torch.Tensor,
                              trans_log: torch.Tensor, init_log: torch.Tensor
                              ) -> torch.Tensor:
    """logadd over the monotone alignments of each row's label sequence: ``-> (B,)``."""
    batch, t_max, _ = emissions.shape
    label_max = labels.shape[1]
    safe_labels = torch.where(labels < 0, 0, labels).to(torch.int64)
    u_range = torch.arange(label_max, device=emissions.device)[None, :]
    # Each state's emission at every frame: (T, B, U).
    state_emissions = emissions.gather(
        2, safe_labels[:, None, :].expand(batch, t_max, label_max)).transpose(0, 1)
    # stay: label[i] -> label[i]; advance: label[i-1] -> label[i]
    stay_trans = trans_log[safe_labels, safe_labels]
    prev_labels = torch.cat([safe_labels[:, :1], safe_labels[:, :-1]], dim=1)
    advance_trans = trans_log[safe_labels, prev_labels]
    state_mask = u_range < label_lengths[:, None]
    active = torch.arange(t_max, device=emissions.device)[:, None] < logit_lengths[None, :]
    alpha = torch.where(u_range == 0,
                        state_emissions[0] + init_log[safe_labels[:, 0]][:, None], NEG_INF)
    alpha = torch.where(state_mask, alpha, NEG_INF)
    dead = torch.full((batch, 1), NEG_INF, dtype=alpha.dtype, device=alpha.device)
    for t in range(1, t_max):
        stay = alpha + stay_trans
        advance = torch.cat([dead, alpha[:, :-1]], dim=1) + advance_trans
        new_alpha = torch.logaddexp(stay, advance) + state_emissions[t]
        new_alpha = torch.where(state_mask, new_alpha, NEG_INF)
        alpha = torch.where(active[t][:, None], new_alpha, alpha)
    final = alpha.gather(1, torch.clamp(label_lengths[:, None].to(torch.int64) - 1, min=0))
    return _frozen_total(final[:, 0], logit_lengths, t_max)


def asg_loss(emissions: torch.Tensor, logit_lengths: torch.Tensor, labels: torch.Tensor,
             label_lengths: torch.Tensor,
             transition_probabilities=None, initial_probabilities=None,
             transition_log_scores: Optional[torch.Tensor] = None,
             initial_log_scores: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Per-example ASG loss, ``(batch,)``.

    ``emissions``: ``(batch, time, classes)`` per-frame scores (the trainer passes
    log-softmax outputs); ``logit_lengths``, ``labels`` (``-1``-padded, coded by
    `AsgGraphemeCodec`: no blank) and ``label_lengths`` as for the CTC loss. The tables
    are either the reference-layout (C+1) probability tables or the ``(C, C)`` /
    ``(C,)`` log-score tables (trainable parameters); absent ones default to the
    reference's random tables. Rows with an empty label or more labels than frames
    score 0."""
    if transition_log_scores is None or initial_log_scores is None:
        trans_log, init_log = log_tables_on(emissions.device, emissions.shape[2],
                                            transition_probabilities, initial_probabilities)
        transition_log_scores = (trans_log if transition_log_scores is None
                                 else transition_log_scores)
        initial_log_scores = init_log if initial_log_scores is None else initial_log_scores
    trans_log = torch.as_tensor(transition_log_scores, device=emissions.device)
    init_log = torch.as_tensor(initial_log_scores, device=emissions.device)
    free = _free_graph_logadd(emissions, logit_lengths, trans_log, init_log)
    constrained = _constrained_graph_logadd(emissions, logit_lengths, labels,
                                            label_lengths, trans_log, init_log)
    feasible = (label_lengths > 0) & (label_lengths <= logit_lengths)
    return torch.where(feasible, free - constrained, 0.0)


def asg_viterbi_decode(emissions: torch.Tensor, logit_lengths: torch.Tensor,
                       transition_log_scores: torch.Tensor,
                       initial_log_scores: torch.Tensor) -> torch.Tensor:
    """The best length-T state path of each row, ``(B, T)`` int64: the argmax over paths
    of ``sum_t emit[t, c_t] + trans[c_t, c_{t-1}]`` (+ ``init[c_0]``). A forward loop
    keeps each state's best score and its best predecessor (the first maximum, as
    `jnp.argmax` picks, over ``delta[:, None, :] + trans[None]`` in the JAX package's
    order of addition), then a reverse walk follows the backpointers. Frames past a
    row's length repeat its final state; a row of one frame takes the argmax at t = 0.
    The codec's repeat-merge turns the path into text."""
    batch, t_max, class_count = emissions.shape
    device = emissions.device
    with torch.no_grad():
        active = torch.arange(t_max, device=device)[:, None] < logit_lengths[None, :]
        identity = torch.arange(class_count, device=device)[None, :].expand(batch,
                                                                           class_count)
        delta = emissions[:, 0] + initial_log_scores[None, :]
        backpointers = []
        for t in range(1, t_max):
            # expanded[b, to, frm] = delta[b, frm] + trans[to, frm]
            best, best_prev = torch.max(delta[:, None, :] + transition_log_scores[None],
                                        dim=2)
            delta = torch.where(active[t][:, None], best + emissions[:, t], delta)
            backpointers.append(torch.where(active[t][:, None], best_prev, identity))
        in_range = (logit_lengths >= 1) & (logit_lengths <= t_max)
        final_state = torch.where(in_range, torch.argmax(delta, dim=1), 0)
        states = [final_state]
        state = final_state
        for t in range(t_max - 1, 0, -1):
            previous = backpointers[t - 1].gather(1, state[:, None])[:, 0]
            state = torch.where(active[t], previous, state)
            states.append(state)
        path = torch.stack(states[::-1], dim=1)
        return torch.where(active.T, path, final_state[:, None])
