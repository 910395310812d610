"""CTC forced alignment: which frames say what (port of
`speechless_tpu/ops/forced_align.py`).

Given per-frame grapheme log posteriors and a known transcript, find the most probable
frame-level alignment: the maximum-score path through the transcript's interleaved
blank/label states (blank, l1, blank, l2, ..., blank) under the CTC transitions (stay,
advance, skip a blank between distinct labels). The result is each label's frame span,
which `word_spans_from_alignment` folds into word timestamps.

The JAX package ran it under ``jit`` (a ``lax.scan`` over frames, ``vmap`` over the
batch); XLA compiled it, with no Pallas kernel. Here one frame loop carries the ``(B, S)``
Viterbi scores of the whole batch, the ``(B, T - 1, S)`` moves stay on the scores'
device, and a reverse walk over them gives each frame's state. Everything runs where
``log_probs`` lies.

Ties and edges follow JAX's program exactly:
* the move is the first maximum of ``[stay, advance, skip]`` (``jnp.argmax``): stay wins
  a tie over advance, advance over skip. Ties are common: ``-1e30 + lp`` rounds back to
  ``-1e30``;
* frames at or past a row's length keep its scores and record move 0;
* the path ends in the last label state only when that state's score is strictly
  greater than the final blank's;
* states past ``2 * label_length + 1`` are invalid; padded labels (-1) gather the last
  class, as a negative index does in JAX.
"""
from typing import Tuple

import torch

NEG_INF = -1e30


@torch.no_grad()
def ctc_forced_align(log_probs: torch.Tensor, lengths: torch.Tensor, labels: torch.Tensor,
                     label_lengths: torch.Tensor, blank: int
                     ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Align each utterance's label sequence to its frames.

    ``log_probs`` ``(B, T, C)`` float32 per-frame log posteriors, ``lengths`` ``(B,)``
    valid frames, ``labels`` ``(B, U)`` grapheme indices padded with -1,
    ``label_lengths`` ``(B,)`` valid labels, ``blank`` the blank class. Returns
    ``(starts, ends, scores)`` on ``log_probs``' device: ``(B, U)`` int32 frame spans
    (label k emits over frames ``[starts[b, k], ends[b, k])``, -1 past
    ``label_lengths``) and ``(B,)`` float32 path scores. An infeasible label (more
    labels than the frames can hold) scores <= -1e29; its spans mean nothing and the
    caller must check."""
    device = log_probs.device
    batch, t_max, classes = log_probs.shape
    u_max = labels.shape[1]
    s_max = 2 * u_max + 1
    lengths = torch.as_tensor(lengths, device=device).long()
    labels = torch.as_tensor(labels, device=device).long()
    label_lengths = torch.as_tensor(label_lengths, device=device).long()

    s_range = torch.arange(s_max, device=device)
    is_label = s_range % 2 == 1
    label_at = (labels[:, torch.clamp(s_range // 2, max=u_max - 1)] if u_max
                else torch.full((batch, s_max), blank, device=device))
    state_char = torch.where(is_label[None, :], label_at, blank)          # (B, S)
    valid_state = s_range[None, :] < 2 * label_lengths[:, None] + 1
    # Skip (s-2 -> s) is legal into a label state whose label differs from the label
    # before it (the blank between equal labels is mandatory).
    prev2_char = torch.cat([torch.full((batch, 2), -2, dtype=torch.long, device=device),
                            state_char[:, :-2]], dim=1)
    can_skip = is_label[None, :] & (s_range[None, :] >= 3) & (state_char != prev2_char)
    gather_index = torch.where(state_char < 0, state_char + classes, state_char)
    emissions = log_probs.gather(2, gather_index[:, None, :].expand(batch, t_max, s_max))

    neg_inf = torch.tensor(NEG_INF, dtype=log_probs.dtype, device=device)
    alpha = torch.where((s_range[None, :] <= 1) & valid_state, emissions[:, 0], neg_inf)
    moves = torch.zeros((batch, t_max - 1, s_max), dtype=torch.uint8, device=device)
    one, two = torch.ones((), dtype=torch.uint8, device=device), \
        torch.full((), 2, dtype=torch.uint8, device=device)
    pad1 = neg_inf.expand(batch, 1)
    pad2 = neg_inf.expand(batch, 2)
    for t in range(1, t_max):
        advance = torch.cat([pad1, alpha[:, :-1]], dim=1)
        skip = torch.where(can_skip, torch.cat([pad2, alpha[:, :-2]], dim=1), neg_inf)
        # The first maximum of [stay, advance, skip], as jnp.argmax takes it.
        take_advance = advance > alpha
        best = torch.where(take_advance, advance, alpha)
        take_skip = skip > best
        best = torch.where(take_skip, skip, best)
        move = torch.where(take_skip, two, torch.where(take_advance, one, 0))
        new_alpha = torch.where(valid_state, best + emissions[:, t], neg_inf)
        active = (t < lengths)[:, None]
        alpha = torch.where(active, new_alpha, alpha)
        moves[:, t - 1] = torch.where(active, move, 0)

    rows = torch.arange(batch, device=device)
    last_label = torch.clamp(2 * label_lengths - 1, min=0)
    end_blank = alpha[rows, 2 * label_lengths]
    end_label = torch.where(label_lengths > 0, alpha[rows, last_label], neg_inf)
    state = torch.where(end_label > end_blank, last_label, 2 * label_lengths)
    scores = torch.maximum(end_blank, end_label)

    # The reverse walk: each frame's state from the next frame's state and its move.
    states = torch.empty((batch, t_max), dtype=torch.long, device=device)
    states[:, t_max - 1] = state
    for t in range(t_max - 1, 0, -1):
        state = state - moves[:, t - 1].gather(1, state[:, None])[:, 0].long()
        states[:, t - 1] = state

    # Label k's span is the frames spent in state 2k + 1 (contiguous: a Viterbi path
    # never returns to a state).
    t_range = torch.arange(t_max, device=device)
    in_frame = t_range[None, :] < lengths[:, None]                         # (B, T)
    label_states = 2 * torch.arange(u_max, device=device) + 1
    visited = (states[:, None, :] == label_states[None, :, None]) & in_frame[:, None, :]
    starts = torch.where(visited, t_range, t_max).amin(dim=2)
    ends = torch.where(visited, t_range + 1, 0).amax(dim=2)
    k_valid = (torch.arange(u_max, device=device)[None, :] < label_lengths[:, None]) \
        & (starts < t_max)
    return (torch.where(k_valid, starts, -1).to(torch.int32),
            torch.where(k_valid, ends, -1).to(torch.int32), scores)


def word_spans_from_alignment(codec, tokens, starts, ends, seconds_per_frame: float,
                              sample_rate: int = 16000):
    """Fold one utterance's per-grapheme spans into word timestamps: a word runs from
    its first grapheme's frame start to its last grapheme's frame end; the space
    grapheme separates words. Returns ``[{"word", "start_s", "end_s"}, ...]`` with
    times rounded to the millisecond."""
    words = []
    chars, word_start, word_end = [], 0, 0
    for token, start, end in zip(tokens, starts, ends):
        char = codec.decode_graphemes([int(token)], merge_repeated=False)
        if char == " ":
            if chars:
                words.append({"word": "".join(chars),
                              "start_s": round(word_start * seconds_per_frame, 3),
                              "end_s": round(word_end * seconds_per_frame, 3)})
            chars = []
            continue
        if not chars:
            word_start = int(start)
        chars.append(char)
        word_end = int(end)
    if chars:
        words.append({"word": "".join(chars),
                      "start_s": round(word_start * seconds_per_frame, 3),
                      "end_s": round(word_end * seconds_per_frame, 3)})
    return words
