"""The plain batched CTC prefix beam (port of `speechless_tpu/ops/decode_jax.py`).

It serves every route the kernel beams do not: the char-table LM (``lm_table``),
lexicon-constrained search, unpruned search and n-best lists. It is no Pallas kernel in
the JAX package, so its frame loop stays plain PyTorch on whatever device its tensors
live on; the backtrace is `beam_common.beam_backtrace` (one launch of the backtrace
kernel on CUDA tensors, every n-best start reading its row's pointers). The JAX ``vmap``
over utterances is the leading batch dimension here, its ``lax.scan`` over frames a
Python loop.

* Beams are (rolling prefix hash, log P ending in blank, log P ending in non-blank, last
  char, length) plus the LM registers; each frame expands every beam by the stay case
  and the frame's top-k classes (all classes when unpruned), merges equal prefixes by
  sorting on the hash and log-sum-exp-ing each run, and keeps the top W.
* Hashes are the JAX package's uint32, kept in int64 and masked to 32 bits. Dead
  candidates get hash 0, which sorts FIRST (unlike the kernels' signed int32 with the
  dead key last).
* Ties follow JAX: sorts are stable and ``top_k`` ranks equal scores to the lower index,
  so every ranking here is a stable descending sort.
* JAX clamps out-of-range gathers (an empty segment's representative is INT32_MAX); the
  gathers here clamp explicitly.
* The segment sums run as a segmented scan over the sorted runs (no atomics), so the
  merge is deterministic on the card.
"""
import math
from typing import NamedTuple, Optional, Tuple

import torch

from ..lm.char_ngram import advance_context
from .beam_common import NEG_INF, beam_backtrace, word_bonuses
from .decode_lm import _shift_left

INT32_MAX = 2 ** 31 - 1
HASH_MULTIPLIER = 0x01000193  # FNV-ish, uint32 arithmetic
EMPTY_HASH = 0x811C9DC5
_UINT32 = 0xFFFFFFFF
LN_10 = 2.302585093


class BeamState(NamedTuple):
    """The beam's carry, every field ``(B, W)`` (``word_ctx`` ``(B, W, 2)``); hashes
    hold uint32 values in int64, the other integer fields are int64."""
    lengths: torch.Tensor
    last_chars: torch.Tensor
    hashes: torch.Tensor
    p_b: torch.Tensor
    p_nb: torch.Tensor
    contexts: torch.Tensor
    lm_scores: torch.Tensor
    trie_nodes: torch.Tensor
    word_ctx: torch.Tensor


def lm_table_geometry(lm_table) -> tuple:
    """``(base, order)`` of a packed char-LM context table (`lm/char_ngram.py` layout:
    (base+1)**(order-1) context rows x base next-char columns)."""
    if lm_table is None:
        return 0, 2
    base = lm_table.shape[1]
    return base, round(math.log(lm_table.shape[0]) / math.log(base + 1)) + 1


def initial_beam_state(batch: int, beam_width: int, device, lm_table=None,
                       bos: int = 0) -> BeamState:
    """One live empty prefix per row (log P(blank) = 0), the rest dead. Char-LM contexts
    start at the all-BOS row (the table's last); word-LM registers at the trie root with
    context (BOS, BOS)."""
    shape = (batch, beam_width)
    live = torch.arange(beam_width, device=device).expand(shape) == 0

    def ints(value):
        return torch.full(shape, value, dtype=torch.int64, device=device)

    return BeamState(
        lengths=ints(0), last_chars=ints(-1),
        hashes=torch.where(live, EMPTY_HASH, 0),
        p_b=torch.where(live, 0.0, NEG_INF).to(torch.float32),
        p_nb=torch.full(shape, NEG_INF, device=device),
        contexts=ints(lm_table.shape[0] - 1 if lm_table is not None else 0),
        lm_scores=torch.zeros(shape, device=device), trie_nodes=ints(0),
        word_ctx=torch.full(shape + (2,), bos, dtype=torch.int64, device=device))


def _top_classes(log_probs_t: torch.Tensor, prune_classes: Optional[int]):
    """The classes that may extend a prefix this frame: the top ``prune_classes`` (ties
    to the lower class), or every class in order when unpruned."""
    batch, classes = log_probs_t.shape
    if prune_classes is not None and prune_classes < classes:
        scores, chars = torch.sort(log_probs_t, dim=1, descending=True, stable=True)
        return scores[:, :prune_classes], chars[:, :prune_classes]
    chars = torch.arange(classes, device=log_probs_t.device).expand(batch, classes)
    return log_probs_t, chars


def _run_sums(values: torch.Tensor, run_start: torch.Tensor) -> torch.Tensor:
    """Backward Hillis-Steele scan within runs of a sorted row: each run start ends up
    with the sum of its run (``values`` ``(B, n, ...)``, ``run_start`` ``(B, n)``)."""
    extra = (1,) * (values.dim() - 2)
    blocked = _shift_left(run_start, 1, True)
    shift = 1
    while shift < values.shape[1]:
        values = torch.where(blocked.view(blocked.shape + extra), values,
                             values + _shift_left(values, shift, 0.0))
        blocked = blocked | _shift_left(blocked, shift, True)
        shift *= 2
    return values


def _beam_step(state: BeamState, log_probs_t: torch.Tensor, active: torch.Tensor,
               blank: int, max_len: int, lm_table=None, lm_weight: float = 0.0,
               lm_base: int = 0, lm_order: int = 2, word_lm=None,
               word_count_weight: float = 0.0, valid_word_count_weight: float = 0.0,
               prune_classes=None, lexicon_constrained: bool = False):
    """One frame of the prefix beam for every row: ``log_probs_t`` ``(B, C)``,
    ``active`` ``(B,)`` (rows past their length keep their state). Returns the new
    state and the backpointers ``(parent beam, emitted char or -1)``, each ``(B, W)``.

    ``lm_table`` fuses a char n-gram on every extension (log10 scaled to natural log);
    ``word_lm`` fuses the word LM at space boundaries in a separate per-beam LM score
    that joins the ranking; ``lexicon_constrained`` keeps extensions on its trie."""
    (lengths, last, hashes, p_b, p_nb, contexts, lm_scores, trie_nodes,
     word_ctx) = state
    batch, w = p_b.shape
    device = p_b.device
    frame_scores, frame_chars = _top_classes(log_probs_t, prune_classes)
    k = frame_chars.shape[1]
    n = w * (k + 1)
    chars_col = frame_chars[:, None, :]  # (B, 1, k)

    total = torch.logaddexp(p_b, p_nb)
    valid = total > NEG_INF / 2
    # Candidate 0 per beam: the prefix unchanged (emit blank, or repeat the last char).
    stay_pb = torch.where(valid, total + log_probs_t[:, blank:blank + 1], NEG_INF)
    stay_pnb = torch.where(valid & (last >= 0),
                           p_nb + log_probs_t.gather(1, last.clamp(min=0)), NEG_INF)
    # Candidates 1..k: extend with frame_chars[e-1]; never the blank, never at capacity.
    scores_col = frame_scores[:, None, :]
    ext = torch.where(chars_col == last[..., None], p_b[..., None] + scores_col,
                      total[..., None] + scores_col)  # (B, W, k)
    ext = torch.where(valid[..., None] & (chars_col != blank)
                      & (lengths < max_len)[..., None], ext, NEG_INF)
    if word_lm is not None and lexicon_constrained:
        # A char must stay on the vocabulary trie; a space may only end a complete
        # word (or follow a space/BOS, trie node 0).
        node = trie_nodes.clamp(min=0)
        columns = frame_chars.clamp(0, word_lm.trie.shape[1] - 1)
        walked_all = word_lm.trie[node[..., None], columns[:, None, :]]
        walked_all = torch.where((trie_nodes >= 0)[..., None], walked_all, -1)
        word_done = word_lm.node_word[node] >= 0
        allowed = torch.where(chars_col == word_lm.space_index,
                              (word_done | (trie_nodes == 0))[..., None], walked_all >= 0)
        ext = torch.where(allowed, ext, NEG_INF)
    if lm_table is not None:
        # log10 P_lm(c | context), in natural log; classes outside the LM's alphabet
        # get a uniform floor.
        rows = lm_table[contexts]  # (B, W, lm_base)
        picked = rows.gather(2, frame_chars.clamp(max=rows.shape[2] - 1)[:, None, :]
                             .expand(batch, w, k))
        char_lm = torch.where(chars_col < rows.shape[2], picked,
                              -math.log10(max(lm_base, 2)))
        ext = ext + lm_weight * char_lm * LN_10
    ext_hashes = (hashes[..., None] * HASH_MULTIPLIER + (chars_col + 2)) & _UINT32

    # Flatten: candidate i = beam * (k+1) + e, e = 0 stay, e > 0 extend by chars[e-1].
    all_pb = torch.cat([stay_pb[..., None], torch.full_like(ext, NEG_INF)], 2).view(
        batch, n)
    all_pnb = torch.cat([stay_pnb[..., None], ext], 2).view(batch, n)
    all_hashes = torch.cat([hashes[..., None], ext_hashes], 2).view(batch, n)
    if word_lm is not None:
        bonus, _, normalized = word_bonuses(word_lm, trie_nodes.reshape(-1),
                                            word_ctx.reshape(-1, 2), lm_weight,
                                            word_count_weight, valid_word_count_weight)
        bonus = bonus.view(batch, w).to(torch.float32)
        ext_lm = torch.where(chars_col == word_lm.space_index, bonus[..., None], 0.0)
        all_lm = (lm_scores[..., None]
                  + torch.cat([torch.zeros_like(lm_scores[..., None]), ext_lm], 2)
                  ).view(batch, n)
    else:
        all_lm = torch.zeros((batch, n), device=device)
    alive = torch.logaddexp(all_pb, all_pnb) > NEG_INF / 2
    all_hashes = torch.where(alive, all_hashes, 0)

    # Merge equal prefixes: stable sort by hash, then per-run log-sum-exp. Segment s is
    # the s-th run (so segments keep the hash order); segments past the last run are
    # empty, as JAX's fixed-size segment reductions leave them.
    sorted_hashes, order = torch.sort(all_hashes, dim=1, stable=True)
    run_start = torch.ones_like(sorted_hashes, dtype=torch.bool)
    run_start[:, 1:] = sorted_hashes[:, 1:] != sorted_hashes[:, :-1]
    segment_ids = torch.cumsum(run_start, dim=1) - 1
    starts = torch.sort((~run_start).to(torch.uint8), dim=1, stable=True).indices
    in_range = torch.arange(n, device=device) < run_start.sum(dim=1, keepdim=True)
    seg_hash = torch.where(in_range, sorted_hashes.gather(1, starts), 0)
    # The stable sort leaves a run's lowest original index at its start.
    seg_repr = torch.where(in_range, order.gather(1, starts), INT32_MAX)
    masses = torch.stack([all_pb, all_pnb], dim=2).gather(
        1, order[..., None].expand(batch, n, 2))
    index = segment_ids[..., None].expand(batch, n, 2)
    maxima = torch.full_like(masses, -math.inf).scatter_reduce(
        1, index, masses, "amax", include_self=False).clamp(min=NEG_INF)
    sums = _run_sums(torch.exp(masses - maxima.gather(1, index)), run_start)
    sums = torch.where(in_range[..., None], sums.gather(1, starts[..., None].expand(
        batch, n, 2)), 0.0)
    merged = torch.where(sums > 0, maxima + torch.log(sums.clamp(min=1e-38)), NEG_INF)
    merged_pb, merged_pnb = merged[..., 0], merged[..., 1]
    merged_total = torch.where(seg_hash > 0, torch.logaddexp(merged_pb, merged_pnb),
                               NEG_INF)

    # The ranking includes the per-prefix word-LM score; acoustic masses stay pure.
    ranked = merged_total + all_lm.gather(1, seg_repr.clamp(max=n - 1))
    top_scores, top_segments = torch.sort(ranked, dim=1, descending=True, stable=True)
    top_scores, top_segments = top_scores[:, :w], top_segments[:, :w]
    top_repr = seg_repr.gather(1, top_segments)
    parent = (top_repr // (k + 1)).clamp(max=w - 1)
    extension = top_repr % (k + 1)  # 0 = stay, e > 0 = extended with frame_chars[e-1]
    ext_char = frame_chars.gather(1, (extension - 1).clamp(min=0))
    new_pb = merged_pb.gather(1, top_segments)
    new_pnb = merged_pnb.gather(1, top_segments)
    new_lm = all_lm.gather(1, top_repr.clamp(max=n - 1))
    new_hashes = torch.where(top_scores > NEG_INF / 2, seg_hash.gather(1, top_segments), 0)

    parent_contexts = contexts.gather(1, parent)
    if lm_table is not None:
        # Out-of-LM-alphabet characters reset to the all-BOS start context.
        extended = torch.where(ext_char < lm_base,
                               advance_context(parent_contexts, ext_char, lm_base,
                                               lm_order), lm_table.shape[0] - 1)
        new_contexts = torch.where(extension > 0, extended, parent_contexts)
    else:
        new_contexts = parent_contexts
    parent_trie = trie_nodes.gather(1, parent)
    parent_wctx = word_ctx.gather(1, parent[..., None].expand(batch, w, 2))
    emitted = extension > 0
    if word_lm is not None:
        char = ext_char.clamp(0, word_lm.trie.shape[1] - 1)
        is_space = emitted & (ext_char == word_lm.space_index)
        walked = torch.where(parent_trie < 0, -1,
                             word_lm.trie[parent_trie.clamp(min=0), char].to(torch.int64))
        new_trie = torch.where(emitted & ~is_space, walked,
                               torch.where(is_space, 0, parent_trie))
        shift = is_space & (parent_trie != 0)  # a word completed: push it into the context
        parent_norm = normalized.view(batch, w).to(torch.int64).gather(1, parent)
        new_word_ctx = torch.stack(
            [torch.where(shift, parent_wctx[..., 1], parent_wctx[..., 0]),
             torch.where(shift, parent_norm, parent_wctx[..., 1])], dim=2)
    else:
        new_trie, new_word_ctx = parent_trie, parent_wctx
    new_last = torch.where(emitted, ext_char, last.gather(1, parent))
    new_lengths = (lengths.gather(1, parent) + emitted).clamp(max=max_len)

    new_state = BeamState(new_lengths, new_last, new_hashes, new_pb, new_pnb,
                          new_contexts, new_lm, new_trie, new_word_ctx)
    rows = active[:, None]
    new_state = BeamState(*(torch.where(rows.view(rows.shape + (1,) * (new.dim() - 2)),
                                        new, old)
                            for new, old in zip(new_state, state)))
    lane = torch.arange(w, device=device).expand(batch, w)
    return new_state, (torch.where(rows, parent, lane),
                       torch.where(rows & emitted, ext_char, -1))


def _beam_search(log_probs, lengths, blank, beam_width, max_decoded_length, lm_table,
                 lm_weight, word_lm, word_count_weight, valid_word_count_weight,
                 prune_classes, lexicon_constrained, nbest=0):
    """The frame loop shared by `beam_search_decode` and `beam_search_nbest`."""
    if word_lm is not None and lm_table is not None:
        raise ValueError("char-table and word-level fusion are mutually exclusive")
    if lexicon_constrained and word_lm is None:
        raise ValueError("lexicon_constrained needs a word_lm (the vocabulary trie)")
    batch, t_max, _ = log_probs.shape
    device = log_probs.device
    log_probs = log_probs.to(torch.float32)
    if word_lm is not None:
        word_lm = word_lm.to(device)
    if lm_table is not None:
        lm_table = torch.as_tensor(lm_table, dtype=torch.float32, device=device)
    lm_base, lm_order = lm_table_geometry(lm_table)
    state = initial_beam_state(batch, beam_width, device, lm_table,
                               word_lm.bos_id if word_lm is not None else 0)
    counts = lengths.to(device=device, dtype=torch.int64)
    weights = (lm_weight, word_count_weight, valid_word_count_weight)
    # Frames past every row's length are exact no-ops: stop at the longest row.
    t_run = max(1, min(t_max, int(counts.max()))) if batch else 1
    parents, chars = [], []
    for t in range(t_run):
        state, (parent, char) = _beam_step(
            state, log_probs[:, t], t < counts, blank, max_decoded_length,
            lm_table=lm_table, lm_weight=lm_weight, lm_base=lm_base, lm_order=lm_order,
            word_lm=word_lm, word_count_weight=word_count_weight,
            valid_word_count_weight=valid_word_count_weight, prune_classes=prune_classes,
            lexicon_constrained=lexicon_constrained)
        parents.append(parent)
        chars.append(char)
    parents, chars = torch.stack(parents, dim=1), torch.stack(chars, dim=1)
    final = torch.logaddexp(state.p_b, state.p_nb) + state.lm_scores
    if word_lm is not None:
        # The trailing unterminated word joins the final ranking.
        tail_bonus, _, _ = word_bonuses(word_lm, state.trie_nodes.reshape(-1),
                                        state.word_ctx.reshape(-1, 2), *weights)
        final = final + tail_bonus.view(batch, beam_width).to(torch.float32)
    if not nbest:
        best = final.argmax(dim=1)
        return beam_backtrace(parents, chars, best,
                              state.lengths.gather(1, best[:, None])[:, 0],
                              max_decoded_length)
    # Live beams are distinct prefixes (the merge collapses equal hashes), so the top n
    # final beams are an honest n-best list; dead ones come back empty.
    top_scores, top_beams = torch.sort(final, dim=1, descending=True, stable=True)
    top_scores, top_beams = top_scores[:, :nbest], top_beams[:, :nbest]
    tokens, token_counts = beam_backtrace(parents, chars, top_beams,
                                          state.lengths.gather(1, top_beams),
                                          max_decoded_length)
    alive = top_scores > NEG_INF / 2
    tokens = torch.where(alive[..., None], tokens, -1)
    token_counts = torch.where(alive, token_counts, 0)
    return tokens.to(torch.int32), token_counts.to(torch.int32), top_scores


def beam_search_decode(log_probs: torch.Tensor, lengths: torch.Tensor, blank: int,
                       beam_width: int = 25, max_decoded_length: int = 256,
                       lm_table=None, lm_weight: float = 0.5, word_lm=None,
                       word_count_weight: float = 0.0,
                       valid_word_count_weight: float = 2.3,
                       prune_classes: Optional[int] = None,
                       lexicon_constrained: bool = False
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Batched CTC prefix beam search with optional LM fusion (token-identical to
    `speechless_tpu.ops.decode_jax.beam_search_decode_jax`).

    ``log_probs (B, T, C)``, ``lengths (B,)``. ``lm_table``: a dense char-LM table
    (`lm/char_ngram.py`) fused with ``lm_weight`` on every extension. ``word_lm``: a
    `lm.device_lm.DeviceWordLm` fused at space boundaries with the three weights;
    exclusive with ``lm_table``. ``prune_classes``: only the k most probable classes
    may extend a prefix per frame (None: every class). ``lexicon_constrained``: with
    ``word_lm``, every emitted word is in its vocabulary. Returns ``tokens (B,
    max_decoded_length) int32`` (-1 padded) and ``counts (B,)``."""
    return _beam_search(log_probs, lengths, blank, beam_width, max_decoded_length,
                        lm_table, lm_weight, word_lm, word_count_weight,
                        valid_word_count_weight, prune_classes, lexicon_constrained)


def beam_search_nbest(log_probs: torch.Tensor, lengths: torch.Tensor, blank: int,
                      nbest: int, beam_width: int = 25, max_decoded_length: int = 256,
                      lm_table=None, lm_weight: float = 0.5, word_lm=None,
                      word_count_weight: float = 0.0,
                      valid_word_count_weight: float = 2.3,
                      prune_classes: Optional[int] = None,
                      lexicon_constrained: bool = False
                      ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The same search returning the top ``nbest`` final beams (equal to
    `speechless_tpu.ops.decode_jax.beam_search_nbest_jax`): ``tokens (B, nbest,
    max_decoded_length)`` (-1 padded), ``counts (B, nbest)`` and ``scores (B, nbest)``,
    the total path score (acoustic + weighted LM), descending. When fewer than
    ``nbest`` prefixes are alive the tail entries are empty (count 0, score ~-1e30)."""
    if not 1 <= nbest <= beam_width:
        raise ValueError("nbest must be in [1, beam_width={}], got {}".format(
            beam_width, nbest))
    return _beam_search(log_probs, lengths, blank, beam_width, max_decoded_length,
                        lm_table, lm_weight, word_lm, word_count_weight,
                        valid_word_count_weight, prune_classes, lexicon_constrained,
                        nbest=nbest)
