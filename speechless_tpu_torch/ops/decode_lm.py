"""Word-LM-fused CTC prefix beam search on the hand-written beam-step kernel (port of
`speechless_tpu/ops/decode_pallas_lm.py`).

One frame of the beam is split as in the JAX package:

* **the beam-step kernel** (`lm_step`, CUDA source `csrc/lm_beam_step.cu`) expands W
  beams into r·(k+1) candidates (stay, or extend by one of the frame's top-k classes),
  sorts them by prefix hash with a bitonic network, merges equal prefixes with a
  segmented log-sum-exp (keeping the min-index representative and carrying the LM score
  as a rider), and sorts again on -(score + lm) to keep the top W;
* **torch ops between frames** walk the vocabulary trie, probe the cuckoo n-gram tables
  (`lm/device_lm.py`) and record the (parent, emitted char) backpointers.

`lm_step_reference` is the plain PyTorch version of one step. It follows the same
network with the same tie rule (no swap on equal keys) and the same merge order, so it,
the kernel and the JAX kernel agree bit for bit on one device. `lm_step` runs the kernel
for CUDA tensors and `lm_step_reference` for CPU tensors, and nothing else.
"""
import torch

from . import _kernels
from .beam_common import (DEAD_KEY, EMPTY_HASH, HASH_MULTIPLIER, NEG_INF,
                          backtrace_tokens, next_pow2, word_bonuses)

INT32_MAX = 2 ** 31 - 1
MAX_LANES = 1024  # candidate lanes per row: one CUDA thread each


def pack_frames(log_probs: torch.Tensor, k: int) -> torch.Tensor:
    """``(B, T, C)`` log posteriors -> ``(T, B, 2k + C)`` frame rows: the top-k scores,
    their class ids (as floats) and the full class row. Ties rank the lower class index
    first, as XLA's ``top_k`` does."""
    log_probs = log_probs.to(torch.float32)
    scores, classes = torch.sort(log_probs, dim=-1, descending=True, stable=True)
    packed = torch.cat([scores[..., :k], classes[..., :k].to(torch.float32), log_probs],
                       dim=-1)
    return packed.transpose(0, 1).contiguous()


def fresh_carry(batch: int, r: int, word_lm, device) -> list:
    """The beam state at stream start: one live empty prefix per row (lane 0,
    log P(blank) = 0, EMPTY_HASH), everything else dead."""
    pb = torch.full((batch, r), NEG_INF, device=device)
    pb[:, 0] = 0.0
    hsh = torch.zeros((batch, r), dtype=torch.int32, device=device)
    hsh[:, 0] = EMPTY_HASH
    carry = [pb,
             torch.full((batch, r), NEG_INF, device=device),                    # pnb
             hsh,
             torch.full((batch, r), -1, dtype=torch.int32, device=device),      # last
             torch.zeros((batch, r), dtype=torch.int32, device=device),         # len
             torch.zeros((batch, r), device=device)]                            # lm
    if word_lm is not None:
        carry += [torch.zeros((batch, r), dtype=torch.int32, device=device),    # trie node
                  torch.full((batch, r, 2), word_lm.bos_id, dtype=torch.int32,
                             device=device)]                                    # word ctx
    return carry


def _bitonic_permutation(keys: torch.Tensor, secondary: torch.Tensor = None) -> torch.Tensor:
    """Row-wise bitonic sort, ascending by ``keys`` then ``secondary``: the XOR-partner
    compare-exchange network, no swap on equal keys. Returns the permutation, so that
    ``payload.gather(1, perm)`` is what carrying the payload through the network gives."""
    batch, n = keys.shape
    lane = torch.arange(n, device=keys.device)
    perm = lane.expand(batch, n)
    size = 2
    while size <= n:
        ascending = (lane & size) == 0
        stride = size // 2
        while stride:
            partner = lane ^ stride
            upper = (lane & stride) != 0
            partner_key = keys[:, partner]
            greater = keys > partner_key
            less = keys < partner_key
            if secondary is not None:
                partner_secondary = secondary[:, partner]
                equal = keys == partner_key
                greater = greater | (equal & (secondary > partner_secondary))
                less = less | (equal & (secondary < partner_secondary))
            take = torch.where(ascending, torch.where(upper, less, greater),
                               torch.where(upper, greater, less))
            keys = torch.where(take, partner_key, keys)
            if secondary is not None:
                secondary = torch.where(take, partner_secondary, secondary)
            perm = torch.where(take, perm[:, partner], perm)
            stride //= 2
        size *= 2
    return perm


def _shift_left(x: torch.Tensor, shift: int, fill) -> torch.Tensor:
    """``y[:, i] = x[:, i + shift]``, ``fill`` past the end."""
    return torch.cat([x[:, shift:], torch.full_like(x[:, :shift], fill)], dim=1)


def _segmented_merge(keys, pb, pnb, idx, rider):
    """Hillis–Steele suffix log-sum-exp within runs of equal keys: each run start ends
    up with the run's total masses, its minimum ``idx`` and that candidate's rider."""
    run_start = torch.cat([torch.ones_like(keys[:, :1], dtype=torch.bool),
                           keys[:, 1:] != keys[:, :-1]], dim=1)
    blocked = _shift_left(run_start, 1, True)
    shift = 1
    while shift < keys.shape[1]:
        pb_r = _shift_left(pb, shift, NEG_INF)
        pnb_r = _shift_left(pnb, shift, NEG_INF)
        idx_r = _shift_left(idx, shift, INT32_MAX)
        rider_r = _shift_left(rider, shift, 0.0)
        blocked_r = _shift_left(blocked, shift, True)
        open_window = ~blocked
        pb = torch.where(open_window, torch.logaddexp(pb, pb_r), pb)
        pnb = torch.where(open_window, torch.logaddexp(pnb, pnb_r), pnb)
        rider = torch.where(open_window & (idx_r < idx), rider_r, rider)
        idx = torch.where(open_window, torch.minimum(idx, idx_r), idx)
        blocked = blocked | blocked_r
        shift *= 2
    return run_start, pb, pnb, idx, rider


def lm_step_reference(frame, pb, pnb, hsh, last, lens, lm, bonus, *, k: int, blank: int,
                      beam_width: int, max_decoded_length: int, space_index: int):
    """One beam frame in plain PyTorch. ``frame`` is ``(B, 2k + C)`` (`pack_frames`);
    the state blocks are ``(B, r)`` (pb, pnb, lm, bonus float32; hash, last, len int32).
    Candidate lane i of a row is (parent beam i % r, extension i // r): 0 stays,
    1..k extend with the frame's e-th pruned class. Returns ``(pb, pnb, hash, last,
    len, lm, selected candidate index)``, each ``(B, r)``."""
    batch, r = pb.shape
    class_count = frame.shape[1] - 2 * k
    n_pad = next_pow2((k + 1) * r)
    lane = torch.arange(n_pad, device=pb.device)
    w_of = lane % r
    e_of = lane // r
    live = e_of <= k

    total = torch.logaddexp(pb, pnb)
    valid = total > NEG_INF / 2
    lp_blank = frame[:, 2 * k + blank: 2 * k + blank + 1]
    known = (last >= 0) & (last < class_count)
    lp_last = torch.where(
        known, frame.gather(1, (2 * k + last.clamp(0, class_count - 1)).long()), NEG_INF)

    def expand(state, fill):
        return torch.where(live, state[:, w_of], fill)

    c_pb, c_pnb, c_total = expand(pb, NEG_INF), expand(pnb, NEG_INF), expand(total, NEG_INF)
    c_valid = live & valid[:, w_of]
    c_hash, c_last, c_len = expand(hsh, 0), expand(last, -1), expand(lens, 0)
    c_lplast, c_lm, c_bonus = expand(lp_last, NEG_INF), expand(lm, 0.0), expand(bonus, 0.0)

    extends = (e_of >= 1) & live
    slot = (e_of - 1).clamp(0, k - 1)
    ext_score = torch.where(extends, frame[:, slot], NEG_INF)
    ext_char = torch.where(extends, frame[:, k + slot].to(torch.int32), -1)

    is_stay = e_of == 0
    stay_pb = torch.where(c_valid, c_total + lp_blank, NEG_INF)
    stay_pnb = torch.where(c_valid & (c_last >= 0), c_pnb + c_lplast, NEG_INF)
    ext_base = torch.where(ext_char == c_last, c_pb, c_total)
    ext_ok = c_valid & (ext_char >= 0) & (ext_char != blank) & (c_len < max_decoded_length)
    ext_pnb = torch.where(ext_ok, ext_base + ext_score, NEG_INF)
    # int32 wraparound of hash * HASH_MULTIPLIER + (char + 2), computed in int64.
    ext_hash = (c_hash.to(torch.int64) * HASH_MULTIPLIER + (ext_char + 2)) & 0xFFFFFFFF
    ext_hash = torch.where(ext_hash > INT32_MAX, ext_hash - 2 ** 32, ext_hash)

    cand_pb = torch.where(is_stay, stay_pb, NEG_INF)
    cand_pnb = torch.where(is_stay, stay_pnb, ext_pnb)
    cand_hash = torch.where(is_stay, c_hash, ext_hash.to(torch.int32))
    cand_last = torch.where(is_stay, c_last, ext_char)
    cand_len = torch.where(is_stay, c_len, (c_len + 1).clamp(max=max_decoded_length))
    cand_lm = torch.where(is_stay | (ext_char != space_index), c_lm, c_lm + c_bonus)
    alive = torch.logaddexp(cand_pb, cand_pnb) > NEG_INF / 2
    key = torch.where(alive, cand_hash, DEAD_KEY)
    orig = torch.where(alive, (w_of * (k + 1) + e_of).to(torch.int32), INT32_MAX)

    perm = _bitonic_permutation(key)
    key = key.gather(1, perm)
    s_pb, s_pnb, s_orig, s_last, s_len, s_lm = (
        x.gather(1, perm) for x in (cand_pb, cand_pnb, orig, cand_last, cand_len, cand_lm))
    run_start, m_pb, m_pnb, m_idx, m_lm = _segmented_merge(key, s_pb, s_pnb, s_orig, s_lm)
    # Only run starts represent a merged prefix (the others hold partial masses).
    m_pb = torch.where(run_start, m_pb, NEG_INF)
    m_pnb = torch.where(run_start, m_pnb, NEG_INF)
    score = torch.where(run_start & (key != DEAD_KEY),
                        torch.logaddexp(m_pb, m_pnb) + m_lm, NEG_INF)

    top = _bitonic_permutation(-score, secondary=m_idx)[:, :r]
    f_pb, f_pnb, f_key, f_idx, f_last, f_len, f_lm = (
        x.gather(1, top) for x in (m_pb, m_pnb, key, m_idx, s_last, s_len, m_lm))
    lane_r = torch.arange(r, device=pb.device).expand(batch, r)
    in_beam = (lane_r < beam_width) & (torch.logaddexp(f_pb, f_pnb) > NEG_INF / 2)
    return (torch.where(in_beam, f_pb, NEG_INF),
            torch.where(in_beam, f_pnb, NEG_INF),
            torch.where(in_beam, f_key, 0),
            torch.where(in_beam, f_last, -1),
            torch.where(in_beam, f_len, 0),
            torch.where(in_beam, f_lm, 0.0),
            torch.where(in_beam, f_idx, (lane_r * (k + 1)).to(torch.int32)))


def lm_step(frame, pb, pnb, hsh, last, lens, lm, bonus, *, k: int, blank: int,
            beam_width: int, max_decoded_length: int, space_index: int):
    """One beam frame: the CUDA kernel for CUDA tensors, `lm_step_reference` for CPU
    tensors. Same contract as `lm_step_reference`; ``lm_step.launches`` counts kernel
    launches. A build or launch failure raises."""
    static = dict(k=k, blank=blank, beam_width=beam_width,
                  max_decoded_length=max_decoded_length, space_index=space_index)
    if pb.device.type == "cpu":
        return lm_step_reference(frame, pb, pnb, hsh, last, lens, lm, bonus, **static)
    if pb.device.type != "cuda":
        raise ValueError("lm_step runs on CPU or CUDA tensors, got {}".format(pb.device))
    batch, r = pb.shape
    n_pad = next_pow2((k + 1) * r)
    if n_pad > MAX_LANES:
        raise ValueError("beam step needs {} candidate lanes; the kernel takes at most {} "
                         "(lower beam_width or prune_classes)".format(n_pad, MAX_LANES))
    floats, ints = (frame, pb, pnb, lm, bonus), (hsh, last, lens)
    for name, tensor, dtype in ([("float", t, torch.float32) for t in floats]
                                + [("int", t, torch.int32) for t in ints]):
        if tensor.device != pb.device or tensor.dtype != dtype \
                or not tensor.is_contiguous() or tensor.shape[0] != batch:
            raise ValueError("lm_step: every {} input must be a contiguous {} tensor with "
                             "{} rows on {}".format(name, dtype, batch, pb.device))
    if any(t.shape != (batch, r) for t in floats[1:] + ints) \
            or frame.shape[1] <= 2 * k + blank:
        raise ValueError("lm_step: state blocks must be (B, r) and frame rows (B, 2k + C)")
    outputs = (torch.empty_like(pb), torch.empty_like(pnb), torch.empty_like(hsh),
               torch.empty_like(last), torch.empty_like(lens), torch.empty_like(lm),
               torch.empty_like(hsh))
    with torch.cuda.device(pb.device):
        status = _kernels.function("lm_beam_step")(
            *(t.data_ptr() for t in (frame, pb, pnb, hsh, last, lens, lm, bonus) + outputs),
            batch, frame.shape[1], r, k, n_pad, frame.shape[1] - 2 * k, blank, beam_width,
            max_decoded_length, space_index, torch.cuda.current_stream().cuda_stream)
    if status != 0:
        raise RuntimeError("lm_beam_step kernel launch failed with CUDA error {}".format(
            status))
    lm_step.launches += 1
    return outputs


lm_step.launches = 0


def _advance(carry, frame, t, counts, step, word_lm, k, weights, static):
    """One frame around the step: LM bonuses before it; the ``t < counts`` mask, the
    trie walk, the word-context shift and the backpointers after it."""
    pb, pnb, hsh, last, lens, lm = carry[:6]
    batch, r = pb.shape
    if word_lm is not None:
        trie, wctx = carry[6:]
        bonus, _, normalized = word_bonuses(word_lm, trie.reshape(-1),
                                            wctx.reshape(-1, 2), *weights)
        bonus = bonus.reshape(batch, r).to(torch.float32)
        normalized = normalized.reshape(batch, r)
    else:
        bonus = torch.zeros_like(pb)
    npb, npnb, nhsh, nlast, nlen, nlm, idx = step(frame, pb, pnb, hsh, last, lens, lm,
                                                  bonus, **static)
    parent = idx // (k + 1)
    emitted = (idx % (k + 1)) > 0
    active = (t < counts)[:, None]
    new_carry = [torch.where(active, new, old) for new, old in
                 zip((npb, npnb, nhsh, nlast, nlen, nlm), carry[:6])]
    if word_lm is not None:
        ext_char = torch.where(emitted, nlast, -1)
        parent_index = parent.long()
        parent_trie = trie.gather(1, parent_index)
        parent_wctx = wctx.gather(1, parent_index[..., None].expand(-1, -1, 2))
        char = ext_char.clamp(0, word_lm.trie.shape[1] - 1)
        is_space = emitted & (ext_char == word_lm.space_index)
        is_char_ext = emitted & ~is_space
        walked = torch.where(parent_trie < 0, -1,
                             word_lm.trie[parent_trie.clamp(min=0).long(), char.long()])
        ntrie = torch.where(is_char_ext, walked, torch.where(is_space, 0, parent_trie))
        shift = is_space & (parent_trie != 0)  # a word completed: push it into the context
        parent_norm = normalized.gather(1, parent_index)
        nwctx = torch.stack(
            [torch.where(shift, parent_wctx[..., 1], parent_wctx[..., 0]),
             torch.where(shift, parent_norm, parent_wctx[..., 1])], dim=-1)
        new_carry += [torch.where(active, ntrie, trie),
                      torch.where(active[..., None], nwctx, wctx)]
    lane = torch.arange(r, device=pb.device, dtype=parent.dtype).expand(batch, r)
    return new_carry, (torch.where(active, parent, lane),
                       torch.where(active & emitted, nlast, -1))


def _beam_search(log_probs, lengths, blank, word_lm, beam_width, max_decoded_length,
                 lm_weight, word_count_weight, valid_word_count_weight, prune_classes,
                 step=lm_step):
    """The frame loop shared by both public entries (``step`` is the one-frame
    function: `lm_step`, or `lm_step_reference` to check the kernel against on CUDA)."""
    batch, t_max, class_count = log_probs.shape
    device = log_probs.device
    k = min(prune_classes, class_count)
    r = next_pow2(max(beam_width, 8))
    if word_lm is not None:
        word_lm = word_lm.to(device)
    static = dict(k=k, blank=blank, beam_width=beam_width,
                  max_decoded_length=max_decoded_length,
                  space_index=word_lm.space_index if word_lm is not None else -2)
    weights = (lm_weight, word_count_weight, valid_word_count_weight)
    frames = pack_frames(log_probs, k)
    counts = lengths.to(device=device, dtype=torch.int64)
    # Frames past every row's length are exact no-ops: stop at the longest row.
    t_run = max(1, min(t_max, int(counts.max())))
    carry = fresh_carry(batch, r, word_lm, device)
    parents, chars = [], []
    for t in range(t_run):
        carry, (bp_parent, bp_char) = _advance(carry, frames[t], t, counts, step,
                                               word_lm, k, weights, static)
        parents.append(bp_parent)
        chars.append(bp_char)
    pb, pnb, _, _, lens, lm = carry[:6]
    final = torch.logaddexp(pb, pnb)
    if word_lm is not None:
        # The trailing unterminated word joins the final ranking.
        tail_bonus, _, _ = word_bonuses(word_lm, carry[6].reshape(-1),
                                        carry[7].reshape(-1, 2), *weights)
        final = final + lm + tail_bonus.reshape(batch, r)
    best = final.argmax(dim=1)
    return backtrace_tokens(torch.stack(parents, dim=1), torch.stack(chars, dim=1), best,
                            lens.gather(1, best[:, None])[:, 0], max_decoded_length)


def beam_search_decode_lm(log_probs, lengths, blank, word_lm, beam_width=25,
                          max_decoded_length=256, lm_weight=0.8, word_count_weight=0.0,
                          valid_word_count_weight=2.3, prune_classes=8):
    """Batched CTC prefix beam search with WORD-level LM fusion.

    ``log_probs (B, T, C)``, ``lengths (B,)``; ``word_lm`` a `lm.device_lm.DeviceWordLm`.
    Returns ``tokens (B, max_decoded_length) int32`` (-1 padded) and ``counts (B,)``,
    token-identical to `speechless_tpu.ops.decode_pallas_lm.beam_search_decode_pallas_lm`.
    """
    return _beam_search(log_probs, lengths, blank, word_lm, beam_width, max_decoded_length,
                        lm_weight, word_count_weight, valid_word_count_weight, prune_classes)


def beam_search_decode_frames(log_probs, lengths, blank, beam_width=25,
                              max_decoded_length=256, prune_classes=8):
    """The same beam WITHOUT an LM (token-identical to
    `speechless_tpu.ops.decode_pallas_lm.beam_search_decode_pallas_frames`)."""
    return _beam_search(log_probs, lengths, blank, None, beam_width, max_decoded_length,
                        0.0, 0.0, 0.0, prune_classes)
