"""Word-LM-fused CTC prefix beam search on the hand-written span kernel (port of
`speechless_tpu/ops/decode_pallas_lm.py`).

One frame of the beam is, as in the JAX package:

* **the LM bonuses**: each beam's word bonus from the vocabulary trie and the cuckoo
  n-gram tables (`lm/device_lm.py`, `beam_common.word_bonuses`);
* **the frame step** (`lm_step_reference`): expand W beams into r·(k+1) candidates
  (stay, or extend by one of the frame's top-k classes), merge equal prefixes (keeping
  the min-index representative and carrying the LM score as a rider), and keep the top
  W by -(score + lm);
* **after it**: the ``t < counts`` mask, the trie walk and word-context shift through
  each new beam's parent, and the (parent, emitted char) backpointers (`_advance`).

`lm_span` runs every frame of a span in one launch of the CUDA kernel
``csrc/lm_beam_span.cu`` (the JAX package ran the step in Pallas and the LM between
frames in XLA); `lm_span_reference` is its plain PyTorch version, the loop of `_advance`
over `lm_step_reference`. `lm_step_reference` follows the Pallas network with the same
tie rule (no swap on equal keys) and the same merge order, so it, the kernel and the JAX
kernel agree bit for bit on one device. `lm_step` runs one frame on the single-frame
test entry ``csrc/lm_beam_step.cu`` of the kernel's step; no decode launches it. Each
wrapper runs its kernel for CUDA tensors and its plain version for CPU tensors, and
nothing else.
"""
import functools

import torch

from . import _kernels
from .beam_common import (DEAD_KEY, EMPTY_HASH, HASH_MULTIPLIER, NEG_INF,
                          backtrace_tokens, beam_backtrace, next_pow2, word_bonuses)

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


def expand_candidates(frame, pb, pnb, hsh, last, lens, lm, bonus, *, k: int, blank: int,
                      max_decoded_length: int, space_index: int):
    """The candidates of one beam frame (the first stage of `lm_step_reference`): lane i
    of a row is (parent beam i % r, extension i // r), over ``next_pow2((k + 1) r)``
    lanes. Returns ``(pb, pnb, hash, last, len, lm, alive, index)``, each ``(B, n_pad)``;
    a dead candidate's index is INT32_MAX."""
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
    orig = torch.where(alive, (w_of * (k + 1) + e_of).to(torch.int32), INT32_MAX)
    return cand_pb, cand_pnb, cand_hash, cand_last, cand_len, cand_lm, alive, orig


def lm_step_reference(frame, pb, pnb, hsh, last, lens, lm, bonus, *, k: int, blank: int,
                      beam_width: int, max_decoded_length: int, space_index: int):
    """One beam frame in plain PyTorch. ``frame`` is ``(B, 2k + C)`` (`pack_frames`);
    the state blocks are ``(B, r)`` (pb, pnb, lm, bonus float32; hash, last, len int32).
    Candidate lane i of a row is (parent beam i % r, extension i // r): 0 stays,
    1..k extend with the frame's e-th pruned class (`expand_candidates`). Returns
    ``(pb, pnb, hash, last, len, lm, selected candidate index)``, each ``(B, r)``."""
    batch, r = pb.shape
    cand_pb, cand_pnb, cand_hash, cand_last, cand_len, cand_lm, alive, orig = \
        expand_candidates(frame, pb, pnb, hsh, last, lens, lm, bonus, k=k, blank=blank,
                          max_decoded_length=max_decoded_length, space_index=space_index)
    key = torch.where(alive, cand_hash, DEAD_KEY)

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
    """One beam frame: the single-frame CUDA entry of the span kernel's step for CUDA
    tensors, `lm_step_reference` for CPU tensors. Same contract as `lm_step_reference`;
    ``lm_step.launches`` counts kernel launches. A build or launch failure raises. The
    decoders run `lm_span`; this entry holds the step alone against its plain version
    on states no decode produces."""
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


def lm_span_reference(frames, carry, counts, word_lm, *, k: int, blank: int,
                      beam_width: int, max_decoded_length: int, lm_weight: float,
                      word_count_weight: float, valid_word_count_weight: float,
                      step=lm_step_reference):
    """Every frame of a span in plain PyTorch: `_advance` over ``step`` per frame.

    ``frames`` ``(F, B, 2k + C)`` (`pack_frames`); ``carry`` the leaves of `fresh_carry`
    (pb, pnb, hash, last, len, lm[, trie node, word context]); ``counts`` ``(B,)`` the
    valid frames of each row (frames past it leave the row as it is). Returns ``(carry
    after the span, parents (B, F, r) int32, chars (B, F, r) int32, tail bonus (B, r)
    float32)``; the tail bonus is the word bonus of the final beams (zeros without an
    LM). ``step`` is the one-frame function (`lm_step` runs the per-frame kernel)."""
    static = dict(k=k, blank=blank, beam_width=beam_width,
                  max_decoded_length=max_decoded_length,
                  space_index=word_lm.space_index if word_lm is not None else -2)
    weights = (lm_weight, word_count_weight, valid_word_count_weight)
    counts = counts.to(device=frames.device, dtype=torch.int64)
    parents, chars = [], []
    for t in range(frames.shape[0]):
        carry, (bp_parent, bp_char) = _advance(carry, frames[t], t, counts, step, word_lm,
                                               k, weights, static)
        parents.append(bp_parent)
        chars.append(bp_char)
    pb = carry[0]
    if word_lm is not None:
        tail_bonus, _, _ = word_bonuses(word_lm, carry[6].reshape(-1),
                                        carry[7].reshape(-1, 2), *weights)
        tail_bonus = tail_bonus.reshape(pb.shape).to(torch.float32)
    else:
        tail_bonus = torch.zeros_like(pb)
    return carry, torch.stack(parents, dim=1), torch.stack(chars, dim=1), tail_bonus


def lm_span(frames, carry, counts, word_lm, *, k: int, blank: int, beam_width: int,
            max_decoded_length: int, lm_weight: float, word_count_weight: float,
            valid_word_count_weight: float):
    """Every frame of a span through the custom operator ``speechless::lm_beam_span``
    (`library.py`): one launch of the CUDA span kernel for CUDA tensors,
    `lm_span_reference` for CPU tensors. Same contract as `lm_span_reference`; the carry
    comes back as new tensors. ``lm_span.launches`` counts kernel launches and
    ``lm_span.sorted_frames`` holds the last launch's ``(B,)`` count of frames that took
    the step's sorted network; both are kept by `launch_span`, so a replayed export
    program counts too. A build or launch failure raises, as does a shape the kernel
    refuses."""
    from . import library

    if frames.device.type not in ("cpu", "cuda"):
        raise ValueError("lm_span runs on CPU or CUDA tensors, got {}".format(
            frames.device))
    outputs = library.lm_beam_span(
        frames, list(carry), counts, *library.word_lm_arguments(word_lm), k=k, blank=blank,
        beam_width=beam_width, max_decoded_length=max_decoded_length, lm_weight=lm_weight,
        word_count_weight=word_count_weight,
        valid_word_count_weight=valid_word_count_weight)
    new_carry, (parents, chars, tail_bonus, _) = list(outputs[:-4]), outputs[-4:]
    return new_carry, parents, chars, tail_bonus


def launch_span(frames, carry, counts, word_lm, *, k: int, blank: int, beam_width: int,
                max_decoded_length: int, lm_weight: float, word_count_weight: float,
                valid_word_count_weight: float):
    """One launch of the span kernel on CUDA tensors (the CUDA body of
    ``speechless::lm_beam_span``): `lm_span_reference`'s outputs and the ``(B,)``
    sorted-network frame counts, ``(new carry, parents, chars, tail bonus,
    sorted_frames)``. Counts the launch in ``lm_span.launches``."""
    if frames.device.type != "cuda":
        raise ValueError("the span kernel runs on CUDA tensors, got {}".format(
            frames.device))
    span, batch, width = frames.shape
    r = carry[0].shape[1]
    n_pad = next_pow2((k + 1) * r)
    if n_pad > MAX_LANES:
        raise ValueError("beam step needs {} candidate lanes; the kernel takes at most {} "
                         "(lower beam_width or prune_classes)".format(n_pad, MAX_LANES))
    if span < 1 or width <= 2 * k + blank:
        raise ValueError("lm_span: frames must be (F >= 1, B, 2k + C)")
    leaves = 8 if word_lm is not None else 6
    expected = [(frames, torch.float32, (span, batch, width)),
                (counts, torch.int32, (batch,))] + [
        (leaf, dtype, (batch, r) + ((2,) if i == 7 else ()))
        for i, (leaf, dtype) in enumerate(zip(carry, (torch.float32, torch.float32,
                                                      torch.int32, torch.int32,
                                                      torch.int32, torch.float32,
                                                      torch.int32, torch.int32)))]
    if len(carry) != leaves:
        raise ValueError("lm_span: the carry has {} leaves, want {}".format(len(carry),
                                                                             leaves))
    for tensor, dtype, shape in expected:
        if tensor.device != frames.device or tensor.dtype != dtype \
                or tuple(tensor.shape) != shape or not tensor.is_contiguous():
            raise ValueError("lm_span: expected a contiguous {} tensor of shape {} on {}, "
                             "got {} {} on {}".format(dtype, shape, frames.device,
                                                      tensor.dtype, tuple(tensor.shape),
                                                      tensor.device))
    new_carry = [torch.empty_like(leaf) for leaf in carry]
    parents = torch.empty((batch, span, r), dtype=torch.int32, device=frames.device)
    chars = torch.empty_like(parents)
    tail_bonus = torch.empty((batch, r), dtype=torch.float32, device=frames.device)
    sorted_frames = torch.empty((batch,), dtype=torch.int32, device=frames.device)
    if word_lm is not None:
        tables = [word_lm.trie, word_lm.node_word, word_lm.uni_logp, word_lm.uni_bo,
                  word_lm.bi_k, word_lm.bi_logp, word_lm.bi_bo, word_lm.tri_k,
                  word_lm.tri_logp]
        for table in tables:
            if table.device != frames.device or not table.is_contiguous() \
                    or table.dtype not in (torch.int32, torch.float32):
                raise ValueError("lm_span: the word LM's tables must be contiguous int32 "
                                 "or float32 tensors on {}".format(frames.device))
        pointers = [t.data_ptr() for t in tables]
        lm_ints = (word_lm.trie.shape[1], word_lm.bi_k.shape[0], word_lm.tri_k.shape[0],
                   word_lm.unk_id)
        space_index = word_lm.space_index
        carry_pointers = [t.data_ptr() for t in carry + new_carry]
    else:
        pointers, lm_ints, space_index = [None] * 9, (0, 0, 0, 0), -2
        carry_pointers = ([t.data_ptr() for t in carry] + [None, None]
                          + [t.data_ptr() for t in new_carry] + [None, None])
    with torch.cuda.device(frames.device):
        status = _kernels.function("lm_beam_span")(
            frames.data_ptr(), counts.data_ptr(), *carry_pointers,
            *(t.data_ptr() for t in (parents, chars, tail_bonus, sorted_frames)),
            *pointers, batch, span, width, r, k, n_pad, width - 2 * k, blank, beam_width,
            max_decoded_length, space_index, *lm_ints, lm_weight, word_count_weight,
            valid_word_count_weight, torch.cuda.current_stream().cuda_stream)
    if status != 0:
        raise RuntimeError("lm_beam_span kernel launch failed with CUDA error {} "
                           "(F={}, B={}, r={})".format(status, span, batch, r))
    lm_span.launches += 1
    lm_span.sorted_frames = sorted_frames
    return new_carry, parents, chars, tail_bonus, sorted_frames


lm_span.launches = 0
lm_span.sorted_frames = None


def span_function(step=None):
    """The span function a decoder runs: `lm_span` (the kernel on CUDA) when ``step``
    is None, else `lm_span_reference` over the given one-frame function (the plain
    loop, e.g. ``lm_step_reference`` on CUDA tensors to check the kernel against)."""
    return lm_span if step is None else functools.partial(lm_span_reference, step=step)


def _beam_search(log_probs, lengths, blank, word_lm, beam_width, max_decoded_length,
                 lm_weight, word_count_weight, valid_word_count_weight, prune_classes,
                 step=None):
    """The decode shared by both public entries: one span over every frame, the final
    ranking, the backtrace. ``step`` None runs the span kernel and the
    backtrace kernel (their plain versions on the CPU); a one-frame function runs the
    plain loop over it and the plain backtrace (`span_function`)."""
    batch, _, class_count = log_probs.shape
    device = log_probs.device
    k = min(prune_classes, class_count)
    r = next_pow2(max(beam_width, 8))
    if word_lm is not None:
        word_lm = word_lm.to(device)
    counts = lengths.to(device=device, dtype=torch.int32)
    # Every frame of the bucket: a row stops at its own count (its later backpointers
    # are identities), so no host sync or data-dependent cut is needed to trace this.
    frames = pack_frames(log_probs, k)
    carry, parents, chars, tail_bonus = span_function(step)(
        frames, fresh_carry(batch, r, word_lm, device), counts, word_lm, k=k, blank=blank,
        beam_width=beam_width, max_decoded_length=max_decoded_length, lm_weight=lm_weight,
        word_count_weight=word_count_weight,
        valid_word_count_weight=valid_word_count_weight)
    pb, pnb, _, _, lens, lm = carry[:6]
    final = torch.logaddexp(pb, pnb)
    if word_lm is not None:
        # The trailing unterminated word joins the final ranking.
        final = final + lm + tail_bonus
    best = final.argmax(dim=1)
    backtrace = beam_backtrace if step is None else backtrace_tokens
    return backtrace(parents, chars, best, lens.gather(1, best[:, None])[:, 0],
                     max_decoded_length)


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
