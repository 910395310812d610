"""The port's beam step (`speechless_tpu_torch.ops.decode_lm.lm_step_reference`,
the plain twin of the CUDA kernel) and its no-LM beam against the JAX package's
Pallas step kernel (`ops/decode_pallas_lm.py`, interpret mode on the CPU).

Tolerances: one step's integer outputs exact and float outputs within rtol/atol 1e-6
(log1p/exp of two libraries); beam tokens and counts exact.
"""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from speechless_tpu.ops import decode_pallas_lm as jax_beam
from speechless_tpu_torch.ops import decode_lm
from speechless_tpu_torch.ops.beam_common import next_pow2

ALPHABET = list("abcdefghijklmnopqrstuvwxyz '")
BLANK = len(ALPHABET)


def _peaky_log_probs(text, peak, rng=None):
    frames = []
    for c in text:
        for symbol in (ALPHABET.index(c), BLANK):
            row = np.zeros(len(ALPHABET) + 1)
            row[symbol] = peak
            frames.append(row)
    logits = np.asarray(frames)
    if rng is not None:
        logits = logits + rng.normal(size=logits.shape) * 1.5
    return logits - np.log(np.exp(logits).sum(axis=1, keepdims=True))


def _batch(texts, seed):
    """Rows alternate peaky and noisy; lengths differ; padding frames are -30."""
    rng = np.random.default_rng(seed)
    rows = [_peaky_log_probs(t, 8.0 if i % 2 == 0 else 3.0, None if i % 2 == 0 else rng)
            for i, t in enumerate(texts)]
    t_max = max(r.shape[0] for r in rows)
    log_probs = np.full((len(rows), t_max, BLANK + 1), -30.0, np.float32)
    for i, r in enumerate(rows):
        log_probs[i, :r.shape[0]] = r
    return log_probs, np.asarray([r.shape[0] for r in rows], np.int32)


LM_TEXTS = ["the cat sat", "a dog ran to the log", "the zzz cat", " the  mat",
            "it's a cat", "dog", "a", "the dog ran to the cat", "the ca", "a log",
            "the mat sat", "cat"]


@pytest.mark.parametrize("width,batch,prune", [(8, 5, 8), (25, 12, 4)])
def test_frames_beam_matches_pallas_frames_beam(width, batch, prune):
    """``prune=4`` at W=25 gives 256 candidate lanes, between the serving 512 and 128."""
    log_probs, lengths = _batch(LM_TEXTS[::-1][:batch], seed=100 + width)
    want = jax_beam.beam_search_decode_pallas_frames(
        jnp.asarray(log_probs), jnp.asarray(lengths), blank=BLANK, beam_width=width,
        max_decoded_length=64, prune_classes=prune)
    got = decode_lm.beam_search_decode_frames(
        torch.from_numpy(log_probs), torch.from_numpy(lengths), BLANK,
        beam_width=width, max_decoded_length=64, prune_classes=prune)
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))


def _random_states(rng, batch, r, k, classes, max_len):
    logits = rng.normal(size=(batch, 1, classes)) * 3
    log_probs = (logits - np.log(np.exp(logits).sum(-1, keepdims=True))).astype(np.float32)
    pb = rng.uniform(-20, 0, (batch, r)).astype(np.float32)
    pnb = rng.uniform(-20, 0, (batch, r)).astype(np.float32)
    dead = rng.random((batch, r)) < 0.3
    pb[dead] = -1e30
    pnb[dead | (rng.random((batch, r)) < 0.2)] = -1e30
    hsh = rng.integers(-2 ** 31, 2 ** 31 - 1, (batch, r)).astype(np.int32)
    hsh[:, 5] = hsh[:, 3]  # duplicate prefixes exercise the merge
    hsh[:, 7] = hsh[:, 3]
    last = rng.integers(-1, classes - 1, (batch, r)).astype(np.int32)
    lens = rng.integers(0, max_len + 1, (batch, r)).astype(np.int32)
    lm = rng.normal(size=(batch, r)).astype(np.float32)
    bonus = rng.normal(size=(batch, r)).astype(np.float32)
    return log_probs, (pb, pnb, hsh, last, lens, lm, bonus)


def test_step_matches_pallas_step_kernel():
    """One frame at the serving shapes (16 rows, r=32, k=8, 29 classes, W=25)."""
    batch, width, k, classes, max_len, space = 16, 25, 8, 29, 40, 26
    r = next_pow2(width)
    n_pad = next_pow2((k + 1) * r)
    log_probs, states = _random_states(np.random.default_rng(0), batch, r, k, classes,
                                       max_len)
    frame = jax_beam._pack_frames(jnp.asarray(log_probs), k, batch)[0]
    step = jax_beam._build_step(batch, r, k, n_pad, classes, classes - 1, width, max_len,
                                space)
    want = step(frame, *states)
    ours = decode_lm.pack_frames(torch.from_numpy(log_probs), k)[0]
    np.testing.assert_array_equal(ours.numpy(), np.asarray(frame)[:, :2 * k + classes])
    got = decode_lm.lm_step_reference(
        ours, *(torch.from_numpy(s) for s in states), k=k, blank=classes - 1,
        beam_width=width, max_decoded_length=max_len, space_index=space)
    for name, g, w in zip("pb pnb hash last len lm idx".split(), got, want):
        w = np.asarray(w)
        assert g.numpy().dtype == w.dtype, name
        if w.dtype == np.int32:
            np.testing.assert_array_equal(g.numpy(), w, err_msg=name)
        else:
            np.testing.assert_allclose(g.numpy(), w, rtol=1e-6, atol=1e-6, err_msg=name)


def test_lm_step_runs_the_plain_step_on_cpu_tensors():
    batch, width, k, classes = 3, 8, 4, 6
    log_probs, states = _random_states(np.random.default_rng(1), batch, 8, k, classes, 9)
    frame = decode_lm.pack_frames(torch.from_numpy(log_probs), k)[0]
    static = dict(k=k, blank=classes - 1, beam_width=width, max_decoded_length=9,
                  space_index=-2)
    states = [torch.from_numpy(s) for s in states]
    launches = decode_lm.lm_step.launches
    for got, want in zip(decode_lm.lm_step(frame, *states, **static),
                         decode_lm.lm_step_reference(frame, *states, **static)):
        assert torch.equal(got, want)
    assert decode_lm.lm_step.launches == launches  # no kernel on CPU tensors
    with pytest.raises(ValueError, match="CPU or CUDA"):
        decode_lm.lm_step(*(t.to("meta") for t in [frame] + states), **static)


def test_pack_frames_breaks_ties_to_the_lower_class():
    log_probs = torch.tensor([[[-1.0, -0.5, -0.5, -2.0, -0.5]]])
    packed = decode_lm.pack_frames(log_probs, 3)
    assert packed.shape == (1, 1, 2 * 3 + 5)
    np.testing.assert_array_equal(packed[0, 0, 3:6].numpy(), [1.0, 2.0, 4.0])


# -- the argument behind the kernel's rank network (csrc/beam_step.cuh) ------------------

def _lae(a, b):
    """torch.logaddexp over flat float32 values, padded to a multiple of 64 lanes so that
    every element takes the same (vectorized) CPU path as the plain step's full rows."""
    count = a.numel()
    width = max(64, -(-count // 64) * 64)
    pad = torch.full((width - count,), -1e30)
    return torch.logaddexp(torch.cat([a, pad]), torch.cat([b, pad]))[:count]


def rank_network_model(frame, *state, k, blank, beam_width, max_decoded_length,
                       space_index):
    """The rank network in plain PyTorch: group the live candidates by hash, merge each
    two-member group into its min-index member with one logaddexp, rank the merged
    prefixes by (-score, index) and keep the first W. Returns the step's seven outputs
    and, per row, whether the exactness branch is needed (a hash with three or more
    live candidates, a pair that disagrees on last character or length, or a live hash
    equal to the dead key)."""
    batch, r = state[0].shape
    c_pb, c_pnb, c_hash, c_last, c_len, c_lm, alive, orig = decode_lm.expand_candidates(
        frame, *state, k=k, blank=blank, max_decoded_length=max_decoded_length,
        space_index=space_index)
    needed = np.zeros(batch, bool)
    groups = []  # per row: lists of the candidate lanes of each live hash
    for row in range(batch):
        by_hash = {}
        for lane in torch.nonzero(alive[row])[:, 0].tolist():
            by_hash.setdefault(int(c_hash[row, lane]), []).append(lane)
        pairs_disagree = any(
            len(g) == 2 and (int(c_last[row, g[0]]) != int(c_last[row, g[1]])
                             or int(c_len[row, g[0]]) != int(c_len[row, g[1]]))
            for g in by_hash.values())
        needed[row] = (max(map(len, by_hash.values()), default=0) > 2 or pairs_disagree
                       or 2 ** 31 - 1 in by_hash)
        groups.append(list(by_hash.values()))
    # Merged masses and scores, each computed once for every group of every row.
    flat = [(row, g) for row in range(batch) for g in groups[row]]
    rows = torch.tensor([row for row, _ in flat], dtype=torch.long)
    first = torch.tensor([g[0] for _, g in flat], dtype=torch.long)
    second = torch.tensor([g[-1] for _, g in flat], dtype=torch.long)
    pair = torch.tensor([len(g) == 2 for _, g in flat])
    rep = torch.where(pair & (orig[rows, second] < orig[rows, first]), second, first)
    m_pb = torch.where(pair, _lae(c_pb[rows, first], c_pb[rows, second]), c_pb[rows, first])
    m_pnb = torch.where(pair, _lae(c_pnb[rows, first], c_pnb[rows, second]),
                        c_pnb[rows, first])
    score = _lae(m_pb, m_pnb) + c_lm[rows, rep]
    out = [np.full((batch, r), v, dtype) for v, dtype in
           ((-1e30, np.float32), (-1e30, np.float32), (0, np.int32), (-1, np.int32),
            (0, np.int32), (0.0, np.float32))]
    out.append(np.tile((np.arange(r) * (k + 1)).astype(np.int32), (batch, 1)))
    for row in range(batch):
        mine = [i for i, (owner, _) in enumerate(flat) if owner == row]
        mine.sort(key=lambda i: (-float(score[i]), int(orig[row, rep[i]])))
        for slot, i in enumerate(mine[:beam_width]):
            lane = int(rep[i])
            values = (m_pb[i], m_pnb[i], c_hash[row, lane], c_last[row, lane],
                      c_len[row, lane], c_lm[row, lane], orig[row, lane])
            for array, value in zip(out, values):
                array[row, slot] = value.item()
    return [torch.from_numpy(a) for a in out], needed


def _decode_states(seed, frames_in):
    """Beam states of a real no-LM decode after ``frames_in`` frames, with seeded LM
    scores and bonuses, and the next packed frame."""
    log_probs, lengths = _batch(LM_TEXTS[:8], seed=seed)
    k, r = 8, 32
    frames = decode_lm.pack_frames(torch.from_numpy(log_probs), k)
    carry, _, _, _ = decode_lm.lm_span_reference(
        frames[:frames_in], decode_lm.fresh_carry(8, r, None, "cpu"),
        torch.from_numpy(lengths), None, k=k, blank=BLANK, beam_width=25,
        max_decoded_length=64, lm_weight=0.0, word_count_weight=0.0,
        valid_word_count_weight=0.0)
    rng = np.random.default_rng(seed)
    lm = torch.from_numpy(rng.normal(size=(8, r)).astype(np.float32))
    bonus = torch.from_numpy(rng.normal(size=(8, r)).astype(np.float32))
    return frames[frames_in], carry[:5] + [lm, bonus]


@pytest.mark.parametrize("frames_in", [3, 9, 17, 30])
def test_rank_network_equals_the_plain_step_on_decode_states(frames_in):
    """On the states of a real decode (distinct live hashes) the two-member merge and
    rank selection give the plain step's outputs bit for bit, without the exactness
    branch, and the frames do merge pairs."""
    frame, state = _decode_states(frames_in, frames_in)
    static = dict(k=8, blank=BLANK, beam_width=25, max_decoded_length=64, space_index=26)
    got, needed = rank_network_model(frame, *state, **static)
    want = decode_lm.lm_step_reference(frame, *state, **static)
    assert not needed.any()
    for name, g, w in zip("pb pnb hash last len lm idx".split(), got, want):
        assert g.dtype == w.dtype and torch.equal(g, w), name
    c_hash, alive = (decode_lm.expand_candidates(frame, *state, k=8, blank=BLANK,
                                                 max_decoded_length=64,
                                                 space_index=26)[i] for i in (2, 6))
    live = [np.unique(c_hash[row][alive[row]].numpy(), return_counts=True)[1]
            for row in range(8)]
    assert any((counts == 2).any() for counts in live)


def test_rank_network_reports_duplicate_live_hashes():
    """Three live beams with one hash (states no decode produces) need the exactness
    branch in every row."""
    k, classes = 8, 29
    log_probs, states = _random_states(np.random.default_rng(5), 16, 32, k, classes, 40)
    states[0][:, [3, 5, 7]] = -1.0  # lanes 3, 5, 7 share a hash: make all three live
    frame = decode_lm.pack_frames(torch.from_numpy(log_probs), k)[0]
    _, needed = rank_network_model(frame, *(torch.from_numpy(s) for s in states), k=k,
                                   blank=classes - 1, beam_width=25,
                                   max_decoded_length=40, space_index=26)
    assert needed.all()
