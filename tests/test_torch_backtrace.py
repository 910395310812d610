"""The backtrace (`speechless_tpu_torch.ops.beam_common`): the plain `backtrace_tokens`
against a model of the CUDA kernel's decomposition (``csrc/beam_backtrace.cu``), its
(B, n) start form against the repeated-pointers form, and the plain batched beam
(`ops/decode_beam.py`) calling the wrapper `beam_backtrace` on both of its routes.

Nothing compiles the kernel on the CPU, so `segmented_backtrace` below carries out its
launch plan (a cluster of CTAs a row, segments of at most 32 frames, staged in groups
where a CTA's frames do not fit) and its four phases (segment maps composed into a map
per CTA, the chain resolved from CTA to CTA with the counts summed on the way, the
rewalk that writes each char at its final position, the striped fill), and checks that
every output position is written exactly once. Tolerance: every output exact.
"""
import numpy as np
import pytest
import torch

from speechless_tpu_torch.ops import beam_common, decode_beam
from speechless_tpu_torch.ops.beam_common import backtrace_tokens, beam_backtrace

# The kernel's constants (csrc/beam_backtrace.cu).
MAX_CLUSTER, MAX_SEGMENT, STAGE_BYTES = 8, 32, 160 * 1024


def _ceil(a, b):
    return -(-a // b)


def kernel_plan(t_max, lanes):
    """(CTAs a row, frames a CTA, frames a segment, segments staged at once), as the
    kernel's `plan` chooses them."""
    cluster = min(MAX_CLUSTER, _ceil(t_max, MAX_SEGMENT))
    cta_frames = _ceil(t_max, cluster)
    fit = STAGE_BYTES // (8 * lanes)
    if cta_frames <= fit:
        segments = _ceil(cta_frames, MAX_SEGMENT)
        return cluster, cta_frames, _ceil(cta_frames, segments), segments
    segment = min(MAX_SEGMENT, fit)
    return cluster, cta_frames, segment, fit // segment


def _segment_maps(parents, chars, first, end, segment):
    """For each segment of frames [first, end): the lane every exit lane reaches at the
    segment's entry and the chars it emits on the way."""
    maps = []
    for start in range(first, end, segment):
        lane = np.arange(parents.shape[1])
        emitted = np.zeros_like(lane)
        for t in range(min(end, start + segment) - 1, start - 1, -1):
            emitted += chars[t, lane] >= 0
            lane = parents[t, lane]
        maps.append((lane, emitted, start, min(end, start + segment)))
    return maps


def segmented_backtrace(parents, chars, best, counts, max_len):
    """The kernel's decomposition in numpy; same contract as `backtrace_tokens`."""
    batch, t_max, lanes = parents.shape
    starts = best.reshape(batch, -1)
    limits = counts.reshape(batch, -1)
    n = starts.shape[1]
    cluster, cta_frames, segment, group = kernel_plan(t_max, lanes)
    tokens = np.full((batch, n, max_len), -7, np.int64)
    writes = np.zeros((batch, n, max_len), np.int64)
    for b in range(batch):
        frames = [(q * cta_frames, min(t_max, (q + 1) * cta_frames)) for q in range(cluster)]
        assert all(f1 > f0 for f0, f1 in frames)
        groups = [[(f0 + g, min(f1, f0 + g + group * segment))
                   for g in range(0, f1 - f0, group * segment)] for f0, f1 in frames]
        # 1. Each CTA's map, groups from the last to the first.
        cta_maps = []
        for q in range(cluster):
            entry, emitted = np.arange(lanes), np.zeros(lanes, np.int64)
            for first, end in reversed(groups[q]):
                for seg_entry, seg_count, _, _ in reversed(
                        _segment_maps(parents[b], chars[b], first, end, segment)):
                    emitted = emitted + seg_count[entry]
                    entry = seg_entry[entry]
            cta_maps.append((entry, emitted))
        for q in range(cluster):
            for s in range(n):
                # 2. The chain from the last CTA to the first.
                lane, emitted, exit_lane, after = int(starts[b, s]), 0, None, None
                for p in range(cluster - 1, -1, -1):
                    if p == q:
                        exit_lane, after = lane, emitted
                    emitted += int(cta_maps[p][1][lane])
                    lane = int(cta_maps[p][0][lane])
                limit = min(int(limits[b, s]), max_len)
                # 3. The rewalk, groups from the last to the first, each segment from its
                #    resolved exit lane and end position.
                lane, position = exit_lane, emitted - after
                for first, end in reversed(groups[q]):
                    maps = _segment_maps(parents[b], chars[b], first, end, segment)
                    exits = []
                    for seg_entry, seg_count, _, _ in reversed(maps):
                        exits.append((lane, position))
                        position -= int(seg_count[lane])
                        lane = int(seg_entry[lane])
                    for (_, _, seg_first, seg_end), (walk, at) in zip(reversed(maps), exits):
                        for t in range(seg_end - 1, seg_first - 1, -1):
                            c = chars[b, t, walk]
                            if c >= 0:
                                at -= 1
                                if at < limit:
                                    tokens[b, s, at] = c
                                    writes[b, s, at] += 1
                            walk = parents[b, t, walk]
                # 4. This CTA's stripe of the rest.
                stripe = _ceil(max_len, cluster)
                last = chars[b, t_max - 1, starts[b, s]]
                for i in range(q * stripe, min(max_len, (q + 1) * stripe)):
                    if i < min(emitted, int(limits[b, s])):
                        continue
                    fill = i < limits[b, s] and i >= t_max and emitted == t_max
                    tokens[b, s, i] = last if fill else -1
                    writes[b, s, i] += 1
    assert (writes == 1).all(), "a position was written {} times".format(
        sorted(set(writes.ravel()) - {1}))
    return tokens.reshape(best.shape + (max_len,)).astype(np.int32)


def _pointers(seed, batch, t_max, lanes, starts):
    """Seeded pointers (60 % of the chars -1, row 0 emitting on every frame), ``starts``
    final lanes a row, and counts: the emitted count, off by up to 2, 0, and past T."""
    rng = np.random.default_rng(seed)
    parents = rng.integers(0, lanes, (batch, t_max, lanes)).astype(np.int32)
    chars = rng.integers(0, 28, (batch, t_max, lanes)).astype(np.int32)
    chars[1:][rng.random(chars[1:].shape) < 0.6] = -1
    best = rng.integers(0, lanes, (batch, starts)).astype(np.int32)
    emitted = torch.stack([
        (backtrace_tokens(torch.from_numpy(parents), torch.from_numpy(chars),
                          torch.from_numpy(best[:, s]), torch.full((batch,), t_max),
                          t_max)[0] >= 0).sum(-1) for s in range(starts)], 1).numpy()
    counts = emitted + rng.integers(-2, 3, emitted.shape)
    counts[-1, 0], counts[0, -1] = 0, t_max + 3
    return parents, chars, best, np.clip(counts, 0, None).astype(np.int32)


@pytest.mark.parametrize("lanes", [1, 32, 1024])
@pytest.mark.parametrize("t_max", [1, 2, 31, 32, 33, 65, 513])
def test_segmented_model_equals_backtrace_tokens(t_max, lanes):
    """The kernel's decomposition gives `backtrace_tokens`' tokens bitwise, with one start
    and with three, at max_len below and above T."""
    for starts in (1, 3):
        parents, chars, best, counts = _pointers(t_max * 7 + lanes, 2, t_max, lanes, starts)
        if starts == 1:
            best, counts = best[:, 0], counts[:, 0]
        for max_len in (max(1, t_max // 2), t_max + 5):
            want, want_counts = backtrace_tokens(
                *(torch.from_numpy(x) for x in (parents, chars, best, counts)), max_len)
            got = segmented_backtrace(parents, chars, best, counts, max_len)
            np.testing.assert_array_equal(got, want.numpy())
            np.testing.assert_array_equal(want_counts.numpy(), counts)


@pytest.mark.parametrize("t_max,lanes", [(1401, 32), (513, 512), (200, 1000)])
def test_kernel_plan_covers_the_row(t_max, lanes):
    """Every CTA gets frames, a segment holds at most 32, and a CTA stages at most its
    budget at once: at T=1401 (8 CTAs of 176 frames), at the K3 route's widest rows
    (r=512: staged in groups) and at r=1000 (not a power of two)."""
    cluster, cta_frames, segment, group = kernel_plan(t_max, lanes)
    assert (cluster - 1) * cta_frames < t_max <= cluster * cta_frames
    assert segment <= MAX_SEGMENT and group * segment * lanes * 8 <= STAGE_BYTES
    parents, chars, best, counts = _pointers(lanes, 1, t_max, lanes, 2)
    want = backtrace_tokens(*(torch.from_numpy(x) for x in (parents, chars, best, counts)),
                            t_max)[0]
    np.testing.assert_array_equal(segmented_backtrace(parents, chars, best, counts, t_max),
                                  want.numpy())


@pytest.mark.parametrize("max_len", [3, 40, 60])
def test_start_form_equals_repeated_pointers(max_len):
    """(B, n) starts on the row's pointers give the tokens of the pointers repeated n
    times with one start each (the n-best route's former form), bitwise, through the
    plain version and through the wrapper (the plain version on CPU tensors), which
    launches nothing."""
    parents, chars, best, counts = (torch.from_numpy(x) for x in _pointers(5, 3, 40, 6, 4))
    repeated = backtrace_tokens(parents.repeat_interleave(4, 0),
                                chars.repeat_interleave(4, 0), best.reshape(-1),
                                counts.reshape(-1), max_len)
    launches = beam_backtrace.launches
    for backtrace in (backtrace_tokens, beam_backtrace):
        tokens, got_counts = backtrace(parents, chars, best, counts, max_len)
        assert tokens.shape == (3, 4, max_len) and tokens.dtype == torch.int32
        assert torch.equal(tokens.reshape(12, max_len), repeated[0])
        assert torch.equal(got_counts.reshape(-1), repeated[1])
    assert beam_backtrace.launches == launches


@pytest.mark.parametrize("nbest", [0, 3])
def test_plain_beam_backtraces_through_the_wrapper(monkeypatch, nbest):
    """`beam_search_decode` and `beam_search_nbest` call `beam_backtrace` once with the
    (B, T, W) backpointers unrepeated (n-best: (B, n) starts), so CUDA tensors take one
    kernel launch; on the CPU it runs `backtrace_tokens`."""
    calls = []

    def spy(parents, chars, best, counts, max_len):
        calls.append((tuple(parents.shape), tuple(best.shape), tuple(counts.shape)))
        return beam_common.beam_backtrace(parents, chars, best, counts, max_len)

    monkeypatch.setattr(decode_beam, "beam_backtrace", spy)
    rng = np.random.default_rng(3)
    logits = rng.normal(size=(2, 9, 6)) * 3.0
    log_probs = torch.log_softmax(torch.tensor(logits, dtype=torch.float32), -1)
    lengths = torch.tensor([9, 6])
    if nbest:
        tokens, counts, _ = decode_beam.beam_search_nbest(log_probs, lengths, 5, nbest,
                                                          beam_width=4)
        assert tokens.shape == (2, nbest, 256)
        assert calls == [((2, 9, 4), (2, nbest), (2, nbest))]
    else:
        tokens, counts = decode_beam.beam_search_decode(log_probs, lengths, 5, beam_width=4)
        assert calls == [((2, 9, 4), (2,), (2,))]
    assert (counts > 0).any()
