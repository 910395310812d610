"""The stitch and ranking of a streaming beam chunk (`speechless_tpu_torch.ops.
decode_incremental_kernel.stitch_reference`, the plain twin of the CUDA kernel
``csrc/stream_stitch.cu``) against the rule of the JAX package's `_pallas_stream_core`
written out lane by lane, the wrapper's routing, the seams of `stream_advance` and the
kernel's C signature. One whole advance, the stitch included, is held against
`_pallas_stream_core` itself in `test_torch_streaming.py`
(`test_one_advance_matches_the_jax_stream_core`).

Tolerances: every output exact (the stitch only moves integers and picks a score).
"""
import re
from pathlib import Path

import numpy as np
import pytest
import torch

from speechless_tpu_torch.ops import _kernels, decode_lm
from speechless_tpu_torch.ops.decode_incremental_kernel import (KernelBeamStreamDecoder,
                                                                stitch_reference,
                                                                stream_stitch)

REPO = Path(__file__).resolve().parent.parent
C, BLANK, W, CF, MAX_LEN = 6, 5, 8, 16, 64  # the shapes of test_streaming_beam_pallas


def _log_probs(frames, seed):
    rng = np.random.RandomState(seed)
    logits = rng.randn(frames, C) * 2.5
    return (logits - np.log(np.exp(logits).sum(-1, keepdims=True))).astype(np.float32)


def _rule(parents, chars, tokens, prev_len, new_len, final):
    """The JAX stitch written out lane by lane: walk back to the ancestor, pack the
    emitted chars in time order, then the row of `_pallas_stream_core` (:148-154)."""
    streams, frames, lanes = parents.shape
    max_len = tokens.shape[2]
    rows = np.zeros_like(tokens)
    for n in range(streams):
        for lane in range(lanes):
            b, path = lane, []
            for t in range(frames - 1, -1, -1):
                path.append(chars[n, t, b])
                b = parents[n, t, b]
            path = path[::-1]
            packed = [c for c in path if c >= 0] + [c for c in path if c < 0]
            entry = prev_len[n, b]
            for j in range(max_len):
                if j >= new_len[n, lane]:
                    rows[n, lane, j] = -1
                elif j < entry:
                    rows[n, lane, j] = tokens[n, b, j]
                else:
                    rows[n, lane, j] = packed[min(max(j - entry, 0), frames - 1)]
    best = final.argmax(axis=1)
    scalars = np.stack([new_len[np.arange(streams), best], final[np.arange(streams), best],
                        new_len.max(axis=1)], axis=1).astype(np.float32)
    return rows, rows[np.arange(streams), best], scalars


@pytest.mark.parametrize("seed", range(4))
def test_stitch_reference_follows_the_rule(seed):
    """Random backpointers with dead lanes, a stream whose every frame emits, a
    zero-count stream (identity backpointers) and lengths up to capacity; score ties
    go to the lowest lane."""
    rng = np.random.default_rng(seed)
    streams, frames, lanes, max_len = 4, 6, 8, 20
    parents = rng.integers(0, lanes, (streams, frames, lanes)).astype(np.int32)
    chars = rng.integers(0, 5, (streams, frames, lanes)).astype(np.int32)
    chars[1:][rng.random((streams - 1, frames, lanes)) < 0.5] = -1
    parents[2], chars[2] = np.arange(lanes), -1
    tokens = rng.integers(0, 5, (streams, lanes, max_len)).astype(np.int32)
    prev_len = rng.integers(0, max_len - frames + 1, (streams, lanes)).astype(np.int32)
    prev_len[3] = max_len - frames
    new_len = rng.integers(0, max_len + 1, (streams, lanes)).astype(np.int32)
    new_len[:, 0] = 0
    final = rng.normal(size=(streams, lanes)).astype(np.float32)
    final[:, 6] = final[:, 2] = final.max(axis=1) + 1.0
    arrays = (parents, chars, tokens, prev_len, new_len, final)
    got = stitch_reference(*(torch.from_numpy(a) for a in arrays))
    for g, w in zip(got, _rule(*arrays)):
        np.testing.assert_array_equal(g.numpy(), w)
    assert got[0].dtype == torch.int32 and got[2].dtype == torch.float32
    np.testing.assert_array_equal(got[2][:, 0].numpy(), new_len[:, 2])


def test_stream_stitch_runs_the_plain_version_on_cpu_tensors():
    rng = np.random.default_rng(9)
    args = (torch.from_numpy(rng.integers(0, 8, (2, 3, 8)).astype(np.int32)),
            torch.full((2, 3, 8), -1, dtype=torch.int32),
            torch.from_numpy(rng.integers(0, 5, (2, 8, 12)).astype(np.int32)),
            torch.zeros((2, 8), dtype=torch.int32), torch.ones((2, 8), dtype=torch.int32),
            torch.from_numpy(rng.normal(size=(2, 8)).astype(np.float32)))
    launches = stream_stitch.launches
    for got, want in zip(stream_stitch(*args), stitch_reference(*args)):
        assert torch.equal(got, want)
    assert stream_stitch.launches == launches  # no kernel on CPU tensors
    with pytest.raises(ValueError, match="CPU or CUDA"):
        stream_stitch(*(a.to("meta") for a in args))


def test_stream_advance_takes_the_given_step_and_stitch():
    """The ``step``/``stitch`` seams the card's checks use to run the plain versions."""
    calls = []

    def stitch(*args):
        calls.append("stitch")
        return stitch_reference(*args)

    def step(*args, **kwargs):
        calls.append("step")
        return decode_lm.lm_step_reference(*args, **kwargs)

    decoder = KernelBeamStreamDecoder(blank=BLANK, beam_width=W, max_decoded_length=MAX_LEN,
                                      chunk_frames=CF, prune_classes=C, step=step,
                                      stitch=stitch, device="cpu")
    _, result = decoder.feed(decoder.init_state(), _log_probs(20, seed=1))
    assert calls.count("step") == 20 and calls.count("stitch") == 2
    plain = KernelBeamStreamDecoder(blank=BLANK, beam_width=W, max_decoded_length=MAX_LEN,
                                    chunk_frames=CF, prune_classes=C, device="cpu")
    assert np.array_equal(plain.feed(plain.init_state(), _log_probs(20, seed=1))[1].tokens,
                          result.tokens)


def test_stitch_entry_point_matches_its_ctypes_signature():
    """`csrc/stream_stitch.cu`'s C entry point takes the pointers and ints, in the
    order, that `_kernels.SIGNATURES` declares (nothing compiles it on the CPU)."""
    source = (REPO / "speechless_tpu_torch" / "csrc" / "stream_stitch.cu").read_text()
    match = re.search(r'extern "C" int stream_stitch\(([^)]*)\)', source)
    params = [p.strip() for p in match.group(1).split(",")]
    kinds = ["ptr" if "*" in p else "int" for p in params]
    assert kinds == ["ptr" if t is _kernels.ctypes.c_void_p else "int"
                     for t in _kernels.SIGNATURES["stream_stitch"]]
    assert [p.split()[-1].lstrip("*") for p in params[:9]] == [
        "parents", "chars", "tokens", "prev_len", "new_len", "final_score", "rows",
        "best_rows", "scalars"]


def kernel_stitch(parents, chars, tokens, prev_len, new_len, final):
    """The CUDA kernel's write order in numpy: its launch plan (one warp a row, at least
    4 and at most 32 warps a CTA), every warp ranking the lanes by a 32-thread butterfly
    before any row is written, lane 0's chase keeping the emitted chars latest first,
    and each row written in 4-word vectors (1-word where max_len is not a multiple of 4)
    with the best lane's warp writing best_rows from the same values. Checks that every
    output word is written exactly once."""
    streams, frames, lanes = parents.shape
    max_len = tokens.shape[2]
    warps = min(32, max(4, -(-lanes // 8)))
    vector = 4 if max_len % 4 == 0 else 1
    rows = np.full(tokens.shape, -7, np.int32)
    best_rows = np.full((streams, max_len), -7, np.int32)
    scalars = np.full((streams, 3), -7.0, np.float32)
    writes = np.zeros(tokens.shape, int)
    best_writes = np.zeros(best_rows.shape, int)

    def ranks_before(a, ia, b, ib):
        if np.isnan(a) != np.isnan(b):
            return bool(np.isnan(a))
        if not np.isnan(a) and a != b:
            return a > b
        return ia < ib

    for n in range(streams):
        for part in range(-(-lanes // warps)):
            for warp in range(warps):
                lane = part * warps + warp
                if lane >= lanes:
                    continue
                held = [(np.float32(-np.inf), 2 ** 31 - 1, 0)] * 32
                for l in range(lanes):
                    score, index, longest = held[l % 32]
                    if ranks_before(final[n, l], l, score, index):
                        score, index = final[n, l], l
                    held[l % 32] = (score, index, max(longest, int(new_len[n, l])))
                for offset in (16, 8, 4, 2, 1):
                    new = []
                    for t in range(32):
                        (score, index, longest), other = held[t], held[t ^ offset]
                        if other[1] != 2 ** 31 - 1 and ranks_before(other[0], other[1],
                                                                    score, index):
                            score, index = other[0], other[1]
                        new.append((score, index, max(longest, other[2])))
                    held = new
                assert len(set((float(s), i, g) for s, i, g in held if s == s)) <= 1
                best_score, best, longest = held[0]
                if part == 0 and warp == 0:
                    scalars[n] = (new_len[n, best], best_score, longest)
                ancestor, latest_first = lane, []
                for t in range(frames - 1, -1, -1):
                    if chars[n, t, ancestor] >= 0:
                        latest_first.append(chars[n, t, ancestor])
                    ancestor = min(max(parents[n, t, ancestor], 0), lanes - 1)
                count, entry, stop = len(latest_first), prev_len[n, ancestor], new_len[n, lane]
                tail = latest_first[0] if count == frames else -1
                for j in range(0, max_len, vector):
                    values = []
                    for i in range(j, j + vector):
                        if i >= stop:
                            values.append(-1)
                        elif i < entry:
                            values.append(tokens[n, ancestor, i])
                        elif i < entry + count:
                            values.append(latest_first[count - 1 - (i - entry)])
                        else:
                            values.append(tail)
                    rows[n, lane, j:j + vector] = values
                    writes[n, lane, j:j + vector] += 1
                    if lane == best:
                        best_rows[n, j:j + vector] = values
                        best_writes[n, j:j + vector] += 1
    assert (writes == 1).all() and (best_writes == 1).all()
    return rows, best_rows, scalars


def _stitch_inputs(seed, streams, frames, lanes, max_len, kind):
    """Seeded stitch inputs of one edge kind; exit lengths are each lane's entry length
    plus its emissions (as the beam step gives), except where the kind says otherwise."""
    rng = np.random.default_rng(seed)
    parents = rng.integers(0, lanes, (streams, frames, lanes)).astype(np.int32)
    chars = rng.integers(0, 28, (streams, frames, lanes)).astype(np.int32)
    if kind != "every_frame_emits":
        chars[rng.random(chars.shape) < 0.6] = -1
    prev_len = rng.integers(0, max(1, max_len - frames + 1), (streams, lanes))
    if kind == "max_len_reached":
        prev_len = max_len - rng.integers(0, 3, (streams, lanes))
    prev_len = prev_len.astype(np.int32)
    tokens = rng.integers(0, 28, (streams, lanes, max_len)).astype(np.int32)
    tokens[np.arange(max_len)[None, None, :] >= prev_len[..., None]] = -1
    lane, emitted = np.tile(np.arange(lanes), (streams, 1)), np.zeros((streams, lanes), int)
    for t in range(frames - 1, -1, -1):
        emitted += np.take_along_axis(chars[:, t], lane, 1) >= 0
        lane = np.take_along_axis(parents[:, t], lane, 1)
    new_len = np.take_along_axis(prev_len, lane, 1) + emitted
    if kind == "exit_below_entry":
        new_len = np.take_along_axis(prev_len, lane, 1) - rng.integers(1, 4, new_len.shape)
    new_len = np.clip(new_len, 0, max_len).astype(np.int32)
    final = rng.normal(-50.0, 10.0, (streams, lanes)).astype(np.float32)
    final[:, lanes // 2] = final[:, lanes - 1] = final.max(axis=1) + 1.0  # a tie
    if kind == "nan_scores":
        final[0, [3, lanes - 2]] = np.nan
        final[1] = np.nan
        final[2, 0] = -np.inf
    return parents, chars, tokens, prev_len, new_len, final


@pytest.mark.parametrize("kind,frames,lanes,max_len", [
    ("serving", 32, 32, 64),
    ("one_frame", 1, 32, 64),
    ("every_frame_emits", 8, 32, 40),
    ("exit_below_entry", 6, 32, 48),
    ("max_len_reached", 6, 32, 48),
    ("nan_scores", 6, 32, 48),
    ("unaligned_max_len", 6, 32, 30),
    ("eight_warps", 5, 64, 24),
    ("widest", 3, 512, 8),
])
def test_kernel_write_order_equals_stitch_reference(kind, frames, lanes, max_len):
    """The kernel's write order gives `stitch_reference`'s rows, best rows and scalars
    bitwise at the edge shapes the card's check holds it to."""
    arrays = _stitch_inputs(len(kind) * 31 + frames, 4, frames, lanes, max_len, kind)
    want = stitch_reference(*(torch.from_numpy(a) for a in arrays))
    for got, expected in zip(kernel_stitch(*arrays), want):
        np.testing.assert_array_equal(got.view(np.int32), expected.numpy().view(np.int32))
