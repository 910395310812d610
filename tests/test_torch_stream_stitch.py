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
