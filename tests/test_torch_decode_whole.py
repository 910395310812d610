"""The port's whole-utterance beam (`speechless_tpu_torch.ops.decode_whole`) against
the JAX package's Pallas kernel K3 (`ops/decode_pallas.py::beam_search_decode_pallas`,
interpret mode on the CPU, as its own tests run it), on the cases of
`tests/test_decode_pallas.py`, plus a loose skip threshold where the fast path changes
the result and the wrapper's routing (`test_torch_ctc.py` holds the kernel's C signature
against `_kernels.SIGNATURES` with every other kernel's).

On the CPU `prefix_beam` runs `prefix_beam_reference`, the plain twin of the CUDA
kernel. Tokens and counts must be exactly equal. Interpret mode compiles each shape
once, about 7 s each, but a 32-lane candidate row (W=4, k=3) takes it about 45 s: that
case is held against the JAX package's XLA beam, which its own
`tests/test_decode_pallas.py` holds equal to the Pallas kernel at that width.
"""
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from speechless_tpu.ops.decode_jax import beam_search_decode_jax
from speechless_tpu.ops.decode_pallas import beam_search_decode_pallas
from speechless_tpu_torch.ops.decode_lm import beam_search_decode_frames, pack_frames
from speechless_tpu_torch.ops.decode_whole import (beam_search_decode_whole, prefix_beam,
                                                   prefix_beam_reference)


def _log_probs(rng, batch, t_max, classes, blank, peaky=1.0):
    logits = rng.randn(batch, t_max, classes).astype(np.float32) * 2
    logits[:, :, blank] += peaky
    return logits - np.log(np.exp(logits).sum(-1, keepdims=True))


def _both(log_probs, lengths, blank, reference=beam_search_decode_pallas, **options):
    """(port, JAX) tokens and counts as numpy arrays."""
    got = beam_search_decode_whole(torch.from_numpy(log_probs), torch.from_numpy(lengths),
                                   blank, **options)
    want = reference(jnp.asarray(log_probs), jnp.asarray(lengths), blank, **options)
    return (got[0].numpy(), got[1].numpy()), (np.asarray(want[0]), np.asarray(want[1]))


def _assert_equal(got, want):
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1], want[1])


@pytest.mark.parametrize("beam_width,prune,reference", [
    pytest.param(4, 3, beam_search_decode_jax, id="4-3"),  # 32 lanes: see the docstring
    pytest.param(8, 5, beam_search_decode_pallas, id="8-5"),
    pytest.param(5, 6, beam_search_decode_pallas, id="5-6")])
def test_tokens_match_the_pallas_kernel(beam_width, prune, reference):
    lp = _log_probs(np.random.RandomState(0), 3, 12, 6, 5)
    _assert_equal(*_both(lp, np.array([12, 7, 1], np.int32), 5, reference,
                         beam_width=beam_width, max_decoded_length=16, prune_classes=prune))


@pytest.mark.parametrize("seed", [1, 4, 6])
def test_wide_beam_duplicate_mass(seed):
    """Distinct live prefixes < W while merges occur (W=16, k=2): the run-start mask
    keeps merged duplicates out of the beam (seeds that flip tokens without it)."""
    lp = _log_probs(np.random.RandomState(seed), 4, 16, 3, 2, peaky=2.0)
    _assert_equal(*_both(lp, np.array([16, 11, 5, 2], np.int32), 2, beam_width=16,
                         max_decoded_length=20, prune_classes=2))


def test_wide_beam_small_alphabet_w25():
    lp = _log_probs(np.random.RandomState(0), 2, 10, 4, 3, peaky=1.5)
    _assert_equal(*_both(lp, np.full(2, 10, np.int32), 3, beam_width=25,
                         max_decoded_length=16, prune_classes=3))


def test_capacity_cap():
    """max_decoded_length bounds the emissions without desyncing the counts."""
    lp = _log_probs(np.random.RandomState(0), 2, 20, 4, 3, peaky=-3.0)  # non-blank heavy
    got, want = _both(lp, np.full(2, 20, np.int32), 3, beam_width=8, max_decoded_length=6,
                      prune_classes=4)
    _assert_equal(got, want)
    tokens, counts = got
    assert (counts <= 6).all() and counts.max() == 6
    for b in range(2):
        assert (tokens[b, :counts[b]] >= 0).all() and (tokens[b, counts[b]:] == -1).all()


def test_merge_repeated_false_contract():
    """'AA<blank>AA' -> 'AA' (the reference's test_ctc_decoders.py semantics)."""
    probs = np.full((1, 5, 2), 1e-6, np.float32)
    probs[0, 0, 0] = probs[0, 1, 0] = 1.0  # A A
    probs[0, 2, 1] = 1.0                   # blank
    probs[0, 3, 0] = probs[0, 4, 0] = 1.0  # A A
    lp = torch.from_numpy(np.log(probs / probs.sum(-1, keepdims=True)))
    tokens, counts = beam_search_decode_whole(lp, torch.tensor([5]), blank=1, beam_width=4,
                                              max_decoded_length=8, prune_classes=2)
    assert int(counts[0]) == 2 and tokens[0, :2].tolist() == [0, 0]


def _confident(rng, every=2):
    logits = rng.randn(2, 12, 5).astype(np.float32)
    logits[:, 1::every, 4] = 20.0  # every other frame extremely blank-confident
    return logits - np.log(np.exp(logits).sum(-1, keepdims=True))


def test_confident_blank_skip_matches_the_exact_search():
    lp = _confident(np.random.RandomState(0))
    lengths = np.full(2, 12, np.int32)
    options = dict(beam_width=6, max_decoded_length=12, prune_classes=4)
    skip, want = _both(lp, lengths, 4, skip_blank_log_prob=math.log(0.999), **options)
    _assert_equal(skip, want)
    exact = beam_search_decode_whole(torch.from_numpy(lp), torch.from_numpy(lengths), 4,
                                     **options)
    _assert_equal(skip, (exact[0].numpy(), exact[1].numpy()))


def test_loose_skip_reproduces_the_approximation():
    """At log(0.5) the fast path drops live extensions: the result differs from the
    exact search, and the port reproduces the JAX kernel's approximate result."""
    lp = _log_probs(np.random.RandomState(0), 4, 20, 5, 4, peaky=2.0)
    lengths = np.array([20, 13, 6, 2], np.int32)
    options = dict(beam_width=8, max_decoded_length=20, prune_classes=4)
    got, want = _both(lp, lengths, 4, skip_blank_log_prob=math.log(0.5), **options)
    _assert_equal(got, want)
    exact = beam_search_decode_whole(torch.from_numpy(lp), torch.from_numpy(lengths), 4,
                                     **options)
    assert not np.array_equal(got[0], exact[0].numpy())


def test_skip_off_equals_the_frame_loop_beam():
    """With skipping off, the whole-utterance beam and the beam-step frame loop are the
    same search (JAX's claim that both no-LM routes agree)."""
    lp = torch.from_numpy(_log_probs(np.random.RandomState(5), 3, 24, 29, 28, peaky=2.0))
    lengths = torch.tensor([24, 9, 17])
    options = dict(beam_width=25, max_decoded_length=24, prune_classes=8)
    whole = beam_search_decode_whole(lp, lengths, 28, **options)
    frames = beam_search_decode_frames(lp, lengths, 28, **options)
    assert torch.equal(whole[0], frames[0]) and torch.equal(whole[1], frames[1])


def test_prefix_beam_runs_the_plain_version_on_cpu_tensors():
    lp = torch.from_numpy(_confident(np.random.RandomState(2)))
    frames, lengths = pack_frames(lp, 4), torch.tensor([12, 5], dtype=torch.int32)
    static = dict(k=4, blank=4, beam_width=6, max_decoded_length=12,
                  skip_blank_log_prob=math.log(0.9))
    launches = prefix_beam.launches
    got = prefix_beam(frames, lengths, **static)
    for g, w in zip(got, prefix_beam_reference(frames, lengths, **static)):
        assert torch.equal(g, w)
    assert prefix_beam.launches == launches  # no kernel on CPU tensors
    parents, chars = got[:2]
    assert parents.shape == chars.shape == (2, 12, 8) and parents.dtype == torch.int32
    # Frames past a row's length pass every beam through.
    assert (parents[1, 5:] == torch.arange(8, dtype=torch.int32)).all()
    assert (chars[1, 5:] == -1).all()
    with pytest.raises(ValueError, match="CPU or CUDA"):
        prefix_beam(frames.to("meta"), lengths.to("meta"), **static)
