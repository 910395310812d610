"""CTC forced alignment in the port (`speechless_tpu_torch/ops/forced_align.py` and
`serving.align_audio`) against the JAX package's `ctc_forced_align`,
`word_spans_from_alignment` and `align_audio` on the same numpy inputs.

Starts and ends are held equal and path scores bitwise: the Viterbi recursion is a max
and one fp32 add a state and frame, in the same order on both sides. Every case of
`test_alignment_matches_jax` has one shape, so JAX compiles its program once.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from speechless_tpu.models import wav2letter as jax_w2l
from speechless_tpu.ops import forced_align as jax_forced_align
from speechless_tpu.serving import Transcriber as JaxTranscriber
from speechless_tpu.serving import align_audio as jax_align_audio
from speechless_tpu_torch.models import wav2letter as w2l
from speechless_tpu_torch.ops.forced_align import (NEG_INF, ctc_forced_align,
                                                   word_spans_from_alignment)
from speechless_tpu_torch.serving import Transcriber, align_audio
from speechless_tpu_torch.text.graphemes import CtcGraphemeCodec

B, T, U, C = 4, 30, 8, 6
BLANK = C - 1


def _log_softmax(x):
    x = x - x.max(axis=-1, keepdims=True)
    return (x - np.log(np.exp(x).sum(axis=-1, keepdims=True))).astype(np.float32)


def _case(name):
    rng = np.random.default_rng(sorted(CASES).index(name))
    log_probs = _log_softmax(rng.normal(0, 2, (B, T, C)))
    lengths = np.full(B, T, np.int32)
    label_lengths = rng.integers(1, U + 1, B).astype(np.int32)
    labels = rng.integers(0, BLANK, (B, U)).astype(np.int32)
    CASES[name](rng, log_probs, lengths, labels, label_lengths)
    for row in range(B):
        labels[row, label_lengths[row]:] = -1
    return log_probs, lengths, labels, label_lengths


def _random(rng, log_probs, lengths, labels, label_lengths):
    lengths[:] = [30, 25, 17, 9]
    label_lengths[:] = [8, 5, 3, 2]


def _ties(rng, log_probs, lengths, labels, label_lengths):
    # Uniform posteriors: every candidate of a state ties, so the move order decides.
    log_probs[:] = np.float32(np.log(1.0 / C))
    lengths[:] = [30, 16, 9, 4]
    label_lengths[:] = [8, 8, 4, 2]


def _repeats(rng, log_probs, lengths, labels, label_lengths):
    # Equal neighbours need the blank between them (no skip).
    labels[0] = [1, 1, 2, 2, 2, 3, 3, 0]
    labels[1] = [4, 4, 4, 4, 4, 4, 4, 4]
    labels[2] = [0, 1, 0, 1, 0, 0, 2, 2]
    labels[3] = [3, 3, 0, 0, 0, 0, 0, 0]
    label_lengths[:] = [8, 8, 8, 2]
    lengths[:] = [30, 15, 20, 3]


def _padding(rng, log_probs, lengths, labels, label_lengths):
    # Frames past each length hold large garbage that must not move the path.
    lengths[:] = [12, 1, 30, 7]
    label_lengths[:] = [4, 1, 6, 3]
    for row, length in enumerate(lengths):
        log_probs[row, length:] = rng.normal(0, 50, (T - length, C)).astype(np.float32)


def _infeasible(rng, log_probs, lengths, labels, label_lengths):
    # Row 0: 8 repeated labels need 15 frames, it has 10; row 1: 6 labels, 5 frames;
    # row 2 needs exactly its frames; row 3 one frame more than it has.
    labels[0] = [2] * 8
    label_lengths[:] = [8, 6, 5, 3]
    lengths[:] = [10, 5, 5, 2]


def _empty(rng, log_probs, lengths, labels, label_lengths):
    label_lengths[:] = [0, 0, 3, 0]
    lengths[:] = [30, 1, 12, 6]


CASES = {"random": _random, "ties": _ties, "repeats": _repeats, "padding": _padding,
         "infeasible": _infeasible, "empty": _empty}


@pytest.mark.parametrize("name", sorted(CASES))
def test_alignment_matches_jax(name):
    log_probs, lengths, labels, label_lengths = _case(name)
    want = [np.asarray(x) for x in jax_forced_align.ctc_forced_align(
        jnp.asarray(log_probs), jnp.asarray(lengths), jnp.asarray(labels),
        jnp.asarray(label_lengths), blank=BLANK)]
    got = [x.numpy() for x in ctc_forced_align(
        torch.from_numpy(log_probs), torch.from_numpy(lengths), torch.from_numpy(labels),
        torch.from_numpy(label_lengths), blank=BLANK)]
    assert got[0].dtype == got[1].dtype == np.int32 and got[2].dtype == np.float32
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1], want[1])
    np.testing.assert_array_equal(got[2], want[2])
    feasible = got[2] > -1e29
    if name == "infeasible":
        assert feasible.tolist() == [False, False, True, False]
    else:
        assert feasible.all()
    if name == "empty":
        assert (got[0][[0, 1, 3]] == -1).all()
    for row in np.flatnonzero(feasible):
        n = label_lengths[row]
        spans = list(zip(got[0][row, :n], got[1][row, :n]))
        assert all(0 <= s < e <= lengths[row] for s, e in spans)
        assert all(e1 <= s2 for (_, e1), (s2, _) in zip(spans, spans[1:]))
    assert NEG_INF == jax_forced_align.NEG_INF


ALPHABET = list("abcdefghijklmnopqrstuvwxyz '")


def test_word_spans_match_jax():
    codec = CtcGraphemeCodec(ALPHABET)
    tokens = codec.encode("the cat  sat")
    rng = np.random.default_rng(5)
    starts = np.cumsum(rng.integers(1, 4, len(tokens)))
    ends = starts + rng.integers(1, 3, len(tokens))
    for spf in (0.016, 0.008):
        got = word_spans_from_alignment(codec, tokens, starts, ends, spf)
        assert got == jax_forced_align.word_spans_from_alignment(codec, tokens, starts,
                                                                 ends, spf)
        assert [w["word"] for w in got] == ["the", "cat", "sat"]


LAYERS = (w2l.ConvSpec("striding_conv", 16, 48, 2),
          w2l.ConvSpec("inner_conv_1", 16, 7, 1),
          w2l.ConvSpec("big_conv_1", 24, 32, 1),
          w2l.ConvSpec("big_conv_2", 24, 1, 1),
          w2l.ConvSpec("output_conv", len(ALPHABET) + 1, 1, 1, "linear"))


def _audio(seconds, seed):
    rng = np.random.default_rng(seed)
    t = np.arange(int(seconds * 16000)) / 16000.0
    tones = sum(0.2 * np.sin(2 * np.pi * f * t) for f in rng.uniform(100, 3000, 3))
    return (tones + 0.05 * rng.normal(size=t.size)).astype(np.float32)


@pytest.fixture(scope="module")
def transcribers():
    config = w2l.Wav2LetterConfig(128, len(ALPHABET) + 1, layers=LAYERS)
    params = w2l.init_params(config, seed=31)
    params[-1]["w"] = params[-1]["w"] * 10.0
    jax_config = jax_w2l.Wav2LetterConfig(128, len(ALPHABET) + 1, layers=tuple(
        jax_w2l.ConvSpec(s.name, s.filters, s.kernel_size, s.stride, s.activation, False)
        for s in LAYERS))
    return (Transcriber(config, params, ALPHABET, device="cpu", sample_buckets=(16384,)),
            JaxTranscriber(jax_config, [{k: jnp.asarray(v) for k, v in p.items()}
                                        for p in params], ALPHABET,
                           sample_buckets=(16384,)))


@pytest.mark.parametrize("transcript", [
    "the cat sat on the mat", "The CAT, sat -- on 2 mats!", "it's a dog", "a"])
def test_align_audio_matches_jax(transcribers, transcript):
    ours, theirs = transcribers
    audio = _audio(1.0, 7)
    want = jax_align_audio(theirs, audio, transcript)
    got = ours.align_audio(audio, transcript)
    assert got == want
    end = len(ours.frame_log_probs(audio)) * ours.seconds_per_frame
    assert got and all(0.0 <= w["start_s"] < w["end_s"] <= end for w in got)
    assert align_audio(ours, audio, transcript) == got  # the module function


def test_align_audio_refusals_match_jax(transcribers):
    ours, theirs = transcribers
    audio = _audio(0.3, 8)
    assert ours.align_audio(audio, "") == jax_align_audio(theirs, audio, "") == []
    assert ours.align_audio(audio, "  ") == []
    for transcript in ("123 !!", "ÄÖÜ"):
        with pytest.raises(ValueError, match="no characters in the model alphabet") as mine:
            ours.align_audio(audio, transcript)
        with pytest.raises(ValueError) as jax_error:
            jax_align_audio(theirs, audio, transcript)
        assert str(mine.value) == str(jax_error.value)
    too_long = "the cat sat on the mat " * 6
    with pytest.raises(ValueError, match="cannot be aligned") as mine:
        ours.align_audio(audio, too_long)
    with pytest.raises(ValueError) as jax_error:
        jax_align_audio(theirs, audio, too_long)
    assert str(mine.value) == str(jax_error.value)
