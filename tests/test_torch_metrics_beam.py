"""The port's evaluation metrics (`text/metrics.py`) and host beam (`ops/decode.py::
beam_search_decode` on the port's copy of `native/beam_search.cpp`, with the
`native/ngram_lm.cpp` scorer) against the JAX package's on the CPU.

Tolerances: none for the results. Edit distances, the LER/WER summary text and the
beam's tokens and counts are equal: without an LM, with an LM that the port's
`arpa_builder` builds, with the facade's prune floor log(1e-5), and between the port's
native decoder and its pure-Python version. The C++ scorer's log10 probabilities are
fp32, the Python scorer's float64: 1e-5 apart per word, 1e-4 per sentence.
"""
import math

import numpy as np
import pytest

from speechless_tpu.lm.ngram import load_language_model as jax_load_language_model
from speechless_tpu.ops.decode import beam_search_decode as jax_beam_search_decode
from speechless_tpu.text import metrics as jax_metrics
from speechless_tpu_torch.lm.arpa_builder import build_kenlm_directory
from speechless_tpu_torch.lm.ngram import (ArpaLanguageModel, NativeArpaLanguageModel,
                                           load_language_model)
from speechless_tpu_torch.ops.decode import beam_search_decode, beam_search_decode_python
from speechless_tpu_torch.text import metrics

ALPHABET = list("abcdefghijklmnopqrstuvwxyz '")
BLANK = len(ALPHABET)
SENTENCES = ["the cat sat on the mat", "a dog ran to the cat", "the dog sat",
             "it's the mat", "a cat ran"]


def test_levenshtein_matches():
    rng = np.random.default_rng(0)
    for _ in range(200):
        a = "".join(rng.choice(list("ab c'"), rng.integers(0, 12)))
        b = "".join(rng.choice(list("ab c'"), rng.integers(0, 12)))
        want = jax_metrics._levenshtein_python(a, b)
        assert metrics.levenshtein(a, b) == metrics._levenshtein_python(a, b) == want
        assert metrics.levenshtein(a.split(), b.split()) \
            == jax_metrics._levenshtein_python(a.split(), b.split())
    assert metrics.levenshtein("", "") == 0 and metrics.levenshtein("äöü", "aöu") == 2


def _results(module, seed):
    rng = np.random.default_rng(seed)
    results = []
    for _ in range(3):
        expected = " ".join(rng.choice(["the", "cat", "sat", "mat"], rng.integers(1, 5)))
        predicted = " ".join(rng.choice(["the", "cat", "sad", "at"], rng.integers(0, 5)))
        results.append(module.ExpectationVsPrediction(expected, predicted,
                                                      float(rng.uniform(0, 50))))
    return module.ExpectationsVsPredictions(results)


def test_summary_text_matches():
    ours = [_results(metrics, seed) for seed in range(3)]
    theirs = [_results(jax_metrics, seed) for seed in range(3)]
    for mine, want in zip(ours, theirs):
        assert str(mine) == str(want) and mine.summary_line() == want.summary_line()
        assert [str(r) for r in mine.results] == [str(r) for r in want.results]
    batches = metrics.ExpectationsVsPredictionsInBatches(ours)
    jax_batches = jax_metrics.ExpectationsVsPredictionsInBatches(theirs)
    assert str(batches) == str(jax_batches)
    grouped = metrics.ExpectationsVsPredictionsInGroupedBatches(
        {"a": batches, "b": metrics.ExpectationsVsPredictionsInBatches(ours[:1])})
    jax_grouped = jax_metrics.ExpectationsVsPredictionsInGroupedBatches(
        {"a": jax_batches, "b": jax_metrics.ExpectationsVsPredictionsInBatches(theirs[:1])})
    assert str(grouped) == str(jax_grouped)
    assert grouped.average_word_error_rate == jax_grouped.average_word_error_rate
    empty = metrics.ExpectationsVsPredictions([])
    assert empty.summary_line() == jax_metrics.ExpectationsVsPredictions([]).summary_line()


@pytest.fixture(scope="module")
def lm_directory(tmp_path_factory):
    directory = tmp_path_factory.mktemp("kenlm")
    build_kenlm_directory(SENTENCES, directory, allowed_characters=ALPHABET, order=3)
    return directory


def _log_probs(seed, batch=4, frames=60):
    """Peaky frames spelling corrupted sentences (a character, then blanks), with noise:
    the LM and the valid-word bonus change which prefix wins."""
    rng = np.random.default_rng(seed)
    logits = rng.normal(scale=1.5, size=(batch, frames, BLANK + 1))
    lengths = rng.integers(frames // 2, frames + 1, batch)
    for b in range(batch):
        text = SENTENCES[(seed + b) % len(SENTENCES)]
        t = 0
        for char in text:
            if t + 1 >= lengths[b]:
                break
            wrong = rng.random() < 0.2
            logits[b, t, ALPHABET.index(char) if not wrong else rng.integers(0, 26)] += 4.0
            logits[b, t, ALPHABET.index(char)] += 2.5 if wrong else 0.0
            logits[b, t + 1, BLANK] += 3.0
            t += 2
    log_probs = logits - np.log(np.exp(logits).sum(axis=-1, keepdims=True))
    return log_probs.astype(np.float32), lengths.astype(np.int32)


CASES = {"no_lm": (False, None), "lm": (True, None), "lm_pruned": (True, math.log(1e-5)),
         "pruned": (False, math.log(1e-5))}


@pytest.mark.parametrize("case", sorted(CASES))
@pytest.mark.parametrize("seed", [0, 1])
def test_native_beam_matches_the_jax_package(lm_directory, case, seed):
    with_lm, floor = CASES[case]
    log_probs, lengths = _log_probs(seed)
    ours_lm = load_language_model(lm_directory) if with_lm else None
    theirs_lm = jax_load_language_model(lm_directory) if with_lm else None
    assert with_lm is False or isinstance(ours_lm, NativeArpaLanguageModel)
    kwargs = dict(blank=BLANK, beam_width=16, alphabet=ALPHABET, lm_weight=0.8,
                  word_count_weight=0.1, valid_word_count_weight=2.3,
                  prune_log_prob_floor=floor)
    tokens, counts = beam_search_decode(log_probs, list(lengths), lm=ours_lm, **kwargs)
    want_tokens, want_counts = jax_beam_search_decode(log_probs, list(lengths), lm=theirs_lm,
                                                      **kwargs)
    assert np.array_equal(counts, want_counts)
    assert np.array_equal(tokens, want_tokens)
    assert counts.max() > 4


@pytest.mark.parametrize("with_lm", [False, True])
def test_native_beam_matches_its_python_version(lm_directory, with_lm):
    log_probs, lengths = _log_probs(2, batch=3, frames=40)
    kwargs = dict(blank=BLANK, beam_width=8, alphabet=ALPHABET)
    native_lm = load_language_model(lm_directory) if with_lm else None
    tokens, counts = beam_search_decode(log_probs, list(lengths), lm=native_lm, **kwargs)
    python_lm = load_language_model(lm_directory, prefer_native=False) if with_lm else None
    assert python_lm is None or isinstance(python_lm, ArpaLanguageModel)
    for lm in (native_lm, python_lm):
        want_tokens, want_counts = beam_search_decode_python(log_probs, list(lengths), lm=lm,
                                                             **kwargs)
        assert np.array_equal(counts, want_counts)
        assert np.array_equal(tokens[:, :want_tokens.shape[1]], want_tokens)
    forced, forced_counts = beam_search_decode(log_probs, list(lengths), lm=native_lm,
                                               force_python=True, **kwargs)
    assert np.array_equal(forced_counts, counts)


def test_scorers_agree(lm_directory):
    native = load_language_model(lm_directory)
    python = load_language_model(lm_directory, prefer_native=False)
    assert native.order == python.order == 3
    for words in (["the", "cat"], ["a", "dog", "ran"], ["zzz", "the"], []):
        for word in ("sat", "mat", "qqq", "</s>"):
            assert native.score_word(words, word) == pytest.approx(
                python.score_word(words, word), abs=1e-5)
        assert native.score_sentence(words) == pytest.approx(python.score_sentence(words),
                                                             abs=1e-4)
    assert native.is_valid_word("cat") and not native.is_valid_word("qqq")
    assert load_language_model(lm_directory / "missing") is None
