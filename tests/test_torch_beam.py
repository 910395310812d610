"""The port's LM-fused beam (`speechless_tpu_torch.ops.decode_lm`) against the JAX
package's Pallas beam (`ops/decode_pallas_lm.py`, interpret mode on the CPU, as its own
tests run it), and every route of the port's router (`device_beam`) against the JAX
router.

On the CPU `lm_step` runs `lm_step_reference`, the plain PyTorch twin of the CUDA
kernel. Tokens and counts must be exactly equal.
"""
import math

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from speechless_tpu.lm.device_lm import build_device_word_lm as jax_build_device_word_lm
from speechless_tpu.lm.ngram import ArpaLanguageModel as JaxArpaLanguageModel
from speechless_tpu.ops import decode_pallas_lm as jax_beam
from speechless_tpu.ops.device_beam import (
    beam_search_decode_device as jax_beam_search_decode_device)
from speechless_tpu_torch.lm.arpa_builder import build_kenlm_directory
from speechless_tpu_torch.lm.char_ngram import char_ngram_table_from_texts
from speechless_tpu_torch.lm.device_lm import build_device_word_lm
from speechless_tpu_torch.lm.ngram import ArpaLanguageModel
from speechless_tpu_torch.ops import decode_lm, device_beam
from speechless_tpu_torch.ops.device_beam import beam_search_decode_device
from test_torch_beam_step import ALPHABET, BLANK, LM_TEXTS, _batch

WEIGHTS = dict(lm_weight=0.8, word_count_weight=0.0, valid_word_count_weight=2.3)
TEXTS = ["the cat sat on the mat",
         "the cat ran to the dog",
         "a dog sat on a log",
         "the dog ran to the cat",
         "it's the cat on the mat",
         "a cat and a dog ran"]


@pytest.fixture(scope="module")
def word_lms(tmp_path_factory):
    directory = tmp_path_factory.mktemp("lm")
    build_kenlm_directory(TEXTS, directory, allowed_characters=ALPHABET, order=3)
    return (build_device_word_lm(ArpaLanguageModel.load(directory / "lm.arpa"), ALPHABET),
            jax_build_device_word_lm(JaxArpaLanguageModel.load(directory / "lm.arpa"),
                                     ALPHABET))


@pytest.mark.parametrize("width,batch", [(8, 12), (25, 5)])
def test_lm_beam_matches_pallas_lm_beam(word_lms, width, batch):
    ours, theirs = word_lms
    log_probs, lengths = _batch(LM_TEXTS[:batch], seed=width)
    want = jax_beam.beam_search_decode_pallas_lm(
        jnp.asarray(log_probs), jnp.asarray(lengths), blank=BLANK, word_lm=theirs,
        beam_width=width, max_decoded_length=64, prune_classes=8, **WEIGHTS)
    got = decode_lm.beam_search_decode_lm(
        torch.from_numpy(log_probs), torch.from_numpy(lengths), BLANK, ours,
        beam_width=width, max_decoded_length=64, prune_classes=8, **WEIGHTS)
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))


ROUTES = {  # case -> (router options, the port's route)
    "lexicon": (dict(lexicon_constrained=True, word_lm=True, **WEIGHTS), "plain"),
    "lm_table": (dict(lm_table=True, lm_weight=0.5), "plain"),
    "unpruned": (dict(prune_classes=None), "plain"),
    "word_lm": (dict(word_lm=True, **WEIGHTS), "lm"),
    "skip": (dict(skip_blank_log_prob=math.log(0.9)), "whole"),
    "no_lm": (dict(), "frames"),
    "oversized_skip": (dict(skip_blank_log_prob=math.log(0.9)), "plain"),
}


@pytest.mark.parametrize("case", sorted(ROUTES))
def test_router_matches_the_jax_router(word_lms, monkeypatch, case):
    """Each route of `beam_search_decode_device` gives the JAX router's tokens and takes
    the port's path for it. 120 classes + 2*8 pruned exceed the TPU's 128-lane frame
    row, where JAX ignores skipping and takes the XLA beam; the port takes the plain
    beam there too."""
    options, route = ROUTES[case]
    if case == "oversized_skip":
        rng = np.random.default_rng(4)
        logits = rng.normal(size=(2, 9, 120)).astype(np.float32)
        logits[0, ::2, 7] += 10.0
        logits[:, 1::2, 119] += 3.0
        log_probs = (logits - np.log(np.exp(logits).sum(-1, keepdims=True))).astype(
            np.float32)
        lengths, blank = np.array([9, 5], np.int32), 119
    else:
        (log_probs, lengths), blank = _batch(["the cat", "a dog", "the zzz"], seed=3), BLANK
    ours, theirs = dict(options), dict(options)
    if "word_lm" in options:
        ours["word_lm"], theirs["word_lm"] = word_lms
    if "lm_table" in options:
        table = char_ngram_table_from_texts(TEXTS, ALPHABET, order=3)
        ours["lm_table"], theirs["lm_table"] = torch.from_numpy(table), jnp.asarray(table)
    taken = []
    for name, label in (("beam_search_decode", "plain"), ("beam_search_decode_lm", "lm"),
                        ("beam_search_decode_whole", "whole"),
                        ("beam_search_decode_frames", "frames")):
        def record(*args, _fn=getattr(device_beam, name), _label=label, **kwargs):
            taken.append(_label)
            return _fn(*args, **kwargs)
        monkeypatch.setattr(device_beam, name, record)
    got = device_beam.beam_search_decode_device(
        torch.from_numpy(log_probs), torch.from_numpy(lengths), blank, beam_width=4,
        max_decoded_length=32, **ours)
    want = jax_beam_search_decode_device(jnp.asarray(log_probs), jnp.asarray(lengths),
                                         blank, beam_width=4, max_decoded_length=32,
                                         **theirs)
    assert taken == [route]
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))


def test_dispatch_routes_and_refusals(word_lms):
    """The word-LM and no-LM routes are the kernel beams themselves; lexicon-constrained
    search refuses the options JAX refuses with it."""
    log_probs, lengths = (torch.from_numpy(x) for x in _batch(["the cat", "a dog"], seed=3))
    via = beam_search_decode_device(log_probs, lengths, BLANK, beam_width=4,
                                    max_decoded_length=32, word_lm=word_lms[0], **WEIGHTS)
    direct = decode_lm.beam_search_decode_lm(log_probs, lengths, BLANK, word_lms[0],
                                             beam_width=4, max_decoded_length=32,
                                             **WEIGHTS)
    assert torch.equal(via[0], direct[0])
    via = beam_search_decode_device(log_probs, lengths, BLANK, beam_width=4,
                                    max_decoded_length=32)
    direct = decode_lm.beam_search_decode_frames(log_probs, lengths, BLANK, beam_width=4,
                                                 max_decoded_length=32)
    assert torch.equal(via[0], direct[0])
    with pytest.raises(ValueError, match="skip_blank_log_prob is not supported"):
        beam_search_decode_device(log_probs, lengths, BLANK, word_lm=word_lms[0],
                                  lexicon_constrained=True, skip_blank_log_prob=-0.1)
    with pytest.raises(ValueError, match="needs a word-level LM"):
        beam_search_decode_device(log_probs, lengths, BLANK, lexicon_constrained=True,
                                  lm_table=torch.zeros(29 ** 2, 28))


def test_a_class_count_past_the_tpu_lane_cap_decodes():
    """120 classes + 2*8 pruned > 128 lanes: the TPU routed this to the XLA beam;
    the port's beam step has no such cap."""
    rng = np.random.default_rng(4)
    logits = rng.normal(size=(2, 9, 120)).astype(np.float32)
    logits[0, ::2, 7] += 10.0
    log_probs = torch.log_softmax(torch.from_numpy(logits), dim=-1)
    tokens, counts = beam_search_decode_device(log_probs, torch.tensor([9, 5]), 119,
                                               beam_width=4, max_decoded_length=9)
    assert tokens.shape == (2, 9) and int(counts[0]) >= 1
