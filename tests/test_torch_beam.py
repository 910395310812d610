"""The port's LM-fused beam (`speechless_tpu_torch.ops.decode_lm`, `device_beam`)
against the JAX package's Pallas beam (`ops/decode_pallas_lm.py`, interpret mode on
the CPU, as its own tests run it).

On the CPU `lm_step` runs `lm_step_reference`, the plain PyTorch twin of the CUDA
kernel. Tokens and counts must be exactly equal.
"""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from speechless_tpu.lm.device_lm import build_device_word_lm as jax_build_device_word_lm
from speechless_tpu.lm.ngram import ArpaLanguageModel as JaxArpaLanguageModel
from speechless_tpu.ops import decode_pallas_lm as jax_beam
from speechless_tpu_torch.lm.arpa_builder import build_kenlm_directory
from speechless_tpu_torch.lm.device_lm import build_device_word_lm
from speechless_tpu_torch.lm.ngram import ArpaLanguageModel
from speechless_tpu_torch.ops import decode_lm
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


def test_dispatch_routes_and_refusals(word_lms):
    log_probs, lengths = _batch(["the cat", "a dog"], seed=3)
    log_probs, lengths = torch.from_numpy(log_probs), torch.from_numpy(lengths)
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
    for refused in (dict(lexicon_constrained=True, word_lm=word_lms[0]),
                    dict(lm_table=torch.zeros(30, 28)), dict(prune_classes=None),
                    dict(skip_blank_log_prob=-0.1)):
        with pytest.raises(NotImplementedError, match="ROADMAP.md"):
            beam_search_decode_device(log_probs, lengths, BLANK, beam_width=4, **refused)


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
