"""The port's LM-fused beam (`speechless_tpu_torch.ops.decode_lm`) against the JAX
package's Pallas beam (`ops/decode_pallas_lm.py`, interpret mode on the CPU, as its own
tests run it), and every route of the port's router (`device_beam`) against the JAX
router.

On the CPU `lm_span` runs `lm_span_reference` (the frame loop over
`lm_step_reference`), the plain PyTorch twin of the CUDA span kernel, and
`beam_backtrace` runs `backtrace_tokens`. Tokens and counts must be exactly equal.
"""
import math
import re
from pathlib import Path

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
from speechless_tpu_torch.ops import _kernels, beam_common, decode_lm, device_beam
from speechless_tpu_torch.ops.device_beam import beam_search_decode_device
from test_torch_beam_step import ALPHABET, BLANK, LM_TEXTS, _batch

REPO = Path(__file__).resolve().parent.parent
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


def _span(word_lm, log_probs, lengths, width, frames=None):
    """`lm_span` (its plain version, on the CPU) over a fresh carry: the packed frames,
    the span's outputs and the static options."""
    k = 8
    word_lm = word_lm.to("cpu") if word_lm is not None else None
    packed = decode_lm.pack_frames(torch.from_numpy(log_probs), k)
    static = dict(k=k, blank=BLANK, beam_width=width, max_decoded_length=64, **WEIGHTS)
    carry = decode_lm.fresh_carry(log_probs.shape[0], decode_lm.next_pow2(max(width, 8)),
                                  word_lm, "cpu")
    counts = torch.from_numpy(lengths)
    out = decode_lm.lm_span(packed if frames is None else packed[frames], carry, counts,
                            word_lm, **static)
    return packed, out, static, word_lm


@pytest.mark.parametrize("width,batch", [(8, 12), (25, 5)])
def test_span_reference_tokens_match_pallas_lm_beam(word_lms, width, batch):
    """One span over every frame, ranked and backtraced, gives the JAX Pallas beam's
    tokens (the span kernel's plain version, which its CUDA launch equals on the card)."""
    ours, theirs = word_lms
    log_probs, lengths = _batch(LM_TEXTS[:batch], seed=width)
    want = jax_beam.beam_search_decode_pallas_lm(
        jnp.asarray(log_probs), jnp.asarray(lengths), blank=BLANK, word_lm=theirs,
        beam_width=width, max_decoded_length=64, prune_classes=8, **WEIGHTS)
    _, (carry, parents, chars, tail_bonus), _, _ = _span(ours, log_probs, lengths, width)
    assert parents.dtype == chars.dtype == torch.int32
    assert parents.shape == (batch, log_probs.shape[1], carry[0].shape[1])
    final = torch.logaddexp(carry[0], carry[1]) + carry[5] + tail_bonus
    best = final.argmax(dim=1)
    tokens, counts = beam_common.backtrace_tokens(parents, chars, best,
                                                  carry[4].gather(1, best[:, None])[:, 0],
                                                  64)
    np.testing.assert_array_equal(tokens.numpy(), np.asarray(want[0]))
    np.testing.assert_array_equal(counts.numpy(), np.asarray(want[1]))


@pytest.mark.parametrize("with_lm", [True, False])
def test_a_span_split_in_two_equals_one_span(word_lms, with_lm):
    """The carry is the whole state: spans [0, a) then [a, T) give one span's carry,
    backpointers and tail bonus exactly."""
    log_probs, lengths = _batch(LM_TEXTS[:6], seed=11)
    packed, (carry, parents, chars, bonus), static, word_lm = _span(
        word_lms[0] if with_lm else None, log_probs, lengths, 8)
    cut = 13
    _, (half, p1, c1, _), _, _ = _span(word_lm, log_probs, lengths, 8, slice(0, cut))
    rest = decode_lm.lm_span(packed[cut:], half,
                             torch.from_numpy(np.maximum(lengths - cut, 0)), word_lm,
                             **static)
    for got, want in zip(rest[0], carry):
        assert torch.equal(got, want)
    assert torch.equal(torch.cat([p1, rest[1]], dim=1), parents)
    assert torch.equal(torch.cat([c1, rest[2]], dim=1), chars)
    assert torch.equal(rest[3], bonus)
    assert with_lm or not bonus.any()


def test_span_and_backtrace_wrappers_run_the_plain_versions_on_cpu(word_lms):
    log_probs, lengths = _batch(LM_TEXTS[:3], seed=2)
    packed, out, static, word_lm = _span(word_lms[0], log_probs, lengths, 8)
    launches = (decode_lm.lm_span.launches, beam_common.beam_backtrace.launches)
    carry = decode_lm.fresh_carry(3, 8, word_lm, "cpu")
    want = decode_lm.lm_span_reference(packed, carry, torch.from_numpy(lengths), word_lm,
                                       **static)
    for got, expected in zip(out[0] + list(out[1:]), want[0] + list(want[1:])):
        assert torch.equal(got, expected)
    best = torch.zeros(3, dtype=torch.long)
    for got, expected in zip(
            beam_common.beam_backtrace(out[1], out[2], best, out[0][4][:, 0], 64),
            beam_common.backtrace_tokens(out[1], out[2], best, out[0][4][:, 0], 64)):
        assert torch.equal(got, expected)
    assert (decode_lm.lm_span.launches, beam_common.beam_backtrace.launches) == launches
    with pytest.raises(ValueError, match="CPU or CUDA"):
        decode_lm.lm_span(packed.to("meta"), carry, torch.from_numpy(lengths), None,
                          **static)
    with pytest.raises(ValueError, match="CPU or CUDA"):
        beam_common.beam_backtrace(out[1].to("meta"), out[2], best, best, 64)


def _c_parameters(name):
    source = (REPO / "speechless_tpu_torch" / "csrc" / (name + ".cu")).read_text()
    match = re.search(r'extern "C" int {}\(([^)]*)\)'.format(name), source)
    return [p.strip() for p in match.group(1).split(",")]


@pytest.mark.parametrize("name,names", [
    ("lm_beam_span", ["frames", "counts", "pb", "pnb", "hash", "last", "len", "lm",
                      "trie_node", "word_ctx", "out_pb", "out_pnb", "out_hash", "out_last",
                      "out_len", "out_lm", "out_trie_node", "out_word_ctx", "parents",
                      "chars", "tail_bonus", "sorted_frames", "trie", "node_word",
                      "uni_logp", "uni_bo", "bi_keys", "bi_logp", "bi_bo", "tri_keys",
                      "tri_logp", "batch", "span", "frame_width", "r", "k", "n_pad",
                      "class_count", "blank", "beam_width", "max_len", "space_index",
                      "trie_classes", "bi_size", "tri_size", "unk_id", "lm_weight",
                      "word_count_weight", "valid_word_count_weight", "stream"]),
    ("beam_backtrace", ["parents", "chars", "best", "counts", "tokens", "batch", "t_max",
                        "r", "starts", "max_len", "stream"])])
def test_span_and_backtrace_entry_points_match_their_signatures(name, names):
    """The C entry points take, in the order the wrappers pass them, the pointers, ints
    and floats that `_kernels.SIGNATURES` declares (nothing compiles them on the CPU)."""
    params = _c_parameters(name)
    assert [p.split()[-1].lstrip("*") for p in params] == names
    kinds = [_kernels.ctypes.c_void_p if "*" in p else
             _kernels.ctypes.c_float if p.startswith("float") else _kernels.ctypes.c_int
             for p in params]
    assert kinds == _kernels.SIGNATURES[name]


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
