"""The port's jax-free LM stack (`speechless_tpu_torch.lm`): the ARPA builder and
loader, and the device word-LM tables and gathers, against the JAX package. Every
table array and every score is exactly equal (no tolerance)."""
import itertools

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from speechless_tpu.lm import arpa_builder as jax_arpa_builder
from speechless_tpu.lm import device_lm as jax_device_lm
from speechless_tpu.lm.ngram import ArpaLanguageModel as JaxArpaLanguageModel
from speechless_tpu_torch.lm import arpa_builder, device_lm, ngram
from speechless_tpu_torch.ops.beam_common import word_bonuses

ALPHABET = list("abcdefghijklmnopqrstuvwxyz '")

TEXTS = ["the cat sat on the mat",
         "the cat ran to the dog",
         "a dog sat on a log",
         "the dog ran to the cat",
         "it's the cat on the mat",
         "a cat and a dog ran"]


@pytest.fixture(scope="module")
def lm_directory(tmp_path_factory):
    directory = tmp_path_factory.mktemp("lm")
    arpa_builder.build_kenlm_directory(TEXTS, directory, allowed_characters=ALPHABET,
                                       order=3)
    return directory


@pytest.fixture(scope="module")
def tables(lm_directory):
    ours = device_lm.build_device_word_lm(
        ngram.ArpaLanguageModel.load(lm_directory / "lm.arpa"), ALPHABET)
    theirs = jax_device_lm.build_device_word_lm(
        JaxArpaLanguageModel.load(lm_directory / "lm.arpa"), ALPHABET)
    return ours, theirs


def test_arpa_files_are_identical(lm_directory, tmp_path):
    jax_arpa_builder.build_kenlm_directory(TEXTS, tmp_path, allowed_characters=ALPHABET,
                                           order=3)
    for name in ("lm.arpa", "vocabulary"):
        assert (lm_directory / name).read_bytes() == (tmp_path / name).read_bytes()


def test_arpa_scores_match(lm_directory):
    ours = ngram.load_language_model(lm_directory, prefer_native=False)
    theirs = JaxArpaLanguageModel.load(lm_directory / "lm.arpa")
    assert ours.order == theirs.order == 3
    assert ours.vocabulary == theirs.vocabulary
    words = sorted(theirs.vocabulary) + ["zzz"]
    for context in itertools.product(words, repeat=2):
        for word in words:
            assert ours.score_word(context, word) == theirs.score_word(context, word)


def test_tables_are_identical(tables):
    ours, theirs = tables
    for name, got, want in zip(("trie", "node_word", "uni_logp", "uni_bo", "bi_k",
                                "bi_logp", "bi_bo", "tri_k", "tri_logp"),
                               ours.arrays(), theirs[:9]):
        assert got.dtype == want.dtype, name
        assert np.array_equal(got, want), name
    assert (ours.max_probes, ours.bos_id, ours.unk_id, ours.space_index) \
        == (theirs.max_probes, theirs.bos_id, theirs.unk_id, theirs.space_index)


def test_score_word_device_matches_for_every_context(tables):
    ours, theirs = tables
    ids = np.arange(len(ours.uni_logp), dtype=np.int32)
    c1, c2, w = (x.reshape(-1) for x in np.meshgrid(ids, ids, ids, indexing="ij"))
    want = np.asarray(jax_device_lm.score_word_device(
        theirs.as_device(), jnp.asarray(c1), jnp.asarray(c2), jnp.asarray(w)))
    got = device_lm.score_word_device(ours.to("cpu"), torch.from_numpy(c1),
                                      torch.from_numpy(c2), torch.from_numpy(w))
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), want)


def test_word_bonuses_match(tables):
    from speechless_tpu.ops.decode_jax import _word_bonuses

    ours, theirs = tables
    rng = np.random.default_rng(0)
    nodes = rng.integers(-1, len(ours.node_word), 64).astype(np.int32)
    nodes[:4] = [0, -1, 1, 2]
    contexts = rng.integers(0, len(ours.uni_logp), (64, 2)).astype(np.int32)
    want = _word_bonuses(theirs.as_device(), jnp.asarray(nodes), jnp.asarray(contexts),
                         0.8, 0.0, 2.3)
    got = word_bonuses(ours.to("cpu"), torch.from_numpy(nodes),
                       torch.from_numpy(contexts), 0.8, 0.0, 2.3)
    for w, g in zip(want, got):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def test_tables_move_to_device_as_tensors(tables):
    moved = tables[0].to("cpu")
    assert all(isinstance(a, torch.Tensor) for a in moved.arrays())
    assert moved.trie.dtype == torch.int32 and moved.uni_logp.dtype == torch.float32
    assert moved.to("cpu").space_index == ALPHABET.index(" ")
