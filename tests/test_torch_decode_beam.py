"""The port's plain batched beam (`speechless_tpu_torch.ops.decode_beam`) against the
JAX package's XLA beam (`ops/decode_jax.py`: `beam_search_decode_jax`,
`beam_search_nbest_jax`) in every fusion mode: pruned and unpruned search, the char-table
LM, the word LM, lexicon-constrained search and n-best lists.

Tolerances: tokens and counts exact; n-best scores within 1e-5 relative (segment sums
and log-sum-exps are taken by another library, in another order).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from speechless_tpu.lm.device_lm import build_device_word_lm as jax_build_device_word_lm
from speechless_tpu.lm.ngram import ArpaLanguageModel as JaxArpaLanguageModel
from speechless_tpu.ops.decode_jax import beam_search_decode_jax, beam_search_nbest_jax
from speechless_tpu_torch.lm.arpa_builder import build_kenlm_directory
from speechless_tpu_torch.lm.char_ngram import char_ngram_table_from_texts
from speechless_tpu_torch.lm.device_lm import build_device_word_lm
from speechless_tpu_torch.lm.ngram import ArpaLanguageModel
from speechless_tpu_torch.ops import decode_beam
from test_torch_beam_step import ALPHABET, BLANK, LM_TEXTS, _batch

TEXTS = ["the cat sat on the mat", "the cat ran to the dog", "a dog sat on a log",
         "the dog ran to the cat", "it's the cat on the mat", "a cat and a dog ran"]
WEIGHTS = dict(lm_weight=0.8, word_count_weight=0.5, valid_word_count_weight=2.3)


@pytest.fixture(scope="module")
def word_lms(tmp_path_factory):
    directory = tmp_path_factory.mktemp("lm")
    build_kenlm_directory(TEXTS, directory, allowed_characters=ALPHABET, order=3)
    return (build_device_word_lm(ArpaLanguageModel.load(directory / "lm.arpa"), ALPHABET),
            jax_build_device_word_lm(JaxArpaLanguageModel.load(directory / "lm.arpa"),
                                     ALPHABET))


@pytest.fixture(scope="module")
def batch():
    """Peaky and noisy rows of different lengths, with out-of-vocabulary words."""
    return _batch(LM_TEXTS[:7], seed=11)


def _options(mode, word_lms):
    """(port options, JAX options) of one fusion mode."""
    if mode == "lm_table":
        table = char_ngram_table_from_texts(TEXTS, ALPHABET, order=3)
        return (dict(lm_table=torch.from_numpy(table), lm_weight=0.5, prune_classes=8),
                dict(lm_table=jnp.asarray(table), lm_weight=0.5, prune_classes=8))
    if mode in ("word_lm", "lexicon"):
        lexicon = dict(lexicon_constrained=mode == "lexicon", prune_classes=8, **WEIGHTS)
        return dict(word_lm=word_lms[0], **lexicon), dict(word_lm=word_lms[1], **lexicon)
    prune = dict(pruned=8, unpruned=None)[mode]
    return dict(prune_classes=prune), dict(prune_classes=prune)


@pytest.mark.parametrize("mode", ["pruned", "unpruned", "lm_table", "word_lm", "lexicon"])
def test_decode_matches_the_xla_beam(word_lms, batch, mode):
    log_probs, lengths = batch
    ours, theirs = _options(mode, word_lms)
    want = beam_search_decode_jax(jnp.asarray(log_probs), jnp.asarray(lengths), BLANK,
                                  beam_width=8, max_decoded_length=48, **theirs)
    got = decode_beam.beam_search_decode(torch.from_numpy(log_probs),
                                         torch.from_numpy(lengths), BLANK, beam_width=8,
                                         max_decoded_length=48, **ours)
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
    assert got[0].dtype == got[1].dtype == torch.int32


@pytest.mark.parametrize("mode,nbest", [("pruned", 5), ("word_lm", 3), ("lexicon", 8)])
def test_nbest_matches_the_xla_beam(word_lms, batch, mode, nbest):
    """``nbest=8`` at W=8 takes every beam, dead ones included (empty, count 0)."""
    log_probs, lengths = batch
    ours, theirs = _options(mode, word_lms)
    want = beam_search_nbest_jax(jnp.asarray(log_probs), jnp.asarray(lengths), BLANK,
                                 nbest, beam_width=8, max_decoded_length=48, **theirs)
    got = decode_beam.beam_search_nbest(torch.from_numpy(log_probs),
                                        torch.from_numpy(lengths), BLANK, nbest,
                                        beam_width=8, max_decoded_length=48, **ours)
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
    alive = np.asarray(want[2]) > -1e29
    np.testing.assert_allclose(got[2].numpy()[alive], np.asarray(want[2])[alive],
                               rtol=1e-5)
    assert (got[2].numpy()[~alive] <= -1e29).all()
    if mode == "lexicon":
        assert not alive.all()  # short rows hold fewer live prefixes than W


def test_lexicon_emits_only_vocabulary_words(word_lms, batch):
    """Every completed word of the constrained search is in the LM's vocabulary; the
    open-vocabulary search emits out-of-vocabulary ones on the same input."""
    log_probs, lengths = batch
    vocabulary = {word for text in TEXTS for word in text.split()}
    texts = {}
    for lexicon in (False, True):
        tokens, counts = decode_beam.beam_search_decode(
            torch.from_numpy(log_probs), torch.from_numpy(lengths), BLANK, beam_width=8,
            max_decoded_length=48, word_lm=word_lms[0], prune_classes=8,
            lexicon_constrained=lexicon, **WEIGHTS)
        texts[lexicon] = ["".join(ALPHABET[c] for c in row[:n].tolist())
                          for row, n in zip(tokens, counts)]
    complete = [w for text in texts[True] for w in text.split(" ")[:-1] if w]
    assert complete and set(complete) <= vocabulary
    assert any(w not in vocabulary for text in texts[False] for w in text.split())


def test_refusals(word_lms, batch):
    log_probs, lengths = (torch.from_numpy(x) for x in batch)
    with pytest.raises(ValueError, match="mutually exclusive"):
        decode_beam.beam_search_decode(log_probs, lengths, BLANK, word_lm=word_lms[0],
                                       lm_table=torch.zeros(29 ** 2, 28))
    with pytest.raises(ValueError, match="needs a word_lm"):
        decode_beam.beam_search_decode(log_probs, lengths, BLANK, lexicon_constrained=True)
    for nbest in (0, 9):
        with pytest.raises(ValueError, match="nbest must be in"):
            decode_beam.beam_search_nbest(log_probs, lengths, BLANK, nbest, beam_width=8)


def test_lm_table_geometry_reads_the_table_shape():
    table = char_ngram_table_from_texts(TEXTS, ALPHABET, order=4)
    assert decode_beam.lm_table_geometry(table) == (len(ALPHABET), 4)
    assert decode_beam.lm_table_geometry(None) == (0, 2)
