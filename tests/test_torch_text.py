"""The port's own copies of the JAX package's jax-free host modules
(`speechless_tpu_torch.text.charsets`, `.text.graphemes`, `.utils.microbatch`,
`.lm.char_ngram`) hold what the originals hold: the same character lists,
`CtcGraphemeCodec` encoding and decoding the same on both charsets, and the same char
n-gram tables and context arithmetic."""
import numpy as np
import pytest

from speechless_tpu.lm import char_ngram as jax_char_ngram
from speechless_tpu.text import charsets as jax_charsets
from speechless_tpu.text import graphemes as jax_graphemes
from speechless_tpu.utils import microbatch as jax_microbatch
from speechless_tpu_torch.lm import char_ngram
from speechless_tpu_torch.text import charsets, graphemes
from speechless_tpu_torch.utils import microbatch

TEXTS = ["the cat's hat", "", "a  b", "zoo keeper", "grüße aus köln", "straße"]


def test_character_lists_are_equal():
    assert charsets.english_frequent_characters == jax_charsets.english_frequent_characters
    assert charsets.german_frequent_characters == jax_charsets.german_frequent_characters


@pytest.mark.parametrize("charset", ["english_frequent_characters",
                                     "german_frequent_characters"])
def test_ctc_codec_encodes_and_decodes_the_same(charset):
    characters = getattr(charsets, charset)
    ours = graphemes.CtcGraphemeCodec(characters)
    theirs = jax_graphemes.CtcGraphemeCodec(getattr(jax_charsets, charset))
    texts = [t for t in TEXTS if set(t) <= set(characters)]
    assert (ours.grapheme_set_size, ours.ctc_blank) == \
        (theirs.grapheme_set_size, theirs.ctc_blank)
    for text in texts:
        assert ours.encode(text) == theirs.encode(text)
    np.testing.assert_array_equal(ours.encode_label_batch(texts),
                                  theirs.encode_label_batch(texts))
    rng = np.random.default_rng(0)
    for _ in range(20):
        tokens = rng.integers(0, ours.grapheme_set_size, 30).tolist()
        for merge in (True, False):
            assert ours.decode_graphemes(tokens, merge_repeated=merge) == \
                theirs.decode_graphemes(tokens, merge_repeated=merge)
    batch = rng.integers(0, ours.grapheme_set_size, (3, 12))
    assert ours.decode_grapheme_batch(batch, [12, 5, 0]) == \
        theirs.decode_grapheme_batch(batch, [12, 5, 0])


def test_microbatch_exposes_the_same_names():
    for name in ("MicroBatcher", "PendingItem", "BatcherSaturated", "BatcherStopped"):
        assert hasattr(microbatch, name) and hasattr(jax_microbatch, name), name


@pytest.mark.parametrize("order,add_k", [(2, 0.1), (3, 0.5), (4, 0.1)])
def test_char_ngram_tables_are_equal(order, add_k):
    """Same table bytes (texts with out-of-alphabet characters reset the context) and
    the same context arithmetic on ints and arrays."""
    alphabet = list("abc ")
    texts = ["abc cab", "a-b c", "", "ccc aaa bbb", "xyz ab"]
    ours = char_ngram.char_ngram_table_from_texts(texts, alphabet, order, add_k)
    theirs = jax_char_ngram.char_ngram_table_from_texts(texts, alphabet, order, add_k)
    assert ours.dtype == theirs.dtype == np.float32
    np.testing.assert_array_equal(ours, theirs)
    size = len(alphabet)
    assert char_ngram.context_size(size, order) == jax_char_ngram.context_size(size, order)
    assert char_ngram.initial_context(size, order) == \
        jax_char_ngram.initial_context(size, order) == ours.shape[0] - 1
    contexts = np.arange(ours.shape[0])
    for char in range(size):
        np.testing.assert_array_equal(
            char_ngram.advance_context(contexts, char, size, order),
            jax_char_ngram.advance_context(contexts, char, size, order))
