"""The port's own copies of the JAX package's jax-free host modules
(`speechless_tpu_torch.text.charsets`, `.text.graphemes`, `.utils.microbatch`) hold
what the originals hold: the same character lists, and `CtcGraphemeCodec` encoding and
decoding the same on both charsets."""
import numpy as np
import pytest

from speechless_tpu.text import charsets as jax_charsets
from speechless_tpu.text import graphemes as jax_graphemes
from speechless_tpu.utils import microbatch as jax_microbatch
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
