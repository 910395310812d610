"""The port's remaining stream routes on the CPU against the JAX package: the
plain-step stream decoder (`speechless_tpu_torch.ops.decode_incremental.
BeamStreamDecoder`) against JAX's `BeamStreamDecoder` and both offline beams, for the
lexicon-constrained, unpruned, char-table-LM, word-LM and no-LM searches; one advance
leaf by leaf against JAX's stream step (the stitch kernel's plain version against JAX's
XLA stitch); the engine routing of `beam_decoder_for`; lexicon and unpruned sessions of
the host pool against the JAX pool.

Tolerances: tokens, committed prefixes and texts exact; scores within 1e-4 relative
(log-sum-exp and LM sums in two libraries, over up to 48 frames).
"""
import json
import types

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from speechless_tpu.lm.device_lm import build_device_word_lm as jax_build_device_word_lm
from speechless_tpu.lm.ngram import ArpaLanguageModel as JaxArpaLanguageModel
from speechless_tpu.ops.decode_incremental import BeamStreamDecoder as JaxDecoder
from speechless_tpu.ops.decode_incremental import _stream_step_impl
from speechless_tpu.ops.decode_jax import beam_search_decode_jax
from speechless_tpu.serving_streaming import StreamingSessionPool as JaxPool
from speechless_tpu_torch.lm.arpa_builder import build_kenlm_directory
from speechless_tpu_torch.lm.char_ngram import char_ngram_table_from_texts
from speechless_tpu_torch.lm.device_lm import build_device_word_lm
from speechless_tpu_torch.lm.ngram import ArpaLanguageModel
from speechless_tpu_torch.ops.decode_beam import beam_search_decode
from speechless_tpu_torch.ops.decode_incremental import BeamStreamDecoder
from speechless_tpu_torch.ops.decode_incremental_kernel import (KernelBeamStreamDecoder,
                                                                kernel_beam_supported)
from speechless_tpu_torch.serving import Transcriber
from speechless_tpu_torch.serving_streaming import StreamingSessionPool, beam_decoder_for
from test_torch_serving import ALPHABET, TEXTS, _audio, _jax_transcriber
from test_torch_serving import setup  # noqa: F401 (the module fixture)
from test_torch_streaming import MODES, WINDOW, _drive, random_log_probs, stream

CLASSES = len(ALPHABET) + 1
BLANK = len(ALPHABET)
W = 8
RTOL = 1e-4
DECODER = dict(blank=BLANK, beam_width=W, max_decoded_length=64, chunk_frames=16)
# search name -> (decoder options without the LMs, which LM)
SEARCHES = {"lexicon": (dict(prune_classes=8, lexicon_constrained=True), "word"),
            "unpruned": (dict(prune_classes=None), None),
            "char_table": (dict(prune_classes=8, lm_weight=0.5), "table"),
            "word_lm": (dict(prune_classes=8), "word"),
            "unpruned_word_lm": (dict(prune_classes=None), "word")}


@pytest.fixture(scope="module")
def lms(tmp_path_factory):
    """(port word LM, JAX word LM, char table as numpy)."""
    directory = tmp_path_factory.mktemp("lm")
    build_kenlm_directory(TEXTS, directory, allowed_characters=ALPHABET, order=3)
    return (build_device_word_lm(ArpaLanguageModel.load(directory / "lm.arpa"), ALPHABET),
            jax_build_device_word_lm(JaxArpaLanguageModel.load(directory / "lm.arpa"),
                                     ALPHABET),
            char_ngram_table_from_texts(TEXTS, ALPHABET, order=3))


def decoders(search, lms, **overrides):
    """(port decoder, JAX decoder) for one search of `SEARCHES`."""
    options, lm = SEARCHES[search]
    kwargs = dict(DECODER, **options, **overrides)
    port, theirs = dict(kwargs), dict(kwargs)
    if lm == "word":
        port["word_lm"], theirs["word_lm"] = lms[0], lms[1]
    elif lm == "table":
        port["lm_table"], theirs["lm_table"] = lms[2], jnp.asarray(lms[2])
    return BeamStreamDecoder(device="cpu", **port), JaxDecoder(**theirs)


def assert_same_result(got, want):
    np.testing.assert_array_equal(got.tokens, want.tokens)
    np.testing.assert_allclose(got.score, want.score, rtol=RTOL)


@pytest.mark.parametrize("search", sorted(SEARCHES))
def test_chunked_stream_matches_jax_and_offline(lms, search):
    """Chunked at three sets of splits: the result equals JAX's decoder chunked the
    same way, and its tokens equal both offline beams over the whole 48 frames."""
    ours, theirs = decoders(search, lms)
    lp = random_log_probs(48, CLASSES, seed=3)
    results = []
    for splits in ([], [5, 13, 30], [16, 32]):
        got = stream(ours, lp, splits)[1]
        assert_same_result(got, stream(theirs, lp, splits)[1])
        results.append(got)
    options, lm = SEARCHES[search]
    offline = dict(beam_width=W, max_decoded_length=64, **options)
    if lm == "word":
        port_lm, jax_lm = dict(word_lm=lms[0]), dict(word_lm=lms[1])
    elif lm == "table":
        port_lm, jax_lm = dict(lm_table=lms[2]), dict(lm_table=jnp.asarray(lms[2]))
    else:
        port_lm = jax_lm = {}
    weights = {} if "lm_weight" in options else dict(lm_weight=0.8)
    tokens, counts = beam_search_decode(torch.from_numpy(lp[None]), torch.tensor([48]),
                                        BLANK, **offline, **port_lm, **weights)
    jax_tokens, jax_counts = beam_search_decode_jax(
        jnp.asarray(lp[None]), jnp.asarray([48]), BLANK, **offline, **jax_lm, **weights)
    want = np.asarray(jax_tokens)[0][: int(jax_counts[0])]
    np.testing.assert_array_equal(tokens[0, : int(counts[0])].numpy(), want)
    for got in results:
        np.testing.assert_array_equal(got.tokens, want)
    assert len(want) > 3


@pytest.mark.parametrize("count", [0, 9, 16])
def test_one_advance_matches_the_jax_stream_step(lms, count):
    """Lexicon-constrained word-LM streams carried 21 frames in, then one chunk through
    `advance_in_program` (its stitch is `stitch_reference` on the CPU) and through JAX's
    stream step (its XLA stitch): every leaf of the new state, the stitched token
    buffer included, the best row and the scalars agree. ``count=0`` is a no-op."""
    ours, theirs = decoders("lexicon", lms)
    lp = random_log_probs(21, CLASSES, seed=6)
    jax_state, _ = theirs.feed(theirs.init_state(), lp)
    state, _ = ours.feed(ours.init_state(), lp)
    piece = random_log_probs(16, CLASSES, seed=7)
    piece[count:] = 0.0
    want_state, want_row, want_scalars = _stream_step_impl(
        jax_state.beam, jnp.asarray(piece), jnp.asarray(count, jnp.int32), BLANK, W, 64,
        None, 0.8, theirs._word_arrays, theirs._word_static, 0.0, 2.3, 8, True)
    stacked = [leaf[None] for leaf in state.beam]
    got_state, got_row, got_scalars = ours.advance_in_program(
        stacked, torch.from_numpy(piece[None]), np.asarray([count]))
    assert len(got_state) == len(want_state) == 10
    for got, want in zip(got_state, want_state):
        want = np.asarray(want)
        if np.issubdtype(want.dtype, np.floating):
            np.testing.assert_allclose(got[0].numpy(), want, rtol=1e-5, atol=1e-6)
        else:
            np.testing.assert_array_equal(got[0].numpy(), want.astype(np.int64))
    np.testing.assert_array_equal(got_row[0].numpy(), np.asarray(want_row))
    np.testing.assert_array_equal(got_scalars[0, [0, 2]].numpy(),
                                  np.asarray(want_scalars)[[0, 2]])
    np.testing.assert_allclose(float(got_scalars[0, 1]), float(want_scalars[1]),
                               rtol=1e-5)
    if count == 0:
        for got, before in zip(got_state, stacked):
            np.testing.assert_array_equal(got.numpy(), before.numpy())


def test_stacked_advance_matches_jax_advance_in_program(lms):
    """`stacked_fresh_state` is `_fresh_beam` stacked, and one advance of three stacked
    rows (counts 16, 0, 5) equals JAX's traced `advance_in_program` row for row."""
    ours, theirs = decoders("unpruned", lms)
    stacked = ours.stacked_fresh_state(3)
    for leaf, fresh in zip(stacked, ours._fresh_beam()):
        assert all(torch.equal(row, fresh) for row in leaf)
    pieces = np.stack([random_log_probs(16, CLASSES, seed=s) for s in (1, 2, 3)])
    counts = np.asarray([16, 0, 5])
    got_state, got_rows, got_scalars = ours.advance_in_program(
        stacked, torch.from_numpy(pieces), counts)
    want_state, want_rows, want_scalars = jax.jit(theirs.advance_in_program)(
        theirs.stacked_fresh_state(3), jnp.asarray(pieces), jnp.asarray(counts, jnp.int32))
    np.testing.assert_array_equal(got_rows.numpy(), np.asarray(want_rows))
    np.testing.assert_array_equal(got_state[-1].numpy(), np.asarray(want_state[-1]))
    np.testing.assert_allclose(got_scalars.numpy(), np.asarray(want_scalars), rtol=1e-5)


@pytest.mark.parametrize("search", ["lexicon", "char_table"])
def test_feed_batch_and_rollover_match_jax(lms, search):
    """At 16 graphemes of buffer and 4-frame chunks the stream rolls over many times:
    the committed prefix, its score and the result equal JAX's; `feed_batch` of three
    rows (one empty) equals sequential feeds."""
    ours, theirs = decoders(search, lms, max_decoded_length=16, chunk_frames=4)
    lp = random_log_probs(120, CLASSES, seed=7)
    state, result = stream(ours, lp, [9, 50])
    want_state, want = stream(theirs, lp, [9, 50])
    assert state.committed.size > 8
    np.testing.assert_array_equal(state.committed, want_state.committed)
    np.testing.assert_allclose(state.committed_score, want_state.committed_score,
                               rtol=RTOL)
    assert_same_result(result, want)
    lps = [random_log_probs(frames, CLASSES, seed=frames) for frames in (37, 0, 22)]
    sequential = [ours.feed(ours.init_state(), lp) for lp in lps]
    for (got_state, got), (seq_state, seq) in zip(
            ours.feed_batch([ours.init_state() for _ in lps], lps), sequential):
        np.testing.assert_array_equal(got_state.committed, seq_state.committed)
        assert_same_result(got, seq)


def test_constructor_checks(lms):
    """JAX's constructor checks, and the CUDA default device."""
    with pytest.raises(ValueError, match="mutually exclusive"):
        BeamStreamDecoder(blank=BLANK, word_lm=lms[0], lm_table=lms[2], device="cpu")
    with pytest.raises(ValueError, match="needs a word_lm"):
        BeamStreamDecoder(blank=BLANK, lexicon_constrained=True, device="cpu")
    with pytest.raises(ValueError, match="chunk_frames"):
        BeamStreamDecoder(blank=BLANK, chunk_frames=65, max_decoded_length=64,
                          device="cpu")
    with pytest.raises(ValueError, match="chunk_frames"):
        BeamStreamDecoder(blank=BLANK, chunk_frames=0, device="cpu")
    assert BeamStreamDecoder(blank=BLANK).device.type == "cuda"


class TestRouting:
    @staticmethod
    def fake(**overrides):
        base = dict(blank_index=BLANK, _decoder={"beam_width": W, "prune_classes": 8},
                    word_lm=None, lexicon_constrained=False, device=torch.device("cpu"))
        base.update(overrides)
        return types.SimpleNamespace(**base)

    def test_kernel_limits(self):
        assert kernel_beam_supported(29, 8, 25)       # 9 x 32 lanes -> 512
        assert kernel_beam_supported(40, 31, 32)      # 32 x 32 -> 1024
        assert not kernel_beam_supported(40, 32, 32)  # 33 x 32 -> 2048
        assert not kernel_beam_supported(29, None, 8)
        assert kernel_beam_supported(5, 40, 32)       # k is at most the class count

    @pytest.mark.parametrize("overrides, engine, want", [
        ({}, "auto", KernelBeamStreamDecoder),
        ({}, "xla", BeamStreamDecoder),
        ({}, "pallas", KernelBeamStreamDecoder),
        ({"lexicon_constrained": True}, "auto", BeamStreamDecoder),
        ({"_decoder": {"beam_width": W, "prune_classes": None}}, "auto", BeamStreamDecoder),
        ({"_decoder": {"beam_width": 64, "prune_classes": 28}}, "auto", BeamStreamDecoder),
    ])
    def test_engines(self, lms, overrides, engine, want):
        if overrides.get("lexicon_constrained"):
            overrides = dict(overrides, word_lm=lms[0])
        decoder = beam_decoder_for(self.fake(**overrides), engine=engine)
        assert type(decoder) is want
        assert decoder.device == torch.device("cpu") and decoder.chunk_frames == 32
        if want is BeamStreamDecoder:
            assert decoder.lexicon_constrained == bool(overrides.get("lexicon_constrained"))
            assert decoder.prune_classes == self.fake(**overrides)._decoder["prune_classes"]

    def test_refusals(self, lms):
        with pytest.raises(ValueError, match="unknown beam engine"):
            beam_decoder_for(self.fake(), engine="tpu")
        with pytest.raises(ValueError, match="lexicon"):
            beam_decoder_for(self.fake(lexicon_constrained=True, word_lm=lms[0]),
                             engine="pallas")
        with pytest.raises(ValueError, match="pruned"):
            beam_decoder_for(self.fake(_decoder={"beam_width": W, "prune_classes": None}),
                             engine="pallas")


@pytest.mark.parametrize("kind", ["lexicon", "unpruned"])
def test_stream_sessions_match_the_jax_pool(setup, kind):  # noqa: F811
    """Lexicon-constrained and unpruned transcribers serve stream sessions (they raised
    before): greedy, beam, pipelined beam and two-pass sessions fed the same chunks give
    partials, words and finals byte-equal to the JAX pool's."""
    config, params, lm_directory = setup
    options = (dict(lexicon_constrained=True) if kind == "lexicon"
               else dict(prune_classes=None))
    ours = Transcriber(config, params, ALPHABET, device="cpu", kenlm_directory=lm_directory,
                       beam_width=8, sample_buckets=(16384,), **options)
    theirs = _jax_transcriber(setup, kenlm=True, **options)
    audio = _audio(2.4, 40)
    results = []
    for pool in (StreamingSessionPool(ours, max_wait_ms=1.0, **WINDOW),
                 JaxPool(theirs, max_wait_ms=1.0, **WINDOW)):
        pool.start()
        try:
            sessions = {pool.create(partial_decode=mode, final_decode=final):
                        (mode, final) for mode, final in MODES}
            results.append(_drive(pool, audio, sessions))
        finally:
            pool.stop()
    assert results[0] == results[1]
    assert all(json.loads(r)[-1]["text"] for r in results[0])
