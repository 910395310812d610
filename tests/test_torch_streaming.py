"""The port's streaming slice on the CPU against the JAX package: the incremental beam
(`speechless_tpu_torch.ops.decode_incremental_kernel.KernelBeamStreamDecoder`, whose
steps run their plain versions on CPU tensors) against `PallasBeamStreamDecoder`
(interpret mode), the XLA `BeamStreamDecoder` and the offline Pallas beams; the
streaming helpers; the session pool against the JAX pool; the HTTP stream routes and
the CLI's refusals.

Tolerances: tokens, committed prefixes, texts and words exact; scores within 1e-5
relative (log-sum-exp in two libraries).
"""
import json
import sys
import threading
import types
import urllib.error
import urllib.request

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from speechless_tpu.lm.device_lm import build_device_word_lm as jax_build_device_word_lm
from speechless_tpu.lm.ngram import ArpaLanguageModel as JaxArpaLanguageModel
from speechless_tpu.ops.decode_incremental import BeamStreamDecoder as JaxXlaDecoder
from speechless_tpu.ops.decode_incremental_pallas import (PallasBeamStreamDecoder,
                                                          _pallas_stream_step_impl)
from speechless_tpu.ops.decode_pallas_lm import (beam_search_decode_pallas_frames,
                                                 beam_search_decode_pallas_lm)
from speechless_tpu.serving_streaming import StreamingSessionPool as JaxPool
from speechless_tpu.serving_streaming import WordAssembler as JaxWordAssembler
from speechless_tpu.serving_streaming import collapse_new_frames as jax_collapse
from speechless_tpu.text.graphemes import CtcGraphemeCodec as JaxCodec
from speechless_tpu_torch.lm.arpa_builder import build_kenlm_directory
from speechless_tpu_torch.lm.device_lm import build_device_word_lm
from speechless_tpu_torch.lm.ngram import ArpaLanguageModel
from speechless_tpu_torch.ops.decode_incremental import BeamStreamDecoder
from speechless_tpu_torch.ops.decode_incremental_kernel import (BeamStreamState,
                                                                KernelBeamStreamDecoder,
                                                                state_from_jax,
                                                                stream_advance)
from speechless_tpu_torch.serving import Transcriber
from speechless_tpu_torch.serving_http import TranscriptionServer
from speechless_tpu_torch.serving_streaming import (StreamingSessionPool, WordAssembler,
                                                    beam_decoder_for, collapse_new_frames)
from speechless_tpu_torch.text.graphemes import CtcGraphemeCodec
from test_torch_serving import ALPHABET, TEXTS, _audio, _jax_transcriber, _request
from test_torch_serving import setup  # noqa: F401 (the module fixture)

C, BLANK, W = 6, 5, 8       # tiny no-LM alphabet: interpret-mode compiles are the cost
BLANK_LM = len(ALPHABET)
RTOL = 1e-5


def random_log_probs(frames, classes, seed, peaky=2.5):
    rng = np.random.RandomState(seed)
    logits = rng.randn(frames, classes) * peaky
    return (logits - np.log(np.exp(logits).sum(-1, keepdims=True))).astype(np.float32)


def stream(decoder, log_probs, splits, state=None):
    state = decoder.init_state() if state is None else state
    start, result = 0, None
    for end in list(splits) + [log_probs.shape[0]]:
        state, result = decoder.feed(state, log_probs[start:end])
        start = end
    return state, result


def assert_same_result(got, want):
    np.testing.assert_array_equal(got.tokens, want.tokens)
    np.testing.assert_allclose(got.score, want.score, rtol=RTOL)


@pytest.fixture(scope="module")
def no_lm():
    """(port decoder, JAX Pallas decoder) at C=6, W=8, 16-frame chunks."""
    kwargs = dict(blank=BLANK, beam_width=W, max_decoded_length=64, chunk_frames=16,
                  prune_classes=C)
    return (KernelBeamStreamDecoder(device="cpu", **kwargs),
            PallasBeamStreamDecoder(**kwargs))


@pytest.fixture(scope="module")
def word_lms(tmp_path_factory):
    directory = tmp_path_factory.mktemp("lm")
    build_kenlm_directory(TEXTS, directory, allowed_characters=ALPHABET, order=3)
    return (build_device_word_lm(ArpaLanguageModel.load(directory / "lm.arpa"), ALPHABET),
            jax_build_device_word_lm(JaxArpaLanguageModel.load(directory / "lm.arpa"),
                                     ALPHABET))


@pytest.fixture(scope="module")
def with_lm(word_lms):
    """(port decoder, JAX Pallas decoder) with the word LM, 29 classes, W=8."""
    kwargs = dict(blank=BLANK_LM, beam_width=W, max_decoded_length=64, chunk_frames=16,
                  prune_classes=8)
    return (KernelBeamStreamDecoder(word_lm=word_lms[0], device="cpu", **kwargs),
            PallasBeamStreamDecoder(word_lm=word_lms[1], **kwargs))


class TestNoLm:
    @pytest.mark.parametrize("splits", [[], [7, 8, 9], [1, 16, 17, 33], [20]])
    def test_matches_the_jax_pallas_decoder(self, no_lm, splits):
        ours, theirs = no_lm
        lp = random_log_probs(40, C, seed=0)
        assert_same_result(stream(ours, lp, splits)[1], stream(theirs, lp, splits)[1])

    @pytest.mark.parametrize("splits", [[], [5, 23]])
    def test_chunked_equals_offline(self, no_lm, splits):
        lp = random_log_probs(40, C, seed=0)
        tokens, counts = beam_search_decode_pallas_frames(
            jnp.asarray(lp[None]), jnp.asarray([lp.shape[0]]), blank=BLANK, beam_width=W,
            max_decoded_length=64, prune_classes=C)
        offline = np.asarray(tokens)[0][: int(counts[0])]
        np.testing.assert_array_equal(stream(no_lm[0], lp, splits)[1].tokens, offline)

    def test_matches_the_jax_xla_decoder(self, no_lm):
        lp = random_log_probs(40, C, seed=1)
        xla = JaxXlaDecoder(blank=BLANK, beam_width=W, max_decoded_length=64,
                            chunk_frames=16, prune_classes=C)
        assert_same_result(stream(no_lm[0], lp, [11])[1], stream(xla, lp, [11])[1])

    def test_empty_feed_keeps_best(self, no_lm):
        ours = no_lm[0]
        state, result = stream(ours, random_log_probs(24, C, seed=2), [])
        _, again = ours.feed(state, np.zeros((0, C), np.float32))
        assert_same_result(again, result)

    def test_feed_batch_matches_sequential(self, no_lm):
        ours = no_lm[0]
        lps = [random_log_probs(30 + 7 * i, C, seed=10 + i) for i in range(2)]
        lps.append(np.zeros((0, C), np.float32))  # a zero-length row is a no-op
        sequential = [ours.feed(ours.init_state(), lp)[1] for lp in lps]
        batched = ours.feed_batch([ours.init_state() for _ in lps], lps)
        for (_, got), want in zip(batched, sequential):
            assert_same_result(got, want)

    def test_rollover_matches_jax(self):
        """At 16 graphemes of buffer and 4-frame chunks the stream rolls over many
        times: committed prefix, its score and the result equal the JAX decoder's."""
        kwargs = dict(blank=BLANK, beam_width=W, max_decoded_length=16, chunk_frames=4,
                      prune_classes=C)
        lp = random_log_probs(120, C, seed=7)
        state, result = stream(KernelBeamStreamDecoder(device="cpu", **kwargs), lp, [9, 50])
        want_state, want = stream(JaxXlaDecoder(**kwargs), lp, [9, 50])
        assert state.committed.size > 16
        np.testing.assert_array_equal(state.committed, want_state.committed)
        np.testing.assert_allclose(state.committed_score, want_state.committed_score,
                                   rtol=RTOL)
        assert_same_result(result, want)

    def test_rollover_rows_in_feed_batch_match_sequential(self):
        ours = KernelBeamStreamDecoder(blank=BLANK, beam_width=W, max_decoded_length=16,
                                       chunk_frames=4, prune_classes=C, device="cpu")
        lps = [random_log_probs(frames, C, seed=20 + frames) for frames in (37, 3, 22)]
        sequential = [ours.feed(ours.init_state(), lp) for lp in lps]
        for (got_state, got), (want_state, want) in zip(
                ours.feed_batch([ours.init_state() for _ in lps], lps), sequential):
            np.testing.assert_array_equal(got_state.committed, want_state.committed)
            assert_same_result(got, want)

    def test_a_jax_stream_continues_in_the_port(self, no_lm):
        ours, theirs = no_lm
        lp = random_log_probs(40, C, seed=3)
        jax_state, _ = stream(theirs, lp[:13], [5])
        state = BeamStreamState(tuple(leaf[0] for leaf in
                                      state_from_jax([jax_state.beam], device="cpu")),
                                jax_state.committed, jax_state.committed_score)
        _, got = stream(ours, lp[13:], [10], state=state)
        assert_same_result(got, stream(theirs, lp, [5, 13, 23])[1])


@pytest.mark.parametrize("count", [0, 9, 16])
def test_one_advance_matches_the_jax_stream_core(no_lm, count):
    """A JAX stream carried 21 frames in, converted by `state_from_jax`, then one
    chunk advanced by both packages: every leaf of the new state (the stitched token
    buffer included), the best row and the scalars agree. ``count=0`` is a no-op."""
    jax_decoder = no_lm[1]  # its compiled advance is reused below
    state, _ = jax_decoder.feed(jax_decoder.init_state(), random_log_probs(21, C, seed=4))
    piece = random_log_probs(16, C, seed=5)
    if count < 16:
        piece[count:] = 0.0
    want_states, want_row, want_scalars = _pallas_stream_step_impl(
        (state.beam,), jnp.asarray(piece[None]), jnp.asarray([count], jnp.int32), BLANK,
        W, 64, None, None, 0.8, 0.0, 2.3, C)
    stacked = state_from_jax([state.beam], device="cpu")
    got_state, got_row, got_scalars = stream_advance(
        stacked, torch.from_numpy(piece[None]), np.asarray([count]), blank=BLANK,
        beam_width=W, max_decoded_length=64, prune_classes=C)
    for got, want in zip(got_state, want_states[0]):
        want = np.asarray(want)
        assert got[0].numpy().dtype == want.dtype
        if want.dtype == np.int32:
            np.testing.assert_array_equal(got[0].numpy(), want)
        else:
            np.testing.assert_allclose(got[0].numpy(), want, rtol=1e-5)
    np.testing.assert_array_equal(got_row[0].numpy(), np.asarray(want_row[0]))
    np.testing.assert_array_equal(got_scalars[0, [0, 2]].numpy(),
                                  np.asarray(want_scalars[0])[[0, 2]])
    np.testing.assert_allclose(float(got_scalars[0, 1]), float(want_scalars[0][1]),
                               rtol=1e-5)
    if count == 0:
        np.testing.assert_array_equal(got_state[-1].numpy(), stacked[-1].numpy())


@pytest.mark.parametrize("count", [7, 16])
def test_one_word_lm_advance_matches_the_jax_stream_core(with_lm, count):
    """With the word LM: a JAX stream carried 21 frames in, then one chunk through the
    port's span (`lm_span`, whose CPU path is `lm_span_reference`) and through the JAX
    stream core. The carry after the chunk (trie nodes and word contexts included), the
    stitched token buffer, the best row and the scalars agree."""
    ours, theirs = with_lm
    state, _ = theirs.feed(theirs.init_state(), random_log_probs(21, BLANK_LM + 1, seed=6))
    piece = random_log_probs(16, BLANK_LM + 1, seed=7)
    piece[count:] = 0.0
    want_states, want_row, want_scalars = theirs._dispatch(
        (state.beam,), piece[None], np.asarray([count], np.int32))
    got_state, got_row, got_scalars = stream_advance(
        state_from_jax([state.beam], device="cpu"), torch.from_numpy(piece[None]),
        np.asarray([count]), blank=BLANK_LM, beam_width=W, max_decoded_length=64,
        word_lm=ours.word_lm, prune_classes=8)
    assert len(got_state) == 9  # pb, pnb, hash, last, len, lm, trie, context, tokens
    for got, want in zip(got_state, want_states[0]):
        want = np.asarray(want)
        assert got[0].numpy().dtype == want.dtype
        if want.dtype == np.int32:
            np.testing.assert_array_equal(got[0].numpy(), want)
        else:
            np.testing.assert_allclose(got[0].numpy(), want, rtol=1e-5)
    np.testing.assert_array_equal(got_row[0].numpy(), np.asarray(want_row[0]))
    np.testing.assert_array_equal(got_scalars[0, [0, 2]].numpy(),
                                  np.asarray(want_scalars[0])[[0, 2]])


class TestWordLm:
    @pytest.mark.parametrize("splits", [[], [5, 13, 30], [16, 32]])
    def test_matches_the_jax_pallas_decoder(self, with_lm, splits):
        ours, theirs = with_lm
        lp = random_log_probs(48, BLANK_LM + 1, seed=3)
        assert_same_result(stream(ours, lp, splits)[1], stream(theirs, lp, splits)[1])

    def test_chunked_equals_offline(self, with_lm, word_lms):
        lp = random_log_probs(48, BLANK_LM + 1, seed=3)
        tokens, counts = beam_search_decode_pallas_lm(
            jnp.asarray(lp[None]), jnp.asarray([lp.shape[0]]), blank=BLANK_LM,
            word_lm=word_lms[1], beam_width=W, max_decoded_length=64, prune_classes=8)
        np.testing.assert_array_equal(stream(with_lm[0], lp, [9, 31])[1].tokens,
                                      np.asarray(tokens)[0][: int(counts[0])])

    def test_matches_the_jax_xla_decoder(self, with_lm, word_lms):
        lp = random_log_probs(48, BLANK_LM + 1, seed=4)
        xla = JaxXlaDecoder(blank=BLANK_LM, beam_width=W, max_decoded_length=64,
                            chunk_frames=16, word_lm=word_lms[1], prune_classes=8)
        assert_same_result(stream(with_lm[0], lp, [5])[1], stream(xla, lp, [5])[1])

    def test_feed_batch_and_a_continued_jax_stream(self, with_lm):
        ours, theirs = with_lm
        lps = [random_log_probs(frames, BLANK_LM + 1, seed=frames) for frames in (30, 0, 17)]
        sequential = [ours.feed(ours.init_state(), lp)[1] for lp in lps]
        for (_, got), want in zip(ours.feed_batch([ours.init_state() for _ in lps], lps),
                                  sequential):
            assert_same_result(got, want)
        lp = random_log_probs(48, BLANK_LM + 1, seed=3)
        jax_state, _ = stream(theirs, lp[:21], [])
        state = BeamStreamState(tuple(leaf[0] for leaf in
                                      state_from_jax([jax_state.beam], device="cpu")),
                                jax_state.committed, jax_state.committed_score)
        assert_same_result(stream(ours, lp[21:], [], state=state)[1],
                           stream(theirs, lp, [21])[1])


class TestDecoderConstruction:
    def test_refusals_and_defaults(self):
        assert KernelBeamStreamDecoder(blank=BLANK, prune_classes=None,
                                       device="cpu").prune_classes == 8
        with pytest.raises(ValueError, match="chunk_frames"):
            KernelBeamStreamDecoder(blank=BLANK, chunk_frames=65, max_decoded_length=64,
                                    device="cpu")
        with pytest.raises(ValueError, match="chunk_frames"):
            KernelBeamStreamDecoder(blank=BLANK, chunk_frames=0, device="cpu")
        # No TPU lane cap: 120 classes + 2*8 pruned decode.
        wide = KernelBeamStreamDecoder(blank=119, beam_width=4, chunk_frames=8,
                                       device="cpu")
        assert wide.feed(wide.init_state(), random_log_probs(9, 120, seed=5))[1].score < 0

    def test_the_default_device_is_the_card(self):
        """Built without ``device``, the decoder targets CUDA (constructing it touches
        no GPU); `beam_decoder_for` takes the transcriber's device, with no fallback."""
        assert KernelBeamStreamDecoder(blank=BLANK).device.type == "cuda"
        assert beam_decoder_for(TestRouting.fake(device=torch.device("cuda", 1))).device \
            == torch.device("cuda", 1)
        without_device = TestRouting.fake()
        del without_device.device
        with pytest.raises(AttributeError):
            beam_decoder_for(without_device)

    def test_feeds_must_be_frames_by_classes(self, no_lm):
        ours = no_lm[0]
        with pytest.raises(ValueError, match="frames, classes"):
            ours.feed(ours.init_state(), np.zeros(C, np.float32))
        with pytest.raises(ValueError, match="class count"):
            ours.feed_batch([ours.init_state()] * 2,
                            [np.zeros((3, C), np.float32), np.zeros((3, C + 1), np.float32)])

    def test_shared_decoder_counts_every_feed(self, no_lm):
        """Threads sharing one decoder lose no counts (the counters take a lock)."""
        ours = no_lm[0]
        feeds, pieces = ours.stat_feeds, ours.stat_piece_rounds
        empty = np.zeros((0, C), np.float32)

        def worker():
            for _ in range(25):
                ours.feed(ours.init_state(), empty)

        threads = [threading.Thread(target=worker) for _ in range(4)]
        interval = sys.getswitchinterval()
        sys.setswitchinterval(1e-6)  # switch threads often: a lost update would show
        try:
            for thread in threads:
                thread.start()
            for thread in threads:
                thread.join(timeout=120)
        finally:
            sys.setswitchinterval(interval)
        assert not any(thread.is_alive() for thread in threads)
        assert ours.stat_feeds - feeds == 100 and ours.stat_piece_rounds - pieces == 100


class TestRouting:
    @staticmethod
    def fake(**overrides):
        base = dict(blank_index=BLANK, _decoder={"beam_width": W, "prune_classes": C},
                    word_lm=None, lexicon_constrained=False, device=torch.device("cpu"))
        base.update(overrides)
        return types.SimpleNamespace(**base)

    def test_the_kernel_decoder_takes_the_transcriber_configuration(self):
        decoder = beam_decoder_for(self.fake())
        assert isinstance(decoder, KernelBeamStreamDecoder)
        assert (decoder.chunk_frames, decoder.max_decoded_length) == (32, 512)
        assert (decoder.blank, decoder.beam_width, decoder.prune_classes) == (BLANK, W, C)
        assert decoder.device == torch.device("cpu")

    def test_unexpressible_configurations_raise(self, word_lms):
        """The kernel decoder refuses a lexicon-constrained or unpruned search; the
        default route sends both to the plain-step decoder instead."""
        for fake in (self.fake(lexicon_constrained=True, word_lm=word_lms[0]),
                     self.fake(_decoder={"beam_width": W, "prune_classes": None})):
            with pytest.raises(ValueError, match="engine='xla'"):
                beam_decoder_for(fake, engine="pallas")
            assert isinstance(beam_decoder_for(fake), BeamStreamDecoder)


@pytest.mark.parametrize("seed", range(3))
def test_collapse_and_words_match_jax(seed):
    rng = np.random.default_rng(seed)
    blank, spf = len(ALPHABET), 256
    frames = rng.integers(0, blank + 1, 300)
    frames[rng.random(300) < 0.4] = blank
    frames[rng.random(300) < 0.1] = ALPHABET.index(" ")
    ours, theirs = (WordAssembler(CtcGraphemeCodec(ALPHABET), spf),
                    JaxWordAssembler(JaxCodec(ALPHABET), spf))
    state = state_jax = (0, -1)
    for start in range(0, 300, 37):
        args = (frames[start:start + 60], 60, start * spf, spf)
        limit = (start + 50) * spf
        got = collapse_new_frames(*args, *state, limit, blank)
        want = jax_collapse(*args, *state_jax, limit, blank)
        assert got == want
        state, state_jax = got[1:], want[1:]
        for token, at in got[0]:
            ours.push(token, at)
            theirs.push(token, at)
        assert ours.pop_new_words() == theirs.pop_new_words()
    ours.flush()
    theirs.flush()
    assert ours.pop_new_words() == theirs.pop_new_words()


# ---- pools and HTTP, with the tiny bridged model of test_torch_serving -------------
WINDOW = dict(window_s=1.0, margin_s=0.25)
MODES = [("greedy", False), ("beam", False), ("beam_pipelined", False), ("greedy", True)]


@pytest.fixture(scope="module")
def port_transcriber(setup):  # noqa: F811
    config, params, lm_directory = setup
    return Transcriber(config, params, ALPHABET, device="cpu", kenlm_directory=lm_directory,
                       beam_width=8, sample_buckets=(16384,))


@pytest.fixture(scope="module")
def stream_audios():
    return [_audio(2.4, 40), _audio(1.7, 41)]


def test_frame_batches_match_single_windows_and_jax(setup, port_transcriber,  # noqa: F811
                                                    stream_audios):
    windows = [stream_audios[0][:15872], stream_audios[1][:9000], stream_audios[0][:300]]
    got = port_transcriber.frame_log_probs_batch(windows, batch_size=2)
    tokens = port_transcriber.frame_tokens_batch(windows, batch_size=2)
    want = _jax_transcriber(setup, kenlm=False).frame_tokens_batch(windows, batch_size=2)
    for window, log_probs, frame_tokens, jax_tokens in zip(windows, got, tokens, want):
        np.testing.assert_allclose(log_probs, port_transcriber.frame_log_probs(window),
                                   atol=1e-5, rtol=0)
        np.testing.assert_array_equal(frame_tokens, jax_tokens)
    assert port_transcriber.supports_posteriors


def _drive(pool, audio, sessions, chunk=4000):
    """Feed ``audio`` in ``chunk``-sample pieces (0.25 s) to each session in turn, then
    finish them: the feed replies of the synchronous sessions and every finish reply."""
    replies = {sid: [] for sid in sessions}
    for start in range(0, len(audio), chunk):
        for sid, (mode, _) in sessions.items():
            reply = pool.feed_with_state(sid, audio[start:start + chunk])
            if mode != "beam_pipelined":  # pipelined partials depend on thread timing
                replies[sid].append(reply)
    for sid in sessions:
        replies[sid].append(pool.finish_with_state(sid))
    return [json.dumps(replies[sid], sort_keys=True) for sid in sessions]


def test_session_pool_matches_the_jax_pool(setup, port_transcriber,  # noqa: F811
                                           stream_audios):
    """Greedy, beam, pipelined beam and two-pass sessions fed the same chunks: every
    partial, word and final of the port's pool is byte-equal to the JAX pool's."""
    pools = (StreamingSessionPool(port_transcriber, max_wait_ms=1.0, **WINDOW),
             JaxPool(_jax_transcriber(setup, kenlm=True), max_wait_ms=1.0, **WINDOW))
    results = []
    for pool in pools:
        pool.start()
        try:
            sessions = {pool.create(partial_decode=mode, final_decode=final):
                        (mode, final) for mode, final in MODES}
            results.append(_drive(pool, stream_audios[0], sessions))
        finally:
            pool.stop()
    assert results[0] == results[1]
    finals = [json.loads(r)[-1] for r in results[0]]
    assert finals[1]["text"] == finals[2]["text"]  # pipelined ends where beam ends
    assert finals[3]["text"] == port_transcriber.transcribe_audio(stream_audios[0])
    assert all(f["text"] for f in finals)


def test_concurrent_beam_sessions_batch_their_advances(port_transcriber, stream_audios):
    """Sessions fed from threads share batched advances and end where sequential
    sessions end."""
    pool = StreamingSessionPool(port_transcriber, max_wait_ms=30.0, **WINDOW)
    pool.start()
    try:
        sessions = {pool.create(partial_decode="beam"): audio
                    for audio in stream_audios + stream_audios[::-1]}
        finals = {}

        def run(sid, audio):
            for start in range(0, len(audio), 4000):
                pool.feed(sid, audio[start:start + 4000])
            finals[sid] = pool.finish(sid)

        threads = [threading.Thread(target=run, args=item) for item in sessions.items()]
        for thread in threads:
            thread.start()
        for thread in threads:
            thread.join(timeout=300)
        sequential = {}
        for sid, audio in list(sessions.items())[:2]:
            alone = pool.create(partial_decode="beam")
            for start in range(0, len(audio), 4000):
                pool.feed(alone, audio[start:start + 4000])
            sequential[sid] = pool.finish(alone)
        assert pool.beam_batcher.metrics()["mean_batch_size"] > 1.0
    finally:
        pool.stop()
    sids = list(sessions)
    assert [finals[s] for s in sids] == [sequential[sids[0]], sequential[sids[1]],
                                         sequential[sids[1]], sequential[sids[0]]]


def test_http_stream_routes(port_transcriber, stream_audios):
    server = TranscriptionServer(port_transcriber, port=0, max_batch=4, max_wait_ms=5.0,
                                 stream_window_s=1.0, stream_margin_s=0.25)
    server.start()
    try:
        status, created = _request(server.port, "/v1/stream", b'{"partial_decode": "beam"}')
        assert status == 200
        sid = created["session"]
        assert _request(server.port, "/healthz")[1]["streaming_sessions"] == 1
        audio = stream_audios[1]
        for start in range(0, len(audio), 4000):
            chunk = audio[start:start + 4000]
            status, reply = _request(server.port, "/v1/stream/" + sid,
                                     chunk.astype("<f4").tobytes(),
                                     "application/octet-stream")
            assert status == 200 and set(reply) == {"partial", "text", "final_up_to_s",
                                                    "words"}
        status, final = _request(server.port, "/v1/stream/{}/finish".format(sid), b"")
        assert status == 200 and final["text"] and final["final_up_to_s"] > 1.6
        direct = StreamingSessionPool(port_transcriber, **WINDOW)
        direct.start()
        try:
            alone = direct.create(partial_decode="beam")
            for start in range(0, len(audio), 4000):
                direct.feed(alone, audio[start:start + 4000])
            assert final["text"] == direct.finish(alone)
        finally:
            direct.stop()
        status, metrics = _request(server.port, "/v1/metrics")
        assert status == 200 and "windows" in metrics["streaming"]
        request = urllib.request.Request(
            "http://127.0.0.1:{}/v1/stream".format(server.port), method="POST")
        with urllib.request.urlopen(request, timeout=60) as response:  # a bare POST
            assert response.status == 200 and json.loads(response.read())["session"]
        assert _request(server.port, "/v1/stream/nope", b'{"pcm": [0.1]}')[0] == 404
        assert _request(server.port, "/v1/stream/nope/finish", b"")[0] == 404
        assert _request(server.port, "/v1/stream/" + sid + "/finish", b"")[0] == 404
        assert _request(server.port, "/v1/stream", b"[1, 2]")[0] == 400
        assert _request(server.port, "/v1/stream", b'{"partial_decode": "x"}')[0] == 400
    finally:
        server.stop()

    class NoPosteriors:
        supports_posteriors = False

        def __getattr__(self, name):
            return getattr(port_transcriber, name)

    server = TranscriptionServer(NoPosteriors(), port=0)
    server.start()
    try:
        assert _request(server.port, "/v1/stream", b'{"partial_decode": "beam"}')[0] == 501
    finally:
        server.stop()


REFUSALS = {("--beam-mode", "resident"): "--beam-mode resident needs --device-streams",
            ("--device-streams", "--kenlm", "lm", "--lexicon", "--beam-engine", "pallas"):
            "--beam-engine pallas has no lexicon constraint"}


@pytest.mark.parametrize("flags", [list(flags) for flags in REFUSALS])
def test_cli_refuses_device_streams_before_loading(flags, capsys):
    """Flag combinations the stream pools cannot serve exit with a usage error before
    any weights load (the checkpoint does not exist)."""
    from speechless_tpu_torch.__main__ import main

    with pytest.raises(SystemExit) as exited:
        main(["serve", "--checkpoint", "no-such-checkpoint.npz", "--device", "cpu"] + flags)
    assert exited.value.code == 2
    assert REFUSALS[tuple(flags)] in capsys.readouterr().err
