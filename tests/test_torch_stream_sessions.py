"""The session rules that the host pool (`StreamingSessionPool`) and the device pool
(`DeviceStreamingPool`) share through `serving_streaming.SessionPool` and
`StreamSession`, each case run on both pools on the CPU: the session limit, close and
idle reaping (never of a session whose lock is held), a failed pipelined advance, and
the keys of the feed and finish replies."""
import time

import pytest

from speechless_tpu_torch.models import wav2letter as w2l
from speechless_tpu_torch.serving import Transcriber
from speechless_tpu_torch.serving_device_stream import DeviceStreamingPool
from speechless_tpu_torch.serving_streaming import StreamingSessionPool, UnknownSessionError
from test_torch_serving import ALPHABET, LAYERS, _audio

KINDS = ["host", "device"]
FEED_KEYS = {"partial", "text", "final_up_to_s", "words"}
FINISH_KEYS = {"text", "live_text", "words", "final_up_to_s"}


@pytest.fixture(scope="module")
def transcriber():
    """The tiny model of `test_torch_serving`, without a word LM."""
    config = w2l.Wav2LetterConfig(128, len(ALPHABET) + 1, layers=LAYERS)
    params = w2l.init_params(config, seed=11)
    params[-1]["w"] = params[-1]["w"] * 10.0  # peaky frames
    return Transcriber(config, params, ALPHABET, device="cpu", beam_width=8,
                       sample_buckets=(16384,))


def make_pool(kind, transcriber, **options):
    if kind == "host":
        pool = StreamingSessionPool(transcriber, window_s=1.0, margin_s=0.25,
                                    max_wait_ms=1.0, **options)
    else:
        pool = DeviceStreamingPool(transcriber, window_s=1.024, margin_s=0.25,
                                   max_batch=4, chunk_cap_s=0.5, max_wait_ms=1.0,
                                   **options)
    pool.start()
    return pool


@pytest.mark.parametrize("kind", KINDS)
def test_limit_close_and_reaping(kind, transcriber):
    """The session limit; `UnknownSessionError` after a close and after an idle reap;
    a session whose lock is held outlives the timeout; every slot comes back."""
    pool = make_pool(kind, transcriber, max_sessions=2, idle_timeout_s=0.3)
    try:
        closed, held = pool.create(), pool.create()
        with pytest.raises(RuntimeError, match="session limit"):
            pool.create()
        pool.close(closed)
        with pytest.raises(UnknownSessionError):
            pool.feed(closed, _audio(0.1, 1))
        idle = pool.create()
        with pool._get(held).lock:  # a feed or finish in progress
            time.sleep(0.4)
            fresh = pool.create()  # reaps the idle session only
            with pytest.raises(UnknownSessionError):
                pool.text(idle)
            assert pool.text(held) == "" and pool.session_count == 2
        for sid in (held, fresh):
            pool.close(sid)
        sids = [pool.create() for _ in range(2)]
        assert pool.session_count == 2 and len(set(sids)) == 2
    finally:
        pool.stop()


@pytest.mark.parametrize("kind", KINDS)
def test_failed_pipelined_advance_loses_the_session(kind, transcriber):
    """An advance that raises surfaces in the session's feed or finish; from then on
    every feed and finish raises "stream lost", and a device session's row is free at
    once, before the session is closed."""
    pool = make_pool(kind, transcriber, max_sessions=2)
    try:
        sid = pool.create(partial_decode="beam_pipelined")

        def failing_serve(batch):
            raise RuntimeError("advance failed")

        pool.beam_batcher._serve = failing_serve
        audio = _audio(1.5, 2)
        with pytest.raises(RuntimeError, match="advance failed"):
            for start in range(0, len(audio), 8000):
                pool.feed(sid, audio[start:start + 8000])
            pool.finish(sid)
        with pytest.raises(RuntimeError, match="stream lost"):
            pool.feed(sid, audio[:4000])
        with pytest.raises(RuntimeError, match="stream lost"):
            pool.finish(sid)
        if kind == "device":
            assert sorted(pool._free) == [0, 1]
        pool.close(sid)
        assert pool.session_count == 0
        if kind == "device":
            assert sorted(pool._free) == [0, 1]  # freed once
    finally:
        pool.stop()


@pytest.mark.parametrize("kind", KINDS)
def test_replies_have_the_same_keys(kind, transcriber):
    """Feed and finish replies carry the same keys on both pools; a finished beam
    session is final up to the stream's duration."""
    pool = make_pool(kind, transcriber)
    audio = _audio(0.75, 3)
    try:
        for mode in ("greedy", "beam"):
            sid = pool.create(partial_decode=mode)
            assert set(pool.feed_with_state(sid, audio)) == FEED_KEYS
            final = pool.finish_with_state(sid)
            assert set(final) == FINISH_KEYS
            assert final["final_up_to_s"] == pytest.approx(len(audio) / 16000, abs=0.02)
        assert final["final_up_to_s"] == round(len(audio) / 16000, 3)  # the beam's
    finally:
        pool.stop()
