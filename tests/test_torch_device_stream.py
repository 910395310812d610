"""The port's device-resident streaming pool on the CPU
(`speechless_tpu_torch.serving_device_stream.DeviceStreamingPool`): the window
arithmetic against the JAX package's, sessions of every mode against the JAX
`DeviceStreamingPool` (same weights, LM and audio; short and long streams, oversized
chunks, concurrent sessions), the resident beam against the posterior sync beam, the
pool's lifecycle (row reuse, reaping, a failed dispatch, the sink row), and the HTTP
routes with ``device_streams=True``.

Tolerances: partials, words and finals byte-equal (JSON) to the JAX pool's; the
resident mode's finals and words byte-equal to the posterior mode's sync beam.
"""
import json
import socket
import threading
import time

import numpy as np
import pytest
import torch

from speechless_tpu.serving_device_stream import DeviceStreamingPool as JaxPool
from speechless_tpu.serving_device_stream import _window_frames as jax_window_frames
from speechless_tpu.serving_device_stream import mirror_append as jax_mirror_append
from speechless_tpu.serving_device_stream import quantize_pool_dims as jax_quantize
from speechless_tpu_torch.serving import Transcriber
from speechless_tpu_torch.serving_device_stream import (_NO_EMIT_LIMIT, DEFAULT_POST_ROWS,
                                                        DeviceStreamingPool,
                                                        _check_post_rows, _window_frames,
                                                        mirror_append, quantize_pool_dims)
from speechless_tpu_torch.serving_http import TranscriptionServer
from speechless_tpu_torch.serving_streaming import UnknownSessionError
from test_torch_serving import ALPHABET, _audio, _jax_transcriber, _request
from test_torch_serving import setup  # noqa: F401 (the module fixture)
from test_torch_streaming import MODES, _drive
from torch_tmp import delete_tmp_path  # noqa: F401 (full-width files)

# window_s=1.024 makes the pooled window the transcriber's 16384-sample bucket.
POOL = dict(window_s=1.024, margin_s=0.25, max_batch=4, chunk_cap_s=0.5, max_sessions=8)


@pytest.fixture(scope="module")
def port_transcriber(setup):  # noqa: F811
    config, params, lm_directory = setup
    return Transcriber(config, params, ALPHABET, device="cpu", kenlm_directory=lm_directory,
                       beam_width=8, sample_buckets=(16384,))


@pytest.fixture(scope="module")
def jax_pool(setup):  # noqa: F811
    """One JAX pool for the module: its feed and advance programs compile once."""
    pool = JaxPool(_jax_transcriber(setup, kenlm=True), max_wait_ms=1.0, **POOL)
    pool.start()
    yield pool
    pool.stop()


def make_pool(transcriber, **overrides):
    pool = DeviceStreamingPool(transcriber, **dict(POOL, max_wait_ms=1.0, **overrides))
    pool.start()
    return pool


@pytest.fixture()
def pool(port_transcriber):
    pool = make_pool(port_transcriber)
    yield pool
    pool.stop()


def transcribe(pool, audio, chunk=4000, mode="beam"):
    session = pool.create_stream(partial_decode=mode)
    return session.transcribe_stream(audio, chunk), session


def test_pool_arithmetic_matches_jax(setup, port_transcriber):  # noqa: F811
    """Pool dimensions, the host mirror of the append, the window's frame count (from
    the conv arithmetic, against JAX's traced shape and the model's output) and the
    posterior block clamp."""
    jax_transcriber = _jax_transcriber(setup, kenlm=False)
    spf = port_transcriber.samples_per_frame
    for window_s, cap_s in ((1.024, 0.5), (8.0, 1.0), (0.3, 0.01), (2.5, 0.77)):
        window, cap = quantize_pool_dims(spf, window_s, cap_s)
        assert (window, cap) == jax_quantize(spf, window_s, cap_s)
        frames = _window_frames(port_transcriber.config, window)
        assert frames == jax_window_frames(jax_transcriber.config, jax_transcriber.params,
                                           window)
        with torch.no_grad():
            features = torch.zeros((1, 1 + window // 128, 128))
            assert port_transcriber.model(features).shape[1] == frames
        assert _check_post_rows(DEFAULT_POST_ROWS, frames) == min(40, frames)
    with pytest.raises(ValueError, match="post_rows"):
        _check_post_rows(11, 100)
    rng = np.random.default_rng(0)
    length = jax_length = 0
    for _ in range(200):
        chunk, reset = int(rng.integers(0, 9000)), bool(rng.random() < 0.1)
        got = mirror_append(length, chunk, 16384, spf, reset)
        assert got == jax_mirror_append(jax_length, chunk, 16384, spf, reset)
        length = jax_length = got[0]


def test_device_window_matches_numpy_mirror(pool):
    """After feeds of arbitrary sizes the session's device row holds exactly the
    trailing window the host mirror predicts, its start on the frame grid."""
    session = pool.create_stream()
    fed = np.zeros(0, np.float32)
    length = 0
    rng = np.random.default_rng(1)
    for i in range(7):
        chunk = _audio(int(rng.integers(100, pool.chunk_cap + 1)) / 16000, 10 + i)
        session.feed(chunk)
        fed = np.concatenate([fed, chunk])
        length, _ = mirror_append(length, len(chunk), pool.window, pool.spf)
    assert session._length == length and (len(fed) - length) % pool.spf == 0
    row = pool._buffers[session._row].numpy()
    np.testing.assert_array_equal(row[:length], fed[len(fed) - length:])
    np.testing.assert_array_equal(row[length:], 0.0)
    assert int(pool._lengths[session._row]) == length
    session.finish()


@pytest.mark.parametrize("seconds, chunk", [(0.75, 4000), (2.5, 4000), (2.0, 12000)],
                         ids=["short", "long", "oversized_chunks"])
def test_sessions_match_the_jax_pool(port_transcriber, jax_pool, seconds, chunk):
    """Greedy, beam, pipelined beam and two-pass sessions fed the same chunks (a stream
    under one window; one past several window drops; chunks over ``chunk_cap``, which
    split into several dispatches): every partial, word and final byte-equal to the JAX
    pool's."""
    audio = _audio(seconds, 40)
    results = []
    pool = make_pool(port_transcriber)
    try:
        for each in (pool, jax_pool):
            sessions = {each.create(partial_decode=mode, final_decode=final):
                        (mode, final) for mode, final in MODES}
            results.append(_drive(each, audio, sessions, chunk))
    finally:
        pool.stop()
    ours, theirs = ([json.loads(r) for r in result] for result in results)
    for replies, jax_replies in zip(ours, theirs):
        # The port's finish reply adds the host pool's final_up_to_s, which the JAX
        # device pool leaves out: compare the JAX pool's keys.
        assert set(replies[-1]) - set(jax_replies[-1]) == {"final_up_to_s"}
        replies[-1] = {key: replies[-1][key] for key in jax_replies[-1]}
    assert ours == theirs
    finals = [json.loads(r)[-1] for r in results[0]]
    assert finals[1]["text"] == finals[2]["text"]  # pipelined ends where beam ends
    assert finals[3]["text"] == port_transcriber.transcribe_long_audio(audio)
    assert all(f["text"] for f in finals)


def test_concurrent_sessions_match_the_jax_pool(pool, jax_pool):
    """Four threads feeding one pool share dispatches and advances, and end where the
    JAX pool's sequential sessions end."""
    audios = [_audio(seconds, 50 + i) for i, seconds in enumerate((1.9, 2.8, 3.2, 2.4))]
    modes = ["greedy", "beam", "greedy", "beam"]
    expected = [transcribe(jax_pool, audio, mode=mode)[0]
                for audio, mode in zip(audios, modes)]
    results = [None] * len(audios)

    def run(i):
        results[i] = transcribe(pool, audios[i], mode=modes[i])[0]

    threads = [threading.Thread(target=run, args=(i,)) for i in range(len(audios))]
    for thread in threads:
        thread.start()
    for thread in threads:
        thread.join(timeout=300)
    assert not any(thread.is_alive() for thread in threads)
    assert results == expected
    assert pool.batcher.batches < pool.batcher.items  # some feeds shared a dispatch


def test_row_reuse_and_session_surface(pool):
    """A finished session's row goes to the next session, which does not see the old
    audio; the pool surface, unknown sessions and the session limit."""
    audio = _audio(1.5, 5)
    first_text, first = transcribe(pool, audio, mode="greedy")
    again_text, again = transcribe(pool, audio, mode="greedy")
    assert again._row == first._row and again_text == first_text
    sid = pool.create()
    partial, text, final_up_to_s = pool.feed_with_text(sid, audio[:9000])
    assert text.endswith(partial) and pool.text(sid) == text
    assert 0.0 <= final_up_to_s <= 9000 / 16000.0
    assert pool.finish(sid).startswith(text)
    with pytest.raises(UnknownSessionError):
        pool.feed(sid, audio[:100])
    with pytest.raises(UnknownSessionError):
        pool.finish("nope")
    sids = [pool.create() for _ in range(pool.max_sessions)]
    with pytest.raises(RuntimeError, match="session limit"):
        pool.create()
    for sid in sids:
        pool.close(sid)
    assert sorted(pool._free) == list(range(pool.max_sessions))


def test_idle_sessions_are_reaped(port_transcriber):
    """A session fed past the idle timeout survives; an idle one is reaped and its row
    freed."""
    pool = make_pool(port_transcriber, max_sessions=2, idle_timeout_s=0.4)
    try:
        session = pool.create_stream()
        for _ in range(4):
            time.sleep(0.15)
            session.feed(_audio(0.125, 30))
        pool.close(pool.create())  # runs the reaper
        assert not session._finished and session._row not in pool._free
        time.sleep(0.6)
        pool.create()
        assert session._finished and pool.session_count == 1
    finally:
        pool.stop()


def test_failed_dispatch_poisons_sessions_and_pool_recovers(port_transcriber):
    """A failing dispatch fails its feed, retires every live session ("stream lost"),
    resets the pooled tensors, and new sessions serve as before."""
    pool = make_pool(port_transcriber, max_sessions=2)
    try:
        audio = _audio(1.25, 31)
        expected = transcribe(pool, audio, mode="greedy")[0]
        session = pool.create_stream()
        session.feed(audio[:4000])
        real_feed = pool._feed

        def exploding_feed(*args, **kwargs):
            raise RuntimeError("device lost")

        pool._feed = exploding_feed
        with pytest.raises(RuntimeError, match="device lost"):
            session.feed(audio[4000:8000])
        pool._feed = real_feed
        with pytest.raises(RuntimeError, match="stream lost"):
            session.feed(audio[:2000])
        with pytest.raises(RuntimeError, match="stream lost"):
            session.finish()
        assert not pool._buffers.any() and not pool._lengths.any()
        assert transcribe(pool, audio, mode="greedy")[0] == expected
    finally:
        pool.stop()


def test_sliced_posteriors_match_full_window(port_transcriber):
    """Beam feeds that read back a 16-row posterior block (its offset computed on the
    host before the dispatch) give the transcripts of the whole window's posteriors at
    the same feed cadence, through the multi-window flush drain."""
    audio = _audio(2.0, 90)
    texts = {}
    chunk = None
    for post_rows in (16, None):
        pool = make_pool(port_transcriber, post_rows=post_rows)
        try:
            if post_rows is not None:
                assert pool.post_rows == 16 and pool.beam_piece_cap == 8 * pool.spf
                chunk = pool.beam_piece_cap
            for mode in ("beam", "beam_pipelined"):
                text, session = transcribe(pool, audio, chunk, mode)
                texts.setdefault(mode, []).append((text, session.greedy_text))
        finally:
            pool.stop()
    for runs in texts.values():
        assert runs[0] == runs[1] and runs[0][0]


@pytest.mark.parametrize("beam_mode", ["posterior", "resident"])
def test_the_sink_row_is_never_read(port_transcriber, beam_mode):
    """NaN in the sink row's window and carries changes no transcript: the sink takes
    only warm-up feeds, and no dispatch writes one row twice."""
    audio = _audio(2.0, 8)
    clean = make_pool(port_transcriber, beam_mode=beam_mode)
    try:
        expected = [transcribe(clean, audio)[0], transcribe(clean, audio, mode="greedy")[0]]
    finally:
        clean.stop()
    pool = make_pool(port_transcriber, beam_mode=beam_mode)
    sink = pool.max_sessions
    try:
        pool._buffers[sink] = float("nan")
        pool._lengths[sink] = 12345
        for leaf in pool._beam_pool or []:
            leaf[sink] = (float("nan") if leaf.dtype.is_floating_point else 7)
        dispatched = []
        real_feed = pool._feed

        def recording_feed(*args, **kwargs):
            rows = args[3] if beam_mode == "resident" else args[2]
            dispatched.append(rows.tolist())
            return real_feed(*args, **kwargs)

        pool._feed = recording_feed
        got = [transcribe(pool, audio)[0], transcribe(pool, audio, mode="greedy")[0]]
        assert got == expected
        assert all(len(set(rows)) == len(rows) and sink not in rows
                   for rows in dispatched)
        assert torch.isnan(pool._buffers[sink]).all() and int(pool._lengths[sink]) == 12345
        pool.warm_up()  # the sink's only writer
        assert not pool._buffers[sink].any() and int(pool._lengths[sink]) == 0
    finally:
        pool.stop()


def test_warm_up_touches_no_session(port_transcriber):
    """`warm_up` before and after `start`, and `warm_up_beam` in both modes, leave the
    session rows as they were."""
    for beam_mode in ("posterior", "resident"):
        pool = DeviceStreamingPool(port_transcriber, beam_mode=beam_mode, **POOL)
        pool.warm_up()
        pool.start()
        try:
            pool.warm_up()
            pool.warm_up_beam()
            assert not pool._buffers[:pool.max_sessions].any()
            text, _ = transcribe(pool, _audio(1.0, 9))
            assert text
        finally:
            pool.stop()


class TestResident:
    """``beam_mode="resident"``: every beam carry lives in the pooled state and
    advances inside the feed dispatch; transcripts equal the posterior sync beam's."""

    @pytest.mark.parametrize("chunk", [4000, 7000])
    def test_matches_posterior_sync_beam(self, port_transcriber, chunk):
        audio = _audio(2.5, 21)
        states = []
        for beam_mode in ("posterior", "resident"):
            pool = make_pool(port_transcriber, beam_mode=beam_mode)
            try:
                assert pool.beam_mode == beam_mode
                session = pool.create_stream(partial_decode="beam")
                for start in range(0, len(audio), chunk):
                    session.feed(audio[start:start + chunk])
                states.append(session.finish_with_state())
            finally:
                pool.stop()
        assert states[0] == states[1] and states[0]["text"] and states[0]["words"]

    def test_rollover_commits_and_matches(self, port_transcriber):
        """A live prefix outgrowing ``max_decoded_length`` commits the best to the host
        and restarts the row from a fresh carry (the reset rides the next dispatch), as
        the posterior path's per-piece rollover does."""
        audio = _audio(3.0, 23)
        opts = {"max_decoded_length": 48, "chunk_frames": 40}
        texts = []
        for beam_mode in ("posterior", "resident"):
            pool = make_pool(port_transcriber, beam_mode=beam_mode, beam_opts=opts)
            try:
                text, session = transcribe(pool, audio)
                texts.append(text)
                if beam_mode == "resident":
                    assert session._committed.size > 0
            finally:
                pool.stop()
        assert texts[0] == texts[1]

    def test_row_reuse_resets_the_carry(self, port_transcriber):
        audio = _audio(1.9, 24)
        pool = make_pool(port_transcriber, beam_mode="resident", max_sessions=1)
        try:
            first_text, first = transcribe(pool, audio)
            again_text, again = transcribe(pool, audio)
            assert again._row == first._row and again_text == first_text
        finally:
            pool.stop()

    def test_partials_do_not_lag(self, port_transcriber):
        """Each resident partial reflects every row this feed finalized: after each
        feed it equals the posterior sync session's."""
        audio = _audio(1.5, 25)
        resident = make_pool(port_transcriber, beam_mode="resident")
        posterior = make_pool(port_transcriber)
        try:
            res = resident.create_stream(partial_decode="beam")
            ref = posterior.create_stream(partial_decode="beam")
            partials = [(res.feed(audio[s:s + 4000]), ref.feed(audio[s:s + 4000]))
                        for s in range(0, len(audio), 4000)]
        finally:
            resident.stop()
            posterior.stop()
        assert all(a == b for a, b in partials) and partials[-1][0]

    def test_engines_and_greedy_sessions(self, port_transcriber):
        """The plain-step decoder's carries (`decode_beam.BeamState`'s nine leaves and
        the tokens) and the kernel decoder's (eight leaves with the word LM, and the
        tokens) both live in the pool and give the same transcript; a greedy session
        beside a beam session decodes as it does alone."""
        audio = _audio(2.5, 22)
        out = {}
        for engine in ("xla", "pallas"):
            pool = make_pool(port_transcriber, beam_mode="resident", beam_engine=engine)
            try:
                assert len(pool._beam_pool) == (10 if engine == "xla" else 9)
                alone = transcribe(pool, audio, mode="greedy")[0]
                beam = pool.create_stream(partial_decode="beam")
                greedy = pool.create_stream()
                text = ""
                for start in range(0, len(audio), 4000):
                    beam.feed(audio[start:start + 4000])
                    text += greedy.feed(audio[start:start + 4000])
                text += greedy.finish()
                beam.finish()
                assert text == alone
                out[engine] = beam.text
            finally:
                pool.stop()
        assert out["xla"] == out["pallas"] and out["xla"]

    def test_mode_checks(self, port_transcriber):
        with pytest.raises(ValueError, match="beam_mode"):
            DeviceStreamingPool(port_transcriber, beam_mode="fused")
        with pytest.raises(ValueError, match="beam_partials=False"):
            DeviceStreamingPool(port_transcriber, beam_mode="resident",
                                beam_partials=False)
        # 0.16 s holds 11 output frames: fewer than the 12-row advance block.
        with pytest.raises(ValueError, match="12 frames"):
            DeviceStreamingPool(port_transcriber, window_s=0.16, margin_s=0.05,
                                beam_mode="resident")
        with pytest.raises(ValueError, match="live serving.Transcriber"):
            DeviceStreamingPool(object())
        pool = make_pool(port_transcriber, beam_mode="resident")
        try:
            with pytest.raises(ValueError, match="pipeline"):
                pool.create(partial_decode="beam_pipelined")
            assert pool.post_rows is None
            assert pool.beam_piece_cap == min(pool.chunk_cap, 32 * pool.spf)
        finally:
            pool.stop()
        greedy_only = DeviceStreamingPool(port_transcriber, beam_partials=False, **POOL)
        with pytest.raises(ValueError, match="beam_partials=False"):
            greedy_only.create(partial_decode="beam")
        assert greedy_only.session_count == 0

    def test_advance_range_of_non_beam_rows_is_empty(self, port_transcriber):
        """The host's advance range: a non-beam row at `_NO_EMIT_LIMIT` advances over
        nothing, even where its window start is far below zero; a beam row whose
        horizon rides the window's tail gets a block rolled so that its first valid
        frame is row 0 (floor division of the negative differences)."""
        pool = DeviceStreamingPool(port_transcriber, beam_mode="resident", **POOL)
        spf, frames = pool.spf, pool.window_frames
        window = pool.window
        total = 10 * window
        payloads = [(0, None, False, False, 0),
                    (1, None, False, True, (total, window, total - 3 * spf,
                                            total + spf, False)),
                    (2, None, False, True, (total, window, total - window - 5 * spf,
                                            _NO_EMIT_LIMIT, True))]
        reset_rows, advance, slots, counts = pool._resident_advance(payloads)
        assert reset_rows.tolist() == [2] and slots.tolist() == [1]
        f_lo = window // spf - 3  # the horizon three frames before the window's end
        assert advance[2].tolist() == [int(counts[1]) - f_lo] == [3]
        block = advance[1][0].tolist()
        assert block[0] == f_lo and block[:3] == [f_lo, f_lo + 1, f_lo + 2]
        assert sorted(block) == list(range(frames - pool._beam_cf, frames))


@pytest.mark.parametrize("beam_mode", ["posterior", "resident"])
def test_http_stream_routes_on_the_device_pool(port_transcriber, beam_mode):
    """``TranscriptionServer(device_streams=True)``: a beam session over HTTP ends with
    the text of the same audio through a direct pool; the routes' errors as on the
    host pool; ``resident`` without ``device_streams`` is refused."""
    audio = _audio(1.7, 41)
    server = TranscriptionServer(port_transcriber, port=0, max_batch=4, max_wait_ms=5.0,
                                 stream_window_s=1.024, stream_margin_s=0.25,
                                 device_streams=True, beam_mode=beam_mode)
    assert isinstance(server.streams, DeviceStreamingPool)
    server.start()
    try:
        status, created = _request(server.port, "/v1/stream", b'{"partial_decode": "beam"}')
        assert status == 200
        sid = created["session"]
        assert _request(server.port, "/healthz")[1]["streaming_sessions"] == 1
        for start in range(0, len(audio), 4000):
            status, reply = _request(server.port, "/v1/stream/" + sid,
                                     audio[start:start + 4000].astype("<f4").tobytes(),
                                     "application/octet-stream")
            assert status == 200 and set(reply) == {"partial", "text", "final_up_to_s",
                                                    "words"}
        status, final = _request(server.port, "/v1/stream/{}/finish".format(sid), b"")
        assert status == 200 and final["text"]
        assert final["final_up_to_s"] == round(len(audio) / 16000, 3)
        status, metrics = _request(server.port, "/v1/metrics")
        assert status == 200 and metrics["streaming"]["feeds"] > 0
        assert _request(server.port, "/v1/stream/nope", b'{"pcm": [0.1]}')[0] == 404
        assert _request(server.port, "/v1/stream/" + sid + "/finish", b"")[0] == 404
        pipelined = _request(server.port, "/v1/stream",
                             b'{"partial_decode": "beam_pipelined"}')[0]
        assert pipelined == (501 if beam_mode == "resident" else 200)
    finally:
        server.stop()
    direct = make_pool(port_transcriber, beam_mode=beam_mode)
    try:
        assert final["text"] == transcribe(direct, audio)[0]
    finally:
        direct.stop()
    with pytest.raises(ValueError, match="device_streams=True"):
        TranscriptionServer(port_transcriber, port=0, beam_mode="resident")


def test_http_server_queues_simultaneous_connects(port_transcriber):
    """32 clients connecting at once are all queued for the accept loop (which is not
    running here): with socketserver's backlog of 5 the kernel drops the surplus, and
    their TCP retries them a second later."""
    server = TranscriptionServer(port_transcriber, port=0)
    connections = []
    try:
        for _ in range(32):
            connections.append(socket.create_connection(("127.0.0.1", server.port),
                                                        timeout=0.5))
    finally:
        for connection in connections:
            connection.close()
        server.httpd.server_close()
    assert len(connections) == 32


def test_cli_serves_device_streams(setup, tmp_path):  # noqa: F811
    """``serve --device-streams --beam-mode resident`` on the CPU: a beam session over
    HTTP ends with the text of a direct resident pool on the same weights and audio."""
    import queue
    import signal
    import subprocess
    import sys
    from pathlib import Path

    from speechless_tpu_torch.models import wav2letter as w2l
    from test_torch_serving import _pcm_body

    _, _, lm_directory = setup
    config = w2l.Wav2LetterConfig(128, len(ALPHABET) + 1)
    params = w2l.init_params(config, seed=2)
    params[-1]["w"] = params[-1]["w"] * 8.0  # peaky frames
    checkpoint = tmp_path / "weights-epoch1.npz"
    np.savez(checkpoint, **{"layer{}.{}".format(i, key): value
                            for i, layer in enumerate(params)
                            for key, value in layer.items()})
    process = subprocess.Popen(
        [sys.executable, "-m", "speechless_tpu_torch", "serve", "--checkpoint",
         str(checkpoint), "--kenlm", str(lm_directory), "--device", "cpu", "--port", "0",
         "--no-warm-up", "--device-streams", "--beam-mode", "resident"],
        cwd=str(Path(__file__).resolve().parent.parent), stderr=subprocess.PIPE, text=True)
    lines = queue.Queue()

    def read_log():
        for log_line in process.stderr:
            lines.put(log_line)
        lines.put(None)  # the server exited

    threading.Thread(target=read_log, daemon=True).start()
    audio = _audio(1.0, 42)
    try:
        line = ""
        while "serving on http://" not in line:
            line = lines.get(timeout=120)
            assert line is not None, "the server exited before it bound its port"
        port = int(line.rsplit(":", 1)[1].split()[0])
        sid = _request(port, "/v1/stream", b'{"partial_decode": "beam"}')[1]["session"]
        for start in range(0, len(audio), 8000):
            assert _request(port, "/v1/stream/" + sid,
                            _pcm_body(audio[start:start + 8000]))[0] == 200
        status, final = _request(port, "/v1/stream/{}/finish".format(sid), b"")
    finally:
        process.send_signal(signal.SIGINT)
        try:
            process.wait(timeout=60)
        finally:
            process.kill()
    transcriber = Transcriber(config, params, ALPHABET, device="cpu",
                              kenlm_directory=lm_directory)
    direct = DeviceStreamingPool(transcriber, beam_mode="resident")
    direct.start()
    try:
        want = transcribe(direct, audio, 8000)[0]
    finally:
        direct.stop()
    assert status == 200 and final["text"] == want and want


def _feed_bundle(transcriber, directory, **device_streaming):
    """An export bundle of ``transcriber``'s bucket with the pool's feed program."""
    from speechless_tpu_torch.serving_export import ExportedTranscriber, export_transcriber

    export_transcriber(transcriber, directory, platforms=("cpu",),
                       device_streaming={"window_s": 1.024, "chunk_cap_s": 0.5,
                                         "max_sessions": 4, "max_batch": 4,
                                         **device_streaming})
    return ExportedTranscriber(directory, device="cpu")


def test_exported_bundle_serves_device_streams(port_transcriber, pool, tmp_path):
    """A bundle exported with ``device_streaming=...`` serves device-resident streams
    with no model code, matching the live pool's transcript exactly; the pool adopts the
    bundle's baked dimensions over mismatched constructor arguments and refuses the
    resident mode."""
    bundle = _feed_bundle(port_transcriber, tmp_path / "bundle")
    assert bundle.device_feed_spec["window"] == pool.window
    assert bundle.device_feed_spec["chunk_cap"] == pool.chunk_cap
    audio = _audio(3.25, 9)
    expected = transcribe(pool, audio, mode="greedy")[0]
    bundle_pool = DeviceStreamingPool(bundle, window_s=8.0, margin_s=0.25, max_batch=16,
                                      max_wait_ms=20.0, max_sessions=64)
    assert (bundle_pool.window, bundle_pool.max_sessions,
            bundle_pool.batcher.max_batch) == (pool.window, 4, 4)
    assert bundle_pool.beam_partials is False
    bundle_pool.start()
    try:
        assert transcribe(bundle_pool, audio, mode="greedy")[0] == expected
        with pytest.raises(ValueError, match="beam_partials=False"):
            bundle_pool.create_stream(partial_decode="beam")
    finally:
        bundle_pool.stop()
    with pytest.raises(ValueError, match="resident"):
        DeviceStreamingPool(bundle, beam_mode="resident")
    with pytest.raises(ValueError, match="posteriors"):
        DeviceStreamingPool(bundle, beam_partials=True)


def test_posteriors_bundle_serves_greedy_pool(setup, tmp_path):  # noqa: F811
    """A bundle whose feed bakes the posterior input and output serves a pool built
    with ``beam_partials=False`` (the dispatch follows the program, not the flag), and
    its beam sessions give the live pool's finals: a bundle's pool decodes beam
    partials with the default stream beam (no LM, unpruned), as the JAX package's does,
    so the live transcriber here has that decoder too."""
    config, params, _ = setup
    live = Transcriber(config, params, ALPHABET, device="cpu", sample_buckets=(16384,),
                       prune_classes=None)
    bundle = _feed_bundle(live, tmp_path / "bundle", posteriors=True, post_rows=12)
    assert bundle.device_feed_spec["posteriors"]
    audio = _audio(3.25, 9)
    live_pool = make_pool(live, post_rows=12)
    try:
        expected = {mode: transcribe(live_pool, audio, mode=mode)[0]
                    for mode in ("greedy", "beam")}
    finally:
        live_pool.stop()
    greedy_pool = DeviceStreamingPool(bundle, margin_s=0.25, beam_partials=False)
    greedy_pool.start()
    try:
        assert greedy_pool.beam_partials is False
        assert transcribe(greedy_pool, audio, mode="greedy")[0] == expected["greedy"]
        with pytest.raises(ValueError, match="beam_partials=False"):
            greedy_pool.create_stream(partial_decode="beam")
    finally:
        greedy_pool.stop()
    beam_pool = DeviceStreamingPool(bundle, margin_s=0.25, max_wait_ms=1.0)
    beam_pool.start()
    try:
        assert beam_pool.beam_partials is True and beam_pool.post_rows == 12
        assert transcribe(beam_pool, audio, mode="beam")[0] == expected["beam"]
    finally:
        beam_pool.stop()
