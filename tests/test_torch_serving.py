"""The port's serving slice end to end on the CPU: `speechless_tpu_torch.serving.
Transcriber` against the JAX package's `Transcriber` (same weights, same word LM, same
audio) on the LM beam, greedy, lexicon-constrained and n-best routes, the port's HTTP
server (`serving_http.TranscriptionServer`) and its CLI.

Tolerances: log-probs atol 1e-4 (fp32 features and convolutions summed in another
order; the output layer is scaled up so frames are peaky); transcripts exactly equal;
confidences atol 1e-4; n-best scores 1e-4 relative (the log-probs' own difference,
summed over the frames).
"""
import io
import json
import threading
import urllib.error
import urllib.request

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from speechless_tpu.models import wav2letter as jax_w2l
from speechless_tpu.serving import Transcriber as JaxTranscriber
from speechless_tpu_torch.lm.arpa_builder import build_kenlm_directory
from speechless_tpu_torch.models import wav2letter as w2l
from speechless_tpu_torch.serving import Transcriber, words_from_frame_tokens
from speechless_tpu_torch.serving_http import (DynamicBatcher, RequestError,
                                               TranscriptionServer, _parse_audio)
from speechless_tpu_torch.utils.microbatch import PendingItem
from torch_tmp import delete_tmp_path  # noqa: F401 (full-width files)

torch.backends.cudnn.allow_tf32 = False

ALPHABET = list("abcdefghijklmnopqrstuvwxyz '")
TEXTS = ["the cat sat on the mat", "the cat ran to the dog", "a dog sat on a log",
         "the dog ran to the cat", "it's the cat on the mat", "a cat and a dog ran"]
LAYERS = (w2l.ConvSpec("striding_conv", 16, 48, 2),
          w2l.ConvSpec("inner_conv_1", 16, 7, 1),
          w2l.ConvSpec("big_conv_1", 24, 32, 1),
          w2l.ConvSpec("big_conv_2", 24, 1, 1),
          w2l.ConvSpec("output_conv", len(ALPHABET) + 1, 1, 1, "linear"))
BUCKETS = (16384,)


def _audio(seconds, seed):
    rng = np.random.default_rng(seed)
    t = np.arange(int(seconds * 16000)) / 16000.0
    tones = sum(0.2 * np.sin(2 * np.pi * f * t) for f in rng.uniform(100, 3000, 3))
    return (tones + 0.05 * rng.normal(size=t.size)).astype(np.float32)


AUDIOS = [_audio(s, i) for i, s in enumerate((1.0, 0.6, 0.85, 0.3, 1.02))]


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    lm_directory = tmp_path_factory.mktemp("kenlm")
    build_kenlm_directory(TEXTS, lm_directory, allowed_characters=ALPHABET, order=3)
    config = w2l.Wav2LetterConfig(128, len(ALPHABET) + 1, layers=LAYERS)
    params = w2l.init_params(config, seed=11)
    params[-1]["w"] = params[-1]["w"] * 10.0  # peaky frames
    return config, params, lm_directory


@pytest.fixture(scope="module")
def port_lm(setup):
    config, params, lm_directory = setup
    return Transcriber(config, params, ALPHABET, device="cpu", kenlm_directory=lm_directory,
                       beam_width=8, sample_buckets=BUCKETS)


@pytest.fixture(scope="module")
def server(port_lm):
    srv = TranscriptionServer(port_lm, port=0, max_batch=4, max_wait_ms=30.0)
    srv.start()
    yield srv
    srv.stop()


def _jax_transcriber(setup, kenlm, lexicon_constrained=False, **options):
    config, params, lm_directory = setup
    jax_config = jax_w2l.Wav2LetterConfig(
        128, len(ALPHABET) + 1, layers=tuple(
            jax_w2l.ConvSpec(s.name, s.filters, s.kernel_size, s.stride, s.activation,
                             False) for s in LAYERS))
    return JaxTranscriber(jax_config, [{k: jnp.asarray(v) for k, v in p.items()}
                                       for p in params], ALPHABET,
                          kenlm_directory=lm_directory if kenlm else None, beam_width=8,
                          sample_buckets=BUCKETS, lexicon_constrained=lexicon_constrained,
                          **options)


@pytest.mark.parametrize("kenlm", [True, False], ids=["lm_beam", "greedy"])
def test_transcripts_match_jax_transcriber(setup, port_lm, kenlm):
    config, params, _ = setup
    ours = port_lm if kenlm else Transcriber(config, params, ALPHABET, device="cpu",
                                             sample_buckets=BUCKETS)
    theirs = _jax_transcriber(setup, kenlm)
    want = theirs.transcribe_batch(AUDIOS, batch_size=8)
    got = ours.transcribe_batch(AUDIOS, batch_size=8)
    assert [text for text, _ in got] == [text for text, _ in want]
    assert any(len(text) > 3 for text, _ in got)
    np.testing.assert_allclose([c for _, c in got], [c for _, c in want], atol=1e-4)
    if kenlm:
        # The single-utterance route: the port's against the JAX batch's transcript
        # (the JAX single route is the same program at batch 1, compiled once more).
        for audio, (text, _) in zip(AUDIOS[:2], want):
            np.testing.assert_allclose(ours.frame_log_probs(audio),
                                       theirs.frame_log_probs(audio), atol=1e-4, rtol=0)
            assert ours.transcribe_audio(audio) == text


def _request(port, path, data=None, content_type="application/json"):
    request = urllib.request.Request("http://127.0.0.1:{}{}".format(port, path),
                                     data=data)
    if data is not None:
        request.add_header("Content-Type", content_type)
    try:
        with urllib.request.urlopen(request, timeout=300) as response:
            return response.status, json.loads(response.read())
    except urllib.error.HTTPError as error:
        return error.code, json.loads(error.read())


def _pcm_body(audio, sample_rate=16000):
    return json.dumps({"pcm": audio.tolist(), "sample_rate": sample_rate}).encode()


def test_http_transcribe_matches_direct_calls(server, port_lm):
    results = [None] * 4

    def send(index):
        if index == 3:
            results[index] = _request(server.port, "/v1/transcribe",
                                      AUDIOS[index].astype("<f4").tobytes(),
                                      "application/octet-stream; rate=16000")
        else:
            results[index] = _request(server.port, "/v1/transcribe",
                                      _pcm_body(AUDIOS[index]))

    threads = [threading.Thread(target=send, args=(i,)) for i in range(4)]
    for thread in threads:
        thread.start()
    for thread in threads:
        thread.join(timeout=300)
    direct = port_lm.transcribe_batch(AUDIOS[:4])
    for (status, payload), (text, confidence) in zip(results, direct):
        assert status == 200
        assert payload["text"] == text
        assert payload["confidence"] == pytest.approx(confidence, abs=1e-5)
    status, metrics = _request(server.port, "/metrics")
    assert status == 200 and metrics["requests"] >= 4


def test_http_wav_body_and_timestamps(server, port_lm):
    import scipy.io.wavfile as wavfile

    buffer = io.BytesIO()
    wavfile.write(buffer, 8000, (AUDIOS[0][::2] * 32767).astype(np.int16))
    status, payload = _request(server.port, "/v1/transcribe", buffer.getvalue(),
                               "audio/wav")
    assert status == 200 and isinstance(payload["text"], str)
    status, payload = _request(server.port, "/v1/transcribe?timestamps=1",
                               _pcm_body(AUDIOS[0]))
    assert status == 200
    want = words_from_frame_tokens(port_lm.frame_tokens(AUDIOS[0]), port_lm.codec,
                                   port_lm.blank_index, port_lm.seconds_per_frame)
    assert [w["word"] for w in payload["words"]] == [w for w, _, _ in want]
    assert all(w["end_s"] > w["start_s"] for w in payload["words"])


def test_http_status_codes(server):
    status, health = _request(server.port, "/healthz")
    assert status == 200 and health["sample_buckets"] == list(BUCKETS)
    assert _request(server.port, "/v1/metrics")[0] == 200
    assert _request(server.port, "/nope")[0] == 404
    for query in ("nbest=two", "nbest=0", "nbest=3&timestamps=1", "nbest=9"):
        status, payload = _request(server.port, "/v1/transcribe?" + query,
                                   _pcm_body(AUDIOS[1]))
        assert status == 400 and "nbest" in payload["error"], query
    status, payload = _request(server.port, "/v1/stream", b"{}")  # a greedy session
    assert status == 200 and payload["session"]
    assert _request(server.port, "/v1/transcribe", b"not json")[0] == 400
    assert _request(server.port, "/v1/transcribe", b"\x00", "text/plain")[0] == 415


def test_timestamps_failure_fails_its_request_alone():
    """Two requests in one batch, one asking for timestamps from a backend whose
    `frame_tokens` raises `ValueError`: the other keeps its text, the failing one gets a
    501 (as the JAX package's batcher does)."""

    class NoFrameTokens:
        def transcribe_batch(self, audios, batch_size):
            return [("text {}".format(i), 0.5) for i in range(len(audios))]

        def frame_tokens(self, audio):
            raise ValueError("no frame path")

    batch = [PendingItem((np.zeros(160, np.float32), want, None))
             for want in (False, True)]
    DynamicBatcher(NoFrameTokens())._serve(batch)
    assert batch[0].error is None and batch[0].result == {"text": "text 0",
                                                          "confidence": 0.5}
    assert batch[1].result is None
    assert isinstance(batch[1].error, RequestError) and batch[1].error.status == 501


@pytest.mark.parametrize("kenlm", [True, False], ids=["lm_beam", "no_lm"])
def test_nbest_matches_jax_transcriber(setup, port_lm, kenlm):
    """`transcribe_nbest` gives the JAX Transcriber's hypotheses: texts exactly, scores
    within 1e-4 relative; the best text is the one-best route's."""
    config, params, _ = setup
    ours = port_lm if kenlm else Transcriber(config, params, ALPHABET, device="cpu",
                                             beam_width=8, sample_buckets=BUCKETS)
    theirs = _jax_transcriber(setup, kenlm)
    for audio in AUDIOS[:3]:
        got, want = ours.transcribe_nbest(audio, 5), theirs.transcribe_nbest(audio, 5)
        assert [text for text, _ in got] == [text for text, _ in want]
        assert len(got) > 1
        np.testing.assert_allclose([score for _, score in got],
                                   [score for _, score in want], rtol=1e-4)
    if kenlm:
        assert got[0][0] == ours.transcribe_audio(AUDIOS[2])


def test_lexicon_transcripts_match_jax_transcriber(setup):
    """The lexicon-constrained route: transcripts equal to the JAX Transcriber's, every
    completed word in the LM's vocabulary."""
    config, params, lm_directory = setup
    ours = Transcriber(config, params, ALPHABET, device="cpu", kenlm_directory=lm_directory,
                       beam_width=8, sample_buckets=BUCKETS, lexicon_constrained=True)
    want = _jax_transcriber(setup, True, lexicon_constrained=True).transcribe_batch(
        AUDIOS, batch_size=8)
    got = ours.transcribe_batch(AUDIOS, batch_size=8)
    assert [text for text, _ in got] == [text for text, _ in want]
    vocabulary = {word for text in TEXTS for word in text.split()}
    words = [w for text, _ in got for w in text.split(" ")[:-1] if w]
    assert words and set(words) <= vocabulary
    assert ours.transcribe_nbest(AUDIOS[0], 3)[0][0] == got[0][0]


def test_http_nbest_matches_direct_calls(server, port_lm):
    """``?nbest=3`` answers 200 with the direct call's hypotheses; plain requests in the
    same batch window are answered as before."""
    results = {}

    def send(name, path, audio):
        results[name] = _request(server.port, path, _pcm_body(audio))

    threads = [threading.Thread(target=send, args=args) for args in (
        ("nbest", "/v1/transcribe?nbest=3", AUDIOS[2]),
        ("plain", "/v1/transcribe", AUDIOS[1]))]
    for thread in threads:
        thread.start()
    for thread in threads:
        thread.join(timeout=300)
    status, payload = results["nbest"]
    want = port_lm.transcribe_nbest(AUDIOS[2], 3)
    assert status == 200 and payload["text"] == want[0][0]
    assert [(h["text"], h["score"]) for h in payload["hypotheses"]] == \
        [(text, round(score, 4)) for text, score in want]
    status, payload = results["plain"]
    assert status == 200 and payload["text"] == port_lm.transcribe_audio(AUDIOS[1])


def test_parse_audio_resamples_octet_stream():
    audio = np.linspace(-0.5, 0.5, 800, dtype=np.float32)
    out = _parse_audio("application/octet-stream; rate=8000", audio.astype("<f4").tobytes())
    assert out.dtype == np.float32 and out.shape == (1600,)


class _Pattern(torch.nn.Module):
    """Peaky logits cycling through the alphabet: char, blank, char, ... per frame."""

    def forward(self, features):
        frames = torch.arange(features.shape[1])
        symbol = torch.where(frames % 2 == 0, (frames // 2) % len(ALPHABET), len(ALPHABET))
        logits = torch.full((features.shape[0], features.shape[1], len(ALPHABET) + 1), -8.0)
        logits[:, frames, symbol] = 8.0
        return logits


@pytest.mark.parametrize("kenlm", [True, False], ids=["lm_beam", "greedy"])
def test_long_transcripts_are_not_truncated(setup, kenlm):
    """A transcript longer than 256 graphemes comes back whole on both decode routes:
    ``max_decoded_length`` is the frame count, not the old default of 256."""
    _, params, lm_directory = setup
    config = w2l.Wav2LetterConfig(128, len(ALPHABET) + 1, layers=(
        w2l.ConvSpec("output_conv", len(ALPHABET) + 1, 1, 1, "linear"),))
    transcriber = Transcriber(config, [{"w": np.zeros((1, 128, 29), np.float32),
                                        "b": np.zeros(29, np.float32)}], ALPHABET,
                              device="cpu", kenlm_directory=lm_directory if kenlm else None,
                              beam_width=4)
    transcriber.model = _Pattern()
    audio = np.zeros(int(4.5 * 16000), np.float32)
    frames = 1 + len(audio) // 128
    want = "".join(ALPHABET[(f // 2) % len(ALPHABET)] for f in range(0, frames, 2))
    text = transcriber.transcribe_audio(audio)
    assert len(want) > 256
    assert text == want


def test_unported_options_raise(setup, port_lm):
    """The options that raised here before they were ported now serve: quantized
    serving, forced alignment (their parity with JAX: `test_torch_quantize.py`,
    `test_torch_forced_align.py`) and sequence-parallel long-form decoding, which in one
    process runs the whole recording through the plain forward and, at a matched
    bucket, transcribes as the offline route does (meshes:
    `test_torch_sequence_parallel.py`). Bad options still raise."""
    config, params, _ = setup
    quantized = Transcriber(config, params, ALPHABET, device="cpu", quantize_weights=True,
                            sample_buckets=BUCKETS)
    assert quantized.quantized and not quantized.int8_compute
    assert isinstance(quantized.model.layers[0], w2l.QuantizedConv1d)
    assert isinstance(quantized.transcribe_audio(AUDIOS[0]), str)
    with pytest.raises(ValueError, match="requires kenlm_directory"):
        Transcriber(config, params, ALPHABET, device="cpu", lexicon_constrained=True)
    with pytest.raises(ValueError, match="nbest must be in"):
        port_lm.transcribe_nbest(AUDIOS[0], 9)
    plain = Transcriber(config, params, ALPHABET, device="cpu", sample_buckets=BUCKETS)
    for transcriber in (plain, port_lm):
        transcriber._SP_BUCKET_SAMPLES = BUCKETS[0]
        assert transcriber.transcribe_long_audio(AUDIOS[0], sequence_parallel=True) \
            == transcriber.transcribe_audio(AUDIOS[0])
    words = port_lm.align_audio(AUDIOS[0], "a cat")
    assert [w["word"] for w in words] == ["a", "cat"]


def test_cli_serves_a_full_width_checkpoint(setup, tmp_path):
    """``python -m speechless_tpu_torch serve`` on the CPU answers like a direct call."""
    import queue
    import signal
    import subprocess
    import sys
    from pathlib import Path

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
         "--no-warm-up"], cwd=str(Path(__file__).resolve().parent.parent),
        stderr=subprocess.PIPE, text=True)
    lines = queue.Queue()

    def read_log():
        for log_line in process.stderr:
            lines.put(log_line)
        lines.put(None)  # the server exited

    threading.Thread(target=read_log, daemon=True).start()
    try:
        line = ""
        while "serving on http://" not in line:
            line = lines.get(timeout=120)
            assert line is not None, "the server exited before it bound its port"
        port = int(line.rsplit(":", 1)[1].split()[0])
        status, payload = _request(port, "/v1/transcribe", _pcm_body(AUDIOS[0]))
    finally:
        process.send_signal(signal.SIGINT)
        try:
            process.wait(timeout=60)
        finally:
            process.kill()
    direct = Transcriber(config, params, ALPHABET, device="cpu",
                         kenlm_directory=lm_directory).transcribe_audio(AUDIOS[0])
    assert status == 200 and payload["text"] == direct and direct


def _cli(*args):
    import subprocess
    import sys
    from pathlib import Path

    return subprocess.run([sys.executable, "-m", "speechless_tpu_torch", *args],
                          cwd=str(Path(__file__).resolve().parent.parent),
                          capture_output=True, text=True, timeout=300)


def test_cli_transcribe_nbest_json(setup, port_lm, tmp_path):
    """``transcribe --nbest 3 --json`` prints the direct call's hypotheses per file;
    ``--lexicon`` without ``--kenlm`` is refused before anything loads, by both
    commands."""
    import scipy.io.wavfile as wavfile

    _, params, lm_directory = setup
    config = w2l.Wav2LetterConfig(128, len(ALPHABET) + 1)
    checkpoint = tmp_path / "weights-epoch1.npz"
    full = w2l.init_params(config, seed=2)
    full[-1]["w"] = full[-1]["w"] * 8.0  # peaky frames
    np.savez(checkpoint, **{"layer{}.{}".format(i, key): value
                            for i, layer in enumerate(full)
                            for key, value in layer.items()})
    wav = tmp_path / "a.wav"
    wavfile.write(wav, 16000, AUDIOS[0])
    done = _cli("transcribe", str(wav), "--checkpoint", str(checkpoint), "--kenlm",
                str(lm_directory), "--device", "cpu", "--json", "--nbest", "3")
    assert done.returncode == 0, done.stderr
    record = json.loads(done.stdout.strip().splitlines()[-1])
    want = Transcriber(config, full, ALPHABET, device="cpu", kenlm_directory=lm_directory
                       ).transcribe_nbest(AUDIOS[0], 3)
    assert record["file"] == str(wav) and record["text"] == want[0][0]
    assert [(h["text"], h["score"]) for h in record["hypotheses"]] == \
        [(text, round(score, 4)) for text, score in want]
    for command in (["serve"], ["transcribe", str(wav)]):
        refused = _cli(*command, "--checkpoint", str(checkpoint), "--lexicon",
                       "--device", "cpu")
        assert refused.returncode == 2 and "--lexicon requires --kenlm" in refused.stderr
    refused = _cli("transcribe", str(wav), "--checkpoint", str(checkpoint), "--nbest", "3")
    assert refused.returncode == 2 and "--nbest requires --json" in refused.stderr


def test_long_audio_segments_like_jax(port_lm):
    from speechless_tpu.serving import split_long_audio as jax_split_long_audio
    from speechless_tpu_torch.serving import split_long_audio

    audio = np.concatenate([AUDIOS[0], np.zeros(3000, np.float32), AUDIOS[2]])
    segments = split_long_audio(audio, max_segment_s=1.0)
    assert [len(s) for s in segments] \
        == [len(s) for s in jax_split_long_audio(audio, max_segment_s=1.0)]
    assert len(segments) > 1
    assert port_lm.transcribe_long_audio(audio, max_segment_s=1.0) == " ".join(
        text for text in map(port_lm.transcribe_audio, segments) if text)


def test_file_timestamps_and_latency_routes(setup, port_lm, tmp_path):
    """`transcribe_file` on wav and FLAC, `has_batched_programs`,
    `transcribe_audio_with_timestamps` (equal to the JAX Transcriber's) and
    `measure_latency`."""
    import scipy.io.wavfile as wavfile

    from speechless_tpu_torch.features.flac_encoder import encode_flac

    pcm = np.clip(np.round(AUDIOS[0] * 32767), -32768, 32767).astype(np.int16)
    wavfile.write(tmp_path / "a.wav", 16000, pcm)
    encode_flac(str(tmp_path / "a.flac"), [pcm.astype(np.int64).tolist()])
    want = port_lm.transcribe_audio(pcm.astype(np.float32) / 32768.0)
    assert port_lm.transcribe_file(tmp_path / "a.wav") == want
    assert port_lm.transcribe_file(tmp_path / "a.flac") == want
    assert port_lm.has_batched_programs is True
    theirs = _jax_transcriber(setup, kenlm=False)
    for audio in AUDIOS[:3]:
        got = port_lm.transcribe_audio_with_timestamps(audio)
        assert got == theirs.transcribe_audio_with_timestamps(audio)
    assert any(port_lm.transcribe_audio_with_timestamps(a) for a in AUDIOS[:3])
    calls = []
    transcribe_audio = port_lm.transcribe_audio
    port_lm.transcribe_audio = lambda audio: calls.append(audio) or transcribe_audio(audio)
    try:
        p50, p95 = port_lm.measure_latency(duration_s=0.5, iterations=3)
    finally:
        del port_lm.transcribe_audio
    assert len(calls) == 4 and 0.0 < p50 <= p95
    expected = (0.1 * np.random.RandomState(0).randn(8000)).astype(np.float32)
    assert all(np.array_equal(audio, expected) for audio in calls)


def test_warm_up_beam_leaves_no_trace(port_lm):
    """The host pool's beam warm-up runs throwaway feeds on the shared decoder: a beam
    session fed after it gives the replies of one fed on a pool that never warmed up.
    A backend without posteriors is refused with the JAX pool's message."""
    from speechless_tpu_torch.serving_streaming import StreamingSessionPool

    audio = np.concatenate(AUDIOS[:3])
    replies = []
    for warm in (True, False):
        pool = StreamingSessionPool(port_lm, window_s=1.0, margin_s=0.25, max_wait_ms=1.0)
        if warm:
            pool.warm_up_beam()
            assert pool.beam_batcher is not None
        pool.start()
        try:
            sid = pool.create(partial_decode="beam")
            replies.append([pool.feed_with_state(sid, audio[i:i + 4000])
                            for i in range(0, len(audio), 4000)]
                           + [pool.finish_with_state(sid)])
        finally:
            pool.stop()
    assert json.dumps(replies[0], sort_keys=True) == json.dumps(replies[1], sort_keys=True)
    assert replies[0][-1]["text"]

    class NoPosteriors:
        supports_posteriors = False

        def __getattr__(self, name):
            return getattr(port_lm, name)

    with pytest.raises(ValueError, match="beam partials need per-frame posteriors; this "
                                         "backend has no frame_log_probs program"):
        StreamingSessionPool(NoPosteriors()).warm_up_beam()
