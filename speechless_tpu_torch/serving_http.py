"""HTTP transcription service with dynamic micro-batching (port of
`speechless_tpu/serving_http.py` over the port's `serving.Transcriber`).

Threading contract, as in the JAX server: every device dispatch happens on the single
batcher thread. HTTP handler threads only parse the request, enqueue it, and wait.

Endpoints::

    GET  /healthz                 liveness + model metadata + open streaming sessions
    GET  /metrics, /v1/metrics    request/batch counters, latency percentiles (the
                                  "streaming" block: the window batcher's)
    POST /v1/transcribe           body: audio/wav bytes, JSON {"pcm": [...],
                                  "sample_rate": 16000}, or raw little-endian float32
                                  PCM as application/octet-stream (";rate=<hz>")
         ?timestamps=1            adds word-level emission timestamps
         ?nbest=N                 the top N hypotheses with path scores:
                                  {"text", "hypotheses": [{"text", "score"}]}
    POST /v1/stream               open a streaming session; optional JSON body
                                  {"partial_decode": "greedy"|"beam"|"beam_pipelined",
                                  "final_decode": bool} -> {"session": id}
    POST /v1/stream/<id>          feed one audio chunk (same bodies as /v1/transcribe)
                                  -> {"partial", "text", "final_up_to_s", "words"}
    POST /v1/stream/<id>/finish   flush and close -> {"text", "live_text", "words",
                                  "final_up_to_s"}

``?nbest=N`` answers 400 when N is not an integer, below 1 or above the beam width, or
comes with ``timestamps``, and 501 on an export bundle (`serving_export.
ExportedTranscriber`), which holds 1-best programs only. A bundle without batched
programs serves a batch of requests one by one. Streaming sessions run on
`serving_streaming.StreamingSessionPool` (or, with ``device_streams``,
`serving_device_stream.DeviceStreamingPool`); both pools answer the same routes with the
same replies through the shared session core (`serving_streaming.SessionPool`): 400 for
a bad body or mode, 404 for an unknown session, 501 for a mode the backend cannot serve.
"""
import inspect
import json
import logging
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import List, Optional
from urllib.parse import parse_qs, urlparse

import numpy as np

from .features.audio_io import decode_wav_bytes, resample
from .serving_host import words_from_frame_tokens
from .serving_streaming import StreamingSessionPool, UnknownSessionError
from .utils.microbatch import BatcherSaturated, MicroBatcher, PendingItem

_MAX_BODY_BYTES = 64 * 1024 * 1024  # ~35 min of 16 kHz float32; guards the heap

logger = logging.getLogger(__name__)


class RequestError(ValueError):
    """A client error (HTTP 4xx/501) with a status code."""

    def __init__(self, status: int, message: str):
        super().__init__(message)
        self.status = status


class DynamicBatcher(MicroBatcher):
    """Collect concurrent requests into micro-batches: everything that arrives within
    ``max_wait_ms`` of the first queued request (up to ``max_batch``) is served by one
    ``backend.transcribe_batch`` call; a lone request takes the single-utterance path.
    N-best requests ride the same thread but decode one by one (their search returns n
    hypotheses, not one row of a shared batch). Queue, shutdown and error semantics are
    `utils.microbatch`'s."""

    item_noun = "requests"

    def __init__(self, backend, max_batch: int = 16, max_wait_ms: float = 10.0,
                 max_queue: Optional[int] = None):
        super().__init__(max_batch=max_batch, max_wait_ms=max_wait_ms,
                         name="transcribe-batcher", max_queue=max_queue)
        self.backend = backend
        # A live transcriber groups by the batcher's width; an export bundle's batched
        # programs fix theirs.
        self._batch_kwargs = ({"batch_size": max_batch} if "batch_size" in
                              inspect.signature(backend.transcribe_batch).parameters
                              else {})

    def submit(self, audio: np.ndarray, want_timestamps: bool = False,
               nbest: Optional[int] = None) -> dict:
        """Enqueue one request and block until its batch is served."""
        return super().submit((audio, want_timestamps, nbest))

    def _serve(self, batch: List[PendingItem]) -> None:
        for pending in [p for p in batch if p.payload[2] is not None]:
            audio, _, nbest = pending.payload
            try:
                hypotheses = self.backend.transcribe_nbest(audio, nbest)
            except Exception as error:  # a bad n must not fail the co-batched requests
                pending.error = error
                continue
            pending.result = {"text": hypotheses[0][0] if hypotheses else "",
                              "hypotheses": [{"text": text, "score": round(score, 4)}
                                             for text, score in hypotheses]}
        batch = [p for p in batch if p.payload[2] is None]
        if not batch:
            return
        if len(batch) == 1 or not getattr(self.backend, "has_batched_programs", True):
            decoded = [self.backend.transcribe_audio_with_confidence(pending.payload[0])
                       for pending in batch]
        else:
            decoded = self.backend.transcribe_batch(
                [pending.payload[0] for pending in batch], **self._batch_kwargs)
        for pending, (text, confidence) in zip(batch, decoded):
            audio, want_timestamps, _ = pending.payload
            result = {"text": text, "confidence": confidence}
            if want_timestamps:
                try:
                    result["words"] = self._timestamps(audio)
                except Exception as error:  # fails this request, not the co-batched ones
                    pending.error = error
                    continue
            pending.result = result

    def _timestamps(self, audio: np.ndarray) -> List[dict]:
        """The request's words with start and end seconds; a `ValueError` from
        ``backend.frame_tokens`` (a backend without the frame path) is a 501."""
        try:
            frames = self.backend.frame_tokens(audio)
        except ValueError as error:
            raise RequestError(501, str(error))
        words = words_from_frame_tokens(frames, self.backend.codec,
                                        self.backend.blank_index,
                                        self.backend.seconds_per_frame)
        return [{"word": word, "start_s": round(start, 4), "end_s": round(end, 4)}
                for word, start, end in words]


def _parse_audio(content_type: str, body: bytes) -> np.ndarray:
    """Decode a request body to a mono 16 kHz float32 waveform (wav, JSON PCM, or raw
    float32 octet-stream with an optional ``; rate=<hz>`` parameter)."""
    kind = (content_type or "").split(";")[0].strip().lower()
    if kind == "application/octet-stream":
        if not body or len(body) % 4:
            raise RequestError(400, "octet-stream body must be non-empty raw "
                                    "little-endian float32 PCM")
        rate = 16000
        for param in (content_type or "").split(";")[1:]:
            name, _, value = param.strip().partition("=")
            if name.lower() == "rate":
                try:
                    rate = int(value)
                except ValueError:
                    raise RequestError(400, "rate parameter must be an integer")
        if rate <= 0:
            raise RequestError(400, "rate parameter must be positive")
        audio = np.frombuffer(body, dtype="<f4")
        if not np.isfinite(audio[:: max(1, audio.size // 64)]).all():
            # Spot-check only: NaN samples would poison the shared batch's features.
            raise RequestError(400, "PCM contains non-finite samples")
        return resample(audio, rate, 16000)
    if kind in ("audio/wav", "audio/x-wav", "audio/wave"):
        try:
            audio, rate = decode_wav_bytes(body)
        except Exception as error:
            raise RequestError(400, "invalid wav payload: {}".format(error))
        return resample(audio, rate, 16000)
    if kind in ("application/json", ""):
        try:
            payload = json.loads(body.decode("utf-8"))
        except (UnicodeDecodeError, json.JSONDecodeError) as error:
            raise RequestError(400, "invalid JSON body: {}".format(error))
        if not isinstance(payload, dict) or "pcm" not in payload:
            raise RequestError(400, 'JSON body must be {"pcm": [...]} '
                                    '(+ optional "sample_rate")')
        try:
            audio = np.asarray(payload["pcm"], dtype=np.float32)
        except (TypeError, ValueError) as error:
            raise RequestError(400, "pcm must be a flat float list: {}".format(error))
        if audio.ndim != 1 or audio.size == 0:
            raise RequestError(400, "pcm must be a non-empty 1-D float list")
        rate = int(payload.get("sample_rate", 16000))
        if rate <= 0:
            raise RequestError(400, "sample_rate must be positive")
        return resample(audio, rate, 16000)
    raise RequestError(415, "unsupported Content-Type {!r}; send audio/wav, "
                            "application/json, or application/octet-stream "
                            "(raw float32 PCM)".format(content_type))


class _HttpServer(ThreadingHTTPServer):
    # socketserver listens with a backlog of 5. More simultaneous connects (stream
    # sessions feeding at once) overflow it, and the clients' TCP retries them after a
    # second: 1 s feeds on the card.
    request_queue_size = 128
    daemon_threads = True


class TranscriptionServer:
    """A threaded HTTP server over a `serving.Transcriber`. ``port=0`` binds an
    ephemeral port (``server.port`` reports it). ``stream_window_s`` and
    ``stream_margin_s`` configure the streaming sessions' pool: the host pool
    (`StreamingSessionPool`), or with ``device_streams`` the device pool
    (`serving_device_stream.DeviceStreamingPool`: every session's window stays on the
    device, and with ``beam_mode="resident"`` every beam carry too). ``beam_engine``
    picks the beam sessions' decoder (`serving_streaming.beam_decoder_for`)."""

    def __init__(self, backend, host: str = "127.0.0.1", port: int = 8000,
                 max_batch: int = 16, max_wait_ms: float = 10.0,
                 stream_window_s: float = 8.0, stream_margin_s: float = 2.0,
                 max_queue: Optional[int] = None, device_streams: bool = False,
                 beam_engine: str = "auto", beam_mode: str = "posterior"):
        if beam_mode == "resident" and not device_streams:
            raise ValueError("beam_mode='resident' needs device_streams=True (the beam "
                             "carry lives in the pooled device state)")
        self.backend = backend
        # Bounded backlog (default 8 dispatches deep): past it the server sheds load
        # with 503 + Retry-After. 0 disables shedding (unbounded queue).
        if max_queue is None:
            max_queue = 8 * max_batch
        self.batcher = DynamicBatcher(backend, max_batch=max_batch,
                                      max_wait_ms=max_wait_ms,
                                      max_queue=max_queue or None)
        if device_streams:
            from .serving_device_stream import DeviceStreamingPool

            self.streams = DeviceStreamingPool(backend, window_s=stream_window_s,
                                               margin_s=stream_margin_s,
                                               max_batch=max_batch,
                                               max_wait_ms=max_wait_ms,
                                               beam_engine=beam_engine,
                                               beam_mode=beam_mode)
        else:
            self.streams = StreamingSessionPool(backend, window_s=stream_window_s,
                                                margin_s=stream_margin_s,
                                                max_batch=max_batch,
                                                max_wait_ms=max_wait_ms,
                                                beam_engine=beam_engine)
        self.started_at = time.time()
        self.httpd = _HttpServer((host, port), self._handler_class())
        self._serve_thread: Optional[threading.Thread] = None

    @property
    def port(self) -> int:
        return self.httpd.server_address[1]

    def start(self) -> None:
        """Start serving in a background thread (tests / embedding)."""
        self.batcher.start()
        self.streams.start()
        self._serve_thread = threading.Thread(target=self.httpd.serve_forever,
                                              daemon=True, name="transcribe-http")
        self._serve_thread.start()

    def serve_forever(self) -> None:
        """Serve on the calling thread (the CLI path) until interrupted."""
        self.batcher.start()
        self.streams.start()
        logger.info("serving on http://%s:%d (max_batch=%d, max_wait_ms=%s)",
                    self.httpd.server_address[0], self.port, self.batcher.max_batch,
                    self.batcher.max_wait_ms)
        try:
            self.httpd.serve_forever()
        except KeyboardInterrupt:
            pass
        finally:
            self.stop()

    def stop(self) -> None:
        self.httpd.shutdown()
        self.httpd.server_close()
        self.batcher.stop()
        self.streams.stop()

    def _transcribe_nbest(self, audio: np.ndarray, nbest_raw: str,
                          want_timestamps: bool) -> dict:
        """``?nbest=N``: the top N hypotheses with path scores, decoded on the batcher
        thread like every other request."""
        try:
            nbest = int(nbest_raw)
        except ValueError:
            raise RequestError(400, "nbest must be an integer")
        if nbest < 1:
            raise RequestError(400, "nbest must be >= 1")
        if want_timestamps:
            raise RequestError(400, "timestamps and nbest are mutually exclusive "
                                    "(timestamps describe the single best path)")
        if not hasattr(self.backend, "transcribe_nbest"):
            raise RequestError(501, "this backend has no n-best decode: AOT bundles export "
                                    "1-best programs only")
        if nbest > self.backend.beam_width:
            raise RequestError(400, "nbest must be <= the decoder's beam width ({})"
                               .format(self.backend.beam_width))
        return self.batcher.submit(audio, nbest=nbest)

    def _health(self) -> dict:
        return {
            "status": "ok",
            "uptime_s": round(time.time() - self.started_at, 1),
            "charset_size": len(self.backend.codec.allowed_characters),
            "sample_buckets": list(self.backend.sample_buckets),
            "max_batch": self.batcher.max_batch,
            "device": str(self.backend.device),
            "streaming_sessions": self.streams.session_count,
        }

    def _handler_class(self):
        server = self

        class Handler(BaseHTTPRequestHandler):
            protocol_version = "HTTP/1.1"

            def log_message(self, format, *args):
                logger.debug("http %s %s", self.address_string(), format % args)

            def _reply(self, status: int, payload: dict,
                       headers: Optional[dict] = None) -> None:
                body = json.dumps(payload).encode("utf-8")
                self.send_response(status)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(body)))
                for name, value in (headers or {}).items():
                    self.send_header(name, value)
                self.end_headers()
                self.wfile.write(body)

            def do_GET(self):
                path = urlparse(self.path).path
                if path == "/healthz":
                    self._reply(200, server._health())
                elif path in ("/metrics", "/v1/metrics"):
                    metrics = server.batcher.metrics()
                    metrics["streaming"] = server.streams.batcher.metrics()
                    self._reply(200, metrics)
                else:
                    self._reply(404, {"error": "unknown path {}".format(path)})

            def _read_body(self) -> bytes:
                length = int(self.headers.get("Content-Length", 0) or 0)
                if length <= 0:
                    raise RequestError(411, "Content-Length required")
                if length > _MAX_BODY_BYTES:
                    raise RequestError(413, "body exceeds {} bytes".format(_MAX_BODY_BYTES))
                return self.rfile.read(length)

            def _drain_body(self) -> None:
                """Discard an unused body: on a keep-alive connection its bytes would be
                parsed as the next request line."""
                length = int(self.headers.get("Content-Length", 0) or 0)
                while length > 0:
                    read = self.rfile.read(min(length, 1 << 20))
                    if not read:
                        break
                    length -= len(read)

            def do_POST(self):
                parsed = urlparse(self.path)
                try:
                    if parsed.path == "/v1/transcribe":
                        audio = _parse_audio(self.headers.get("Content-Type", ""),
                                             self._read_body())
                        query = parse_qs(parsed.query)
                        want_timestamps = query.get("timestamps", ["0"])[0] in (
                            "1", "true", "yes")
                        nbest = query.get("nbest", ["1"])[0]
                        if nbest not in ("", "1"):
                            self._reply(200, server._transcribe_nbest(audio, nbest,
                                                                      want_timestamps))
                        else:
                            self._reply(200, server.batcher.submit(audio,
                                                                   want_timestamps))
                    elif parsed.path == "/v1/stream":
                        self._stream_create()
                    elif parsed.path.startswith("/v1/stream/"):
                        self._stream_post(parsed.path[len("/v1/stream/"):])
                    else:
                        self._drain_body()
                        self._reply(404, {"error": "unknown path {}".format(parsed.path)})
                except RequestError as error:
                    self._reply(error.status, {"error": str(error)})
                except BatcherSaturated as error:
                    self._reply(503, {"error": str(error)},
                                headers={"Retry-After": str(
                                    max(1, int(round(error.retry_after_s))))})
                except UnknownSessionError as error:
                    # Raised only by the session lookups; any other KeyError is a
                    # server fault and answers 500 below.
                    self._reply(404, {"error": str(error)})
                except Exception as error:  # noqa: BLE001 — a serving loop must not die
                    logger.exception("request failed")
                    self._reply(500, {"error": "{}: {}".format(type(error).__name__,
                                                                error)})

            def _stream_create(self) -> None:
                """Open a session. The body is optional (a bare POST opens a greedy
                session); when present it is a JSON object."""
                has_body = int(self.headers.get("Content-Length", 0) or 0) > 0
                body = self._read_body() if has_body else b""
                final_decode, partial_decode = False, "greedy"
                if body.strip():
                    try:
                        options = json.loads(body)
                        final_decode = bool(options.get("final_decode", False))
                        partial_decode = str(options.get("partial_decode", "greedy"))
                    except (ValueError, AttributeError):
                        raise RequestError(400, "body must be empty or a JSON object")
                if partial_decode not in ("greedy", "beam", "beam_pipelined"):
                    raise RequestError(400, "partial_decode must be 'greedy', 'beam', or "
                                            "'beam_pipelined'")
                try:
                    session = server.streams.create(final_decode=final_decode,
                                                    partial_decode=partial_decode)
                except (ValueError, NotImplementedError) as error:
                    raise RequestError(501, str(error))  # a mode the backend lacks
                self._reply(200, {"session": session})

            def _stream_post(self, tail: str) -> None:
                if tail.endswith("/finish"):
                    self._drain_body()
                    self._reply(200, server.streams.finish_with_state(
                        tail[:-len("/finish")]))
                    return
                # Feed one chunk; the whole reply comes from one locked call, since a
                # second lookup could 404 after a concurrent finish or reap.
                audio = _parse_audio(self.headers.get("Content-Type", ""),
                                     self._read_body())
                try:
                    state = server.streams.feed_with_state(tail, audio)
                except ValueError as error:  # a window call the backend lacks
                    raise RequestError(501, str(error))
                state["final_up_to_s"] = round(state["final_up_to_s"], 3)
                self._reply(200, state)

        return Handler
