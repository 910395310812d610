"""Streaming (online) transcription: text while audio is still arriving (port of
`speechless_tpu/serving_streaming.py`).

`StreamingTranscriber` wraps a `serving.Transcriber` and decodes incrementally:

* audio accumulates in a buffer; each `feed()` runs the per-frame program
  (`Transcriber.frame_tokens`: features and the acoustic model, no collapse) over a
  bounded window and CTC-collapses (merge repeats, drop blanks) across window
  boundaries by carrying the last processed frame token;
* frames within ``margin_s`` of the right edge are never emitted: the conv stack's
  receptive field is incomplete there, so their decisions could still change;
* once emitted, audio older than ``margin_s`` before the emission boundary is dropped
  (aligned to the frame grid), which bounds memory and per-feed work.

The approximation against offline greedy decoding is only the per-window feature
z-norm; a stream shorter than one window that is flushed by `finish()` decodes exactly
like the offline path.

Live beam partials (``partial_decode="beam"``): the incremental prefix beam
(`beam_decoder_for`: `ops/decode_incremental_kernel.py::KernelBeamStreamDecoder` on the
span and stitch kernels on CUDA, or, for a lexicon-constrained or unpruned search,
`ops/decode_incremental.py::BeamStreamDecoder`) advances over exactly the frames the
greedy rule finalized, with the transcriber's word LM when it has one. Beam partials
replace rather than append. ``"beam_pipelined"`` runs the same beam with the advances
overlapping the client's next chunks.

Multi-stream serving: `StreamingSessionPool` runs many concurrent sessions over one
transcriber. Their window dispatches are micro-batched (`StreamingFrameBatcher`) and
their beam advances run as one batched advance (`BeamAdvanceBatcher`), each on its own
batcher thread. Exposed over HTTP as ``POST /v1/stream``, ``/v1/stream/<id>`` and
``/v1/stream/<id>/finish``.

Two-pass mode (``final_decode=True``): live greedy partials flow unchanged, and
`finish` re-decodes the complete audio through the offline path (full-utterance z-norm
and the word-LM beam when the transcriber has one).

`serving_device_stream.DeviceStreamingPool` is the same surface with every session's
window, and in its resident mode every beam carry, kept on the device.
"""
import threading
import time
import uuid
from typing import Dict, List, Optional, Tuple

import numpy as np

from .utils.microbatch import MicroBatcher, PendingItem


class UnknownSessionError(KeyError):
    """The referenced streaming session does not exist (never created, already
    finished, or idle-reaped). Maps to HTTP 404; a type of its own so that the handler
    never takes an internal KeyError for a missing session."""


def collapse_new_frames(frames, count: int, buffer_start: int, spf: int,
                        emit_sample: int, carry: int, emit_limit: int,
                        blank: int) -> Tuple[List[Tuple[int, int]], int, int]:
    """One streaming CTC emission step.

    Walks ``frames[:count]`` (per-frame argmax tokens of a window starting at absolute
    sample ``buffer_start``), skipping frames already emitted (< ``emit_sample``) or
    beyond ``emit_limit`` (the margin or flush boundary), CTC-collapsing against
    ``carry`` (the previous frame's token; repeats and blanks emit nothing). Returns
    ``(new_emissions, emit_sample, carry)``; each emission is ``(token,
    absolute_start_sample)``, whose start gives the word timestamps.
    """
    new_emissions: List[Tuple[int, int]] = []
    for f in range(min(count, len(frames))):
        start = buffer_start + f * spf
        if start < emit_sample or start + spf > emit_limit:
            continue
        token = int(frames[f])
        if token != carry and token != blank:
            new_emissions.append((token, start))
        carry = token
        emit_sample = start + spf
    return new_emissions, emit_sample, carry


class WordAssembler:
    """Folds finalized ``(token, start_sample)`` emissions into word timestamps. Words
    close on the space grapheme or on `flush()`; times are absolute stream seconds: a
    word spans its first grapheme's frame start to its last grapheme's frame end."""

    def __init__(self, codec, spf: int, sample_rate: int = 16000):
        self._codec = codec
        self._spf = spf
        self._rate = sample_rate
        self._chars: List[str] = []
        self._start = 0
        self._end = 0
        self._new: List[dict] = []

    def push(self, token: int, start: int) -> None:
        char = self._codec.decode_graphemes([token], merge_repeated=False)
        if char == " ":
            self._close()
            return
        if not self._chars:
            self._start = start
        self._chars.append(char)
        self._end = start + self._spf

    def flush(self) -> None:
        """Close the trailing word (stream end)."""
        self._close()

    def pop_new_words(self) -> List[dict]:
        """Words finalized since the last pop, oldest first."""
        new, self._new = self._new, []
        return new

    def _close(self) -> None:
        if self._chars:
            self._new.append({"word": "".join(self._chars),
                              "start_s": round(self._start / self._rate, 3),
                              "end_s": round(self._end / self._rate, 3)})
            self._chars = []


def offline_final_pass(transcriber, audio_parts: List[np.ndarray]) -> str:
    """The two-pass final transcript: offline decode of the whole accumulated audio
    (full-utterance z-norm, silence segmentation, the LM beam when the transcriber has
    one)."""
    if not audio_parts:
        return ""
    return transcriber.transcribe_long_audio(np.concatenate(audio_parts))


def _serves_posteriors(backend) -> bool:
    """Whether ``backend`` serves per-frame posteriors (beam partials): it has
    `frame_log_probs` and its `supports_posteriors` predicate, where it has one, is
    true."""
    return (hasattr(backend, "frame_log_probs")
            and getattr(backend, "supports_posteriors", True))


def _check_window(window_s: float, margin_s: float) -> None:
    if window_s <= 2 * margin_s:
        raise ValueError("window_s must exceed 2*margin_s to make progress "
                         "(got window {}s, margin {}s)".format(window_s, margin_s))


def beam_decoder_for(transcriber, chunk_frames: int = 32,
                     max_decoded_length: int = 512, engine: str = "auto"):
    """The incremental prefix-beam decoder for ``transcriber``'s decode configuration
    (beam width, fusion weights, word LM, lexicon constraint, pruning), on its device.
    The decoder holds no per-stream state, so one instance serves any number of
    sessions.

    ``engine``: ``"pallas"`` is `KernelBeamStreamDecoder` (the span and stitch kernels
    for CUDA tensors, their plain versions for CPU tensors; the name is the JAX
    package's, whose kernel decoder ran in Pallas); ``"xla"`` is
    `decode_incremental.BeamStreamDecoder` (the plain batched beam step, then the
    stitch); ``"auto"`` takes the kernel decoder whenever it expresses the configuration
    (`kernel_beam_supported`: not lexicon-constrained, pruned, within the span kernel's
    lanes), on either device, so that the CPU runs the route the card runs.

    ``chunk_frames=32`` (0.5 s at 62.5 frames/s) hugs the live-feed cadence: a feed of
    0.5 s finalizes about that many frames, and a longer feed (the flush at finish)
    runs more pieces; results do not depend on the piece count."""
    from .ops.decode_incremental import BeamStreamDecoder
    from .ops.decode_incremental_kernel import (KernelBeamStreamDecoder,
                                                kernel_beam_supported)

    if engine not in ("auto", "xla", "pallas"):
        raise ValueError("unknown beam engine {!r} (auto/xla/pallas)".format(engine))
    decoder = getattr(transcriber, "_decoder", {})
    lexicon_constrained = getattr(transcriber, "lexicon_constrained", False)
    prune_classes = decoder.get("prune_classes", None)
    beam_width = decoder.get("beam_width", 25)
    if engine == "auto":
        engine = ("pallas" if not lexicon_constrained and kernel_beam_supported(
            transcriber.blank_index + 1, prune_classes, beam_width) else "xla")
    if engine == "pallas":
        if lexicon_constrained:
            raise ValueError("the kernel beam has no lexicon constraint: use "
                             "engine='xla' (or 'auto', which routes there)")
        if prune_classes is None:
            raise ValueError("the kernel beam requires pruned extensions "
                             "(prune_classes); unpruned decoding takes engine='xla' "
                             "(or 'auto', which routes there)")
        cls, kwargs = KernelBeamStreamDecoder, {}
    else:
        cls, kwargs = BeamStreamDecoder, {"lexicon_constrained": lexicon_constrained}
    return cls(
        blank=transcriber.blank_index,
        beam_width=beam_width,
        chunk_frames=chunk_frames,
        max_decoded_length=max_decoded_length,
        word_lm=getattr(transcriber, "word_lm", None),
        lm_weight=decoder.get("lm_weight", 0.8),
        word_count_weight=decoder.get("word_count_weight", 0.0),
        valid_word_count_weight=decoder.get("valid_word_count_weight", 2.3),
        prune_classes=prune_classes,
        device=transcriber.device, **kwargs)


class _DeferredAdvance:
    """Handle for pipelined advances when no batcher serves them: the advance runs at
    `.wait()` (collection time), with the batcher path's lag and without its overlap."""

    __slots__ = ("_fn", "_state", "_rows")

    #: Nothing progresses in the background, so collection is always allowed.
    ready = True

    def __init__(self, fn, state, rows):
        self._fn, self._state, self._rows = fn, state, rows

    def wait(self):
        return self._fn(self._state, self._rows)


class StreamingTranscriber:
    def __init__(self, transcriber, window_s: float = 8.0, margin_s: float = 2.0,
                 sample_rate: int = 16000, frame_fn=None,
                 final_decode: bool = False, partial_decode: str = "greedy",
                 beam_chunk_frames: int = 32, beam_max_decoded_length: int = 512,
                 beam_decoder=None, beam_advance_fn=None,
                 beam_advance_nowait_fn=None):
        """``frame_fn``: the per-frame window call (default ``transcriber.frame_tokens``,
        or ``transcriber.frame_log_probs`` in beam mode); a `StreamingFrameBatcher.submit`
        lets many streams share batched dispatches.

        ``beam_decoder`` / ``beam_advance_fn``: share one decoder (and a batched
        advance, e.g. `BeamAdvanceBatcher.submit`) across many beam-partial streams;
        the per-stream state rides in each stream's `BeamStreamState`. Defaults: a
        private decoder, advanced directly.

        ``final_decode``: two-pass mode; the stream also keeps every fed chunk on the
        host (3.84 MB per minute of 16 kHz float32) and `finalize()` re-decodes the whole
        audio through `transcribe_long_audio`.

        ``partial_decode``: ``"greedy"`` (live partials are the append-only collapsed
        argmax), ``"beam"`` (live partials come from the incremental prefix beam, with
        the transcriber's word LM; `feed` returns the full current best, which replaces
        earlier partials, and the greedy text and word timestamps stay available as
        `.greedy_text` / `pop_new_words`) or ``"beam_pipelined"`` (the same beam,
        advanced while the client gathers its next chunk: partials lag one feed or
        more, the transcript after `finish` is the same as ``"beam"``'s)."""
        _check_window(window_s, margin_s)
        if partial_decode not in ("greedy", "beam", "beam_pipelined"):
            raise ValueError("partial_decode must be 'greedy', 'beam', or "
                             "'beam_pipelined', got {!r}".format(partial_decode))
        self._transcriber = transcriber
        self._final_decode = final_decode
        self._partial_beam = partial_decode in ("beam", "beam_pipelined")
        self._beam_pipelined = partial_decode == "beam_pipelined"
        if self._partial_beam:
            if frame_fn is None and not _serves_posteriors(transcriber):
                raise ValueError("partial_decode='beam' needs per-frame posteriors; this "
                                 "backend has no frame_log_probs")
            self._beam_decoder = (beam_decoder if beam_decoder is not None
                                  else beam_decoder_for(transcriber, beam_chunk_frames,
                                                        beam_max_decoded_length))
            self._beam_advance = (beam_advance_fn if beam_advance_fn is not None
                                  else self._beam_decoder.feed)
            if self._beam_pipelined:
                # `beam_advance_nowait_fn(state, rows)` returns a handle whose `.wait()`
                # yields `(new_state, BeamStreamResult)`: the pools pass
                # `BeamAdvanceBatcher.submit_nowait`; standalone streams defer.
                self._beam_submit = (
                    beam_advance_nowait_fn if beam_advance_nowait_fn is not None
                    else lambda s, r: _DeferredAdvance(self._beam_advance, s, r))
            default_fn = transcriber.frame_log_probs
        else:
            self._beam_decoder = None
            default_fn = transcriber.frame_tokens
        self._frame_fn = frame_fn if frame_fn is not None else default_fn
        spf = transcriber.samples_per_frame
        # Window and margin aligned to the output frame grid, so the absolute
        # frame-to-sample mapping survives buffer drops.
        self._window = int(window_s * sample_rate) // spf * spf
        self._margin = int(margin_s * sample_rate) // spf * spf
        self._spf = spf
        self._sample_rate = sample_rate
        self.reset()

    def reset(self) -> None:
        self._buffer = np.zeros(0, dtype=np.float32)
        self._finished = False
        self._buffer_start = 0   # absolute sample index of buffer[0]
        self._emit_sample = 0    # everything before this absolute sample is final
        self._carry = -1         # last processed frame token (-1 = stream start)
        self._parts: List[str] = []
        self._audio_parts: List[np.ndarray] = []
        self._words = WordAssembler(self._transcriber.codec, self._spf,
                                    self._sample_rate)
        if self._partial_beam:
            self._beam_state = self._beam_decoder.init_state()
            self._beam_tokens = np.zeros(0, np.int32)
            self._beam_inflight = None  # pipelined mode's uncollected advance
            self._beam_pending = []     # finalized rows queued behind it
            self._beam_broken = False   # a failed pipelined advance breaks the stream

    @property
    def text(self) -> str:
        """The live transcript: everything emitted so far (greedy mode), or the
        incremental beam's current best (beam modes: a replacement, not an append)."""
        if self._partial_beam:
            return self._transcriber.codec.decode_graphemes(
                self._beam_tokens.tolist(), merge_repeated=False)
        return "".join(self._parts)

    @property
    def greedy_text(self) -> str:
        """The append-only greedy transcript (`.text` in greedy mode)."""
        return "".join(self._parts)

    @property
    def final_up_to_s(self) -> float:
        """Absolute stream time (seconds) up to which the transcript is final.

        Beam modes return 0.0 while live, since any later feed may re-rank tokens
        arbitrarily far back, and the full stream duration after `finish()`. The greedy
        horizon stays available as `greedy_final_up_to_s`."""
        if self._partial_beam:
            if self._finished:
                return (self._buffer_start + len(self._buffer)) / self._sample_rate
            return 0.0
        return self._emit_sample / self._sample_rate

    @property
    def greedy_final_up_to_s(self) -> float:
        """The greedy emission horizon (seconds): `greedy_text` and the word timestamps
        never change before this instant, in every mode."""
        return self._emit_sample / self._sample_rate

    def feed(self, chunk: np.ndarray) -> str:
        """Append audio; returns newly finalized text (possibly empty). In beam modes
        the return is the full current best transcript."""
        chunk = np.asarray(chunk, np.float32)
        if self._partial_beam and self._beam_broken:
            self._collect_beam()  # raises the broken-stream error
        if self._final_decode:
            self._audio_parts.append(chunk)
        self._buffer = np.concatenate([self._buffer, chunk])
        return self._drain(flush=False)

    def finish(self) -> str:
        """Flush the stream: decode everything pending with no right margin and return
        the newly finalized text. The stream can be reused after `reset()`."""
        out = self._drain(flush=True)
        self._words.flush()
        self._finished = True
        return out

    def pop_new_words(self) -> List[dict]:
        """Word timestamps finalized since the last pop (absolute stream seconds)."""
        return self._words.pop_new_words()

    def finalize(self) -> str:
        """Two-pass final transcript: offline decode of the whole accumulated stream.
        Requires ``final_decode=True``; the live transcript stays available as
        `.text`."""
        if not self._final_decode:
            raise ValueError("stream was not created with final_decode=True")
        return offline_final_pass(self._transcriber, self._audio_parts)

    def transcribe_stream(self, audio: np.ndarray, chunk_samples: int = 8000) -> str:
        """Reset, feed ``audio`` in fixed-size chunks, flush; returns the complete
        streamed transcript (`.text` after the flush, in every mode)."""
        self.reset()
        for start in range(0, len(audio), chunk_samples):
            self.feed(audio[start:start + chunk_samples])
        self.finish()
        return self.text

    def _drain(self, flush: bool) -> str:
        emitted_before = len(self._parts)
        blank = self._transcriber.blank_index
        codec = self._transcriber.codec
        while True:
            available = len(self._buffer)
            window_len = min(available, self._window)
            window_end = self._buffer_start + window_len
            last_window = window_len == available
            # Frames whose receptive field may still grow are not final, except at the
            # flush of the last window, where the (possibly partial) last frame is
            # emitted too.
            emit_limit = (window_end + self._spf if flush and last_window
                          else window_end - self._margin)
            if emit_limit > self._emit_sample:
                window_out = self._frame_fn(self._buffer[:window_len])
                if self._partial_beam:
                    # Beam modes get per-frame posteriors; the greedy machinery
                    # (emission boundary, words, greedy_text) runs on their argmax.
                    log_probs = np.asarray(window_out)
                    frames = log_probs.argmax(-1)
                else:
                    frames = window_out
                finalized_from = self._emit_sample
                emissions, self._emit_sample, self._carry = collapse_new_frames(
                    frames, len(frames), self._buffer_start, self._spf,
                    self._emit_sample, self._carry, emit_limit, blank)
                if self._partial_beam and self._emit_sample > finalized_from:
                    # Advance the beam over exactly the rows the greedy rule just
                    # finalized: [finalized_from, emit_sample) on the absolute axis.
                    row_from = (finalized_from - self._buffer_start) // self._spf
                    row_to = (self._emit_sample - self._buffer_start) // self._spf
                    rows = log_probs[row_from:row_to]
                    if self._beam_pipelined:
                        # Queue the rows and pump without blocking: a finished advance
                        # seeds one coalesced advance over everything queued since; one
                        # still in flight leaves the rows for the next pump.
                        if len(rows):
                            self._beam_pending.append(rows)
                        self._pump_beam(block=False)
                    else:
                        self._beam_state, result = self._beam_advance(
                            self._beam_state, rows)
                        self._beam_tokens = result.tokens
                if emissions:
                    self._parts.append(codec.decode_graphemes(
                        [t for t, _ in emissions], merge_repeated=False))
                    for token, start in emissions:
                        self._words.push(token, start)
            if last_window:
                break
            # More audio waits beyond this window: slide forward, dropping finalized
            # samples but keeping margin_s of left context. This runs even when the
            # window emitted nothing, so the buffer stays bounded on silent streams.
            new_start = max(self._buffer_start, self._emit_sample - self._margin)
            if new_start == self._buffer_start:
                break  # no progress without more audio (margin-bound)
            self._buffer = self._buffer[new_start - self._buffer_start:]
            self._buffer_start = new_start
        if self._partial_beam:
            if flush:
                self._drain_beam()  # the flush hands back the complete transcript
            return self.text
        return "".join(self._parts[emitted_before:])

    def _pump_beam(self, block: bool) -> None:
        """Pipelined-advance pump: collect the in-flight advance when it is done (or
        in any case with ``block``), then submit one advance over every queued row
        block. A session that fell behind catches up in one coalesced advance; the
        finish drain makes the final transcript complete either way."""
        if self._beam_inflight is not None:
            # Handles without a `ready` poll are collected at once.
            if not block and not getattr(self._beam_inflight, "ready", True):
                return
            self._collect_beam()
        if self._beam_pending:
            rows = (self._beam_pending[0] if len(self._beam_pending) == 1
                    else np.concatenate(self._beam_pending))
            self._beam_pending = []
            self._beam_inflight = self._beam_submit(self._beam_state, rows)

    def _drain_beam(self) -> None:
        """Collect and submit until no advance is in flight and no rows are queued."""
        while self._beam_inflight is not None or self._beam_pending:
            self._pump_beam(block=True)

    def _collect_beam(self) -> None:
        """Wait for the in-flight advance (if any) and adopt its state and best. A
        failed advance surfaces here and breaks the stream: the greedy horizon has
        already moved past its rows, so resuming from the stale beam would silently
        drop that audio. `reset()` (or a new session) recovers."""
        if self._beam_broken:
            raise RuntimeError("beam stream lost: a previous pipelined advance failed "
                               "mid-stream; reset() or open a new session")
        if self._beam_inflight is not None:
            inflight, self._beam_inflight = self._beam_inflight, None
            try:
                self._beam_state, result = inflight.wait()
            except BaseException:
                self._beam_broken = True
                raise
            self._beam_tokens = result.tokens


class StreamingFrameBatcher(MicroBatcher):
    """Batch the windows of many concurrent streams into shared dispatches: windows
    that arrive within ``max_wait_ms`` are served by one
    `Transcriber.frame_tokens_batch` (or `frame_log_probs_batch`) call; a lone window
    takes the single-window call."""

    item_noun = "windows"

    def __init__(self, transcriber, max_batch: int = 16, max_wait_ms: float = 20.0,
                 log_probs: bool = False):
        """``log_probs``: serve per-frame posteriors instead of argmax tokens (the
        window call of beam-partial streams); a pool runs one batcher per kind."""
        super().__init__(max_batch=max_batch, max_wait_ms=max_wait_ms,
                         name="streaming-{}-batcher".format(
                             "posteriors" if log_probs else "frame"))
        self._transcriber = transcriber
        self._single_name = "frame_log_probs" if log_probs else "frame_tokens"

    def submit(self, audio: np.ndarray) -> np.ndarray:
        """Frame tokens (or posteriors) for one window; blocks until its batch is
        served. This is the ``frame_fn`` of `StreamingTranscriber`."""
        return super().submit(np.asarray(audio, np.float32))

    def _serve(self, batch: List[PendingItem]) -> None:
        batched = getattr(self._transcriber, self._single_name + "_batch", None)
        if len(batch) == 1 or batched is None:
            single = getattr(self._transcriber, self._single_name)
            for pending in batch:
                pending.result = single(pending.payload)
        else:
            results = batched([pending.payload for pending in batch],
                              batch_size=self.max_batch)
            for pending, frames in zip(batch, results):
                pending.result = frames


class BeamAdvanceBatcher(MicroBatcher):
    """Batch the incremental-beam advances of concurrent beam-partial streams into one
    `feed_batch` (one device step per piece round for all of them). Payloads are
    ``(BeamStreamState, log_probs_rows)``, results ``(new_state, BeamStreamResult)``.

    The JAX package padded each batch to a bucketed size, because its batched program
    compiled once per batch size. PyTorch runs eagerly and the kernels take any row
    count, so a batch runs at its own size."""

    item_noun = "advances"

    def __init__(self, decoder, max_batch: int = 16, max_wait_ms: float = 20.0):
        super().__init__(max_batch=max_batch, max_wait_ms=max_wait_ms,
                         name="streaming-beam-batcher")
        self.decoder = decoder

    def submit(self, state, log_probs):
        return super().submit((state, log_probs))

    def submit_nowait(self, state, log_probs):
        """Enqueue an advance and return its `PendingItem` (``.wait()`` gives
        ``(new_state, BeamStreamResult)``): the pipelined-partials path."""
        return self._enqueue((state, log_probs))

    def warm_up(self, classes: int) -> None:
        """Load, building where none is cached, every kernel a beam feed launches,
        before beam traffic arrives: one throwaway single-stream feed (the path of a
        lone advance) and one two-stream `feed_batch` (the batched path; the kernels
        take any row count, so one size covers every batch), each of zero frames on a
        fresh state (one advance with count 0, which launches the same kernels and
        changes nothing). ``classes`` is the posterior class count (``blank_index +
        1``). The decoder holds no per-stream state, so no session sees a trace."""
        empty = np.zeros((0, classes), np.float32)
        self.decoder.feed(self.decoder.init_state(), empty)
        self.decoder.feed_batch([self.decoder.init_state()] * 2, [empty] * 2)

    def _serve(self, batch):
        if len(batch) == 1:
            state, rows = batch[0].payload
            batch[0].result = self.decoder.feed(state, rows)
            return
        results = self.decoder.feed_batch([p.payload[0] for p in batch],
                                          [p.payload[1] for p in batch])
        for pending, result in zip(batch, results):
            pending.result = result


class _Session:
    __slots__ = ("stream", "lock", "last_used")

    def __init__(self, stream: StreamingTranscriber):
        self.stream = stream
        self.lock = threading.Lock()
        self.last_used = time.time()


class StreamingSessionPool:
    """Many concurrent streaming sessions over one transcriber, their window dispatches
    and beam advances micro-batched::

        pool = StreamingSessionPool(transcriber)
        sid = pool.create()
        partial = pool.feed(sid, chunk)      # newly finalized text
        final = pool.finish(sid)             # flush + close

    Sessions idle beyond ``idle_timeout_s`` are reaped (their text is lost; clients
    that want it must `finish`). Feeds to one session serialize on its lock; different
    sessions proceed concurrently and share batches.
    """

    def __init__(self, transcriber, window_s: float = 8.0, margin_s: float = 2.0,
                 max_batch: int = 16, max_wait_ms: float = 20.0,
                 idle_timeout_s: float = 300.0, max_sessions: int = 256,
                 beam_engine: str = "auto"):
        """``beam_engine``: the beam sessions' decoder (`beam_decoder_for`)."""
        # Fail at construction: a bad window/margin pair would otherwise surface as a
        # misleading error on every create().
        _check_window(window_s, margin_s)
        self._transcriber = transcriber
        self._window_s = window_s
        self._margin_s = margin_s
        self._idle_timeout_s = idle_timeout_s
        self._max_sessions = max_sessions
        self._sessions: Dict[str, _Session] = {}
        self._lock = threading.Lock()
        self.batcher = StreamingFrameBatcher(transcriber, max_batch=max_batch,
                                             max_wait_ms=max_wait_ms)
        # Beam-partial sessions run another window call (posteriors), so they batch
        # among themselves on a second thread; without posteriors they are refused.
        self.posterior_batcher = (
            StreamingFrameBatcher(transcriber, max_batch=max_batch,
                                  max_wait_ms=max_wait_ms, log_probs=True)
            if _serves_posteriors(transcriber) else None)
        # Beam sessions share one decoder and batch their advances; built on the first
        # beam create(), so greedy-only pools never pay for it.
        self.beam_batcher: Optional[BeamAdvanceBatcher] = None
        self._beam_engine = beam_engine
        self._max_batch = max_batch
        self._max_wait_ms = max_wait_ms
        self._started = False

    def start(self) -> None:
        self.batcher.start()
        if self.posterior_batcher is not None:
            self.posterior_batcher.start()
        with self._lock:
            self._started = True
            if self.beam_batcher is not None and not self.beam_batcher.started:
                self.beam_batcher.start()

    def stop(self) -> None:
        self.batcher.stop()
        if self.posterior_batcher is not None:
            self.posterior_batcher.stop()
        if self.beam_batcher is not None:
            self.beam_batcher.stop()
        with self._lock:
            self._started = False
            self._sessions.clear()

    def create(self, final_decode: bool = False,
               partial_decode: str = "greedy") -> str:
        """``final_decode``: two-pass session; `finish` also re-decodes the whole audio
        through the offline path and returns that as the transcript.

        ``partial_decode``: ``"beam"`` serves live partials from the incremental beam
        (each feed's text replaces the previous one); ``"beam_pipelined"`` is the same
        beam with advances that overlap the client's next chunks (partials lag; the
        finish transcript equals ``"beam"``'s)."""
        beam = partial_decode in ("beam", "beam_pipelined")
        if beam and self.posterior_batcher is None:
            raise ValueError("partial_decode='{}' needs per-frame posteriors; this "
                             "backend has no frame_log_probs".format(partial_decode))
        with self._lock:
            self._reap_locked()
            if len(self._sessions) >= self._max_sessions:
                raise RuntimeError("session limit reached ({})".format(
                    self._max_sessions))
            session_id = uuid.uuid4().hex[:16]
            beam_kwargs = {}
            if beam:
                batcher = self._ensure_beam_batcher_locked()
                beam_kwargs = dict(beam_decoder=batcher.decoder,
                                   beam_advance_fn=batcher.submit,
                                   beam_advance_nowait_fn=batcher.submit_nowait)
            frame_fn = self.posterior_batcher.submit if beam else self.batcher.submit
            stream = StreamingTranscriber(self._transcriber, window_s=self._window_s,
                                          margin_s=self._margin_s, frame_fn=frame_fn,
                                          final_decode=final_decode,
                                          partial_decode=partial_decode, **beam_kwargs)
            self._sessions[session_id] = _Session(stream)
            return session_id

    def _ensure_beam_batcher_locked(self) -> BeamAdvanceBatcher:
        """Build (and start, if the pool runs) the shared beam-advance batcher. The
        caller holds `self._lock`."""
        if self.beam_batcher is None:
            self.beam_batcher = BeamAdvanceBatcher(
                beam_decoder_for(self._transcriber, engine=self._beam_engine),
                max_batch=self._max_batch, max_wait_ms=self._max_wait_ms)
            if self._started:
                self.beam_batcher.start()
        return self.beam_batcher

    def warm_up_beam(self) -> None:
        """Load the shared beam decoder's kernels (`BeamAdvanceBatcher.warm_up`) before
        beam traffic arrives, so that no live feed builds or loads one: with an empty
        build directory the first feed would otherwise run nvcc. Pools that never serve
        beam sessions skip this. Raises like ``create(partial_decode='beam')`` when the
        backend has no posteriors."""
        if self.posterior_batcher is None:
            raise ValueError("beam partials need per-frame posteriors; this "
                             "backend has no frame_log_probs program")
        with self._lock:
            batcher = self._ensure_beam_batcher_locked()
        batcher.warm_up(self._transcriber.blank_index + 1)

    def feed(self, session_id: str, chunk: np.ndarray) -> str:
        return self.feed_with_text(session_id, chunk)[0]

    def feed_with_text(self, session_id: str,
                       chunk: np.ndarray) -> Tuple[str, str, float]:
        """``(newly_finalized, full_text_so_far, final_up_to_s)``; see
        `feed_with_state`."""
        state = self.feed_with_state(session_id, chunk)
        return state["partial"], state["text"], state["final_up_to_s"]

    def feed_with_state(self, session_id: str, chunk: np.ndarray) -> dict:
        """Feed one chunk; returns ``{"partial", "text", "final_up_to_s", "words"}``
        (``words``: timestamps finalized by this feed) from one locked call, so that a
        concurrent finish or reap cannot lose the result."""
        session = self._get(session_id)
        with session.lock:
            try:
                partial = session.stream.feed(chunk)
                return {"partial": partial, "text": session.stream.text,
                        "final_up_to_s": session.stream.final_up_to_s,
                        "words": session.stream.pop_new_words()}
            finally:
                # Stamped on exit: a feed that waits long (a first kernel build) must
                # not look idle and be reaped mid-feed.
                session.last_used = time.time()

    def text(self, session_id: str) -> str:
        return self._get(session_id).stream.text

    def finish(self, session_id: str) -> str:
        """Flush and close; returns the complete transcript (the offline second pass for
        ``final_decode`` sessions, the live text otherwise)."""
        return self.finish_with_live_text(session_id)[0]

    def finish_with_live_text(self, session_id: str) -> Tuple[str, str]:
        """``(final_text, live_text)``, the same for single-pass sessions."""
        state = self.finish_with_state(session_id)
        return state["text"], state["live_text"]

    def finish_with_state(self, session_id: str) -> dict:
        """Flush and close; ``{"text", "live_text", "words", "final_up_to_s"}``:
        ``words`` are the timestamps the flush finalized, ``final_up_to_s`` the full
        stream duration."""
        session = self._get(session_id)
        with session.lock:
            session.stream.finish()
            live = session.stream.text
            full = session.stream.finalize() if session.stream._final_decode else live
            words = session.stream.pop_new_words()
            final_up_to = session.stream.final_up_to_s
        with self._lock:
            self._sessions.pop(session_id, None)
        return {"text": full, "live_text": live, "words": words,
                "final_up_to_s": round(final_up_to, 3)}

    def close(self, session_id: str) -> None:
        with self._lock:
            self._sessions.pop(session_id, None)

    @property
    def session_count(self) -> int:
        with self._lock:
            return len(self._sessions)

    def _get(self, session_id: str) -> _Session:
        with self._lock:
            self._reap_locked()
            session = self._sessions.get(session_id)
        if session is None:
            raise UnknownSessionError("unknown or expired session {!r}".format(session_id))
        return session

    def _reap_locked(self) -> None:
        cutoff = time.time() - self._idle_timeout_s
        for stale in [sid for sid, s in self._sessions.items()
                      if s.last_used < cutoff and not s.lock.locked()]:
            # A held lock means a feed or finish is running: never reap a live stream.
            del self._sessions[stale]
