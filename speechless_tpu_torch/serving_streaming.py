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

Two-pass mode (``final_decode=True``): live greedy partials flow unchanged, and
`finish` re-decodes the complete audio through the offline path (full-utterance z-norm
and the word-LM beam when the transcriber has one).

The session core serves both session pools over the same HTTP routes (``POST
/v1/stream``, ``/v1/stream/<id>`` and ``/v1/stream/<id>/finish``): `StreamSession`
holds one session's contract and `SessionPool` the pool's rules. `StreamingSessionPool`
runs its sessions over one transcriber, their window dispatches micro-batched
(`StreamingFrameBatcher`) and their beam advances run as one batched advance
(`BeamAdvanceBatcher`), each on its own batcher thread;
`serving_device_stream.DeviceStreamingPool` keeps every session's window, and in its
resident mode every beam carry, on the device.
"""
import contextlib
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


def _serves_posteriors(backend) -> bool:
    """Whether ``backend`` serves per-frame posteriors (beam partials): it has
    `frame_log_probs` and its `supports_posteriors` predicate, where it has one, is
    true."""
    return (hasattr(backend, "frame_log_probs")
            and getattr(backend, "supports_posteriors", True))


BEAM_MODES = ("beam", "beam_pipelined")


def _check_partial_decode(partial_decode: str) -> None:
    if partial_decode not in ("greedy",) + BEAM_MODES:
        raise ValueError("partial_decode must be 'greedy', 'beam', or "
                         "'beam_pipelined', got {!r}".format(partial_decode))


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


class StreamSession:
    """One streaming session's contract, shared by the host stream
    (`StreamingTranscriber`) and the device session
    (`serving_device_stream.DeviceStreamingSession`): the live text, the replies of
    feed and finish under the session's lock, and the pipelined beam advance. A
    subclass implements `_feed_chunk(chunk) -> newly finalized text` and `_flush()`,
    both run under the lock, and emits through `_emit_frames` and `_advance_finalized`.

    A finished stream takes no more audio. A failed advance loses the stream for good:
    the greedy horizon has already moved past its rows, so resuming from the stale beam
    would silently drop that audio."""

    _lost_message = ("beam stream lost: a previous pipelined advance failed "
                     "mid-stream; reset() or open a new session")

    def __init__(self, transcriber, samples_per_frame: int, sample_rate: int,
                 final_decode: bool, partial_decode: str):
        _check_partial_decode(partial_decode)
        self._transcriber = transcriber
        self._codec = transcriber.codec
        self._blank = transcriber.blank_index
        self._spf = samples_per_frame
        self._sample_rate = sample_rate
        self._final_decode = final_decode
        self._partial_beam = partial_decode in BEAM_MODES
        self._beam_pipelined = partial_decode == "beam_pipelined"
        self._beam_decoder = None
        self.lock = threading.Lock()
        self.last_used = time.time()

    def _use_beam_decoder(self, decoder, advance_fn=None, submit_fn=None) -> None:
        """Advance through ``advance_fn(state, rows) -> (state, BeamStreamResult)``
        (default ``decoder.feed``); pipelined, through ``submit_fn``, whose handle's
        ``.wait()`` yields that pair (default: the advance, run at collection)."""
        self._beam_decoder = decoder
        self._beam_advance = advance_fn if advance_fn is not None else decoder.feed
        self._beam_submit = (submit_fn if submit_fn is not None else
                             lambda state, rows: _DeferredAdvance(self._beam_advance,
                                                                  state, rows))

    def _start_stream(self) -> None:
        """Fresh per-stream state: nothing fed, emitted or advanced."""
        self._finished = False
        self._lost: Optional[str] = None
        self._total = 0          # absolute samples fed
        self._emit_sample = 0    # everything before this absolute sample is final
        self._carry = -1         # last processed frame token (-1 = stream start)
        self._parts: List[str] = []
        self._audio_parts: List[np.ndarray] = []
        self._words = WordAssembler(self._codec, self._spf, self._sample_rate)
        self._beam_tokens = np.zeros(0, np.int32)
        self._beam_inflight = None  # pipelined mode's uncollected advance
        self._beam_pending = []     # finalized rows queued behind it
        if self._beam_decoder is not None:
            self._beam_state = self._beam_decoder.init_state()

    @property
    def text(self) -> str:
        """The live transcript: everything emitted so far (greedy mode), or the
        incremental beam's current best (beam modes: a replacement, not an append)."""
        if self._partial_beam:
            return self._codec.decode_graphemes(self._beam_tokens.tolist(),
                                                merge_repeated=False)
        return "".join(self._parts)

    @property
    def greedy_text(self) -> str:
        """The append-only greedy transcript (`.text` in greedy mode; beam modes still
        accumulate it, and it drives the word timestamps)."""
        return "".join(self._parts)

    @property
    def final_up_to_s(self) -> float:
        """Absolute stream time (seconds) up to which the transcript is final.

        Beam modes return 0.0 while live, since any later feed may re-rank tokens
        arbitrarily far back, and the full stream duration after `finish()`. The greedy
        horizon stays available as `greedy_final_up_to_s`."""
        if self._partial_beam:
            return self._total / self._sample_rate if self._finished else 0.0
        return self._emit_sample / self._sample_rate

    @property
    def greedy_final_up_to_s(self) -> float:
        """The greedy emission horizon (seconds): `greedy_text` and the word timestamps
        never change before this instant, in every mode."""
        return self._emit_sample / self._sample_rate

    def pop_new_words(self) -> List[dict]:
        """Word timestamps finalized since the last pop (absolute stream seconds)."""
        return self._words.pop_new_words()

    @contextlib.contextmanager
    def _held(self):
        """The session's lock, stamping ``last_used`` on exit: a call that waits long
        (a first kernel build) must not look idle and be reaped mid-call."""
        with self.lock:
            try:
                yield
            finally:
                self.last_used = time.time()

    def feed(self, chunk: np.ndarray) -> str:
        """Append audio; returns newly finalized text (possibly empty). In beam modes
        the return is the full current best transcript."""
        with self._held():
            return self._feed_locked(chunk)

    def feed_with_text(self, chunk: np.ndarray) -> Tuple[str, str, float]:
        """``(newly_finalized, full_text_so_far, final_up_to_s)``."""
        state = self.feed_with_state(chunk)
        return state["partial"], state["text"], state["final_up_to_s"]

    def feed_with_state(self, chunk: np.ndarray) -> dict:
        """Feed one chunk; returns ``{"partial", "text", "final_up_to_s", "words"}``
        (``words``: timestamps finalized by this feed) from one locked call, so that a
        concurrent finish or reap cannot lose the result."""
        with self._held():
            partial = self._feed_locked(chunk)
            return {"partial": partial, "text": self.text,
                    "final_up_to_s": self.final_up_to_s,
                    "words": self._words.pop_new_words()}

    def finish(self) -> str:
        """Flush the stream: decode everything pending with no right margin and return
        the newly finalized text (in beam modes the full best)."""
        with self._held():
            return self._finish_locked()

    def finish_with_live_text(self) -> Tuple[str, str]:
        """``(final_text, live_text)``, the same for single-pass sessions."""
        state = self.finish_with_state()
        return state["text"], state["live_text"]

    def finish_with_state(self) -> dict:
        """Flush; ``{"text", "live_text", "words", "final_up_to_s"}``: the offline
        second pass for ``final_decode`` sessions (else the live text), the live text,
        the words the flush finalized, and the stream's duration."""
        with self._held():
            self._finish_locked()
            live = self.text
            full = self._finalize_locked() if self._final_decode else live
            return {"text": full, "live_text": live,
                    "words": self._words.pop_new_words(),
                    "final_up_to_s": round(self.final_up_to_s, 3)}

    def finalize(self) -> str:
        """Two-pass final transcript: offline decode of the whole accumulated stream
        (full-utterance z-norm, the LM beam when the transcriber has one). Requires
        ``final_decode=True``; the live transcript stays available as `.text`."""
        with self.lock:
            return self._finalize_locked()

    def transcribe_stream(self, audio: np.ndarray, chunk_samples: int = 8000) -> str:
        """Feed ``audio`` in fixed-size chunks (a host stream resets first) and flush;
        returns `.text` after the flush, the complete transcript in every mode."""
        self._restart()
        for start in range(0, len(audio), chunk_samples):
            self.feed(audio[start:start + chunk_samples])
        self.finish()
        return self.text

    def _restart(self) -> None:
        """`StreamingTranscriber.reset`; a device session streams once."""

    def _finalize_locked(self) -> str:
        if not self._final_decode:
            raise ValueError("stream was not created with final_decode=True")
        if not self._audio_parts:
            return ""
        return self._transcriber.transcribe_long_audio(np.concatenate(self._audio_parts))

    def _feed_locked(self, chunk: np.ndarray) -> str:
        self._check_usable()
        chunk = np.asarray(chunk, np.float32).ravel()
        if self._final_decode:
            self._audio_parts.append(chunk)
        out = self._feed_chunk(chunk)
        return self.text if self._partial_beam else out  # beam partials replace

    def _finish_locked(self) -> str:
        if self._finished and self._lost is None:
            return ""  # flushed already
        self._check_usable()
        out = self._flush()
        self._drain_beam()  # the flush hands back the complete transcript
        self._words.flush()
        self._end()
        return self.text if self._partial_beam else out

    def _check_usable(self) -> None:
        if self._lost is not None:
            raise RuntimeError(self._lost)
        if self._finished:
            raise RuntimeError("session is finished")

    def _end(self) -> None:
        """Mark the stream finished, freeing what it holds once (`_release`)."""
        if not self._finished:
            self._finished = True
            self._release()

    def _release(self) -> None:
        """Free what the stream holds when it ends: the device session's row."""

    def _emit_frames(self, frames, count: int, buffer_start: int,
                     emit_limit: int) -> Tuple[int, str]:
        """`collapse_new_frames` into the greedy text and the words; returns the
        horizon before this step and the new text."""
        finalized_from = self._emit_sample
        emissions, self._emit_sample, self._carry = collapse_new_frames(
            frames, count, buffer_start, self._spf, self._emit_sample, self._carry,
            emit_limit, self._blank)
        if not emissions:
            return finalized_from, ""
        for token, start in emissions:
            self._words.push(token, start)
        part = self._codec.decode_graphemes([t for t, _ in emissions],
                                            merge_repeated=False)
        self._parts.append(part)
        return finalized_from, part

    def _advance_finalized(self, log_probs, finalized_from: int, buffer_start: int,
                           first_row: int = 0) -> None:
        """Advance the beam over exactly the rows the greedy rule just finalized,
        ``[finalized_from, _emit_sample)`` on the absolute axis, of ``log_probs`` (a
        window starting at ``buffer_start``, from its frame ``first_row`` on). max(0,
        .): should a degenerate configuration shift unemitted audio out of the window,
        the beam consumes the rows that are left rather than mis-sliced ones."""
        if self._emit_sample <= finalized_from:
            return
        row_from = max(0, (finalized_from - buffer_start) // self._spf)
        row_to = (self._emit_sample - buffer_start) // self._spf
        rows = log_probs[row_from - first_row:row_to - first_row]
        if self._beam_pipelined:
            # Queue the rows and pump without blocking: a finished advance seeds one
            # coalesced advance over everything queued since; one still in flight
            # leaves the rows for the next pump.
            if len(rows):
                self._beam_pending.append(rows)
            self._pump_beam(block=False)
        else:
            self._beam_state, result = self._beam_advance(self._beam_state, rows)
            self._beam_tokens = result.tokens

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
        failed advance surfaces here and loses the stream."""
        if self._beam_inflight is not None:
            inflight, self._beam_inflight = self._beam_inflight, None
            try:
                self._beam_state, result = inflight.wait()
            except BaseException:
                self._lost = self._lost_message  # what every later feed or finish raises
                self._end()
                raise
            self._beam_tokens = result.tokens


class StreamingTranscriber(StreamSession):
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
        private decoder, advanced directly. ``beam_advance_nowait_fn``: the pipelined
        submit (`StreamSession._use_beam_decoder`).

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
        super().__init__(transcriber, transcriber.samples_per_frame, sample_rate,
                         final_decode, partial_decode)
        if self._partial_beam:
            if frame_fn is None and not _serves_posteriors(transcriber):
                raise ValueError("partial_decode='beam' needs per-frame posteriors; this "
                                 "backend has no frame_log_probs")
            self._use_beam_decoder(
                beam_decoder if beam_decoder is not None
                else beam_decoder_for(transcriber, beam_chunk_frames,
                                      beam_max_decoded_length),
                beam_advance_fn, beam_advance_nowait_fn)
            default_fn = transcriber.frame_log_probs
        else:
            default_fn = transcriber.frame_tokens
        self._frame_fn = frame_fn if frame_fn is not None else default_fn
        # Window and margin aligned to the output frame grid, so the absolute
        # frame-to-sample mapping survives buffer drops.
        self._window = int(window_s * sample_rate) // self._spf * self._spf
        self._margin = int(margin_s * sample_rate) // self._spf * self._spf
        self.reset()

    def reset(self) -> None:
        """Start the stream afresh: after `finish`, or after a failed advance lost
        it."""
        self._start_stream()
        self._buffer = np.zeros(0, dtype=np.float32)
        self._buffer_start = 0   # absolute sample index of buffer[0]

    _restart = reset

    def _feed_chunk(self, chunk: np.ndarray) -> str:
        self._buffer = np.concatenate([self._buffer, chunk])
        self._total += len(chunk)
        return self._drain(flush=False)

    def _flush(self) -> str:
        return self._drain(flush=True)

    def _drain(self, flush: bool) -> str:
        out = ""
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
                finalized_from, part = self._emit_frames(frames, len(frames),
                                                         self._buffer_start, emit_limit)
                out += part
                if self._partial_beam:
                    self._advance_finalized(log_probs, finalized_from, self._buffer_start)
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
        return out


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


class SessionPool:
    """Many concurrent streaming sessions, shared by the host pool
    (`StreamingSessionPool`) and the device pool
    (`serving_device_stream.DeviceStreamingPool`)::

        sid = pool.create()
        partial = pool.feed(sid, chunk)      # newly finalized text
        final = pool.finish(sid)             # flush + close

    Sessions idle beyond ``idle_timeout_s`` are reaped (their text is lost; clients
    that want it must `finish`). Feeds to one session serialize on its lock; different
    sessions proceed concurrently and share batches, and beam sessions one decoder. A
    subclass owns ``batcher`` and implements `_open_locked` and `_check_mode`."""

    def __init__(self, transcriber, idle_timeout_s: float, max_sessions: int,
                 beam_engine: str = "auto", beam_opts: Optional[dict] = None):
        self._transcriber = transcriber
        self._idle_timeout_s = idle_timeout_s
        self.max_sessions = max_sessions
        self._sessions: Dict[str, StreamSession] = {}
        # Re-entrant: a reap under it ends sessions, and the end of a device session
        # hands its row back under it.
        self._lock = threading.RLock()
        self.beam_batcher: Optional[BeamAdvanceBatcher] = None
        self._beam_engine = beam_engine
        self._beam_opts = beam_opts or {}

    def start(self) -> None:
        self.batcher.start()
        with self._lock:
            if self.beam_batcher is not None and not self.beam_batcher.started:
                self.beam_batcher.start()

    def stop(self) -> None:
        self.batcher.stop()
        if self.beam_batcher is not None:
            self.beam_batcher.stop()
        with self._lock:
            self._close_all_locked()

    def _close_all_locked(self) -> None:
        self._sessions.clear()

    def create(self, final_decode: bool = False,
               partial_decode: str = "greedy") -> str:
        """``final_decode``: two-pass session; `finish` also re-decodes the whole audio
        through the offline path and returns that as the transcript.

        ``partial_decode``: ``"beam"`` serves live partials from the incremental beam
        (each feed's text replaces the previous one); ``"beam_pipelined"`` is the same
        beam with advances that overlap the client's next chunks (partials lag; the
        finish transcript equals ``"beam"``'s)."""
        _check_partial_decode(partial_decode)
        self._check_mode(partial_decode)
        with self._lock:
            self._reap_locked()
            if self._full_locked():
                raise RuntimeError("session limit reached ({})".format(
                    self.max_sessions))
            session_id = uuid.uuid4().hex[:16]
            self._sessions[session_id] = self._open_locked(final_decode, partial_decode)
            return session_id

    def _full_locked(self) -> bool:
        return len(self._sessions) >= self.max_sessions

    def _get_beam_batcher(self) -> BeamAdvanceBatcher:
        """The shared beam decoder in its `BeamAdvanceBatcher`, built at the first beam
        session, so that greedy-only pools never pay for it."""
        with self._lock:
            if self.beam_batcher is None:
                self.beam_batcher = BeamAdvanceBatcher(
                    beam_decoder_for(self._transcriber, engine=self._beam_engine,
                                     **self._beam_opts),
                    max_batch=self.batcher.max_batch,
                    max_wait_ms=self.batcher.max_wait_ms)
                if self.batcher.started:
                    self.beam_batcher.start()
            return self.beam_batcher

    def _beam_feed(self, state, rows):
        """A session's advance: batched while the beam batcher runs, direct otherwise
        (read per call, so sessions created before `start` adopt the batcher)."""
        batcher = self.beam_batcher
        if batcher.started:
            return batcher.submit(state, rows)
        return batcher.decoder.feed(state, rows)

    def _beam_feed_nowait(self, state, rows):
        """A session's pipelined submit, deferred to collection before `start`."""
        batcher = self.beam_batcher
        if batcher.started:
            return batcher.submit_nowait(state, rows)
        return _DeferredAdvance(batcher.decoder.feed, state, rows)

    def warm_up_beam(self) -> None:
        """Load the shared beam decoder's kernels (`BeamAdvanceBatcher.warm_up`) before
        beam traffic arrives, so that no live feed builds or loads one (with an empty
        build directory, it would run nvcc)."""
        self._get_beam_batcher().warm_up(self._transcriber.blank_index + 1)

    def feed(self, session_id: str, chunk: np.ndarray) -> str:
        return self.feed_with_text(session_id, chunk)[0]

    def feed_with_text(self, session_id: str,
                       chunk: np.ndarray) -> Tuple[str, str, float]:
        return self._get(session_id).feed_with_text(chunk)

    def feed_with_state(self, session_id: str, chunk: np.ndarray) -> dict:
        return self._get(session_id).feed_with_state(chunk)

    def text(self, session_id: str) -> str:
        return self._get(session_id).text

    def finish(self, session_id: str) -> str:
        """Flush and close; returns the complete transcript (the offline second pass for
        ``final_decode`` sessions, the live text otherwise)."""
        return self.finish_with_live_text(session_id)[0]

    def finish_with_live_text(self, session_id: str) -> Tuple[str, str]:
        """``(final_text, live_text)``, the same for single-pass sessions."""
        state = self.finish_with_state(session_id)
        return state["text"], state["live_text"]

    def finish_with_state(self, session_id: str) -> dict:
        """Flush and close (`StreamSession.finish_with_state`)."""
        state = self._get(session_id).finish_with_state()
        with self._lock:
            self._sessions.pop(session_id, None)
        return state

    def close(self, session_id: str) -> None:
        with self._lock:
            session = self._sessions.pop(session_id, None)
        if session is None:
            return
        # Under the session lock, so that a close racing a feed or finish cannot free
        # what that call still uses (a device row while its dispatch is queued: a new
        # session would get it and receive the old session's audio).
        with session.lock:
            session._end()

    @property
    def session_count(self) -> int:
        with self._lock:
            return len(self._sessions)

    def _get(self, session_id: str) -> StreamSession:
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
            self._sessions.pop(stale)._end()


class StreamingSessionPool(SessionPool):
    """A `SessionPool` over one transcriber: each session is a `StreamingTranscriber`
    whose window dispatches are micro-batched (`StreamingFrameBatcher`)."""

    def __init__(self, transcriber, window_s: float = 8.0, margin_s: float = 2.0,
                 max_batch: int = 16, max_wait_ms: float = 20.0,
                 idle_timeout_s: float = 300.0, max_sessions: int = 256,
                 beam_engine: str = "auto"):
        """``beam_engine``: the beam sessions' decoder (`beam_decoder_for`)."""
        # Fail at construction: a bad window/margin pair would otherwise surface as a
        # misleading error on every create().
        _check_window(window_s, margin_s)
        super().__init__(transcriber, idle_timeout_s, max_sessions, beam_engine)
        self._window_s = window_s
        self._margin_s = margin_s
        self.batcher = StreamingFrameBatcher(transcriber, max_batch=max_batch,
                                             max_wait_ms=max_wait_ms)
        # Beam-partial sessions run another window call (posteriors), so they batch
        # among themselves on a second thread; without posteriors they are refused.
        self.posterior_batcher = (
            StreamingFrameBatcher(transcriber, max_batch=max_batch,
                                  max_wait_ms=max_wait_ms, log_probs=True)
            if _serves_posteriors(transcriber) else None)

    def start(self) -> None:
        if self.posterior_batcher is not None:
            self.posterior_batcher.start()
        super().start()

    def stop(self) -> None:
        if self.posterior_batcher is not None:
            self.posterior_batcher.stop()
        super().stop()

    def _check_mode(self, partial_decode: str) -> None:
        if partial_decode in BEAM_MODES and self.posterior_batcher is None:
            raise ValueError("partial_decode='{}' needs per-frame posteriors; this "
                             "backend has no frame_log_probs".format(partial_decode))

    def _open_locked(self, final_decode: bool,
                     partial_decode: str) -> StreamingTranscriber:
        beam = partial_decode in BEAM_MODES
        beam_kwargs = {}
        if beam:
            beam_kwargs = dict(beam_decoder=self._get_beam_batcher().decoder,
                               beam_advance_fn=self._beam_feed,
                               beam_advance_nowait_fn=self._beam_feed_nowait)
        frame_fn = self.posterior_batcher.submit if beam else self.batcher.submit
        return StreamingTranscriber(self._transcriber, window_s=self._window_s,
                                    margin_s=self._margin_s, frame_fn=frame_fn,
                                    final_decode=final_decode,
                                    partial_decode=partial_decode, **beam_kwargs)

    def warm_up_beam(self) -> None:
        """`SessionPool.warm_up_beam`, for a backend with posteriors."""
        if self.posterior_batcher is None:
            raise ValueError("beam partials need per-frame posteriors; this "
                             "backend has no frame_log_probs program")
        super().warm_up_beam()
