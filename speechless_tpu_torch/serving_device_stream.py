"""Device-resident streaming: every session's audio window lives on the transcriber's
device (port of `speechless_tpu/serving_device_stream.py`, for live transcribers).

The host pool (`serving_streaming.py`, whose session core this pool shares) sends each
session's whole window (seconds of audio) to the device on every feed and stacks each
beam session's carry on the host. Here the pooled state stays on the device between
feeds:

* all sessions' windows are rows of one tensor, ``(max_sessions+1, window)`` fp32, with
  their valid lengths ``(max_sessions+1,)`` int32; the spare row ``max_sessions`` is the
  sink that `DeviceStreamingPool.warm_up` feeds;
* a feed uploads only its chunk. One fused dispatch (`_build_feed_fn`) appends each
  chunk to its session's row (the shift quantized to the output frame grid, so absolute
  frame positions stay valid across drops, as on the host path), runs the features and
  the model on the updated rows, and returns per-frame argmax tokens (plus, for beam
  sessions, log posteriors, or in resident mode the beam's best row);
* ``beam_mode="resident"`` keeps every beam session's carry on the device too: the
  dispatch advances it over the frames the emission rule finalizes, with the span and
  stitch kernels (`decode_incremental_kernel.KernelBeamStreamDecoder`) or the plain
  batched step (`decode_incremental.BeamStreamDecoder`).

Emission semantics match `serving_streaming.StreamingTranscriber` (frames within
``margin_s`` of the right edge are withheld; CTC collapse carries across windows). The
one difference: the device window always keeps the trailing ``window_s`` of audio,
more left context than the host path keeps after an emission drop, so the per-window
z-norm sees closer-to-offline statistics. Streams shorter than one window decode as on
the host path.

Unlike the JAX pool, a dispatch over a live transcriber runs only the rows it feeds:
PyTorch compiles nothing per shape, so padding every dispatch to ``max_batch`` rows would
be wasted work. Over an export bundle (`serving_export.ExportedTranscriber` with a feed
program, `export_feed_program`) the pool replays the bundle's feed, whose dimensions it
adopts over its own arguments; its fed rows are a dynamic dimension of the program, so
a dispatch runs them alone too (the JAX pool pads to ``max_batch``). Such a pool serves
beam partials in the posterior mode only. One batcher thread owns the pooled tensors.
"""
import functools
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from .features.spectrogram import features_batch, frame_count
from .models import wav2letter as w2l
from .serving_streaming import (BEAM_MODES, SessionPool, StreamSession, _check_window,
                                beam_decoder_for)
from .utils.microbatch import MicroBatcher, PendingItem
from .utils.tools import log

_POISONED_MESSAGE = ("stream lost: a device dispatch failed and the pool state was "
                     "reset; create a new session")

DEFAULT_POST_ROWS = 40

# Advance-range limit for non-beam rows of a resident dispatch: so negative that
# (limit - buffer_start) // spf never reaches a valid frame, and far from int32
# overflow when window-sized starts are subtracted.
_NO_EMIT_LIMIT = -(2 ** 30)


def _build_feed_fn(transcriber, window: int, chunk_cap: int, spf: int,
                   post_rows: Optional[int] = None, beam_decoder=None, device=None):
    """The fused append-and-decode over the pooled windows, on ``device`` (default the
    transcriber's).

    The window feed is ``(weights, buffers (S+1, W), lengths (S+1,), rows (B,), chunks
    (B, cap), chunk_lens (B,), resets (B,), post_starts=None) -> (tokens (B, F) int32,
    counts (B,), new_lens (B,), log_probs)``, all device tensors (``weights``: the
    model's tensors by name, `serving.Transcriber.weights`); it writes the updated rows
    of ``buffers`` and ``lengths`` in place. ``post_starts`` None computes no
    posteriors (a dispatch without beam sessions); else ``log_probs`` is the ``(B,
    post_rows, C)`` block of log posteriors starting at each row's ``post_starts``
    (clamped into the window). The block is sliced before the softmax, which is per
    frame, so its rows equal the full window's. ``post_rows`` None slices the whole
    window.

    The append shift is quantized up to ``spf`` (samples per output frame) so every
    row's window start stays on the absolute frame grid: the sessions mirror the same
    integer arithmetic on the host (`mirror_append`).

    With ``beam_decoder`` the resident feed is ``(weights, buffers, lengths, beam_state,
    rows, chunks, chunk_lens, resets, reset_rows, advance) -> (tokens, counts, new_lens,
    best_rows, scalars)``: ``beam_state`` is the pooled stacked carries
    (`stacked_fresh_state(S+1)`'s layout, whatever the decoder's lanes); the carries of
    ``reset_rows`` restart fresh first; ``advance`` None skips the beam, else it is
    ``(slots (m,), block_index (m, cf), valid (m,) host ints)``: the batch slots whose
    beams advance, the window frames of each one's advance block of ``cf`` rows (the
    first valid frame at row 0) and its valid frame count. Their carries advance
    through ``beam_decoder.advance_in_program`` and are written back; ``best_rows``
    ``(m, max_len)`` and ``scalars`` ``(m, 3)`` follow ``slots``."""
    config, model = transcriber.config, transcriber.model
    device = transcriber.device if device is None else device
    positions = torch.arange(window, device=device)
    chunk_positions = torch.arange(chunk_cap, device=device)
    frames = _window_frames(config, window)
    block_rows = torch.arange(post_rows or frames, device=device)

    def feed_core(weights, buffers, lengths, rows, chunks, chunk_lens, resets):
        length = torch.where(resets, 0, lengths[rows])
        ext = torch.cat([buffers[rows], torch.zeros_like(chunks)], dim=1)
        # The chunk arrives zero-masked beyond chunk_len, so the fixed-size write puts
        # zeros over the (already zero) tail.
        ext.scatter_(1, length[:, None].long() + chunk_positions, chunks)
        total = length + chunk_lens
        overflow = torch.clamp(total - window, min=0)
        shift = (overflow + spf - 1) // spf * spf
        # shift <= chunk_cap (a multiple of spf, and overflow <= chunk_len <= chunk_cap),
        # so the window read below never runs past the extension: a clamp there would
        # silently break the frame alignment.
        new_bufs = ext.gather(1, shift[:, None].long() + positions)
        new_lens = (total - shift).to(torch.int32)
        new_bufs = torch.where(positions < new_lens[:, None], new_bufs, 0.0)
        buffers[rows] = new_bufs
        lengths[rows] = new_lens
        feats, frame_counts = features_batch(new_bufs, torch.clamp(new_lens, min=1))
        logits = torch.func.functional_call(model, weights, (feats,))
        tokens = logits.argmax(dim=-1).to(torch.int32)
        return tokens, w2l.prediction_lengths(config, frame_counts), new_lens, logits

    def block(logits, index):
        """Rows ``index`` (B', n) of each row's frames, log-softmaxed."""
        return torch.log_softmax(
            logits.gather(1, index[..., None].expand(-1, -1, logits.shape[2])), dim=-1)

    if beam_decoder is not None:
        fresh = beam_decoder.stacked_fresh_state(1)

        def feed_fn(weights, buffers, lengths, beam_state, rows, chunks, chunk_lens,
                    resets, reset_rows, advance):
            tokens, counts, new_lens, logits = feed_core(weights, buffers, lengths, rows,
                                                         chunks, chunk_lens, resets)
            if len(reset_rows):
                # Before the advance: a reused row's carry must not reach it.
                for leaf, fresh_leaf in zip(beam_state, fresh):
                    leaf[reset_rows] = fresh_leaf
            if advance is None:
                return tokens, counts, new_lens, None, None
            slots, block_index, valid = advance
            session_rows = rows[slots]
            new_state, best_rows, scalars = beam_decoder.advance_in_program(
                [leaf[session_rows] for leaf in beam_state],
                block(logits[slots], block_index), valid)
            for leaf, new in zip(beam_state, new_state):
                leaf[session_rows] = new
            return tokens, counts, new_lens, best_rows, scalars
        return feed_fn

    def feed_fn(weights, buffers, lengths, rows, chunks, chunk_lens, resets,
                post_starts=None):
        tokens, counts, new_lens, logits = feed_core(weights, buffers, lengths, rows,
                                                     chunks, chunk_lens, resets)
        if post_starts is None:
            return tokens, counts, new_lens, None
        start = torch.clamp(post_starts, 0, frames - len(block_rows))
        return tokens, counts, new_lens, block(logits, start[:, None] + block_rows)
    return feed_fn


def _window_frames(config, window: int) -> int:
    """The feed's logits frame count for a full ``window``-sample row, from the conv
    arithmetic: the features' frames, then each layer's SAME-padded stride."""
    frames = frame_count(window)
    for spec in config.layers:
        frames = -(-frames // spec.stride)
    return frames


def export_feed_program(transcriber, window_s: float = 8.0, chunk_cap_s: float = 1.0,
                        max_sessions: int = 64, max_batch: int = 16,
                        posteriors: bool = False,
                        post_rows: Optional[int] = DEFAULT_POST_ROWS, device=None):
    """The window feed as an export bundle traces it: ``(fn, example inputs, dynamic
    shapes, spec)``. ``fn(weights, buffers, lengths, rows, chunks, chunk_lens, resets[,
    post_starts])`` is `_build_feed_fn`'s feed over ``max_sessions + 1`` window rows,
    which it updates in place, for 1 to ``max_batch`` fed rows a dispatch (the dynamic
    dimension), so that the bundle's pool runs the rows it feeds, as the live pool does,
    and gives the live pool's results bit for bit. ``posteriors`` adds the
    ``post_starts`` input and the log-posterior output (beam partials on the bundle's
    pool), a block of ``post_rows`` rows (None: the whole window). ``spec`` is the
    manifest entry the pool adopts: the dimensions baked into the program."""
    spf = transcriber.samples_per_frame
    device = transcriber.device if device is None else torch.device(device)
    window, chunk_cap = quantize_pool_dims(spf, window_s, chunk_cap_s)
    frames = _window_frames(transcriber.config, window)
    if not posteriors:
        post_rows = None
    if post_rows is not None:
        post_rows = _check_post_rows(post_rows, frames)
    feed = _build_feed_fn(transcriber, window, chunk_cap, spf, post_rows=post_rows,
                          device=device)
    if posteriors:
        fn = feed
    else:
        def fn(weights, buffers, lengths, rows, chunks, chunk_lens, resets):
            return feed(weights, buffers, lengths, rows, chunks, chunk_lens, resets)[:3]
    args = (torch.zeros((max_sessions + 1, window), device=device),
            torch.zeros((max_sessions + 1,), dtype=torch.int32, device=device),
            torch.full((max_batch,), max_sessions, dtype=torch.int64, device=device),
            torch.zeros((max_batch, chunk_cap), device=device),
            torch.zeros((max_batch,), dtype=torch.int32, device=device),
            torch.ones((max_batch,), dtype=torch.bool, device=device))
    if posteriors:
        args += (torch.zeros((max_batch,), dtype=torch.int64, device=device),)
    # One batch dimension for every fed-row input (a single row is a static shape).
    fed_rows = (torch.export.Dim("fed_rows", min=1, max=max_batch) if max_batch > 1
                else None)
    dynamic = (None, None) + tuple({0: fed_rows} if fed_rows else None for _ in args[2:])
    spec = {"window": window, "chunk_cap": chunk_cap, "max_sessions": max_sessions,
            "max_batch": max_batch, "samples_per_frame": spf, "posteriors": posteriors,
            "post_rows": post_rows, "window_frames": frames}
    return fn, args, dynamic, spec


def _fetch(*tensors) -> List[np.ndarray]:
    """Device tensors (int32 or float32) as numpy arrays through one copy to the host:
    every copy waits for the device, so the dispatch pays one wait."""
    flat = torch.cat([t.reshape(-1).view(torch.int32) if t.dtype == torch.float32
                      else t.reshape(-1).to(torch.int32) for t in tensors]).cpu().numpy()
    out, offset = [], 0
    for t in tensors:
        part = flat[offset:offset + t.numel()]
        offset += t.numel()
        if t.dtype == torch.float32:
            part = part.view(np.float32)
        out.append(part.reshape(tuple(t.shape)))
    return out


def quantize_pool_dims(samples_per_frame: int, window_s: float,
                       chunk_cap_s: float) -> Tuple[int, int]:
    """``(window, chunk_cap)`` in samples, aligned to the output frame grid."""
    spf = samples_per_frame
    window = int(window_s * 16000) // spf * spf
    chunk_cap = max(int(chunk_cap_s * 16000) // spf, 1) * spf
    return window, chunk_cap


def _check_post_rows(post_rows: int, frames: int) -> int:
    """Validate and clamp the posterior block size: at least 12 rows, at most the
    window's frame count (the slice offset is clamped to ``frames - post_rows``). The
    slack over the per-dispatch beam piece holds by construction:
    `DeviceStreamingPool.beam_piece_cap` derives the piece cap from ``post_rows``."""
    post_rows = int(post_rows)
    if post_rows < 12:
        raise ValueError("post_rows must be >= 12 (got {})".format(post_rows))
    return min(post_rows, frames)


def mirror_append(length: int, chunk_len: int, window: int, spf: int,
                  reset: bool = False) -> Tuple[int, int]:
    """Host mirror of the device append arithmetic: ``(new_length, shift)``."""
    if reset:
        length = 0
    total = length + chunk_len
    overflow = max(0, total - window)
    shift = -(-overflow // spf) * spf
    return total - shift, shift


class _DeviceFeedBatcher(MicroBatcher):
    """One thread owns the pooled device state: it collects (row, chunk) feeds from all
    sessions and serves them with one fused dispatch. No other thread ever touches the
    pooled tensors."""

    item_noun = "feeds"

    def __init__(self, pool: "DeviceStreamingPool", max_batch: int,
                 max_wait_ms: float):
        super().__init__(max_batch=max_batch, max_wait_ms=max_wait_ms,
                         name="device-stream-batcher")
        self._pool = pool

    def _serve(self, batch: List[PendingItem]) -> None:
        # A session's feeds serialize on its lock, so duplicate rows in one batch do
        # not happen in normal operation; a duplicate would make the row writes
        # order-dependent, so split rather than corrupt a window.
        served: Dict[int, bool] = {}
        group: List[PendingItem] = []
        for item in batch:
            row = item.payload[0]
            if row in served:
                self._pool._dispatch(group)
                served, group = {}, []
            served[row] = True
            group.append(item)
        if group:
            self._pool._dispatch(group)


class DeviceStreamingSession(StreamSession):
    """Host-side mirror of one device-resident streaming window: a
    `serving_streaming.StreamSession` whose chunks go through the pool's fused dispatch
    (`_dispatch`) and whose emissions come from the token rows it returns (`_emit`).
    Its row goes back to the pool when the session ends."""

    _lost_message = _POISONED_MESSAGE

    def __init__(self, pool: "DeviceStreamingPool", row: int,
                 final_decode: bool = False, partial_beam: bool = False,
                 beam_pipelined: bool = False):
        super().__init__(pool._transcriber, pool.spf, 16000, final_decode,
                         "beam_pipelined" if beam_pipelined
                         else "beam" if partial_beam else "greedy")
        self._pool = pool
        self._row = row
        self._beam_resident = self._partial_beam and pool.beam_mode == "resident"
        # Posterior blocks / resident beam: each dispatch finalizes at most one block.
        self._beam_blocks = self._partial_beam and (self._beam_resident
                                                    or pool.post_rows is not None)
        if self._beam_resident:
            # The carry lives in the pool's device state and advances inside the feed
            # dispatch; the host keeps the committed prefix (tokens rolled out when the
            # buffer fills), the fetched live best, and the reset flag the next
            # dispatch applies to this row.
            self._committed = np.zeros(0, np.int32)
            self._committed_score = 0.0
            self._live_tokens = np.zeros(0, np.int32)
            self._live_score = 0.0
            self._pending_beam_reset = True  # a reused row starts from a fresh carry
        elif self._partial_beam:
            # The pool's decoder, per-session state, advances coalesced through the
            # pool's BeamAdvanceBatcher, as on the host pool.
            self._use_beam_decoder(pool._get_beam_batcher().decoder, pool._beam_feed,
                                   pool._beam_feed_nowait)
        self._start_stream()
        self._pending_reset = True
        self._length = 0    # mirror of the device row's valid length

    def _release(self) -> None:
        with self._pool._lock:
            self._pool._free.append(self._row)

    def _feed_chunk(self, chunk: np.ndarray) -> str:
        """Chunks longer than the pool's ``chunk_cap`` split into several dispatches."""
        out = ""
        cap = self._pool.chunk_cap
        if self._beam_blocks:
            # Pieces fit the per-dispatch block, so a dispatch's newly finalized rows
            # always fit it (the emission cap in `_emit` is then a safety net at
            # steady state).
            cap = min(cap, self._pool.beam_piece_cap)
        for start in range(0, max(len(chunk), 1), cap):
            piece = chunk[start:start + cap]
            if len(chunk) and not len(piece):
                break
            out += self._emit(*self._dispatch(piece), flush=False)
        return out

    def _flush(self) -> str:
        out = ""
        if self._total:
            while True:
                before = self._emit_sample
                dispatched = self._dispatch(np.zeros(0, np.float32), flush=True)
                out += self._emit(*dispatched, flush=True)
                self._drain_beam()  # each block's advance completes before the next
                if not self._beam_blocks:
                    break
                # One flush dispatch drains at most one block of the withheld margin,
                # so dispatch empty pieces until the emission horizon reaches the
                # model's frame horizon.
                horizon = (self._total - self._length) + dispatched[1] * self._spf
                if self._emit_sample <= before or self._emit_sample >= horizon:
                    break
        return out

    def _beam_limit(self, buffer_start: int, emit_limit: int) -> int:
        """The emission limit capped at the end of this dispatch's advance block."""
        f_lo = max(0, (self._emit_sample - buffer_start) // self._spf)
        return min(emit_limit, buffer_start + (f_lo + self._pool._beam_cf) * self._spf)

    def _dispatch(self, piece: np.ndarray, flush: bool = False):
        """The pool's fused dispatch of ``piece``: `_emit`'s arguments."""
        mirrored, _ = mirror_append(self._length, len(piece), self._pool.window,
                                    self._spf)
        post_start = 0
        info = 0
        total_after = self._total + len(piece)
        buffer_start = total_after - mirrored
        if self._beam_resident:
            # The dispatch advances this row's carry over the frames the emission rule
            # will finalize. The range is integer arithmetic over lengths
            # (`mirror_append` is deterministic and `collapse_new_frames`' horizon does
            # not depend on token content), so it is known before dispatch.
            raw_limit = (total_after + self._spf if flush
                         else total_after - self._pool.margin)
            info = (total_after, mirrored, self._emit_sample,
                    self._beam_limit(buffer_start, raw_limit), self._pending_beam_reset)
        elif self._partial_beam and self._pool.post_rows is not None:
            # Newly finalized rows begin at the emission horizon; clamped so the block
            # stays inside the window (as the device clamps it).
            row_from = max(0, (self._emit_sample - buffer_start) // self._spf)
            post_start = max(0, min(row_from,
                                    self._pool.window_frames - self._pool.post_rows))
            info = post_start
        tokens, count, new_length, extra = self._pool.batcher.submit(
            (self._row, piece, self._pending_reset, self._partial_beam, info))
        self._pending_reset = False
        if self._beam_resident:
            self._pending_beam_reset = False
        self._total = total_after
        self._length = int(new_length)
        if self._length != mirrored:
            raise AssertionError("device window length {} diverged from host mirror {}"
                                 .format(self._length, mirrored))
        return np.asarray(tokens), int(count), extra, post_start

    def _emit(self, tokens: np.ndarray, count: int, log_probs, post_start: int,
              flush: bool) -> str:
        buffer_start = self._total - self._length  # spf-aligned by construction
        emit_limit = self._total + self._spf if flush else self._total - self._pool.margin
        if self._beam_resident:
            # The cap `_dispatch` used, from the same horizon (`_emit_sample` has not
            # moved yet), so host emission and the device advance stay in lockstep.
            emit_limit = self._beam_limit(buffer_start, emit_limit)
        elif self._partial_beam and self._pool.post_rows is not None:
            # Never finalize past the fetched posterior block: the beam can only
            # consume rows it has.
            emit_limit = min(emit_limit, buffer_start
                             + (post_start + self._pool.post_rows) * self._spf)
        finalized_from, part = self._emit_frames(tokens, count, buffer_start, emit_limit)
        if self._beam_resident:
            # The advance ran inside the dispatch. Lockstep check: the range the
            # dispatch advanced over must end where host emission just ended.
            f_hi = min(count, max(0, (emit_limit - buffer_start) // self._spf))
            f_lo = max(0, (finalized_from - buffer_start) // self._spf)
            expected = (buffer_start + f_hi * self._spf if f_hi > f_lo
                        else finalized_from)
            if self._emit_sample != expected:
                raise AssertionError(
                    "host emission horizon {} diverged from the device advance range "
                    "[{}, {}) (expected {})".format(self._emit_sample, f_lo, f_hi,
                                                     expected))
            if f_hi > f_lo:
                beam_row, scalars = log_probs
                count_live = int(scalars[0])
                self._live_tokens = np.asarray(beam_row[:count_live], np.int32)
                self._live_score = float(scalars[1])
                if (int(scalars[2]) + self._pool._beam_cf
                        > self._pool._resident_decoder.max_decoded_length):
                    # Rollover, as `StreamDecoderBase.feed`'s per-piece rule: any live
                    # prefix could reach capacity within the next block. Commit the
                    # best; the next dispatch restarts this row from a fresh carry.
                    self._committed = np.concatenate([self._committed,
                                                      self._live_tokens])
                    self._committed_score += self._live_score
                    self._live_tokens = np.zeros(0, np.int32)
                    self._live_score = 0.0
                    self._pending_beam_reset = True
            self._beam_tokens = (np.concatenate([self._committed, self._live_tokens])
                                 if self._committed.size else self._live_tokens)
        elif self._partial_beam:
            # As the host pool does, on the rows of the fetched posterior block, which
            # lie inside the trailing device window (window > margin by construction).
            self._advance_finalized(log_probs, finalized_from, buffer_start, post_start)
        return part


class DeviceStreamingPool(SessionPool):
    """Many concurrent streaming sessions whose windows live in pooled device rows: a
    `serving_streaming.SessionPool` (its sessions' rules and surface, which
    `serving_http.TranscriptionServer(device_streams=True)` serves over the same HTTP
    routes) whose sessions each hold one row. A feed sends its chunk to the device and
    reads back one token row; the window stays there.
    """

    def __init__(self, transcriber, window_s: float = 8.0, margin_s: float = 2.0,
                 max_batch: int = 16, max_wait_ms: float = 20.0,
                 chunk_cap_s: float = 1.0, idle_timeout_s: float = 300.0,
                 max_sessions: int = 64, beam_partials: Optional[bool] = None,
                 post_rows: Optional[int] = DEFAULT_POST_ROWS,
                 beam_engine: str = "auto", beam_mode: str = "posterior",
                 beam_opts: Optional[dict] = None):
        """``beam_partials``: let sessions open live beam partials
        (``create(partial_decode="beam")``); the feed then also returns log posteriors
        for the dispatches that carry beam sessions. Default on.

        ``post_rows``: the size of the posterior block a beam feed reads back (see
        `_build_feed_fn`): the ~chunk of newly finalized rows the advance consumes
        instead of the whole window. ``None`` returns the whole window.

        ``beam_engine``: the beam decoder (``"auto"``, ``"xla"``, ``"pallas"``; see
        `serving_streaming.beam_decoder_for`). ``beam_opts``: more of its arguments
        (``chunk_frames``, ``max_decoded_length``).

        ``beam_mode``: ``"posterior"``: beam sessions advance on the host's schedule
        through the pool's `BeamAdvanceBatcher` (``partial_decode="beam_pipelined"``
        too). ``"resident"``: every beam carry lives in the pool's device state and
        advances inside the feed dispatch, in blocks of ``chunk_frames`` (default 40)
        rows: no separate advance, partials never lag, and the final transcript equals
        the posterior mode's sync beam."""
        if beam_mode not in ("posterior", "resident"):
            raise ValueError("beam_mode must be 'posterior' or 'resident', "
                             "got {!r}".format(beam_mode))
        spec = getattr(transcriber, "device_feed_spec", None)
        if not hasattr(transcriber, "config") and spec is None:
            raise ValueError(
                "device-resident streaming needs a live serving.Transcriber or a "
                "bundle exported with device_streaming=... (this backend has neither a "
                "model config nor an exported feed program)")
        super().__init__(transcriber, idle_timeout_s, max_sessions, beam_engine,
                         beam_opts)
        self.codec = transcriber.codec
        self.blank_index = transcriber.blank_index
        spf = transcriber.samples_per_frame
        self.spf = spf
        self.device = transcriber.device
        self.beam_mode = beam_mode
        self._resident_decoder = None
        self._beam_pool = None
        # An export bundle's feed takes its baked posterior input (and gives its output)
        # on every dispatch, whether beam sessions feed or not.
        self._bundle_feed = not hasattr(transcriber, "config")
        if self._bundle_feed:
            if beam_mode == "resident":
                raise ValueError(
                    "beam_mode='resident' needs a live serving.Transcriber (the beam "
                    "carry advances inside the feed dispatch); exported bundles serve "
                    "beam partials via beam_mode='posterior'")
            requested = quantize_pool_dims(spf, window_s, chunk_cap_s)
            if requested != (spec["window"], spec["chunk_cap"]) or (
                    max_sessions, max_batch) != (spec["max_sessions"], spec["max_batch"]):
                log("device-stream pool adopting the bundle's baked dimensions "
                    "(window={} chunk_cap={} max_sessions={} max_batch={})".format(
                        spec["window"], spec["chunk_cap"], spec["max_sessions"],
                        spec["max_batch"]))
            self.window, self.chunk_cap = spec["window"], spec["chunk_cap"]
            self.max_sessions = spec["max_sessions"]
            max_batch = spec["max_batch"]
            self.post_rows = spec["post_rows"]
            self.window_frames = spec["window_frames"]
            self._feed = functools.partial(transcriber.device_feed_program,
                                           transcriber.weights)
            self._program_posteriors = bool(spec["posteriors"])
            if beam_partials and not self._program_posteriors:
                raise ValueError(
                    "beam partials need per-frame posteriors, but this bundle's feed "
                    "program was exported without them; re-export with "
                    "device_streaming={'posteriors': True}")
            self.beam_partials = (self._program_posteriors if beam_partials is None
                                  else beam_partials)
        else:
            self.beam_partials = True if beam_partials is None else beam_partials
            self.window, self.chunk_cap = quantize_pool_dims(spf, window_s, chunk_cap_s)
            self.window_frames = _window_frames(transcriber.config, self.window)
            self._prediction_ratio = transcriber.config.input_to_prediction_length_ratio
            if beam_mode == "resident":
                if not self.beam_partials:
                    raise ValueError("beam_mode='resident' builds the beam into the feed "
                                     "dispatch: it cannot be combined with "
                                     "beam_partials=False")
                # 40 rows = DEFAULT_POST_ROWS: the piece cap (`beam_piece_cap`) then cuts
                # feeds as the posterior mode does. The rollover guard scales with this
                # block, so posterior-mode equality at the rollover needs the same
                # ``chunk_frames`` on both pools.
                opts = dict(beam_opts or {})
                self._beam_cf = max(12, min(int(opts.pop("chunk_frames", 40)),
                                            self.window_frames))
                if self._beam_cf > self.window_frames:
                    raise ValueError(
                        "beam_mode='resident' advances blocks of at least 12 frames, but a "
                        "{} s window has {} frames: use a longer window".format(
                            window_s, self.window_frames))
                self._resident_decoder = beam_decoder_for(
                    transcriber, chunk_frames=self._beam_cf, engine=beam_engine, **opts)
                self.post_rows = None
                self._feed = functools.partial(
                    _build_feed_fn(transcriber, self.window, self.chunk_cap, spf,
                                   beam_decoder=self._resident_decoder),
                    transcriber.weights)
            else:
                self.post_rows = (_check_post_rows(post_rows, self.window_frames)
                                  if self.beam_partials and post_rows is not None else None)
                self._feed = functools.partial(
                    _build_feed_fn(transcriber, self.window, self.chunk_cap, spf,
                                   post_rows=self.post_rows), transcriber.weights)
        _check_window(self.window / 16000.0, margin_s)
        self.margin = int(margin_s * 16000) // spf * spf
        if self.window < self.margin + 4 * spf:
            # The window must outrun the margin by a few frames, or a fast feeder could
            # shift unemitted (pre-margin) audio out of the buffer.
            raise ValueError("window too small for margin at this frame rate")
        self._reset_device_state()
        self._free = list(range(self.max_sessions))
        self.batcher = _DeviceFeedBatcher(self, max_batch=max_batch,
                                          max_wait_ms=max_wait_ms)

    def _reset_device_state(self) -> None:
        """Fresh pooled tensors: zero windows and lengths, fresh beam carries."""
        rows = self.max_sessions + 1
        self._buffers = torch.zeros((rows, self.window), dtype=torch.float32,
                                    device=self.device)
        self._lengths = torch.zeros((rows,), dtype=torch.int32, device=self.device)
        if self._resident_decoder is not None:
            self._beam_pool = self._resident_decoder.stacked_fresh_state(rows)

    # -- lifecycle -------------------------------------------------------------------

    def _close_all_locked(self) -> None:
        """Retire every session ("stream lost") and free every row."""
        for session in self._sessions.values():
            session._lost, session._finished = _POISONED_MESSAGE, True
        self._sessions.clear()
        self._free = list(range(self.max_sessions))

    def warm_up(self) -> None:
        """One feed of the sink row before traffic (the first dispatch of a shape
        allocates and picks its convolution algorithms); in resident mode also one
        empty advance, which builds the decoder's kernels. No session row is
        touched."""
        item = (self.max_sessions, np.zeros(0, np.float32), True, False, 0)
        if self.batcher.started:
            # Serving already: through the batcher thread, the pooled state's owner.
            self.batcher.submit(item)
        else:
            self._dispatch([PendingItem(item)])
        if self._resident_decoder is not None:
            decoder = self._resident_decoder
            with torch.no_grad():
                decoder.advance_in_program(
                    decoder.stacked_fresh_state(1),
                    torch.zeros((1, self._beam_cf, self.blank_index + 1),
                                device=self.device), np.zeros(1, np.int64))

    def warm_up_beam(self) -> None:
        """`SessionPool.warm_up_beam`; a resident pool's advance runs in `warm_up`."""
        if self.beam_mode == "resident":
            self.warm_up()
            return
        if not self.beam_partials:
            raise ValueError("this pool was constructed with beam_partials=False: its "
                             "feed returns no posteriors")
        super().warm_up_beam()

    # -- sessions --------------------------------------------------------------------

    def _check_mode(self, partial_decode: str) -> None:
        if partial_decode == "beam_pipelined" and self.beam_mode == "resident":
            raise ValueError(
                "beam_mode='resident' pools have no separate advance to pipeline: the "
                "beam rides the feed dispatch itself; use partial_decode='beam' "
                "(partials are already lag-free)")
        if partial_decode in BEAM_MODES and not self.beam_partials:
            raise ValueError("beam partials disabled: this pool was constructed with "
                             "beam_partials=False (its feed returns no posteriors)")

    def _full_locked(self) -> bool:
        return not self._free

    def _open_locked(self, final_decode: bool,
                     partial_decode: str) -> DeviceStreamingSession:
        return DeviceStreamingSession(
            self, self._free.pop(), final_decode=final_decode,
            partial_beam=partial_decode in BEAM_MODES,
            beam_pipelined=partial_decode == "beam_pipelined")

    def create_stream(self, final_decode: bool = False,
                      partial_decode: str = "greedy") -> DeviceStreamingSession:
        """Library-facing variant: returns the session object itself."""
        return self._get(self.create(final_decode=final_decode,
                                     partial_decode=partial_decode))

    @property
    def beam_piece_cap(self) -> int:
        """Per-dispatch piece cap (samples) of beam sessions with posterior blocks: a
        few frames under ``post_rows`` so that one dispatch's newly finalized rows
        (piece frames plus one carry or quantization frame) always fit the block; 40
        rows give 32-frame pieces, one advance chunk. Resident pools use their advance
        block (``_beam_cf``) instead."""
        rows = self._beam_cf if self.beam_mode == "resident" else self.post_rows
        return min(self.chunk_cap, max(4, rows - 8) * self.spf)

    # -- internals -------------------------------------------------------------------

    def _recover_after_failed_dispatch(self) -> None:
        """Fresh pooled tensors, and every live session retired: a failed dispatch may
        have written some rows and not others. The failed batch's waiters see the
        error; later calls on old sessions raise 'stream lost'; new sessions start
        clean. Runs on the batcher thread."""
        self._reset_device_state()
        with self._lock:
            self._close_all_locked()

    def _frame_counts(self, new_lens: np.ndarray) -> np.ndarray:
        """Host mirror of the feed's valid logits frames for windows of ``new_lens``
        samples (the features on ``max(new_len, 1)`` samples, then the strides)."""
        return frame_count(np.maximum(new_lens, 1)) // self._prediction_ratio

    def _resident_advance(self, payloads: list):
        """The rows to reset and the advance of one resident dispatch, from the host's
        integers (no device sync): ``(reset_rows, advance, slots, host_counts)``
        (`_build_feed_fn`; ``slots`` are the advancing batch slots on the host). A row
        advances over the frames [f_lo, f_hi) that the emission rule finalizes; a
        non-beam row gets the limit `_NO_EMIT_LIMIT`, which leaves its range empty."""
        n = len(payloads)
        totals = np.zeros(n, np.int64)
        new_lens = np.zeros(n, np.int64)
        emit_samples = np.zeros(n, np.int64)
        emit_limits = np.full(n, _NO_EMIT_LIMIT, np.int64)
        reset_rows = []
        for i, (row, _, _, want_beam, info) in enumerate(payloads):
            if want_beam:
                totals[i], new_lens[i], emit_samples[i], emit_limits[i], reset = info
                if reset:
                    reset_rows.append(row)
        counts = self._frame_counts(new_lens)
        buffer_start = totals - new_lens
        # Floor division, as the emission rule's: these differences may be negative.
        f_lo = np.maximum(0, (emit_samples - buffer_start) // self.spf)
        f_hi = np.minimum(counts, np.maximum(0, (emit_limits - buffer_start) // self.spf))
        valid = np.maximum(0, f_hi - f_lo)
        slots = np.flatnonzero(valid > 0)
        advance = None
        if slots.size:
            cf = self._beam_cf
            # The block starts inside the window: where the horizon rides the window's
            # tail (flush drains) the start clamps, and the block is rolled so that the
            # first valid frame is its row 0.
            start = np.clip(f_lo[slots], 0, self.window_frames - cf)
            shift = f_lo[slots] - start
            block_index = start[:, None] + (np.arange(cf) + shift[:, None]) % cf
            advance = (torch.from_numpy(slots).to(self.device),
                       torch.from_numpy(block_index).to(self.device), valid[slots])
        reset_rows = torch.as_tensor(reset_rows, dtype=torch.int64, device=self.device)
        return reset_rows, advance, slots, counts

    def _dispatch(self, group: List[PendingItem]) -> None:
        """Serve one group of feeds (distinct rows) with a single fused dispatch and
        one copy back to the host. Runs only on the batcher thread (or before it
        starts), the pooled state's single owner."""
        n = len(group)
        payloads = [item.payload for item in group]
        rows = np.zeros(n, np.int64)
        chunks = np.zeros((n, self.chunk_cap), np.float32)
        chunk_lens = np.zeros(n, np.int32)
        resets = np.zeros(n, bool)
        for i, (row, piece, reset, _, _) in enumerate(payloads):
            rows[i] = row
            chunks[i, :len(piece)] = piece
            chunk_lens[i] = len(piece)
            resets[i] = reset
        any_beam = any(payload[3] for payload in payloads)
        device = self.device
        args = tuple(torch.from_numpy(array).to(device)
                     for array in (rows, chunks, chunk_lens, resets))
        resident = self.beam_mode == "resident"
        extra_rows = None
        try:
            with torch.no_grad():
                if resident:
                    reset_rows, advance, slots, host_counts = self._resident_advance(
                        payloads)
                    tokens, counts, new_lens, best_rows, scalars = self._feed(
                        self._buffers, self._lengths, self._beam_pool, *args, reset_rows,
                        advance)
                    fetched = _fetch(tokens, counts, new_lens, *(
                        (best_rows, scalars) if advance is not None else ()))
                else:
                    post_starts = ()
                    if any_beam or self._bundle_feed and self._program_posteriors:
                        post_starts = (torch.as_tensor([payload[4] for payload in payloads],
                                                       dtype=torch.int64, device=device),)
                    outputs = self._feed(self._buffers, self._lengths, *args,
                                         *post_starts)
                    tokens, counts, new_lens = outputs[:3]
                    fetched = _fetch(tokens, counts, new_lens, *(
                        outputs[3:] if any_beam else ()))
        except Exception:
            # Some rows may have been written and others not: without recovery every
            # later feed of every session would read a half-updated pool.
            self._recover_after_failed_dispatch()
            raise
        tokens, counts, new_lens = fetched[:3]
        if resident:
            beam_slots = [i for i, payload in enumerate(payloads) if payload[3]]
            if np.any(counts[beam_slots] != host_counts[beam_slots]):
                raise AssertionError("device frame counts {} diverged from the host "
                                     "mirror {}".format(counts, host_counts))
            if advance is not None:
                extra_rows = {int(slot): (fetched[3][j], fetched[4][j])
                              for j, slot in enumerate(slots)}
        elif len(fetched) > 3:
            extra_rows = dict(enumerate(fetched[3]))
        for i, item in enumerate(group):
            extra = extra_rows.get(i) if extra_rows and item.payload[3] else None
            item.result = (tokens[i], int(counts[i]), int(new_lens[i]), extra)
