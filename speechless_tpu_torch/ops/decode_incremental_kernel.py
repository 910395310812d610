"""Incremental (streaming) CTC prefix beam search on the port's kernels (port of
`speechless_tpu/ops/decode_incremental.py`'s host half and of
`speechless_tpu/ops/decode_incremental_pallas.py`).

The beam state is Markov: feeding frames [0, t1), [t1, t2), ... through per-chunk
advances that carry it gives exactly what one pass over [0, t2) gives. The one thing
the offline decoder rebuilds only at the end, the winning prefix, a streaming decoder
keeps current after every chunk: the state also carries a (lanes, max_len) token
buffer, stitched once per chunk from the chunk's backpointers (each surviving lane's
ancestor at chunk entry, then its emissions within the chunk).

One chunk advance of N streams (`stream_advance`) runs as follows:

* the chunk's frames are packed (`decode_lm.pack_frames`) and the span kernel
  (`decode_lm.lm_span`, CUDA source ``csrc/lm_beam_span.cu``) runs every frame of the
  chunk in one launch, with the word-LM gathers and the per-row ``t < counts`` mask
  inside it: a row with count 0 is an exact no-op;
* the stitch-and-rank kernel (`stream_stitch`, CUDA source ``csrc/stream_stitch.cu``)
  rebuilds every lane's token buffer from the chunk's backpointers and picks each
  stream's best lane with its (length, score, longest live length).

`StreamDecoderBase` runs an advance on the host's schedule: piece slicing, rollover
and `feed_batch`. `KernelBeamStreamDecoder` is its advance on `stream_advance`, with
per-stream state the kernel carry (pb, pnb, hash, last, len, lm[, trie node, word
context], each with r lanes) plus the (r, max_len) token buffer, on the decoder's
device; `decode_incremental.BeamStreamDecoder` is its advance on the plain batched
beam step, for the searches the span kernel does not express (`kernel_beam_supported`).

Beam partials are not append-only: later audio may re-rank the best hypothesis, so
each feed returns the full current best prefix (callers replace, not append). Frames
fed are consumed for good: callers feed only frames whose receptive field is complete.

The TPU version padded the rows to a multiple of 8 sublanes and capped the alphabet at
128 packed lanes; the port's kernels take any row count and class count.
"""
import threading
from typing import List, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from . import _kernels
from .beam_common import next_pow2
from .decode_lm import MAX_LANES, fresh_carry, pack_frames, span_function

DEFAULT_DEVICE = "cuda:0"  # the card unless the caller asks for the CPU


class BeamStreamResult(NamedTuple):
    """Best hypothesis after a feed: ``tokens`` (count,) int32 grapheme indices of the
    current best beam (the full prefix since stream start; it replaces any earlier
    partial) and its total path ``score`` (acoustic log prob + weighted LM terms)."""
    tokens: np.ndarray
    score: float


class BeamStreamState(NamedTuple):
    """Per-stream decoder state: the ``beam`` carry (a tuple of device tensors) plus the
    host-side ``committed`` prefix (tokens rolled out of the beam when a stream outgrows
    ``max_decoded_length``, see `KernelBeamStreamDecoder`) and its accumulated
    ``committed_score``."""
    beam: tuple
    committed: np.ndarray
    committed_score: float


def stitch_reference(parents: torch.Tensor, chars: torch.Tensor, tokens: torch.Tensor,
                     prev_len: torch.Tensor, new_len: torch.Tensor, final: torch.Tensor):
    """The stitch and the ranking in plain PyTorch (the gathers of the JAX package's
    `_pallas_stream_core`).

    ``parents``/``chars`` ``(N, F, r)`` int32: each frame's (parent lane, emitted char
    or -1); ``tokens`` ``(N, r, max_len)`` int32, the buffers at chunk entry;
    ``prev_len``/``new_len`` ``(N, r)`` int32, the prefix lengths at chunk entry and
    exit; ``final`` ``(N, r)`` fp32, each lane's ranking score. Returns ``(tokens
    (N, r, max_len), best rows (N, max_len), scalars (N, 3))`` with scalars (best
    length, best score, longest live length) in fp32; ties go to the lowest lane."""
    streams, frames, lanes = parents.shape
    max_len = tokens.shape[2]
    lane = torch.arange(lanes, device=parents.device).expand(streams, lanes)
    path = []
    for t in range(frames - 1, -1, -1):
        path.append(chars[:, t].gather(1, lane))
        lane = parents[:, t].gather(1, lane.long()).long()
    ancestors = lane
    path_chars = torch.stack(path[::-1], dim=2)                        # (N, r, F)
    t_range = torch.arange(frames, device=parents.device)
    # Front-compact the emitted characters in time order.
    order = torch.argsort(torch.where(path_chars >= 0, t_range, t_range + frames), dim=2)
    packed = path_chars.gather(2, order)
    entry_len = prev_len.gather(1, ancestors)                          # (N, r)
    old_rows = tokens.gather(1, ancestors[..., None].expand(-1, -1, max_len))
    out = torch.arange(max_len, device=parents.device)
    chunk_pos = (out - entry_len[..., None]).clamp(0, frames - 1)
    rows = torch.where(out < entry_len[..., None], old_rows, packed.gather(2, chunk_pos))
    rows = torch.where(out < new_len[..., None], rows, -1).to(torch.int32)
    best = final.argmax(dim=1, keepdim=True)                           # (N, 1)
    rows_best = rows.gather(1, best[..., None].expand(-1, -1, max_len))[:, 0]
    scalars = torch.stack([new_len.gather(1, best)[:, 0].to(torch.float32),
                           final.gather(1, best)[:, 0],
                           new_len.max(dim=1).values.to(torch.float32)], dim=1)
    return rows, rows_best, scalars


def stream_stitch(parents: torch.Tensor, chars: torch.Tensor, tokens: torch.Tensor,
                  prev_len: torch.Tensor, new_len: torch.Tensor, final: torch.Tensor):
    """The stitch and the ranking: the CUDA kernel for CUDA tensors, `stitch_reference`
    for CPU tensors. Same contract as `stitch_reference`; the output buffers are new
    tensors (the kernel reads other lanes' entry rows, so it never writes in place).
    ``stream_stitch.launches`` counts kernel launches. A build or launch failure
    raises, as does a shape the kernel refuses (no frames, or more lanes than its
    shared memory holds)."""
    if final.device.type == "cpu":
        return stitch_reference(parents, chars, tokens, prev_len, new_len, final)
    if final.device.type != "cuda":
        raise ValueError("stream_stitch runs on CPU or CUDA tensors, got {}".format(
            final.device))
    streams, frames, lanes = parents.shape
    max_len = tokens.shape[2]
    expected = ((parents, torch.int32, (streams, frames, lanes)),
                (chars, torch.int32, (streams, frames, lanes)),
                (tokens, torch.int32, (streams, lanes, max_len)),
                (prev_len, torch.int32, (streams, lanes)),
                (new_len, torch.int32, (streams, lanes)),
                (final, torch.float32, (streams, lanes)))
    for tensor, dtype, shape in expected:
        if tensor.device != final.device or tensor.dtype != dtype \
                or tuple(tensor.shape) != shape or not tensor.is_contiguous():
            raise ValueError(
                "stream_stitch: expected a contiguous {} tensor of shape {} on {}, got {} "
                "{} on {}".format(dtype, shape, final.device, tensor.dtype,
                                  tuple(tensor.shape), tensor.device))
    rows = torch.empty_like(tokens)
    rows_best = torch.empty((streams, max_len), dtype=torch.int32, device=final.device)
    scalars = torch.empty((streams, 3), dtype=torch.float32, device=final.device)
    with torch.cuda.device(final.device):
        status = _kernels.function("stream_stitch")(
            *(t.data_ptr() for t in (parents, chars, tokens, prev_len, new_len, final,
                                     rows, rows_best, scalars)),
            streams, frames, lanes, max_len, torch.cuda.current_stream().cuda_stream)
    if status != 0:
        raise RuntimeError("stream_stitch kernel launch failed with CUDA error {} "
                           "(F={}, r={})".format(status, frames, lanes))
    stream_stitch.launches += 1
    return rows, rows_best, scalars


stream_stitch.launches = 0


def stream_advance(stacked_state: Sequence[torch.Tensor], log_probs: torch.Tensor,
                   counts, *, blank: int, beam_width: int, max_decoded_length: int,
                   word_lm=None, lm_weight: float = 0.8, word_count_weight: float = 0.0,
                   valid_word_count_weight: float = 2.3, prune_classes: int = 8,
                   step=None, stitch=stream_stitch):
    """One chunk advance of N streams (the port of `_pallas_stream_core`).

    ``stacked_state`` is the carry leaves and the token buffer with a leading stream
    dimension (`stacked_fresh_state`'s layout), ``log_probs`` ``(N, F, C)`` on the
    state's device, ``counts`` ``(N,)`` valid frames per row (0 is an exact no-op).
    ``step`` None runs the span kernel (`decode_lm.span_function`); a one-frame
    function (`decode_lm.lm_step_reference`) runs the plain loop over it instead.
    ``stitch`` is the stitch function (the kernel, or `stitch_reference`).
    Returns ``(new stacked state, best rows (N, max_len), scalars (N, 3))``."""
    carry, tokens = list(stacked_state[:-1]), stacked_state[-1]
    device = tokens.device
    streams, frames, class_count = log_probs.shape
    k = min(prune_classes, class_count)
    counts = torch.as_tensor(counts)
    # Frames past every row's count are exact no-ops (identity backpointers, nothing
    # emitted): stop at the longest row, as the offline beam does.
    t_run = max(1, min(frames, int(counts.max()) if streams else 0))
    counts = counts.to(device=device, dtype=torch.int32)
    packed = pack_frames(log_probs, k)[:t_run]                         # (F, N, 2k + C)
    prev_len = carry[4]
    carry, parents, chars, tail_bonus = span_function(step)(
        packed, carry, counts, word_lm, k=k, blank=blank, beam_width=beam_width,
        max_decoded_length=max_decoded_length, lm_weight=lm_weight,
        word_count_weight=word_count_weight,
        valid_word_count_weight=valid_word_count_weight)
    pb, pnb, _, _, new_len, lm = carry[:6]
    final = torch.logaddexp(pb, pnb) + lm
    if word_lm is not None:
        # The trailing unterminated word joins the ranking, as in the offline beam.
        final = final + tail_bonus
    rows, rows_best, scalars = stitch(
        parents.contiguous(), chars.contiguous(), tokens.contiguous(),
        prev_len.contiguous(), new_len.contiguous(),
        final.to(torch.float32).contiguous())
    return carry + [rows], rows_best, scalars


def state_from_jax(beams, device) -> List[torch.Tensor]:
    """The JAX package's `PallasBeamStreamDecoder` carries as the port's stacked state.

    ``beams`` is a sequence of per-stream beams (``BeamStreamState.beam`` of the JAX
    decoder: pb, pnb, hash, last, len, lm[, trie node, word context] and the token
    buffer), their leaves anything `numpy.asarray` takes. Returns the leaves stacked
    along a leading stream dimension, float leaves as fp32 and integer leaves as
    int32, on ``device``."""
    stacked = []
    for leaves in zip(*beams):
        array = np.stack([np.asarray(leaf) for leaf in leaves])
        dtype = np.float32 if np.issubdtype(array.dtype, np.floating) else np.int32
        stacked.append(torch.from_numpy(array.astype(dtype)).to(device))
    return stacked


def kernel_beam_supported(class_count: int, prune_classes: Optional[int],
                          beam_width: int) -> bool:
    """Whether `KernelBeamStreamDecoder` expresses this search as it is configured: the
    packed frame row holds the top ``prune_classes`` classes (an unpruned search has no
    such row), and the span kernel runs one thread per candidate lane, at most
    `decode_lm.MAX_LANES` of them (``(k + 1) * r`` padded to a power of two)."""
    if prune_classes is None:
        return False
    k = min(prune_classes, class_count)
    return next_pow2((k + 1) * next_pow2(max(beam_width, 8))) <= MAX_LANES


def _host(x) -> np.ndarray:
    """A device tensor as a numpy array on the host."""
    return x.cpu().numpy()


class StreamDecoderBase:
    """The host half of a streaming prefix-beam decoder: per-stream state, piece
    slicing, rollover and `feed_batch`. A subclass gives its fresh carry
    (`stacked_fresh_state`) and its one-piece advance of N stacked streams
    (`advance_in_program`). The decoder holds no per-stream state, so one instance
    serves any number of streams: `init_state()` per stream, then `feed(state,
    log_probs)` with each newly finalized frame range.

    ``chunk_frames`` is the frame capacity of one advance: feeds are cut into pieces of
    at most ``chunk_frames`` frames (the last zero-padded and masked). ``device`` holds
    the state and runs the advance.

    Unbounded streams: the carried token buffer is (lanes, ``max_decoded_length``), and
    the beam step forbids extending a prefix at capacity, so a transcript that outgrew
    the buffer would silently stop emitting. The decoder therefore rolls over first:
    whenever any live prefix could reach capacity within the next chunk, the best one
    is committed to a host-side buffer and the beam restarts fresh. Committed text is
    final, and the LM context does not span the seam (the new segment starts at BOS and
    the trie root), so quality dips only at seams ``max_decoded_length`` characters
    apart.
    """

    def __init__(self, blank: int, beam_width: int, max_decoded_length: int,
                 chunk_frames: int, device):
        if chunk_frames < 1:
            raise ValueError("chunk_frames must be >= 1")
        if chunk_frames > max_decoded_length:
            # Rollover happens between chunks; a chunk longer than the buffer could
            # saturate (and silently drop characters) within one step.
            raise ValueError(
                "chunk_frames ({}) must not exceed max_decoded_length ({})".format(
                    chunk_frames, max_decoded_length))
        self.blank = blank
        self.beam_width = beam_width
        self.max_decoded_length = max_decoded_length
        self.chunk_frames = chunk_frames
        self.device = torch.device(device)
        # Load counters: how many feed/feed_batch calls ran and how many
        # chunk_frames-piece rounds they cost (pieces > feeds means sessions fell
        # behind the live cadence and caught up in multi-piece advances). Threads that
        # share the decoder update them under a lock.
        self.stat_feeds = 0
        self.stat_piece_rounds = 0
        self._stat_lock = threading.Lock()

    def stacked_fresh_state(self, n: int) -> List[torch.Tensor]:
        """``n`` fresh carries as one stacked state (leading dimension ``n``): the
        carry leaves and the token buffer, the layout `advance_in_program` takes."""
        raise NotImplementedError

    def advance_in_program(self, stacked_state: Sequence[torch.Tensor],
                           log_probs: torch.Tensor, counts):
        """One piece advance of N streams on the decoder's device: ``stacked_state``
        in `stacked_fresh_state`'s layout, ``log_probs`` ``(N, F, C)`` on the device,
        ``counts`` ``(N,)`` valid frames per row on the host (0 is an exact no-op).
        Returns ``(new stacked state, best rows (N, max_len) int32, scalars (N, 3)
        fp32)`` with scalars (best length, best score, longest live length). It reads
        nothing back to the host, so a caller that stacks its carries (the device pool's
        resident feed) runs it between its own launches."""
        raise NotImplementedError

    def _count(self, pieces: int) -> None:
        with self._stat_lock:
            self.stat_feeds += 1
            self.stat_piece_rounds += pieces

    def _fresh_beam(self) -> tuple:
        return tuple(leaf[0] for leaf in self.stacked_fresh_state(1))

    def init_state(self) -> BeamStreamState:
        """Fresh per-stream state: the offline decoder's initial carry plus the token
        buffer, and an empty committed prefix."""
        return BeamStreamState(self._fresh_beam(), np.zeros(0, np.int32), 0.0)

    def _step(self, beams: list, batch_lp: np.ndarray, valid: np.ndarray):
        """One-piece advance of N streams: ``(new_beams (N tuples), best rows
        (N, max_len), scalars (N, 3))``."""
        stacked = [torch.stack(leaves) for leaves in zip(*beams)]
        new, rows, scalars = self.advance_in_program(
            stacked, torch.from_numpy(batch_lp).to(self.device), valid)
        return [tuple(leaf[i] for leaf in new) for i in range(len(beams))], rows, scalars

    def feed(self, state: BeamStreamState,
             log_probs: np.ndarray) -> Tuple[BeamStreamState, BeamStreamResult]:
        """Advance the beam over ``log_probs`` (t, classes); the frames are consumed.
        Returns ``(new_state, BeamStreamResult)`` whose tokens are the committed prefix
        plus the live beam's current best; an empty feed returns the current best from
        the carried buffer (one step with count 0)."""
        log_probs = np.asarray(log_probs, np.float32)
        if log_probs.ndim != 2:
            raise ValueError("log_probs must be (frames, classes), got shape {}".format(
                log_probs.shape))
        beam, committed, committed_score = state
        pieces = max(1, -(-log_probs.shape[0] // self.chunk_frames))
        self._count(pieces)
        tokens = None
        count, score = 0, 0.0
        for p in range(pieces):
            piece = log_probs[p * self.chunk_frames:(p + 1) * self.chunk_frames]
            valid = piece.shape[0]
            if valid < self.chunk_frames:
                piece = np.pad(piece, ((0, self.chunk_frames - valid), (0, 0)))
            beams, rows, scalars = self._step([beam], piece[None],
                                              np.asarray([valid], np.int32))
            beam, tokens = beams[0], rows[0]
            count_f, score_f, max_live = _host(scalars[0])
            count, score = int(count_f), float(score_f)
            if int(max_live) + self.chunk_frames > self.max_decoded_length:
                # Rollover (see the class docstring): any live prefix, not just the
                # best, could reach capacity within the next chunk, lose characters
                # there and later win. Commit the best and restart.
                committed = np.concatenate(
                    [committed, _host(tokens)[:count].astype(np.int32)])
                committed_score += score
                beam = self._fresh_beam()
                tokens = None
                count, score = 0, 0.0
        live = (np.zeros(0, np.int32) if tokens is None
                else _host(tokens)[:count].astype(np.int32))
        full = np.concatenate([committed, live]) if committed.size else live
        return (BeamStreamState(beam, committed, committed_score),
                BeamStreamResult(full, committed_score + score))

    def feed_batch(self, states: List[BeamStreamState],
                   log_probs_list: List[np.ndarray]
                   ) -> List[Tuple[BeamStreamState, BeamStreamResult]]:
        """Advance many independent streams together: each piece round is one batched
        advance for all streams and one fetch of the stacked scalars, with exactly the
        per-stream results of sequential `feed` calls.

        Rows are padded to a common piece count; a zero-length piece is an exact no-op
        on its stream's state. Rollover (see the class docstring) is handled per row
        between piece rounds.
        """
        if len(states) != len(log_probs_list):
            raise ValueError("states and log_probs_list lengths differ")
        if not states:
            return []
        if len(states) == 1:
            return [self.feed(states[0], log_probs_list[0])]
        arrays = []
        for lp in log_probs_list:
            lp = np.asarray(lp, np.float32)
            if lp.ndim != 2:
                raise ValueError(
                    "log_probs must be (frames, classes), got shape {}".format(lp.shape))
            arrays.append(lp)
        n = len(arrays)
        classes = arrays[0].shape[1]
        if any(lp.shape[1] != classes for lp in arrays):
            raise ValueError("all rows must share one class count (one model)")
        cf = self.chunk_frames
        beams = [s.beam for s in states]
        committed = [s.committed for s in states]
        committed_score = [float(s.committed_score) for s in states]
        pieces = max(1, max(-(-lp.shape[0] // cf) for lp in arrays))
        self._count(pieces)
        rolled_in_final_piece = [False] * n
        for p in range(pieces):
            batch_lp = np.zeros((n, cf, classes), np.float32)
            valid = np.zeros(n, np.int32)
            for i, lp in enumerate(arrays):
                piece = lp[p * cf:(p + 1) * cf]
                batch_lp[i, : piece.shape[0]] = piece
                valid[i] = piece.shape[0]
            beams, rows, scalars = self._step(beams, batch_lp, valid)
            scal = _host(scalars)  # one fetch per piece round
            counts = scal[:, 0].astype(np.int64)
            scores = scal[:, 1].astype(np.float64)
            max_live = scal[:, 2].astype(np.int64)
            rows_np = None
            rollover = {i for i in range(n) if max_live[i] + cf > self.max_decoded_length}
            if rollover:
                rows_np = _host(rows)  # the rows are fetched mid-loop only for a roll
                for i in rollover:
                    committed[i] = np.concatenate(
                        [committed[i], rows_np[i, : counts[i]].astype(np.int32)])
                    committed_score[i] += scores[i]
                    beams[i] = self._fresh_beam()
            rolled_in_final_piece = [i in rollover for i in range(n)]
        if rows_np is None:
            rows_np = _host(rows)
        out = []
        for i in range(n):
            if rolled_in_final_piece[i]:
                live = np.zeros(0, np.int32)
                live_score = 0.0
            else:
                live = rows_np[i, : counts[i]].astype(np.int32)
                live_score = scores[i]
            full = np.concatenate([committed[i], live]) if committed[i].size else live
            out.append((BeamStreamState(beams[i], committed[i], committed_score[i]),
                        BeamStreamResult(full, committed_score[i] + live_score)))
        return out


class KernelBeamStreamDecoder(StreamDecoderBase):
    """Streaming prefix-beam decoder on `stream_advance`: the span kernel and the
    stitch-and-rank kernel once per chunk on CUDA, their plain versions on the CPU
    (the port of `PallasBeamStreamDecoder`). Its carry has r = next_pow2(max(W, 8))
    lanes. See `StreamDecoderBase` for the per-stream surface and rollover.

    ``step`` (a one-frame function for the plain frame loop instead of the span kernel)
    and ``stitch`` run the plain versions on CUDA tensors. ``prune_classes=None``
    becomes 8, as in the JAX kernel decoder: the beam step expands the frame's top
    classes only (`serving_streaming.beam_decoder_for` sends unpruned searches to
    `decode_incremental.BeamStreamDecoder` instead).
    """

    def __init__(self, blank: int, beam_width: int = 25,
                 max_decoded_length: int = 512, chunk_frames: int = 128,
                 lm_weight: float = 0.8, word_lm=None, word_count_weight: float = 0.0,
                 valid_word_count_weight: float = 2.3,
                 prune_classes: Optional[int] = 8, device=DEFAULT_DEVICE,
                 step=None, stitch=stream_stitch):
        super().__init__(blank, beam_width, max_decoded_length, chunk_frames, device)
        self.lm_weight = float(lm_weight)
        self.word_lm = None if word_lm is None else word_lm.to(self.device)
        self.word_count_weight = float(word_count_weight)
        self.valid_word_count_weight = float(valid_word_count_weight)
        self.prune_classes = 8 if prune_classes is None else prune_classes
        self._r = next_pow2(max(beam_width, 8))
        self._step_fn, self._stitch_fn = step, stitch

    def stacked_fresh_state(self, n: int) -> List[torch.Tensor]:
        return fresh_carry(n, self._r, self.word_lm, self.device) + [
            torch.full((n, self._r, self.max_decoded_length), -1, dtype=torch.int32,
                       device=self.device)]

    def advance_in_program(self, stacked_state, log_probs, counts):
        return stream_advance(
            stacked_state, log_probs, counts, blank=self.blank,
            beam_width=self.beam_width, max_decoded_length=self.max_decoded_length,
            word_lm=self.word_lm, lm_weight=self.lm_weight,
            word_count_weight=self.word_count_weight,
            valid_word_count_weight=self.valid_word_count_weight,
            prune_classes=self.prune_classes, step=self._step_fn, stitch=self._stitch_fn)
