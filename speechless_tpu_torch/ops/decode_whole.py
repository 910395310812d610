"""The whole-utterance no-LM prefix beam on the hand-written kernel K3 (port of
`speechless_tpu/ops/decode_pallas.py`).

`prefix_beam` runs every frame of every utterance in one launch (CUDA source
`csrc/prefix_beam.cu`, one thread block per utterance) and returns the per-frame
backpointers and the final beams; the top-k frame packing before it
(`decode_lm.pack_frames`) and the winner after it are torch ops, as they were XLA ops
around the Pallas call, and the backtrace is one launch of the backtrace kernel
(`beam_common.beam_backtrace`). Frames whose blank log-prob exceeds
``skip_blank_log_prob`` take the fast path of `decode_pallas.py:236-245`: only the
blank / non-blank split of each beam updates.

`prefix_beam_reference` is the plain PyTorch version: the frame loop over
`decode_lm.lm_step_reference` with no LM, plus the fast path chosen per row. The
kernel's frame step gives the same result by its rank network, or by this very network
where a hash gathers more than two live candidates (``csrc/beam_step.cuh``), so the two
agree bit for bit on one device. `prefix_beam` runs the
kernel for CUDA tensors and the plain version for CPU tensors, and nothing else.
"""
from typing import Optional, Tuple

import numpy as np
import torch

from . import _kernels
from .beam_common import NEG_INF, beam_backtrace, next_pow2
from .decode_lm import MAX_LANES, fresh_carry, lm_step_reference, pack_frames


def _threshold(skip_blank_log_prob: Optional[float]) -> float:
    """The fast path's threshold as the float32 the frames are compared with (JAX
    compares an f32 with a weakly typed Python float); +inf when there is none."""
    return float("inf") if skip_blank_log_prob is None else float(
        np.float32(skip_blank_log_prob))


def prefix_beam_reference(frames: torch.Tensor, lengths: torch.Tensor, *, k: int,
                          blank: int, beam_width: int, max_decoded_length: int,
                          skip_blank_log_prob: Optional[float] = None):
    """The whole-utterance beam in plain PyTorch. ``frames`` is ``(T, B, 2k + C)``
    (`pack_frames`), ``lengths`` ``(B,)``. Returns ``(parents, chars)`` ``(B, T, r)``
    int32 and the final ``(pb, pnb, len)`` ``(B, r)``."""
    t_max, batch, width = frames.shape
    class_count = width - 2 * k
    r = next_pow2(max(beam_width, 8))
    device = frames.device
    pb, pnb, hsh, last, lens, zeros = fresh_carry(batch, r, None, device)
    threshold = _threshold(skip_blank_log_prob)
    counts = lengths.to(device=device, dtype=torch.int64)
    lane = torch.arange(r, device=device, dtype=torch.int32).expand(batch, r)
    parents = lane[:, None, :].repeat(1, t_max, 1)
    chars = torch.full((batch, t_max, r), -1, dtype=torch.int32, device=device)
    static = dict(k=k, blank=blank, beam_width=beam_width,
                  max_decoded_length=max_decoded_length, space_index=-2)
    # Frames past every row's length pass every beam through: stop at the longest row.
    for t in range(min(t_max, int(counts.max())) if batch else 0):
        frame = frames[t]
        npb, npnb, nhsh, nlast, nlen, _, idx = lm_step_reference(
            frame, pb, pnb, hsh, last, lens, zeros, zeros, **static)
        # The fast path: the prefix set stays; only the blank / non-blank split moves.
        total = torch.logaddexp(pb, pnb)
        valid = total > NEG_INF / 2
        lp_blank = frame[:, 2 * k + blank:2 * k + blank + 1]
        known = (last >= 0) & (last < class_count)
        lp_last = torch.where(
            known, frame.gather(1, (2 * k + last.clamp(0, class_count - 1)).long()),
            NEG_INF)
        fast_pb = torch.where(valid, total + lp_blank, NEG_INF)
        fast_pnb = torch.where(valid & (last >= 0), pnb + lp_last, NEG_INF)
        active = (t < counts)[:, None]
        fast = active & (lp_blank > threshold)
        full = active & ~fast
        pb = torch.where(full, npb, torch.where(fast, fast_pb, pb))
        pnb = torch.where(full, npnb, torch.where(fast, fast_pnb, pnb))
        hsh, last, lens = (torch.where(full, new, old) for new, old in
                           ((nhsh, hsh), (nlast, last), (nlen, lens)))
        emitted = full & ((idx % (k + 1)) > 0)
        parents[:, t] = torch.where(full, idx // (k + 1), lane)
        chars[:, t] = torch.where(emitted, nlast, -1)
    return parents, chars, pb, pnb, lens


def prefix_beam(frames: torch.Tensor, lengths: torch.Tensor, *, k: int, blank: int,
                beam_width: int, max_decoded_length: int,
                skip_blank_log_prob: Optional[float] = None):
    """The whole-utterance beam: the CUDA kernel for CUDA tensors,
    `prefix_beam_reference` for CPU tensors. Same contract as `prefix_beam_reference`;
    ``prefix_beam.launches`` counts kernel launches. A build or launch failure
    raises."""
    static = dict(k=k, blank=blank, beam_width=beam_width,
                  max_decoded_length=max_decoded_length,
                  skip_blank_log_prob=skip_blank_log_prob)
    if frames.device.type == "cpu":
        return prefix_beam_reference(frames, lengths, **static)
    if frames.device.type != "cuda":
        raise ValueError("prefix_beam runs on CPU or CUDA tensors, got {}".format(
            frames.device))
    t_max, batch, width = frames.shape
    r = next_pow2(max(beam_width, 8))
    n_pad = next_pow2((k + 1) * r)
    if n_pad > MAX_LANES:
        raise ValueError("the whole-utterance beam needs {} candidate lanes; the kernel "
                         "takes at most {} (lower beam_width or prune_classes)".format(
                             n_pad, MAX_LANES))
    if frames.dtype != torch.float32 or not frames.is_contiguous() \
            or width <= 2 * k + blank:
        raise ValueError("prefix_beam: frames must be a contiguous float32 (T, B, 2k + C) "
                         "tensor")
    if lengths.device != frames.device or lengths.dtype != torch.int32 \
            or not lengths.is_contiguous() or lengths.shape != (batch,):
        raise ValueError("prefix_beam: lengths must be a contiguous int32 (B,) tensor on "
                         "{}".format(frames.device))
    parents = torch.empty((batch, t_max, r), dtype=torch.int32, device=frames.device)
    chars = torch.empty_like(parents)
    pb = torch.empty((batch, r), dtype=torch.float32, device=frames.device)
    pnb = torch.empty_like(pb)
    lens = torch.empty((batch, r), dtype=torch.int32, device=frames.device)
    with torch.cuda.device(frames.device):
        status = _kernels.function("prefix_beam")(
            *(t.data_ptr() for t in (frames, lengths, parents, chars, pb, pnb, lens)),
            batch, t_max, width, r, k, n_pad, width - 2 * k, blank, beam_width,
            max_decoded_length, _threshold(skip_blank_log_prob),
            torch.cuda.current_stream().cuda_stream)
    if status != 0:
        raise RuntimeError("prefix_beam kernel launch failed with CUDA error {}".format(
            status))
    prefix_beam.launches += 1
    return parents, chars, pb, pnb, lens


prefix_beam.launches = 0


def beam_search_decode_whole(log_probs: torch.Tensor, lengths: torch.Tensor, blank: int,
                             beam_width: int = 25, max_decoded_length: int = 256,
                             prune_classes: int = 8,
                             skip_blank_log_prob: Optional[float] = None
                             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Batched no-LM CTC prefix beam search in one kernel launch (token-identical to
    `speechless_tpu.ops.decode_pallas.beam_search_decode_pallas`).

    ``log_probs (B, T, C)``, ``lengths (B,)``. ``skip_blank_log_prob`` (e.g.
    ``math.log(0.999)``): frames whose blank log-prob exceeds it update only the
    blank / non-blank mass split, which equals the full update whenever the frame's
    non-blank mass is below the pruning floor; None disables it. Returns ``tokens (B,
    max_decoded_length) int32`` (-1 padded) and ``counts (B,)``."""
    k = min(prune_classes, log_probs.shape[2])
    parents, chars, pb, pnb, lens = prefix_beam(
        pack_frames(log_probs, k), lengths.to(device=log_probs.device, dtype=torch.int32),
        k=k, blank=blank, beam_width=beam_width, max_decoded_length=max_decoded_length,
        skip_blank_log_prob=skip_blank_log_prob)
    best = torch.logaddexp(pb, pnb).argmax(dim=1)
    return beam_backtrace(parents, chars, best, lens.gather(1, best[:, None])[:, 0],
                          max_decoded_length)
