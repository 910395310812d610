"""Sequence parallelism: the time axis of one long recording split over the ranks of a
mesh axis (port of `speechless_tpu/parallel/sequence.py`).

wav2letter is a pure conv stack, so an output frame depends on at most
`receptive_field_inputs` input frames. Each rank takes its chunk of the (padded) input,
gets a halo of ``halo_outputs * ratio`` frames from each neighbour, runs the model on
``[halo | chunk | halo]`` and keeps its central ``chunk / ratio`` output frames; then
every rank gathers every chunk's frames. The outputs equal the unsplit forward's up to
the convolutions' rounding:

* chunk and halo are multiples of the stride ratio, so every layer sees a window in
  stride phase with the global one, and the SAME padding of an interior window
  (`models/wav2letter.same_padding`) lands where the global one does;
* the global edges are not a zero halo (SAME pads zeros at every layer, a zero input
  halo turns into ``activation(bias)`` after the first conv), so the first and last
  ranks roll their window by -halo and +halo, putting the global edge at the local
  array's edge, and slice their outputs at the offset the roll moved them to.

The halo exchange is one `all_gather` of every rank's head and tail (``2 * halo``
frames each) over the axis' group, where JAX's program ``ppermute``s the tail to the
right neighbour and the head to the left one. Each rank keeps its neighbours' parts.
One collective moves ``n * 2 * halo`` frames a rank, a few hundred frames against a
recording's tens of thousands, and it runs on NCCL and on gloo alike, with CUDA or CPU
tensors (gloo's send and receive take CPU tensors only).

With one rank on the axis, or a chunk shorter than the halo (a short input), every rank
runs the plain forward on the padded input, as JAX does.
"""
from typing import Optional

import torch
import torch.nn.functional as F

from ..models import wav2letter as w2l
from .mesh import DATA_AXIS, all_gather, axis_group, axis_rank, axis_size


def receptive_field_inputs(config: w2l.Wav2LetterConfig) -> int:
    """Receptive field of one output frame, in input frames (mel frames or samples)."""
    field = 1
    for spec in reversed(config.layers):
        field = (field - 1) * spec.stride + spec.kernel_size
    return field


def halo_output_frames(config: w2l.Wav2LetterConfig) -> int:
    """The per-side halo in output frames: the whole receptive field rounded up to
    output frames (JAX's bound)."""
    ratio = config.input_to_prediction_length_ratio
    return -(-receptive_field_inputs(config) // ratio)


def _neighbour_halos(local: torch.Tensor, halo: int, group, axis: str, rank: int,
                     n: int):
    """The left neighbour's last ``halo`` frames and the right neighbour's first, zeros
    past the global edges, from one all-gather of every rank's head and tail."""
    ends = torch.cat([local[:, :halo], local[:, -halo:]], dim=1)
    gathered = all_gather(ends[None], group, axis, "sequence halos").unbind(0)
    zeros = torch.zeros_like(local[:, :halo])
    left = gathered[rank - 1][:, halo:] if rank > 0 else zeros
    right = gathered[rank + 1][:, :halo] if rank < n - 1 else zeros
    return left, right


def sequence_parallel_logits(model: w2l.Wav2Letter, inputs: torch.Tensor, mesh,
                             axis: str = DATA_AXIS,
                             halo_outputs: Optional[int] = None) -> torch.Tensor:
    """Time-split forward: ``(B, T, F)`` (the same input on every rank of ``axis``) ->
    ``(B, ceil(T / (n * ratio)) * n, C)`` fp32 logits, whole on every rank. T is
    zero-padded to ``n`` chunks of a multiple of the stride ratio (zero padding is what
    SAME pads, so frames below ``T // ratio`` are unaffected); callers slice the valid
    prefix with `w2l.prediction_lengths`. Every rank of ``axis`` must call it
    together."""
    config = model.config
    n = axis_size(mesh, axis)
    ratio = config.input_to_prediction_length_ratio
    if halo_outputs is None:
        halo_outputs = halo_output_frames(config)
    halo = halo_outputs * ratio
    frames = inputs.shape[1]
    chunk = -(-frames // (n * ratio)) * ratio
    padded = F.pad(inputs, (0, 0, 0, chunk * n - frames))
    if n == 1 or chunk < halo:
        # A chunk shorter than the halo would need halos from further ranks; long-form
        # input is the point of this path, so a short one runs unsplit.
        return model(padded)
    rank, group = axis_rank(mesh, axis), axis_group(mesh, axis)
    local = padded[:, rank * chunk:(rank + 1) * chunk]
    left, right = _neighbour_halos(local, halo, group, axis, rank, n)
    extended = torch.cat([left, local, right], dim=1)
    # The edge ranks roll the global boundary onto the local array's edge, where the
    # model's own SAME padding equals the global one at every layer.
    shift = -halo if rank == 0 else halo if rank == n - 1 else 0
    logits = model(torch.roll(extended, shift, dims=1))
    offset = halo_outputs + shift // ratio
    mine = logits[:, offset:offset + chunk // ratio]
    return all_gather(mine, group, axis, "sequence outputs", dim=1)


def sequence_parallel_log_probs(model: w2l.Wav2Letter, inputs: torch.Tensor, mesh,
                                axis: str = DATA_AXIS,
                                halo_outputs: Optional[int] = None) -> torch.Tensor:
    """Log-softmax posteriors of `sequence_parallel_logits`, whole on every rank (the
    beam decodes them in order, as JAX's gathered posteriors)."""
    return torch.log_softmax(sequence_parallel_logits(model, inputs, mesh, axis,
                                                      halo_outputs), dim=-1)
