"""The port's decode kernels as PyTorch custom operators (`torch.library.custom_op`).

The kernels are ctypes calls on ``data_ptr()`` (`_kernels.py`), which `torch.export`
cannot trace through. Registered as operators, they appear in an exported graph as one
node each, and a replayed program (`serving_export.py`) launches the same kernels the
live path launches:

* ``speechless::lm_beam_span``: the word-LM beam over a span of frames, kernel K4
  (``csrc/lm_beam_span.cu``, `decode_lm.launch_span`); plain version
  `decode_lm.lm_span_reference`;
* ``speechless::beam_backtrace``: the prefixes from the backpointers
  (``csrc/beam_backtrace.cu``, `beam_common.launch_backtrace`); plain version
  `beam_common.backtrace_tokens`.

For CUDA tensors an operator launches its kernel or raises; for CPU tensors it runs the
plain version. Each has a fake (meta) implementation that gives the output shapes, which
depend on the input shapes only. The live wrappers `decode_lm.lm_span` and
`beam_common.beam_backtrace` call through these operators, and the kernels' launch
counters (``lm_span.launches``, ``beam_backtrace.launches``) are kept where the kernel
launches, so replays count too. Importing this module registers the operators: a
process must import it before `torch.export.load` reads a program that calls them.
"""
from typing import List

import torch

from . import beam_common, decode_lm

Tensor = torch.Tensor


def word_lm_arguments(word_lm) -> tuple:
    """``(tables, space_index, max_probes, bos_id, unk_id)`` of a `DeviceWordLm` as the
    span operator takes them: its nine tables as a tensor list (empty without an LM)
    and its integers."""
    if word_lm is None:
        return [], -2, 0, 0, 0
    return (list(word_lm.arrays()), word_lm.space_index, word_lm.max_probes,
            word_lm.bos_id, word_lm.unk_id)


def _word_lm(tables, space_index, max_probes, bos_id, unk_id):
    if not tables:
        return None
    from ..lm.device_lm import DeviceWordLm

    return DeviceWordLm(*tables, max_probes, bos_id, unk_id, space_index)


@torch.library.custom_op("speechless::lm_beam_span", mutates_args=())
def lm_beam_span(frames: Tensor, carry: List[Tensor], counts: Tensor, tables: List[Tensor],
                 space_index: int, max_probes: int, bos_id: int, unk_id: int, k: int,
                 blank: int, beam_width: int, max_decoded_length: int, lm_weight: float,
                 word_count_weight: float, valid_word_count_weight: float
                 ) -> List[Tensor]:
    """Every frame of a span (`decode_lm.lm_span_reference`'s contract). Returns the
    carry's leaves, then parents ``(B, F, r)``, chars ``(B, F, r)``, the tail bonus
    ``(B, r)`` and the ``(B,)`` frames that took the step's sorted network (zeros from
    the plain version, which has one network)."""
    word_lm = _word_lm(tables, space_index, max_probes, bos_id, unk_id)
    static = dict(k=k, blank=blank, beam_width=beam_width,
                  max_decoded_length=max_decoded_length, lm_weight=lm_weight,
                  word_count_weight=word_count_weight,
                  valid_word_count_weight=valid_word_count_weight)
    if frames.device.type == "cpu":
        new_carry, parents, chars, tail_bonus = decode_lm.lm_span_reference(
            frames, carry, counts, word_lm, **static)
        sorted_frames = torch.zeros((frames.shape[1],), dtype=torch.int32)
    elif frames.device.type == "cuda":
        new_carry, parents, chars, tail_bonus, sorted_frames = decode_lm.launch_span(
            frames, carry, counts, word_lm, **static)
    else:
        raise ValueError("lm_span runs on CPU or CUDA tensors, got {}".format(
            frames.device))
    return list(new_carry) + [parents, chars, tail_bonus, sorted_frames]


@lm_beam_span.register_fake
def _lm_beam_span_fake(frames, carry, counts, tables, space_index, max_probes, bos_id,
                       unk_id, k, blank, beam_width, max_decoded_length, lm_weight,
                       word_count_weight, valid_word_count_weight):
    span, batch, _ = frames.shape
    r = carry[0].shape[1]
    parents = frames.new_empty((batch, span, r), dtype=torch.int32)
    return [torch.empty_like(leaf) for leaf in carry] + [
        parents, torch.empty_like(parents), frames.new_empty((batch, r)),
        frames.new_empty((batch,), dtype=torch.int32)]


@torch.library.custom_op("speechless::beam_backtrace", mutates_args=())
def beam_backtrace(parents: Tensor, emit_chars: Tensor, best: Tensor, counts: Tensor,
                   max_decoded_length: int) -> Tensor:
    """The tokens ``best.shape + (max_decoded_length,)`` int32 (-1 padded) of
    `beam_common.backtrace_tokens`."""
    if parents.device.type == "cpu":
        return beam_common.backtrace_tokens(parents, emit_chars, best, counts,
                                            max_decoded_length)[0]
    if parents.device.type == "cuda":
        return beam_common.launch_backtrace(parents, emit_chars, best, counts,
                                            max_decoded_length)
    raise ValueError("beam_backtrace runs on CPU or CUDA tensors, got {}".format(
        parents.device))


@beam_backtrace.register_fake
def _beam_backtrace_fake(parents, emit_chars, best, counts, max_decoded_length):
    return parents.new_empty(tuple(best.shape) + (max_decoded_length,), dtype=torch.int32)
