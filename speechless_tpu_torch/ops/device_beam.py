"""Device beam-search routing (port of `speechless_tpu/ops/device_beam.py`).

* word LM -> `decode_lm.beam_search_decode_lm` (the beam-step kernel + torch LM gathers);
* no LM, pruned -> `decode_lm.beam_search_decode_frames` (the same kernel, no LM).

Routes not ported yet raise `NotImplementedError` naming their ROADMAP.md item; none of
them goes elsewhere quietly. The kernel has no class-count cap: the TPU's 128-lane
packed frame row (`FRAME_LANES`) does not apply here.
"""
from typing import Optional, Tuple

import torch

from .decode_lm import beam_search_decode_frames, beam_search_decode_lm

_NOT_PORTED = "{} is not ported yet (ROADMAP.md, {})"


def beam_search_decode_device(log_probs: torch.Tensor, lengths: torch.Tensor, blank: int,
                              beam_width: int = 25, max_decoded_length: int = 256,
                              prune_classes: Optional[int] = 8,
                              word_lm=None, lm_table: torch.Tensor = None,
                              lm_weight: float = 0.8,
                              word_count_weight: float = 0.0,
                              valid_word_count_weight: float = 2.3,
                              skip_blank_log_prob: Optional[float] = None,
                              lexicon_constrained: bool = False,
                              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Batched CTC prefix beam search: ``tokens (B, max_decoded_length) int32``
    (-1 padded) and ``counts (B,)``. Same arguments as the JAX package's router."""
    if lexicon_constrained:
        raise NotImplementedError(_NOT_PORTED.format(
            "lexicon-constrained search", "beam routes: lexicon_constrained"))
    if lm_table is not None:
        raise NotImplementedError(_NOT_PORTED.format(
            "the char-table LM beam", "beam routes: lm_table"))
    if prune_classes is None:
        raise NotImplementedError(_NOT_PORTED.format(
            "unpruned search (prune_classes=None)", "beam routes: unpruned search"))
    if skip_blank_log_prob is not None:
        raise NotImplementedError(_NOT_PORTED.format(
            "the skip_blank_log_prob fast path", "kernel K3 _beam_kernel"))
    if word_lm is not None:
        return beam_search_decode_lm(
            log_probs, lengths, blank, word_lm, beam_width=beam_width,
            max_decoded_length=max_decoded_length, lm_weight=lm_weight,
            word_count_weight=word_count_weight,
            valid_word_count_weight=valid_word_count_weight, prune_classes=prune_classes)
    return beam_search_decode_frames(
        log_probs, lengths, blank, beam_width=beam_width,
        max_decoded_length=max_decoded_length, prune_classes=prune_classes)
