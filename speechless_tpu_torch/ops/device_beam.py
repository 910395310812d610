"""Device beam-search routing (port of `speechless_tpu/ops/device_beam.py`), in the
JAX router's order:

* ``lexicon_constrained`` -> the plain batched beam (`decode_beam.py`), with a word LM;
* a char-table LM (``lm_table``) or unpruned search -> the plain batched beam;
* word LM -> `decode_lm.beam_search_decode_lm` (the beam-step kernel + torch LM gathers);
* ``skip_blank_log_prob`` -> `decode_whole.beam_search_decode_whole` (kernel K3, the
  whole utterance in one launch);
* no LM, pruned -> `decode_lm.beam_search_decode_frames` (the beam-step kernel, no LM).

The kernels have no class-count cap; the TPU's 128-lane packed frame row
(``FRAME_LANES``) only decides one case, so that the result stays the JAX package's:
where ``C + 2 * min(k, C)`` exceeds it, JAX takes the XLA beam before it looks at
``skip_blank_log_prob`` and so ignores skipping. With skipping asked for, such a charset
takes the plain beam here too; without, the kernel beams give JAX's tokens anyway.
"""
import logging
from typing import Optional, Tuple

import torch

from .decode_beam import beam_search_decode
from .decode_lm import beam_search_decode_frames, beam_search_decode_lm
from .decode_whole import beam_search_decode_whole

FRAME_LANES = 128  # the TPU kernels' packed frame row: top-k scores, top-k chars, frame

logger = logging.getLogger(__name__)


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
    weights = dict(lm_weight=lm_weight, word_count_weight=word_count_weight,
                   valid_word_count_weight=valid_word_count_weight)
    if lexicon_constrained:
        if skip_blank_log_prob is not None:
            raise ValueError("skip_blank_log_prob is not supported with "
                             "lexicon_constrained (only the whole-utterance kernel "
                             "implements blank skipping, and it has no trie mask)")
        if lm_table is not None:
            raise ValueError("lexicon_constrained needs a word-level LM (word_lm): "
                             "the vocabulary trie rides in the word LM, which a "
                             "char-table LM (lm_table) does not carry")
        return beam_search_decode(log_probs, lengths, blank, beam_width=beam_width,
                                  max_decoded_length=max_decoded_length, word_lm=word_lm,
                                  prune_classes=prune_classes, lexicon_constrained=True,
                                  **weights)
    class_count = log_probs.shape[-1]
    beyond_frame_row = prune_classes is not None and \
        class_count + 2 * min(prune_classes, class_count) > FRAME_LANES
    if lm_table is not None or prune_classes is None \
            or (beyond_frame_row and skip_blank_log_prob is not None):
        if lm_table is None:
            logger.info(
                "device beam: %d classes + 2*%s pruned exceeds the %d-lane packed frame "
                "row (or pruning disabled); using the plain batched beam", class_count,
                prune_classes, FRAME_LANES)
        return beam_search_decode(log_probs, lengths, blank, beam_width=beam_width,
                                  max_decoded_length=max_decoded_length, lm_table=lm_table,
                                  word_lm=word_lm, prune_classes=prune_classes, **weights)
    if word_lm is not None:
        return beam_search_decode_lm(log_probs, lengths, blank, word_lm,
                                     beam_width=beam_width,
                                     max_decoded_length=max_decoded_length,
                                     prune_classes=prune_classes, **weights)
    if skip_blank_log_prob is not None:
        return beam_search_decode_whole(log_probs, lengths, blank, beam_width=beam_width,
                                        max_decoded_length=max_decoded_length,
                                        prune_classes=prune_classes,
                                        skip_blank_log_prob=skip_blank_log_prob)
    return beam_search_decode_frames(log_probs, lengths, blank, beam_width=beam_width,
                                     max_decoded_length=max_decoded_length,
                                     prune_classes=prune_classes)
