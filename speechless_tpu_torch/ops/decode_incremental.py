"""Incremental (streaming) CTC prefix beam search on the plain batched beam step (port
of `speechless_tpu/ops/decode_incremental.py`'s `BeamStreamDecoder`).

It serves every search the span kernel does not express (`decode_incremental_kernel.
kernel_beam_supported`): a lexicon-constrained beam, an unpruned beam and char-table LM
fusion (``lm_table``), besides the word LM and no LM. The search is the offline
`decode_beam._beam_step` split at arbitrary frame boundaries: the step is Markov in its
carry (prefix length, last char, rolling hash, log P ending in blank and in non-blank,
char-LM context, word-LM score, trie node, word context), so chunked equals offline.

One chunk advance of N streams (`advance_in_program`): the frame loop of `_beam_step`
over the chunk with the rows as the batch (W lanes a row, as JAX's), then the stitch
and ranking of the token buffer (`stream_stitch`: the CUDA kernel ``csrc/
stream_stitch.cu`` for CUDA tensors, `stitch_reference` for CPU ones). JAX stitches with
XLA gathers; the stitch computes the same function (each lane's ancestor at chunk entry,
its chars within the chunk, the best lane by first argmax and the three scalars).
"""
from typing import List, Optional

import torch

from .beam_common import word_bonuses
from .decode_beam import BeamState, _beam_step, initial_beam_state, lm_table_geometry
from .decode_incremental_kernel import DEFAULT_DEVICE, StreamDecoderBase, stream_stitch


class BeamStreamDecoder(StreamDecoderBase):
    """Streaming prefix-beam decoder on the plain batched beam step: chunked feeds give
    exactly what `decode_beam.beam_search_decode` gives on the concatenated frames, for
    every fusion mode (none, ``lm_table`` char fusion, ``word_lm`` word fusion,
    optionally ``lexicon_constrained``). Its carry is `decode_beam.BeamState` with W
    lanes plus the (W, max_len) token buffer; see `StreamDecoderBase` for the
    per-stream surface and rollover. The frame loop is plain PyTorch on whatever device
    the decoder holds: JAX ran it in XLA, no TPU kernel."""

    def __init__(self, blank: int, beam_width: int = 25,
                 max_decoded_length: int = 512, chunk_frames: int = 128,
                 lm_table=None, lm_weight: float = 0.8, word_lm=None,
                 word_count_weight: float = 0.0, valid_word_count_weight: float = 2.3,
                 prune_classes: Optional[int] = None, lexicon_constrained: bool = False,
                 device=DEFAULT_DEVICE, stitch=stream_stitch):
        if word_lm is not None and lm_table is not None:
            raise ValueError("char-table and word-level fusion are mutually exclusive")
        if lexicon_constrained and word_lm is None:
            raise ValueError("lexicon_constrained needs a word_lm (the vocabulary trie)")
        super().__init__(blank, beam_width, max_decoded_length, chunk_frames, device)
        self.lm_table = (None if lm_table is None else
                         torch.as_tensor(lm_table, dtype=torch.float32).to(self.device))
        self.lm_weight = float(lm_weight)
        self.word_lm = None if word_lm is None else word_lm.to(self.device)
        self.word_count_weight = float(word_count_weight)
        self.valid_word_count_weight = float(valid_word_count_weight)
        self.prune_classes = prune_classes
        self.lexicon_constrained = lexicon_constrained
        self._stitch_fn = stitch

    def stacked_fresh_state(self, n: int) -> List[torch.Tensor]:
        bos = self.word_lm.bos_id if self.word_lm is not None else 0
        return list(initial_beam_state(n, self.beam_width, self.device, self.lm_table,
                                       bos)) + [
            torch.full((n, self.beam_width, self.max_decoded_length), -1,
                       dtype=torch.int32, device=self.device)]

    def advance_in_program(self, stacked_state, log_probs, counts):
        state, tokens = BeamState(*stacked_state[:-1]), stacked_state[-1]
        streams, frames, _ = log_probs.shape
        counts = torch.as_tensor(counts)
        # Frames past every row's count are exact no-ops (identity backpointers, nothing
        # emitted): stop at the longest row.
        t_run = max(1, min(frames, int(counts.max()) if streams else 0))
        counts = counts.to(device=self.device, dtype=torch.int64)
        log_probs = log_probs.to(torch.float32)
        lm_base, lm_order = lm_table_geometry(self.lm_table)
        prev_len = state.lengths
        parents, chars = [], []
        for t in range(t_run):
            state, (parent, char) = _beam_step(
                state, log_probs[:, t], t < counts, self.blank, self.max_decoded_length,
                lm_table=self.lm_table, lm_weight=self.lm_weight, lm_base=lm_base,
                lm_order=lm_order, word_lm=self.word_lm,
                word_count_weight=self.word_count_weight,
                valid_word_count_weight=self.valid_word_count_weight,
                prune_classes=self.prune_classes,
                lexicon_constrained=self.lexicon_constrained)
            parents.append(parent)
            chars.append(char)
        # The offline final ranking applied to the live state: the masses, the
        # per-prefix LM score and, with word fusion, the trailing word's bonus.
        final = torch.logaddexp(state.p_b, state.p_nb) + state.lm_scores
        if self.word_lm is not None:
            tail_bonus, _, _ = word_bonuses(
                self.word_lm, state.trie_nodes.reshape(-1), state.word_ctx.reshape(-1, 2),
                self.lm_weight, self.word_count_weight, self.valid_word_count_weight)
            final = final + tail_bonus.view(streams, self.beam_width).to(torch.float32)
        rows, rows_best, scalars = self._stitch_fn(
            torch.stack(parents, dim=1).to(torch.int32).contiguous(),
            torch.stack(chars, dim=1).to(torch.int32).contiguous(),
            tokens.contiguous(), prev_len.to(torch.int32).contiguous(),
            state.lengths.to(torch.int32).contiguous(),
            final.to(torch.float32).contiguous())
        return list(state) + [rows], rows_best, scalars

