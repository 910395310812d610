"""CTC decoding (port of `speechless_tpu/ops/decode.py`).

* `greedy_decode`: argmax -> merge repeats -> strip blanks on tensors, front-packed; the
  `Transcriber`'s and the facade's route without a language model.
* `beam_search_decode`: the host CTC *prefix* beam with optional shallow word-LM fusion
  at word boundaries and the reference's three decoder weights, on the port's native
  C++ decoder (threaded over utterances); `beam_search_decode_python` is its plain
  version. The facade evaluates with it (`system.py`), as the JAX facade does.

Both return dense ``-1``-padded token matrices, so downstream decoding remaps ``-1`` to
blank as the reference does.
"""
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..lm.ngram import LanguageModelScorer

NEG_INF = -float("inf")


def greedy_decode(log_probs: torch.Tensor, lengths: torch.Tensor,
                  blank: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Args: ``log_probs (batch, time, classes)``, ``lengths (batch,)`` valid frames.
    Returns ``tokens (batch, time) int32`` (collapsed symbols front-packed, ``-1``
    padded) and ``counts (batch,) int32``."""
    best = log_probs.argmax(dim=-1).to(torch.int32)            # (B, T)
    batch, t_max = best.shape
    t_range = torch.arange(t_max, device=best.device)[None, :]
    previous = torch.cat([best.new_full((batch, 1), -1), best[:, :-1]], dim=1)
    keep = (best != blank) & (best != previous) & (t_range < lengths.to(best.device)[:, None])
    # Stable front-compaction: sort by (kept ? position : position + T).
    order = torch.argsort(torch.where(keep, t_range, t_range + t_max), dim=1)
    packed = best.gather(1, order)
    counts = keep.sum(dim=1).to(torch.int32)
    return torch.where(t_range < counts[:, None], packed, packed.new_full((), -1)), counts


def _native_lm_handle(lm: Optional[LanguageModelScorer]) -> Optional[int]:
    """The C++ scorer handle if ``lm`` is native-backed, else None."""
    handle = getattr(lm, "_handle", None)
    return handle if isinstance(handle, int) and handle else None


def beam_search_decode(
        log_probs: np.ndarray,
        lengths: Sequence[int],
        blank: int,
        beam_width: int = 100,
        alphabet: Optional[List[str]] = None,
        lm: Optional[LanguageModelScorer] = None,
        lm_weight: float = 0.8,
        word_count_weight: float = 0.0,
        valid_word_count_weight: float = 2.3,
        space_index: Optional[int] = None,
        force_python: bool = False,
        prune_log_prob_floor: Optional[float] = None,
) -> Tuple[np.ndarray, np.ndarray]:
    """CTC prefix beam search over a batch on the host. Runs the threaded C++ decoder
    (the port's ``native/beam_search.cpp``, built at first use) unless ``force_python``
    or the LM is not the native-backed scorer; then the pure-Python reference
    implementation, which the tests hold it against. Matches TF beam semantics with
    ``merge_repeated=False`` and the KenLM-fork fusion weights (`net.py:444-451`).

    ``prune_log_prob_floor`` (native path only): skip per-frame extensions whose class
    log-probability is below the floor — standard production pruning; on peaky (trained)
    outputs the result is unchanged while the search runs ~10x faster. ``None`` = exact.
    """
    lm_handle = _native_lm_handle(lm)
    if not force_python and (lm is None or lm_handle is not None):
        from .. import native

        if lm is not None and space_index is None:
            if alphabet is None:
                raise ValueError("LM fusion requires the alphabet to locate word boundaries.")
            space_index = alphabet.index(" ")
        tokens, counts = native.library().ctc_beam_search(
            np.asarray(log_probs), list(lengths), blank=blank, beam_width=beam_width,
            lm_handle=lm_handle or 0, alphabet=alphabet,
            space_index=-1 if space_index is None else space_index,
            lm_weight=lm_weight, word_count_weight=word_count_weight,
            valid_word_count_weight=valid_word_count_weight,
            class_log_prob_floor=(0.0 if prune_log_prob_floor is None
                                  else float(prune_log_prob_floor)))
        width = max(int(counts.max()) if counts.size else 0, 1)
        return tokens[:, :width], counts
    return beam_search_decode_python(
        log_probs, lengths, blank, beam_width=beam_width, alphabet=alphabet, lm=lm,
        lm_weight=lm_weight, word_count_weight=word_count_weight,
        valid_word_count_weight=valid_word_count_weight, space_index=space_index)


def beam_search_decode_python(
        log_probs: np.ndarray,
        lengths: Sequence[int],
        blank: int,
        beam_width: int = 100,
        alphabet: Optional[List[str]] = None,
        lm: Optional[LanguageModelScorer] = None,
        lm_weight: float = 0.8,
        word_count_weight: float = 0.0,
        valid_word_count_weight: float = 2.3,
        space_index: Optional[int] = None,
) -> Tuple[np.ndarray, np.ndarray]:
    """CTC prefix beam search over a batch (the pure-Python reference path; the device
    beams are `ops/decode_lm.py` and `ops/decode_beam.py`). Matches TF beam semantics
    with ``merge_repeated=False``.

    LM fusion: when a prefix emits a space (word boundary), add
    ``lm_weight * log10 P_lm(word | context) + word_count_weight + valid_word_count_weight
    * [word in vocabulary]`` — the weighting scheme of the reference's KenLM TF fork
    (`net.py:444-451`).

    Returns dense ``-1``-padded tokens plus decoded lengths.
    """
    log_probs = np.asarray(log_probs, dtype=np.float64)
    batch, t_max, _ = log_probs.shape
    results: List[List[int]] = []

    if lm is not None and space_index is None:
        if alphabet is None:
            raise ValueError("LM fusion requires the alphabet to locate word boundaries.")
        space_index = alphabet.index(" ")

    def lm_bonus(prefix: Tuple[int, ...]) -> float:
        """Score the just-completed word when ``prefix`` ends at a boundary."""
        if len(prefix) >= 2 and prefix[-2] == space_index:
            return 0.0  # consecutive space: the word was already scored at the first one
        chars = [alphabet[i] for i in prefix[:-1]]
        text = "".join(chars)
        words = text.split()
        if not words:
            return 0.0
        word = words[-1]
        bonus = lm_weight * lm.score_word(words[:-1], word) + word_count_weight
        if lm.is_valid_word(word):
            bonus += valid_word_count_weight
        return bonus

    for b in range(batch):
        # prefix -> (log p ending in blank, log p ending in non-blank, lm score so far)
        beams = {(): (0.0, NEG_INF, 0.0)}
        for t in range(int(lengths[b])):
            row = log_probs[b, t]
            candidates: dict = {}

            def add(prefix, p_b, p_nb, lm_score):
                old_b, old_nb, _ = candidates.get(prefix, (NEG_INF, NEG_INF, 0.0))
                candidates[prefix] = (np.logaddexp(old_b, p_b), np.logaddexp(old_nb, p_nb),
                                      lm_score)

            for prefix, (p_b, p_nb, lm_score) in beams.items():
                total = np.logaddexp(p_b, p_nb)
                # Emit blank: prefix unchanged, ends-in-blank.
                add(prefix, total + row[blank], NEG_INF, lm_score)
                last = prefix[-1] if prefix else None
                for c in range(len(row)):
                    if c == blank:
                        continue
                    p_c = row[c]
                    if c == last:
                        # Repeat without separating blank collapses onto the same prefix...
                        add(prefix, NEG_INF, p_nb + p_c, lm_score)
                        # ...while extension is only possible from the ends-in-blank mass.
                        extended = prefix + (c,)
                        bonus = (lm_bonus(extended) if lm is not None and c == space_index
                                 else 0.0)
                        add(extended, NEG_INF, p_b + p_c, lm_score + bonus)
                    else:
                        extended = prefix + (c,)
                        bonus = (lm_bonus(extended) if lm is not None and c == space_index
                                 else 0.0)
                        add(extended, NEG_INF, total + p_c, lm_score + bonus)

            beams = dict(sorted(
                candidates.items(),
                key=lambda kv: -(np.logaddexp(kv[1][0], kv[1][1]) + kv[1][2]))[:beam_width])

        def final_score(kv):
            prefix, (p_b, p_nb, lm_score) = kv
            total = np.logaddexp(p_b, p_nb) + lm_score
            if lm is not None:
                # Score the trailing (unterminated) word at end of sequence.
                words = "".join(alphabet[i] for i in prefix).split()
                if words and (not prefix or prefix[-1] != space_index):
                    total += lm_weight * lm.score_word(words[:-1], words[-1]) + word_count_weight
                    if lm.is_valid_word(words[-1]):
                        total += valid_word_count_weight
            return total

        best_prefix = max(beams.items(), key=final_score)[0]
        results.append(list(best_prefix))

    max_len = max((len(r) for r in results), default=0)
    tokens = -np.ones((batch, max(max_len, 1)), dtype=np.int32)
    counts = np.zeros(batch, dtype=np.int32)
    for i, r in enumerate(results):
        tokens[i, :len(r)] = r
        counts[i] = len(r)
    return tokens, counts
