"""A plain CTC prefix beam search with a word LM fused at word ends (float64, Python), and
the objective a transcript is scored by.

Search (Hannun et al., 2014, as speechless decodes): per frame each beam stays (blank, or
its last character repeated) or extends by one of the frame's ``prune_classes`` most
likely non-blank classes (a repeat of the last character extends only from the blank
mass). A space that ends a non-empty word adds the word's bonus,
``lm_weight * log10 P(word | two words before) + word_count_weight
+ valid_word_count_weight * [word in the vocabulary]``, and shifts the word into the
context. Beams are ranked by log(P_blank + P_nonblank) + bonus sum; the last, unended
word's bonus joins the final ranking.

`objective` scores any transcript the same way, with the acoustic part exact: the CTC
log-likelihood of the transcript over every alignment (``F.ctc_loss``, float64) plus
the bonus of every word.
"""
import math
from typing import Dict, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from .lm import BOS, Arpa

NEG = -math.inf


def _add(a: float, b: float) -> float:
    if a == NEG:
        return b
    if b == NEG:
        return a
    high, low = (a, b) if a > b else (b, a)
    return high + math.log1p(math.exp(low - high))


def word_bonus(lm: Arpa, context: Tuple[str, str], word: str, weights: dict) -> float:
    valid = word in lm.vocabulary
    return (weights["lm_weight"] * lm.score(context[0], context[1], lm.normal(word))
            + weights["word_count_weight"] + weights["valid_word_count_weight"] * valid)


def decode(log_probs: np.ndarray, alphabet: str, lm: Arpa, beam_width: int,
           prune_classes: int, weights: dict) -> str:
    """The best transcript of ``log_probs`` ``(frames, classes)``, blank the last class."""
    blank = log_probs.shape[1] - 1
    space = alphabet.index(" ")
    # prefix -> [p_blank, p_nonblank, bonus sum, pending word, context]
    beams: Dict[tuple, list] = {(): [0.0, NEG, 0.0, "", (BOS, BOS)]}
    bonus_cache: Dict[tuple, float] = {}

    def bonus(context, word):
        key = (context, word)
        if key not in bonus_cache:
            bonus_cache[key] = word_bonus(lm, context, word, weights)
        return bonus_cache[key]

    for frame in log_probs:
        top = [int(c) for c in np.argsort(-frame, kind="stable")[:prune_classes]
               if c != blank]
        nxt: Dict[tuple, list] = {}

        def entry(prefix, lm_sum, word, context):
            if prefix not in nxt:
                nxt[prefix] = [NEG, NEG, lm_sum, word, context]
            return nxt[prefix]

        for prefix, (pb, pnb, lm_sum, word, context) in beams.items():
            total = _add(pb, pnb)
            stay = entry(prefix, lm_sum, word, context)
            stay[0] = _add(stay[0], total + frame[blank])
            if prefix:
                stay[1] = _add(stay[1], pnb + frame[prefix[-1]])
            for c in top:
                base = pb if prefix and c == prefix[-1] else total
                if c == space:
                    if word:
                        ext = entry(prefix + (c,), lm_sum + bonus(context, word), "",
                                    (context[1], lm.normal(word)))
                    else:
                        ext = entry(prefix + (c,), lm_sum, "", context)
                else:
                    ext = entry(prefix + (c,), lm_sum, word + alphabet[c], context)
                ext[1] = _add(ext[1], base + frame[c])
        ranked = sorted(nxt.items(), key=lambda item: -(_add(item[1][0], item[1][1])
                                                        + item[1][2]))
        beams = dict(ranked[:beam_width])

    def final(item):
        pb, pnb, lm_sum, word, context = item[1]
        return _add(pb, pnb) + lm_sum + (bonus(context, word) if word else 0.0)

    best = max(beams.items(), key=final)[0]
    return "".join(alphabet[c] for c in best)


def objective(log_probs: np.ndarray, text: str, alphabet: str, lm: Arpa,
              weights: dict) -> float:
    """CTC log-likelihood of ``text`` over ``log_probs`` plus the bonus of every word."""
    labels = torch.tensor([[alphabet.index(c) for c in text] or [0]], dtype=torch.int64)
    nll = F.ctc_loss(torch.from_numpy(log_probs)[:, None, :], labels,
                     torch.tensor([log_probs.shape[0]]), torch.tensor([len(text)]),
                     blank=log_probs.shape[1] - 1, reduction="sum", zero_infinity=False)
    total, context = -float(nll), (BOS, BOS)
    for word in text.split(" "):
        if word:
            total += word_bonus(lm, context, word, weights)
            context = (context[1], lm.normal(word))
    return total


def weights_of(serve: dict) -> dict:
    return {key: serve[key] for key in ("lm_weight", "word_count_weight",
                                        "valid_word_count_weight")}

