"""Character-level n-gram LM as a dense table, for shallow fusion in the beam (the
port's own copy of `speechless_tpu/lm/char_ngram.py`, which is jax-free).

A char-level n-gram over the decode alphabet fits in device memory as a dense log-prob
table, so the beam applies shallow fusion with one table lookup per candidate.

Context encoding uses base ``alphabet_size + 1`` with a reserved BOS pseudo-character, so
start-of-text (and post-out-of-alphabet resets) get their own context rows instead of
colliding with the genuine all-``alphabet[0]`` context. For a table with ``cols`` columns:
``base = cols + 1``, rows = ``base^(order-1)``, and the all-BOS start context is exactly
``rows - 1`` (BOS id = cols is the largest digit): everything decode-side derives from
the table shape alone.
"""
from typing import List, Sequence

import numpy as np


def context_size(alphabet_size: int, order: int) -> int:
    return (alphabet_size + 1) ** (order - 1)


def initial_context(alphabet_size: int, order: int) -> int:
    """Index of the all-BOS context: the highest row, ``base^(order-1) - 1``."""
    return context_size(alphabet_size, order) - 1


def advance_context(context, char, alphabet_size: int, order: int):
    """Rolling context update (works on ints, arrays or tensors)."""
    base = alphabet_size + 1
    return (context * base + char) % context_size(alphabet_size, order)


def char_ngram_table_from_texts(texts: Sequence[str], alphabet: List[str], order: int = 4,
                                add_k: float = 0.1) -> np.ndarray:
    """Estimate an add-k-smoothed char n-gram table from training transcripts.

    Returns ``((alphabet_size+1)^(order-1), alphabet_size)`` float32 log10 probabilities:
    ``table[ctx, c] = log10 P(c | context ctx)``. Each text starts from the all-BOS
    context; characters outside the alphabet reset the context to all-BOS. Contexts never
    observed fall back to the smoothed uniform distribution.
    """
    size = len(alphabet)
    index = {c: i for i, c in enumerate(alphabet)}
    start = initial_context(size, order)
    counts = np.zeros((context_size(size, order), size), dtype=np.float64)
    for text in texts:
        context = start
        for char in text:
            c = index.get(char)
            if c is None:
                context = start
                continue
            counts[context, c] += 1.0
            context = advance_context(context, c, size, order)
    smoothed = counts + add_k
    probs = smoothed / smoothed.sum(axis=1, keepdims=True)
    return np.log10(probs).astype(np.float32)
