"""Interpolated Kneser-Ney word n-gram estimator that writes an ARPA file: the input
maker of the serving cells' word LM, frozen here so that the LM a cell serves cannot
change with the program. Estimation follows Chen & Goodman (1999): the highest order
uses raw counts, lower orders continuation counts (raw for ``<s>``-initial n-grams), one
absolute discount per order (``n1/(n1+2*n2)``), with the interpolation folded into the
backoff weights; ``<unk>`` receives the unigram interpolation mass.
"""
import math
from collections import Counter
from pathlib import Path
from typing import Dict, List, Tuple

BOS = "<s>"
EOS = "</s>"
UNK = "<unk>"

Ngram = Tuple[str, ...]


def _ney_discount(counts: Counter) -> float:
    """Absolute discount D = n1 / (n1 + 2 n2), clamped to (0, 1)."""
    n1 = sum(1 for c in counts.values() if c == 1)
    n2 = sum(1 for c in counts.values() if c == 2)
    if n1 == 0:
        return 0.5
    return min(max(n1 / (n1 + 2.0 * n2), 0.05), 0.95)


class WordNgramEstimator:
    """Interpolated Kneser-Ney estimator over whitespace-tokenized transcripts."""

    def __init__(self, order: int = 3):
        if order < 1:
            raise ValueError("order must be >= 1, got {}".format(order))
        self.order = order
        # raw_counts[n-1]: n-gram -> occurrence count (over <s> ... </s> padded sentences)
        self.raw_counts: List[Counter] = [Counter() for _ in range(order)]

    def add_text(self, text: str) -> None:
        words = text.split()
        if not words:
            return
        tokens = [BOS] + words + [EOS]
        for n in range(1, self.order + 1):
            counts = self.raw_counts[n - 1]
            for start in range(len(tokens) - n + 1):
                counts[tuple(tokens[start:start + n])] += 1

    def estimate(self) -> Tuple[List[Dict[Ngram, float]], List[Dict[Ngram, float]]]:
        """Returns (probabilities, backoffs): per order, n-gram -> probability /
        context -> backoff weight (linear domain)."""
        if not self.raw_counts[0]:
            raise ValueError("No text was added before estimation.")
        order = self.order

        effective: List[Counter] = [Counter() for _ in range(order)]
        effective[order - 1] = self.raw_counts[order - 1]
        for n in range(order - 1, 0, -1):
            continuation: Counter = Counter()
            for higher in self.raw_counts[n]:  # (n+1)-grams
                continuation[higher[1:]] += 1
            counts_n = effective[n - 1]
            for gram, raw in self.raw_counts[n - 1].items():
                counts_n[gram] = raw if gram[0] == BOS else continuation.get(gram, raw)

        discounts = [_ney_discount(effective[n]) for n in range(order)]

        # Unigrams: interpolate with uniform over the closed vocabulary (incl. <unk>).
        vocabulary = sorted(set(w for (w,) in effective[0]) | {UNK})
        predictable = [w for w in vocabulary if w != BOS]
        total = sum(c for gram, c in effective[0].items() if gram != (BOS,))
        seen_types = sum(1 for gram in effective[0] if gram != (BOS,))
        d1 = discounts[0]
        lambda_uni = d1 * seen_types / total if total else 1.0
        uniform = 1.0 / len(predictable)
        probabilities: List[Dict[Ngram, float]] = [dict() for _ in range(order)]
        for word in predictable:
            count = effective[0].get((word,), 0)
            probabilities[0][(word,)] = (max(count - d1, 0.0) / total if total else 0.0) \
                + lambda_uni * uniform

        backoffs: List[Dict[Ngram, float]] = [dict() for _ in range(order)]
        for n in range(2, order + 1):
            counts = effective[n - 1]
            d = discounts[n - 1]
            context_totals: Counter = Counter()
            context_types: Counter = Counter()
            for gram, count in counts.items():
                context_totals[gram[:-1]] += count
                context_types[gram[:-1]] += 1
            for gram, count in counts.items():
                denominator = context_totals[gram[:-1]]
                lam = d * context_types[gram[:-1]] / denominator
                lower = probabilities[n - 2].get(gram[1:], uniform)
                probabilities[n - 1][gram] = max(count - d, 0.0) / denominator \
                    + lam * lower
            for context, denominator in context_totals.items():
                backoffs[n - 2][context] = d * context_types[context] / denominator
        return probabilities, backoffs

    def write_arpa(self, path: Path) -> Path:
        probabilities, backoffs = self.estimate()
        path = Path(path)
        path.parent.mkdir(parents=True, exist_ok=True)

        def log10_floor(value: float) -> float:
            return math.log10(value) if value > 0.0 else -99.0

        with path.open("w", encoding="utf8") as f:
            f.write("\\data\\\n")
            entry_lists: List[List[str]] = []
            for n in range(1, self.order + 1):
                entries = []
                grams = sorted(probabilities[n - 1])
                if n == 1:
                    grams = sorted(set(grams) | {(BOS,)})
                for gram in grams:
                    prob = probabilities[n - 1].get(gram)
                    logp = -99.0 if gram == (BOS,) else log10_floor(prob)
                    line = "{:.7f}\t{}".format(logp, " ".join(gram))
                    backoff = backoffs[n - 1].get(gram) if n < self.order else None
                    if backoff is not None:
                        line += "\t{:.7f}".format(log10_floor(backoff))
                    entries.append(line)
                entry_lists.append(entries)
                f.write("ngram {}={}\n".format(n, len(entries)))
            for n, entries in enumerate(entry_lists, start=1):
                f.write("\n\\{}-grams:\n".format(n))
                for line in entries:
                    f.write(line + "\n")
            f.write("\n\\end\\\n")
        return path
