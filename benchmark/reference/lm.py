"""A plain ARPA reader and Katz back-off scorer (log10), the reference of the word LM
that the serving cells' beam fuses.

``score(c1, c2, w)`` is log10 P(w | c1 c2): the trigram if listed, else the context's
back-off plus the bigram score, which is the bigram if listed, else the back-off of
``c2`` plus the unigram. Out-of-vocabulary words score as ``<unk>``; the context starts
as ``<s> <s>``.
"""
from typing import Dict, Tuple

BOS, UNK = "<s>", "<unk>"


class Arpa:
    """The model of an ARPA file's text."""

    def __init__(self, text: str):
        self.probs: Dict[Tuple[str, ...], float] = {}
        self.backoffs: Dict[Tuple[str, ...], float] = {}
        order = 0
        for line in text.splitlines():
            line = line.strip()
            if not line or line == "\\data\\" or line.startswith("ngram "):
                continue
            if line.startswith("\\") and line.endswith("-grams:"):
                order = int(line[1:line.index("-")])
                continue
            if line == "\\end\\":
                break
            parts = line.split("\t")
            gram = tuple(parts[1].split())
            if len(gram) != order:
                raise ValueError("{}-gram line {!r}".format(order, line))
            self.probs[gram] = float(parts[0])
            if len(parts) > 2:
                self.backoffs[gram] = float(parts[2])
        self.vocabulary = {g[0] for g in self.probs if len(g) == 1} - {BOS, "</s>", UNK}

    def normal(self, word: str) -> str:
        return word if word in self.vocabulary else UNK

    def score(self, c1: str, c2: str, word: str) -> float:
        if (c1, c2, word) in self.probs:
            return self.probs[(c1, c2, word)]
        if (c2, word) in self.probs:
            bigram = self.probs[(c2, word)]
        else:
            bigram = self.backoffs.get((c2,), 0.0) + self.probs.get((word,), -99.0)
        return self.backoffs.get((c1, c2), 0.0) + bigram
