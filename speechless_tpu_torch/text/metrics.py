"""Edit-distance metrics and evaluation result aggregation: the port's own copy of
`speechless_tpu/text/metrics.py`.

Edit distance runs in the port's copy of the C++ Levenshtein routine
(``speechless_tpu_torch/native``, built at first use), in place of the original
speechless ``editdistance`` dependency; `_levenshtein_python` is the plain version the
tests hold it against. The lazy LER/WER aggregation classes (`ExpectationVsPrediction`
et al.) print the same ``summary_line`` and ``__str__`` text as the JAX package's.
"""
from functools import cached_property
from typing import Dict, Hashable, List, Sequence

from .. import native
from ..utils.tools import average_or_nan


def _levenshtein_python(a: Sequence[Hashable], b: Sequence[Hashable]) -> int:
    """Plain two-row DP; reference implementation used for testing the fast paths."""
    if len(a) < len(b):
        a, b = b, a
    previous = list(range(len(b) + 1))
    for i, ca in enumerate(a, start=1):
        current = [i]
        for j, cb in enumerate(b, start=1):
            current.append(min(previous[j] + 1, current[j - 1] + 1, previous[j - 1] + (ca != cb)))
        previous = current
    return previous[-1]


def levenshtein(a: Sequence[Hashable], b: Sequence[Hashable]) -> int:
    """Edit distance between two sequences (strings, or lists of words)."""
    if isinstance(a, str) and isinstance(b, str):
        return native.library().levenshtein(a, b)
    # Map arbitrary hashables to a shared id space, then compare as int strings.
    ids: Dict[Hashable, int] = {}

    def to_ids(seq: Sequence[Hashable]) -> str:
        return "".join(chr(ids.setdefault(x, len(ids)) + 1) for x in seq)
    return native.library().levenshtein(to_ids(a), to_ids(b))


class ExpectationVsPrediction:
    """One evaluated utterance: expected vs predicted transcript plus its CTC loss."""

    def __init__(self, expected: str, predicted: str, loss: float):
        self.expected = expected
        self.predicted = predicted
        self.loss = loss
        self.expected_letter_count = len(expected)
        self.expected_words = expected.split()
        self.expected_word_count = len(self.expected_words)

    @cached_property
    def letter_error_count(self) -> int:
        return levenshtein(self.expected, self.predicted)

    @cached_property
    def word_error_count(self) -> int:
        return levenshtein(self.expected_words, self.predicted.split())

    @cached_property
    def letter_error_rate(self) -> float:
        return self.letter_error_count / self.expected_letter_count

    @cached_property
    def word_error_rate(self) -> float:
        return self.word_error_count / self.expected_word_count

    def __str__(self) -> str:
        return ('Expected:  "{}"\nPredicted: "{}"\nErrors: {} letters ({}%), {} words ({}%), '
                "loss: {:.2f}.").format(
            self.expected, self.predicted,
            self.letter_error_count, round(self.letter_error_rate * 100),
            self.word_error_count, round(self.word_error_rate * 100), self.loss)


class ExpectationsVsPredictions:
    """Flat collection of evaluated utterances with lazily computed aggregates."""

    def __init__(self, results: List[ExpectationVsPrediction]):
        self.results = results

    @cached_property
    def average_letter_error_count(self) -> float:
        return average_or_nan([r.letter_error_count for r in self.results])

    @cached_property
    def average_word_error_count(self) -> float:
        return average_or_nan([r.word_error_count for r in self.results])

    @cached_property
    def average_letter_error_rate(self) -> float:
        return average_or_nan([r.letter_error_rate for r in self.results])

    @cached_property
    def average_word_error_rate(self) -> float:
        return average_or_nan([r.word_error_rate for r in self.results])

    @cached_property
    def average_loss(self) -> float:
        return average_or_nan([r.loss for r in self.results])

    def summary_line(self) -> str:
        return ("Average over {} examples: {:.1f} letter errors ({:.2f}%), "
                "{:.1f} word errors ({:.2f}%), loss {:.2f}.").format(
            len(self.results),
            self.average_letter_error_count, self.average_letter_error_rate * 100,
            self.average_word_error_count, self.average_word_error_rate * 100,
            self.average_loss)

    def __str__(self) -> str:
        return "\n\n".join(str(r) for r in self.results) + "\n\n" + self.summary_line() + "\n\n"


class ExpectationsVsPredictionsInBatches(ExpectationsVsPredictions):
    def __init__(self, result_batches: List[ExpectationsVsPredictions]):
        self.result_batches = result_batches
        super().__init__([r for batch in result_batches for r in batch.results])

    def __str__(self) -> str:
        return "All batches: {}".format(self.summary_line())


class ExpectationsVsPredictionsInGroupedBatches(ExpectationsVsPredictions):
    def __init__(self, results_by_group_name: Dict[str, ExpectationsVsPredictionsInBatches]):
        self.result_batches_by_group_name = results_by_group_name
        super().__init__([r for batches in results_by_group_name.values() for r in batches.results])

    def __str__(self) -> str:
        groups = "\n".join("{}: {}".format(name, batches)
                           for name, batches in self.result_batches_by_group_name.items())
        return "\n\n{}\n\nAll corpora: {}\n\n".format(groups, self.summary_line())
