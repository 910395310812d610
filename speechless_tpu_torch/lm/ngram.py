"""Word n-gram language model with Katz back-off, loaded from ARPA files (jax-free port
of `speechless_tpu/lm/ngram.py`): the `LanguageModelScorer` interface of the host beam's
shallow fusion (`ops/decode.py::beam_search_decode`), the Python loader and scorer
(`ArpaLanguageModel`, from which `lm/device_lm.py` builds the device tables) and the
C++ scorer of the port's own ``native/ngram_lm.cpp`` (`NativeArpaLanguageModel`, which
the native beam scores with)."""
import gzip
import logging
from pathlib import Path
from typing import Dict, List, Optional, Sequence, Tuple

UNK = "<unk>"
BOS = "<s>"
EOS = "</s>"

logger = logging.getLogger(__name__)


class LanguageModelScorer:
    """Word-level LM interface for beam-search shallow fusion.

    ``score_word(context_words, word)`` returns the log10 probability of ``word`` given the
    preceding words, and ``is_valid_word(word)`` gates the valid-word bonus.
    """

    def score_word(self, context: Sequence[str], word: str) -> float:
        raise NotImplementedError

    def is_valid_word(self, word: str) -> bool:
        raise NotImplementedError


class ArpaLanguageModel(LanguageModelScorer):
    """Back-off n-gram LM. Probabilities are log10, matching ARPA/KenLM convention."""

    def __init__(self, order: int,
                 log_probs: List[Dict[Tuple[str, ...], float]],
                 backoffs: List[Dict[Tuple[str, ...], float]]):
        self.order = order
        self._log_probs = log_probs      # index n-1: n-gram -> log10 p
        self._backoffs = backoffs        # index n-1: n-gram -> log10 backoff weight
        self.vocabulary = set(w for (w,) in log_probs[0].keys()) - {BOS, EOS, UNK}

    @staticmethod
    def load(path: Path) -> "ArpaLanguageModel":
        path = Path(path)
        opener = gzip.open if path.suffix == ".gz" else open
        log_probs: List[Dict[Tuple[str, ...], float]] = []
        backoffs: List[Dict[Tuple[str, ...], float]] = []
        current_order = 0
        with opener(str(path), "rt", encoding="utf8") as f:
            section = None
            for line in f:
                line = line.strip()
                if not line:
                    continue
                if line == "\\data\\":
                    section = "data"
                    continue
                if line.endswith("-grams:") and line.startswith("\\"):
                    current_order = int(line[1:line.index("-")])
                    while len(log_probs) < current_order:
                        log_probs.append({})
                        backoffs.append({})
                    section = "ngrams"
                    continue
                if line == "\\end\\":
                    break
                if section == "ngrams":
                    parts = line.split("\t")
                    if len(parts) < 2:
                        parts = line.split()
                        if len(parts) < current_order + 1:
                            continue
                        prob, words, backoff = parts[0], parts[1:current_order + 1], \
                            parts[current_order + 1:]
                    else:
                        prob = parts[0]
                        words = tuple(parts[1].split())
                        backoff = parts[2:]
                    ngram = tuple(words)
                    log_probs[current_order - 1][ngram] = float(prob)
                    if backoff:
                        backoffs[current_order - 1][ngram] = float(backoff[0])
        if not log_probs:
            raise ValueError("No n-grams found in ARPA file {}".format(path))
        return ArpaLanguageModel(order=len(log_probs), log_probs=log_probs, backoffs=backoffs)

    def _score(self, ngram: Tuple[str, ...]) -> float:
        """log10 p(last word | preceding words) with Katz back-off."""
        order = len(ngram)
        table = self._log_probs[order - 1] if order <= self.order else None
        if table is not None and ngram in table:
            return table[ngram]
        if order == 1:
            unk = self._log_probs[0].get((UNK,))
            return unk if unk is not None else -99.0
        context = ngram[:-1]
        backoff = 0.0
        if len(context) <= self.order:
            backoff = self._backoffs[len(context) - 1].get(context, 0.0)
        return backoff + self._score(ngram[1:])

    def _normalize_word(self, word: str) -> str:
        """KenLM semantics: OOV tokens score as <unk>."""
        return word if (word,) in self._log_probs[0] else UNK

    def score_word(self, context: Sequence[str], word: str) -> float:
        # Only the last order-1 context words matter; normalizing OOV context to <unk>
        # keeps Python and native scorers identical.
        context = tuple(self._normalize_word(w) for w in context[-(self.order - 1):]) \
            if self.order > 1 else ()
        ngram = ((BOS,) + context + (self._normalize_word(word),))[-(self.order):]
        return self._score(ngram)

    def score_sentence(self, words: Sequence[str], include_eos: bool = True) -> float:
        total = 0.0
        for i, word in enumerate(words):
            total += self.score_word(words[:i], word)
        if include_eos:
            sentence = (BOS,) + tuple(words) + (EOS,)
            total += self._score(sentence[-(self.order):])
        return total

    def is_valid_word(self, word: str) -> bool:
        return word in self.vocabulary


class NativeArpaLanguageModel(LanguageModelScorer):
    """The C++ ARPA scorer (``native/ngram_lm.cpp``) behind `ArpaLanguageModel`'s
    interface; the native beam reads its handle."""

    def __init__(self, path: Path):
        from .. import native

        self._native = native.library()
        self._handle = self._native.ngram_load(str(path))
        self.order = self._native.ngram_order(self._handle)

    def __del__(self):
        if getattr(self, "_handle", None):
            self._native.ngram_free(self._handle)
            self._handle = None

    def score_word(self, context: Sequence[str], word: str) -> float:
        # Only the trailing order-1 words can affect the score.
        relevant = context[-(self.order - 1):] if self.order > 1 else []
        return self._native.ngram_score_word(self._handle, " ".join(relevant), word)

    def is_valid_word(self, word: str) -> bool:
        return self._native.ngram_is_valid_word(self._handle, word)

    def score_sentence(self, words: Sequence[str], include_eos: bool = True) -> float:
        total = 0.0
        for i, word in enumerate(words):
            total += self.score_word(words[:i], word)
        if include_eos:
            total += self.score_word(words, EOS)
        return total


def load_language_model(directory_or_file: Path,
                        prefer_native: bool = True) -> Optional[LanguageModelScorer]:
    """Find and load an ARPA LM: a file path, or a KenLM-style directory holding
    ``lm.arpa`` / ``*.arpa`` / ``*.arpa.gz``. Returns None when there is none. The C++
    scorer with ``prefer_native`` (a gzip file always loads in Python), else
    `ArpaLanguageModel`, which `lm/device_lm.py` needs."""
    path = Path(directory_or_file)
    candidate: Optional[Path] = None
    if path.is_file():
        candidate = path
    elif path.is_dir():
        candidates = (sorted(path.glob("lm.arpa")) + sorted(path.glob("*.arpa"))
                      + sorted(path.glob("*.arpa.gz")))
        if candidates:
            candidate = candidates[0]
    if candidate is None:
        logger.info("No ARPA language model found in %s", path)
        return None
    if prefer_native and candidate.suffix != ".gz":
        return NativeArpaLanguageModel(candidate)
    return ArpaLanguageModel.load(candidate)
