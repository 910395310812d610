"""Corpus core: train/test example collections, deterministic splits, CSV persistence.

The port's own copy of `speechless_tpu/data/corpus.py`. Re-provides the corpus layer of
the original speechless (`corpus.py`):

* duplicate-id and train/test-overlap validation on construction;
* seeded (42) subsampling of training examples;
* CSV save/load with rows ``(id, audio_path, label, phase, serialized positional label)``;
* ``grouped_by`` sub-corpora keyed arbitrarily, ``ComposedCorpus`` concatenation;
* ``TrainingTestSplit`` strategies, all deterministic with seed 42.
"""
import csv
import random
from enum import Enum
from pathlib import Path
from typing import Any, Callable, Dict, List, Optional, Tuple, TypeVar

from collections import OrderedDict

from ..features.example import LabeledExample, LabeledExampleFromFile, PositionalLabel
from ..utils.tools import duplicates, group, log

K = TypeVar("K")


class ParsingException(Exception):
    pass


class Phase(Enum):
    training = "training"
    test = "test"


class Corpus:
    def __init__(self,
                 training_examples: List[LabeledExample],
                 test_examples: List[LabeledExample],
                 sampled_training_example_count: Optional[int] = None):
        if sampled_training_example_count is not None:
            training_examples = random.Random(42).sample(
                training_examples, sampled_training_example_count)
        self.sampled_training_example_count = sampled_training_example_count
        self.training_examples = training_examples
        self.test_examples = test_examples
        self.examples = list(training_examples) + list(test_examples)

        log("Training on {} examples, testing on {} examples.".format(
            len(self.training_examples), len(self.test_examples)))

        for name, examples in (("training", training_examples), ("test", test_examples)):
            dup = duplicates(e.id for e in examples)
            if dup:
                raise ValueError("Duplicate ids in {} examples: {}".format(name, dup))
        overlap = duplicates(e.id for e in self.examples)
        if overlap:
            raise ValueError("Overlapping training and test set: {}".format(overlap))

    # -- persistence ------------------------------------------------------

    def save(self, corpus_csv_file: Path, use_relative_audio_file_paths: bool = True) -> None:
        corpus_csv_file = Path(corpus_csv_file)
        with corpus_csv_file.open("w", encoding="utf8", newline="") as f:
            writer = csv.writer(f, delimiter=",", quotechar='"', quoting=csv.QUOTE_MINIMAL)
            for example, phase in ([(e, Phase.training) for e in self.training_examples] +
                                   [(e, Phase.test) for e in self.test_examples]):
                audio_path = example.audio_file
                if use_relative_audio_file_paths:
                    # A composed corpus's audio may lie beside the csv's directory
                    # (``../English/...``), where the JAX package's relative_to raises.
                    audio_path = audio_path.relative_to(corpus_csv_file.parent,
                                                        walk_up=True)
                writer.writerow((example.id, str(audio_path), example.label, phase.value,
                                 example.positional_label.serialize()
                                 if example.positional_label else ""))

    @staticmethod
    def load(corpus_csv_file: Path,
             sampled_training_example_count: Optional[int] = None) -> "Corpus":
        corpus_csv_file = Path(corpus_csv_file)
        training, test = [], []
        with corpus_csv_file.open(encoding="utf8", newline="") as f:
            for id, audio_path, label, phase, positional in csv.reader(
                    f, delimiter=",", quotechar='"', quoting=csv.QUOTE_MINIMAL):
                path = Path(audio_path)
                if not path.is_absolute():
                    path = corpus_csv_file.parent / path
                example = LabeledExampleFromFile(
                    audio_file=path, id=id, label=label,
                    positional_label=PositionalLabel.deserialize(positional)
                    if positional else None)
                (training if Phase(phase) == Phase.training else test).append(example)
        return Corpus(training_examples=training, test_examples=test,
                      sampled_training_example_count=sampled_training_example_count)

    # -- structure --------------------------------------------------------

    def grouped_by(self, key: Callable[[LabeledExample], K]) -> Dict[K, "Corpus"]:
        training_by_key = group(self.training_examples, key=key)
        test_by_key = group(self.test_examples, key=key)
        keys = group(self.examples, key=key).keys()
        return OrderedDict(
            (k, Corpus(training_examples=list(training_by_key.get(k, ())),
                       test_examples=list(test_by_key.get(k, ()))))
            for k in keys)

    def csv_rows(self) -> List[List[Any]]:
        """Per-source summary rows; a corpus loaded from ``corpus.csv`` knows no sources
        and has none. (The JAX package raises here, so that ``summarize`` fails on the
        German configurations, which load their corpus from ``corpus.csv``.)"""
        return []

    def summary(self) -> str:
        return "{} examples, {} training, {} test".format(
            len(self.examples), len(self.training_examples), len(self.test_examples))

    def summarize_to_csv(self, summary_csv_file: Path) -> None:
        with Path(summary_csv_file).open("w", encoding="utf8", newline="") as f:
            writer = csv.writer(f, delimiter=",", quotechar='"', quoting=csv.QUOTE_MINIMAL)
            for row in self.csv_rows():
                writer.writerow(row)


class ComposedCorpus(Corpus):
    """Concatenation of corpora (`corpus.py:125-144`)."""

    def __init__(self, corpora: List[Corpus]):
        self.corpora = corpora
        super().__init__(
            training_examples=[e for c in corpora for e in c.training_examples],
            test_examples=[e for c in corpora for e in c.test_examples])

    def csv_rows(self) -> List[List[Any]]:
        return [row for corpus in self.corpora for row in corpus.csv_rows()]

    def summary(self) -> str:
        return "\n\n".join(c.summary() for c in self.corpora) + \
            "\n\n {} total, {} training, {} test".format(
                len(self.examples), len(self.training_examples), len(self.test_examples))


SplitFn = Callable[[List[LabeledExample]], Tuple[List[LabeledExample], List[LabeledExample]]]


class TrainingTestSplit:
    """Deterministic split strategies (seed 42 preserved from `corpus.py:147-194`)."""

    training_only: SplitFn = staticmethod(lambda examples: (examples, []))
    test_only: SplitFn = staticmethod(lambda examples: ([], examples))

    @staticmethod
    def randomly_grouped_by(key_from_example: Callable[[LabeledExample], Any],
                            training_share: float = 0.9) -> SplitFn:
        def split(examples):
            keys = list(group(examples, key=key_from_example).keys())
            rand = random.Random(42)
            training_keys = set(rand.sample(keys, int(training_share * len(keys))))
            training = [e for e in examples if key_from_example(e) in training_keys]
            test = [e for e in examples if key_from_example(e) not in training_keys]
            return training, test
        return split

    @staticmethod
    def randomly(training_share: float = 0.9) -> SplitFn:
        return TrainingTestSplit.randomly_grouped_by(lambda e: e.id, training_share)

    @staticmethod
    def randomly_grouped_by_directory(training_share: float = 0.9) -> SplitFn:
        return TrainingTestSplit.randomly_grouped_by(lambda e: e.audio_directory,
                                                     training_share)

    @staticmethod
    def overfit(training_example_count: int) -> SplitFn:
        return lambda examples: (examples[:training_example_count],
                                 examples[training_example_count:])

    @staticmethod
    def by_directory(test_directory_name: str = "test") -> SplitFn:
        def split(examples):
            training = [e for e in examples if e.audio_directory.name != test_directory_name]
            test = [e for e in examples if e.audio_directory.name == test_directory_name]
            return training, test
        return split
