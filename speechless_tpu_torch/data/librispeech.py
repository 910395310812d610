"""LibriSpeech-style corpus acquisition and parsing.

The port's own copy of `speechless_tpu/data/librispeech.py`. Re-provides the original
speechless `english_corpus.py`: download (HTTP or scp) + tar.gz
unpack with optional root-dir skip, fixed-depth directory walk, flac/wav discovery with
id-regex filtering, ``.txt`` transcript parsing (one ``<id> <words...>`` line each,
lowercased), tag removal + whitespace normalization, empty/too-long/too-short filtering,
deterministic splits, and the rich per-corpus statistics summary/CSV.
"""
import os
import re
import string
import subprocess
import tarfile
import random as _random
from collections import Counter, OrderedDict
from functools import cached_property, reduce
from pathlib import Path
from typing import Callable, Dict, Iterable, List, Optional, Union
from urllib import request

from ..features.example import LabeledExampleFromFile, PositionalLabel
from ..utils.tools import count_summary, distinct, extension, log, mkdir, name_without_extension
from .corpus import Corpus, ComposedCorpus, TrainingTestSplit

english_frequent_characters = list(string.ascii_lowercase + " '")

MATCH_ALL = re.compile(r"[\s\S]*")


class LibriSpeechCorpus(Corpus):
    #: Mirror override: ``SPEECHLESS_LIBRISPEECH_URL`` redirects every default-URL
    #: LibriSpeech fetch (corporate mirrors / air-gapped fixture servers) without
    #: touching the `Configuration.english()/minimal_english()` entry points —
    #: exercised end-to-end by `examples/librispeech_dress_rehearsal.py`.
    DEFAULT_URL = "http://www.openslr.org/resources/12/"

    def __init__(self,
                 base_directory: Path,
                 corpus_name: str,
                 base_source_url_or_directory: Optional[str] = None,
                 tar_gz_extension: str = ".tar.gz",
                 mel_frequency_count: int = 128,
                 root_compressed_directory_name_to_skip: Optional[str] = "LibriSpeech/",
                 subdirectory_depth: int = 3,
                 allowed_characters: List[str] = english_frequent_characters,
                 tags_to_ignore: Iterable[str] = (),
                 id_filter_regex=MATCH_ALL,
                 training_test_split: Callable = TrainingTestSplit.randomly(),
                 maximum_example_duration_in_s: Optional[int] = None,
                 minimum_duration_per_character: Optional[float] = None):
        self.base_directory = Path(base_directory)
        self.corpus_name = corpus_name
        if base_source_url_or_directory is None:
            base_source_url_or_directory = os.environ.get(
                "SPEECHLESS_LIBRISPEECH_URL", self.DEFAULT_URL)
        self.base_url_or_directory = base_source_url_or_directory
        self.tar_gz_extension = tar_gz_extension
        self.mel_frequency_count = mel_frequency_count
        self.root_compressed_directory_name_to_skip = root_compressed_directory_name_to_skip
        self.subdirectory_depth = subdirectory_depth
        self.allowed_characters = allowed_characters
        self.tags_to_ignore = list(tags_to_ignore)
        self.id_filter_regex = id_filter_regex
        self.training_test_split = training_test_split
        self.maximum_example_duration_in_s = maximum_example_duration_in_s
        self.minimum_duration_per_character_in_s = minimum_duration_per_character
        mkdir(self.base_directory)

        self.corpus_directory = self._ensure_downloaded_and_unpacked()
        self.files = self._walk_files()

        self.unfiltered_audio_files = [
            f for f in self.files if f.name.lower().endswith((".flac", ".wav"))]
        audio_files = [f for f in self.unfiltered_audio_files
                       if self.id_filter_regex.match(name_without_extension(f))]
        self.filtered_out_count = len(self.unfiltered_audio_files) - len(audio_files)

        positional_label_by_id = self._extract_positional_label_by_id(self.files)
        found_audio_ids = set(name_without_extension(f) for f in audio_files)
        found_label_ids = positional_label_by_id.keys()
        self.audio_ids_without_label = list(found_audio_ids - found_label_ids)
        self.label_ids_without_audio = list(found_label_ids - found_audio_ids)

        self.examples_with_empty_and_too_long_or_short = [
            self._make_example(f, positional_label_by_id[name_without_extension(f)])
            for f in audio_files if name_without_extension(f) in found_label_ids]
        self.examples_with_too_long_or_short = [
            e for e in self.examples_with_empty_and_too_long_or_short if e.label]
        self.examples_with_too_short = [
            e for e in self.examples_with_too_long_or_short if not self.is_too_long(e)]
        examples = [e for e in self.examples_with_too_short if not self.is_too_short(e)]

        training, test = self.training_test_split(sorted(examples, key=lambda e: e.id))
        super().__init__(training_examples=training, test_examples=test)

    # -- acquisition ------------------------------------------------------

    def _ensure_downloaded_and_unpacked(self) -> Path:
        target_directory = self.base_directory / self.corpus_name
        if not target_directory.exists():
            archive_name = self.corpus_name + self.tar_gz_extension
            archive_path = self._fetch(self.base_url_or_directory + archive_name,
                                       self.base_directory / archive_name)
            self._unpack(archive_path, target_directory)
        return target_directory

    def _fetch(self, source: str, target: Path) -> Path:
        if not target.is_file():
            log("Downloading corpus {} to {}".format(source, target))
            if self.base_url_or_directory.startswith("http"):
                request.urlretrieve(source, str(target))
            else:
                try:
                    subprocess.check_output(["scp", source, str(target)],
                                            stderr=subprocess.STDOUT)
                except subprocess.CalledProcessError as e:
                    raise IOError("Copying failed: " + str(e.output))
        return target

    def _unpack(self, archive: Path, target_directory: Path) -> None:
        if target_directory.is_dir():
            return
        root = Path(target_directory).resolve()
        with tarfile.open(str(archive), "r:gz") as tar:
            members = tar.getmembers()
            skip = self.root_compressed_directory_name_to_skip
            for member in members:
                if skip is not None and member.name.startswith(skip):
                    member.name = member.name[len(skip):]
                # Corpus archives hold only files and directories; link/device members
                # could redirect later writes outside the target (a symlink extracted
                # first would defeat the path check below), so refuse them outright.
                if not (member.isfile() or member.isdir()):
                    raise IOError("Archive member has unsupported type: {}".format(
                        member.name))
                # Refuse members that would land outside the target (absolute paths or
                # '..' traversal in a crafted archive).
                resolved = (root / member.name).resolve()
                if root != resolved and root not in resolved.parents:
                    raise IOError("Archive member escapes target directory: {}".format(
                        member.name))
            tar.extractall(str(target_directory), members=members)

    def _walk_files(self) -> List[Path]:
        directories = [self.corpus_directory]
        for _ in range(self.subdirectory_depth):
            directories = [sub for d in directories for sub in d.iterdir() if sub.is_dir()]
        return [f for d in directories for f in d.iterdir() if f.is_file()]

    # -- labels -----------------------------------------------------------

    def _extract_positional_label_by_id(self, files: Iterable[Path]
                                        ) -> Dict[str, Union[PositionalLabel, str]]:
        """LibriSpeech transcript format: ``.txt`` files of ``<id> <words...>`` lines."""
        labels: Dict[str, Union[PositionalLabel, str]] = OrderedDict()
        for label_file in (f for f in files if f.name.endswith(".txt")):
            with label_file.open() as f:
                for line in f:
                    parts = line.split()
                    if parts:
                        labels[parts[0]] = " ".join(parts[1:]).lower()
        return labels

    def _remove_tags_to_ignore(self, text: str) -> str:
        return reduce(lambda t, tag: t.replace(tag, ""), self.tags_to_ignore, text)

    def _make_example(self, audio_file: Path,
                      raw_label: Union[PositionalLabel, str]) -> LabeledExampleFromFile:
        def correct(label: str) -> str:
            return " ".join(self._remove_tags_to_ignore(label).split()).strip()

        if isinstance(raw_label, PositionalLabel):
            positional = raw_label.with_corrected_labels(correct).convert_range_to_seconds(
                LabeledExampleFromFile.file_sample_rate(audio_file))
            return LabeledExampleFromFile(
                audio_file, mel_frequency_count=self.mel_frequency_count,
                label=positional.label, label_with_tags=raw_label.label,
                positional_label=positional)
        return LabeledExampleFromFile(
            audio_file, mel_frequency_count=self.mel_frequency_count,
            label=correct(raw_label), label_with_tags=raw_label, positional_label=None)

    # -- filters ----------------------------------------------------------

    def is_too_long(self, example) -> bool:
        return (self.maximum_example_duration_in_s is not None and
                example.duration_in_s > self.maximum_example_duration_in_s)

    def is_too_short(self, example) -> bool:
        return (self.minimum_duration_per_character_in_s is not None and
                example.duration_in_s <
                len(example.label) * self.minimum_duration_per_character_in_s)

    def is_allowed(self, label: str) -> bool:
        return all(c in self.allowed_characters for c in label)

    # -- statistics (summary/CSV reporting surface) -----------------------

    @cached_property
    def empty_examples(self):
        return [e for e in self.examples_with_empty_and_too_long_or_short if not e.label]

    @cached_property
    def too_long_examples(self):
        return [e for e in self.examples_with_too_long_or_short if self.is_too_long(e)]

    @cached_property
    def too_short_examples(self):
        return [e for e in self.examples_with_too_short if self.is_too_short(e)]

    @cached_property
    def invalid_examples_texts(self):
        return ["Invalid characters {} in {}".format(
            distinct([c for c in e.label if c not in self.allowed_characters]), str(e))
            for e in self.examples if not self.is_allowed(e.label)]

    @cached_property
    def invalid_examples_summary(self):
        return "".join(t + "\n" for t in self.invalid_examples_texts)

    @cached_property
    def duplicate_label_count(self):
        return len(self.examples) - len(set(e.label for e in self.examples))

    @cached_property
    def most_duplicated_labels(self):
        return Counter(e.label for e in self.examples).most_common(10)

    @cached_property
    def file_extensions(self):
        return [extension(f) for f in self.corpus_directory.glob("**/*.*") if f.is_file()]

    @cached_property
    def file_type_summary(self):
        return count_summary(self.file_extensions)

    @cached_property
    def tags_from_all_examples(self):
        return [tag for e in self.examples for tag in self.tags_to_ignore
                for _ in range(e.tag_count(tag))]

    @cached_property
    def tag_summary(self):
        return count_summary(self.tags_from_all_examples)

    @cached_property
    def some_original_sample_rates(self):
        sample = _random.sample(self.examples, min(50, len(self.examples)))
        return [e.original_sample_rate for e in sample]

    @cached_property
    def original_sample_rate_summary(self):
        return count_summary(self.some_original_sample_rates)

    @cached_property
    def examples_without_positional_labels(self):
        return [e for e in self.examples if not e.positional_label]

    @cached_property
    def total_duration_in_h(self):
        return sum(e.duration_in_s for e in self.examples) / 3600

    @cached_property
    def total_training_duration_in_h(self):
        return sum(e.duration_in_s for e in self.training_examples) / 3600

    @cached_property
    def total_test_duration_in_h(self):
        return sum(e.duration_in_s for e in self.test_examples) / 3600

    @cached_property
    def total_duration_of_too_long_examples_in_h(self):
        return sum(e.duration_in_s for e in self.too_long_examples) / 3600

    def csv_rows(self):
        return [[self.corpus_name, self.file_type_summary,
                 len(self.unfiltered_audio_files), self.filtered_out_count,
                 self.id_filter_regex,
                 len(self.audio_ids_without_label), str(self.audio_ids_without_label[:10]),
                 len(self.label_ids_without_audio), self.label_ids_without_audio[:10],
                 self.tag_summary, len(self.examples),
                 len(self.invalid_examples_texts), self.invalid_examples_summary,
                 len(self.empty_examples), [e.id for e in self.empty_examples[:10]],
                 self.duplicate_label_count, self.most_duplicated_labels,
                 len(self.training_examples), len(self.test_examples),
                 len(self.examples_without_positional_labels),
                 self.total_duration_in_h, self.total_training_duration_in_h,
                 self.total_test_duration_in_h,
                 self.total_duration_of_too_long_examples_in_h,
                 len(self.too_long_examples), len(self.too_short_examples),
                 [e.id for e in self.too_short_examples]]]

    def summary(self) -> str:
        lines = ["File types: {}".format(self.file_type_summary)]
        if self.filtered_out_count > 0:
            lines.append("Out of {} audio files, {} were excluded by regex {}".format(
                len(self.unfiltered_audio_files), self.filtered_out_count,
                self.id_filter_regex))
        if self.audio_ids_without_label:
            lines.append("{} audio files without matching label; will be excluded, "
                         "e. g. {}.".format(len(self.audio_ids_without_label),
                                            self.audio_ids_without_label[:10]))
        if self.label_ids_without_audio:
            lines.append("{} labels without matching audio file; will be excluded, "
                         "e. g. {}.".format(len(self.label_ids_without_audio),
                                            self.label_ids_without_audio[:10]))
        if self.tag_summary:
            lines.append("Removed label tags: {}".format(self.tag_summary))
        if self.invalid_examples_summary:
            lines.append(self.invalid_examples_summary.rstrip("\n"))
        lines.append(
            "{} extracted examples, of them {} invalid, {} empty (will be excluded), "
            "{} too long, {} too short, {} duplicate, {} without positions.".format(
                len(self.examples), len(self.invalid_examples_texts),
                len(self.empty_examples), len(self.too_long_examples),
                len(self.too_short_examples), self.duplicate_label_count,
                len(self.examples_without_positional_labels)))
        lines.append("{} training examples, {} test examples.".format(
            len(self.training_examples), len(self.test_examples)))
        return self.corpus_name + "\n" + "\n".join("\t" + line for line in lines)


def dev_clean(base_directory: Path) -> LibriSpeechCorpus:
    return LibriSpeechCorpus(base_directory=base_directory, corpus_name="dev-clean",
                             training_test_split=TrainingTestSplit.training_only)


def english_corpus(base_directory: Path) -> ComposedCorpus:
    """All 1000h LibriSpeech splits; test-clean is the test set (to compare with the
    wav2letter paper, `english_corpus.py:315-329`)."""
    def train_split(name: str) -> LibriSpeechCorpus:
        return LibriSpeechCorpus(base_directory=base_directory, corpus_name=name,
                                 training_test_split=TrainingTestSplit.training_only)

    return ComposedCorpus([
        dev_clean(base_directory),
        train_split("dev-other"),
        train_split("train-clean-100"),
        train_split("train-clean-360"),
        train_split("train-other-500"),
        LibriSpeechCorpus(base_directory=base_directory, corpus_name="test-clean",
                          training_test_split=TrainingTestSplit.test_only),
    ])


def minimal_english_corpus(base_directory: Path) -> ComposedCorpus:
    return ComposedCorpus([dev_clean(base_directory)])
