"""Orchestration (port of `speechless_tpu/configuration.py`): named configurations, the
data-directory layout, and the train/test/load workflows.

Preserves the reference's public API (the original speechless `configuration.py`):
``Configuration.minimal_english().train_from_beginning()``, ``load_model(...)`` with
``allowed_characters_for_loaded_model`` transfer, the German and mixed German-English
configurations, ``train_transfer_from_best_english_model``,
``test_model_grouped_by_loaded_corpus_name``, the ``~/speechless-data`` directory layout,
and the ``LoggedRun`` per-run file logging. ``wav2letter_kwargs`` choose the model
variant (``use_asg``, ``train_asg_transitions``, ``use_raw_wave_input``, which also
sets the input size to 1, and ``activation``) on the fresh and on the resume path. In
a world of more than one process the batch generator is the sharded one
(`data.batching.ShardedBatchGenerator`), and the facade trains on a mesh.
"""
import logging
from collections import OrderedDict
from functools import cached_property
from pathlib import Path
from typing import Callable, List, Optional

from .data.batching import LabeledSpectrogramBatchGenerator
from .data.corpus import ComposedCorpus, Corpus
from .data.german import german_corpus, german_frequent_characters
from .data.librispeech import (english_corpus, english_frequent_characters,
                               minimal_english_corpus)
from .features.example import LabeledExampleFromFile
from .system import Wav2Letter
from .text.metrics import ExpectationsVsPredictionsInGroupedBatches
from .utils.tools import home_directory, log, logger, mkdir, timestamp, write_text

class DataDirectories:
    """`~/speechless-data` layout (`configuration.py:22-31`)."""

    def __init__(self, data_directory: Path = home_directory() / "speechless-data"):
        self.data_directory = data_directory
        self.corpus_base_directory = data_directory / "corpus"
        self.spectrogram_cache_base_directory = data_directory / "spectrogram-cache"
        self.tensorboard_log_base_directory = data_directory / "logs"
        self.nets_base_directory = data_directory / "nets"
        self.kenlm_base_directory = data_directory / "kenlm"
        self.recording_directory = data_directory / "recordings"
        self.test_results_directory = data_directory / "test-results"


default_data_directories = DataDirectories()


class Configuration:
    def __init__(self,
                 name: str,
                 corpus_from_directory: Callable[[Path], Corpus],
                 allowed_characters: List[str] = english_frequent_characters,
                 directories: DataDirectories = None,
                 mel_frequency_count: int = 128,
                 training_batches_per_epoch: int = 100,
                 batch_size: int = 64,
                 bucket_training_batches: bool = False):
        self.name = name
        self.corpus_from_directory = corpus_from_directory
        self.allowed_characters = allowed_characters
        self.directories = directories if directories is not None else default_data_directories
        self.mel_frequency_count = mel_frequency_count
        self.training_batches_per_epoch = training_batches_per_epoch
        self.batch_size = batch_size
        self.bucket_training_batches = bucket_training_batches
        self.spectrogram_cache_directory = \
            self.directories.spectrogram_cache_base_directory / name
        self.corpus_directory = self.directories.corpus_base_directory / name

    @cached_property
    def corpus(self) -> Corpus:
        return self.corpus_from_directory(self.corpus_directory)

    @cached_property
    def batch_generator(self) -> LabeledSpectrogramBatchGenerator:
        return self.batch_generator_for_corpus(self.corpus)

    def batch_generator_for_corpus(self, corpus: Corpus, mesh=None
                                   ) -> LabeledSpectrogramBatchGenerator:
        """In a world of more than one process, the sharded generator: every rank draws
        the same global batch and keeps its data rank's slice, with the global batch's
        bucket hints. ``mesh`` is the model's (`Wav2Letter.mesh`): its data axis gives
        the slice, so the ranks of one model group take the same rows (JAX slices per
        process, and a process feeds all of its devices). Without one the world is the
        data axis, as on the facade's default mesh."""
        import torch.distributed as dist

        if dist.is_available() and dist.is_initialized() and dist.get_world_size() > 1:
            from .data.batching import ShardedBatchGenerator
            if mesh is None:
                host_id, host_count = dist.get_rank(), dist.get_world_size()
            else:
                from .parallel.mesh import DATA_AXIS, axis_rank, axis_size
                host_id, host_count = axis_rank(mesh, DATA_AXIS), axis_size(mesh, DATA_AXIS)
            return ShardedBatchGenerator(
                corpus=corpus, spectrogram_cache_directory=self.spectrogram_cache_directory,
                batch_size=self.batch_size, host_id=host_id, host_count=host_count,
                bucket_training_batches=self.bucket_training_batches)
        return LabeledSpectrogramBatchGenerator(
            corpus=corpus, spectrogram_cache_directory=self.spectrogram_cache_directory,
            batch_size=self.batch_size,
            bucket_training_batches=self.bucket_training_batches)

    # -- named configurations --------------------------------------------

    @staticmethod
    def english(directories: "DataDirectories" = None) -> "Configuration":
        return Configuration(name="English", corpus_from_directory=english_corpus,
                             directories=directories)

    @staticmethod
    def minimal_english(directories: "DataDirectories" = None) -> "Configuration":
        return Configuration(name="English", corpus_from_directory=minimal_english_corpus,
                             directories=directories)

    @staticmethod
    def german(from_cached: bool = True,
               sampled_training_example_count_when_loading_from_cached: Optional[int] = None,
               directories: "DataDirectories" = None) -> "Configuration":
        def load_cached_corpus(corpus_directory: Path) -> Corpus:
            return Corpus.load(
                corpus_directory / "corpus.csv",
                sampled_training_example_count=
                sampled_training_example_count_when_loading_from_cached)

        return Configuration(
            name="German", allowed_characters=german_frequent_characters,
            corpus_from_directory=load_cached_corpus if from_cached else german_corpus,
            directories=directories)

    @staticmethod
    def mixed_german_english(directories: "DataDirectories" = None) -> "Configuration":
        return Configuration(
            name="mixed-English-German",
            allowed_characters=german_frequent_characters,
            directories=directories,
            corpus_from_directory=lambda _: ComposedCorpus(
                [Configuration.english(directories).corpus,
                 Configuration.german(directories=directories).corpus]))

    # -- workflows --------------------------------------------------------

    def train(self, wav2letter: Wav2Letter, run_name: str, **train_kwargs) -> None:
        """``device_resident=True`` packs the training corpus into device memory once and
        samples batches there (`data.device_dataset`) instead of streaming them through
        the host pipeline; ``multi_step`` and bucketing have no effect then, and are
        dropped with a warning. A facade on a mesh takes its batches from a generator
        sliced over the mesh's data axis."""
        generator = self.batch_generator if wav2letter.mesh is None else \
            self.batch_generator_for_corpus(self.corpus, mesh=wav2letter.mesh)
        if train_kwargs.pop("device_resident", False):
            dropped = [key for key in ("multi_step",) if key in train_kwargs]
            if dropped:
                log("Warning: device_resident=True ignores host-pipeline option(s) {} "
                    "(each epoch is one on-device dispatch).".format(dropped))
                for key in dropped:
                    train_kwargs.pop(key)
            if self.bucket_training_batches:
                log("Warning: bucket_training_batches has no effect with "
                    "device_resident=True (the corpus is packed to one HBM-resident "
                    "shape).")
            train_kwargs.setdefault("device_resident_examples",
                                    generator.labeled_training_spectrograms)
            train_kwargs.setdefault("batch_size", self.batch_size)
        wav2letter.train(
            generator.training_batches(),
            preview_labeled_spectrogram_batch=generator.preview_batch(),
            tensor_board_log_directory=self.directories.tensorboard_log_base_directory / run_name,
            net_directory=self.directories.nets_base_directory / run_name,
            batches_per_epoch=self.training_batches_per_epoch, **train_kwargs)

    def _input_size_per_time_step(self, wav2letter_kwargs: dict) -> int:
        # The raw-wave model family consumes (samples, 1) waveforms, not mel frames.
        return 1 if wav2letter_kwargs.get("use_raw_wave_input") \
            else self.mel_frequency_count

    def train_from_beginning(self, wav2letter_kwargs: Optional[dict] = None,
                             **train_kwargs) -> None:
        """``wav2letter_kwargs`` (e.g. ``spec_augment``, ``gradient_clip_norm``) reach
        the model constructor; everything else goes to :meth:`train`."""
        wav2letter_kwargs = wav2letter_kwargs or {}
        wav2letter = Wav2Letter(self._input_size_per_time_step(wav2letter_kwargs),
                                allowed_characters=self.allowed_characters,
                                **wav2letter_kwargs)
        self.train(wav2letter,
                   run_name=timestamp() + "-adam-small-learning-rate-complete-training-{}{}"
                   .format(self.name, self.sampled_training_example_count_extension()),
                   **train_kwargs)

    def train_or_resume(self, run_name: str, frozen_layer_count: int = 0,
                        wav2letter_kwargs: Optional[dict] = None,
                        **train_kwargs) -> None:
        """Crash recovery workflow: resume ``run_name`` from its latest checkpoint (weights
        + optimizer state) or start it from scratch if none exists. The reference required
        manually picking ``load_epoch`` (SURVEY.md §5); here recovery is automatic.

        ``frozen_layer_count`` must match the original run's freezing (a transfer run
        resumed without it would silently unfreeze and rebuild optimizer state);
        ``wav2letter_kwargs`` (e.g. ``gradient_clip_norm``, ``use_asg``) reach the model
        constructor on both the fresh and the resume path."""
        from .experiments import available_epochs

        wav2letter_kwargs = dict(wav2letter_kwargs or {})
        net_directory = self.directories.nets_base_directory / run_name
        wav2letter = None
        # Walk back past unreadable checkpoints (e.g. truncated by the crash being
        # recovered from; writes are atomic, but belt and braces).
        for epoch in reversed(available_epochs(net_directory)):
            try:
                wav2letter = self.load_model(load_name=run_name, load_epoch=epoch,
                                             frozen_layer_count=frozen_layer_count,
                                             allowed_characters_for_loaded_model=None,
                                             **wav2letter_kwargs)
                log("Resuming run {} from epoch {}.".format(run_name, epoch))
                break
            except Exception as e:
                log("Checkpoint epoch {} of run {} unreadable ({}); trying earlier.".format(
                    epoch, run_name, e))
        if wav2letter is None:
            log("Starting run {} from scratch.".format(run_name))
            wav2letter = Wav2Letter(self._input_size_per_time_step(wav2letter_kwargs),
                                    allowed_characters=self.allowed_characters,
                                    **wav2letter_kwargs)
        self.train(wav2letter, run_name=run_name, **train_kwargs)

    def train_transfer_from_best_english_model(
            self, frozen_layer_count: int,
            reinitialize_trainable_loaded_layers: bool = False,
            wav2letter_kwargs: Optional[dict] = None, **train_kwargs) -> None:
        """Load `english_baseline` with its output layer remapped to this configuration's
        characters and the first ``frozen_layer_count`` layers frozen, and train it. The
        run continues the donor's epoch numbering (the reference's ``initial_epoch =
        load_epoch``), so an ``epoch_limit`` counts from the donor's epoch."""
        run_name = timestamp() + "-adam-small-learning-rate-transfer-to-{}-freeze-{}{}{}".format(
            self.name, frozen_layer_count,
            "-reinitialize" if reinitialize_trainable_loaded_layers else "",
            self.sampled_training_example_count_extension())
        log("Run: " + run_name)
        wav2letter = self.load_best_english_model(
            frozen_layer_count=frozen_layer_count,
            reinitialize_trainable_loaded_layers=reinitialize_trainable_loaded_layers,
            **(wav2letter_kwargs or {}))
        self.train(wav2letter, run_name=run_name, **train_kwargs)

    def sampled_training_example_count_extension(self) -> str:
        count = self.corpus.sampled_training_example_count
        return "-{}examples".format(count) if count is not None else ""

    def summarize_and_save_corpus(self) -> None:
        log(self.corpus.summary())
        # The mixed configuration's own directory holds no audio, so it may not exist
        # yet (the JAX package fails there).
        mkdir(self.corpus_directory)
        self.corpus.summarize_to_csv(self.corpus_directory / "summary.csv")
        self.save_corpus()

    def save_corpus(self) -> None:
        self.corpus.save(self.corpus_directory / "corpus.csv")

    def fill_cache(self, repair_incorrect: bool = False) -> None:
        self.batch_generator.fill_cache(repair_incorrect=repair_incorrect)

    def test_model(self, wav2letter: Wav2Letter) -> None:
        log(wav2letter.test_and_predict_batch(self.batch_generator.preview_batch()))
        log(wav2letter.test_and_predict_batches(self.batch_generator.test_batches()))

    def test_model_grouped_by_loaded_corpus_name(self, wav2letter: Wav2Letter
                                                 ) -> ExpectationsVsPredictionsInGroupedBatches:
        def corpus_name(example: LabeledExampleFromFile) -> str:
            # Composed cross-language corpora hold examples OUTSIDE this
            # configuration's own corpus directory (under corpus/<English|German>/...);
            # group those by language directory.
            directory = example.audio_directory
            if directory.is_relative_to(self.corpus_directory):
                return directory.relative_to(self.corpus_directory).parts[0]
            return directory.relative_to(
                self.directories.corpus_base_directory).parts[0]

        corpus_by_name = self.corpus.grouped_by(corpus_name)
        log([(name, len(corpus.test_examples)) for name, corpus in corpus_by_name.items()])
        result = wav2letter.test_and_predict_grouped_batches(OrderedDict(
            (name, self.batch_generator_for_corpus(corpus).test_batches())
            for name, corpus in corpus_by_name.items()))
        log(result)
        return result

    # -- model loading ----------------------------------------------------

    def load_model(self,
                   load_name: str,
                   load_epoch: int,
                   frozen_layer_count: int = 0,
                   allowed_characters_for_loaded_model: List[str] = english_frequent_characters,
                   use_kenlm: bool = False,
                   reinitialize_trainable_loaded_layers: bool = False,
                   language_model_name_extension: str = "",
                   **wav2letter_kwargs) -> Wav2Letter:
        return Wav2Letter(
            allowed_characters=self.allowed_characters,
            input_size_per_time_step=self._input_size_per_time_step(wav2letter_kwargs),
            load_model_from_directory=self.directories.nets_base_directory / load_name,
            load_epoch=load_epoch,
            allowed_characters_for_loaded_model=allowed_characters_for_loaded_model,
            frozen_layer_count=frozen_layer_count,
            kenlm_directory=(self.directories.kenlm_base_directory /
                             (self.name.lower() + language_model_name_extension))
            if use_kenlm else None,
            reinitialize_trainable_loaded_layers=reinitialize_trainable_loaded_layers,
            **wav2letter_kwargs)

    english_baseline = ("20170314-134351-adam-small-learning-rate-complete-95", 1689)
    freeze0day4hour7 = ("20170420-001258-adam-small-learning-rate-transfer-to-German-freeze-0",
                        2066)

    def load_best_english_model(self, frozen_layer_count: int = 0, use_ken_lm: bool = False,
                                reinitialize_trainable_loaded_layers: bool = False,
                                **wav2letter_kwargs) -> Wav2Letter:
        return self.load_model(
            load_name=Configuration.english_baseline[0],
            load_epoch=Configuration.english_baseline[1],
            frozen_layer_count=frozen_layer_count, use_kenlm=use_ken_lm,
            reinitialize_trainable_loaded_layers=reinitialize_trainable_loaded_layers,
            **wav2letter_kwargs)

    def test_best_english_model(self, use_kenlm: bool = False) -> None:
        self.test_model_grouped_by_loaded_corpus_name(
            self.load_best_english_model(use_ken_lm=use_kenlm))

    def load_german_model(self, load_name: str, load_epoch: int, use_ken_lm: bool = False,
                          language_model_name_extension: str = "",
                          **wav2letter_kwargs) -> Wav2Letter:
        return self.load_model(
            load_name=load_name, load_epoch=load_epoch,
            allowed_characters_for_loaded_model=german_frequent_characters,
            use_kenlm=use_ken_lm,
            language_model_name_extension=language_model_name_extension,
            **wav2letter_kwargs)

    def test_german_model(self, load_name: str, load_epoch: int, use_ken_lm: bool = False,
                          language_model_name_extension: str = "",
                          **wav2letter_kwargs) -> None:
        self.test_model_grouped_by_loaded_corpus_name(self.load_german_model(
            load_name, load_epoch, use_ken_lm=use_ken_lm,
            language_model_name_extension=language_model_name_extension,
            **wav2letter_kwargs))

    def load_best_german_model(self, use_ken_lm: bool = False,
                               language_model_name_extension: str = "",
                               **wav2letter_kwargs) -> Wav2Letter:
        return self.load_german_model(
            Configuration.freeze0day4hour7[0], Configuration.freeze0day4hour7[1],
            use_ken_lm=use_ken_lm,
            language_model_name_extension=language_model_name_extension,
            **wav2letter_kwargs)


class LoggedRun:
    """Run an action with its log lines mirrored to ``test-results/<name>`` (the
    original speechless `configuration.py:217-234`)."""

    def __init__(self, action: Callable[[], None], name: str,
                 results_directory: Path = None):
        self.action = action
        self.name = name
        self.results_directory = (results_directory if results_directory is not None
                                  else default_data_directories.test_results_directory)
        self.result_file = self.results_directory / self.name

    def __call__(self) -> None:
        mkdir(self.results_directory)
        write_text(self.result_file, "")
        handler = logging.FileHandler(str(self.result_file))
        handler.setLevel(logging.INFO)
        logger.addHandler(handler)
        try:
            self.action()
        finally:
            logger.removeHandler(handler)
            handler.close()
