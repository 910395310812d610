"""Experiment runner (port of `speechless_tpu/experiments.py`): named-run registry, batch
evaluation dispatch, epoch-sweep validation.

Re-provides the original speechless `main.py` machinery as an importable module:

* device memory capping (`main.py:14-24`'s GPU memory fraction, as
  `torch.cuda.set_per_process_memory_fraction`);
* a registry of named trained runs with pinned epochs (`main.py:28-85`);
* indexed `LoggedRun` dispatch for batch evaluation jobs (`main.py:147-180`);
* `validate_to_csv`: evaluate a run's checkpoint sweep and write
  (epoch, loss, letter/word error counts and rates) rows (`main.py:183-221`).
"""
import csv
import re
from pathlib import Path
from typing import Callable, List, Optional, Sequence, Tuple

from .configuration import Configuration, LoggedRun
from .utils.tools import log


def limit_device_memory_fraction(fraction: float, device="cuda:0") -> None:
    """Cap the share of the card's memory that PyTorch's allocator may hold (the
    reference's TF `per_process_gpu_memory_fraction`). Without CUDA it logs and does
    nothing."""
    import torch

    if not torch.cuda.is_available():
        log("limit_device_memory_fraction: no CUDA device; nothing to cap.")
        return
    torch.cuda.set_per_process_memory_fraction(fraction, torch.device(device))


class TrainedRun:
    """A named training run with an evaluation epoch pinned."""

    def __init__(self, name: str, epoch: int, use_kenlm: bool = False,
                 language_model_name_extension: str = ""):
        self.name = name
        self.epoch = epoch
        self.use_kenlm = use_kenlm
        self.language_model_name_extension = language_model_name_extension


class ExperimentRegistry:
    """Named evaluation jobs, dispatchable by index (for array jobs / shell loops).
    ``wav2letter_kwargs`` (e.g. ``device``) reach every loaded model."""

    def __init__(self, configuration_factory: Callable[[], Configuration],
                 **wav2letter_kwargs):
        self.configuration_factory = configuration_factory
        self.wav2letter_kwargs = wav2letter_kwargs
        self._runs: List[Tuple[str, Callable[[], None]]] = []

    def add_evaluation(self, run: TrainedRun) -> None:
        def action():
            configuration = self.configuration_factory()
            wav2letter = configuration.load_model(
                load_name=run.name, load_epoch=run.epoch, use_kenlm=run.use_kenlm,
                language_model_name_extension=run.language_model_name_extension,
                **self.wav2letter_kwargs)
            configuration.test_model_grouped_by_loaded_corpus_name(wav2letter)

        label = "{}{}-{}".format("kenlm-" if run.use_kenlm else "", run.name, run.epoch)
        self._runs.append((label, action))

    def names(self) -> List[str]:
        return [name for name, _ in self._runs]

    def run(self, index: int) -> None:
        name, action = self._runs[index]
        log("Dispatching evaluation {} ({} of {}).".format(name, index + 1, len(self._runs)))
        results_directory = self.configuration_factory().directories.test_results_directory
        LoggedRun(action, name + ".txt", results_directory)()

    def run_all(self) -> None:
        for index in range(len(self._runs)):
            self.run(index)


def available_epochs(net_directory: Path) -> List[int]:
    """Checkpoint epochs present in a run directory, ascending. Reference-format Keras
    ``.h5`` files count too (they load through the `train/keras_import.py` fallback), so
    epoch sweeps work directly on a migrated user's existing run directories."""
    pattern = re.compile(r"weights-epoch(\d+)\.(npz|h5)$")
    epochs = set()
    for file in Path(net_directory).glob("weights-epoch*"):
        match = pattern.match(file.name)
        if match:
            epochs.add(int(match.group(1)))
    return sorted(epochs)


def validate_to_csv(configuration: Configuration, run_name: str, csv_file: Path,
                    epochs: Optional[Sequence[int]] = None,
                    use_ken_lm: bool = False, **wav2letter_kwargs) -> None:
    """Evaluate a sweep of checkpoints of one run on the test set and append CSV rows of
    (epoch, average loss, letter error count/rate, word error count/rate).
    ``wav2letter_kwargs`` (e.g. ``device``) reach each loaded model."""
    net_directory = configuration.directories.nets_base_directory / run_name
    if epochs is None:
        epochs = available_epochs(net_directory)
    csv_file = Path(csv_file)
    write_header = not csv_file.exists()
    with csv_file.open("a", newline="") as f:
        writer = csv.writer(f)
        if write_header:
            writer.writerow(["epoch", "average_loss", "average_letter_error_count",
                             "average_letter_error_rate", "average_word_error_count",
                             "average_word_error_rate"])
        for epoch in epochs:
            wav2letter = configuration.load_model(
                load_name=run_name, load_epoch=epoch,
                allowed_characters_for_loaded_model=None, use_kenlm=use_ken_lm,
                **wav2letter_kwargs)
            result = wav2letter.test_and_predict_batches(
                configuration.batch_generator.test_batches())
            log("Epoch {}: {}".format(epoch, result.summary_line()))
            writer.writerow([epoch, result.average_loss, result.average_letter_error_count,
                             result.average_letter_error_rate, result.average_word_error_count,
                             result.average_word_error_rate])
            f.flush()
