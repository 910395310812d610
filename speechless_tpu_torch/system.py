"""The `Wav2Letter` system facade (port of `speechless_tpu/system.py`): the reference's
public model API on the port's stack.

* one train step (`train/trainer.py`, the CTC on the kernels for CUDA tensors), one
  eval step (loss and log-probs in one pass), greedy decoding on the device and the
  host's native LM beam (`ops/decode.py::beam_search_decode`);
* an explicit epoch loop with preview predictions, a background `Prefetcher` that
  pads batches and copies them to the device, per-epoch ``weights-epoch{n}.npz``
  checkpoints with the optimizer state and step (the JAX package's format, so either
  package resumes the other's run), ``scalars.csv``, TensorBoard scalars and
  `GracefulShutdown` (SIGTERM/SIGINT checkpoint at the epoch's end);
* the device-resident corpus (``train(device_resident_examples=...)``): the whole
  corpus packed into device memory once (`data/device_dataset.py`) and each epoch's
  batches sampled and gathered there (`trainer.make_device_epoch_step`), with the same
  log lines, ``scalars.csv`` columns, previews, checkpoints and `GracefulShutdown`;
* the cross-charset transfer load (``allowed_characters_for_loaded_model``): the output
  layer's filters remapped to this model's characters, the first ``frozen_layer_count``
  layers frozen (no gradient is computed for them), and with
  ``reinitialize_trainable_loaded_layers`` the layers above them drawn afresh;
* SpecAugment, dropout and remat in training;
* the model variants of the JAX facade: the raw-wave family (``use_raw_wave_input``:
  ``(samples, 1)`` z-normalized waveforms, sample-count buckets), the activations
  (relu, elu, linear, softmax), and the ASG criterion (``use_asg``: `AsgGraphemeCodec`,
  the reference's random tables, decoded by per-frame argmax), with trainable tables
  (``train_asg_transitions``: a pseudo-layer of the parameters that Adam updates and the
  checkpoints carry, decoded by the Viterbi over them);
* the reference's Keras ``.h5`` checkpoints, loaded when no ``.npz`` is there
  (`train/checkpoint.py`);
* the KenLM vocabulary-consistency check of the reference.

* a ``(data, model)`` mesh (``mesh=``, `parallel/mesh.py`; built over the world when a
  run of several processes gives none): each rank keeps its tensor-parallel shards of
  the wide tail and trains on its own batches (the `ShardedBatchGenerator`'s slices),
  the gradients averaged over the data group (`train/trainer.py`); a resident corpus
  is split over the data ranks; eval batches run whole on every rank; checkpoints are
  gathered whole, written by rank 0 as a single-process run writes them, and restore
  on any topology, the optimizer state re-split.

Compute is bf16 on CUDA (features copied as fp16, parameters, logits and the loss in
fp32) and fp32 on the CPU, as the JAX facade picks by backend. Runs on ``cuda:0``
unless the caller passes ``device``.
"""
import csv
import math
import time
from collections import OrderedDict
from pathlib import Path
from typing import Dict, Iterable, List, Optional

import numpy as np
import torch
import torch.distributed

from .data.batching import (Prefetcher, batch_from_spectrograms, chunked, pad_to_bucket,
                            stack_batches)
from .features.example import LabeledSpectrogram
from .models import wav2letter as w2l
from .ops.decode import beam_search_decode, greedy_decode
from .ops.specaugment import SpecAugment
from .text.graphemes import AsgGraphemeCodec, CtcGraphemeCodec
from .text.metrics import (ExpectationsVsPredictions, ExpectationsVsPredictionsInBatches,
                           ExpectationsVsPredictionsInGroupedBatches, ExpectationVsPrediction)
from .train import checkpoint as ckpt
from .train.trainer import (DEFAULT_DEVICE, Batch, init_train_state, make_eval_step,
                            make_lr_schedule, make_multi_step, make_optimizer,
                            make_train_step)
from .utils.tools import log, mkdir, read_text, single

DEFAULT_BEAM_WIDTH = 100
KENLM_WEIGHT = 0.8
WORD_COUNT_WEIGHT = 0.0
VALID_WORD_COUNT_WEIGHT = 2.3
# Production pruning of the host beam: classes below 1e-5 a frame cannot move a trained
# model's beam (the JAX facade's floor, `speechless_tpu/system.py:401`).
PRUNE_LOG_PROB_FLOOR = math.log(1e-5)


class Wav2Letter:
    """Speech-recognition system based on wav2letter (arXiv:1609.03193)."""

    def __init__(self,
                 input_size_per_time_step: int,
                 allowed_characters: List[str],
                 use_raw_wave_input: bool = False,
                 activation: str = "relu",
                 output_activation: str = "softmax",
                 learning_rate: float = 1e-4,
                 lr_warmup_steps: int = 0,
                 lr_decay: Optional[str] = None,
                 lr_decay_steps: Optional[int] = None,
                 gradient_clip_norm: Optional[float] = None,
                 accumulate_gradient_steps: Optional[int] = None,
                 dropout: Optional[float] = None,
                 load_model_from_directory: Optional[Path] = None,
                 load_epoch: Optional[int] = None,
                 allowed_characters_for_loaded_model: Optional[List[str]] = None,
                 frozen_layer_count: int = 0,
                 reinitialize_trainable_loaded_layers: bool = False,
                 use_asg: bool = False,
                 asg_transition_probabilities: Optional[np.ndarray] = None,
                 asg_initial_probabilities: Optional[np.ndarray] = None,
                 train_asg_transitions: bool = False,
                 kenlm_directory: Optional[Path] = None,
                 beam_width: int = DEFAULT_BEAM_WIDTH,
                 lm_weight: float = KENLM_WEIGHT,
                 word_count_weight: float = WORD_COUNT_WEIGHT,
                 valid_word_count_weight: float = VALID_WORD_COUNT_WEIGHT,
                 compute_dtype: Optional[torch.dtype] = None,
                 remat: bool = False,
                 mesh=None,
                 spec_augment=None,
                 seed: int = 0,
                 device=DEFAULT_DEVICE):
        if frozen_layer_count > 0 and load_model_from_directory is None:
            raise ValueError("Layers cannot be frozen if model is trained from scratch.")
        if use_asg and kenlm_directory is not None:
            raise ValueError("LM-fused beam decoding is CTC-only; ASG decodes greedily "
                             "(kenlm_directory would be silently ignored).")
        if train_asg_transitions and not use_asg:
            raise ValueError("train_asg_transitions requires use_asg=True.")
        if use_raw_wave_input and input_size_per_time_step != 1:
            raise ValueError("Raw-wave input feeds (samples, 1) waveforms; "
                             "input_size_per_time_step must be 1, got {}."
                             .format(input_size_per_time_step))
        if use_raw_wave_input and spec_augment:
            # SpecAugment masks mel bins; on a (samples, 1) waveform any frequency mask
            # would zero the entire signal.
            raise ValueError("spec_augment is a mel-feature augmentation and does not "
                             "apply to the raw-wave model family.")
        # True selects the default policy; training only, eval never sees masked features.
        self.spec_augment = SpecAugment() if spec_augment is True else spec_augment or None

        self.device = torch.device(device)
        self.use_asg = use_asg
        self.train_asg_transitions = use_asg and train_asg_transitions
        self.grapheme_encoding = (AsgGraphemeCodec(allowed_characters) if use_asg
                                  else CtcGraphemeCodec(allowed_characters))
        if use_asg:
            from .ops.asg import (default_asg_initial_probabilities,
                                  default_asg_transition_probabilities)
            if asg_transition_probabilities is None:
                asg_transition_probabilities = default_asg_transition_probabilities(
                    self.grapheme_encoding.grapheme_set_size)
            if asg_initial_probabilities is None:
                asg_initial_probabilities = default_asg_initial_probabilities(
                    self.grapheme_encoding.grapheme_set_size)
        self.asg_transition_probabilities = asg_transition_probabilities
        self.asg_initial_probabilities = asg_initial_probabilities
        self.kenlm_directory = Path(kenlm_directory) if kenlm_directory else None
        self.beam_width = beam_width
        self.lm_weight = lm_weight
        self.word_count_weight = word_count_weight
        self.valid_word_count_weight = valid_word_count_weight
        self.frozen_layer_count = frozen_layer_count
        self.load_epoch = load_epoch
        self.input_size_per_time_step = input_size_per_time_step
        self.output_activation = output_activation
        if compute_dtype is None:
            compute_dtype = torch.float32 if self.device.type == "cpu" else torch.bfloat16
        self.config = w2l.Wav2LetterConfig(
            input_size_per_time_step, self.grapheme_encoding.grapheme_set_size,
            compute_dtype=compute_dtype, dropout=dropout, remat=remat,
            use_raw_wave_input=use_raw_wave_input, activation=activation)

        if self.kenlm_directory is not None:
            expected_characters = list(single(
                read_text(self.kenlm_directory / "vocabulary",
                          encoding="utf8").splitlines()).lower())
            if list(allowed_characters) != expected_characters:
                raise ValueError(
                    "Allowed characters {} differ from those expected by kenlm decoder: {}"
                    .format(allowed_characters, expected_characters))
            from .lm.ngram import load_language_model
            self.language_model = load_language_model(self.kenlm_directory)
        else:
            self.language_model = None

        # With trainable ASG tables the optimizer trains them too: freezing applies to
        # the acoustic model's layers only.
        self.optimizer = make_optimizer(
            make_lr_schedule(learning_rate, warmup_steps=lr_warmup_steps,
                             decay=lr_decay, decay_steps=lr_decay_steps),
            trainable=w2l.trainable_mask(self.config, frozen_layer_count),
            gradient_clip_norm=gradient_clip_norm,
            accumulate_steps=accumulate_gradient_steps)

        if load_model_from_directory is None:
            params = w2l.init_params(self.config, seed)
        else:
            if load_epoch is None:
                raise ValueError(
                    "load_epoch is required when load_model_from_directory is set "
                    "(pick one of experiments.available_epochs)")
            load_model_from_directory = Path(load_model_from_directory)
            if allowed_characters_for_loaded_model is None:
                params = ckpt.load_params(load_model_from_directory, load_epoch,
                                          config=self.config)
            else:
                params = ckpt.load_params_with_character_remap(
                    load_model_from_directory, load_epoch,
                    source_characters=allowed_characters_for_loaded_model,
                    target_characters=allowed_characters, target_config=self.config,
                    loaded_first_layers_count=(frozen_layer_count
                                               if reinitialize_trainable_loaded_layers
                                               else None),
                    init_generator=torch.Generator().manual_seed(seed))
        if self.train_asg_transitions:
            if not w2l.is_asg_layer(params[-1]):
                from .ops.asg import log_score_tables
                trans, init = log_score_tables(asg_transition_probabilities,
                                               asg_initial_probabilities)
                params = list(params) + [{"asg_transitions": trans, "asg_initials": init}]
        elif w2l.is_asg_layer(params[-1]):
            # A fixed-table or CTC run loading a trainable-ASG checkpoint: drop the
            # criterion pseudo-layer, as the JAX facade does.
            params = list(params)[:-1]
        if mesh is None:
            # Several processes run one program: a data-parallel mesh over the world,
            # as the JAX facade defaults to a global mesh under multi-host training.
            from .parallel.mesh import world_mesh
            mesh = world_mesh(self.device.type)
        self.mesh = mesh
        self.state = init_train_state(self.config, self.optimizer, seed=seed, params=params,
                                      device=self.device, mesh=mesh)
        if load_model_from_directory is not None \
                and allowed_characters_for_loaded_model is None:
            # Resume: the optimizer state and the step continue where the run stopped
            # (a transfer load starts them fresh, as in the JAX package).
            ckpt.load_opt_state(load_model_from_directory, load_epoch, self.state.opt_state,
                                strict=False)
            saved_step = ckpt.load_step(load_model_from_directory, load_epoch)
            if saved_step is not None:
                self.state.step = saved_step
        if use_asg:
            self._criterion = "asg_trainable" if self.train_asg_transitions else "asg"
        else:
            self._criterion = "ctc"
        self._asg_tables = dict(asg_transitions=asg_transition_probabilities,
                                asg_initials=asg_initial_probabilities)
        self._train_step = None
        self._eval_step = make_eval_step(self.config, self._criterion, **self._asg_tables)

    # -- core model surface ----------------------------------------------

    @property
    def params(self) -> w2l.Params:
        """The parameters in the JAX package's layout (numpy)."""
        return self.state.params

    @property
    def input_to_prediction_length_ratio(self) -> int:
        return self.config.input_to_prediction_length_ratio

    def _log_probs(self, inputs: torch.Tensor) -> torch.Tensor:
        with torch.no_grad():
            return torch.log_softmax(self.state.model(inputs), dim=-1)

    def prediction_batch(self, input_batch: np.ndarray) -> np.ndarray:
        """Softmax grapheme probabilities for a padded spectrogram batch."""
        inputs = torch.as_tensor(np.asarray(input_batch, np.float32)).to(self.device)
        return np.exp(self._log_probs(inputs).cpu().numpy())

    def _device_batch(self, batch: Batch) -> Batch:
        """A host batch (numpy) on the device. When the model computes in bf16 the
        features travel as fp16 (numpy has no bf16), half the bytes; the model casts them
        to bf16 as the JAX model casts them. On CUDA the copies come from pinned memory
        without blocking the host; they run on the current stream, ahead of any step the
        caller queues after them."""
        inputs = batch.inputs
        if self.config.compute_dtype == torch.bfloat16 and inputs.dtype == np.float32:
            inputs = inputs.astype(np.float16)
        pinned = self.device.type == "cuda"

        def to_device(array: np.ndarray) -> torch.Tensor:
            tensor = torch.from_numpy(np.ascontiguousarray(array))
            if pinned:
                return tensor.pin_memory().to(self.device, non_blocking=True)
            return tensor.to(self.device)

        return Batch(to_device(inputs), to_device(batch.input_lengths),
                     to_device(batch.labels), to_device(batch.label_lengths))

    def _prepare_batch(self, labeled_spectrogram_batch: List[LabeledSpectrogram]):
        batch, labels = batch_from_spectrograms(labeled_spectrogram_batch,
                                                self.grapheme_encoding,
                                                raw_wave=self.config.use_raw_wave_input)
        return self._device_batch(batch), labels

    # -- decoding / evaluation -------------------------------------------

    def _greedy_decode_tokens(self, log_probs: torch.Tensor,
                              prediction_lengths: torch.Tensor) -> List[str]:
        blank = self.grapheme_encoding.grapheme_set_size - 1
        tokens, counts = (t.cpu().numpy() for t in greedy_decode(log_probs,
                                                                 prediction_lengths, blank))
        tokens = np.where(tokens < 0, blank, tokens)
        return self.grapheme_encoding.decode_grapheme_batch(tokens, list(counts),
                                                            merge_repeated=False)

    def _decode_tokens(self, log_probs: torch.Tensor,
                       prediction_lengths: torch.Tensor) -> List[str]:
        """Greedy on the device, or with a KenLM directory the host's native LM beam.
        ASG has no blank: with trained tables the Viterbi path over them
        (`ops/asg.py::asg_viterbi_decode`; the per-frame log-softmax shifts every path
        alike, so it ranks them as the logits would), otherwise the per-frame argmax;
        then the codec merges repeats and expands the repetition graphemes."""
        if self.use_asg:
            if self.train_asg_transitions:
                from .ops.asg import asg_viterbi_decode
                tables = self.state.model.asg
                tokens = asg_viterbi_decode(log_probs, prediction_lengths,
                                            tables.transitions.detach(),
                                            tables.initials.detach())
            else:
                tokens = torch.argmax(log_probs, dim=2)
            return self.grapheme_encoding.decode_grapheme_batch(
                tokens.cpu().numpy(), list(prediction_lengths.cpu().numpy()),
                merge_repeated=True)
        if self.kenlm_directory is None:
            return self._greedy_decode_tokens(log_probs, prediction_lengths)
        blank = self.grapheme_encoding.grapheme_set_size - 1
        tokens, counts = beam_search_decode(
            log_probs.float().cpu().numpy(), list(prediction_lengths.cpu().numpy()),
            blank=blank, beam_width=self.beam_width,
            alphabet=self.grapheme_encoding.allowed_characters, lm=self.language_model,
            lm_weight=self.lm_weight, word_count_weight=self.word_count_weight,
            valid_word_count_weight=self.valid_word_count_weight,
            prune_log_prob_floor=PRUNE_LOG_PROB_FLOOR)
        tokens = np.where(tokens < 0, blank, tokens)
        return self.grapheme_encoding.decode_grapheme_batch(tokens, list(counts),
                                                            merge_repeated=False)

    def test_and_predict_batch(self, labeled_spectrogram_batch: List[LabeledSpectrogram]
                               ) -> ExpectationsVsPredictions:
        batch, expected_labels = self._prepare_batch(labeled_spectrogram_batch)
        log_probs, lengths, losses = self._eval_step(self.state.model, batch)
        predictions = self._decode_tokens(log_probs, lengths)
        return ExpectationsVsPredictions(
            [ExpectationVsPrediction(predicted=predicted, expected=expected, loss=float(loss))
             for predicted, expected, loss in zip(predictions, expected_labels,
                                                  losses.cpu().numpy())])

    def predict_batch_greedily(self, spectrograms: List[np.ndarray]) -> List[str]:
        batch = self._device_batch(pad_to_bucket(spectrograms, [""] * len(spectrograms),
                                                 self.grapheme_encoding))
        lengths = w2l.prediction_lengths(self.config, batch.input_lengths)
        return self._greedy_decode_tokens(self._log_probs(batch.inputs), lengths)

    def test_and_predict(self, labeled_spectrogram: LabeledSpectrogram
                         ) -> ExpectationVsPrediction:
        return self.test_and_predict_batch([labeled_spectrogram]).results[0]

    def predict(self, labeled_spectrogram: LabeledSpectrogram) -> str:
        return self.test_and_predict(labeled_spectrogram).predicted

    def test_and_predict_batch_with_log(self, index: int, batch: List[LabeledSpectrogram]
                                        ) -> ExpectationsVsPredictions:
        result = self.test_and_predict_batch(batch)
        log(str(result) + " (batch {})".format(index))
        return result

    def test_and_predict_batches(self, labeled_spectrogram_batches:
                                 Iterable[List[LabeledSpectrogram]]
                                 ) -> ExpectationsVsPredictionsInBatches:
        return ExpectationsVsPredictionsInBatches(
            [self.test_and_predict_batch_with_log(i, batch)
             for i, batch in enumerate(labeled_spectrogram_batches)])

    def test_and_predict_batches_with_log(self, corpus_name: str,
                                          batches: Iterable[List[LabeledSpectrogram]]
                                          ) -> ExpectationsVsPredictionsInBatches:
        result = self.test_and_predict_batches(batches)
        log("{}: {}".format(corpus_name, result))
        return result

    def test_and_predict_grouped_batches(self, grouped_batches: Dict[str, Iterable[
            List[LabeledSpectrogram]]]) -> ExpectationsVsPredictionsInGroupedBatches:
        return ExpectationsVsPredictionsInGroupedBatches(OrderedDict(
            (name, self.test_and_predict_batches_with_log(corpus_name=name, batches=batches))
            for name, batches in grouped_batches.items()))

    # -- training ---------------------------------------------------------

    @staticmethod
    def model_file_name(epoch: int) -> str:
        return ckpt.model_file_name(epoch)

    def train(self,
              labeled_spectrogram_batches: Iterable[List[LabeledSpectrogram]],
              preview_labeled_spectrogram_batch: List[LabeledSpectrogram],
              tensor_board_log_directory: Path,
              net_directory: Path,
              batches_per_epoch: int,
              epoch_limit: Optional[int] = None,
              save_step: int = 1,
              callback_step: int = 1,
              multi_step: int = 1,
              device_resident_examples: Optional[List[LabeledSpectrogram]] = None,
              batch_size: int = 64) -> None:
        """Train until interrupted (or ``epoch_limit``). Per epoch: preview predictions
        (every ``callback_step``), a checkpoint (every ``save_step``), a ``scalars.csv``
        row and TensorBoard scalars. The epoch's losses stay on the device and are read
        once at its end. ``multi_step=k`` runs k updates per step call over k stacked
        batches (`trainer.make_multi_step`); it must divide ``batches_per_epoch``.

        ``device_resident_examples``: the whole corpus is packed into device memory once
        (`data.device_dataset`) and each epoch samples its ``batches_per_epoch`` batches
        of ``batch_size`` there (`trainer.make_device_epoch_step`);
        ``labeled_spectrogram_batches`` and ``multi_step`` are then unused."""
        if device_resident_examples is not None:
            self._train_device_resident(
                device_resident_examples, preview_labeled_spectrogram_batch,
                tensor_board_log_directory, net_directory, batches_per_epoch,
                epoch_limit=epoch_limit, save_step=save_step, callback_step=callback_step,
                batch_size=batch_size)
            return
        if multi_step < 1 or batches_per_epoch % multi_step != 0:
            raise ValueError("multi_step ({}) must be >= 1 and divide batches_per_epoch "
                             "({})".format(multi_step, batches_per_epoch))
        if self._train_step is None or self._train_step[0] != multi_step:
            make = make_train_step if multi_step == 1 else make_multi_step
            self._train_step = (multi_step,
                                make(self.config, self.optimizer, criterion=self._criterion,
                                     device=self.device, spec_augment=self.spec_augment,
                                     **self._asg_tables))
        train_step = self._train_step[1]
        self._print_preview_batch(preview_labeled_spectrogram_batch)
        tensorboard, scalar_log, new_log = self._open_logs(tensor_board_log_directory)
        if multi_step == 1:
            batches = Prefetcher(iter(labeled_spectrogram_batches),
                                 prepare=self._prepare_batch, depth=2)
        else:
            def prepare_stacked(batch_group):
                prepared = [batch_from_spectrograms(group, self.grapheme_encoding,
                                                    raw_wave=self.config.use_raw_wave_input)
                            for group in batch_group]
                stacked = stack_batches([host_batch for host_batch, _ in prepared])
                return (self._device_batch(stacked),
                        [label for _, labels in prepared for label in labels])

            batches = Prefetcher(chunked(iter(labeled_spectrogram_batches), multi_step),
                                 prepare=prepare_stacked, depth=2)

        def run_epoch(_epoch):
            losses = []
            utterances = 0
            for _ in range(batches_per_epoch // multi_step):
                batch, _labels = next(batches)
                self.state, metrics = train_step(self.state, batch)
                losses.append(metrics["loss"])
                # multi-step batches carry a leading steps axis: (k, B, T, F).
                utterances += (batch.inputs.shape[0] * batch.inputs.shape[1]
                               if batch.inputs.dim() == 4 else batch.inputs.shape[0])
            # One device-to-host read per epoch.
            return float(torch.stack(losses).mean()), utterances

        with batches:
            self._epoch_loop(run_epoch, "", tensorboard, scalar_log, new_log,
                             preview_labeled_spectrogram_batch, net_directory,
                             batches_per_epoch, epoch_limit, save_step, callback_step)

    def _print_preview_batch(self, preview_labeled_spectrogram_batch) -> None:
        log(self.test_and_predict_batch(preview_labeled_spectrogram_batch))

    @staticmethod
    def _open_logs(tensor_board_log_directory: Path):
        mkdir(tensor_board_log_directory)
        from .utils.tensorboard import SummaryWriter
        scalar_log = Path(tensor_board_log_directory) / "scalars.csv"
        return SummaryWriter(tensor_board_log_directory), scalar_log, not scalar_log.exists()

    def _epoch_loop(self, run_epoch, mode: str, tensorboard, scalar_log: Path, new_log: bool,
                    preview_labeled_spectrogram_batch, net_directory: Path,
                    batches_per_epoch: int, epoch_limit: Optional[int], save_step: int,
                    callback_step: int) -> None:
        """The epochs of either training path: ``run_epoch(epoch) -> (mean loss,
        utterances)`` trains one; then the log line (``mode`` appended), the
        ``scalars.csv`` row, TensorBoard, the preview, the checkpoint and the
        preemption check."""
        from .train.preemption import GracefulShutdown

        epoch = self.load_epoch if self.load_epoch is not None else 0
        with tensorboard, GracefulShutdown() as shutdown, \
                scalar_log.open("a", newline="") as scalar_file:
            writer = csv.writer(scalar_file)
            if new_log:
                writer.writerow(["epoch", "step", "loss", "utterances_per_second",
                                 "seconds_per_batch"])
            while epoch_limit is None or epoch < epoch_limit:
                epoch_start = time.time()
                mean_loss, utterances = run_epoch(epoch)
                elapsed = time.time() - epoch_start
                epoch += 1
                log("Epoch {}: loss {:.2f}, {:.1f} utterances/s{}".format(
                    epoch, mean_loss, utterances / elapsed, mode))
                writer.writerow([epoch, int(self.state.step), mean_loss,
                                 utterances / elapsed, elapsed / batches_per_epoch])
                scalar_file.flush()
                tensorboard.add_scalar("loss", mean_loss, epoch)
                tensorboard.add_scalar("utterances_per_second", utterances / elapsed, epoch)
                tensorboard.flush()
                if epoch % callback_step == 0:
                    self._print_preview_batch(preview_labeled_spectrogram_batch)
                if epoch % save_step == 0 and epoch > 0:
                    self.save(net_directory, epoch)
                if shutdown.requested:
                    if epoch % save_step != 0:
                        self.save(net_directory, epoch)
                    log("Preemption ({}): checkpointed epoch {}; exiting the training "
                        "loop.".format(shutdown.signal_name, epoch))
                    break

    def _train_device_resident(self, examples: List[LabeledSpectrogram],
                               preview_labeled_spectrogram_batch: List[LabeledSpectrogram],
                               tensor_board_log_directory: Path, net_directory: Path,
                               batches_per_epoch: int, epoch_limit: Optional[int] = None,
                               save_step: int = 1, callback_step: int = 1,
                               batch_size: int = 64) -> None:
        """The epoch loop over a device-resident corpus: one `make_device_epoch_step`
        call an epoch, its batches sampled on the device by a generator seeded from 42
        and the epoch (the JAX facade folds the epoch into key 42)."""
        from .data.device_dataset import build_device_dataset
        from .train.trainer import make_device_epoch_step

        if batch_size > len(examples):
            raise ValueError("batch_size {} exceeds corpus size {}".format(
                batch_size, len(examples)))
        load_start = time.time()
        dataset, megabytes = build_device_dataset(
            examples, self.grapheme_encoding, self.device,
            compute_dtype=self.config.compute_dtype,
            raw_wave=self.config.use_raw_wave_input, mesh=self.mesh)
        log("Device-resident corpus: {} examples, {:.0f} MB in HBM (packed + transferred "
            "in {:.1f}s).".format(len(examples), megabytes, time.time() - load_start))
        epoch_fn = make_device_epoch_step(self.config, self.optimizer, batch_size=batch_size,
                                          steps=batches_per_epoch, criterion=self._criterion,
                                          spec_augment=self.spec_augment, mesh=self.mesh,
                                          **self._asg_tables)

        def run_epoch(epoch):
            seed = int(np.random.SeedSequence([42, epoch]).generate_state(1)[0])
            generator = torch.Generator(device=self.device).manual_seed(seed)
            self.state, metrics = epoch_fn(self.state, dataset, generator)
            return float(metrics["loss"]), batches_per_epoch * batch_size

        self._print_preview_batch(preview_labeled_spectrogram_batch)
        tensorboard, scalar_log, new_log = self._open_logs(tensor_board_log_directory)
        self._epoch_loop(run_epoch, " (device-resident)", tensorboard, scalar_log, new_log,
                         preview_labeled_spectrogram_batch, net_directory,
                         batches_per_epoch, epoch_limit, save_step, callback_step)

    def save(self, net_directory: Path, epoch: int) -> Path:
        """Checkpoint weights, optimizer state and step as ``weights-epoch{epoch}.npz``.
        Under a mesh every rank gathers the split tensors (a collective) and rank 0
        writes the file a single-process run writes."""
        params = self.state.params
        leaves = self.state.opt_state.leaves()
        if self.mesh is not None and torch.distributed.get_rank() != 0:
            return Path(net_directory) / ckpt.model_file_name(epoch)
        return ckpt.save_checkpoint(net_directory, epoch, params, leaves,
                                    step=self.state.step)

