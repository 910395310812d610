"""The training step (port of `speechless_tpu/train/trainer.py`).

* loss: the batch mean of per-utterance losses under one of three criteria:
  * ``"ctc"``: CTC NLL on the logits, with the JAX package's infeasible-label guard (a
    label needing more frames than the utterance has scores 0); the CTC runs on the
    CUDA kernels K1/K2 for CUDA tensors and on the plain recursions for CPU tensors
    (`ops/ctc_kernels.py`), so no CUDA tensor reaches the plain version;
  * ``"asg"``: the ASG loss (`ops/asg.py`) on the per-frame log-softmax, with fixed
    tables (the step builders' ``asg_transitions`` / ``asg_initials`` probability
    tables, by default the reference's random ones), converted to log scores once;
  * ``"asg_trainable"``: the same loss on the model's own tables (`w2l.AsgTables`, the
    JAX params' trailing pseudo-layer), which the optimizer trains beside the convs
    and layer freezing never freezes;
* optimizer: `torch.optim.Adam` with optax's defaults (b1 0.9, b2 0.999, eps 1e-8),
  optional global-norm clipping, frozen layers (no gradient, no moments, exactly zero
  updates), k-step gradient accumulation (`optax.MultiSteps`: the running mean of k
  micro-batch gradients, then one update) and warmup/cosine schedules keyed to the
  update count, in the order the JAX package chains them;
* steps: `make_train_step` (features in), `make_wav_train_step` (raw audio in, features
  on the device), `make_multi_step` and `make_multi_wav_step` (k updates per call with
  no host sync between them, over feature or raw-audio batches), `make_device_epoch_step`
  (a whole epoch over a device-resident corpus, `data/device_dataset.py`: each step's
  rows sampled and gathered on the device), plus `make_eval_step`;
* each update applies SpecAugment to its features when asked (`ops/specaugment.py`) and
  the model's dropout and remat (`models/wav2letter.py`); their draws come from the
  state's `torch.Generator`, on the state's device, where the JAX step splits a key.

Under a mesh (`init_train_state(mesh=...)`, `parallel/mesh.py`) each rank runs the same
step on its data rank's rows: the model holds its tensor-parallel shards, and after the
backward one bucketed all-reduce over the data group averages the gradients and the
loss (`OptimizerState.all_reduce`), so the update is JAX's gradient of the mean over the
global batch and the reported loss the global mean. Global-norm clipping sums the split
tensors' squares over the model group and counts the replicated ones once. The CTC
kernels run on each rank's rows, as JAX's ``ctc_pallas_sharded`` ran them per data
shard.

PyTorch runs eagerly, so a "step" is a Python function over a mutable `TrainState`: it
updates the model and optimizer in place and returns the same state, where the JAX step
returns a new one. Every step runs with TF32 off (`precision.ieee_fp32`): fp32 training
is IEEE fp32 in the forward and the backward, and bf16 training is bf16 either way.
"""
import math
from dataclasses import dataclass
from typing import Callable, Dict, List, NamedTuple, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from ..features.spectrogram import features_batch
from ..models import wav2letter as w2l
from ..ops.asg import asg_loss, log_tables_on
from ..ops.ctc_kernels import ctc_loss_from_logits
from ..ops.specaugment import SpecAugment, apply_spec_augment
from ..precision import ieee_fp32
from ..utils import trace

DEFAULT_DEVICE = "cuda:0"
CRITERIA = ("ctc", "asg", "asg_trainable")


class Batch(NamedTuple):
    """One statically shaped training batch (padded within a length bucket)."""
    inputs: torch.Tensor          # (B, T, F) float32 features
    input_lengths: torch.Tensor   # (B,) int32 valid frame counts
    labels: torch.Tensor          # (B, U) int32, -1 padded
    label_lengths: torch.Tensor   # (B,) int32


class WavBatch(NamedTuple):
    """A raw-audio batch for the features-on-device path; `make_multi_wav_step` takes
    the same fields with a leading steps axis."""
    wavs: torch.Tensor            # (B, samples) float32 zero-padded 16 kHz audio
    wav_lengths: torch.Tensor     # (B,) int32 true sample counts
    labels: torch.Tensor          # (B, U) int32, -1 padded
    label_lengths: torch.Tensor   # (B,) int32


# --------------------------------------------------------------------------------------
# Learning-rate schedules (optax's formulas, evaluated on the host per update)
# --------------------------------------------------------------------------------------

@dataclass(frozen=True)
class WarmupSchedule:
    """optax's ``join_schedules([linear 0 -> peak over warmup_steps, then cosine decay to
    end_value over decay_steps - warmup_steps | constant peak])``."""
    peak: float
    warmup_steps: int
    decay_steps: Optional[int] = None   # None: hold the peak after the warmup
    end_value: float = 0.0

    def __call__(self, count: int) -> float:
        if count < self.warmup_steps:  # optax's linear_schedule from 0 to the peak
            return (0.0 - self.peak) * (1.0 - count / self.warmup_steps) + self.peak
        if self.decay_steps is None:
            return self.peak
        steps = self.decay_steps - self.warmup_steps
        alpha = 0.0 if self.peak == 0.0 else self.end_value / self.peak
        done = min(count - self.warmup_steps, steps)
        cosine = 0.5 * (1.0 + math.cos(math.pi * done / steps))
        return self.peak * ((1.0 - alpha) * cosine + alpha)


LearningRate = Union[float, Callable[[int], float]]


def make_lr_schedule(base_learning_rate: float = 1e-4, warmup_steps: int = 0,
                     decay: Optional[str] = None, decay_steps: Optional[int] = None,
                     end_value_fraction: float = 0.01) -> LearningRate:
    """The plain float without warmup and decay, else a schedule of the update count:
    a linear warmup from 0 over ``warmup_steps``, then the peak held (``decay=None``) or
    a cosine decay to ``end_value_fraction * base`` at ``decay_steps`` total updates."""
    if not warmup_steps and decay is None:
        return base_learning_rate
    if decay == "cosine":
        if not decay_steps:
            raise ValueError("decay_steps (total steps incl. warmup) is required "
                             "for cosine decay")
        if decay_steps <= warmup_steps:
            raise ValueError("cosine decay needs decay_steps > warmup_steps")
        return WarmupSchedule(base_learning_rate, warmup_steps, decay_steps,
                              base_learning_rate * end_value_fraction)
    if decay is None:
        return WarmupSchedule(base_learning_rate, warmup_steps)
    raise ValueError("unknown decay {!r}; expected 'cosine' or None".format(decay))


# --------------------------------------------------------------------------------------
# Optimizer
# --------------------------------------------------------------------------------------

@dataclass(frozen=True)
class Optimizer:
    """Adam with optax's defaults and the JAX package's options (see `make_optimizer`).
    `init` binds it to a model's parameters."""
    learning_rate: LearningRate = 1e-4
    trainable: Optional[Tuple[bool, ...]] = None
    gradient_clip_norm: Optional[float] = None
    accumulate_steps: int = 1

    def init(self, model: w2l.Wav2Letter, data_group=None) -> "OptimizerState":
        return OptimizerState(self, model, data_group)


def make_optimizer(learning_rate: LearningRate = 1e-4,
                   trainable: Optional[Sequence[bool]] = None,
                   gradient_clip_norm: Optional[float] = None,
                   accumulate_steps: Optional[int] = None) -> Optimizer:
    """Adam with an optional per-layer freezing mask, global-norm clipping of the
    (accumulated) gradient over the trainable layers, and k-step accumulation: one
    update per ``accumulate_steps`` micro-batches from their mean gradient, so that k
    equal micro-batches step like one k-times-larger batch. ``learning_rate`` is a
    float or a `make_lr_schedule` schedule, which advances once per real update."""
    if accumulate_steps is not None and accumulate_steps < 1:
        raise ValueError("accumulate_steps must be >= 1, got {}".format(accumulate_steps))
    return Optimizer(learning_rate, None if trainable is None else tuple(trainable),
                     gradient_clip_norm, accumulate_steps or 1)


class OptimizerState:
    """The optimizer bound to one model: a `torch.optim.Adam` over the trainable
    layers' parameters, the update count, and the accumulation buffers.

    The layers are those of the JAX layout (`Wav2Letter.parameter_layers`): the convs,
    whose ``trainable`` flags the optimizer holds, then a trainable-ASG model's table
    pseudo-layer, which is always trainable (freezing applies to the convs only, as in
    the JAX facade). `step` consumes the ``.grad`` of the trainable parameters (frozen
    layers get ``requires_grad=False``, so the backward computes no gradient for them).
    `leaves` and `load_leaves` give the state as the leaves of the JAX package's optax
    state, in ``jax.tree_util.tree_leaves`` order, so either package resumes the
    other's run; a tensor-parallel model's leaves are gathered whole and loaded split.
    With a ``data_group``, `all_reduce` averages the gradients over it.
    """

    def __init__(self, spec: Optimizer, model: w2l.Wav2Letter, data_group=None):
        self.spec = spec
        self.model = model
        self.data_group = data_group
        self.layers = model.parameter_layers()
        self.trainable = list(spec.trainable or [True] * len(model.layers))
        if len(self.trainable) != len(model.layers):
            raise ValueError("trainable has {} flags for {} layers".format(
                len(self.trainable), len(model.layers)))
        if model.asg is not None:
            self.trainable.append(True)
        for layer, flag in zip(self.layers, self.trainable):
            for param, _ in layer:
                param.requires_grad_(flag)
        self.params = [param for layer, flag in zip(self.layers, self.trainable) if flag
                       for param, _ in layer]
        self.adam = torch.optim.Adam(self.params, lr=self._learning_rate(0),
                                     betas=(0.9, 0.999), eps=1e-8)
        self.updates = 0     # optax's Adam count: real updates so far
        self.mini_step = 0   # micro-batches accumulated toward the next update
        self.accumulated = ([torch.zeros_like(p) for p in self.params]
                            if spec.accumulate_steps > 1 else None)

    def _learning_rate(self, count: int) -> float:
        rate = self.spec.learning_rate
        return float(rate(count)) if callable(rate) else float(rate)

    def all_reduce(self, loss: torch.Tensor) -> torch.Tensor:
        """Average the trainable parameters' gradients and ``loss`` over the data group
        in one all-reduce of one flat buffer, and return the averaged loss; without a
        data group, ``loss`` as it is."""
        if self.data_group is None:
            return loss
        from ..parallel.mesh import DATA_AXIS, all_reduce

        for param in self.params:
            if param.grad is None:
                param.grad = torch.zeros_like(param)
        grads = [param.grad for param in self.params]
        flat = torch.cat([grad.reshape(-1) for grad in grads]
                         + [loss.reshape(1).to(grads[0].dtype)])
        all_reduce(flat, self.data_group, DATA_AXIS, "gradients and loss")
        flat /= torch.distributed.get_world_size(self.data_group)
        offset = 0
        for grad in grads:
            grad.copy_(flat[offset:offset + grad.numel()].view_as(grad))
            offset += grad.numel()
        return flat[-1].to(loss.dtype)

    def _global_norm(self, grads: Sequence[torch.Tensor]) -> torch.Tensor:
        """The global L2 norm of ``grads`` (one per trainable parameter). A split
        tensor's squares are summed over the model group, a replicated one's counted
        once."""
        split = self.model.split_axes()
        total = torch.zeros((), device=grads[0].device)
        for param, grad in zip(self.params, grads):
            if param not in split:
                total = total + torch.sum(grad * grad)
        if split:
            from ..parallel.mesh import MODEL_AXIS, all_reduce

            part = torch.zeros(1, device=grads[0].device)
            for param, grad in zip(self.params, grads):
                if param in split:
                    part = part + torch.sum(grad * grad)
            all_reduce(part, self.model.tensor_parallel.group, MODEL_AXIS, "gradient norm")
            total = total + part[0]
        return torch.sqrt(total)

    def step(self) -> None:
        """Accumulate the current gradients, and on every k-th call apply one update."""
        grads = [p.grad if p.grad is not None else torch.zeros_like(p) for p in self.params]
        if self.accumulated is not None:
            for acc, grad in zip(self.accumulated, grads):  # optax's running mean
                acc.add_((grad - acc) / (self.mini_step + 1))
            self.mini_step += 1
            if self.mini_step < self.spec.accumulate_steps:
                self._clear_grads()
                return
            self.mini_step = 0
            grads = self.accumulated
        clip = self.spec.gradient_clip_norm
        if clip is not None:  # optax.clip_by_global_norm, without a host sync
            norm = self._global_norm(grads)
            grads = [torch.where(norm < clip, g, g / norm * clip) for g in grads]
        for param, grad in zip(self.params, grads):
            param.grad = grad
        for group in self.adam.param_groups:
            group["lr"] = self._learning_rate(self.updates)
        self.adam.step()
        self.updates += 1
        if self.accumulated is not None:
            for acc in self.accumulated:
                acc.zero_()
        self._clear_grads()

    def _clear_grads(self) -> None:
        for param in self.params:
            param.grad = None

    # ---- the optax state as leaves ------------------------------------------------
    def _leaf_params(self, trainable_only: bool) -> List[Tuple[torch.Tensor, bool]]:
        """(parameter, is conv weight) in optax's leaf order: layer by layer, each
        layer's keys sorted (``b`` before ``w``)."""
        return [pair for layer, flag in zip(self.layers, self.trainable)
                if flag or not trainable_only for pair in layer]

    def _to_jax(self, param: torch.Tensor, value: torch.Tensor,
                is_weight: bool) -> np.ndarray:
        """``value`` (shaped like ``param``) in the JAX layout, whole."""
        array = self.model.full_tensor(param, value).detach().to("cpu", torch.float32)
        array = array.numpy()
        return np.ascontiguousarray(array.transpose(2, 1, 0)) if is_weight else array.copy()

    def _from_jax(self, array: np.ndarray, like: torch.Tensor) -> torch.Tensor:
        """A whole JAX-layout leaf as ``like``'s part of it, on ``like``'s device."""
        array = np.asarray(array, np.float32)
        if like.dim() == 3:
            array = array.transpose(2, 1, 0)
        value = self.model.local_part(like, torch.from_numpy(np.ascontiguousarray(array)))
        if tuple(value.shape) != tuple(like.shape):
            raise ValueError("optimizer leaf of shape {} for a parameter of shape {}".format(
                array.shape, tuple(like.shape)))
        return value.to(like.device)

    def _moments(self, key: str) -> List[np.ndarray]:
        leaves = []
        for param, is_weight in self._leaf_params(trainable_only=True):
            state = self.adam.state.get(param)
            value = state[key] if state else torch.zeros_like(param)
            leaves.append(self._to_jax(param, value, is_weight))
        return leaves

    def leaf_count(self) -> int:
        """``len(self.leaves())``, without gathering anything."""
        moments = len(self._leaf_params(trainable_only=True))
        count = 1 + 2 * moments + (1 if callable(self.spec.learning_rate) else 0)
        if self.accumulated is None:
            return count
        return 2 + count + len(self._leaf_params(trainable_only=False))

    def leaves(self) -> List[np.ndarray]:
        """The JAX package's optax state leaves for `make_optimizer` with the same
        options: ``[count, mu..., nu...(, schedule count)]`` over the trainable layers,
        inside ``[mini_step, gradient_step, ..., accumulated gradients]`` when
        accumulating (frozen layers' accumulators are zeros: no update reads them)."""
        count = np.asarray(self.updates, np.int32)
        inner = [count] + self._moments("exp_avg") + self._moments("exp_avg_sq")
        if callable(self.spec.learning_rate):
            inner.append(count)
        if self.accumulated is None:
            return inner
        accumulated = dict(zip(self.params, self.accumulated))
        acc = [self._to_jax(param, accumulated.get(param, torch.zeros_like(param)),
                            is_weight)
               for param, is_weight in self._leaf_params(trainable_only=False)]
        return [np.asarray(self.mini_step, np.int32), count] + inner + acc

    def load_leaves(self, leaves: Sequence[np.ndarray]) -> None:
        """Inverse of `leaves`. Raises if the count of leaves does not fit the options."""
        leaves = list(leaves)
        expected = self.leaf_count()
        if len(leaves) != expected:
            raise ValueError("checkpoint optimizer state has {} leaves; these optimizer "
                             "options expect {}".format(len(leaves), expected))
        if self.accumulated is not None:
            self.mini_step = int(leaves[0])
            every = self._leaf_params(trainable_only=False)
            acc_leaves = leaves[len(leaves) - len(every):]
            leaves = leaves[2:len(leaves) - len(every)]
            accumulated = dict(zip(self.params, self.accumulated))
            for (param, _), value in zip(every, acc_leaves):
                if param in accumulated:
                    accumulated[param].copy_(self._from_jax(value, param))
        self.updates = int(leaves[0])
        moments = len(self.params)
        mu, nu = leaves[1:1 + moments], leaves[1 + moments:1 + 2 * moments]
        ordered = [param for param, _ in self._leaf_params(trainable_only=True)]
        self.adam.state.clear()
        if self.updates > 0:
            for param, m, v in zip(ordered, mu, nu):
                self.adam.state[param] = {
                    "step": torch.tensor(float(self.updates), dtype=torch.float32),
                    "exp_avg": self._from_jax(m, param),
                    "exp_avg_sq": self._from_jax(v, param)}


# --------------------------------------------------------------------------------------
# State and steps
# --------------------------------------------------------------------------------------

@dataclass
class TrainState:
    """The model (fp32 parameters on the device), its optimizer state, the step, and the
    generator on the model's device that SpecAugment and dropout draw from."""
    step: int
    model: w2l.Wav2Letter
    opt_state: OptimizerState
    generator: torch.Generator

    @property
    def params(self) -> w2l.Params:
        """The parameters in the JAX package's layout (numpy), whole (a collective
        over the model group when the model is tensor-parallel)."""
        return w2l.params_to_jax(self.model)


def init_train_state(config: w2l.Wav2LetterConfig, optimizer: Optimizer, seed: int = 0,
                     params: Optional[w2l.Params] = None,
                     device=DEFAULT_DEVICE, mesh=None) -> TrainState:
    """A fresh state on ``device``: ``params`` (JAX layout) or `w2l.init_params(seed)`,
    and a generator on ``device`` seeded with ``seed``. Under a ``mesh`` (a
    `parallel.mesh.make_mesh` `DeviceMesh`), ``params`` are the full host parameters,
    the same on every rank: the model keeps this rank's tensor-parallel shards, and the
    optimizer averages gradients over the data group. Every rank draws the same
    SpecAugment and dropout masks (the model ranks of one data rank must)."""
    if params is None:
        params = w2l.init_params(config, seed)
    split, data_group = None, None
    if mesh is not None:
        from ..parallel import mesh as pmesh

        split = pmesh.model_split(mesh)
        if split is not None:
            params = pmesh.shard_params(params, pmesh.param_specs(config.layer_names),
                                        split.rank, split.size)
        data_group = pmesh.axis_group(mesh, pmesh.DATA_AXIS)
    model = w2l.build_model(config, params, device=device, tensor_parallel=split).train()
    generator = torch.Generator(device=torch.device(device)).manual_seed(seed)
    return TrainState(step=0, model=model, opt_state=optimizer.init(model, data_group),
                      generator=generator)


def _batch_to(batch, device) -> tuple:
    return type(batch)(*(torch.as_tensor(field).to(device) for field in batch))


def _check_criterion(criterion: str) -> None:
    if criterion not in CRITERIA:
        raise ValueError("Unknown criterion: {}".format(criterion))


def _fixed_asg_tables(config: w2l.Wav2LetterConfig, criterion: str, asg_transitions,
                      asg_initials, device="cpu"):
    """The ``"asg"`` criterion's (transition, initial) log-score tensors on ``device``,
    converted from the probability tables once, when the step is built; None for the
    other criteria."""
    _check_criterion(criterion)
    if criterion != "asg":
        return None
    return log_tables_on(device, config.grapheme_set_size, asg_transitions, asg_initials)


def _tables_to(tables, device):
    return None if tables is None else tuple(t.to(device) for t in tables)


def _per_example_loss(config: w2l.Wav2LetterConfig, model: w2l.Wav2Letter, criterion: str,
                      logits: torch.Tensor, logit_lengths: torch.Tensor, batch: Batch,
                      asg_tables) -> torch.Tensor:
    """The criterion's per-example losses: CTC on the logits, or ASG on the per-frame
    log-softmax (which shifts every path of both graphs by the same amount, so the loss
    is unchanged, but keeps the logits' scale from drifting) with the fixed tables or
    the model's own."""
    if criterion == "ctc":
        return ctc_loss_from_logits(logits, logit_lengths, batch.labels, batch.label_lengths,
                                    config.grapheme_set_size - 1)
    if criterion == "asg_trainable":
        if model.asg is None:
            raise ValueError("criterion 'asg_trainable' needs a model with ASG tables "
                             "(params ending in the asg_transitions/asg_initials layer)")
        asg_tables = (model.asg.transitions, model.asg.initials)
    transitions, initials = asg_tables if asg_tables is not None else (None, None)
    return asg_loss(torch.log_softmax(logits, dim=-1), logit_lengths, batch.labels,
                    batch.label_lengths, transition_log_scores=transitions,
                    initial_log_scores=initials)


def loss_fn(config: w2l.Wav2LetterConfig, model: w2l.Wav2Letter, batch: Batch,
            criterion: str = "ctc", train: bool = True,
            generator: Optional[torch.Generator] = None,
            dropout_masks: Optional[Sequence[Optional[torch.Tensor]]] = None,
            asg_tables: Optional[Tuple[torch.Tensor, torch.Tensor]] = None
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Mean loss over the batch, and the per-example losses. Under CTC, examples whose
    label needs more frames than they have (length plus adjacent repeats > frames) admit
    no alignment and score 0, as in the JAX package; ASG's own guard zeroes empty and
    too-long labels. ``asg_tables`` are the ``"asg"`` criterion's log-score tables on the
    batch's device (default: the reference's random tables). ``train`` runs the model's
    dropout (masks given, or drawn from ``generator``) and remat."""
    _check_criterion(criterion)
    logits = model(batch.inputs, train=train, dropout_masks=dropout_masks,
                   generator=generator)
    logit_lengths = w2l.prediction_lengths(config, batch.input_lengths).to(torch.int32)
    per_example = _per_example_loss(config, model, criterion, logits, logit_lengths, batch,
                                    asg_tables)
    if criterion == "ctc":
        labels = batch.labels
        repeats = ((labels[:, 1:] == labels[:, :-1]) & (labels[:, 1:] >= 0)).sum(dim=1)
        feasible = batch.label_lengths + repeats <= logit_lengths
        per_example = torch.where(feasible, per_example, 0.0)
    return per_example.mean(), per_example


def _update(config, criterion, state: TrainState, batch: Batch,
            spec_augment: Optional[SpecAugment] = None, asg_tables=None):
    with ieee_fp32():
        if spec_augment is not None:
            batch = batch._replace(inputs=apply_spec_augment(
                batch.inputs, batch.input_lengths, spec_augment, generator=state.generator))
        loss, per_example = loss_fn(config, state.model, batch, criterion,
                                    generator=state.generator, asg_tables=asg_tables)
        loss.backward()
        loss = state.opt_state.all_reduce(loss.detach())
        state.opt_state.step()
    state.step += 1
    return loss.detach(), per_example.detach()


def _wav_features(batch: WavBatch) -> Batch:
    features, frame_counts = features_batch(batch.wavs, batch.wav_lengths)
    return Batch(features, frame_counts, batch.labels, batch.label_lengths)


def make_train_step(config: w2l.Wav2LetterConfig, optimizer: Optimizer,
                    criterion: str = "ctc", device=DEFAULT_DEVICE,
                    spec_augment: Optional[SpecAugment] = None,
                    asg_transitions=None, asg_initials=None):
    """``(state, Batch) -> (state, {"loss", "per_example_loss"})``: one update on
    ``device`` (the batch is moved there; the state must be there already), with
    SpecAugment on the features when ``spec_augment`` is given. ``asg_transitions`` /
    ``asg_initials`` are the ``"asg"`` criterion's probability tables (reference
    layout; default the reference's random ones)."""
    del optimizer  # bound into the state by `init_train_state`
    tables = _fixed_asg_tables(config, criterion, asg_transitions, asg_initials, device)

    def train_step(state: TrainState, batch: Batch) -> Tuple[TrainState, Dict]:
        loss, per_example = _update(config, criterion, state, _batch_to(batch, device),
                                    spec_augment, tables)
        return state, {"loss": loss, "per_example_loss": per_example}

    return train_step


def make_wav_train_step(config: w2l.Wav2LetterConfig, optimizer: Optimizer,
                        criterion: str = "ctc", device=DEFAULT_DEVICE,
                        spec_augment: Optional[SpecAugment] = None,
                        asg_transitions=None, asg_initials=None):
    """``(state, WavBatch) -> (state, metrics)``: features on the device, then one
    update, as `make_train_step`."""
    del optimizer
    tables = _fixed_asg_tables(config, criterion, asg_transitions, asg_initials, device)

    def train_step(state: TrainState, batch: WavBatch) -> Tuple[TrainState, Dict]:
        features = _wav_features(_batch_to(batch, device))
        loss, per_example = _update(config, criterion, state, features, spec_augment,
                                    tables)
        return state, {"loss": loss, "per_example_loss": per_example}

    return train_step


def make_multi_wav_step(config: w2l.Wav2LetterConfig, optimizer: Optimizer,
                        criterion: str = "ctc", device=DEFAULT_DEVICE,
                        spec_augment: Optional[SpecAugment] = None,
                        asg_transitions=None, asg_initials=None):
    """``(state, stacked WavBatch) -> (state, {"loss": mean, "step_losses": (k,)})``:
    k fused updates (features, forward, loss, backward, Adam), one per row of the
    leading steps axis, with no host sync between them; the losses stay on the
    device."""
    del optimizer
    tables = _fixed_asg_tables(config, criterion, asg_transitions, asg_initials, device)

    def multi_step(state: TrainState, stacked: WavBatch) -> Tuple[TrainState, Dict]:
        stacked = _batch_to(stacked, device)
        losses = []
        for index in range(stacked.wavs.shape[0]):
            micro = WavBatch(*(field[index] for field in stacked))
            losses.append(_update(config, criterion, state, _wav_features(micro),
                                  spec_augment, tables)[0])
        losses = torch.stack(losses)
        return state, {"loss": losses.mean(), "step_losses": losses}

    return multi_step


def make_multi_step(config: w2l.Wav2LetterConfig, optimizer: Optimizer,
                    criterion: str = "ctc", device=DEFAULT_DEVICE,
                    spec_augment: Optional[SpecAugment] = None,
                    asg_transitions=None, asg_initials=None):
    """``(state, stacked Batch) -> (state, {"loss": mean, "step_losses": (k,)})``: k
    updates over feature batches stacked on a leading steps axis
    (`data.batching.stack_batches`), one per row, with no host sync between them; the
    losses stay on the device. The facade's ``multi_step=k``."""
    del optimizer
    tables = _fixed_asg_tables(config, criterion, asg_transitions, asg_initials, device)

    def multi_step(state: TrainState, stacked: Batch) -> Tuple[TrainState, Dict]:
        stacked = _batch_to(stacked, device)
        losses = torch.stack([
            _update(config, criterion, state, Batch(*(field[index] for field in stacked)),
                    spec_augment, tables)[0]
            for index in range(stacked.inputs.shape[0])])
        return state, {"loss": losses.mean(), "step_losses": losses}

    return multi_step


def sample_indices(example_count: int, batch_size: int, steps: int,
                   generator: torch.Generator) -> torch.Tensor:
    """``(steps, batch_size)`` int64 corpus rows, each step's drawn uniformly without
    replacement within the batch (the reference's `random.sample`), on the generator's
    device."""
    return torch.stack([torch.randperm(example_count, generator=generator,
                                       device=generator.device)[:batch_size]
                        for _ in range(steps)])


def make_device_epoch_step(config: w2l.Wav2LetterConfig, optimizer: Optimizer,
                           batch_size: int, steps: int, criterion: str = "ctc",
                           spec_augment: Optional[SpecAugment] = None,
                           asg_transitions=None, asg_initials=None, mesh=None):
    """``(state, dataset, generator=None, indices=None) -> (state, {"loss": mean,
    "step_losses": (steps,)})``: ``steps`` updates over a device-resident corpus
    (`data.device_dataset.DeviceDataset`, on the state's device). Each step's
    ``batch_size`` rows come from ``indices`` (``(steps, batch_size)``, e.g. JAX's
    `jax.random.choice` draws) or are drawn on the device from ``generator``
    (`sample_indices`), and are gathered with `index_select`: no feature or label byte
    crosses from the host. The losses stay on the device. Under a ``mesh`` the indices
    (the same on every rank) pick the global batch, from a replicated or a split corpus
    (`data.device_dataset.ShardedDeviceDataset`), and each rank trains on its data
    rank's slice of it."""
    del optimizer
    if batch_size < 1 or steps < 1:
        raise ValueError("batch_size ({}) and steps ({}) must be >= 1".format(batch_size,
                                                                               steps))
    local_rows = slice(None)
    if mesh is not None:
        from ..parallel.mesh import batch_rows

        local_rows = batch_rows(mesh, batch_size)
    tables = _fixed_asg_tables(config, criterion, asg_transitions, asg_initials)

    def epoch_step(state: TrainState, dataset, generator: Optional[torch.Generator] = None,
                   indices=None) -> Tuple[TrainState, Dict]:
        count = dataset.example_count
        if batch_size > count:
            raise ValueError("batch_size {} exceeds corpus size {}".format(batch_size, count))
        device = dataset.inputs.device
        if indices is None:
            if generator is None:
                raise ValueError("epoch_step needs a generator or the indices")
            indices = sample_indices(count, batch_size, steps, generator)
        else:
            indices = torch.as_tensor(indices).to(device=device, dtype=torch.int64)
            if tuple(indices.shape) != (steps, batch_size):
                raise ValueError("indices of shape {}, expected {}".format(
                    tuple(indices.shape), (steps, batch_size)))
        step_tables = _tables_to(tables, device)
        losses = torch.stack([
            _update(config, criterion, state, _gathered(dataset, rows, local_rows),
                    spec_augment, step_tables)[0]
            for rows in indices])
        return state, {"loss": losses.mean(), "step_losses": losses}

    return epoch_step


def _gathered(dataset, rows: torch.Tensor, local_rows: slice) -> Batch:
    """This rank's rows of one step's batch from a resident corpus. While a profiler
    records (`utils/trace.py`) it counts the frames the step computes, ``train.frames``
    (rows x the corpus's padded frames), and the rows' own, ``train.frames_own``."""
    batch = Batch(*(field[local_rows] for field in dataset.gather(rows)))
    if trace.recording():
        trace.count("train.frames", batch.inputs.shape[0] * batch.inputs.shape[1])
        trace.count("train.frames_own", batch.input_lengths.sum())
    return batch


def make_eval_step(config: w2l.Wav2LetterConfig, criterion: str = "ctc",
                   asg_transitions=None, asg_initials=None):
    """``(model, Batch) -> (log_probs, logit_lengths, per_example_loss)`` with no
    gradient, on the device the model and batch lie on. Unlike training, the CTC losses
    carry no feasibility guard, as in the JAX package."""
    tables = _fixed_asg_tables(config, criterion, asg_transitions, asg_initials)

    def eval_step(model: w2l.Wav2Letter, batch: Batch):
        with torch.no_grad(), ieee_fp32():
            logits = model(batch.inputs)
            logit_lengths = w2l.prediction_lengths(config, batch.input_lengths).to(
                torch.int32)
            per_example = _per_example_loss(config, model, criterion, logits, logit_lengths,
                                            batch, _tables_to(tables, logits.device))
            return torch.log_softmax(logits, dim=-1), logit_lengths, per_example

    return eval_step
