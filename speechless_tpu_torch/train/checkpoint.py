"""Checkpoints (port of `speechless_tpu/train/checkpoint.py`).

Checkpoints are the JAX package's ``weights-epoch{n}.npz`` files: ``layer{i}.{key}``
parameters in the JAX layout, the optimizer state as ``opt.{i}`` (the leaves of the
optax state in ``tree_leaves`` order) and the global ``step``. The port writes and reads
the same files, and its optimizer state converts to and from those leaves
(`trainer.OptimizerState.leaves`), so either package resumes the other's run when both
use the same optimizer options. A trainable-ASG run's parameters end in the criterion
pseudo-layer (``layer{n}.asg_transitions``, ``layer{n}.asg_initials``), stored and
averaged like any other layer. `average_checkpoint_params` averages epochs of one run
(the CLI's ``average``) and `load_params_with_character_remap` is the transfer load
(the CLI's ``transfer``).

The reference's own checkpoints are Keras files, ``weights-epoch{n}.h5``: where an
epoch has no ``.npz`` but has that file, `load_params` reads its weights
(`train/keras_import.py`, which needs h5py), and `load_step` and `load_opt_state` find
no step and no optimizer state, which the reference never saved.
"""
import os
from pathlib import Path
from typing import Dict, List, Optional

import numpy as np
import torch

from ..utils.tools import log

# The JAX layout of a model's parameters (`models/wav2letter.py::Params`). The models
# are imported where a function needs them: loading weights (the export bundle loader)
# imports no model code.
Params = List[Dict[str, np.ndarray]]


def model_file_name(epoch: int) -> str:
    return "weights-epoch{}.npz".format(epoch)


def keras_model_file_name(epoch: int) -> str:
    """The reference's own checkpoint name."""
    return "weights-epoch{}.h5".format(epoch)


def _keras_fallback_path(directory: Path, epoch: int) -> Optional[Path]:
    """The epoch's reference ``.h5`` file when it has no ``.npz`` checkpoint, else None."""
    if (Path(directory) / model_file_name(epoch)).exists():
        return None
    h5_path = Path(directory) / keras_model_file_name(epoch)
    return h5_path if h5_path.exists() else None


def _flatten_params(params: Params) -> dict:
    """The ``layer{i}.{key}`` naming of every ``.npz`` writer."""
    return {"layer{}.{}".format(i, key): np.asarray(value)
            for i, layer in enumerate(params) for key, value in layer.items()}


def _write_npz_atomically(path: Path, arrays: dict) -> None:
    temp_path = path.with_name(path.name + ".tmp")
    with temp_path.open("wb") as f:  # a file object: np.savez appends no suffix
        np.savez(f, **arrays)
    os.replace(str(temp_path), str(path))


def save_checkpoint(directory: Path, epoch: int, params: Params, opt_leaves=None,
                    step: Optional[int] = None) -> Path:
    """Write ``params`` (JAX layout, e.g. `TrainState.params`), the optimizer state's
    optax leaves (``opt_state.leaves()``: under a mesh every rank gathers them before one
    rank writes) and the step to
    ``directory/weights-epoch{epoch}.npz``, atomically (a temporary file, then a
    rename)."""
    directory = Path(directory)
    directory.mkdir(parents=True, exist_ok=True)
    arrays = _flatten_params(params)
    if opt_leaves is not None:
        for i, leaf in enumerate(opt_leaves):
            arrays["opt.{}".format(i)] = leaf
    if step is not None:
        arrays["step"] = np.asarray(int(step))
    path = directory / model_file_name(epoch)
    _write_npz_atomically(path, arrays)
    return path


def save_params_npz(path: Path, params: Params) -> Path:
    """Write a weights-only ``.npz`` at any path (the target of the CLI's ``convert``)."""
    _write_npz_atomically(Path(path), _flatten_params(params))
    return Path(path)


def load_step(directory: Path, epoch: int) -> Optional[int]:
    """The global step saved beside the weights (None if absent, and for a reference
    ``.h5`` checkpoint)."""
    if _keras_fallback_path(directory, epoch) is not None:
        return None
    with np.load(str(Path(directory) / model_file_name(epoch))) as data:
        return int(data["step"]) if "step" in data.files else None


def load_opt_state(directory: Path, epoch: int, opt_state, strict: bool = True):
    """Load the saved optimizer leaves into ``opt_state`` (a `trainer.OptimizerState`
    built with the options of the run that wrote them) and return it; None when the
    checkpoint holds no optimizer state. When the count of leaves does not fit the
    options (another optimizer's state, or another set of frozen layers) it raises, or
    with ``strict=False`` logs and returns None, as the JAX package's load does (the
    facade loads a transfer run's checkpoint to evaluate it with all layers
    trainable). A reference ``.h5`` checkpoint holds no optimizer state: None."""
    if _keras_fallback_path(directory, epoch) is not None:
        return None
    with np.load(str(Path(directory) / model_file_name(epoch))) as data:
        keys = sorted((k for k in data.files if k.startswith("opt.")),
                      key=lambda k: int(k.split(".")[1]))
        leaves = [np.asarray(data[k]) for k in keys]
    if not leaves:
        return None
    expected = opt_state.leaf_count()
    if not strict and len(leaves) != expected:
        log("Checkpoint optimizer state has {} leaves, expected {}; ignoring it.".format(
            len(leaves), expected))
        return None
    opt_state.load_leaves(leaves)
    return opt_state


def load_params_npz(path: Path) -> Params:
    """Load ``[{"w", "b"}, ...]`` from an ``.npz`` file at an arbitrary path. Each layer
    keeps the keys it was saved with: an int8 checkpoint's layers hold ``w_q`` and
    ``w_scale`` (`models/quantize.py`), which the serving model takes as they are."""
    with np.load(str(path)) as data:
        layer_keys: dict = {}
        for name in data.files:
            if not name.startswith("layer"):
                continue
            index_part, key = name.split(".", 1)
            layer_keys.setdefault(int(index_part[len("layer"):]), []).append(key)
        params = [{key: np.asarray(data["layer{}.{}".format(i, key)])
                   for key in sorted(layer_keys[i])} for i in sorted(layer_keys)]
    return params


def load_params(directory: Path, epoch: int,
                config: Optional["w2l.Wav2LetterConfig"] = None) -> Params:
    """Load ``directory/weights-epoch{epoch}.npz``, or the reference's
    ``weights-epoch{epoch}.h5`` when only that exists. ``config`` checks an ``.h5``
    file's layers and shapes against the model, so that a charset or geometry mismatch
    fails here rather than decoding through a wrong blank index."""
    keras_path = _keras_fallback_path(directory, epoch)
    if keras_path is not None:
        from .keras_import import load_keras_params
        log("Loading reference-format Keras checkpoint {}".format(keras_path))
        return load_keras_params(keras_path, config=config)
    return load_params_npz(Path(directory) / model_file_name(epoch))


def average_checkpoint_params(directory: Path, epochs: List[int],
                              config: Optional["w2l.Wav2LetterConfig"] = None) -> Params:
    """The uniform average of the parameters of several epoch checkpoints of one run,
    accumulated in float64 and returned as float32 (weights only: optimizer state means
    nothing for an averaged model). All checkpoints must share one structure: the same
    layers, keys and shapes (a trained-ASG pseudo-layer's tables average like any other
    leaf). ``config`` checks reference ``.h5`` epochs as `load_params` does."""
    if not epochs:
        raise ValueError("need at least one epoch to average")
    accumulated: Optional[List[dict]] = None
    for epoch in epochs:
        params = load_params(directory, epoch, config=config)
        if accumulated is None:
            accumulated = [{key: np.asarray(value, np.float64) for key, value in layer.items()}
                           for layer in params]
            continue
        if len(params) != len(accumulated) or any(
                sorted(layer) != sorted(acc) for layer, acc in zip(params, accumulated)):
            raise ValueError(
                "checkpoint structure of epoch {} does not match epoch {} — checkpoints "
                "of different runs (or with/without trained ASG tables) cannot be "
                "averaged".format(epoch, epochs[0]))
        for acc, layer in zip(accumulated, params):
            for key, value in layer.items():
                if value.shape != acc[key].shape:
                    raise ValueError(
                        "epoch {} parameter {!r} has shape {} vs epoch {}'s {}".format(
                            epoch, key, value.shape, epochs[0], acc[key].shape))
                acc[key] += value
    scale = 1.0 / len(epochs)
    return [{key: (value * scale).astype(np.float32) for key, value in layer.items()}
            for layer in accumulated]


def load_params_with_character_remap(
        directory: Path, epoch: int, source_characters: List[str],
        target_characters: List[str], target_config: "w2l.Wav2LetterConfig",
        loaded_first_layers_count: Optional[int] = None,
        init_generator: Optional[torch.Generator] = None) -> Params:
    """The transfer load: the donor checkpoint's first ``loaded_first_layers_count``
    layers (default: all), its output layer remapped to ``target_characters``
    (`w2l.remap_output_layer`), and fresh layers beyond the count, drawn from
    ``init_generator`` (a CPU generator; default seeded with 0) by
    `w2l.init_params_from_generator`. The JAX package draws its fresh layers from a JAX
    key, which torch does not reproduce."""
    from ..models import wav2letter as w2l

    donor = load_params(directory, epoch)
    layer_count = len(target_config.layers)
    if loaded_first_layers_count is None:
        loaded_first_layers_count = layer_count
    if init_generator is None:
        init_generator = torch.Generator().manual_seed(0)
    fresh = w2l.init_params_from_generator(target_config, init_generator)

    ignored = sorted(set(source_characters) - set(target_characters))
    if ignored:
        log("Ignoring characters {} from loaded model.".format(ignored))
    extra = sorted(set(target_characters) - set(source_characters))
    if extra:
        log("Initializing extra characters {} not found in model.".format(extra))
    log("Loading first {} layers of {}, epoch {}, reinitializing the last {}.".format(
        loaded_first_layers_count, directory, epoch, layer_count - loaded_first_layers_count))

    params: Params = []
    for i in range(layer_count):
        if i >= loaded_first_layers_count:
            params.append(fresh[i])
        elif i == layer_count - 1:
            params.append(w2l.remap_output_layer(donor[i], source_characters,
                                                 target_characters))
        else:
            params.append(dict(donor[i]))
    return params
