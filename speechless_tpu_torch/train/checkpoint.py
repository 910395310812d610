"""Checkpoints (port of `speechless_tpu/train/checkpoint.py`).

Checkpoints are the JAX package's ``weights-epoch{n}.npz`` files: ``layer{i}.{key}``
parameters in the JAX layout, the optimizer state as ``opt.{i}`` (the leaves of the
optax state in ``tree_leaves`` order) and the global ``step``. The port writes and reads
the same files, and its optimizer state converts to and from those leaves
(`trainer.OptimizerState.leaves`), so either package resumes the other's run when both
use the same optimizer options. The reference's Keras ``.h5`` fallback, checkpoint
averaging and the character-remap transfer load are not ported yet (ROADMAP.md, item 7).
"""
import os
from pathlib import Path
from typing import Optional

import numpy as np

from ..models.wav2letter import Params


def model_file_name(epoch: int) -> str:
    return "weights-epoch{}.npz".format(epoch)


def save_checkpoint(directory: Path, epoch: int, params: Params, opt_state=None,
                    step: Optional[int] = None) -> Path:
    """Write ``params`` (JAX layout, e.g. `TrainState.params`), the optimizer state's
    optax leaves and the step to ``directory/weights-epoch{epoch}.npz``, atomically
    (a temporary file, then a rename)."""
    directory = Path(directory)
    directory.mkdir(parents=True, exist_ok=True)
    arrays = {"layer{}.{}".format(i, key): np.asarray(value)
              for i, layer in enumerate(params) for key, value in layer.items()}
    if opt_state is not None:
        for i, leaf in enumerate(opt_state.leaves()):
            arrays["opt.{}".format(i)] = leaf
    if step is not None:
        arrays["step"] = np.asarray(int(step))
    path = directory / model_file_name(epoch)
    temp_path = path.with_name(path.name + ".tmp")
    with temp_path.open("wb") as f:  # a file object: np.savez appends no suffix
        np.savez(f, **arrays)
    os.replace(str(temp_path), str(path))
    return path


def load_step(directory: Path, epoch: int) -> Optional[int]:
    """The global step saved beside the weights (None if absent)."""
    with np.load(str(Path(directory) / model_file_name(epoch))) as data:
        return int(data["step"]) if "step" in data.files else None


def load_opt_state(directory: Path, epoch: int, opt_state):
    """Load the saved optimizer leaves into ``opt_state`` (a `trainer.OptimizerState`
    built with the options of the run that wrote them) and return it; None when the
    checkpoint holds no optimizer state. Raises when the leaves do not fit the options
    (another optimizer's state is never loaded quietly)."""
    with np.load(str(Path(directory) / model_file_name(epoch))) as data:
        keys = sorted((k for k in data.files if k.startswith("opt.")),
                      key=lambda k: int(k.split(".")[1]))
        leaves = [np.asarray(data[k]) for k in keys]
    if not leaves:
        return None
    opt_state.load_leaves(leaves)
    return opt_state


def load_params_npz(path: Path) -> Params:
    """Load ``[{"w", "b"}, ...]`` from an ``.npz`` file at an arbitrary path."""
    with np.load(str(path)) as data:
        layer_keys: dict = {}
        for name in data.files:
            if not name.startswith("layer"):
                continue
            index_part, key = name.split(".", 1)
            layer_keys.setdefault(int(index_part[len("layer"):]), []).append(key)
        params = [{key: np.asarray(data["layer{}.{}".format(i, key)])
                   for key in sorted(layer_keys[i])} for i in sorted(layer_keys)]
    for i, layer in enumerate(params):
        if "w_q" in layer or "w_scale" in layer:
            raise NotImplementedError(
                "{} layer {} holds int8-quantized weights; quantized serving is not "
                "ported yet (ROADMAP.md, Transcriber routes)".format(path, i))
    return params


def load_params(directory: Path, epoch: int) -> Params:
    """Load ``directory/weights-epoch{epoch}.npz``."""
    return load_params_npz(Path(directory) / model_file_name(epoch))
