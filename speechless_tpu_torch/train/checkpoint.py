"""Read-only checkpoint loading (port of the reader half of
`speechless_tpu/train/checkpoint.py`).

Checkpoints are the JAX package's ``weights-epoch{n}.npz`` files with ``layer{i}.{key}``
entries; the parameters come back in the JAX layout (numpy), ready for
`models.wav2letter.params_from_jax`. Writing checkpoints, optimizer state and the Keras
``.h5`` fallback belong to the training slice.
"""
from pathlib import Path

import numpy as np

from ..models.wav2letter import Params


def model_file_name(epoch: int) -> str:
    return "weights-epoch{}.npz".format(epoch)


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
