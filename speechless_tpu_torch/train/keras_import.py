"""The reference's Keras HDF5 weight files, read and written (port of
`speechless_tpu/train/keras_import.py`).

The reference saves its acoustic model as ``nets/<run>/weights-epoch{n}.h5`` with Keras
``save_weights``, so a user who comes from it arrives with such files.
`train/checkpoint.py::load_params` falls back to the ``.h5`` file when an epoch has no
``.npz``, which takes every load path (resume, evaluation, the transfer remap) through
`load_keras_params`; `save_keras_params` writes a model trained here back in Keras's
layout. The CLI's ``convert`` does either explicitly.

What Keras writes, and what is read:
* ``save_weights`` puts one HDF5 group per layer at the file's root and the layer order
  in a root attribute ``layer_names``; full-model ``model.save`` files nest the same
  under a ``model_weights`` group. Both are read;
* each layer group lists its weights in a ``weight_names`` attribute: Keras 2 names them
  ``<layer>/kernel:0`` and ``<layer>/bias:0`` (nested datasets), Keras 1 ``<layer>_W``
  and ``<layer>_b``. Both are read;
* weightless layers (the reference's ``dropout_before_*`` Dropout layers) have an empty
  ``weight_names`` and are skipped;
* a Keras Conv1D kernel is ``(kernel_size, in_channels, filters)`` with a ``(filters,)``
  bias: the JAX parameter layout, so nothing is transposed.

The parameters are numpy arrays. Only this module needs h5py, which the functions
import when they run: the rest of the port (and a machine without h5py) never loads it.
"""
from pathlib import Path
from typing import List, Optional, Union

import numpy as np

from ..models import wav2letter as w2l
from ..utils.tools import log

_KERAS_SUFFIXES = (".h5", ".hdf5")


def is_keras_weight_file(path: Union[str, Path]) -> bool:
    return Path(path).suffix.lower() in _KERAS_SUFFIXES


def _decode(name) -> str:
    return name.decode("utf-8") if isinstance(name, bytes) else str(name)


def _weight_root(h5_file):
    """``save_weights`` files hold the layers at the root; ``model.save`` files nest them
    under ``model_weights``."""
    if "model_weights" in h5_file:
        return h5_file["model_weights"]
    return h5_file


def _layer_names_in_order(root, path: Path,
                          config: Optional[w2l.Wav2LetterConfig]) -> List[str]:
    if "layer_names" in root.attrs:
        return [_decode(n) for n in root.attrs["layer_names"]]
    # Without the attribute h5py lists groups alphabetically, which misorders even the
    # reference geometry ("big_conv_1" sorts before "striding_conv"): only a config
    # knows the order.
    if config is not None:
        present = set(root.keys())
        return [name for name in config.layer_names if name in present]
    raise ValueError(
        "Keras file {} lacks the root 'layer_names' attribute that records model "
        "order (group order is alphabetical and would misorder the layers); load it "
        "with a model config, or re-save it via Keras save_weights".format(path))


def _pick_weight(group, weight_names: List[str], kind: str) -> Optional[np.ndarray]:
    """The kernel or bias dataset of one layer, under Keras 2's or Keras 1's name."""
    keras2 = "kernel:0" if kind == "kernel" else "bias:0"
    keras1 = "_W" if kind == "kernel" else "_b"
    for name in weight_names:
        leaf = name.rsplit("/", 1)[-1]
        if leaf == keras2 or name.endswith(keras1):
            return np.asarray(group[name])
    return None


def load_keras_params(path: Union[str, Path],
                      config: Optional[w2l.Wav2LetterConfig] = None) -> w2l.Params:
    """A Keras HDF5 weight file as the JAX-layout parameter list ``[{"w", "b"}, ...]``
    (fp32 numpy), in the file's ``layer_names`` order with weightless layers skipped.
    With ``config`` the layer names and shapes must match the model's, so that a
    charset or architecture mismatch fails here."""
    import h5py

    path = Path(path)
    params: w2l.Params = []
    loaded_names: List[str] = []
    with h5py.File(str(path), "r") as f:
        root = _weight_root(f)
        for layer_name in _layer_names_in_order(root, path, config):
            if layer_name not in root:
                raise ValueError("Keras file {} names layer {!r} but has no group for it"
                                 .format(path, layer_name))
            group = root[layer_name]
            weight_names = [_decode(n) for n in group.attrs.get("weight_names", [])]
            if not weight_names:
                continue  # Dropout or another weightless layer
            kernel = _pick_weight(group, weight_names, "kernel")
            bias = _pick_weight(group, weight_names, "bias")
            if kernel is None or bias is None:
                raise ValueError(
                    "Layer {!r} in {} has weights {} — expected a Conv1D kernel+bias pair"
                    .format(layer_name, path, weight_names))
            if kernel.ndim != 3 or bias.ndim != 1 or kernel.shape[2] != bias.shape[0]:
                raise ValueError(
                    "Layer {!r} in {}: kernel {} / bias {} is not a Conv1D weight pair"
                    .format(layer_name, path, kernel.shape, bias.shape))
            params.append({"w": np.asarray(kernel, np.float32),
                           "b": np.asarray(bias, np.float32)})
            loaded_names.append(layer_name)

    if not params:
        raise ValueError("No weight-bearing layers found in Keras file {}".format(path))
    if config is not None:
        _validate_against_config(path, config, loaded_names, params)
    return params


def _validate_against_config(path: Path, config: w2l.Wav2LetterConfig,
                             names: List[str], params: w2l.Params) -> None:
    expected = config.layer_names
    if names != expected:
        raise ValueError(
            "Keras file {} layers {} do not match the model's {} — wrong architecture "
            "variant (raw-wave vs mel?) or a foreign checkpoint".format(
                path, names, expected))
    in_channels = config.input_size_per_time_step
    for spec, layer in zip(config.layers, params):
        want = (spec.kernel_size, in_channels, spec.filters)
        got = tuple(layer["w"].shape)
        if got != want:
            raise ValueError(
                "Keras file {} layer {!r}: kernel shape {} does not match the model's {} "
                "(charset size or filter-count mismatch)".format(path, spec.name, got, want))
        in_channels = spec.filters


def save_keras_params(path: Union[str, Path], config: w2l.Wav2LetterConfig,
                      params: w2l.Params) -> Path:
    """Write the JAX-layout parameter list as a Keras 2 ``save_weights`` file with the
    reference's layer names, which a Keras loader of the reference's model reads. Only
    float layers can be written: int8 layers (`models/quantize.py`) have no Keras form."""
    import h5py

    path = Path(path)
    if len(params) != len(config.layers):
        raise ValueError("Got {} parameter layers for a {}-layer model"
                         .format(len(params), len(config.layers)))
    for spec, layer in zip(config.layers, params):
        if "w" not in layer:
            raise ValueError(
                "Layer {!r} has keys {} — quantized parameters cannot be exported to "
                "Keras; export the float checkpoint instead".format(
                    spec.name, sorted(layer)))

    with h5py.File(str(path), "w") as f:
        f.attrs["layer_names"] = np.array(
            [spec.name.encode("utf-8") for spec in config.layers])
        f.attrs["backend"] = "speechless-tpu".encode("utf-8")
        for spec, layer in zip(config.layers, params):
            group = f.create_group(spec.name)
            weight_names = ["{}/kernel:0".format(spec.name), "{}/bias:0".format(spec.name)]
            group.attrs["weight_names"] = np.array(
                [n.encode("utf-8") for n in weight_names])
            group.create_dataset(weight_names[0],
                                 data=np.asarray(layer["w"], dtype=np.float32))
            group.create_dataset(weight_names[1],
                                 data=np.asarray(layer["b"], dtype=np.float32))
    log("Exported {} layers to Keras weight file {}".format(len(params), path))
    return path
