"""The reference's Keras ``.h5`` checkpoints in the port (`train/keras_import.py`, the
``.h5`` fallback of `train/checkpoint.py`, the CLI's ``convert``) against the JAX
package's module on the same files: each case of `tests/test_keras_import.py`, both
packages reading the same file (a file the test writes, or one either package's writer
wrote). Every array must be bitwise equal, and every refusal must come from both.
"""
import shutil

import numpy as np
import pytest

h5py = pytest.importorskip("h5py")

import jax.numpy as jnp

from speechless_tpu import __main__ as jax_cli
from speechless_tpu.models import wav2letter as jax_w2l
from speechless_tpu.train import checkpoint as jax_checkpoint
from speechless_tpu.train import keras_import as jax_keras
from speechless_tpu_torch.__main__ import main
from speechless_tpu_torch.experiments import available_epochs
from speechless_tpu_torch.models import wav2letter as w2l
from speechless_tpu_torch.train import checkpoint, keras_import


def _tiny(grapheme_set_size=5):
    layers = (("striding_conv", 6, 5, 2, "relu"), ("inner_conv_1", 6, 3, 1, "relu"),
              ("output_conv", grapheme_set_size, 1, 1, "linear"))
    return (w2l.Wav2LetterConfig(4, grapheme_set_size,
                                 layers=tuple(w2l.ConvSpec(*spec) for spec in layers)),
            jax_w2l.Wav2LetterConfig(input_size_per_time_step=4,
                                     grapheme_set_size=grapheme_set_size,
                                     layers=tuple(jax_w2l.ConvSpec(*spec, False)
                                                  for spec in layers)))


def _layers(config, seed=0):
    rng = np.random.RandomState(seed)
    layers, in_channels = [], config.input_size_per_time_step
    for spec in config.layers:
        kernel = rng.randn(spec.kernel_size, in_channels, spec.filters)
        layers.append((spec.name, kernel.astype(np.float32),
                       rng.randn(spec.filters).astype(np.float32)))
        in_channels = spec.filters
    return layers


def _write_keras2(path, layers, weightless=(), nested=False, keras1=False):
    """A Keras ``save_weights`` file: root ``layer_names``, per-layer ``weight_names``
    (Keras 2's ``<layer>/kernel:0`` or Keras 1's ``<layer>_W``), Dropout groups without
    weights before the named layers, or everything under ``model_weights``."""
    with h5py.File(str(path), "w") as f:
        root = f.create_group("model_weights") if nested else f
        ordered = []
        for name, kernel, bias in layers:
            if name in weightless:
                ordered.append(("dropout_before_{}".format(name), None, None))
            ordered.append((name, kernel, bias))
        root.attrs["layer_names"] = np.array([n.encode() for n, _, _ in ordered])
        for name, kernel, bias in ordered:
            group = root.create_group(name)
            if kernel is None:
                group.attrs["weight_names"] = np.array([], dtype="S1")
                continue
            names = (["{}_W".format(name), "{}_b".format(name)] if keras1 else
                     ["{}/kernel:0".format(name), "{}/bias:0".format(name)])
            group.attrs["weight_names"] = np.array([n.encode() for n in names])
            group.create_dataset(names[0], data=kernel)
            group.create_dataset(names[1], data=bias)


def _assert_equal(got, want):
    assert len(got) == len(want)
    for got_layer, want_layer in zip(got, want):
        assert sorted(got_layer) == sorted(want_layer)
        for key in want_layer:
            got_array, want_array = np.asarray(got_layer[key]), np.asarray(want_layer[key])
            assert got_array.dtype == want_array.dtype
            np.testing.assert_array_equal(got_array, want_array)


def _both_load(path, with_config=True, grapheme_set_size=5):
    config, jax_config = _tiny(grapheme_set_size)
    got = keras_import.load_keras_params(path, config if with_config else None)
    want = jax_keras.load_keras_params(path, jax_config if with_config else None)
    _assert_equal(got, want)
    return got


@pytest.mark.parametrize("layout", ["keras2", "dropout_groups", "model_weights", "keras1"])
def test_loads_like_jax(tmp_path, layout):
    config = _tiny()[0]
    layers = _layers(config)
    path = tmp_path / "weights-epoch1.h5"
    _write_keras2(path, layers, nested=layout == "model_weights",
                  keras1=layout == "keras1",
                  weightless={"striding_conv", "inner_conv_1"}
                  if layout == "dropout_groups" else ())
    _assert_equal(_both_load(path), [{"w": k, "b": b} for _, k, b in layers])


@pytest.mark.parametrize("case", ["charset", "architecture", "no_layer_names"])
def test_refuses_like_jax(tmp_path, case):
    """A charset mismatch (kernel shape), an architecture mismatch (layer names) and a
    file without ``layer_names`` loaded without a config fail in both packages."""
    path = tmp_path / "weights-epoch1.h5"
    layers = _layers(_tiny(7 if case == "charset" else 5)[0])
    _write_keras2(path, layers[:2] if case == "architecture" else layers)
    if case == "no_layer_names":
        with h5py.File(str(path), "a") as f:
            del f.attrs["layer_names"]
    match = {"charset": "kernel shape", "architecture": "do not match",
             "no_layer_names": "layer_names"}[case]
    for module, config in ((keras_import, _tiny()[0]), (jax_keras, _tiny()[1])):
        with pytest.raises(ValueError, match=match):
            module.load_keras_params(path, None if case == "no_layer_names" else config)


def test_config_restores_the_order_without_layer_names(tmp_path):
    layers = _layers(_tiny()[0])
    path = tmp_path / "weights-epoch1.h5"
    _write_keras2(path, layers)
    with h5py.File(str(path), "a") as f:
        del f.attrs["layer_names"]
    _assert_equal(_both_load(path), [{"w": k, "b": b} for _, k, b in layers])


def test_round_trips_across_packages(tmp_path):
    """The port's writer read by JAX's reader, and JAX's writer read by the port's: the
    arrays bitwise, the files' structure the same."""
    config, jax_config = _tiny()
    params = w2l.init_params(config, seed=3)
    keras_import.save_keras_params(tmp_path / "port.h5", config, params)
    jax_keras.save_keras_params(tmp_path / "jax.h5", jax_config,
                                [{k: jnp.asarray(v) for k, v in p.items()} for p in params])
    _assert_equal(jax_keras.load_keras_params(tmp_path / "port.h5", jax_config), params)
    _assert_equal(keras_import.load_keras_params(tmp_path / "jax.h5", config), params)
    with h5py.File(str(tmp_path / "port.h5"), "r") as got, \
            h5py.File(str(tmp_path / "jax.h5"), "r") as want:
        assert list(got.attrs["layer_names"]) == list(want.attrs["layer_names"])
        for name in got:
            assert list(got[name].attrs["weight_names"]) == \
                list(want[name].attrs["weight_names"])


def test_quantized_params_are_refused(tmp_path):
    config = _tiny()[0]
    params = w2l.init_params(config, seed=3)
    params[0] = {"w_q": np.zeros((5, 4, 6), np.int8), "w_scale": np.ones(6, np.float32),
                 "b": params[0]["b"]}
    with pytest.raises(ValueError, match="quantized"):
        keras_import.save_keras_params(tmp_path / "q.h5", config, params)


def test_checkpoint_fallback_like_jax(tmp_path):
    """``load_params`` reads ``weights-epoch{n}.h5`` when no ``.npz`` is there (checked
    against a config when given), with no step and no optimizer state; an ``.npz`` of
    the same epoch wins; ``available_epochs`` lists both kinds."""
    config, jax_config = _tiny()
    layers = _layers(config)
    _write_keras2(tmp_path / "weights-epoch3.h5", layers)
    _assert_equal(checkpoint.load_params(tmp_path, 3, config=config),
                  jax_checkpoint.load_params(tmp_path, 3, config=jax_config))
    assert checkpoint.load_step(tmp_path, 3) is None
    from speechless_tpu_torch.train import trainer
    state = trainer.init_train_state(config, trainer.make_optimizer(),
                                     params=checkpoint.load_params(tmp_path, 3), device="cpu")
    assert checkpoint.load_opt_state(tmp_path, 3, state.opt_state) is None
    with pytest.raises(ValueError, match="kernel shape"):
        checkpoint.load_params(tmp_path, 3, config=_tiny(7)[0])

    npz_params = w2l.init_params(config, seed=4)
    checkpoint.save_checkpoint(tmp_path, 3, npz_params)
    _assert_equal(checkpoint.load_params(tmp_path, 3), npz_params)
    _write_keras2(tmp_path / "weights-epoch10.h5", layers)
    assert available_epochs(tmp_path) == [3, 10]
    averaged = checkpoint.average_checkpoint_params(tmp_path, [3, 10], config=config)
    _assert_equal(averaged, jax_checkpoint.average_checkpoint_params(tmp_path, [3, 10],
                                                                     config=jax_config))


def test_transfer_from_an_h5_donor_like_jax(tmp_path):
    """The transfer remap straight off a reference checkpoint: shared characters keep the
    donor's filters, new ones are zero, blank maps to blank, as in JAX."""
    source, target = ["a", "b", "c", "d"], ["a", "c", "x"]
    donor_config = _tiny(len(source) + 1)[0]
    donor_layers = _layers(donor_config, seed=2)
    _write_keras2(tmp_path / "weights-epoch7.h5", donor_layers)
    target_config, jax_target_config = _tiny(len(target) + 1)
    got = checkpoint.load_params_with_character_remap(tmp_path, 7, source, target,
                                                      target_config)
    want = jax_checkpoint.load_params_with_character_remap(tmp_path, 7, source, target,
                                                           jax_target_config)
    _assert_equal(got, want)
    np.testing.assert_array_equal(got[-1]["w"][..., 1], donor_layers[-1][1][..., 2])
    np.testing.assert_array_equal(got[-1]["w"][..., 2], 0.0)


@pytest.mark.parametrize("raw_wave", [False, True], ids=["mel", "raw_wave"])
def test_convert_both_ways_like_jax(tmp_path, raw_wave):
    """``convert`` h5 -> npz -> h5 at the full reference geometry (the npz -> h5
    direction infers it from the weights: a first kernel of (250, 1, ...) is the
    raw-wave model), equal to the JAX CLI's files; a trained-ASG pseudo-layer is
    dropped; int8 weights and mismatched extensions are refused. The full-width files
    (~90 MB each) are deleted when the test ends."""
    try:
        _convert_both_ways(tmp_path, raw_wave)
    finally:
        shutil.rmtree(tmp_path, ignore_errors=True)


def _unlink(directory, *names):
    """Deletes full-width files once compared: the test's peak stays at ~3 of them."""
    for name in names:
        (directory / name).unlink()


def _convert_both_ways(tmp_path, raw_wave):
    config = w2l.Wav2LetterConfig(1 if raw_wave else 8, 5, use_raw_wave_input=raw_wave)
    params = w2l.init_params(config, seed=9)
    h5_path = tmp_path / "weights-epoch1.h5"
    keras_import.save_keras_params(h5_path, config, params)
    main(["convert", str(h5_path), str(tmp_path / "port.npz")])
    jax_cli.main(["convert", str(h5_path), str(tmp_path / "jax.npz")])
    _assert_equal(checkpoint.load_params_npz(tmp_path / "port.npz"), params)
    _assert_equal(checkpoint.load_params_npz(tmp_path / "port.npz"),
                  jax_checkpoint.load_params_npz(tmp_path / "jax.npz"))
    _unlink(tmp_path, "weights-epoch1.h5", "port.npz", "jax.npz")

    with_tables = params + [{"asg_transitions": np.zeros((5, 5), np.float32),
                             "asg_initials": np.zeros(5, np.float32)}]
    checkpoint.save_params_npz(tmp_path / "asg.npz", with_tables)
    main(["convert", str(tmp_path / "asg.npz"), str(tmp_path / "port.h5")])
    jax_cli.main(["convert", str(tmp_path / "asg.npz"), str(tmp_path / "jax.h5")])
    _assert_equal(keras_import.load_keras_params(tmp_path / "port.h5", config), params)
    _assert_equal(keras_import.load_keras_params(tmp_path / "port.h5"),
                  jax_keras.load_keras_params(tmp_path / "jax.h5"))
    with h5py.File(str(tmp_path / "port.h5"), "r") as f:
        assert [n.decode() for n in f.attrs["layer_names"]] == config.layer_names
    _unlink(tmp_path, "asg.npz", "port.h5", "jax.h5")

    quantized = [dict(layer) for layer in params]
    quantized[0] = {"w_q": np.zeros(params[0]["w"].shape, np.int8),
                    "w_scale": np.ones(params[0]["w"].shape[2], np.float32),
                    "b": params[0]["b"]}
    checkpoint.save_params_npz(tmp_path / "q.npz", quantized)
    with pytest.raises(SystemExit, match="int8"):
        main(["convert", str(tmp_path / "q.npz"), str(tmp_path / "q.h5")])
    with pytest.raises(SystemExit, match="convert needs"):
        main(["convert", str(tmp_path / "a.txt"), str(tmp_path / "b.npz")])
    assert keras_import.is_keras_weight_file("model.HDF5")
    assert not keras_import.is_keras_weight_file("weights-epoch3.npz")
