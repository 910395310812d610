"""Sequence parallelism and mesh serving in the port (`parallel/sequence.py`,
`Transcriber(mesh=)`, `transcribe_long_audio(sequence_parallel=True)`) against the JAX
package's on its CPU meshes.

The port's side runs in one gloo world of 4 CPU processes spawned for the module
(`torch_parallel_worker.py`); the time axis is split over the data axis of a 2 x 2 mesh
(n = 2) and of a 4 x 1 mesh (n = 4). The JAX references run here on 2- and 4-device
meshes, with the same numpy weights.

Tolerances: split logits within 1e-5 of the port's unsplit forward (the split changes
only which frames a conv sees at once: the SAME padding of every window is the global
one) and within 1e-4 of JAX's `sequence_parallel_logits` (`test_torch_model.py`'s
logits limit); texts and frame tokens exact.
"""
import shutil
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from speechless_tpu.models import wav2letter as jax_w2l
from speechless_tpu.parallel import mesh as jax_mesh
from speechless_tpu.parallel.sequence import sequence_parallel_logits as jax_sp_logits
from speechless_tpu.serving import Transcriber as JaxTranscriber
from speechless_tpu_torch.lm.arpa_builder import build_kenlm_directory
from speechless_tpu_torch.models import wav2letter as w2l
from speechless_tpu_torch.parallel.sequence import halo_output_frames, receptive_field_inputs
from speechless_tpu_torch.serving import Transcriber

from test_streaming import ALPHABET, _tiny_config

sys.path.insert(0, str(Path(__file__).resolve().parent))
from torch_parallel_worker import load, save, spawn  # noqa: E402

MEL_LAYERS = (("striding_conv", 16, 48, 2, "relu", False),
              ("inner_conv_1", 16, 7, 1, "relu", False),
              ("big_conv_1", 24, 32, 1, "relu", False),
              ("big_conv_2", 24, 1, 1, "relu", False),
              ("output_conv", 5, 1, 1, "linear", False))
RAW_LAYERS = (("wave_conv", 8, 250, 160, "relu", False),
              ("striding_conv", 8, 48, 2, "relu", False),
              ("output_conv", 4, 1, 1, "linear", False))
# name: (layers, input shape); 2000 frames pad the tail; at 200 a chunk is shorter than
# the halo (122 frames) for n = 2 and 4
CASES = {"mel": (MEL_LAYERS, (2, 2048, 8)), "mel_padded": (MEL_LAYERS, (2, 2000, 8)),
         "short": (MEL_LAYERS, (2, 200, 8)), "raw_wave": (RAW_LAYERS, (1, 320 * 40 * 4, 1))}
SP_BUCKET = 131072
TEXTS = ["the cat sat on the mat", "a dog ran to the cat", "the dog sat on a log"]


def _configs(layers, features):
    port = w2l.Wav2LetterConfig(features, layers[-1][1],
                                layers=tuple(w2l.ConvSpec(*layer) for layer in layers),
                                use_raw_wave_input=layers[0][0] == "wave_conv")
    jax_config = jax_w2l.Wav2LetterConfig(
        input_size_per_time_step=features, grapheme_set_size=layers[-1][1],
        use_raw_wave_input=layers[0][0] == "wave_conv",
        layers=tuple(jax_w2l.ConvSpec(*layer) for layer in layers))
    return port, jax_config


def _jax_params(params):
    return [{k: jnp.asarray(v) for k, v in layer.items()} for layer in params]


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    directory = tmp_path_factory.mktemp("sequence")
    rng = np.random.RandomState(0)
    sequence = {}
    for seed, (name, (layers, shape)) in enumerate(CASES.items()):
        config, _ = _configs(layers, shape[2])
        sequence[name] = (layers, rng.randn(*shape).astype(np.float32),
                          w2l.init_params(config, seed=seed))
    save(directory, "sequence", sequence)

    serving_config = _tiny_config()
    params = [{k: np.asarray(v) for k, v in layer.items()}
              for layer in jax_w2l.init_params(serving_config, jax.random.PRNGKey(9))]
    lm = directory / "lm"
    build_kenlm_directory(TEXTS, lm, allowed_characters=ALPHABET, order=3)
    rng = np.random.RandomState(8)
    audios = [(0.3 * rng.randn(rng.randint(4000, 16000))).astype(np.float32)
              for _ in range(10)]
    long = (np.random.RandomState(60).randn(120000) * 0.3).astype(np.float32)
    layers = tuple((s.name, s.filters, s.kernel_size, s.stride, s.activation,
                    s.dropout_before) for s in serving_config.layers)
    save(directory, "serving", {
        "config": (serving_config.input_size_per_time_step,
                   serving_config.grapheme_set_size), "layers": layers, "params": params,
        "alphabet": ALPHABET, "lm": str(lm), "audios": audios, "long": long,
        "sp_bucket": SP_BUCKET})
    spawn(4, ["sequence", "serving"], directory)
    port_config = w2l.Wav2LetterConfig(serving_config.input_size_per_time_step,
                                       serving_config.grapheme_set_size,
                                       layers=tuple(w2l.ConvSpec(*layer) for layer in layers))
    yield {"directory": directory, "sequence": sequence, "serving_config": serving_config,
           "port_config": port_config, "params": params, "lm": lm, "audios": audios,
           "long": long}
    shutil.rmtree(directory)


def _results(world, case):
    return [load(world["directory"], "{}.{}".format(case, rank)) for rank in range(4)]


def test_receptive_field_and_halo():
    config, jax_config = _configs(MEL_LAYERS, 8)
    assert receptive_field_inputs(config) == 122
    assert halo_output_frames(config) == 61
    full = w2l.Wav2LetterConfig(128, 29)
    from speechless_tpu.parallel.sequence import receptive_field_inputs as jax_field
    assert receptive_field_inputs(full) == jax_field(
        jax_w2l.Wav2LetterConfig(input_size_per_time_step=128, grapheme_set_size=29))
    raw, _ = _configs(RAW_LAYERS, 1)
    assert raw.input_to_prediction_length_ratio == 320
    assert halo_output_frames(raw) == 25


@pytest.mark.parametrize("n", [2, 4])
@pytest.mark.parametrize("name", list(CASES))
def test_split_logits_match_unsplit_and_jax(world, n, name):
    """Every rank's gathered logits: within 1e-5 of the port's unsplit forward on the
    padded input, within 1e-4 of JAX's `sequence_parallel_logits` on an n-device mesh;
    split runs issue one halo all-gather and one output all-gather, the short input
    (chunk < halo) none."""
    layers, inputs, params = world["sequence"][name]
    config, jax_config = _configs(layers, inputs.shape[2])
    mesh = jax_mesh.make_mesh(jax.devices()[:n])
    want = np.asarray(jax_sp_logits(jax_config, _jax_params(params), jnp.asarray(inputs),
                                    mesh))
    model = w2l.build_model(config, params, device="cpu")
    ratio = config.input_to_prediction_length_ratio
    padded = np.zeros((inputs.shape[0], want.shape[1] * ratio, inputs.shape[2]), np.float32)
    padded[:, :inputs.shape[1]] = inputs
    with torch.no_grad():
        unsplit = model(torch.from_numpy(padded)).numpy()
    split = name != "short"
    for result in _results(world, "sequence"):
        logits, events = result[(n, name)]
        assert logits.shape == want.shape
        np.testing.assert_allclose(logits, unsplit, rtol=0, atol=1e-5)
        np.testing.assert_allclose(logits, want, rtol=0, atol=1e-4)
        assert events == ([("all_gather", "data", "sequence halos"),
                           ("all_gather", "data", "sequence outputs")] if split else [])


@pytest.fixture(scope="module")
def jax_transcribers(world):
    config = world["serving_config"]
    params = _jax_params(world["params"])
    mesh = jax_mesh.make_mesh(jax.devices()[:4])
    out = {}
    for name, lm in (("greedy", None), ("lm", world["lm"])):
        on_mesh = JaxTranscriber(config, params, ALPHABET, sample_buckets=(16384,),
                                 kenlm_directory=lm, beam_width=8, mesh=mesh)
        plain = JaxTranscriber(config, params, ALPHABET, sample_buckets=(16384,),
                               kenlm_directory=lm, beam_width=8)
        plain._SP_BUCKET_SAMPLES = SP_BUCKET
        out[name] = (on_mesh, plain)
    return out


@pytest.mark.parametrize("name", ["greedy", "lm"])
def test_mesh_transcriber_matches_jax(world, jax_transcribers, name):
    """`Transcriber(mesh=)` over 4 data ranks: each rank's texts (its rows decoded,
    the others gathered) equal JAX's DP-sharded Transcriber's and the port's
    single-process Transcriber's; frame tokens too; a batch of 3 is refused with JAX's
    message."""
    on_mesh, _ = jax_transcribers[name]
    want = on_mesh.transcribe_batch(world["audios"], batch_size=8)
    plain = Transcriber(world["port_config"], world["params"], ALPHABET, device="cpu",
                        sample_buckets=(16384,), beam_width=8,
                        kenlm_directory=world["lm"] if name == "lm" else None)
    single = plain.transcribe_batch(world["audios"], batch_size=8)
    assert [text for text, _ in single] == [text for text, _ in want]
    for result in _results(world, "serving"):
        got = result[name]["texts"]
        assert [text for text, _ in got] == [text for text, _ in want]
        np.testing.assert_allclose([c for _, c in got], [c for _, c in want], rtol=1e-5)
        if name == "greedy":
            for frames, expected in zip(result[name]["frames"], on_mesh.frame_tokens_batch(
                    world["audios"][:8], batch_size=8)):
                np.testing.assert_array_equal(frames, expected)
            with pytest.raises(ValueError, match="does not divide") as refusal:
                on_mesh.transcribe_batch(world["audios"][:3], batch_size=3)
            assert result[name]["refusal"] == str(refusal.value)


@pytest.mark.parametrize("name", ["greedy", "lm"])
def test_sequence_parallel_long_form_matches_jax(world, jax_transcribers, name):
    """`transcribe_long_audio(sequence_parallel=True)` of a 7.5 s recording in one
    131,072-sample bucket: the same text at n = 2, n = 4 and on the default mesh (the
    world), equal to JAX's on a 4-device mesh, to the port's single-process route and,
    at this matched bucket, to the offline single-utterance route."""
    _, plain = jax_transcribers[name]
    want = plain.transcribe_long_audio(world["long"], mesh=jax_mesh.make_mesh(
        jax.devices()[:4]))
    assert want
    port = Transcriber(world["port_config"], world["params"], ALPHABET, device="cpu",
                       sample_buckets=(SP_BUCKET,), beam_width=8,
                       kenlm_directory=world["lm"] if name == "lm" else None)
    port._SP_BUCKET_SAMPLES = SP_BUCKET
    assert port.transcribe_long_audio(world["long"], sequence_parallel=True) == want
    assert port.transcribe_audio(world["long"]) == want
    for result in _results(world, "serving"):
        for key in (("long", 2), ("long", 4), ("long", "default")):
            assert result[name][key] == want
