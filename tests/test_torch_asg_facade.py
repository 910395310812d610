"""The port's facade with the ASG criterion and trainable tables
(`speechless_tpu_torch.system.Wav2Letter(use_asg=True, train_asg_transitions=True)`)
against the JAX facade on the CPU, at the published widths (128 mel in, 250/2000
filters) in fp32, on a 6-utterance tree of `tests/test_system.py`'s kind (3 to train,
batch 2, 2 batches an epoch; 3 to test). The JAX facade saves epoch 0, both packages
train one epoch from it after the same `random.seed`, and the JAX facade resumes the
port's checkpoint. A 7-character set keeps the classes at 9 (JAX's ASG compiles per
shape; the batcher pads to 64 frames and 64 labels).

Tolerances, as in `test_torch_system.py`: the epoch's loss and the eval losses of the
same weights rtol 1e-4; each tensor's change since epoch 0 and each Adam moment within
0.25 relative L2 of the JAX package's (Adam's ±lr steps on gradients within rounding of
zero); Viterbi predictions, tables, steps and layer counts equal.
"""
import random
import shutil

import numpy as np
import pytest

from speechless_tpu.configuration import Configuration as JaxConfiguration
from speechless_tpu.configuration import DataDirectories as JaxDataDirectories
from speechless_tpu.data import LibriSpeechCorpus as JaxLibriSpeechCorpus
from speechless_tpu.data import TrainingTestSplit as JaxTrainingTestSplit
from speechless_tpu.system import Wav2Letter as JaxWav2Letter
from speechless_tpu_torch.configuration import Configuration, DataDirectories
from speechless_tpu_torch.data import LibriSpeechCorpus, TrainingTestSplit
from speechless_tpu_torch.system import Wav2Letter

from test_corpus import make_librispeech_tree

CHARACTERS = [" ", "a", "e", "h", "s", "t", "y"]   # ASG: 9 classes, CTC: 8
TEXTS = ["hey", "yes", "the sea", "eat", "tea", "say the"]
SEED = 7
LOSS_RTOL = 1e-4
CHECKPOINT_REL_L2 = 0.25
TRAINABLE = dict(use_asg=True, train_asg_transitions=True)


@pytest.fixture(scope="module")
def facades(tmp_path_factory):
    """Both packages train one epoch of 2 batches of 2 from the JAX facade's epoch 0
    (tables included): runs "jax" and "port"; the JAX facade then resumes the port's
    epoch-1 checkpoint for the evaluation tests."""
    data = tmp_path_factory.mktemp("asg_facade") / "data"
    make_librispeech_tree(data / "corpus" / "English" / "mini", TEXTS)
    jax_config = JaxConfiguration(
        name="English", directories=JaxDataDirectories(data), batch_size=2,
        training_batches_per_epoch=2, corpus_from_directory=lambda d: JaxLibriSpeechCorpus(
            base_directory=d, corpus_name="mini",
            training_test_split=JaxTrainingTestSplit.overfit(3)))
    config = Configuration(
        name="English", directories=DataDirectories(data), batch_size=2,
        training_batches_per_epoch=2, corpus_from_directory=lambda d: LibriSpeechCorpus(
            base_directory=d, corpus_name="mini",
            training_test_split=TrainingTestSplit.overfit(3)))
    nets = data / "nets"
    JaxWav2Letter(128, CHARACTERS, **TRAINABLE).save(nets / "base", 0)
    trained = JaxWav2Letter(128, CHARACTERS, load_model_from_directory=nets / "base",
                            load_epoch=0, **TRAINABLE)
    random.seed(SEED)
    jax_config.train(trained, run_name="jax", epoch_limit=1, callback_step=2)
    port = Wav2Letter(128, CHARACTERS, load_model_from_directory=nets / "base", load_epoch=0,
                      device="cpu", **TRAINABLE)
    random.seed(SEED)
    config.train(port, run_name="port", epoch_limit=1, callback_step=2)
    resumed = JaxWav2Letter(128, CHARACTERS, load_model_from_directory=nets / "port",
                            load_epoch=1, **TRAINABLE)
    yield {"jax_config": jax_config, "config": config, "nets": nets, "jax": resumed,
           "port": port}
    shutil.rmtree(data)  # full-width checkpoints


def _scalars(configuration, run):
    return (configuration.directories.tensorboard_log_base_directory / run /
            "scalars.csv").read_text().strip().splitlines()


def test_epoch_matches_the_jax_facade(facades):
    """The port's epoch against the JAX facade's from the same epoch 0 and batches: the
    epoch's loss, and every checkpoint entry (the tables' pseudo-layer and their Adam
    moments included)."""
    port_rows = _scalars(facades["config"], "port")
    jax_rows = _scalars(facades["jax_config"], "jax")
    assert [row.split(",")[:2] for row in port_rows[1:]] \
        == [row.split(",")[:2] for row in jax_rows[1:]] == [["1", "2"]]
    np.testing.assert_allclose(float(port_rows[1].split(",")[2]),
                               float(jax_rows[1].split(",")[2]), rtol=LOSS_RTOL)
    nets, errors = facades["nets"], {}
    with np.load(str(nets / "jax" / "weights-epoch1.npz")) as want, \
            np.load(str(nets / "port" / "weights-epoch1.npz")) as got, \
            np.load(str(nets / "base" / "weights-epoch0.npz")) as base:
        assert sorted(want.files) == sorted(got.files)
        for key in want.files:
            w, g = np.asarray(want[key]), np.asarray(got[key])
            assert w.shape == g.shape and w.dtype == g.dtype, key
            if w.dtype.kind != "f":
                np.testing.assert_array_equal(g, w, err_msg=key)
                continue
            if key.startswith("layer"):
                w, g = w - base[key], g - base[key]
            errors[key] = float(np.linalg.norm(g - w) / np.linalg.norm(w))
    print("epoch loss rel {:.3g}; largest relative L2 of a change or moment: {}".format(
        abs(float(port_rows[1].split(",")[2]) / float(jax_rows[1].split(",")[2]) - 1),
        sorted(errors.items(), key=lambda e: -e[1])[:3]))
    assert max(errors.values()) <= CHECKPOINT_REL_L2, errors


def test_facade_trains_and_the_jax_facade_resumes(facades):
    """The epoch's loss is finite, the tables moved and sit last in the epoch-1
    checkpoint, and the JAX facade resumes it: the step, the tables and Adam's state."""
    scalars = _scalars(facades["config"], "port")
    assert len(scalars) == 2 and np.isfinite(float(scalars[1].split(",")[2]))
    layer = "layer{}.".format(len(facades["port"].params) - 1)
    with np.load(str(facades["nets"] / "port" / "weights-epoch1.npz")) as got, \
            np.load(str(facades["nets"] / "base" / "weights-epoch0.npz")) as base:
        for name in ("asg_initials", "asg_transitions"):
            assert np.abs(got[layer + name] - base[layer + name]).max() > 0
            np.testing.assert_array_equal(np.asarray(facades["jax"].params[-1][name]),
                                          got[layer + name])
    assert facades["port"].state.step == int(facades["jax"].state.step) == 2
    assert facades["jax"].state.opt_state is not None


def test_facade_decodes_the_same_weights_like_jax(facades):
    """Both facades on the port's epoch-1 weights: the Viterbi predictions over the
    trained tables and the eval losses of the test batch."""
    got = facades["port"].test_and_predict_batch(
        facades["config"].batch_generator.labeled_test_spectrograms).results
    want = facades["jax"].test_and_predict_batch(
        facades["jax_config"].batch_generator.labeled_test_spectrograms).results
    assert len(got) == len(want) == 3
    assert [r.predicted for r in got] == [r.predicted for r in want]
    np.testing.assert_allclose([r.loss for r in got], [r.loss for r in want], rtol=1e-4)


def test_fixed_table_and_ctc_runs_drop_the_pseudo_layer(facades):
    """A fixed-table ASG run and a CTC run (one more character, so the same 9 classes)
    loading the trainable-ASG checkpoint drop its tables, as the JAX facade does
    (`speechless_tpu/system.py`: one branch for both)."""
    directory = facades["nets"] / "port"
    for kwargs, characters in (({"use_asg": True}, CHARACTERS), ({}, CHARACTERS + ["'"])):
        port = Wav2Letter(128, characters, load_model_from_directory=directory, load_epoch=1,
                          device="cpu", **kwargs)
        assert len(port.params) == 11 and port.state.model.asg is None
