"""The port's facade (`speechless_tpu_torch.system.Wav2Letter`, `configuration.py`,
`experiments.py` and the CLI's workflow commands) against the JAX package's on the CPU,
at the published width (128 mel in, 250/2000 filters, 29 classes) in fp32, on the
4-utterance tree of `tests/test_system.py` (batch 2, 2 batches an epoch). The JAX facade
saves epoch 0 and both packages load it, so both start from the same weights; both draw
their batches from the global `random` after the same `random.seed`.

Tolerances, with their reasons:
* the first epoch's loss (``scalars.csv``) and per-utterance eval losses of the same
  weights: rtol 1e-4 (fp32 convolutions and CTC sums in another order);
* a later epoch's loss: rtol 1e-3. At this width a few ReLU pre-activations sit within
  fp32 rounding of zero, so the two packages' gradients differ in those paths, and
  Adam, which moves every element by about lr whatever its gradient's size, turns those
  into different updates; after 4 updates the losses differ by about 1e-4 relative
  (`test_two_epochs_match_the_jax_facade` prints the numbers under ``-s``);
* the checkpoints: the same entries, shapes and dtypes, the step and update counts
  equal; each tensor's parameter change since epoch 0 and each Adam moment within 0.25
  relative L2 of the JAX package's (printed as above: about 0.1 and 0.02).
  `test_torch_train.py`'s elementwise Adam bound (atol 1e-2 * lr) holds on its narrow
  model but not here, for the reason above;
* predictions, groups, counts, steps and epoch numbers: equal.
"""
import csv
import random
import shutil

import numpy as np
import pytest

from speechless_tpu.configuration import Configuration as JaxConfiguration
from speechless_tpu.configuration import DataDirectories as JaxDataDirectories
from speechless_tpu.data import LibriSpeechCorpus as JaxLibriSpeechCorpus
from speechless_tpu.data import TrainingTestSplit as JaxTrainingTestSplit
from speechless_tpu.system import Wav2Letter as JaxWav2Letter
from speechless_tpu_torch.__main__ import main
from speechless_tpu_torch.configuration import Configuration, DataDirectories, LoggedRun
from speechless_tpu_torch.data import LibriSpeechCorpus, TrainingTestSplit
from speechless_tpu_torch.experiments import (ExperimentRegistry, TrainedRun,
                                              available_epochs, validate_to_csv)
from speechless_tpu_torch.lm.arpa_builder import build_kenlm_directory
from speechless_tpu_torch.models import wav2letter as w2l
from speechless_tpu_torch.system import Wav2Letter
from speechless_tpu_torch.text.charsets import english_frequent_characters
from speechless_tpu_torch.train import checkpoint

from test_corpus import make_librispeech_tree

LOSS_RTOL = 1e-4
LATER_LOSS_RTOL = 1e-3
CHECKPOINT_REL_L2 = 0.25
SEED = 7
TEXTS = ["hey there", "what's up", "all good", "yes"]


def _configurations(data):
    def jax_corpus(directory):
        return JaxLibriSpeechCorpus(base_directory=directory, corpus_name="mini",
                                    training_test_split=JaxTrainingTestSplit.overfit(3))

    def port_corpus(directory):
        return LibriSpeechCorpus(base_directory=directory, corpus_name="mini",
                                 training_test_split=TrainingTestSplit.overfit(3))

    return (JaxConfiguration(name="English", corpus_from_directory=jax_corpus,
                             directories=JaxDataDirectories(data), batch_size=2,
                             training_batches_per_epoch=2),
            Configuration(name="English", corpus_from_directory=port_corpus,
                          directories=DataDirectories(data), batch_size=2,
                          training_batches_per_epoch=2))


def _scalars(configuration, run):
    path = configuration.directories.tensorboard_log_base_directory / run / "scalars.csv"
    with path.open() as f:
        return list(csv.reader(f))[1:]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Both packages train 2 epochs from the JAX facade's epoch 0: runs "jax" and
    "port". The trained JAX facade stays for the evaluation tests."""
    data = tmp_path_factory.mktemp("system") / "data"
    make_librispeech_tree(data / "corpus" / "English" / "mini", TEXTS)
    jax_config, config = _configurations(data)
    nets = jax_config.directories.nets_base_directory
    JaxWav2Letter(128, english_frequent_characters).save(nets / "base", 0)

    trained = JaxWav2Letter(128, english_frequent_characters,
                            load_model_from_directory=nets / "base", load_epoch=0)
    random.seed(SEED)
    jax_config.train(trained, run_name="jax", epoch_limit=2)
    port = Wav2Letter(128, english_frequent_characters, load_model_from_directory=nets / "base",
                      load_epoch=0, device="cpu")
    random.seed(SEED)
    config.train(port, run_name="port", epoch_limit=2)
    yield {"jax_config": jax_config, "config": config, "nets": nets, "jax": trained,
           "port": port}
    shutil.rmtree(data)  # full-width checkpoints: 280 MB each


def _assert_checkpoints_close(jax_path, port_path, base_path):
    """Returns each float entry's relative L2 error (parameters: their change since
    ``base_path``)."""
    errors = {}
    with np.load(str(jax_path)) as want, np.load(str(port_path)) as got, \
            np.load(str(base_path)) as base:
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
            assert errors[key] <= CHECKPOINT_REL_L2, (key, errors[key])
    return errors


def test_two_epochs_match_the_jax_facade(runs):
    jax_rows = _scalars(runs["jax_config"], "jax")
    port_rows = _scalars(runs["config"], "port")
    assert [row[:2] for row in port_rows] == [row[:2] for row in jax_rows] \
        == [["1", "2"], ["2", "4"]]
    np.testing.assert_allclose(float(port_rows[0][2]), float(jax_rows[0][2]), rtol=LOSS_RTOL)
    np.testing.assert_allclose(float(port_rows[1][2]), float(jax_rows[1][2]),
                               rtol=LATER_LOSS_RTOL)
    print("epoch losses, relative difference:",
          [abs(float(p[2]) - float(j[2])) / float(j[2]) for p, j in zip(port_rows, jax_rows)])
    for epoch in (1, 2):
        errors = _assert_checkpoints_close(
            runs["nets"] / "jax" / "weights-epoch{}.npz".format(epoch),
            runs["nets"] / "port" / "weights-epoch{}.npz".format(epoch),
            runs["nets"] / "base" / "weights-epoch0.npz")
        print("epoch {}: largest relative L2, parameter changes {:.3g}, moments {:.3g}"
              .format(epoch, max(v for k, v in errors.items() if k.startswith("layer")),
                      max(v for k, v in errors.items() if k.startswith("opt"))))
    assert available_epochs(runs["nets"] / "port") == [1, 2]
    logs = runs["config"].directories.tensorboard_log_base_directory / "port"
    assert len(list(logs.glob("events.out.tfevents.*"))) == 1


@pytest.fixture(scope="module")
def evaluated(runs):
    """The JAX run's epoch-2 weights on both facades."""
    port = Wav2Letter(128, english_frequent_characters,
                      load_model_from_directory=runs["nets"] / "jax", load_epoch=2,
                      device="cpu")
    return runs["jax"], port


def test_test_and_predict_batch_matches(runs, evaluated):
    jax_facade, port = evaluated
    preview = runs["config"].batch_generator.preview_batch()
    want = jax_facade.test_and_predict_batch(runs["jax_config"].batch_generator.preview_batch())
    got = port.test_and_predict_batch(preview)
    assert [r.predicted for r in got.results] == [r.predicted for r in want.results]
    assert [r.expected for r in got.results] == [r.expected for r in want.results]
    np.testing.assert_allclose([r.loss for r in got.results],
                               [r.loss for r in want.results], rtol=LOSS_RTOL)
    assert got.summary_line() == want.summary_line()
    assert port.predict_batch_greedily(
        [s.z_normalized_transposed_spectrogram() for s in preview]) \
        == jax_facade.predict_batch_greedily(
            [s.z_normalized_transposed_spectrogram() for s in preview])
    np.testing.assert_allclose(
        port.prediction_batch(np.stack([preview[0].z_normalized_transposed_spectrogram()])),
        jax_facade.prediction_batch(
            np.stack([preview[0].z_normalized_transposed_spectrogram()])),
        rtol=1e-4, atol=1e-6)


def test_grouped_evaluation_matches(runs, evaluated):
    jax_facade, port = evaluated
    want = runs["jax_config"].test_model_grouped_by_loaded_corpus_name(jax_facade)
    got = runs["config"].test_model_grouped_by_loaded_corpus_name(port)
    assert list(got.result_batches_by_group_name) == list(want.result_batches_by_group_name) \
        == ["mini"]
    for name, batches in want.result_batches_by_group_name.items():
        mine = got.result_batches_by_group_name[name]
        assert [len(b.results) for b in mine.result_batches] \
            == [len(b.results) for b in batches.result_batches]
        assert [r.predicted for r in mine.results] == [r.predicted for r in batches.results]
    assert (got.average_letter_error_rate, got.average_word_error_rate) \
        == (want.average_letter_error_rate, want.average_word_error_rate)


def test_checkpoints_resume_across_packages(runs):
    """The port resumes the JAX run and the JAX facade the port's run: epoch, step and
    the optimizer state continue, and one more epoch on each writes epoch 3 at step 6
    with matching losses and checkpoints."""
    jax_config, config, nets = runs["jax_config"], runs["config"], runs["nets"]
    port = Wav2Letter(128, english_frequent_characters, load_model_from_directory=nets / "jax",
                      load_epoch=2, device="cpu")
    jax_facade = JaxWav2Letter(128, english_frequent_characters,
                               load_model_from_directory=nets / "port", load_epoch=2)
    assert port.state.step == int(jax_facade.state.step) == 4
    random.seed(SEED + 1)
    config.train(port, run_name="jax", epoch_limit=3)
    random.seed(SEED + 1)
    jax_config.train(jax_facade, run_name="port", epoch_limit=3)
    port_row, jax_row = _scalars(config, "jax")[-1], _scalars(jax_config, "port")[-1]
    assert port_row[:2] == jax_row[:2] == ["3", "6"]
    np.testing.assert_allclose(float(port_row[2]), float(jax_row[2]), rtol=LATER_LOSS_RTOL)
    _assert_checkpoints_close(nets / "port" / "weights-epoch3.npz",
                              nets / "jax" / "weights-epoch3.npz",
                              nets / "base" / "weights-epoch0.npz")
    assert checkpoint.load_step(nets / "jax", 3) == 6


def test_train_or_resume_and_multi_step(tmp_path):
    """`train_or_resume` starts a run, then resumes it from its latest epoch; the
    multi-step route (k updates a call) trains the same run on."""
    make_librispeech_tree(tmp_path / "corpus" / "English" / "mini", TEXTS)
    _, config = _configurations(tmp_path)
    try:
        config.train_or_resume("run", wav2letter_kwargs={"device": "cpu"}, epoch_limit=1)
        config.train_or_resume("run", wav2letter_kwargs={"device": "cpu"}, epoch_limit=2,
                               multi_step=2)
        rows = _scalars(config, "run")
        assert [row[:2] for row in rows] == [["1", "2"], ["2", "4"]]
        assert all(np.isfinite(float(row[2])) for row in rows)
        with pytest.raises(ValueError, match="multi_step"):
            config.train_or_resume("run", wav2letter_kwargs={"device": "cpu"},
                                   epoch_limit=3, multi_step=3)
    finally:
        shutil.rmtree(config.directories.nets_base_directory, ignore_errors=True)


def test_logged_run_and_registry(runs, tmp_path):
    results = tmp_path / "results"
    LoggedRun(lambda: runs["config"].test_model(runs["port"]), "test.txt", results)()
    assert "Average over" in (results / "test.txt").read_text()

    # The registry loads through `Configuration.load_model`'s default, the JAX
    # package's load with the English characters remapped onto themselves.
    registry = ExperimentRegistry(lambda: runs["config"], device="cpu")
    registry.add_evaluation(TrainedRun("port", 2))
    assert registry.names() == ["port-2"]
    registry.run(0)
    report = runs["config"].directories.test_results_directory / "port-2.txt"
    assert "All corpora: Average over 1 examples" in report.read_text()
    german = runs["config"].load_german_model("port", 2, device="cpu")
    assert german.state.step == 0 and german.config.grapheme_set_size == 29


def test_validate_to_csv(runs, tmp_path):
    csv_file = tmp_path / "sweep.csv"
    validate_to_csv(runs["config"], "port", csv_file, device="cpu")
    lines = csv_file.read_text().strip().splitlines()
    assert lines[0].startswith("epoch,average_loss")
    assert [int(line.split(",")[0]) for line in lines[1:]] \
        == available_epochs(runs["nets"] / "port")


def test_facade_refusals(tmp_path):
    """What the facade refuses; SpecAugment, remat, dropout, the transfer load, the
    German configurations, ASG, the raw-wave model and the other activations construct,
    and in one process the facade runs without a mesh, as JAX's does (the mesh routes:
    `tests/test_torch_parallel.py`)."""
    from speechless_tpu_torch.ops.specaugment import SpecAugment
    from speechless_tpu_torch.text.charsets import german_frequent_characters

    chars = english_frequent_characters
    with pytest.raises(ValueError, match="frozen"):
        Wav2Letter(128, chars, frozen_layer_count=3, device="cpu")
    assert Wav2Letter(128, chars, device="cpu").mesh is None
    with pytest.raises(ValueError, match="tp_activation_constraint needs"):
        w2l.Wav2Letter(w2l.Wav2LetterConfig(128, len(chars) + 1,
                                            tp_activation_constraint=True), device="cpu")
    with pytest.raises(ValueError, match="raw-wave"):
        Wav2Letter(1, chars, use_raw_wave_input=True, spec_augment=True, device="cpu")
    with pytest.raises(ValueError, match="requires use_asg"):
        Wav2Letter(128, chars, train_asg_transitions=True, device="cpu")
    asg = Wav2Letter(128, chars, use_asg=True, train_asg_transitions=True, device="cpu")
    assert asg.grapheme_encoding.grapheme_set_size == len(chars) + 2
    assert sorted(asg.params[-1]) == ["asg_initials", "asg_transitions"]
    raw = Wav2Letter(1, chars, use_raw_wave_input=True, activation="elu", device="cpu")
    assert raw.config.layer_names[0] == "wave_conv"
    assert {spec.activation for spec in raw.config.layers[:-1]} == {"elu"}
    trained = Wav2Letter(128, chars, spec_augment=True, remat=True, dropout=0.1, device="cpu")
    assert trained.spec_augment == SpecAugment()
    assert trained.config.remat and trained.config.dropout == 0.1
    assert [spec.dropout_before for spec in trained.config.layers] == [True] * 8 + [False] * 3
    kenlm = tmp_path / "kenlm"
    kenlm.mkdir()
    (kenlm / "vocabulary").write_text("".join(chars).upper()[::-1])
    with pytest.raises(ValueError, match="differ"):
        Wav2Letter(128, chars, kenlm_directory=kenlm, device="cpu")
    directories = DataDirectories(tmp_path)
    assert Configuration.german(directories=directories).allowed_characters \
        == german_frequent_characters
    mixed = Configuration.mixed_german_english(directories)
    assert (mixed.name, mixed.allowed_characters) == ("mixed-English-German",
                                                      german_frequent_characters)


def test_device_resident_refuses(runs):
    """The device-resident path refuses a batch larger than the training corpus (3
    utterances) before it packs anything."""
    with pytest.raises(ValueError, match="exceeds corpus size"):
        runs["config"].train(runs["port"], run_name="x", epoch_limit=1, device_resident=True,
                             batch_size=4)
    assert not (runs["config"].directories.tensorboard_log_base_directory / "x").exists()


@pytest.fixture(scope="module")
def cli_data(tmp_path_factory):
    data = tmp_path_factory.mktemp("cli")
    make_librispeech_tree(data / "corpus" / "English" / "dev-clean",
                          ["hello there", "nice day", "good one"])
    build_kenlm_directory(["hello there", "nice day", "good one"], data / "kenlm" / "english",
                          allowed_characters=english_frequent_characters, order=3)
    yield data
    shutil.rmtree(data)


def test_cli_workflow_on_the_cpu(cli_data, caplog):
    common = ["--config", "minimal_english", "--data-dir", str(cli_data)]
    main(["summarize", *common])
    assert (cli_data / "corpus" / "English" / "corpus.csv").exists()
    assert (cli_data / "corpus" / "English" / "summary.csv").exists()
    main(["fill-cache", *common])
    assert len(list((cli_data / "spectrogram-cache" / "English").glob("*.npy"))) == 3
    main(["train", *common, "--epochs", "1", "--batch-size", "2", "--batches-per-epoch", "2",
          "--clip-norm", "0.5", "--device", "cpu"])
    (run,) = [d.name for d in (cli_data / "nets").iterdir()]
    assert (cli_data / "nets" / run / "weights-epoch1.npz").exists()
    csv_file = cli_data / "sweep.csv"
    main(["validate", *common, "--batch-size", "2", "--run", run, "--csv", str(csv_file),
          "--device", "cpu"])
    lines = csv_file.read_text().strip().splitlines()
    assert len(lines) == 2 and lines[1].startswith("1,")
    for decoder in ([], ["--kenlm", "--beam-width", "8"]):
        caplog.clear()
        main(["test", *common, "--batch-size", "2", "--run", run, "--epoch", "1", *decoder,
              "--device", "cpu"])
        assert "All corpora: Average over" in caplog.text


# The ids are those the cases had when --device-resident, --spec-augment, --remat and
# the German configurations were refused (argv0-2, argv5-6); those cases now check the
# refusals of `average`, of `transfer`'s parser and of the German configuration's test.
@pytest.mark.parametrize("argv, message", [
    (["average", "--run", "r", "--last", "0"], "--last must be >= 1"),
    (["average", "--run", "r", "--epochs", "1", "2", "--write-epoch", "2"], "overwrite"),
    (["average", "--run", "missing"], "no checkpoints under"),
    (["train", "--lr-decay", "cosine"], "--lr-decay requires --lr-decay-steps"),
    (["train", "--lr-decay-steps", "9"], "has no effect without --lr-decay"),
    (["transfer", "--config", "german", "--freeze", "x"], "invalid int value"),
    (["test", "--config", "mixed_german_english", "--run", "r", "--epoch", "1",
      "--beam-width", "8"], "require --kenlm"),
    (["fill-cache", "--config", "nope"], "Unknown configuration"),
    (["test", "--run", "r", "--epoch", "1", "--lm-weight", "2"], "require --kenlm"),
], ids=["argv0---device-resident is not ported", "argv1---spec-augment is not ported",
        "argv2---remat is not ported", "argv3---lr-decay requires --lr-decay-steps",
        "argv4-has no effect without --lr-decay", "argv5-item 9", "argv6-item 9",
        "argv7-Unknown configuration", "argv8-require --kenlm"])
def test_cli_refusals(cli_data, capsys, argv, message):
    with pytest.raises(SystemExit) as raised:
        main([*argv, "--data-dir", str(cli_data)])
    assert message in str(raised.value) + capsys.readouterr().err


@pytest.mark.parametrize("method", ["test_flag_set_without_dying",
                                    "test_second_signal_falls_through_to_previous_handler",
                                    "test_handlers_restored_on_exit"])
def test_graceful_shutdown_copy(monkeypatch, method):
    """The JAX package's `GracefulShutdown` tests, run on the port's copy."""
    import test_preemption
    from speechless_tpu_torch.train.preemption import GracefulShutdown

    monkeypatch.setattr(test_preemption, "GracefulShutdown", GracefulShutdown)
    getattr(test_preemption.TestGracefulShutdown(), method)()


def test_tensorboard_copy(monkeypatch, tmp_path):
    """The JAX package's event-file round trip, run on the port's writer."""
    import test_tensorboard
    from speechless_tpu_torch.utils import tensorboard

    monkeypatch.setattr(test_tensorboard, "SummaryWriter", tensorboard.SummaryWriter)
    monkeypatch.setattr(test_tensorboard, "_masked_crc", tensorboard._masked_crc)
    test_tensorboard.TestSummaryWriter().test_roundtrip(tmp_path)


def test_sigterm_checkpoints_at_the_epoch_end(runs, caplog):
    """A SIGTERM during training (here raised by the batch source) checkpoints the epoch
    in progress at its end and leaves the loop, with no other checkpoint written."""
    import signal

    config = runs["config"]
    source = config.batch_generator.training_batches

    def interrupted():
        for index, batch in enumerate(source()):
            # The prefetch thread draws batch 3 only once the loop has taken batch 0
            # from its queue of 2, so the handler is installed by then.
            if index == 3:
                signal.raise_signal(signal.SIGTERM)
            yield batch

    port = Wav2Letter(128, english_frequent_characters, device="cpu")
    port.train(interrupted(), config.batch_generator.preview_batch(),
               config.directories.tensorboard_log_base_directory / "preempt",
               runs["nets"] / "preempt", batches_per_epoch=2, epoch_limit=3,
               save_step=1000, callback_step=1000)
    assert available_epochs(runs["nets"] / "preempt") == [1]
    assert "Preemption (SIGTERM): checkpointed epoch 1" in caplog.text
