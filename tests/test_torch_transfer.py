"""The port's German corpora and transfer path against the JAX package's on the CPU:
`data/german.py` (the parsers and the mirror override), `remap_output_layer`,
`average_checkpoint_params`, the character-remap transfer load with frozen layers, the
German and mixed configurations' grouped evaluation, and the CLI's ``transfer`` and
``average`` commands.

Tolerances, with their reasons:
* parsed corpora, remapped and averaged parameters, loaded layers, groups and counts:
  equal (both packages do the same host arithmetic in numpy);
* the mixed configuration's grouped LER/WER: equal (the same weights on both facades
  decode the same text); per-utterance losses rtol 1e-4 (fp32 convolutions and CTC sums
  in another order, as in `test_torch_system.py`).
The fresh layers of a ``--reinitialize`` load come from a JAX key on one side and a
`torch.Generator` on the other, so they are held to their shapes and to differing from
the donor, never to each other.
"""
import os
import shutil
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from speechless_tpu.configuration import Configuration as JaxConfiguration
from speechless_tpu.configuration import DataDirectories as JaxDataDirectories
from speechless_tpu.data import LibriSpeechCorpus as JaxLibriSpeechCorpus
from speechless_tpu.data import TrainingTestSplit as JaxTrainingTestSplit
from speechless_tpu.data import german as jax_german
from speechless_tpu.models import wav2letter as jax_w2l
from speechless_tpu.train import checkpoint as jax_checkpoint
from speechless_tpu_torch.__main__ import main
from speechless_tpu_torch.configuration import Configuration, DataDirectories
from speechless_tpu_torch.data import LibriSpeechCorpus, TrainingTestSplit
from speechless_tpu_torch.data import german
from speechless_tpu_torch.models import wav2letter as w2l
from speechless_tpu_torch.system import Wav2Letter
from speechless_tpu_torch.text.charsets import (english_frequent_characters,
                                                german_frequent_characters)
from speechless_tpu_torch.train import checkpoint, trainer

import test_german_corpus as fixtures
from conftest import make_test_wav
from test_corpus import make_librispeech_tree

sys.path.insert(0, str(Path(__file__).resolve().parent.parent / "examples"))
from rehearsal_common import (serve_directory, stage_clarin_archive,  # noqa: E402
                              stage_voxforge_archive)
from torch_tmp import delete_tmp_path  # noqa: E402, F401 (full-width files)

ENGLISH_BASELINE, BASELINE_EPOCH = JaxConfiguration.english_baseline


def _described(corpus):
    """Every example's id, label, positional label and phase, in corpus order."""
    return ([(e.id, e.label, e.positional_label.serialize() if e.positional_label else None,
              e.audio_file.name) for e in corpus.training_examples],
            [(e.id, e.label) for e in corpus.test_examples])


def _clarin_par(base):
    fixtures.make_clarin_tree(base, "corpus-a", {"rec1": ['gr\\"o\\"se', "test"],
                                                 "rec2": ["hallo", "welt"]})
    return "corpus-a", {}


def _clarin_tr2(base):
    session = base / "corpus-b" / "block0" / "ses0"
    session.mkdir(parents=True)
    make_test_wav(session / "rec1.wav", duration_s=1.0)
    (session / "rec1.par").write_text(
        "ORT:\t0\t<usb>\nORT:\t1\twelt\nTR2:\t0\tsomethi~\nTR2:\t1\twelt", encoding="utf8")
    return "corpus-b", {}


def _clarin_alc(base):
    fixtures.make_clarin_tree(base, "all.ALC.fake",
                              {"0061006007_h_00": ["ein", "satz"], "0061006007_m_00": []})
    return "all.ALC.fake", {}


def _clarin_json(base):
    session = base / "corpus-c" / "block0" / "ses0"
    session.mkdir(parents=True)
    make_test_wav(session / "rec1.wav", duration_s=1.0)
    (session / "rec1_annot.json").write_text(
        fixtures.make_annot_json([("hallo", (0, 8000)), ("welt", (8000, 16000))]),
        encoding="utf8")
    return "corpus-c", {}


def _clarin_json_over_par(base):
    session = base / "corpus-d" / "block0" / "ses0"
    session.mkdir(parents=True)
    make_test_wav(session / "rec1.wav", duration_s=1.0)
    (session / "rec1.par").write_text("ORT:\t0\tpar version", encoding="utf8")
    (session / "rec1_annot.json").write_text(
        fixtures.make_annot_json([("json", (0, 8000)), ("version", (8000, 16000))]),
        encoding="utf8")
    return "corpus-d", {}


def _clarin_sc10(base):
    fixtures.make_clarin_tree(base, "all.SC10.fake", {"fiw1e020": ["kaputt"],
                                                      "fiw1e021": ['"ahnlich', 'scho"n']})
    return "all.SC10.fake", {
        "umlaut_decoder": "try_quote_before_umlaut_then_after",
        "id_filter_regex": "sc10_broken_label_filter_regex"}


@pytest.mark.parametrize("make_tree", [_clarin_par, _clarin_tr2, _clarin_alc, _clarin_json,
                                       _clarin_json_over_par, _clarin_sc10])
def test_clarin_parsing_matches_jax(tmp_path, make_tree):
    """The fixtures of `tests/test_german_corpus.py` (and the SC10 filter with the
    try-both umlaut decoder): ids, labels, positional labels and files equal."""
    name, options = make_tree(tmp_path)

    def parsed(package):
        kwargs = {key: getattr(getattr(package, "UmlautDecoder"), value)
                  if key == "umlaut_decoder" else getattr(package, value)
                  for key, value in options.items()}
        return _described(package.GermanClarinCorpus(
            name, tmp_path, base_source_url_or_directory=str(tmp_path) + "/",
            training_test_split=(JaxTrainingTestSplit if package is jax_german
                                 else TrainingTestSplit).training_only, **kwargs))

    got, want = parsed(german), parsed(jax_german)
    assert got == want and got[0]


def test_voxforge_parsing_matches_jax(tmp_path):
    corpus_dir = tmp_path / "german-speechdata-package-v2" / "train"
    corpus_dir.mkdir(parents=True)
    stem = "2015-01-01-10-00-00"
    (corpus_dir / (stem + ".xml")).write_text(
        "<recording><cleaned_sentence>Häuser in Constanța co2</cleaned_sentence>"
        "</recording>", encoding="utf8")
    for mic in ["_Yamaha", "_Realtek"]:
        make_test_wav(corpus_dir / (stem + mic + ".wav"), duration_s=1.0)
    got = _described(german.GermanVoxforgeCorpus(base_directory=tmp_path))
    assert got == _described(jax_german.GermanVoxforgeCorpus(base_directory=tmp_path))
    assert [label for _, label, _, _ in got[0]] == ["häuser in constanta co zwei"] * 2


def test_decoders_filters_and_charset_match_jax():
    for text in ['gr\\"o\\"se', '"a"o"u"s', 'a"o"u"s"', '"aa"', 'x\\"', "plain"]:
        for name in ("none", "quote_before_umlaut", "quote_after_umlaut",
                     "try_quote_before_umlaut_then_after"):
            assert getattr(german.UmlautDecoder, name)(text) \
                == getattr(jax_german.UmlautDecoder, name)(text)
    for name in ("vm1_id_german_filter_regex", "vm2_id_german_filter_regex",
                 "sc10_broken_label_filter_regex"):
        assert getattr(german, name).pattern == getattr(jax_german, name).pattern
    assert german.german_frequent_characters == jax_german.german_frequent_characters
    assert german._tags_to_ignore == jax_german._tags_to_ignore
    assert german.GermanVoxforgeCorpus._broken_ids \
        == jax_german.GermanVoxforgeCorpus._broken_ids


@pytest.fixture(scope="module")
def served(tmp_path_factory):
    """One archive of each layout that `examples/rehearsal_common.py` stages, served on
    localhost through the mirror overrides."""
    work = tmp_path_factory.mktemp("served")
    stage_clarin_archive(work, "all.FAKE.1.cmdi.1.1", utterances=4, seed=71,
                         escape="before", sessions=2, id_prefix="fk", positional_json=True,
                         max_duration_s=2.5)
    stage_clarin_archive(work, "all.ALC.fake.1", utterances=2, seed=72, sessions=2,
                         alc_pairs=True, max_duration_s=2.5)
    stage_voxforge_archive(work, prompts=4, seed=73, train_share=0.5, max_duration_s=2.5)
    server, url = serve_directory(work / "serve")
    saved = {key: os.environ.get(key) for key in ("SPEECHLESS_CLARIN_URL",
                                                  "SPEECHLESS_VOXFORGE_URL")}
    os.environ.update(SPEECHLESS_CLARIN_URL=url, SPEECHLESS_VOXFORGE_URL=url)
    try:
        yield work
    finally:
        server.shutdown()
        for key, value in saved.items():
            if value is None:
                os.environ.pop(key, None)
            else:
                os.environ[key] = value


@pytest.mark.parametrize("corpus_name", ["all.FAKE.1.cmdi.1.1", "all.ALC.fake.1",
                                         "german-speechdata-package-v2"])
def test_fetched_archives_parse_as_in_jax(served, corpus_name):
    """Each package fetches the archive over HTTP into its own directory, untars it and
    parses it: the same examples, labels and positional labels."""
    def parsed(package, base):
        if corpus_name.startswith("german"):
            return _described(package.GermanVoxforgeCorpus(base_directory=base))
        split = (JaxTrainingTestSplit if package is jax_german else TrainingTestSplit)
        return _described(package.GermanClarinCorpus(corpus_name, base,
                                                     training_test_split=split.training_only))

    got = parsed(german, served / "port" / corpus_name)
    assert (served / "port" / corpus_name).is_dir()
    assert got == parsed(jax_german, served / "jax" / corpus_name)
    assert len(got[0]) + len(got[1]) >= 4
    if corpus_name == "all.FAKE.1.cmdi.1.1":
        assert all(positional is not None for _, _, positional, _ in got[0])


@pytest.mark.parametrize("source, target", [
    (english_frequent_characters, german_frequent_characters),
    (german_frequent_characters, english_frequent_characters),
    (english_frequent_characters, list("zyx '")),
])
def test_remap_output_layer_matches_jax(source, target):
    rng = np.random.default_rng(3)
    layer = {"w": rng.normal(size=(1, 7, len(source) + 1)).astype(np.float32),
             "b": rng.normal(size=(len(source) + 1,)).astype(np.float32)}
    got = w2l.remap_output_layer(layer, source, target)
    want = jax_w2l.remap_output_layer({k: jnp.asarray(v) for k, v in layer.items()},
                                      source, target)
    for key in ("w", "b"):
        assert got[key].dtype == np.float32
        np.testing.assert_array_equal(got[key], np.asarray(want[key]))
    assert w2l.character_remap_indices(source, target) \
        == jax_w2l.character_remap_indices(source, target)
    with pytest.raises(ValueError, match="Duplicate"):
        w2l.character_remap_indices(["a", "a"], target)


def _narrow_config(classes=len(english_frequent_characters) + 1):
    return w2l.Wav2LetterConfig(8, classes, layers=(
        w2l.ConvSpec("striding_conv", 6, 4, 2), w2l.ConvSpec("inner_conv_1", 5, 3, 1),
        w2l.ConvSpec("big_conv_1", 7, 3, 1), w2l.ConvSpec("output_conv", classes, 1, 1,
                                                          "linear")))


def test_average_checkpoint_params_matches_jax(tmp_path):
    config = _narrow_config()
    for epoch in (1, 2, 3):
        checkpoint.save_checkpoint(tmp_path, epoch, w2l.init_params(config, seed=epoch))
    got = checkpoint.average_checkpoint_params(tmp_path, [1, 2, 3])
    want = jax_checkpoint.average_checkpoint_params(tmp_path, [1, 2, 3])
    for layer, reference in zip(got, want):
        for key in ("w", "b"):
            assert layer[key].dtype == np.float32
            np.testing.assert_array_equal(layer[key], np.asarray(reference[key]))


def test_average_checkpoint_params_refuses_like_jax(tmp_path):
    config = _narrow_config()
    checkpoint.save_checkpoint(tmp_path, 1, w2l.init_params(config, seed=1))
    with_asg = w2l.init_params(config, seed=2) + [{"asg_transitions": np.zeros((5, 5)),
                                                   "asg_initials": np.zeros(5)}]
    checkpoint.save_checkpoint(tmp_path, 2, with_asg)
    wider = w2l.init_params(_narrow_config(classes=9), seed=3)
    checkpoint.save_checkpoint(tmp_path, 3, wider)
    for epochs, message in (([1, 2], "cannot be averaged"), ([], "at least one"),
                            ([1, 3], "has shape")):
        for average in (checkpoint.average_checkpoint_params,
                        jax_checkpoint.average_checkpoint_params):
            with pytest.raises(ValueError, match=message):
                average(tmp_path, epochs)


@pytest.mark.parametrize("loaded_first_layers_count", [None, 2])
def test_load_with_character_remap_matches_jax(tmp_path, loaded_first_layers_count):
    source_config = _narrow_config()
    target_config = _narrow_config(len(german_frequent_characters) + 1)
    donor = w2l.init_params(source_config, seed=4)
    checkpoint.save_checkpoint(tmp_path, 7, donor)
    got = checkpoint.load_params_with_character_remap(
        tmp_path, 7, english_frequent_characters, german_frequent_characters, target_config,
        loaded_first_layers_count=loaded_first_layers_count,
        init_generator=torch.Generator().manual_seed(1))
    jax_target = jax_w2l.Wav2LetterConfig(8, target_config.grapheme_set_size, layers=tuple(
        jax_w2l.ConvSpec(s.name, s.filters, s.kernel_size, s.stride, s.activation)
        for s in target_config.layers))
    want = jax_checkpoint.load_params_with_character_remap(
        tmp_path, 7, english_frequent_characters, german_frequent_characters, jax_target,
        loaded_first_layers_count=loaded_first_layers_count)
    loaded = len(donor) if loaded_first_layers_count is None else loaded_first_layers_count
    for index, (layer, reference) in enumerate(zip(got, want)):
        for key in ("w", "b"):
            assert layer[key].shape == np.asarray(reference[key]).shape
            if index < loaded:
                np.testing.assert_array_equal(layer[key], np.asarray(reference[key]))
            elif key == "w":
                assert not np.array_equal(layer[key], np.asarray(reference[key]))
    if loaded_first_layers_count is not None:
        assert not np.array_equal(got[2]["w"], donor[2]["w"])
        again = checkpoint.load_params_with_character_remap(
            tmp_path, 7, english_frequent_characters, german_frequent_characters,
            target_config, loaded_first_layers_count=2,
            init_generator=torch.Generator().manual_seed(1))
        np.testing.assert_array_equal(again[3]["w"], got[3]["w"])


@pytest.fixture(scope="module")
def donor(tmp_path_factory):
    """A full-width English checkpoint at the baseline run's name and epoch."""
    data = tmp_path_factory.mktemp("donor")
    nets = DataDirectories(data).nets_base_directory / ENGLISH_BASELINE
    Wav2Letter(128, english_frequent_characters, seed=3, device="cpu").save(nets,
                                                                              BASELINE_EPOCH)
    yield data, checkpoint.load_params(nets, BASELINE_EPOCH)
    shutil.rmtree(data)  # full-width checkpoints: 280 MB each


def test_transfer_load_matches_jax_and_freezes(donor):
    """`Configuration.load_best_english_model(frozen_layer_count=8)` on both facades:
    every loaded layer bitwise equal to JAX's, the output layer the donor's remapped;
    two updates leave layers 0-7 bitwise the donor's and compute no gradient there."""
    data, donor_params = donor
    config = Configuration.german(directories=DataDirectories(data))
    jax_config = JaxConfiguration.german(directories=JaxDataDirectories(data))
    port = config.load_best_english_model(frozen_layer_count=8, device="cpu")
    jax_facade = jax_config.load_best_english_model(frozen_layer_count=8)
    for layer, reference in zip(port.params, jax_facade.params):
        for key in ("w", "b"):
            np.testing.assert_array_equal(layer[key], np.asarray(reference[key]))
    remapped = w2l.remap_output_layer(donor_params[-1], english_frequent_characters,
                                      german_frequent_characters)
    np.testing.assert_array_equal(port.params[-1]["w"], remapped["w"])
    assert port.state.step == 0 and port.state.opt_state.updates == 0

    rng = np.random.default_rng(5)
    step = trainer.make_train_step(port.config, port.optimizer, device="cpu")
    for _ in range(2):
        port.state, metrics = step(port.state, trainer.Batch(
            rng.normal(size=(2, 64, 128)).astype(np.float32), np.array([64, 50], np.int32),
            np.array([[0, 29, 3], [30, 31, -1]], np.int32), np.array([3, 2], np.int32)))
        assert np.isfinite(float(metrics["loss"]))
    trained = port.params
    for index in range(8):
        for key in ("w", "b"):
            np.testing.assert_array_equal(trained[index][key], donor_params[index][key])
    assert not np.array_equal(trained[-1]["w"], remapped["w"])
    frozen = [conv.weight.requires_grad for conv in port.state.model.layers]
    assert frozen == [False] * 8 + [True] * 3


def test_reinitialize_and_german_model_loads(donor):
    data, donor_params = donor
    config = Configuration.german(directories=DataDirectories(data))
    fresh = config.load_best_english_model(frozen_layer_count=8,
                                           reinitialize_trainable_loaded_layers=True,
                                           device="cpu")
    for index, (layer, reference) in enumerate(zip(fresh.params, donor_params)):
        if index < 8:
            np.testing.assert_array_equal(layer["w"], reference["w"])
        else:
            assert not np.array_equal(layer["w"][..., :28], reference["w"][..., :28])
    nets = config.directories.nets_base_directory
    fresh.save(nets / "german-run", 3)
    loaded = config.load_german_model("german-run", 3, device="cpu")
    for layer, reference in zip(loaded.params, fresh.params):
        np.testing.assert_array_equal(layer["w"], reference["w"])
    assert loaded.state.step == 0  # a load through the remap starts the optimizer fresh


@pytest.fixture(scope="module")
def mixed(tmp_path_factory):
    """English dev-clean and a German corpus saved as ``corpus/German/corpus.csv``, and
    a German-charset checkpoint."""
    data = tmp_path_factory.mktemp("mixed")
    make_librispeech_tree(data / "corpus" / "English" / "dev-clean",
                          ["hello there", "nice day"])
    make_librispeech_tree(data / "corpus" / "German" / "source",
                          ["grüße aus köln", "schöne straße", "über alles"],
                          depth_dirs=("de", "33", "44"))
    source = LibriSpeechCorpus(data / "corpus" / "German", "source",
                               allowed_characters=german_frequent_characters,
                               training_test_split=TrainingTestSplit.overfit(2))
    source.save(data / "corpus" / "German" / "corpus.csv")
    Wav2Letter(128, german_frequent_characters, seed=5, device="cpu").save(
        DataDirectories(data).nets_base_directory / "german", 1)
    yield data
    shutil.rmtree(data)  # full-width checkpoints


@pytest.fixture
def one_english_set(monkeypatch):
    """`Configuration.english` of both packages as dev-clean alone, one utterance held
    out (the configuration's full LibriSpeech sets would download)."""
    for configuration, corpus, split in (
            (Configuration, LibriSpeechCorpus, TrainingTestSplit),
            (JaxConfiguration, JaxLibriSpeechCorpus, JaxTrainingTestSplit)):
        def english(directories=None, configuration=configuration, corpus=corpus,
                    split=split):
            return configuration(name="English", directories=directories,
                                 corpus_from_directory=lambda d: corpus(
                                     d, "dev-clean", training_test_split=split.overfit(1)))

        monkeypatch.setattr(configuration, "english", staticmethod(english))


def test_mixed_grouped_evaluation_matches_jax(mixed, one_english_set):
    """`test_model_grouped_by_loaded_corpus_name` on the mixed configuration: its
    examples lie outside its own corpus directory, so both packages group them by
    language directory, with the same counts, predictions and LER/WER."""
    config = Configuration.mixed_german_english(DataDirectories(mixed))
    jax_config = JaxConfiguration.mixed_german_english(JaxDataDirectories(mixed))
    got = config.test_model_grouped_by_loaded_corpus_name(
        config.load_model("german", 1, allowed_characters_for_loaded_model=None,
                          device="cpu"))
    want = jax_config.test_model_grouped_by_loaded_corpus_name(
        jax_config.load_model("german", 1, allowed_characters_for_loaded_model=None))
    assert list(got.result_batches_by_group_name) \
        == list(want.result_batches_by_group_name) == ["English", "German"]
    for name, batches in want.result_batches_by_group_name.items():
        mine = got.result_batches_by_group_name[name]
        assert [r.predicted for r in mine.results] == [r.predicted for r in batches.results]
        assert [r.expected for r in mine.results] == [r.expected for r in batches.results]
        np.testing.assert_allclose([r.loss for r in mine.results],
                                   [r.loss for r in batches.results], rtol=1e-4)
    assert (got.average_letter_error_rate, got.average_word_error_rate) \
        == (want.average_letter_error_rate, want.average_word_error_rate)
    assert [len(batches.results) for batches in got.result_batches_by_group_name.values()] \
        == [1, 1]
    assert len(config.corpus.examples) == len(jax_config.corpus.examples) == 5


def test_summarize_the_german_and_mixed_configurations(mixed, one_english_set):
    """The JAX package's ``summarize`` fails on both configurations (ROADMAP.md §3): a
    corpus loaded from ``corpus.csv`` has no summary, and the mixed configuration's
    directory does not exist and holds none of its audio. The port summarizes both and
    saves a ``corpus.csv`` that loads back to the same examples."""
    from speechless_tpu_torch.data.corpus import Corpus

    directories, jax_directories = DataDirectories(mixed), JaxDataDirectories(mixed)
    with pytest.raises(NotImplementedError):
        JaxConfiguration.german(directories=jax_directories).summarize_and_save_corpus()
    with pytest.raises(NotImplementedError):
        JaxConfiguration.mixed_german_english(jax_directories).summarize_and_save_corpus()
    for config in (Configuration.german(directories=directories),
                   Configuration.mixed_german_english(directories)):
        config.summarize_and_save_corpus()
        saved = Corpus.load(config.corpus_directory / "corpus.csv")
        assert [(e.id, e.label, e.audio_file.resolve()) for e in saved.examples] \
            == [(e.id, e.label, e.audio_file.resolve()) for e in config.corpus.examples]
        assert all(e.audio_file.exists() for e in saved.examples)
    assert len(saved.examples) == 5
    summary = Configuration.mixed_german_english(directories).corpus.summary()
    assert "3 examples, 2 training, 1 test" in summary and "5 total, 3 training, 2 test" \
        in summary


def test_transfer_cli_trains_with_frozen_layers(donor):
    """``transfer --config german --freeze 8`` on the CPU: the run continues the donor's
    epoch numbering, K1 and the backward run each step, and layers 0-7 of the written
    checkpoint are the donor's, bitwise."""
    data, donor_params = donor
    make_librispeech_tree(data / "corpus" / "German" / "source", ["grüße aus köln", "ja"])
    LibriSpeechCorpus(data / "corpus" / "German", "source",
                      allowed_characters=german_frequent_characters,
                      training_test_split=TrainingTestSplit.overfit(1)).save(
        data / "corpus" / "German" / "corpus.csv")
    main(["transfer", "--config", "german", "--data-dir", str(data), "--freeze", "8",
          "--epochs", str(BASELINE_EPOCH + 1), "--batch-size", "1", "--batches-per-epoch",
          "1", "--device", "cpu"])
    (run,) = [d for d in (data / "nets").iterdir() if "transfer" in d.name]
    assert run.name.endswith("-transfer-to-German-freeze-8")
    params = checkpoint.load_params(run, BASELINE_EPOCH + 1)
    for index in range(8):
        np.testing.assert_array_equal(params[index]["w"], donor_params[index]["w"])
    assert checkpoint.load_step(run, BASELINE_EPOCH + 1) == 1
    # Evaluating the run loads it with every layer trainable: its optimizer state (3
    # trainable layers) does not fit and is ignored, as the JAX facade ignores it.
    config = Configuration.german(directories=DataDirectories(data))
    loaded = config.load_model(run.name, BASELINE_EPOCH + 1,
                               allowed_characters_for_loaded_model=None, device="cpu")
    jax_loaded = JaxConfiguration.german(directories=JaxDataDirectories(data)).load_model(
        run.name, BASELINE_EPOCH + 1, allowed_characters_for_loaded_model=None)
    assert loaded.state.step == int(jax_loaded.state.step) == 1
    assert loaded.state.opt_state.updates == 0
    with pytest.raises(ValueError, match="leaves"):
        checkpoint.load_opt_state(run, BASELINE_EPOCH + 1, loaded.state.opt_state)


def test_transfer_cli_routes_its_flags(tmp_path, monkeypatch):
    captured = {}
    monkeypatch.setattr(Configuration, "train_transfer_from_best_english_model",
                        lambda self, **kwargs: captured.update(kwargs))
    main(["transfer", "--config", "minimal_english", "--data-dir", str(tmp_path),
          "--freeze", "8", "--reinitialize", "--spec-augment", "--clip-norm", "1.0",
          "--epochs", "3", "--device", "cpu"])
    assert captured == {"frozen_layer_count": 8, "reinitialize_trainable_loaded_layers": True,
                        "epoch_limit": 3, "wav2letter_kwargs": {
                            "device": "cpu", "spec_augment": True, "gradient_clip_norm": 1.0}}


def test_average_cli_writes_a_loadable_checkpoint(tmp_path):
    config = w2l.Wav2LetterConfig(128, len(english_frequent_characters) + 1)
    run = tmp_path / "nets" / "r"
    for epoch in (1, 2, 3, 4):
        checkpoint.save_checkpoint(run, epoch, [
            {k: v[..., :3] if k == "w" else v for k, v in layer.items()}
            for layer in w2l.init_params(config, seed=epoch)[:1]])
    main(["average", "--data-dir", str(tmp_path), "--run", "r", "--last", "3"])
    averaged = checkpoint.load_params(run, 1004)
    want = jax_checkpoint.average_checkpoint_params(run, [2, 3, 4])
    np.testing.assert_array_equal(averaged[0]["w"], np.asarray(want[0]["w"]))
    for argv, message in ((["--epochs", "2", "3", "--write-epoch", "3"], "overwrite"),
                          (["--last", "0"], "--last must be >= 1")):
        with pytest.raises(SystemExit, match=message):
            main(["average", "--data-dir", str(tmp_path), "--run", "r", *argv])
    with pytest.raises(SystemExit, match="no checkpoints"):
        main(["average", "--data-dir", str(tmp_path), "--run", "missing"])
