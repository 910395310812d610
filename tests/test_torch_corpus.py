"""The port's corpus pipeline (`speechless_tpu_torch.data`, `features/example.py`, the numpy
host path of `features/spectrogram.py`) against the JAX package's on the CPU.

Tolerances: none where both packages compute the same thing: corpus ids, labels, splits,
summaries and CSV files are equal, synthetic corpora byte-equal, the numpy spectrogram
and every batch array bitwise equal, and a cache entry written by either package reads
back in the other unchanged. Against the golden references of `tests/test_spectrogram.py`
and `tests/test_golden_dsp.py` the port is held to those files' own tolerances (the
numpy path; and `features_batch` on CPU tensors at their 2e-3, fp32 DFT-by-matmul
against the float64 FFT).
"""
import random

import numpy as np
import pytest
import torch

import test_golden_dsp
import test_spectrogram
from speechless_tpu.data import batching as jax_batching
from speechless_tpu.data import corpus as jax_corpus
from speechless_tpu.data import librispeech as jax_librispeech
from speechless_tpu.data import synthetic as jax_synthetic
from speechless_tpu.features import example as jax_example
from speechless_tpu.features import spectrogram as jax_sg
from speechless_tpu.text.graphemes import CtcGraphemeCodec as JaxCodec
from speechless_tpu_torch.data import batching, corpus, librispeech, synthetic
from speechless_tpu_torch.features import example
from speechless_tpu_torch.features import spectrogram as sg
from speechless_tpu_torch.text.graphemes import CtcGraphemeCodec

from test_corpus import make_librispeech_tree

TEXTS = ["Hello  World", "it's a test", "third one", "a b c d", "zebra", "", "yes no"]


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    root = tmp_path_factory.mktemp("corpus")
    make_librispeech_tree(root / "mini", TEXTS[:4])
    make_librispeech_tree(root / "mini", TEXTS[4:], depth_dirs=("dc", "33", "44"))
    return root


SPLITS = {
    "training_only": lambda m: m.TrainingTestSplit.training_only,
    "test_only": lambda m: m.TrainingTestSplit.test_only,
    "randomly": lambda m: m.TrainingTestSplit.randomly(0.5),
    "by_directory_group": lambda m: m.TrainingTestSplit.randomly_grouped_by_directory(0.5),
    "overfit": lambda m: m.TrainingTestSplit.overfit(2),
    "by_directory": lambda m: m.TrainingTestSplit.by_directory("22"),
}


def _corpora(tree, split):
    return (jax_librispeech.LibriSpeechCorpus(
                base_directory=tree, corpus_name="mini",
                training_test_split=SPLITS[split](jax_corpus), maximum_example_duration_in_s=5,
                minimum_duration_per_character=0.02),
            librispeech.LibriSpeechCorpus(
                base_directory=tree, corpus_name="mini",
                training_test_split=SPLITS[split](corpus), maximum_example_duration_in_s=5,
                minimum_duration_per_character=0.02))


def _examples(examples):
    return [(e.id, e.label, str(e.audio_file), e.duration_in_s) for e in examples]


@pytest.mark.parametrize("split", sorted(SPLITS))
def test_parsing_and_splits_match(tree, tmp_path, split):
    theirs, ours = _corpora(tree, split)
    assert _examples(ours.training_examples) == _examples(theirs.training_examples)
    assert _examples(ours.test_examples) == _examples(theirs.test_examples)
    assert ours.summary() == theirs.summary()
    assert [str(v) for v in ours.csv_rows()[0]] == [str(v) for v in theirs.csv_rows()[0]]
    for name in ("audio_ids_without_label", "label_ids_without_audio", "filtered_out_count"):
        assert getattr(ours, name) == getattr(theirs, name)
    assert [e.id for e in ours.too_short_examples] == [e.id for e in theirs.too_short_examples]
    assert [e.id for e in ours.empty_examples] == [e.id for e in theirs.empty_examples]

    # CSV files byte-equal, and each package loads the other's.
    for package, instance in (("jax", theirs), ("port", ours)):
        instance.save(tree / "mini" / "{}-{}.csv".format(split, package))
        instance.summarize_to_csv(tmp_path / "{}-summary.csv".format(package))
    assert (tree / "mini" / "{}-port.csv".format(split)).read_bytes() \
        == (tree / "mini" / "{}-jax.csv".format(split)).read_bytes()
    assert (tmp_path / "port-summary.csv").read_bytes() \
        == (tmp_path / "jax-summary.csv").read_bytes()
    loaded = corpus.Corpus.load(tree / "mini" / "{}-jax.csv".format(split))
    reloaded = jax_corpus.Corpus.load(tree / "mini" / "{}-port.csv".format(split))
    assert _examples(loaded.training_examples) == _examples(reloaded.training_examples) \
        == _examples(theirs.training_examples)
    assert _examples(loaded.test_examples) == _examples(theirs.test_examples)


def test_composed_grouped_and_sampled(tree):
    jax_a, port_a = _corpora(tree, "training_only")
    jax_b, port_b = _corpora(tree, "by_directory")
    theirs, ours = jax_corpus.ComposedCorpus([jax_a]), corpus.ComposedCorpus([port_a])
    assert ours.summary() == theirs.summary()
    assert [str(row) for row in ours.csv_rows()] == [str(row) for row in theirs.csv_rows()]
    key = lambda e: e.audio_directory.name
    assert {k: _examples(c.training_examples) for k, c in ours.grouped_by(key).items()} \
        == {k: _examples(c.training_examples) for k, c in theirs.grouped_by(key).items()}
    sampled = corpus.Corpus(port_b.training_examples, port_b.test_examples,
                            sampled_training_example_count=2)
    jax_sampled = jax_corpus.Corpus(jax_b.training_examples, jax_b.test_examples,
                                    sampled_training_example_count=2)
    assert _examples(sampled.training_examples) == _examples(jax_sampled.training_examples)
    with pytest.raises(ValueError, match="Overlapping"):
        corpus.Corpus(port_a.training_examples, port_a.training_examples[:1])


@pytest.mark.parametrize("difficulty, count, seed", [("standard", 6, 3), ("hard", 3, 5)])
def test_generate_corpus_is_byte_equal(tmp_path, difficulty, count, seed):
    kwargs = dict(utterance_count=count, speaker_count=2, min_duration_s=0.4,
                  max_duration_s=1.0, seed=seed, difficulty=difficulty)
    theirs = jax_synthetic.generate_corpus(tmp_path / "jax", "synthetic", **kwargs)
    ours = synthetic.generate_corpus(tmp_path / "port", "synthetic", **kwargs)
    files = sorted(p.relative_to(theirs) for p in theirs.rglob("*") if p.is_file())
    assert files == sorted(p.relative_to(ours) for p in ours.rglob("*") if p.is_file())
    assert len([f for f in files if f.suffix == ".wav"]) == count
    for name in files:
        assert (ours / name).read_bytes() == (theirs / name).read_bytes(), name
    # A second call with the same signature reuses the tree.
    before = (ours / files[0]).stat().st_mtime_ns
    synthetic.generate_corpus(tmp_path / "port", "synthetic", **kwargs)
    assert (ours / files[0]).stat().st_mtime_ns == before


def _wavs():
    rand = np.random.RandomState(11)
    t = np.arange(16000 * 2 + 731) / 16000.0
    yield (0.3 * np.sin(2 * np.pi * 523.0 * t) + 0.02 * rand.randn(len(t))).astype(np.float32)
    for length in (150, 200, 257, 300, 4096):
        yield (rand.randn(length) * 0.3).astype(np.float32)
    yield np.zeros(16000, np.float32)


def test_numpy_spectrogram_is_bitwise_equal():
    assert np.array_equal(sg.mel_filterbank(), jax_sg.mel_filterbank())
    assert np.array_equal(sg.mel_frequencies(130), jax_sg.mel_frequencies(130))
    for wav in _wavs():
        assert np.array_equal(sg.stft_numpy(wav), jax_sg.stft_numpy(wav))
        for name in ("power_level_spectrogram", "amplitude_spectrogram"):
            assert np.array_equal(getattr(sg, name)(wav), getattr(jax_sg, name)(wav)), name
        ours = sg.z_normalized_transposed_spectrogram(wav)
        theirs = jax_sg.z_normalized_transposed_spectrogram(wav)
        assert ours.dtype == theirs.dtype == np.float32
        assert np.array_equal(ours, theirs)
    level = sg.power_level_spectrogram(next(_wavs()))
    assert np.array_equal(sg.to_mel_scale(level), jax_sg.to_mel_scale(level))


GOLDEN = [
    (test_golden_dsp.TestAnalyticStft, "test_impulse_frames_equal_window_samples", ()),
    (test_golden_dsp.TestAnalyticStft, "test_bin_centered_cosine_peak_and_sidebins", ()),
    (test_golden_dsp.TestSlaneyConstants, "test_linear_region_weight", ()),
    (test_golden_dsp.TestSlaneyConstants, "test_mid_filter_weight", ()),
    (test_golden_dsp.TestSlaneyConstants, "test_log_region_weight", ()),
    (test_golden_dsp.TestSlaneyConstants, "test_scale_anchors", ()),
    (test_golden_dsp.TestScipyCrossCheck, "test_stft_matches_scipy", ()),
    (test_spectrogram.TestMelFilterbank, "test_matches_golden", ()),
    (test_spectrogram.TestMelFilterbank, "test_shape_and_range", ()),
    (test_spectrogram.TestStft, "test_numpy_stft_matches_golden_power", ("wav",)),
    (test_spectrogram.TestStft, "test_frame_count", ("wav",)),
    (test_spectrogram.TestFusedFeatures, "test_matches_golden", ("wav",)),
]


@pytest.fixture(scope="module")
def golden_wav():
    """`tests/test_spectrogram.py`'s signal: two tones and noise, not hop-aligned."""
    rand = np.random.RandomState(7)
    t = np.arange(16000 * 2 + 731) / 16000.0
    return (0.3 * np.sin(2 * np.pi * 523.0 * t) + 0.1 * np.sin(2 * np.pi * 2000.0 * t)
            + 0.02 * rand.randn(len(t))).astype(np.float32)


@pytest.mark.parametrize("cls, method, needs", GOLDEN,
                         ids=["{}.{}".format(c.__name__, m) for c, m, _ in GOLDEN])
def test_golden_vectors_hold_for_the_port(monkeypatch, golden_wav, cls, method, needs):
    """The numpy golden tests of the JAX package, run against the port's module."""
    monkeypatch.setattr(test_golden_dsp, "sg", sg)
    monkeypatch.setattr(test_spectrogram, "sg", sg)
    getattr(cls(), method)(*[golden_wav for _ in needs])


def test_features_batch_holds_to_the_golden_features(golden_wav):
    """`features_batch` on CPU tensors (ROADMAP item [2]): each row against the golden
    chain and against the numpy host path, at `test_spectrogram.py`'s 2e-3."""
    wav = golden_wav
    lengths = np.array([len(wav), len(wav) - 5000, 200], dtype=np.int32)
    batch = np.zeros((3, ((len(wav) + 1023) // 1024) * 1024), dtype=np.float32)
    for i, length in enumerate(lengths):
        batch[i, :length] = wav[:length]
    features, counts = sg.features_batch(torch.from_numpy(batch), torch.from_numpy(lengths))
    features, counts = features.numpy(), counts.numpy()
    golden = test_spectrogram.golden_features(wav.astype(np.float64))
    np.testing.assert_allclose(features[0, :counts[0]], golden, atol=2e-3)
    for i, length in enumerate(lengths):
        host = sg.z_normalized_transposed_spectrogram(wav[:length])
        assert counts[i] == host.shape[0] == sg.frame_count(int(length))
        np.testing.assert_allclose(features[i, :counts[i]], host, atol=2e-3)
        assert not features[i, counts[i]:].any()


def _cached(module, tree, cache, example_id):
    (audio,) = list(tree.rglob(example_id + ".wav"))
    original = module.LabeledExampleFromFile(audio, label="x")
    return module.CachedLabeledSpectrogram(original, spectrogram_cache_directory=cache)


def test_cache_entries_cross_read(tree, tmp_path):
    """Each package reads the other's cache entries (same names and format) without
    recomputing them, and recomputes equal features."""
    for writer, reader, cache in ((jax_example, example, tmp_path / "a"),
                                  (example, jax_example, tmp_path / "b")):
        cache.mkdir()
        for example_id in ("11-22-0000", "33-44-0001"):
            written = _cached(writer, tree, cache, example_id)
            features = written.z_normalized_transposed_spectrogram()
            assert written.is_cached()
            read = _cached(reader, tree, cache, written.id)
            assert read.spectrogram_cache_file == written.spectrogram_cache_file
            assert read.is_cached()
            read.original.get_raw_audio = None  # a recompute would fail
            assert np.array_equal(read.z_normalized_transposed_spectrogram(), features)
    for name in ("11-22-0000.npy", "33-44-0001.npy"):
        assert (tmp_path / "a" / name).read_bytes() == (tmp_path / "b" / name).read_bytes()


def test_fill_cache_and_repair(tree, tmp_path):
    """The port's spawned cache fill writes the JAX package's entries; the repair sweep
    quarantines a corrupted entry and restores it."""
    theirs, ours = _corpora(tree, "training_only")
    generator = batching.LabeledSpectrogramBatchGenerator(ours, tmp_path / "port", 2)
    jax_generator = jax_batching.LabeledSpectrogramBatchGenerator(theirs, tmp_path / "jax", 2)
    generator.fill_cache()
    for spectrogram in jax_generator.labeled_spectrograms:
        spectrogram.z_normalized_transposed_spectrogram()
    names = sorted(p.name for p in (tmp_path / "jax").glob("*.npy"))
    assert names == sorted(p.name for p in (tmp_path / "port").glob("*.npy"))
    assert len(names) == len(ours.examples)
    for name in names:
        assert (tmp_path / "port" / name).read_bytes() == (tmp_path / "jax" / name).read_bytes()
    target = generator.labeled_spectrograms[0]
    good = target.z_normalized_transposed_spectrogram()
    np.save(str(target.spectrogram_cache_file), np.zeros_like(good))
    generator.fill_cache(repair_incorrect=True)
    assert (tmp_path / "port-incorrect" / target.spectrogram_cache_file.name).exists()
    assert np.array_equal(target.z_normalized_transposed_spectrogram(), good)


@pytest.mark.parametrize("bucketed", [False, True])
def test_batches_match(tree, tmp_path, bucketed):
    theirs, ours = _corpora(tree, "training_only")
    generator = batching.LabeledSpectrogramBatchGenerator(
        ours, tmp_path / "cache", 2, bucket_training_batches=bucketed)
    jax_generator = jax_batching.LabeledSpectrogramBatchGenerator(
        theirs, tmp_path / "cache", 2, bucket_training_batches=bucketed)
    assert [s.id for s in generator.preview_batch()] \
        == [s.id for s in jax_generator.preview_batch()]
    assert [[s.id for s in b] for b in generator.test_batches()] \
        == [[s.id for s in b] for b in jax_generator.test_batches()]
    draws = {}
    for name, source in (("port", generator), ("jax", jax_generator)):
        random.seed(3)
        batches = source.training_batches()
        draws[name] = [[s.id for s in next(batches)] for _ in range(6)]
    assert draws["port"] == draws["jax"]

    codec, jax_codec = CtcGraphemeCodec(list("abcdefghijklmnopqrstuvwxyz '")), \
        JaxCodec(list("abcdefghijklmnopqrstuvwxyz '"))
    group = [generator.labeled_training_spectrograms[i:i + 2] for i in (0, 2)]
    jax_group = [jax_generator.labeled_training_spectrograms[i:i + 2] for i in (0, 2)]
    ours_batches = [batching.batch_from_spectrograms(b, codec) for b in group]
    theirs_batches = [jax_batching.batch_from_spectrograms(b, jax_codec) for b in jax_group]
    for (mine, labels), (want, want_labels) in zip(ours_batches, theirs_batches):
        assert labels == want_labels
        for field in ("inputs", "input_lengths", "labels", "label_lengths"):
            a, b = getattr(mine, field), np.asarray(getattr(want, field))
            assert a.dtype == b.dtype and np.array_equal(a, b), field
    stacked = batching.stack_batches([b for b, _ in ours_batches])
    jax_stacked = jax_batching.stack_batches([b for b, _ in theirs_batches])
    for a, b in zip(stacked, jax_stacked):
        assert np.array_equal(a, np.asarray(b))
    for length in (1, 128, 129, 4096, 4097, 9000):
        assert batching.bucket_length(length) == jax_batching.bucket_length(length)
    assert list(batching.chunked(iter(range(7)), 3)) == list(jax_batching.chunked(iter(range(7)), 3))


def test_prefetcher_surfaces_errors():
    def prepare(item):
        if item == 2:
            raise RuntimeError("bad item")
        return item * 10

    with batching.Prefetcher(iter(range(5)), prepare) as prefetched:
        assert next(prefetched) == 0 and next(prefetched) == 10
        with pytest.raises(RuntimeError, match="bad item"):
            next(prefetched)
