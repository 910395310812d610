"""FLAC input in the port: `speechless_tpu_torch/native/flac.cpp` (the port's copy of the
JAX package's decoder, built by the port's g++ loader), the FLAC entries of
`features/audio_io.py` and the port's copy of the pure-Python encoder, held against the
JAX package's decoder, encoder and `audio_io` on the same files. Decoded samples are
compared bitwise; durations and rates exactly.
"""
import numpy as np
import pytest

from speechless_tpu.data import corpus as jax_corpus
from speechless_tpu.data import librispeech as jax_librispeech
from speechless_tpu.features import audio_io as jax_audio_io
from speechless_tpu.features.flac_encoder import encode_flac as jax_encode_flac
from speechless_tpu.native import _native as jax_native
from speechless_tpu_torch.data import corpus, librispeech
from speechless_tpu_torch.features import audio_io
from speechless_tpu_torch.features.flac_encoder import encode_flac
from speechless_tpu_torch.native import library


def int16_wave(n, seed=0, amplitude=8000):
    rand = np.random.RandomState(seed)
    t = np.arange(n)
    wave = (amplitude * np.sin(2 * np.pi * 440 * t / 16000) + 200 * rand.randn(n))
    return np.clip(wave.astype(np.int64), -32768, 32767).tolist()


CASES = {
    "mono_verbatim": dict(channels=1, mode="verbatim"),
    "mono_constant": dict(channels=1, mode="constant"),
    "mono_fixed2": dict(channels=1, mode="fixed2"),
    "stereo_downmix": dict(channels=2, mode="fixed1"),
    "multiframe": dict(channels=1, mode="fixed2", block_size=1024),
    "rate_22050": dict(channels=1, mode="fixed1", sample_rate=22050),
}


def _write(path, encoder, channels, mode, n=10000, block_size=4096, sample_rate=16000):
    data = ([[1234] * n] if mode == "constant"
            else [int16_wave(n, seed=c + 1) for c in range(channels)])
    encoder(str(path), data, sample_rate=sample_rate, block_size=block_size,
            subframe_mode=mode)
    return data


@pytest.mark.parametrize("case", sorted(CASES))
def test_encoder_writes_the_jax_bytes(tmp_path, case):
    spec = CASES[case]
    kwargs = {k: v for k, v in spec.items() if k in ("block_size", "sample_rate")}
    _write(tmp_path / "port.flac", encode_flac, spec["channels"], spec["mode"], **kwargs)
    _write(tmp_path / "jax.flac", jax_encode_flac, spec["channels"], spec["mode"], **kwargs)
    assert (tmp_path / "port.flac").read_bytes() == (tmp_path / "jax.flac").read_bytes()


@pytest.mark.parametrize("case", sorted(CASES))
def test_decode_equals_the_jax_native_decode(tmp_path, case):
    spec = CASES[case]
    kwargs = {k: v for k, v in spec.items() if k in ("block_size", "sample_rate")}
    path = tmp_path / "utt.flac"
    data = _write(path, encode_flac, spec["channels"], spec["mode"], **kwargs)
    ours, rate = library().decode_flac(str(path))
    theirs, jax_rate = jax_native.decode_flac(str(path))
    assert rate == jax_rate == kwargs.get("sample_rate", 16000)
    assert ours.dtype == theirs.dtype == np.float32
    np.testing.assert_array_equal(ours, theirs)
    want = np.mean(np.asarray(data, np.float32), axis=0) / 32768.0
    np.testing.assert_allclose(ours, want, atol=1e-6)
    # The audio_io entries: decode, the 16 kHz load (resampled for 22.05 kHz), probes.
    for port_fn, jax_fn in ((audio_io.decode_audio, jax_audio_io.decode_audio),):
        got, got_rate = port_fn(path)
        want_audio, want_rate = jax_fn(path)
        np.testing.assert_array_equal(got, want_audio)
        assert got_rate == want_rate
    for rate_out in (16000, 8000):
        np.testing.assert_array_equal(audio_io.load_audio(path, rate_out),
                                      jax_audio_io.load_audio(path, rate_out))
    assert audio_io.file_sample_rate(path) == jax_audio_io.file_sample_rate(path)
    assert audio_io.probe_duration_in_s(path) == jax_audio_io.probe_duration_in_s(path) \
        == pytest.approx(len(data[0]) / kwargs.get("sample_rate", 16000))


def _huge_claim(path):
    encode_flac(str(path), [int16_wave(1000)])
    data = bytearray(path.read_bytes())
    # STREAMINFO bytes 18..26 hold rate(20)|channels(3)|bps(5)|total(36): claim 2^36 - 1.
    bits = int.from_bytes(data[18:26], "big") | ((1 << 36) - 1)
    data[18:26] = bits.to_bytes(8, "big")
    path.write_bytes(bytes(data))


def _outcome(fn, *args):
    try:
        audio, rate = fn(*args)
        return ("ok", audio.tobytes(), rate)
    except ValueError as error:
        return ("ValueError", str(error).split(" (error ")[-1])


@pytest.mark.parametrize("kind", ["corrupt", "truncated", "huge_claim", "not_flac"])
def test_bad_files_fail_as_in_jax(tmp_path, kind):
    """Each package's decoder gives the same outcome, error code included, and the
    header probes raise (or give 0 s) as JAX's do."""
    path = tmp_path / "bad.flac"
    if kind == "corrupt":
        path.write_bytes(b"fLaC" + b"\x00" * 100)
    elif kind == "truncated":
        path.write_bytes(b"fLaC\x00\x00")
    elif kind == "huge_claim":
        _huge_claim(path)
    else:
        path.write_bytes(b"RIFF" + b"\x01" * 60)
    ours = _outcome(library().decode_flac, str(path))
    assert ours == _outcome(jax_native.decode_flac, str(path))
    if kind != "huge_claim":
        assert ours[0] == "ValueError"
        with pytest.raises(ValueError):
            audio_io.decode_audio(path)
        with pytest.raises(ValueError):
            audio_io.file_sample_rate(path)
        with pytest.raises(ValueError):
            jax_audio_io.file_sample_rate(path)
    assert audio_io.probe_duration_in_s(path) == jax_audio_io.probe_duration_in_s(path)
    if kind in ("truncated", "not_flac"):
        assert audio_io.probe_duration_in_s(path) == 0.0
    with pytest.raises(ValueError, match="Unsupported audio format"):
        audio_io.decode_audio(tmp_path / "a.ogg")


def test_a_flac_librispeech_tree_loads_through_the_corpus(tmp_path):
    """A LibriSpeech chapter of FLAC files (as LibriSpeech ships) parses into the same
    examples in both packages, and each example's audio decodes bitwise equal."""
    chapter = tmp_path / "mini" / "dc" / "11" / "22"
    chapter.mkdir(parents=True)
    texts = ["hello world", "it's a test", "third one"]
    lines = []
    for i, text in enumerate(texts):
        stem = "11-22-{:04d}".format(i)
        encode_flac(str(chapter / (stem + ".flac")), [int16_wave(8000 + 1600 * i, seed=i)],
                    subframe_mode="fixed2")
        lines.append("{} {}".format(stem, text.upper()))
    (chapter / "11-22.trans.txt").write_text("\n".join(lines))
    theirs = jax_librispeech.LibriSpeechCorpus(
        base_directory=tmp_path, corpus_name="mini",
        training_test_split=jax_corpus.TrainingTestSplit.training_only)
    ours = librispeech.LibriSpeechCorpus(
        base_directory=tmp_path, corpus_name="mini",
        training_test_split=corpus.TrainingTestSplit.training_only)

    def examples(c):
        return sorted((e.id, e.label, e.audio_file.suffix, e.duration_in_s,
                       e.original_sample_rate) for e in c.training_examples)

    assert examples(ours) == examples(theirs)
    assert [e[1] for e in examples(ours)] == sorted(texts)
    assert [e[3] for e in examples(ours)] == [0.5, 0.6, 0.7]
    for mine, jax_example in zip(sorted(ours.training_examples, key=lambda e: e.id),
                                 sorted(theirs.training_examples, key=lambda e: e.id)):
        np.testing.assert_array_equal(mine.get_raw_audio(), jax_example.get_raw_audio())
