"""Export bundles (`speechless_tpu_torch/serving_export.py`) on the CPU: `torch.export`
programs of the port's `Transcriber`, replayed by `ExportedTranscriber`, against the
live port Transcriber and the JAX package's `Transcriber` on the same weights, LM and
audio (the cases of `tests/test_serving_export.py`).

Tolerances: transcripts and alignments exactly equal; confidences and log-probs atol
1e-4 against JAX (fp32 features and convolutions summed in another order) and the live
port (the same ops; padded batches run at another batch size).
"""
import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest

from speechless_tpu.models import wav2letter as jax_w2l
from speechless_tpu.serving import Transcriber as JaxTranscriber
from speechless_tpu.train.checkpoint import load_params as jax_load_params
from speechless_tpu_torch.lm.arpa_builder import build_kenlm_directory
from speechless_tpu_torch.models import wav2letter as w2l
from speechless_tpu_torch.serving import Transcriber
from speechless_tpu_torch.serving_export import (FORMAT, ExportedTranscriber,
                                                 export_transcriber)
from speechless_tpu_torch.serving_host import align_audio
from speechless_tpu_torch.serving_streaming import StreamingTranscriber

ROOT = Path(__file__).resolve().parent.parent
ALPHABET = list("abcdefghijklmnopqrstuvwxyz '")
TEXTS = ["the cat sat on the mat", "the cat ran to the dog", "a dog sat on a log"]
LAYERS = (w2l.ConvSpec("striding_conv", 16, 48, 2),
          w2l.ConvSpec("inner_conv_1", 16, 7, 1),
          w2l.ConvSpec("big_conv_1", 24, 32, 1),
          w2l.ConvSpec("big_conv_2", 24, 1, 1),
          w2l.ConvSpec("output_conv", len(ALPHABET) + 1, 1, 1, "linear"))
BUCKETS = (8192, 16384)
TOLERANCE = 1e-4


def _audio(samples, seed):
    rng = np.random.default_rng(seed)
    t = np.arange(samples) / 16000.0
    tones = sum(0.2 * np.sin(2 * np.pi * f * t) for f in rng.uniform(100, 3000, 3))
    return (tones + 0.05 * rng.normal(size=t.size)).astype(np.float32)


# Inside the first bucket, on its boundary, inside the second.
AUDIOS = [_audio(n, i) for i, n in enumerate((5000, 8192, 12000, 16000, 3000))]


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    lm_directory = tmp_path_factory.mktemp("kenlm")
    build_kenlm_directory(TEXTS, lm_directory, allowed_characters=ALPHABET, order=3)
    config = w2l.Wav2LetterConfig(128, len(ALPHABET) + 1, layers=LAYERS)
    params = w2l.init_params(config, seed=11)
    params[-1]["w"] = params[-1]["w"] * 10.0  # peaky frames
    return config, params, lm_directory


def _jax(setup, kenlm=False, **options):
    config, params, lm_directory = setup
    jax_config = jax_w2l.Wav2LetterConfig(
        128, len(ALPHABET) + 1, layers=tuple(
            jax_w2l.ConvSpec(s.name, s.filters, s.kernel_size, s.stride, s.activation,
                             False) for s in LAYERS))
    return JaxTranscriber(jax_config, [{k: jnp.asarray(v) for k, v in p.items()}
                                       for p in params], ALPHABET,
                          kenlm_directory=lm_directory if kenlm else None, **options)


@pytest.fixture(scope="module")
def live(setup):
    config, params, _ = setup
    return Transcriber(config, params, ALPHABET, device="cpu", sample_buckets=BUCKETS)


@pytest.fixture(scope="module")
def bundle(live, tmp_path_factory):
    directory = tmp_path_factory.mktemp("bundle")
    export_transcriber(live, directory, platforms=("cpu",), batch_sizes=(1, 4),
                       streaming=True)
    return directory


@pytest.fixture(scope="module")
def loaded(bundle):
    return ExportedTranscriber(bundle, device="cpu")


def _copy_with_manifest(bundle, target, **changes):
    shutil.copytree(bundle, target)
    manifest = json.loads((target / "manifest.json").read_text())
    for key, value in changes.items():
        if value is None:
            manifest.pop(key)
        else:
            manifest[key] = value
    (target / "manifest.json").write_text(json.dumps(manifest))
    return target


def test_bundle_layout(bundle):
    manifest = json.loads((bundle / "manifest.json").read_text())
    assert manifest["format"] == FORMAT and manifest["format_version"] == 1
    assert manifest["platforms"] == ["cpu"]
    assert manifest["sample_buckets"] == list(BUCKETS)
    assert manifest["batch_sizes"] == [1, 4]
    assert manifest["allowed_characters"] == ALPHABET
    assert manifest["lm_fused"] is False and manifest["quantized"] is False
    assert manifest["streaming"] and manifest["streaming_posteriors"]
    assert manifest["device_streaming"] is None
    assert manifest["weights"]["layers.0.weight"] == [0, "w", [2, 1, 0]]
    assert manifest["weights"]["layers.4.bias"] == [4, "b", None]
    assert (bundle / "weights-epoch0.npz").exists()
    for bucket in BUCKETS:
        for name in ("program-{}", "program-{}-b4", "frames-{}", "posteriors-{}"):
            assert (bundle / (name.format(bucket) + ".cpu.pt2")).stat().st_size > 0


def test_transcripts_match_live_and_jax(setup, live, loaded):
    theirs = _jax(setup, sample_buckets=BUCKETS)
    for audio in AUDIOS[:3]:
        text, confidence = loaded.transcribe_audio_with_confidence(audio)
        live_text, live_confidence = live.transcribe_audio_with_confidence(audio)
        jax_text, jax_confidence = theirs.transcribe_audio_with_confidence(audio)
        assert text == live_text == jax_text
        assert abs(confidence - live_confidence) <= TOLERANCE
        assert abs(confidence - jax_confidence) <= TOLERANCE
        assert loaded.transcribe_audio(audio) == text
    assert any(len(loaded.transcribe_audio(audio)) > 3 for audio in AUDIOS[:3])


def test_oversize_audio_raises(loaded):
    with pytest.raises(ValueError, match="largest exported bucket"):
        loaded.transcribe_audio(np.zeros(20000, np.float32))


def test_bucket_subset_and_unknown_bucket(live, tmp_path):
    out = export_transcriber(live, tmp_path / "subset", platforms=("cpu",),
                             sample_buckets=(8192,))
    assert json.loads((out / "manifest.json").read_text())["sample_buckets"] == [8192]
    subset = ExportedTranscriber(out, device="cpu")
    assert subset.transcribe_audio(AUDIOS[0]) == live.transcribe_audio(AUDIOS[0])
    assert subset.has_batched_programs is False and not subset.supports_posteriors
    with pytest.raises(ValueError, match="no batched programs"):
        subset.transcribe_batch([AUDIOS[0]])
    with pytest.raises(ValueError, match="no streaming programs"):
        subset.frame_tokens(AUDIOS[0])
    with pytest.raises(ValueError, match="no posterior programs"):
        subset.frame_log_probs(AUDIOS[0])
    with pytest.raises(ValueError, match="not buckets"):
        export_transcriber(live, tmp_path / "bad", platforms=("cpu",),
                           sample_buckets=(999,))


def test_platform_refusals(live, bundle, tmp_path):
    """A bundle loads only on a platform it was exported for; ``tpu`` is no platform
    of the port."""
    cuda_only = _copy_with_manifest(bundle, tmp_path / "cuda-only", platforms=["cuda"])
    with pytest.raises(ValueError, match="exported for platforms"):
        ExportedTranscriber(cuda_only, device="cpu")
    with pytest.raises(ValueError, match="cuda, cpu"):
        export_transcriber(live, tmp_path / "tpu", platforms=("tpu",))


def test_batched_programs(live, loaded, tmp_path):
    """Five utterances in two buckets: groups padded to the exported batch of 4, the
    live transcriber's texts and confidences."""
    assert loaded.has_batched_programs
    results = loaded.transcribe_batch(AUDIOS)
    want = live.transcribe_batch(AUDIOS, batch_size=4)
    assert [text for text, _ in results] == [text for text, _ in want]
    np.testing.assert_allclose([c for _, c in results], [c for _, c in want],
                               atol=TOLERANCE, rtol=0)
    with pytest.raises(ValueError, match="include 1"):
        export_transcriber(live, tmp_path / "nope", platforms=("cpu",), batch_sizes=(4,))


def test_streaming_and_alignment(setup, live, loaded):
    """Frame tokens and posteriors equal the live ones; a streaming session over the
    bundle gives the live session's transcript; forced alignment over the bundle's
    posteriors gives the live word spans."""
    theirs = _jax(setup, sample_buckets=BUCKETS)
    audio = AUDIOS[3]
    np.testing.assert_array_equal(loaded.frame_tokens(audio), live.frame_tokens(audio))
    np.testing.assert_allclose(loaded.frame_log_probs(audio), live.frame_log_probs(audio),
                               atol=TOLERANCE, rtol=0)
    np.testing.assert_allclose(loaded.frame_log_probs(audio),
                               theirs.frame_log_probs(audio), atol=TOLERANCE, rtol=0)
    long_audio = np.concatenate([AUDIOS[3], AUDIOS[2], AUDIOS[0]])
    assert (StreamingTranscriber(loaded, window_s=1.0, margin_s=0.25)
            .transcribe_stream(long_audio, 4000)
            == StreamingTranscriber(live, window_s=1.0, margin_s=0.25)
            .transcribe_stream(long_audio, 4000))
    transcript = live.transcribe_audio(audio)
    assert transcript.strip()
    words = align_audio(loaded, audio, transcript)
    assert words and words == live.align_audio(audio, transcript)
    assert loaded.align_audio(audio, transcript) == words


def test_long_form(live, loaded):
    """Segments capped at the largest exported bucket, as the live transcriber
    segments at the same cap."""
    audio = np.concatenate(AUDIOS[:4])
    assert loaded.transcribe_long_audio(audio) == live.transcribe_long_audio(
        audio, max_segment_s=BUCKETS[-1] / 16000.0)


def test_newer_format_and_jax_bundles_refused(bundle, tmp_path):
    newer = _copy_with_manifest(bundle, tmp_path / "newer", format_version=99)
    with pytest.raises(ValueError, match="newer than this loader"):
        ExportedTranscriber(newer, device="cpu")
    # The JAX package's manifest: the same keys, no "format", StableHLO programs.
    jax_bundle = _copy_with_manifest(bundle, tmp_path / "jax", format=None,
                                     weights=None)
    for program in jax_bundle.glob("*.pt2"):
        program.unlink()
    (jax_bundle / "program-8192.shlo").write_bytes(b"stablehlo")
    with pytest.raises(ValueError, match="JAX package bundle"):
        ExportedTranscriber(jax_bundle, device="cpu")


def test_weights_read_by_jax_load_params(live, bundle):
    """The bundle's weights are a checkpoint of the JAX layout: JAX's loader reads the
    exported params exactly."""
    theirs = jax_load_params(bundle, 0)
    assert len(theirs) == len(live.params)
    for mine, layer in zip(live.params, theirs):
        assert sorted(mine) == sorted(layer)
        for key in mine:
            np.testing.assert_array_equal(np.asarray(layer[key]), mine[key])


def test_lm_fused_bundle_matches_jax(setup, tmp_path):
    """The word-LM beam (W=4, the trigram) inside the programs: the bundle's texts equal
    the live port's and the JAX LM Transcriber's; the programs call the span and
    backtrace operators."""
    config, params, lm_directory = setup
    live = Transcriber(config, params, ALPHABET, device="cpu", kenlm_directory=lm_directory,
                       beam_width=4, sample_buckets=(16384,))
    export_transcriber(live, tmp_path / "lm", platforms=("cpu",), batch_sizes=(1, 4))
    assert json.loads((tmp_path / "lm" / "manifest.json").read_text())["lm_fused"]
    loaded = ExportedTranscriber(tmp_path / "lm", device="cpu")
    graph = loaded._programs[16384].module.graph
    assert {"speechless.lm_beam_span.default", "speechless.beam_backtrace.default"} <= {
        str(node.target) for node in graph.nodes}
    theirs = _jax(setup, kenlm=True, beam_width=4, sample_buckets=(16384,))
    audios = AUDIOS[1:4]
    want = theirs.transcribe_batch(audios, batch_size=4)
    got = loaded.transcribe_batch(audios)
    assert [text for text, _ in got] == [text for text, _ in want] == [
        text for text, _ in live.transcribe_batch(audios)]
    np.testing.assert_allclose([c for _, c in got], [c for _, c in want], atol=TOLERANCE,
                               rtol=0)
    assert loaded.transcribe_audio(audios[0]) == want[0][0]


def test_quantized_bundle(setup, tmp_path):
    """A bundle of the int8 layout serves what the live quantized transcriber serves,
    and its weights stay int8."""
    config, params, _ = setup
    live = Transcriber(config, params, ALPHABET, device="cpu", quantize_weights=True,
                       sample_buckets=(16384,))
    export_transcriber(live, tmp_path / "int8", platforms=("cpu",))
    manifest = json.loads((tmp_path / "int8" / "manifest.json").read_text())
    assert manifest["quantized"] and "layers.0.w_q" in manifest["weights"]
    loaded = ExportedTranscriber(tmp_path / "int8", device="cpu")
    assert str(loaded.weights["layers.0.w_q"].dtype) == "torch.int8"
    for audio in AUDIOS[2:4]:
        text, confidence = loaded.transcribe_audio_with_confidence(audio)
        live_text, live_confidence = live.transcribe_audio_with_confidence(audio)
        assert text == live_text
        assert abs(confidence - live_confidence) <= TOLERANCE


def test_replay_imports_no_model_code(bundle):
    """A fresh interpreter that replays the bundle loads no model, feature or
    Transcriber module of the port (and nothing of JAX)."""
    script = ("import sys, numpy as np\n"
              "from speechless_tpu_torch.serving_export import ExportedTranscriber\n"
              "b = ExportedTranscriber(sys.argv[1], device='cpu')\n"
              "b.transcribe_audio(np.zeros(4000, np.float32))\n"
              "b.frame_log_probs(np.zeros(4000, np.float32))\n"
              "print(' '.join(sorted(sys.modules)))\n")
    done = subprocess.run([sys.executable, "-c", script, str(bundle)], cwd=str(ROOT),
                          capture_output=True, text=True, timeout=300,
                          env={**os.environ, "PYTHONPATH": str(ROOT)})
    assert done.returncode == 0, done.stderr[-3000:]
    modules = done.stdout.split()
    assert "speechless_tpu_torch.serving_export" in modules
    forbidden = ("speechless_tpu_torch.models", "speechless_tpu_torch.features.spectrogram",
                 "jax", "speechless_tpu.")
    assert not [m for m in modules if m.startswith(forbidden)
                or m in ("speechless_tpu_torch.serving", "speechless_tpu")]


def test_http_server_over_a_bundle(loaded):
    """`TranscriptionServer` over a bundle: transcripts of its programs, a greedy stream
    session on the host pool, and ``?nbest=N`` refused (1-best programs only)."""
    from speechless_tpu_torch.serving_http import TranscriptionServer
    from test_torch_serving import _pcm_body, _request

    server = TranscriptionServer(loaded, port=0, max_batch=4, max_wait_ms=30.0)
    server.start()
    try:
        status, reply = _request(server.port, "/v1/transcribe", _pcm_body(AUDIOS[2]))
        assert status == 200 and reply["text"] == loaded.transcribe_audio(AUDIOS[2])
        status, reply = _request(server.port, "/v1/transcribe?nbest=2",
                                 _pcm_body(AUDIOS[2]))
        assert status == 501 and "1-best programs only" in reply["error"]
        sid = _request(server.port, "/v1/stream", b"{}")[1]["session"]
        for start in range(0, len(AUDIOS[3]), 4000):
            assert _request(server.port, "/v1/stream/" + sid,
                            _pcm_body(AUDIOS[3][start:start + 4000]))[0] == 200
        status, final = _request(server.port, "/v1/stream/{}/finish".format(sid), b"")
        assert status == 200 and final["text"] == StreamingTranscriber(
            loaded).transcribe_stream(AUDIOS[3], 4000)
    finally:
        server.stop()
