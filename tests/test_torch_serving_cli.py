"""The port's serving CLI on a configuration's run (``--config --data-dir --run
--epoch``), FLAC input, ``align``, ``--quantize`` and ``serve --warm-beam``, against the
JAX package's CLI on the same full-width checkpoint, LM and files.

Both CLIs run in this process (``main(argv)``, stdout captured) except ``serve``, which
runs in a subprocess until it has answered a stream session. Transcripts and alignments
are held exactly equal; confidences within 1e-4 (fp32 features and convolutions summed
in another order). Refusals: the port exits with a usage error (code 2) where the JAX
CLI raises SystemExit with a message; the messages are held equal.
"""
import json
import queue
import shutil
import signal
import subprocess
import sys
import threading
import urllib.error
import urllib.request
from pathlib import Path

import numpy as np
import pytest
import scipy.io.wavfile as wavfile

from speechless_tpu import __main__ as jax_cli
from speechless_tpu_torch import __main__ as cli
from speechless_tpu_torch.features.flac_encoder import encode_flac
from speechless_tpu_torch.lm.arpa_builder import build_kenlm_directory
from speechless_tpu_torch.models import wav2letter as w2l
from speechless_tpu_torch.serving import CHARSETS, Transcriber

ROOT = Path(__file__).resolve().parent.parent
TEXTS = ["the cat sat on the mat", "the cat ran to the dog", "a dog sat on a log"]


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    """A data directory with run ``run``'s epoch-2 checkpoint (full width, seeded, the
    output layer scaled for peaky frames), the English LM directory, and one second
    of audio as ``a.wav`` and as ``b.flac`` (the same 16-bit samples)."""
    root = tmp_path_factory.mktemp("data")
    config = w2l.Wav2LetterConfig(128, len(CHARSETS["english"]) + 1)
    params = w2l.init_params(config, seed=2)
    params[-1]["w"] = params[-1]["w"] * 8.0
    (root / "nets" / "run").mkdir(parents=True)
    np.savez(root / "nets" / "run" / "weights-epoch2.npz",
             **{"layer{}.{}".format(i, key): value for i, layer in enumerate(params)
                for key, value in layer.items()})
    build_kenlm_directory(TEXTS, root / "kenlm" / "english",
                          allowed_characters=CHARSETS["english"], order=3)
    rng = np.random.default_rng(0)
    t = np.arange(16000) / 16000.0
    audio = 0.3 * np.sin(2 * np.pi * 440 * t) + 0.05 * rng.normal(size=t.size)
    pcm = np.clip(np.round(audio * 32767), -32768, 32767).astype(np.int16)
    wavfile.write(root / "a.wav", 16000, pcm)
    encode_flac(str(root / "b.flac"), [pcm.astype(np.int64).tolist()])
    (root / "text.txt").write_text("The cat, sat!\n")
    yield root, params
    shutil.rmtree(root)  # a full-width checkpoint


def _run(main, argv, capsys):
    """``main(argv)``'s stdout lines, or its exit code and message when it exits."""
    capsys.readouterr()
    try:
        main(argv)
    except SystemExit as exit_:
        captured = capsys.readouterr()
        return exit_.code, (captured.err + str(exit_.code or "")).strip()
    return [line for line in capsys.readouterr().out.splitlines() if line]


def _backend(root):
    return ["--config", "english", "--data-dir", str(root), "--run", "run", "--epoch", "2"]


def test_transcribe_run_epoch_matches_jax(data, capsys):
    """``transcribe`` of a wav and a FLAC file on the run's quantized model prints the
    JAX CLI's records."""
    root, _ = data
    argv = ["transcribe", str(root / "a.wav"), str(root / "b.flac"), *_backend(root),
            "--quantize", "--json"]
    ours = [json.loads(line) for line in _run(cli.main, argv + ["--device", "cpu"], capsys)]
    theirs = [json.loads(line) for line in _run(jax_cli.main, argv, capsys)]
    assert [(r["file"], r["text"]) for r in ours] == [(r["file"], r["text"]) for r in theirs]
    np.testing.assert_allclose([r["confidence"] for r in ours],
                               [r["confidence"] for r in theirs], atol=1e-4)
    assert ours[0]["text"] == ours[1]["text"] and ours[0]["text"]


def test_align_matches_jax(data, capsys):
    root, _ = data
    for text_args in (["--text-file", str(root / "text.txt")], ["--text", "The cat, sat!"]):
        argv = ["align", str(root / "b.flac"), *text_args, *_backend(root), "--quantize"]
        ours = _run(cli.main, argv + ["--device", "cpu"], capsys)
        theirs = _run(jax_cli.main, argv, capsys)
        assert ours == theirs
        record = json.loads(ours[0])
        assert record["text"] == "The cat, sat!"
        assert [w["word"] for w in record["words"]] == ["the", "cat", "sat"]


def test_kenlm_spellings_agree(data, capsys):
    """``--run R --epoch N --kenlm`` (the JAX spelling: the configuration's LM
    directory) and ``--checkpoint FILE --kenlm DIR`` (the port's) serve one model and
    one LM, and print a direct call's transcript."""
    root, params = data
    wav = str(root / "a.wav")
    by_run = _run(cli.main, ["transcribe", wav, *_backend(root), "--kenlm", "--device",
                             "cpu"], capsys)
    by_file = _run(cli.main, ["transcribe", wav, "--checkpoint",
                              str(root / "nets" / "run" / "weights-epoch2.npz"), "--kenlm",
                              str(root / "kenlm" / "english"), "--device", "cpu"], capsys)
    direct = Transcriber(w2l.Wav2LetterConfig(128, 29), params, CHARSETS["english"],
                         device="cpu", kenlm_directory=root / "kenlm" / "english"
                         ).transcribe_file(root / "a.wav")
    assert by_run == by_file == ["{}\t{}".format(wav, direct)]


@pytest.mark.parametrize("argv,message", [
    (["transcribe", "a.wav", "--config", "english", "--run", "run"],
     "--run requires --epoch"),
    (["align", "a.wav", "--text", "a", "--config", "english", "--run", "run"],
     "--run requires --epoch"),
    (["transcribe", "a.wav", "--run", "run", "--epoch", "1", "--lexicon"],
     "--lexicon requires --kenlm (the vocabulary trie rides in the word LM)"),
    (["serve", "--run", "run", "--epoch", "1", "--lexicon"],
     "--lexicon requires --kenlm (the vocabulary trie rides in the word LM)"),
    (["align", "a.wav", "--run", "run", "--epoch", "1"],
     "align needs exactly one of --text or --text-file"),
    (["transcribe", "a.wav"], "transcribe needs exactly one of"),
    (["serve", "--bundle", "b", "--run", "run", "--epoch", "1"],
     "serve needs exactly one of --bundle or a checkpoint"),
    (["serve", "--checkpoint", "w.npz", "--run", "run", "--epoch", "1"],
     "serve needs exactly one of --checkpoint or --run/--epoch"),
    (["transcribe", "a.wav", "--run", "run", "--epoch", "1", "--charset", "german"],
     "--charset is for --checkpoint"),
    (["transcribe", "a.wav", "--bundle", "b", "--lexicon"],
     "--lexicon needs a live checkpoint (--run/--epoch): AOT bundles bake their decoder "
     "at export time, so the flag would be silently ignored"),
    (["transcribe", "a.wav", "--bundle", "b", "--nbest", "2", "--json"],
     "AOT bundles export 1-best programs only"),
    (["serve", "--bundle", "b", "--quantize"], "--quantize with --bundle"),
], ids=["run_without_epoch", "align_run_without_epoch", "lexicon_without_kenlm",
        "serve_lexicon_without_kenlm", "align_without_text", "no_backend", "bundle",
        "two_backends", "charset_with_run", "bundle_lexicon", "bundle_nbest",
        "bundle_quantize"])
def test_refusals(argv, message, capsys, tmp_path):
    """Each refusal exits before anything loads; where the JAX CLI refuses the same
    arguments, its message is the port's."""
    code, said = _run(cli.main, argv + ["--data-dir", str(tmp_path)], capsys)
    assert code == 2 and message in said
    if message.startswith(("--run requires", "--lexicon requires", "align needs",
                           "--lexicon needs a live")):
        jax_code, jax_said = _run(jax_cli.main, argv + ["--data-dir", str(tmp_path)],
                                  capsys)
        assert jax_code == message or message in jax_said


def _request(port, path, data=b"", content_type="application/json"):
    request = urllib.request.Request("http://127.0.0.1:{}{}".format(port, path),
                                     data=data, method="POST")
    request.add_header("Content-Type", content_type)
    with urllib.request.urlopen(request, timeout=300) as response:
        return response.status, json.loads(response.read())


def test_serve_run_epoch_warm_beam(data):
    """``serve --run --epoch --quantize --warm-beam`` warms the stream beam before it
    binds, then answers a beam stream session as the same pool does in process."""
    from speechless_tpu_torch.features.audio_io import load_audio
    from speechless_tpu_torch.serving_streaming import StreamingSessionPool

    root, params = data
    process = subprocess.Popen(
        [sys.executable, "-m", "speechless_tpu_torch", "serve", *_backend(root),
         "--quantize", "--warm-beam", "--no-warm-up", "--device", "cpu", "--port", "0"],
        cwd=str(ROOT), stderr=subprocess.PIPE, text=True)
    lines = queue.Queue()

    def read_log():
        for log_line in process.stderr:
            lines.put(log_line)
        lines.put(None)

    threading.Thread(target=read_log, daemon=True).start()
    audio = load_audio(root / "b.flac")
    try:
        log = []
        while not log or "serving on http://" not in log[-1]:
            log.append(lines.get(timeout=120))
            assert log[-1] is not None, "the server exited: {}".format("".join(log[:-1]))
        assert any("beam warm-up" in line for line in log), log
        port = int(log[-1].rsplit(":", 1)[1].split()[0])
        status, created = _request(port, "/v1/stream", b'{"partial_decode": "beam"}')
        assert status == 200
        for start in range(0, len(audio), 4000):
            _request(port, "/v1/stream/" + created["session"],
                     audio[start:start + 4000].astype("<f4").tobytes(),
                     "application/octet-stream")
        status, final = _request(port, "/v1/stream/{}/finish".format(created["session"]))
    finally:
        process.send_signal(signal.SIGINT)
        try:
            process.wait(timeout=60)
        finally:
            process.kill()
    transcriber = Transcriber(w2l.Wav2LetterConfig(128, 29), params, CHARSETS["english"],
                              device="cpu", quantize_weights=True)
    pool = StreamingSessionPool(transcriber)
    pool.start()
    try:
        sid = pool.create(partial_decode="beam")
        for start in range(0, len(audio), 4000):
            pool.feed(sid, audio[start:start + 4000])
        want = pool.finish(sid)
    finally:
        pool.stop()
    assert status == 200 and final["text"] == want


@pytest.fixture(scope="module")
def bundles(data, tmp_path_factory):
    """``export`` of the run's model for the CPU: one bundle with the streaming
    programs (``align`` needs its posteriors), one without."""
    root, _ = data
    out = {}
    for name, extra in (("streaming", ["--streaming"]), ("plain", [])):
        out[name] = tmp_path_factory.mktemp("bundle-" + name)
        cli.main(["export", *_backend(root), "--out", str(out[name]), "--sample-buckets",
                  "16384", "--platforms", "cpu", "--device", "cpu", *extra])
    yield out
    for directory in out.values():
        shutil.rmtree(directory)  # full-width weights


def test_export_then_bundle_commands_match_the_checkpoint(data, bundles, capsys):
    """``transcribe --bundle`` and ``align --bundle`` print what the checkpoint prints;
    ``align`` on a bundle without posterior programs exits with the JAX CLI's text."""
    root, _ = data
    files = [str(root / "a.wav"), str(root / "b.flac")]
    bundle = ["--bundle", str(bundles["streaming"]), "--device", "cpu"]
    checkpoint = [*_backend(root), "--device", "cpu"]
    by_bundle = [json.loads(line) for line in _run(
        cli.main, ["transcribe", *files, "--json", *bundle], capsys)]
    by_run = [json.loads(line) for line in _run(
        cli.main, ["transcribe", *files, "--json", *checkpoint], capsys)]
    assert [r["text"] for r in by_bundle] == [r["text"] for r in by_run]
    assert by_run[0]["text"]
    np.testing.assert_allclose([r["confidence"] for r in by_bundle],
                               [r["confidence"] for r in by_run], atol=1e-4)
    align = ["align", str(root / "b.flac"), "--text", "The cat, sat!"]
    assert _run(cli.main, align + bundle, capsys) == _run(cli.main, align + checkpoint,
                                                         capsys)
    code, said = _run(cli.main, align + ["--bundle", str(bundles["plain"]), "--device",
                                         "cpu"], capsys)
    assert code == ("this bundle has no frame-posterior programs; re-export with "
                    "--streaming")
