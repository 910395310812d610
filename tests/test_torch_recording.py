"""The port's microphone recorder, spectrogram plotter and ``record`` command
(`speechless_tpu_torch/io`, `__main__.py`) against the JAX package's
(`tests/test_recording.py`'s cases): the endpointing state machine on arrays, equal to
JAX's output exactly; the spectrogram PNGs. Neither `sounddevice` nor `pyaudio` exists
here, so capture is a chunk stream given to the recorder; the backend choice is checked
without one.
"""
import numpy as np
import pytest

from speechless_tpu.features import LabeledExample as JaxLabeledExample
from speechless_tpu.io import Recorder as JaxRecorder
from speechless_tpu_torch import __main__ as cli
from speechless_tpu_torch.features.example import (LabeledExample, SpectrogramFrequencyScale,
                                                   SpectrogramType)
from speechless_tpu_torch.io import LabeledExamplePlotter, Recorder, recording
from speechless_tpu_torch.system import Wav2Letter
from speechless_tpu_torch.text.charsets import english_frequent_characters
from torch_tmp import delete_tmp_path  # noqa: F401 (full-width files)

SILENT = np.zeros(4, np.float32)
LOUD = np.full(4, 0.5, np.float32)
# (chunks, expected length): tests/test_recording.py's streams and two more.
STREAMS = {
    "first_chunk_dropped": ([LOUD] + [SILENT] * 5, 0),
    "start_and_stop": ([SILENT, SILENT, LOUD, LOUD, SILENT, SILENT, SILENT, LOUD, LOUD], 8),
    "never_loud": ([SILENT] * 6, 0),
    "quiet_ramp": ([SILENT, np.linspace(0, 0.2, 4, dtype=np.float32),
                    np.linspace(0.2, 0.01, 4, dtype=np.float32), SILENT, SILENT, SILENT], 6),
    "empty": ([], 0),
}


def _recorders():
    options = dict(silence_threshold_for_unnormalized_audio=0.03, chunk_size=4,
                   sample_rate=8, silence_until_terminate_in_s=1)
    return Recorder(**options), JaxRecorder(**options)


@pytest.mark.parametrize("name", list(STREAMS))
def test_endpointing_matches_jax(name):
    chunks, length = STREAMS[name]
    port, jax_recorder = _recorders()
    got = port.record_from_chunks(iter(chunks))
    want = jax_recorder.record_from_chunks(iter(chunks))
    assert len(got) == length
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)
    if length:
        assert got.max() == pytest.approx(1.0)


@pytest.mark.parametrize("audio", [[0.0, 0.01, 0.5, 0.2, 0.5, 0.01, 0.0], [0.0] * 10])
def test_trim_silence_matches_jax(audio):
    port, jax_recorder = _recorders()
    audio = np.asarray(audio, np.float32)
    np.testing.assert_array_equal(port._trim_silence(audio), jax_recorder._trim_silence(audio))


def test_capture_backend_is_the_first_installed(monkeypatch):
    """sounddevice, else pyaudio; with neither installed the capture fails with the JAX
    package's message."""
    installed = {"pyaudio"}
    monkeypatch.setattr(recording.importlib.util, "find_spec",
                        lambda name: object() if name in installed else None)
    assert Recorder.capture_backend() == "pyaudio"
    installed.add("sounddevice")
    assert Recorder.capture_backend() == "sounddevice"
    installed.clear()
    with pytest.raises(RuntimeError, match="No audio capture backend available"):
        Recorder().capture_backend()


def test_save_spectrogram_png(tmp_path):
    """The plotter's PNGs for the linear power-level and the mel power spectrogram, as
    `tests/test_recording.py` draws them, under the same file names as JAX's."""
    pytest.importorskip("matplotlib")
    from speechless_tpu.io import LabeledExamplePlotter as JaxPlotter

    def example(kind):
        rand = np.random.RandomState(0)
        return kind(get_raw_audio=lambda: rand.randn(4000).astype(np.float32),
                    id="plotme", label="hi")

    plotter = LabeledExamplePlotter(example(LabeledExample))
    (tmp_path / "port").mkdir()
    path = plotter.save_spectrogram(tmp_path / "port")
    mel_path = plotter.save_spectrogram(tmp_path / "port",
                                        frequency_scale=SpectrogramFrequencyScale.mel,
                                        type=SpectrogramType.power)
    jax_plotter = JaxPlotter(example(JaxLabeledExample))
    from speechless_tpu.features import SpectrogramFrequencyScale as JaxScale
    from speechless_tpu.features import SpectrogramType as JaxType
    (tmp_path / "jax").mkdir()
    want = [jax_plotter.save_spectrogram(tmp_path / "jax").name,
            jax_plotter.save_spectrogram(tmp_path / "jax", frequency_scale=JaxScale.mel,
                                         type=JaxType.power).name]
    for got in (path, mel_path):
        assert got.exists() and got.suffix == ".png"
        assert got.read_bytes()[:8] == b"\x89PNG\r\n\x1a\n"
    assert [path.name, mel_path.name] == want


@pytest.fixture
def recorded(monkeypatch):
    """The microphone replaced by 2 s of a tone between silences, in 1024-sample
    chunks."""
    t = np.arange(32768) / 16000.0
    tone = (0.3 * np.sin(2 * np.pi * 440 * t)).astype(np.float32)
    audio = np.concatenate([np.zeros(4096, np.float32), tone, np.zeros(65536, np.float32)])

    def microphone_chunks(self):
        yield from np.split(audio, len(audio) // 1024)

    monkeypatch.setattr(Recorder, "_microphone_chunks", microphone_chunks)


def test_record_command_transcribes_a_run(tmp_path, recorded, capsys):
    """``record --run R`` saves the recording and its spectrogram under the data
    directory and prints what the run's latest epoch predicts for that file."""
    pytest.importorskip("matplotlib")
    nets = tmp_path / "nets" / "run"
    model = Wav2Letter(128, english_frequent_characters, seed=3, device="cpu")
    model.save(nets, 2)
    cli.main(["record", "--config", "english", "--data-dir", str(tmp_path), "--run", "run",
              "--device", "cpu"])
    printed = capsys.readouterr().out.strip().splitlines()
    recordings = tmp_path / "recordings"
    wavs = sorted(recordings.glob("recording-*.wav"))
    assert len(wavs) == 1 and len(list(recordings.glob("*.png"))) == 1
    from speechless_tpu_torch.features.example import LabeledExampleFromFile
    assert printed[-1] == model.predict(LabeledExampleFromFile(wavs[0]))
    assert printed[:2] == ["Wait in silence to begin recording; wait in silence to "
                           "terminate", "Stopped recording."]


def test_record_command_refusals(tmp_path, recorded):
    """Without ``--run`` and without the English baseline, and with a run that has no
    checkpoint, the command exits with the JAX CLI's guidance."""
    pytest.importorskip("matplotlib")
    with pytest.raises(SystemExit, match="No pinned best-English checkpoint"):
        cli.main(["record", "--config", "english", "--data-dir", str(tmp_path),
                  "--device", "cpu"])
    (tmp_path / "nets" / "empty").mkdir(parents=True)
    with pytest.raises(SystemExit, match="No checkpoints found for run 'empty'"):
        cli.main(["record", "--config", "english", "--data-dir", str(tmp_path),
                  "--run", "empty", "--device", "cpu"])
