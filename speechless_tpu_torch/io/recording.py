"""Microphone recording with silence-based endpointing (port of
`speechless_tpu/io/recording.py`, the reference's `recording.py`): capture fp32 16 kHz
chunks, drop the first (often a click), start at the first chunk that is not silent,
stop after 3 s of silence, trim the leading and trailing silence, peak-normalize, write
a wav and wrap it in a `LabeledExample`.

The endpointing is pure numpy on arrays (`Recorder.record_from_chunks`). Capture needs
`sounddevice` or `pyaudio`, imported inside the call that records: neither is a
dependency of the port. The first of the two that is installed records; a failure of
it is raised, where the JAX package falls back to the other.
"""
import importlib.util
from pathlib import Path
from typing import Iterator, List, Optional

import numpy as np

from ..features.audio_io import write_wav
from ..features.example import LabeledExample, LabeledExampleFromFile
from ..utils.tools import mkdir, timestamp

CAPTURE_BACKENDS = ("sounddevice", "pyaudio")


class Recorder:
    def __init__(self,
                 silence_threshold_for_unnormalized_audio: float = 0.03,
                 chunk_size: int = 1024,
                 sample_rate: int = 16000,
                 silence_until_terminate_in_s: int = 3):
        self.silence_threshold = silence_threshold_for_unnormalized_audio
        self.chunk_size = chunk_size
        self.sample_rate = sample_rate
        self.silence_until_terminate_in_s = silence_until_terminate_in_s

    # -- pure endpointing logic ------------------------------------------

    def _is_silent(self, chunk: np.ndarray) -> bool:
        return np.max(chunk) < self.silence_threshold

    def _trim_silence(self, audio: np.ndarray) -> np.ndarray:
        above = np.flatnonzero(audio >= self.silence_threshold)
        if len(above) == 0:
            return np.array([], dtype=audio.dtype)
        return audio[above[0]: above[-1] + 1]

    def _normalize(self, audio: np.ndarray) -> np.ndarray:
        return audio / np.max(np.abs(audio))

    def record_from_chunks(self, chunks: Iterator[np.ndarray]) -> np.ndarray:
        """The endpointing state machine over a stream of chunks: drops the first chunk,
        starts recording at the first chunk that is not silent, stops after
        ``silence_until_terminate_in_s`` of consecutive silence, then trims and
        normalizes."""
        collected: List[np.ndarray] = []
        silent_chunk_count = 0
        has_recording_started = False
        first_chunk_dropped = False
        max_silent_samples = self.silence_until_terminate_in_s * self.sample_rate

        for chunk in chunks:
            if not first_chunk_dropped:  # often loud interface noise
                first_chunk_dropped = True
                continue
            collected.append(np.asarray(chunk, dtype=np.float32))
            silent = self._is_silent(collected[-1])
            if has_recording_started:
                if silent:
                    silent_chunk_count += 1
                    if silent_chunk_count * self.chunk_size > max_silent_samples:
                        break
                else:
                    silent_chunk_count = 0
            elif not silent:
                has_recording_started = True

        if not collected:
            return np.array([], dtype=np.float32)
        trimmed = self._trim_silence(np.concatenate(collected))
        if len(trimmed) == 0:
            return trimmed
        return self._normalize(trimmed)

    # -- capture backends -------------------------------------------------

    @staticmethod
    def capture_backend() -> str:
        """The backend `record` uses: the first of `CAPTURE_BACKENDS` installed."""
        for name in CAPTURE_BACKENDS:
            if importlib.util.find_spec(name) is not None:
                return name
        raise RuntimeError("No audio capture backend available (install sounddevice or "
                           "pyaudio).")

    def _microphone_chunks(self) -> Iterator[np.ndarray]:
        if self.capture_backend() == "sounddevice":
            import sounddevice

            with sounddevice.InputStream(samplerate=self.sample_rate, channels=1,
                                         dtype="float32",
                                         blocksize=self.chunk_size) as stream:
                while True:
                    chunk, _ = stream.read(self.chunk_size)
                    yield chunk[:, 0]
        import pyaudio

        audio = pyaudio.PyAudio()
        stream = audio.open(format=pyaudio.paFloat32, channels=1, rate=self.sample_rate,
                            input=True, frames_per_buffer=self.chunk_size)
        try:
            while True:
                yield np.frombuffer(stream.read(self.chunk_size), dtype=np.float32)
        finally:
            stream.stop_stream()
            stream.close()
            audio.terminate()

    def record(self) -> np.ndarray:
        """Record from the microphone until trailing silence; returns normalized audio."""
        print("Wait in silence to begin recording; wait in silence to terminate")
        chunks = self._microphone_chunks()
        try:
            result = self.record_from_chunks(chunks)
        finally:
            chunks.close()  # stops and releases the capture stream
        print("Stopped recording.")
        return result

    def record_to_file(self, path: Path) -> LabeledExample:
        """Record and write to ``path``; returns a labeled example for analysis."""
        write_wav(path, self.record(), self.sample_rate)
        return LabeledExampleFromFile(path)


def record_plot_and_save(recorder: Optional[Recorder] = None,
                         recording_directory: Optional[Path] = None) -> LabeledExample:
    """Record into ``recording-<timestamp>.wav`` under ``recording_directory`` (the data
    directories' ``recordings`` by default) and save its spectrogram beside it."""
    from ..configuration import default_data_directories
    from .plotting import LabeledExamplePlotter

    if recorder is None:
        recorder = Recorder()
    if recording_directory is None:
        recording_directory = default_data_directories.recording_directory
    mkdir(recording_directory)
    name = "recording-{}".format(timestamp())
    example = recorder.record_to_file(Path(recording_directory) / "{}.wav".format(name))
    LabeledExamplePlotter(example).save_spectrogram(recording_directory)
    return example
