"""Per-utterance data model: labeled examples, positional labels, feature cache.

The port's own copy of `speechless_tpu/features/example.py` (same cache file names and
format, so a cache written by either package is read by the other). Re-provides the
original speechless example layer (`labeled_example.py`) on top of the numpy host path of
``spectrogram.py``:

* ``LabeledSpectrogram`` — the contract the acoustic model consumes: id, label, and a
  ``(time, mel)`` z-normalized feature matrix.
* ``LabeledExample`` / ``LabeledExampleFromFile`` — lazy audio -> features.
* ``PositionalLabel`` — word-level time spans with ``|``-separated serialization.
* ``CachedLabeledSpectrogram`` — per-example ``.npy`` disk cache with corruption repair
  (recompute on load failure; quarantine + re-save on 1-decimal mismatch).
"""
from enum import Enum
from functools import cached_property
from pathlib import Path
from typing import Callable, List, Optional, Tuple

import numpy as np

from ..utils.tools import log, mkdir, name_without_extension, write_text
from . import audio_io, spectrogram as sg


class SpectrogramFrequencyScale(Enum):
    linear = "linear"
    mel = "mel"


class SpectrogramType(Enum):
    power = "power"
    amplitude = "amplitude"
    power_level = "power level"


def z_normalize(array: np.ndarray) -> np.ndarray:
    return (array - np.mean(array)) / np.std(array)


class PositionalLabel:
    """Word-level (label, (start, end)) spans; ranges in samples or seconds."""

    def __init__(self, labeled_sections: List[Tuple[str, Tuple[float, float]]]):
        if not labeled_sections:
            raise ValueError("Sections must be specified.")
        if any(section_range is None for _, section_range in labeled_sections):
            raise ValueError("Range must be specified.")
        self.labeled_sections = labeled_sections
        self.labels = [word for word, _ in labeled_sections]
        self.label = " ".join(self.labels)

    def convert_range_to_seconds(self, original_sample_rate: int) -> "PositionalLabel":
        return PositionalLabel([(word, (start / original_sample_rate, end / original_sample_rate))
                                for word, (start, end) in self.labeled_sections])

    def with_corrected_labels(self, correction: Callable[[str], str]) -> "PositionalLabel":
        return PositionalLabel([(correction(word), section_range)
                                for word, section_range in self.labeled_sections])

    def serialize(self) -> str:
        return "\n".join("{}|{}|{}".format(word, start, end)
                         for word, (start, end) in self.labeled_sections)

    @staticmethod
    def deserialize(serialized: str) -> "PositionalLabel":
        sections = []
        for line in serialized.splitlines():
            word, start, end = line.split("|")
            sections.append((word, (float(start), float(end))))
        return PositionalLabel(sections)


class LabeledSpectrogram:
    """The feature contract consumed by the net (reference `labeled_example.py:63-71`)."""

    def __init__(self, id: str, label: str):
        self.id = id
        self.label = label

    def z_normalized_transposed_spectrogram(self) -> np.ndarray:
        raise NotImplementedError

    def z_normalized_raw_wave(self) -> np.ndarray:
        raise NotImplementedError


class LabeledExample(LabeledSpectrogram):
    """An utterance with lazily loaded raw audio and on-demand feature extraction."""

    def __init__(self,
                 get_raw_audio: Callable[[], np.ndarray],
                 sample_rate: int = 16000,
                 id: Optional[str] = None,
                 label: Optional[str] = "nolabel",
                 fourier_window_length: int = 512,
                 hop_length: int = 128,
                 mel_frequency_count: int = 128,
                 label_with_tags: Optional[str] = None,
                 positional_label: Optional[PositionalLabel] = None):
        super().__init__(id=id, label=label)
        self.get_raw_audio = get_raw_audio
        self.sample_rate = sample_rate
        self.fourier_window_length = fourier_window_length
        self.hop_length = hop_length
        self.mel_frequency_count = mel_frequency_count
        self.label_with_tags = label_with_tags
        self.positional_label = positional_label

    def tag_count(self, tag: str) -> int:
        return self.label_with_tags.count(tag)

    # -- spectrogram variants (plotting / analysis) -----------------------

    def spectrogram(self, type: SpectrogramType = SpectrogramType.power_level,
                    frequency_scale: SpectrogramFrequencyScale = SpectrogramFrequencyScale.linear
                    ) -> np.ndarray:
        audio = self.get_raw_audio()
        n_fft, hop = self.fourier_window_length, self.hop_length
        if type == SpectrogramType.power:
            result = sg.power_spectrogram(audio, n_fft, hop)
        elif type == SpectrogramType.amplitude:
            result = sg.amplitude_spectrogram(audio, n_fft, hop)
        elif type == SpectrogramType.power_level:
            result = sg.power_level_spectrogram(audio, n_fft, hop)
        else:
            raise ValueError(type)
        if frequency_scale == SpectrogramFrequencyScale.mel:
            result = sg.to_mel_scale(result, self.sample_rate, n_fft,
                                     self.mel_frequency_count)
        return result

    def z_normalized_transposed_spectrogram(self) -> np.ndarray:
        """(time, mel) float32 features honouring this example's DSP parameters."""
        return sg.z_normalized_transposed_spectrogram(
            self.get_raw_audio(), n_fft=self.fourier_window_length,
            hop_length=self.hop_length, n_mels=self.mel_frequency_count,
            sample_rate=self.sample_rate)

    def z_normalized_raw_wave(self) -> np.ndarray:
        """(samples, 1) float32 z-normalized waveform: the `use_raw_wave_input` model
        input. The reference declares the wave-conv frontend (`net.py:309-316`) but its
        batch assembly always feeds spectrograms (`net.py:593`) — the raw path never
        actually ran there; here it trains end-to-end."""
        return z_normalize(self.get_raw_audio().astype(np.float32))[:, np.newaxis]

    def mel_frequencies(self) -> List[float]:
        return list(sg.mel_frequencies(self.mel_frequency_count + 2,
                                       fmax=self.sample_rate / 2))

    def highest_detectable_frequency(self) -> float:
        return self.sample_rate / 2

    def frequency_count_from_spectrogram(self, spec: np.ndarray) -> int:
        return spec.shape[0]

    def time_step_count(self) -> int:
        return sg.frame_count(len(self.get_raw_audio()), self.hop_length)

    def time_step_rate(self) -> float:
        return self.time_step_count() / self.duration_in_s

    def reconstructed_audio_from_spectrogram(self) -> np.ndarray:
        """Inverse STFT (overlap-add) of the complex spectrogram, for the plotter."""
        stft = sg.stft_numpy(self.get_raw_audio(), self.fourier_window_length, self.hop_length)
        frames = np.fft.irfft(stft.T, n=self.fourier_window_length, axis=1)
        window = np.asarray(sg._hann_window(self.fourier_window_length))
        n = self.fourier_window_length + self.hop_length * (frames.shape[0] - 1)
        out = np.zeros(n)
        norm = np.zeros(n)
        for i, frame in enumerate(frames):
            start = i * self.hop_length
            out[start:start + self.fourier_window_length] += frame * window
            norm[start:start + self.fourier_window_length] += window ** 2
        out = out / np.maximum(norm, 1e-10)
        pad = self.fourier_window_length // 2
        return out[pad:-pad].astype(np.float32)

    @cached_property
    def duration_in_s(self) -> float:
        return len(self.get_raw_audio()) / self.sample_rate

    def __str__(self) -> str:
        return self.id + (": {}".format(self.label) if self.label else "")


class LabeledExampleFromFile(LabeledExample):
    """File-backed example: decode + resample to 16 kHz on first feature access."""

    def __init__(self,
                 audio_file: Path,
                 id: Optional[str] = None,
                 sample_rate_to_convert_to: int = 16000,
                 label: Optional[str] = "nolabel",
                 fourier_window_length: int = 512,
                 hop_length: int = 128,
                 mel_frequency_count: int = 128,
                 label_with_tags: Optional[str] = None,
                 positional_label: Optional[PositionalLabel] = None):
        if id is None:
            id = name_without_extension(audio_file)
        self.audio_file = Path(audio_file)
        # A bound method rather than a lambda keeps instances picklable, which the
        # multiprocessing cache fill requires (the reference's lambda-based design made its
        # pool workers fail silently).
        super().__init__(
            id=id, get_raw_audio=self._load_audio,
            label=label, sample_rate=sample_rate_to_convert_to,
            fourier_window_length=fourier_window_length, hop_length=hop_length,
            mel_frequency_count=mel_frequency_count,
            label_with_tags=label_with_tags, positional_label=positional_label)

    def _load_audio(self) -> np.ndarray:
        return audio_io.load_audio(self.audio_file, self.sample_rate)

    @property
    def audio_directory(self) -> Path:
        return self.audio_file.parent

    @cached_property
    def original_sample_rate(self) -> int:
        return LabeledExampleFromFile.file_sample_rate(self.audio_file)

    @staticmethod
    def file_sample_rate(audio_file: Path) -> int:
        return audio_io.file_sample_rate(audio_file)

    @cached_property
    def duration_in_s(self) -> float:
        return audio_io.probe_duration_in_s(self.audio_file)

    def sections(self) -> Optional[List[LabeledExample]]:
        """Slice the audio into per-word examples using the positional label (seconds)."""
        if self.positional_label is None:
            return None
        audio = self.get_raw_audio()

        def section(word: str, start: float, end: float) -> LabeledExample:
            return LabeledExample(
                get_raw_audio=lambda: audio[int(start * self.sample_rate):int(end * self.sample_rate)],
                label=word, sample_rate=self.sample_rate,
                fourier_window_length=self.fourier_window_length, hop_length=self.hop_length,
                mel_frequency_count=self.mel_frequency_count)

        return [section(word, start, end)
                for word, (start, end) in self.positional_label.labeled_sections]


class CachedLabeledSpectrogram(LabeledSpectrogram):
    """Disk-cached features keyed by example id, with the reference's repair semantics
    (`labeled_example.py:236-287`)."""

    def __init__(self, original: LabeledSpectrogram, spectrogram_cache_directory: Path):
        super().__init__(id=original.id, label=original.label)
        self.original = original
        self.spectrogram_cache_file = Path(spectrogram_cache_directory) / "{}.npy".format(original.id)

    # Tolerance of the repair sweep: matches the reference's 1-decimal comparison
    # (abs difference below 1.5e-1 counts as equal).
    _REPAIR_ATOL = 1.5e-1

    def is_cached(self) -> bool:
        return self.spectrogram_cache_file.exists()

    def z_normalized_transposed_spectrogram(self) -> np.ndarray:
        cached = self._read_cache_entry()
        return cached if cached is not None else self._refresh_cache_entry()

    def z_normalized_raw_wave(self) -> np.ndarray:
        # Raw audio is not disk-cached: decoding it is cheap relative to the feature
        # DSP this cache exists to skip.
        return self.original.z_normalized_raw_wave()

    def _read_cache_entry(self) -> Optional[np.ndarray]:
        """The cache entry's array, or None if it is absent or unreadable."""
        if not self.is_cached():
            return None
        try:
            return np.load(str(self.spectrogram_cache_file))
        except (ValueError, OSError, EOFError):  # truncated / corrupt entry
            log("feature cache entry {} is unreadable; recomputing it".format(
                self.spectrogram_cache_file))
            return None

    def _refresh_cache_entry(self) -> np.ndarray:
        features = self.original.z_normalized_transposed_spectrogram()
        np.save(str(self.spectrogram_cache_file), features)
        return features

    def repair_cached_file_if_incorrect(self) -> None:
        """Recompute this entry; if the cached copy deviates, quarantine it and re-save."""
        cached = self._read_cache_entry()
        if cached is None:
            self._refresh_cache_entry()
            return
        computed = self.original.z_normalized_transposed_spectrogram()
        mismatch = (cached.shape != computed.shape or
                    not np.allclose(cached, computed, rtol=0.0, atol=self._REPAIR_ATOL))
        if mismatch:
            if cached.shape != computed.shape:
                report = "shape mismatch: cached {} vs computed {}".format(
                    cached.shape, computed.shape)
            else:
                deviation = np.abs(cached - computed)
                report = "max |cached - computed| = {:g} at {} ({} elements over {:g})".format(
                    deviation.max(), np.unravel_index(deviation.argmax(), deviation.shape),
                    int((deviation > self._REPAIR_ATOL).sum()), self._REPAIR_ATOL)
            self._quarantine_incorrect_cache(report)
            np.save(str(self.spectrogram_cache_file), computed)

    def _quarantine_incorrect_cache(self, report: str) -> None:
        """Move the bad entry into a sibling ``<cache>-incorrect/`` dir with a report file."""
        cache_dir = self.spectrogram_cache_file.parent
        quarantine = cache_dir.parent / (cache_dir.name + "-incorrect")
        mkdir(quarantine)
        write_text(quarantine / (self.spectrogram_cache_file.stem + "-error.txt"), report)
        self.spectrogram_cache_file.rename(quarantine / self.spectrogram_cache_file.name)
