"""Spectrogram and waveform figures (port of `speechless_tpu/io/plotting.py`;
matplotlib, imported inside the calls that draw).

Provides the plotting surface of the reference's example plotter
(the reference's `labeled_example_plotter.py`): render or save a spectrogram
image for any (type x frequency-scale) combination, plot raw / istft-reconstructed audio,
and export the reconstruction as a wav. The rendering itself is original: spectrograms are
drawn by row index with tick labels mapped back to physical frequency, which works uniformly
for the linear and mel scales instead of warping the axis into mel units.
"""
from pathlib import Path
from typing import Optional, Sequence

import numpy as np

from ..features.audio_io import write_wav
from ..features.example import LabeledExample, SpectrogramFrequencyScale, SpectrogramType

_FIGURE_SIZE = (12.8, 7.2)
_FREQUENCY_TICK_COUNT = 9


def _colorbar_caption(type: SpectrogramType) -> str:
    if type == SpectrogramType.power_level:
        return "power level / dB (relative; floor -150)"
    if type == SpectrogramType.power:
        return "power (linear, unnormalized)"
    return "amplitude (linear, unnormalized)"


def _frequency_ticks(row_frequencies_hz: Sequence[float]):
    """Pick ~evenly spaced row indices and label each with its physical frequency."""
    rows = len(row_frequencies_hz)
    positions = np.unique(np.linspace(0, rows - 1, _FREQUENCY_TICK_COUNT).round().astype(int))
    labels = ["%.0f" % row_frequencies_hz[p] for p in positions]
    return positions, labels


class LabeledExamplePlotter:
    """Renders figures for one :class:`LabeledExample`."""

    def __init__(self, example: LabeledExample):
        self.example = example

    # -- waveform plots ----------------------------------------------------

    def _plot_audio(self, audio: np.ndarray) -> None:
        import matplotlib.pyplot as plt

        seconds = np.arange(len(audio)) / self.example.sample_rate
        figure, axes = plt.subplots(figsize=_FIGURE_SIZE)
        axes.plot(seconds, audio, linewidth=0.5)
        axes.set_title(str(self.example))
        axes.set_xlabel("time / s ({} Hz)".format(self.example.sample_rate))
        axes.set_ylabel("amplitude")
        plt.show()

    def plot_raw_audio(self) -> None:
        self._plot_audio(self.example.get_raw_audio())

    def plot_reconstructed_audio_from_spectrogram(self) -> None:
        self._plot_audio(self.example.reconstructed_audio_from_spectrogram())

    def save_reconstructed_audio_from_spectrogram(self, target_directory: Path) -> None:
        name = "{}_window{}_hop{}.wav".format(self.example.id,
                                              self.example.fourier_window_length,
                                              self.example.hop_length)
        write_wav(Path(target_directory) / name,
                  self.example.reconstructed_audio_from_spectrogram(),
                  self.example.sample_rate)

    # -- spectrogram figures -----------------------------------------------

    def prepare_spectrogram_plot(
            self, type: SpectrogramType = SpectrogramType.power_level,
            frequency_scale: SpectrogramFrequencyScale = SpectrogramFrequencyScale.linear
    ) -> None:
        """Build (but do not show/save) the figure for the requested spectrogram variant."""
        import matplotlib.pyplot as plt

        spec = self.example.spectrogram(type, frequency_scale=frequency_scale)
        rows = spec.shape[0]
        is_mel = frequency_scale == SpectrogramFrequencyScale.mel
        if is_mel:
            # Row centers of the mel filterbank (mel_frequencies() includes the 2 edge bands).
            row_hz = self.example.mel_frequencies()[1:-1]
        else:
            row_hz = list(np.linspace(0.0, self.example.highest_detectable_frequency(), rows))

        figure, axes = plt.subplots(figsize=_FIGURE_SIZE)
        image = axes.imshow(spec, origin="lower", aspect="auto", cmap="magma",
                            interpolation="nearest",
                            extent=(0.0, self.example.duration_in_s, -0.5, rows - 0.5))
        step_ms = 1000.0 / self.example.time_step_rate()
        axes.set_title("{} | {}{} spectrogram".format(
            self.example, "mel " if is_mel else "", type.value), wrap=True)
        axes.set_xlabel("time / s (one column per {:.1f} ms)".format(step_ms))
        axes.set_ylabel("{} band ({} rows, labels in Hz)".format(
            "mel" if is_mel else "linear", rows))
        positions, labels = _frequency_ticks(row_hz)
        axes.set_yticks(positions)
        axes.set_yticklabels(labels)
        figure.colorbar(image, ax=axes, label=_colorbar_caption(type))
        figure.tight_layout()

    def show_spectrogram(self, type: SpectrogramType = SpectrogramType.power_level) -> None:
        import matplotlib.pyplot as plt

        self.prepare_spectrogram_plot(type)
        plt.show()

    def save_spectrogram(
            self, target_directory: Path,
            type: SpectrogramType = SpectrogramType.power_level,
            frequency_scale: SpectrogramFrequencyScale = SpectrogramFrequencyScale.linear
    ) -> Path:
        import matplotlib
        matplotlib.use("Agg", force=False)
        import matplotlib.pyplot as plt

        self.prepare_spectrogram_plot(type, frequency_scale)
        name = "{}_{}{}_spectrogram.png".format(
            self.example.id,
            "mel_" if frequency_scale == SpectrogramFrequencyScale.mel else "",
            type.value.replace(" ", "_"))
        path = Path(target_directory) / name
        plt.savefig(str(path))
        plt.close("all")
        return path

    def save_spectrograms_of_all_types(self, target_directory: Path) -> None:
        for type in SpectrogramType:
            for frequency_scale in SpectrogramFrequencyScale:
                self.save_spectrogram(target_directory=target_directory, type=type,
                                      frequency_scale=frequency_scale)
