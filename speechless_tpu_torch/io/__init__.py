"""Microphone recording and spectrogram figures (port of `speechless_tpu/io`)."""
from .plotting import LabeledExamplePlotter
from .recording import Recorder, record_plot_and_save

__all__ = ["Recorder", "record_plot_and_save", "LabeledExamplePlotter"]
