"""The share of the frames the resident training steps compute that is padding: one
less the gathered rows' own frames (counter ``train.frames_own``) over rows times the
corpus's padded frames (``train.frames``)."""
from benchmark.harness import program_trace


def read(record):
    return program_trace.pad_share("train.frames", "train.frames_own")
