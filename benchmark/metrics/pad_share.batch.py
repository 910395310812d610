"""The share of the samples the Transcriber's dispatches compute that is padding: one
less the rows' own samples (counter ``transcribe.samples_own``) over rows times their
length bucket's samples (``transcribe.samples``)."""
from benchmark.harness import program_trace


def read(record):
    return program_trace.pad_share("transcribe.samples", "transcribe.samples_own")
