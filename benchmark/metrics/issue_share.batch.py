"""The share of the window the host spends issuing the Transcriber's dispatches: the
summed ``transcribe.copy`` (inputs to the card), ``transcribe.model`` (features, model
and log-softmax) and ``transcribe.decode`` (the beam) spans, over the window's length
on the trace's clock."""
from benchmark.harness import program_trace

ISSUE = ("transcribe.copy", "transcribe.model", "transcribe.decode")


def read(record):
    recorded = program_trace.snapshot()
    if recorded is None:
        return None
    issued = [kept for kept in recorded["spans"] if kept["name"] in ISSUE]
    if not issued:
        return None
    return program_trace.window_share(
        record, sum(program_trace.length_ns(kept) for kept in issued) / 1e9)
