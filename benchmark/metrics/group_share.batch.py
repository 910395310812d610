"""The share of the window the host spends producing the Transcriber's padded groups:
the summed ``transcribe.group`` spans (sorting a call's requests into length buckets and
padding the next group's rows), over the window's length on the trace's clock. The card
has no work queued from this call meanwhile, so it is a part of ``starved_share.batch``."""
from benchmark.harness import program_trace


def read(record):
    recorded = program_trace.snapshot()
    if recorded is None:
        return None
    groups = [kept for kept in recorded["spans"] if kept["name"] == "transcribe.group"]
    if not groups:
        return None
    return program_trace.window_share(
        record, sum(program_trace.length_ns(kept) for kept in groups) / 1e9)
