"""The share of the window in which the Transcriber has queued no work for the card:
each ``transcribe.batch`` span's length less its dispatches' intervals from the start
of their ``transcribe.copy`` (the inputs' copy) to the end of their ``transcribe.fetch``
(the wait for the results), over the window's length on the trace's clock. Grouping
and padding the next bucket, and the text of the last, fall in it."""
from benchmark.harness import program_trace


def read(record):
    recorded = program_trace.snapshot()
    if recorded is None:
        return None
    spans = recorded["spans"]
    batches = [kept for kept in spans if kept["name"] == "transcribe.batch"]
    if not batches:
        return None
    below = program_trace.children(spans)
    starved = 0
    for batch in batches:
        starved += program_trace.length_ns(batch)
        for dispatch in below[batch["id"]]:
            if dispatch["name"] == "transcribe.dispatch":
                stages = {kept["name"]: kept for kept in below[dispatch["id"]]}
                starved -= (stages["transcribe.fetch"]["end_ns"]
                            - stages["transcribe.copy"]["start_ns"])
    return program_trace.window_share(record, starved / 1e9)
