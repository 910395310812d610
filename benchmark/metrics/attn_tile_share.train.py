"""The share of the Conformer attention's 64 x 64 tiles that its kernel pair runs: the
rows' own ceil(len / 64)^2 tiles (counter ``conformer.attn_tiles_run``) over rows times
the padded grid's tiles (``conformer.attn_tiles``), summed over the traced steps. A port
whose attention has no such kernel counts no tiles, and the metric is left out."""
from benchmark.harness import program_trace


def read(record):
    recorded = program_trace.snapshot()
    if recorded is None or not recorded["counters"].get("conformer.attn_tiles"):
        return None
    counters = recorded["counters"]
    return 100.0 * counters["conformer.attn_tiles_run"] / counters["conformer.attn_tiles"]
