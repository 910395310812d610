"""The LM beam span kernel's share of its roofline: the least time of each dispatch's
frame rows, carry and backpointers (`yardstick.span_bytes`, the LM table reads left
out) over the summed device time of the kernels of `layers/lm_span.json`."""
from benchmark.harness import core, yardstick
from benchmark.harness.trace import layer_seconds


def read(record):
    seconds, launches = layer_seconds(record, core.load_json("layers", "lm_span"))
    if not launches:
        return None
    return 100.0 * yardstick.bound(record.work["span_bytes"]) / seconds
