"""The attention core's share of the window: the summed device time of the kernels of
`layers/rel_attention.json` (the fused scores, softmax and value product, forward and
backward, with the position term as their additive mask) over the window's length on the
trace's clock. Building the position term is left out, so this is a lower bound of the
attention's share."""
from benchmark.harness import core
from benchmark.harness.trace import layer_seconds


def read(record):
    seconds, launches = layer_seconds(record, core.load_json("layers", "rel_attention"))
    if not launches:
        return None
    return 100.0 * seconds / record.trace["window_s"]
