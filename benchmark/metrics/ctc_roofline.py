"""The CTC layer's share of its roofline: the least time its own inputs and outputs
take (each utterance's logits read and gradient written once at its own frames, labels,
losses and lengths) over the summed device time of the kernels of `layers/ctc.json`."""
from benchmark.harness import core, yardstick
from benchmark.harness.trace import layer_seconds


def read(record):
    seconds, launches = layer_seconds(record, core.load_json("layers", "ctc"))
    if not launches:
        return None
    return 100.0 * yardstick.bound(record.work["ctc_bytes"]) / seconds
