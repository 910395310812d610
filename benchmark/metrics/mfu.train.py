"""The whole train step's share of the card's bf16 peak: model FLOPs of the window's
utterances at their own frames, for the job (forward of every layer, weight gradient of
the trainable ones, data gradient above the lowest trainable one), over 989 TFLOP/s and
the window's length on the trace's clock (its ``bench/window`` span, profiler's cost
included)."""
from benchmark.harness import yardstick


def read(record):
    seconds = record.trace["window_s"]
    return 100.0 * record.work["model_flops"] / seconds / yardstick.BF16_FLOPS_PER_S
