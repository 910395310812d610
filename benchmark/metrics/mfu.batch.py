"""The whole serving dispatch's share of the card's fp32 peak: forward FLOPs of each
transcribed request at its own frames over 67 TFLOP/s (the model serves in IEEE fp32)
and the window's length on the trace's clock (its ``bench/window`` span, profiler's cost
included)."""
from benchmark.harness import yardstick


def read(record):
    seconds = record.trace["window_s"]
    return 100.0 * record.work["model_flops"] / seconds / yardstick.FP32_OPS_PER_S
