"""The arithmetic the metrics are measured with, kept here so that no change to the
program can move it: the card's peaks, the least time of a layer (`bound`), the model
FLOPs of a job, and the bytes a layer's own inputs and outputs take.

Peaks are NVIDIA's data sheet for one H100 SXM (dense, at the 700 W limit).
"""
import math
from typing import Iterable, List, Sequence

HBM_BYTES_PER_S = 3.35e12
FP32_OPS_PER_S = 67e12      # IEEE fp32 outside the tensor cores
BF16_FLOPS_PER_S = 989e12   # bf16 tensor cores


def bound(bytes_moved: float, operations: float = 0.0) -> float:
    """Least seconds the card could take: the larger of bytes over the memory rate and
    operations over the fp32 rate."""
    return max(bytes_moved / HBM_BYTES_PER_S, operations / FP32_OPS_PER_S)


def out_frames(frames: int, stride: int) -> int:
    return -(-frames // stride)  # SAME padding


def layer_flops(layers: Sequence[dict], input_size: int, frames: int) -> List[float]:
    """Forward FLOPs of each conv layer for one utterance of ``frames`` input frames:
    ``2 * T_out * K * C_in * C_out`` (bias and activation left out)."""
    flops, channels = [], input_size
    for layer in layers:
        frames = out_frames(frames, layer["stride"])
        flops.append(2.0 * frames * layer["kernel_size"] * channels * layer["filters"])
        channels = layer["filters"]
    return flops


def train_flops(layers: Sequence[dict], input_size: int, frames: int,
                frozen_layers: int = 0) -> float:
    """Model FLOPs of one training step on one utterance of ``frames`` frames for the
    job: the forward of every layer, the weight gradient of each trainable layer, and
    the data gradient of each layer above the lowest trainable one (each one forward's
    worth)."""
    forward = layer_flops(layers, input_size, frames)
    total = sum(forward)
    for index, flops in enumerate(forward):
        if index >= frozen_layers:
            total += flops  # weight gradient
        if index > frozen_layers:
            total += flops  # data gradient into the layer below
    return total


def serve_flops(layers: Sequence[dict], input_size: int, frames: int) -> float:
    return sum(layer_flops(layers, input_size, frames))


def feature_frames(samples: int, hop: int = 128) -> int:
    """Feature frames of ``samples`` 16 kHz samples (centred STFT, hop 128)."""
    return 1 + samples // hop


def ctc_bytes(logit_frames: Iterable[int], label_counts: Iterable[int],
              classes: int) -> float:
    """Bytes of the CTC layer's own inputs and outputs for one batch: each utterance's
    fp32 logits read once and their gradient written once, its labels (int32) read,
    its loss written, and its two lengths read."""
    total = 0.0
    for frames, labels in zip(logit_frames, label_counts):
        total += 2 * 4 * frames * classes + 4 * labels + 4 + 8
    return total


def span_bytes(rows: int, frames: int, k: int, classes: int, lanes: int) -> float:
    """Bytes of the LM beam span's inputs and outputs for one dispatch: the packed frame
    rows (top-k scores and ids and the class row, fp32) read, the carry (6 fp32/int32
    blocks and the trie node and two-word context) read and written, the parent and
    character backpointers (int32) written. The word-LM table bytes the beams touch
    depend on the search and are left out, so the count is a lower bound."""
    frame_rows = rows * frames * (2 * k + classes) * 4
    carry = rows * lanes * (6 + 3) * 4
    backpointers = rows * frames * lanes * 4 * 2
    return frame_rows + 2 * carry + backpointers


def next_pow2(value: int) -> int:
    return 1 << max(0, math.ceil(math.log2(max(value, 1))))
