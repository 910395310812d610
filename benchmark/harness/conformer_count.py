"""The model FLOPs of a Conformer-CTC training step and the bytes of its CTC layer, kept
here, beside `yardstick`, so that no change to the program can move them.

FLOPs are counted as `yardstick` counts wav2letter's: 2 x the multiply-adds of each GEMM
and conv of one utterance at its own frames (biases, norms, activations, softmax and the
position term's shift left out):

* subsampling: Conv2d 1 -> C and C -> C (3 x 3 taps, stride 2 in time and frequency),
  then Linear(C x F'' -> d) on each of the T' frames;
* each block: two FFs (d -> 4d -> d), the q, k, v and output projections (d -> d), the
  content scores, the position scores (each query against the T' offsets its keys take,
  not the 2T' - 1 the program multiplies) and the value product (2 T'^2 d each), the
  pointwise convs (d -> 2d, d -> d) and the depthwise conv (K taps a channel);
* the head, d -> classes.

W_pos's projection of the position table is left out: the program computes it once a
batch, at the padded length, so it belongs to no utterance. A training step is three
forwards' worth (each GEMM's data and weight gradients; the score products' two operand
gradients), less the first conv's data gradient, which the features do not need.
"""
from typing import Dict, Iterable

from benchmark.harness import yardstick


def subsampled(length: int) -> int:
    return (length - 1) // 2 + 1


def out_frames(frames: int) -> int:
    return subsampled(subsampled(frames))


def forward_flops(config: dict, frames: int) -> Dict[str, float]:
    """Forward FLOPs of one utterance of ``frames`` feature frames, by part."""
    d, channels = config["d_model"], config["subsampling_conv_channels"]
    t1, f1 = subsampled(frames), subsampled(config["feat_in"])
    t, f2 = subsampled(t1), subsampled(f1)
    inner = config["ff_expansion_factor"] * d
    block = (2 * 2 * (2.0 * t * d * inner)             # two FFs, two GEMMs each
             + 4 * 2.0 * t * d * d                     # q, k, v, output projections
             + 3 * 2.0 * t * t * d                     # content, position, value product
             + 2.0 * t * d * 2 * d + 2.0 * t * d * d   # pointwise convs
             + 2.0 * t * d * config["conv_kernel_size"])  # depthwise conv
    return {"conv1": 2.0 * t1 * f1 * channels * 9,
            "conv2": 2.0 * t * f2 * channels * channels * 9,
            "subsampling_out": 2.0 * t * channels * f2 * d,
            "blocks": config["n_layers"] * block,
            "head": 2.0 * t * d * config["classes"]}


def train_flops(config: dict, frames: int) -> float:
    """Model FLOPs of one training step on one utterance of ``frames`` frames."""
    parts = forward_flops(config, frames)
    return 3 * sum(parts.values()) - parts["conv1"]


def batch_work(config: dict, frames: Iterable[int], label_counts: Iterable[int],
               cache: Dict[int, float]) -> tuple:
    """(model FLOPs, CTC bytes) of one step's rows; ``cache`` keeps each length's
    FLOPs."""
    frames = [int(n) for n in frames]
    flops = 0.0
    for length in frames:
        if length not in cache:
            cache[length] = train_flops(config, length)
        flops += cache[length]
    return flops, yardstick.ctc_bytes([out_frames(n) for n in frames], label_counts,
                                      config["classes"])
