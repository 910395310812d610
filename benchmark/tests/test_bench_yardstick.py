"""The yardstick's arithmetic against figures worked out by hand."""
import json

import pytest

from benchmark.harness import core, yardstick

LAYERS = core.load_json("configs", "w2l-mel-en")["layers"]


def test_big_conv_1_forward_at_the_bench_batch():
    # 64 rows of 1,025 feature frames -> 513 frames after the stride-2 conv.
    flops = 64 * yardstick.layer_flops(LAYERS, 128, 1025)[8]
    assert flops == 2 * 64 * 513 * 250 * 2000 * 32
    assert flops == pytest.approx(1.05e12, rel=1e-3)


def test_forward_of_one_3072_frame_row():
    # 1,536 frames: 4.718 + 7 x 1.344 + 49.152 + 12.288 + 0.178 GFLOP.
    expected = 2 * 1536 * (48 * 128 * 250 + 7 * 7 * 250 * 250 + 32 * 250 * 2000
                           + 2000 * 2000 + 2000 * 29)
    assert yardstick.serve_flops(LAYERS, 128, 3072) == expected
    assert expected == pytest.approx(75.75e9, rel=1e-3)


def test_train_job_counts():
    forward = yardstick.layer_flops(LAYERS, 128, 3072)
    # Full training: every weight gradient, data gradients of layers 1-10.
    assert yardstick.train_flops(LAYERS, 128, 3072) == pytest.approx(
        3 * sum(forward) - forward[0])
    # Freeze 8: weight gradients of layers 8-10, data gradients of layers 9 and 10.
    de = core.load_json("configs", "w2l-mel-de")["layers"]
    forward_de = yardstick.layer_flops(de, 128, 3072)
    assert yardstick.train_flops(de, 128, 3072, frozen_layers=8) == pytest.approx(
        sum(forward_de) + sum(forward_de[8:]) + sum(forward_de[9:]))
    # 75.77 forward + 61.64 weight gradients + 12.49 data gradients: ~150 GFLOP a row.
    assert yardstick.train_flops(de, 128, 3072, 8) == pytest.approx(149.9e9, rel=1e-3)
    assert yardstick.train_flops(LAYERS, 128, 3072) == pytest.approx(222.5e9, rel=1e-3)


def test_ctc_bytes_are_the_layer_inputs_and_outputs():
    # Two utterances: 100 and 50 logit frames of 29 classes, 30 and 10 labels.
    assert yardstick.ctc_bytes([100, 50], [30, 10], 29) == \
        2 * 4 * 29 * 150 + 4 * 40 + 2 * (4 + 8)


def test_span_bytes_of_one_dispatch():
    # 16 rows x 513 frames, k = 8 of 29 classes, 32 lanes.
    frames = 16 * 513 * (2 * 8 + 29) * 4
    carry = 2 * 16 * 32 * 9 * 4
    backpointers = 16 * 513 * 32 * 4 * 2
    assert yardstick.span_bytes(16, 513, 8, 29, 32) == frames + carry + backpointers


def test_bound_takes_the_larger_of_bytes_and_operations():
    assert yardstick.bound(3.35e12) == pytest.approx(1.0)
    assert yardstick.bound(0.0, 67e12) == pytest.approx(1.0)
    assert yardstick.bound(3.35e9, 67e12) == pytest.approx(1.0)


def test_config_files_state_the_port_widths():
    for name in ("w2l-mel-en", "w2l-mel-de"):
        config = core.load_json("configs", name)
        assert [l["filters"] for l in config["layers"][:-1]] == [250] * 8 + [2000] * 2
        assert config["layers"][-1]["filters"] == config["classes"] == \
            len(config["alphabet"]) + 1
        json.dumps(config)
