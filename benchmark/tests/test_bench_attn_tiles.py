"""The Conformer cell's tile share (`metrics/attn_tile_share.train.py`) on the CPU: the
reader on given counters, and a traced run of the cell at a small size (the
configuration and traffic of `test_bench_conformer.py`) with and without the attention
kernel's route, which the CPU takes only when it is forced (the kernel's plain version
then stands in for the kernel pair, which takes only CUDA tensors)."""
import time

import pytest

from benchmark.harness import core, program_trace

CELL = "train-conformer-l-en-resident"
ORIGINAL_LOAD = core.load_json
SMALL_CONFIG = dict(ORIGINAL_LOAD("configs", "conformer-ctc-l-char-en"), n_layers=2,
                    d_model=64, n_heads=4, conv_kernel_size=7, subsampling_conv_channels=8,
                    feat_in=16)
SMALL_TRAFFIC = {"utterances": 24, "bucket_frames": 600, "features": 16, "batch": 4,
                 "steps_per_call": 2, "labels_per_second": 5,
                 "lengths": {"distribution": "normal", "mean_s": 3.0, "sd_s": 1.0,
                             "min_s": 0.5, "max_s": 5.9}}


def read(snapshot, monkeypatch):
    monkeypatch.setattr(program_trace, "snapshot", lambda: snapshot)
    return core.load_module("metrics", "attn_tile_share.train").read(None)


def test_the_tile_share_reader(monkeypatch):
    counters = {"conformer.attn_tiles": 3200, "conformer.attn_tiles_run": 1044,
                "conformer.attn_pairs": 400}
    assert read({"counters": counters}, monkeypatch) == pytest.approx(32.625)
    assert read({"counters": {"conformer.attn_pairs": 400}}, monkeypatch) is None
    assert read(None, monkeypatch) is None


@pytest.mark.parametrize("kernel_route", [True, False], ids=["kernel-route", "library-route"])
def test_a_traced_run_reads_the_tile_share_only_on_the_kernel_route(monkeypatch,
                                                                    kernel_route):
    from speechless_tpu_torch.ops import rel_attention

    monkeypatch.setattr(core, "load_json", lambda kind, name: SMALL_CONFIG
                        if kind == "configs" else ORIGINAL_LOAD(kind, name))
    if kernel_route:  # the kernel takes only CUDA tensors: its plain version stands in
        monkeypatch.setattr(rel_attention, "takes_kernel", lambda *args: True)
        monkeypatch.setattr(rel_attention, "rel_attention",
                            rel_attention.rel_attention_reference)
    result, checks, _ = core.run_cell(CELL, 2**31 + 11, 0.5, True, "cpu",
                                      time.perf_counter(), overrides=SMALL_TRAFFIC)
    assert result["correct"], checks
    metrics = result["metrics"]
    if not kernel_route:
        assert "attn_tile_share.train" not in metrics
        return
    share = metrics["attn_tile_share.train"]["value"]
    # 600 frames at a 10 ms hop: 150 after subsampling, three tiles a side; the rows'
    # own frames cover fewer tiles than their pairs' share of the padded grid
    assert 100.0 - metrics["attn_pad_share.train"]["value"] < share < 100
