"""The Conformer training cell's own files on the CPU: its FLOP count against a hand
count, its metric readers, and the cell run end to end at a small size (a 2-block,
64-wide Conformer in the configuration's place, a corpus of 24 short rows): a sound run
is correct, each planted fault and the fp8 control fail the cell's limits, and a port
without the Conformer fails before any input is made."""
import sys
import time

import pytest

from benchmark.harness import conformer_count, core
from benchmark.harness.core import Record

CELL = "train-conformer-l-en-resident"
ORIGINAL_LOAD = core.load_json
SMALL_CONFIG = dict(ORIGINAL_LOAD("configs", "conformer-ctc-l-char-en"), n_layers=2,
                    d_model=64, n_heads=4, conv_kernel_size=7, subsampling_conv_channels=8,
                    feat_in=16)
SMALL_TRAFFIC = {"utterances": 24, "bucket_frames": 160, "features": 16, "batch": 4,
                 "steps_per_call": 2, "labels_per_second": 5,
                 "lengths": {"distribution": "normal", "mean_s": 1.0, "sd_s": 0.3,
                             "min_s": 0.5, "max_s": 1.5}}


def test_flops_match_a_hand_count():
    config = {"feat_in": 16, "d_model": 8, "n_heads": 2, "n_layers": 1,
              "ff_expansion_factor": 4, "conv_kernel_size": 3,
              "subsampling_conv_channels": 4, "classes": 5}
    # 10 frames, 16 frequencies -> 5 x 8 after the first conv, 3 x 4 after the second.
    parts = conformer_count.forward_flops(config, 10)
    assert parts == {"conv1": 2 * 5 * 8 * 4 * 9,
                     "conv2": 2 * 3 * 4 * 4 * 4 * 9,
                     "subsampling_out": 2 * 3 * 16 * 8,
                     "blocks": 2 * (2 * 3 * 8 * 32 + 2 * 3 * 32 * 8)   # two FFs
                     + 4 * 2 * 3 * 8 * 8                               # q, k, v, out
                     + 3 * 2 * 3 * 3 * 8                               # scores, values
                     + 2 * 3 * 8 * 16 + 2 * 3 * 8 * 8                  # pointwise convs
                     + 2 * 3 * 8 * 3,                                  # depthwise conv
                     "head": 2 * 3 * 8 * 5}
    assert conformer_count.train_flops(config, 10) == 3 * 16752 - 2880
    flops, ctc_bytes = conformer_count.batch_work(config, [10, 10], [2, 1], {})
    assert flops == 2 * (3 * 16752 - 2880)
    assert ctc_bytes == 2 * (2 * 4 * 3 * 5 + 4 + 8) + 4 * 3  # logits, lengths; labels


def test_the_large_configuration_counts_a_padded_step():
    config = ORIGINAL_LOAD("configs", "conformer-ctc-l-char-en")
    parts = conformer_count.forward_flops(config, 2464)
    assert parts["conv2"] == 2 * 616 * 20 * 512 * 512 * 9   # 58.1 GFLOP an utterance
    assert 20e12 < 32 * conformer_count.train_flops(config, 2464) < 22e12


def record_with(kernels=None):
    r = Record(CELL, {}, {}, 1, 10.0, True, 0.0)
    r.trace = {"window_s": 10.0, "busy_s": 9.9, "kernels": kernels or {}}
    return r


def test_the_attention_readers(monkeypatch):
    from benchmark.harness import program_trace

    read = core.load_module("metrics", "rel_attention_share.train").read
    kernels = {"fmha_cutlassF_bf16_aligned_64x64_rf_sm80(Params)": [1.5, 100],
               "fmha_cutlassB_bf16_aligned_64x64_k64_sm80(Params)": [2.5, 100],
               "ctc_alpha_kernel": [0.1, 10]}
    assert read(record_with(kernels)) == pytest.approx(40.0)
    assert read(record_with({"ctc_alpha_kernel": [0.1, 10]})) is None
    monkeypatch.setattr(program_trace, "snapshot", lambda: {
        "counters": {"conformer.attn_pairs": 400, "conformer.attn_pairs_own": 100}})
    assert core.load_module("metrics", "attn_pad_share.train").read(None) == 75.0
    monkeypatch.setattr(program_trace, "snapshot", lambda: {"counters": {}})
    assert core.load_module("metrics", "attn_pad_share.train").read(None) is None


@pytest.fixture
def small_cell(monkeypatch):
    monkeypatch.setattr(core, "load_json", lambda kind, name: SMALL_CONFIG
                        if kind == "configs" else ORIGINAL_LOAD(kind, name))

    def run(fault=None, trace=False):
        return core.run_cell(CELL, 2**31 + 5, 0.5, trace, "cpu", time.perf_counter(),
                             overrides=SMALL_TRAFFIC, fault=fault)

    return run


def test_a_sound_traced_run_is_correct_and_reads_its_shares(small_cell):
    result, checks, cell = small_cell(trace=True)
    assert result["correct"], checks
    assert result["attempted"] > 0 and result["failed"] == 0
    metrics = result["metrics"]
    assert {"mfu.train", "idle_share.train", "pad_share.train",
            "attn_pad_share.train"} <= set(metrics)
    assert 0 < metrics["attn_pad_share.train"]["value"] < 100
    assert metrics["pad_share.train"]["value"] < metrics["attn_pad_share.train"]["value"]
    driver = core.load_module("drivers", "train_conformer_resident")
    limits = ORIGINAL_LOAD("limits", CELL)
    control = dict(driver.control(cell))
    assert any(control[name] > limit for name, limit in limits.items()), control


@pytest.mark.parametrize("fault", ["unchanged_state", "half_batch"])
def test_a_fault_is_not_correct(small_cell, fault):
    result, checks, _ = small_cell(fault=fault)
    assert not result["correct"], checks


def test_a_port_without_the_conformer_fails_before_making_inputs(small_cell, monkeypatch):
    import speechless_tpu_torch.models

    monkeypatch.setitem(sys.modules, "speechless_tpu_torch.models.conformer", None)
    monkeypatch.delattr(speechless_tpu_torch.models, "conformer", raising=False)
    made = []
    driver = core.load_module("drivers", "train_conformer_resident")
    monkeypatch.setattr(core, "load_module", lambda kind, name: driver)
    monkeypatch.setattr(driver, "corpus", lambda *args: made.append(args))
    with pytest.raises(ImportError):
        small_cell()
    assert not made


def test_the_reference_and_the_count_load_nothing_of_the_port():
    import json
    import subprocess

    out = subprocess.run(
        [sys.executable, "-c",
         "import sys, json; sys.path.insert(0, '.')\n"
         "import benchmark.reference.conformer, benchmark.harness.conformer_count\n"
         "print(json.dumps(sorted(m for m in sys.modules if m.split('.')[0] in "
         "('speechless_tpu_torch', 'speechless_tpu', 'jax'))))"],
        cwd=core.ROOT, capture_output=True, text=True, timeout=300,
        env={"PATH": "/usr/bin:/bin", "OMP_NUM_THREADS": "2"})
    assert out.returncode == 0, out.stderr[-3000:]
    assert json.loads(out.stdout.strip().splitlines()[-1]) == []
