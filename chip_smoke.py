#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port's LM-fused serving path on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the beam-step kernel from ``speechless_tpu_torch/csrc/`` with nvcc for sm_90a,
then:

* phase A: `lm_step` (the kernel) against `lm_step_reference` (plain PyTorch) on the
  same CUDA tensors at the serving shapes (16 rows, r=32, k=8, 29 classes): integer
  outputs equal, float outputs bitwise equal or within 1e-6; both timed with CUDA
  events. The same check, bitwise, at other lane counts (16 to 1024 candidates per
  row). Then a full `beam_search_decode_lm` over 513 frames (8 s of audio) through the
  kernel and through the plain step: tokens identical.
* phase B: the full-width wav2letter (seeded random weights, output layer scaled for
  peaky frames), a word LM built by the port's `arpa_builder` from sentences of this
  repository's README, `Transcriber(kenlm_directory=..., device="cuda:0")` behind
  `TranscriptionServer(port=0)`. Five concurrent JSON requests and one octet-stream
  request of 1.6-8 s seeded audio, served in one batch where two of them share a length
  bucket, must answer 200 with the text of a direct `transcribe_batch` call, and the
  kernel's launch count must rise while they are served. The shared bucket's
  log-probs must match the same model on the CPU (the path runs in fp32 with TF32 off
  whatever the process-wide flags say) and its transcripts the plain-step beam. Prints
  per-request latency and the `transcribe_batch` rate at 16 x 8 s.
* with ``--profile`` only: the split of one 16 x 8 s `transcribe_batch` into features,
  model and beam, single-request latencies, and the device's busy share and kernel
  counts from one `torch.profiler` trace, written to ``chiprun_out/profile.json``.

Any failed check exits non-zero before the result is printed. The last two lines are
the kernel table ``{"kernels": [...]}`` and ``{"ok": true, "device": {...}}``.
Needs one CUDA device; exits non-zero without one.
"""
import json
import re
import subprocess
import sys
import tempfile
import threading
import time
import urllib.request
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
SEED = 0
TOLERANCE = 1e-6   # float outputs of kernel vs plain step: bitwise, or within this
# Served log-probs on the card vs the same model on the CPU. On an H100 the fp32 path
# differs by ~2e-6 at full width and the same path in TF32 by ~1.2e-3 (and decodes
# other text), so this limit tells them apart.
FP32_TOLERANCE = 1e-4


def check(condition: bool, message: str) -> None:
    if not condition:
        raise RuntimeError("chip_smoke check failed: " + message)


def cuda_ms(fn, iterations: int) -> float:
    """Mean device milliseconds per call of ``fn`` over ``iterations`` (after warm-up)."""
    import torch

    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iterations):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iterations


def random_step_inputs(rng, batch, r, k, classes, max_len, device):
    """Seeded beam states with dead lanes and duplicate prefixes, and packed frames."""
    import torch

    from speechless_tpu_torch.ops.decode_lm import pack_frames

    logits = rng.normal(size=(batch, 1, classes)) * 3
    log_probs = torch.log_softmax(torch.tensor(logits, dtype=torch.float32), dim=-1)
    frame = pack_frames(log_probs, k)[0]
    pb = rng.uniform(-20, 0, (batch, r)).astype(np.float32)
    pnb = rng.uniform(-20, 0, (batch, r)).astype(np.float32)
    dead = rng.random((batch, r)) < 0.3
    pb[dead] = -1e30
    pnb[dead | (rng.random((batch, r)) < 0.2)] = -1e30
    hsh = rng.integers(-2 ** 31, 2 ** 31 - 1, (batch, r)).astype(np.int32)
    hsh[:, r // 2] = hsh[:, 1]  # duplicate prefixes exercise the merge
    hsh[:, r - 1] = hsh[:, 1]
    last = rng.integers(-1, classes - 1, (batch, r)).astype(np.int32)
    lens = rng.integers(0, max_len + 1, (batch, r)).astype(np.int32)
    lm = rng.normal(size=(batch, r)).astype(np.float32)
    bonus = rng.normal(size=(batch, r)).astype(np.float32)
    return [torch.as_tensor(x).to(device)
            for x in (frame, pb, pnb, hsh, last, lens, lm, bonus)]


def readme_sentences():
    """Lower-cased sentences of README.md restricted to the English charset."""
    text = (ROOT / "README.md").read_text(encoding="utf8").lower()
    sentences = []
    for chunk in re.split(r"[.\n!?;:]", text):
        words = [w for w in re.sub(r"[^a-z' ]", " ", chunk).split() if w.strip("'")]
        if len(words) >= 3:
            sentences.append(" ".join(words))
    return sentences


def post(port: int, body: bytes, content_type: str):
    request = urllib.request.Request("http://127.0.0.1:{}/v1/transcribe".format(port),
                                     data=body, method="POST")
    request.add_header("Content-Type", content_type)
    start = time.perf_counter()
    with urllib.request.urlopen(request, timeout=300) as response:
        payload = json.loads(response.read())
        return response.status, payload, time.perf_counter() - start


def phase_a(device, blank, space_index, word_lm):
    """Kernel vs plain step at serving shapes, then a full 513-frame decode both ways."""
    import torch

    from speechless_tpu_torch.ops import _kernels, decode_lm

    k, beam_width, classes, max_len = 8, 25, 29, 513
    static = dict(k=k, blank=blank, beam_width=beam_width, max_decoded_length=max_len,
                  space_index=space_index)
    rng = np.random.default_rng(SEED)
    max_abs_err = 0.0
    for trial in range(8):
        inputs = random_step_inputs(rng, 16, 32, k, classes, 40, device)
        kernel = decode_lm.lm_step(*inputs, **static)
        plain = decode_lm.lm_step_reference(*inputs, **static)
        torch.cuda.synchronize()
        for name, got, want in zip("pb pnb hash last len lm idx".split(), kernel, plain):
            if got.dtype == torch.int32:
                check(torch.equal(got, want), "step trial {}: {} differs".format(trial, name))
            else:
                err = float((got - want).abs().max())
                check(torch.equal(got, want) or err <= TOLERANCE,
                      "step trial {}: {} max |err| {}".format(trial, name, err))
                max_abs_err = max(max_abs_err, err)
    # Other lane counts: the warp-only network (16, 32 lanes), shared-memory stages
    # (64..512) and the >48 KB dynamic shared memory of 1024 lanes.
    for width, k_other, classes_other in ((1, 1, 4), (8, 2, 6), (8, 7, 120), (8, 8, 29),
                                          (16, 8, 29), (40, 8, 33)):
        r_other = max(8, 1 << (width - 1).bit_length())
        other = dict(static, k=k_other, blank=classes_other - 1, beam_width=width)
        shaped = random_step_inputs(rng, 5, r_other, k_other, classes_other, 40, device)
        for name, got, want in zip("pb pnb hash last len lm idx".split(),
                                   decode_lm.lm_step(*shaped, **other),
                                   decode_lm.lm_step_reference(*shaped, **other)):
            check(torch.equal(got, want), "step W={} k={} C={}: {} differs".format(
                width, k_other, classes_other, name))
    print("phase A step: kernel == plain bitwise at W/k/C = 1/1/4, 8/2/6, 8/7/120, "
          "8/8/29, 16/8/29, 40/8/33 (16, 32, 64, 128, 256, 1024 candidate lanes)")

    # Device time of the kernel alone: raw back-to-back launches of the C entry point
    # (the wrapper's host work per call is timed separately; the plain version is a
    # chain of ~1000 small torch kernels per step, timed per call).
    outputs = [torch.empty_like(t) for t in inputs[1:7]] + [torch.empty_like(inputs[3])]
    raw = (*(t.data_ptr() for t in inputs + outputs), 16, inputs[0].shape[1], 32, k, 512,
           classes, blank, beam_width, max_len, space_index,
           torch.cuda.current_stream().cuda_stream)
    entry = _kernels.function("lm_beam_step")
    ms = cuda_ms(lambda: check(entry(*raw) == 0, "raw kernel launch failed"), 2000)
    wrapper_ms = cuda_ms(lambda: decode_lm.lm_step(*inputs, **static), 500)
    plain_ms = cuda_ms(lambda: decode_lm.lm_step_reference(*inputs, **static), 20)
    print("phase A step: kernel == plain over 8 seeded states at b=16 r=32 k=8 C=29 "
          "(max |float err| {}); kernel {:.5f} ms per launch on the device, lm_step "
          "wrapper {:.5f} ms per call, plain {:.5f} ms per call".format(
              max_abs_err, ms, wrapper_ms, plain_ms))

    # A full decode of 16 x 513 frames of peaky-but-noisy posteriors, both routes.
    frames = 513
    targets = rng.integers(0, classes - 1, (16, frames))
    targets[rng.random((16, frames)) < 0.5] = blank
    logits = rng.normal(size=(16, frames, classes)) * 1.5
    logits[np.arange(16)[:, None], np.arange(frames)[None, :], targets] += 6.0
    log_probs = torch.log_softmax(torch.tensor(logits, dtype=torch.float32), -1).to(device)
    lengths = torch.tensor(rng.integers(frames // 2, frames + 1, 16), device=device)
    lengths[0] = frames
    routes = {}
    for name, step in (("kernel", decode_lm.lm_step), ("plain", decode_lm.lm_step_reference)):
        torch.cuda.synchronize()
        start = time.perf_counter()
        routes[name] = decode_lm._beam_search(
            log_probs, lengths, blank, word_lm, beam_width, frames, 0.8, 0.0, 2.3, k,
            step=step)
        torch.cuda.synchronize()
        routes[name] += (time.perf_counter() - start,)
    check(torch.equal(routes["kernel"][0], routes["plain"][0])
          and torch.equal(routes["kernel"][1], routes["plain"][1]),
          "513-frame beam_search_decode_lm: kernel and plain tokens differ")
    print("phase A decode: beam_search_decode_lm 16 x 513 frames, W=25, word LM: tokens "
          "identical on both routes ({} tokens); wall {:.3f} s kernel, {:.3f} s plain".format(
              int(routes["kernel"][1].sum()), routes["kernel"][2], routes["plain"][2]))
    return {"max_abs_err": max_abs_err, "ms": ms, "plain_ms": plain_ms}


def phase_b(device, lm_directory):
    """The serving path through the HTTP server, then the batch rate at 16 x 8 s."""
    import torch

    from speechless_tpu_torch.features.spectrogram import features_batch
    from speechless_tpu_torch.models import wav2letter as w2l
    from speechless_tpu_torch.ops import decode_lm
    from speechless_tpu_torch.serving import CHARSETS, Transcriber, grouped_padded_batches
    from speechless_tpu_torch.serving_http import TranscriptionServer

    alphabet = CHARSETS["english"]
    config = w2l.Wav2LetterConfig(input_size_per_time_step=128,
                                  grapheme_set_size=len(alphabet) + 1)
    params = w2l.init_params(config, SEED)
    params[-1]["w"] = params[-1]["w"] * 8.0  # peaky frames: decisive argmax, real words
    transcriber = Transcriber(config, params, alphabet, device=device,
                              kenlm_directory=lm_directory)
    rng = np.random.default_rng(SEED + 1)

    def audio(seconds):
        t = np.arange(int(seconds * 16000)) / 16000.0
        tones = sum(0.2 * np.sin(2 * np.pi * f * t + p) for f, p in
                    zip(rng.uniform(100, 3000, 4), rng.uniform(0, 6, 4)))
        return (tones * (0.5 + 0.5 * np.sin(2 * np.pi * rng.uniform(1, 4) * t))
                + 0.05 * rng.normal(size=t.size)).astype(np.float32)

    # Six requests sent at once land in one batch (the batcher waits 500 ms): the 2 s
    # and 1.6 s ones share a length bucket, so the kernel decodes two live rows there;
    # the others are alone in theirs. A direct `transcribe_batch` of the same six
    # groups them the same way, so its texts must equal the served ones.
    audios = [audio(s) for s in (2.0, 3.0, 4.0, 6.0, 8.0, 1.6)]
    octet_stream = 4
    check(transcriber._bucket(len(audios[0])) == transcriber._bucket(len(audios[5])),
          "the 2 s and 1.6 s requests fall in different buckets")
    transcriber.warm_up([len(a) / 16000.0 for a in audios])
    server = TranscriptionServer(transcriber, port=0, max_batch=16, max_wait_ms=500.0)
    server.start()
    results = [None] * len(audios)

    def send(index):
        if index != octet_stream:
            body = json.dumps({"pcm": audios[index].tolist(), "sample_rate": 16000})
            results[index] = post(server.port, body.encode(), "application/json")
        else:
            results[index] = post(server.port, audios[index].astype("<f4").tobytes(),
                                  "application/octet-stream; rate=16000")

    try:
        decode_lm.lm_step.launches = 0
        threads = [threading.Thread(target=send, args=(i,)) for i in range(len(audios))]
        for thread in threads:
            thread.start()
        for thread in threads:
            thread.join(timeout=600)
        launches = decode_lm.lm_step.launches
        with urllib.request.urlopen("http://127.0.0.1:{}/metrics".format(server.port),
                                    timeout=60) as response:
            metrics = json.loads(response.read())
    finally:
        server.stop()
    check(all(r is not None for r in results), "a request did not complete")
    check(launches > 0, "lm_step.launches did not rise while serving")
    check(metrics["batches"] == 1, "the six requests were served in {} batches, not "
          "one".format(metrics["batches"]))
    direct = transcriber.transcribe_batch(audios)
    for index, ((status, payload, seconds), (text, _)) in enumerate(zip(results, direct)):
        check(status == 200, "request {} answered {}".format(index, status))
        check(payload["text"] == text,
              "request {}: HTTP {!r} != direct {!r}".format(index, payload["text"], text))
        print("phase B request {} ({:.1f} s, {}): 200 in {:.3f} s, {} chars: {!r}".format(
            index, len(audios[index]) / 16000.0,
            "octet-stream" if index == octet_stream else "json", seconds, len(text),
            text[:60]))
    print("phase B served {} requests in {} batch ({} length buckets, the 2 s one with 2 "
          "rows); lm_step.launches = {}".format(metrics["requests"], metrics["batches"],
                                                len({transcriber._bucket(len(a))
                                                     for a in audios}), launches))

    # The output is right by the repo's own means: finite posteriors of the expected
    # shape, in fp32 (they match the same model on the CPU), and each transcript of
    # the shared bucket equals the plain-step beam on the same two rows.
    pair = [audios[0], audios[5]]
    _, wavs, lengths = next(grouped_padded_batches(pair, transcriber._bucket, 16))
    with torch.inference_mode():
        log_probs, frames = transcriber._log_probs(wavs, lengths)
        cpu_features, _ = features_batch(torch.from_numpy(wavs), torch.from_numpy(lengths))
        cpu_log_probs = torch.log_softmax(
            w2l.build_model(config, params, device="cpu")(cpu_features), dim=-1)
    valid = torch.arange(log_probs.shape[1])[None, :] < frames.cpu()[:, None]
    check(tuple(log_probs.shape[::2]) == (2, 29) and bool(torch.isfinite(log_probs).all()),
          "log-probs of shape {} (want (2, T, 29)) or not finite".format(log_probs.shape))
    fp32_err = float((log_probs.cpu() - cpu_log_probs).abs()[valid].max())
    check(fp32_err <= FP32_TOLERANCE, "card vs CPU log-probs differ by {} > {}".format(
        fp32_err, FP32_TOLERANCE))
    tokens, counts = decode_lm._beam_search(
        log_probs, frames, transcriber.blank_index, transcriber.word_lm, 25,
        log_probs.shape[1], 0.8, 0.0, 2.3, 8, step=decode_lm.lm_step_reference)
    for row, index in enumerate((0, 5)):
        plain_text = transcriber.codec.decode_graphemes(
            tokens[row, :int(counts[row])].tolist(), merge_repeated=False)
        check(plain_text == direct[index][0], "request {}: plain-step beam {!r} != "
              "{!r}".format(index, plain_text, direct[index][0]))
    print("phase B 2 s + 1.6 s bucket: log-probs {} finite, max |card - CPU| {} (fp32, "
          "limit {}); the plain-step beam on both rows gives the served texts".format(
              tuple(log_probs.shape), fp32_err, FP32_TOLERANCE))

    batch = [audio(8.0) for _ in range(16)]
    transcriber.transcribe_batch(batch)
    runs = 3
    start = time.perf_counter()
    for _ in range(runs):
        texts = transcriber.transcribe_batch(batch)
    elapsed = time.perf_counter() - start
    check(len(texts) == 16 and all(isinstance(t, str) for t, _ in texts), "batch output")
    print("phase B transcribe_batch 16 x 8 s: {:.3f} s per batch, {:.2f} utterances/s, "
          "{:.1f} x realtime".format(elapsed / runs, 16 * runs / elapsed,
                                     16 * 8.0 * runs / elapsed))
    return launches, transcriber, batch, audios[0]


def phase_profile(transcriber, batch, short_audio, out_path: Path) -> None:
    """Where `transcribe_batch`'s time goes at 16 x 8 s (only with ``--profile``).

    Splits one dispatch into features, model and the beam (with the word LM, and the
    same beam without it) on the CUDA-synchronized host clock, times single 2 s and 8 s
    requests, and runs one batch under `torch.profiler` for the device's busy time and
    its kernels. Prints the numbers and writes them to ``out_path`` as JSON.
    """
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from speechless_tpu_torch.features.spectrogram import features_batch
    from speechless_tpu_torch.models import wav2letter as w2l
    from speechless_tpu_torch.ops.device_beam import beam_search_decode_device
    from speechless_tpu_torch.serving import grouped_padded_batches

    def wall_s(fn, runs=3):
        fn()
        torch.cuda.synchronize()
        start = time.perf_counter()
        for _ in range(runs):
            fn()
        torch.cuda.synchronize()
        return (time.perf_counter() - start) / runs

    device = transcriber.device
    _, wavs, lengths = next(grouped_padded_batches(batch, transcriber._bucket, 16))
    wavs, lengths = torch.from_numpy(wavs).to(device), torch.from_numpy(lengths).to(device)
    numbers = {}
    with torch.inference_mode():
        features, counts = features_batch(wavs, lengths)
        log_probs = torch.log_softmax(transcriber.model(features), dim=-1)
        frames = w2l.prediction_lengths(transcriber.config, counts)
        decoder = dict(transcriber._decoder, blank=transcriber.blank_index,
                       max_decoded_length=log_probs.shape[1])
        numbers["features_s"] = wall_s(lambda: features_batch(wavs, lengths))
        numbers["model_s"] = wall_s(lambda: transcriber.model(features))
        numbers["beam_lm_s"] = wall_s(lambda: beam_search_decode_device(
            log_probs, frames, word_lm=transcriber.word_lm, **decoder))
        numbers["beam_no_lm_s"] = wall_s(lambda: beam_search_decode_device(
            log_probs, frames, **decoder))
    numbers["transcribe_batch_s"] = wall_s(lambda: transcriber.transcribe_batch(batch))
    for name, audio in (("2s", short_audio), ("8s", batch[0])):
        seconds = []
        for _ in range(5):
            start = time.perf_counter()
            transcriber.transcribe_audio(audio)
            seconds.append(time.perf_counter() - start)
        numbers["single_{}_p50_s".format(name)] = float(np.median(seconds))

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        transcriber.transcribe_batch(batch)
        torch.cuda.synchronize()
    # Device-side events only (kernels, copies, memsets): host rows that launched them
    # would count them a second time.
    per_name = {}
    for event in prof.events():
        if event.device_type == DeviceType.CUDA:
            count_us = per_name.setdefault(event.name, [0, 0.0])
            count_us[0] += 1
            count_us[1] += event.time_range.elapsed_us()
    busy_s = sum(us for _, us in per_name.values()) / 1e6
    top = sorted(per_name.items(), key=lambda item: -item[1][1])
    numbers.update(
        device_busy_s=busy_s,
        device_idle_share=1.0 - busy_s / numbers["transcribe_batch_s"],
        device_ops_per_batch=sum(count for count, _ in per_name.values()),
        lm_beam_step=[[count, us / 1e3] for name, (count, us) in top
                      if "lm_beam_step" in name],
        top_device_ops_ms=[[name[:72], count, us / 1e3] for name, (count, us) in top[:12]])
    out_path.parent.mkdir(parents=True, exist_ok=True)
    out_path.write_text(json.dumps(numbers, indent=1))
    print("profile (written to {}): {}".format(out_path, json.dumps(
        {key: value for key, value in numbers.items() if key != "top_device_ops_ms"})))


def main() -> None:
    import argparse

    import torch

    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--profile", action="store_true",
                        help="also split transcribe_batch's time into its layers and "
                             "trace one batch (writes chiprun_out/profile.json)")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device")
    sys.path.insert(0, str(ROOT))
    from speechless_tpu_torch.lm.arpa_builder import build_kenlm_directory
    from speechless_tpu_torch.lm.device_lm import build_device_word_lm
    from speechless_tpu_torch.lm.ngram import load_language_model
    from speechless_tpu_torch.ops import _kernels
    from speechless_tpu_torch.serving import CHARSETS

    check("jax" not in sys.modules, "the port imported jax")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         timeout=60)
    print(smi.stdout.strip().splitlines()[0] if smi.stdout.strip() else "nvidia-smi: n/a")
    # PyTorch's defaults, left as they are: the port's features and model turn TF32
    # off themselves (speechless_tpu_torch/precision.py).
    print("torch {} CUDA {}; {} x {}; process-wide TF32 flags: matmul {} cudnn {}".format(
        torch.__version__, torch.version.cuda, torch.cuda.device_count(),
        torch.cuda.get_device_name(0), torch.backends.cuda.matmul.allow_tf32,
        torch.backends.cudnn.allow_tf32))
    device = torch.device("cuda:0")

    _kernels.function("lm_beam_step")
    build = _kernels.builds["lm_beam_step"]
    print("kernel build: nvcc {} {} in {:.2f} s -> {}".format(
        " ".join(_kernels.NVCC_FLAGS), "speechless_tpu_torch/csrc/lm_beam_step.cu",
        build["seconds"], Path(build["path"]).name))
    for line in build["log"].splitlines():
        if "registers" in line or "Compiling entry" in line or "spill" in line:
            print("  ptxas: " + line.strip())

    alphabet = CHARSETS["english"]
    with tempfile.TemporaryDirectory() as lm_directory:
        sentences = readme_sentences()
        build_kenlm_directory(sentences, Path(lm_directory), allowed_characters=alphabet)
        word_lm = build_device_word_lm(load_language_model(Path(lm_directory)),
                                       alphabet).to(device)
        print("word LM: {} sentences of README.md, {} trie nodes, {} unigrams".format(
            len(sentences), word_lm.trie.shape[0], word_lm.uni_logp.shape[0]))
        step = phase_a(device, len(alphabet), alphabet.index(" "), word_lm)
        launches, transcriber, batch, short_audio = phase_b(device, Path(lm_directory))
        if args.profile:
            phase_profile(transcriber, batch, short_audio,
                          ROOT / "chiprun_out" / "profile.json")
    check("jax" not in sys.modules, "the port imported jax")

    print(json.dumps({"kernels": [{
        "name": "lm_beam_step", "route": "cuda",
        "source": "speechless_tpu_torch/csrc/lm_beam_step.cu",
        "replaces": "speechless_tpu/ops/decode_pallas_lm.py:124",
        "launches": launches, "max_abs_err": step["max_abs_err"], "ms": step["ms"],
        "plain_ms": step["plain_ms"]}]}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
