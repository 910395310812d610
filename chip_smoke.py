#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU: LM-fused serving, streaming
sessions, offline decoding on every beam route, training, the training and evaluation
facade, the Transcriber's other routes (int8 serving, alignment, FLAC, the beam
warm-up), the model variants (ASG, the raw-wave model, the activations), export
bundles and parallelism (a data-parallel world of one, two processes sharing the card).

    python3 chip_smoke.py [--profile | --facade-only | --bundle-only | --parallel-only |
                           --dgrad-only | --attention-only]

Builds every kernel of ``speechless_tpu_torch/csrc/`` with nvcc for sm_90a (one nvcc per
source, all started together) and prints ptxas's registers and spills, then:

* phase A: `lm_span` (kernel K4, the span kernel: every frame of a span in one launch,
  with the word-LM gathers inside) against `lm_span_reference` (the plain loop of
  `_advance` over `lm_step_reference`) on the same CUDA tensors: carry, backpointers and
  tail bonus bitwise, at the serving shape (16 x 513 frames, ragged lengths, W=25, k=8,
  29 classes) with and without the word LM, over a lane sweep (W/k/C = 1/1/4 ... 40/8/33,
  12 frames, 16 to 1024 candidate lanes) and from seeded states with three live lanes
  of one hash, which must take the frame step's sorted network (its exactness branch).
  The single-frame entry `lm_step` against `lm_step_reference` on seeded states at the
  same lane counts. Times (CUDA events): the span kernel per launch and per frame, its
  bound (bytes: frames, carry, backpointers and the LM table bytes the run reads), the
  plain loop, the single-frame entry on the sorted and on the rank network, and the
  decode's wall on the span kernel and on the per-frame route; the decode's tokens
  equal the plain loop's.
* phase B: the full-width wav2letter (seeded random weights, output layer scaled for
  peaky frames), a word LM built by the port's `arpa_builder` from sentences of this
  repository's README, `Transcriber(kenlm_directory=..., device="cuda:0")` behind
  `TranscriptionServer(port=0)`. Five concurrent JSON requests and one octet-stream
  request of 1.6-8 s seeded audio, served in one batch where two of them share a length
  bucket, must answer 200 with the text of a direct `transcribe_batch` call, with one
  span launch and one backtrace launch per length bucket and no per-frame step. The shared bucket's
  log-probs must match the same model on the CPU (the path runs in fp32 with TF32 off
  whatever the process-wide flags say) and its transcripts the plain loop's. Prints
  per-request latency and the `transcribe_batch` wall at 16 x 8 s (one span launch a
  batch).
* phase C (training): the CTC kernels K1 (`ctc_alpha`) and the fused backward
  (`ctc_beta_grad`: K2's beta recursion with the occupancy contraction) against
  `alpha_reference` and `beta_reference` + `occupancy_gradient` on the same CUDA
  tensors at the bench's shapes (B=64, T=513, U=192, 29 classes, seeded lengths with
  edge rows: 1 frame with an empty label, 1 frame with one label, adjacent repeats, an
  infeasible row), at U=600, T=1401 (1201 states, over 1024) and at U=8191, T=40
  (16,383 states, the most a row may have): alpha bitwise, beta (through the kernel's
  test pointer) within 1e-5 on each row's valid region (scaled by max(1, |value|)),
  the gradient within 1e-5, the CTC loss within 1e-5 relative and its
  gradient within 1e-5, and `torch.nn.functional.ctc_loss` as a second oracle on the
  feasible rows; times of K1, the fused backward, their bounds, the plain versions, the
  whole CTC forward and backward, and `F.ctc_loss`'s forward and backward. Then
  `make_multi_wav_step` trains the full-width model in bf16 on `bench.py`'s batch (64 x
  131,072 samples, 192 labels, k=10 steps a call; one warm-up call, three timed): every
  step loss finite, the last call's mean loss below the first step's, each CTC kernel
  launched exactly 40 times; prints ms per step, utterances/s, MFU against 989 TFLOP/s
  bf16 and peak memory. Last, one fp32 step (TF32 off) at full width on a 2 x 2 s batch
  on the card against the same step on the CPU (loss, gradients and parameter
  changes), and the same step with TF32 forced on, which must fail those limits.
* phase D (streaming, on phase B's transcriber and LM): the stitch-and-rank kernel
  (`stream_stitch`) against `stitch_reference` on the same CUDA tensors at N=16 streams,
  F=32 (and 25) frames, r=32 lanes, max_len=512, with count-0 streams, streams near
  capacity and dead lanes, at F=128 r=64, and at the edges: F=1, every frame emitting,
  exit lengths below the entry length, max_len reached, NaN scores, max_len=510 and
  r=512: every output equal, scores bitwise; the kernel's device time per launch
  (CUDA events behind a device sleep), the wrapper's and the plain version's.
  Then `KernelBeamStreamDecoder` (W=25, word LM) takes 16 serving-shape streams of 513
  frames by `feed_batch` in 32-frame pieces, on the kernels (one span launch and one
  stitch launch a piece round) and on the plain loop: tokens identical, scores within
  1e-6 relative, and equal to the offline `beam_search_decode_lm` over the same frames;
  a synchronized run splits a piece round into the span kernel, the stitch and the
  rest, and one more runs on the kernels while another thread decodes offline (the
  same results; the time per round). Then 8 concurrent HTTP stream sessions on the
  card, each fed 8 s in 0.5 s chunks and finished, on three pools: the host pool (6
  ``beam``, 1 ``beam_pipelined``, 1 greedy with ``final_decode``), the device pool of
  ``serve --device-streams`` in its posterior mode (the same sessions) and in its
  resident mode (7 ``beam``, 1 greedy with ``final_decode``; the beam carries stay on
  the card and advance inside the feed dispatch): every reply 200, the two-pass final
  equal to the offline transcript, the span and stitch kernels launched during the run
  and the per-frame step never; in the posterior modes each beam final equal to a
  plain-loop replay of the rows its beam consumed, in the resident mode each beam final
  equal to the same audio through the host pool's sync beam (on a transcriber whose
  length bucket is the pool's window, so that both run the model on the same shape).
  Each pool is driven twice (cold: the first windows of each batch size and length;
  warm: a new server in the same process, the run whose launches are reported; the
  resident pass's on a line of its own). Prints feed latency p50/p95 (greedy, beam)
  of the three warm passes side by side, the slowest feeds and batcher dispatches,
  when each finish ran, and the launches. Then the split of a resident dispatch of 16
  beam sessions at the 8 s window (beam_cf 40) by CUDA events between synchronized
  stage boundaries: the host's inputs, the row update, the features, the model, the
  softmax and slice, the packing, the span kernel, the ranking, the stitch kernel, the
  carries' write-back and the fetch, beside the unsynchronized dispatch's wall. Last, a
  lexicon-constrained stream session on the card (the plain-step stream decoder, its
  stitch on the kernel) equal to the rows it consumed through the same decoder on the
  CPU, and that decoder's 16-stream piece round. With
  ``--profile``, one piece round under `torch.profiler`
  (``chiprun_out/profile_stream.json``).
* phase E (offline decoding, on phase B's transcriber and LM): the whole-utterance
  beam kernel K3 (`prefix_beam`) against `prefix_beam_reference` on the same CUDA
  tensors, every output equal and pb/pnb bitwise, on (a) the served log-probs of 16 x
  8 s with skip_blank_log_prob = log(0.999), (b) a seeded batch whose every other frame
  is blank-confident with ragged lengths from 1 to 513, skip on and off, and (c) W = 4,
  8, 16 with k = 3, 5, 8 and W = 40 (32 to 1024 candidate lanes); kernel times by CUDA
  events, the one plain run's time, the fast path's share and the least time. Then K3
  without skipping against the span kernel's no-LM beam (tokens equal), the router's
  skip route (one K3 launch, the plain version's tokens), the backtrace kernel
  (`beam_backtrace`) against `backtrace_tokens` on K3's (a) and phase A's span outputs
  and on seeded rows (r=1024; five starts a row, the n-best form; T = 1, 33 and 1401;
  max_len below the counts and past T; rows emitting on every frame): tokens and counts
  equal, device times and bound. ``POST /v1/transcribe?nbest=5`` against a direct
  `transcribe_nbest` (one backtrace launch a request), a lexicon-constrained
  `Transcriber` on 16 x 8 s (every word in the LM's vocabulary, one backtrace launch a
  dispatch), the plain batched beam twice on the card (bitwise) and on the card
  against the CPU (lexicon tokens equal; the n-best list's tokens equal and scores
  within 1e-4).
* phase F (the facade, after phase C): six synthetic LibriSpeech sets (`data/synthetic.py`,
  hard tier, 2-6 s; dev-clean 48 utterances, test-clean 16, the other training sets 8
  each) under a temporary data directory, then the CLI in process
  (`speechless_tpu_torch.__main__.main`): ``summarize``, ``fill-cache``, ``train
  --config english --batch-size 16 --batches-per-epoch 4 --epochs 2`` (bf16), ``test``
  greedy, ``test --kenlm`` with a trigram of the training transcripts, ``validate
  --csv``, with the CTC kernels' launches counted per command: the fused backward once
  a train step, K1 once a train step and once an eval batch (three previews, one
  test-clean batch per test, two in validate). Every epoch loss finite, both epoch
  checkpoints and two ``scalars.csv`` rows, the port's `Transcriber` on the epoch-2
  checkpoint, and one fp32 facade epoch (2 batches of 2) on the card against the CPU:
  loss within 1e-5 relative, parameter deltas within `FACADE_DELTA_RTOL`. Prints the
  command walls, the cache fill, the facade's train rate beside phase C's, greedy and
  LM-beam LER/WER and the host beam's wall.
* phase G (transfer, after phase F, in its data directory): phase F's epoch-2 checkpoint
  as the English baseline (epoch 1689), synthetic German sets (hard tier, 2-6 s, 48
  training and 16 test utterances) saved as ``corpus/German/corpus.csv``, then the CLI:
  ``summarize``, ``fill-cache``, ``transfer --freeze 8`` (B=16, 4 batches, ``--epochs
  1691``: a transfer run continues the donor's epoch numbering), whose loaded output
  layer must equal a numpy remap of the donor (English and blank columns bitwise, the
  umlaut columns zero) and whose layers 0-7 must stay the donor's bitwise; ``transfer
  --reinitialize`` (layers 8-10 fresh); `bench.py`'s batch with 33 classes in turns for
  the full step, the freeze-8 step and the remat step (ms and peak memory; remat's peak
  must be the lower); ``train --device-resident`` (B=16, 8 batches, 3 epochs: the second
  timed beside phase F's host epoch, the third traced by `torch.profiler` and free of
  host-to-device copies, ``chiprun_out/profile_resident.json``); one fp32 resident epoch
  card vs CPU on given indices; ``train --spec-augment --remat``; SpecAugment masks card
  vs CPU on given draws; ``average --last 2``; ``test`` greedy and ``--kenlm`` (a German
  trigram) on the average; the mixed configuration's ``summarize`` and grouped ``test``
  (an English and a German group); K1 and the fused backward counted per command. Last,
  a resident corpus of train-clean-100's size (28,539 x 3,072 frames x 128 mel fp16,
  22.4 GB) built on the card and 4 steps at B=64 timed by CUDA events, the sampling and
  gather split off.
* phase H (after phase E, on phase B's seeded weights and LM): `Transcriber(
  quantize_weights=True)` on the 16 x 8 s batch with the LM beam (one span and one
  backtrace launch a batch): served log-probs within `FP32_TOLERANCE` of the same int8
  model on the CPU and transcripts equal to the plain loop's on the same log-probs; the
  weights' device bytes and the per-call dequantize; the same for `int8_compute=True`,
  with big_conv_1's and big_conv_2's int32 sums on the card equal to an exact CPU
  product of the same x_q, the log-prob gap card vs CPU within `INT8_LOGPROB_LIMIT`, the
  int8 product's time beside the fp32 conv's; how many rows' transcripts of the CPU's
  own log-probs equal the card's (fp32, weight-only, int8); the alignment of an 8 s
  request to its greedy transcript, spans equal to the CPU Viterbi's on the same
  log-probs; the request as FLAC and as wav through ``transcribe`` (the same line); a
  fresh ``serve --warm-beam --no-warm-up`` process, which must load the span and stitch
  kernels before it binds and none during a first beam session; one quantized resident
  device-pool session against the host pool's sync beam; `measure_latency(4.0)`. After
  phase G: ``transcribe --config english --run R --epoch 2`` on phase F's run prints
  what ``--checkpoint`` on the same file prints.
* phase I (after phase F, in its data directory): ASG at the bench shape ((64, 513, 30)
  log-probs, 192 graphemes by `AsgGraphemeCodec`, an empty, a U = T' and a U > T' row):
  `asg_loss` card vs CPU (loss within 1e-5 relative, gradients within `ASG_GRAD_TOL`
  of max(1, |g|)), both beside an fp64 evaluation on the card, and `asg_viterbi_decode`
  paths equal; their device times. `make_multi_step` with ``asg_trainable`` on the
  bench batch's features (bf16, k=10): losses finite and falling, the tables changed,
  ms per step beside phase C's; one fp32 step on 2 x 2 s card vs CPU (loss, gradients
  within phase C's limits, the parameter changes within `ASG_DELTA_RTOL`) and the
  same step with TF32 forced on, which must fail them.
  The raw-wave model on (64, 131,072, 1) z-normalized waves (bf16, k=10): K1 and the
  fused backward once a step, the loss falling, ms per step, utterances/s and MFU; then
  K1 and the fused backward against their plain versions on the log-probs the trained
  model gives that batch (the shape measured: (64, 410, 29)), as in phase C; one fp32
  step card vs CPU within phase C's limits with its TF32 control, and an elu forward
  within `FP32_TOLERANCE`. The facade over phase F's
  corpora (B=16, 4 batches an epoch): `train_from_beginning` with trainable ASG tables
  for 2 epochs (no CTC launch) and its grouped test (the Viterbi), then the raw-wave
  model for 1 epoch host-fed and 1 resident (the fused backward once a step), each
  test's LER/WER.
* phase J (after phase H, on phase B's transcriber and LM): export bundles.
  `export_transcriber` writes the 16 x 8 s batch's bucket for ``cuda`` (batch sizes 1
  and 16, the streaming programs, the device pool's feed with posteriors): its wall and
  bytes (programs, weights). A fresh ``python -X importtime -m speechless_tpu_torch
  transcribe --bundle --json`` of the batch as float32 wavs prints the live
  `transcribe_batch`'s texts (confidences within 1e-4) and imports no model, features
  or Transcriber module. In process, `ExportedTranscriber`: the batched program's texts
  equal the live ones with one span and one backtrace launch a dispatch; the 16 single
  programs launch one each, their posteriors are within 1e-4 of the live log-probs and
  their texts equal the plain loop (`lm_span_reference`, `backtrace_tokens`) on those
  posteriors; ms per 16 x 8 s dispatch, bundle and live in turns; a greedy session on a
  `DeviceStreamingPool` over the bundle gives the live pool's final, resident mode is
  refused; a ``cpu``-only bundle is refused on the card.
* phase K (after phase G, in phase F's data directory): parallelism. K1, a world of one
  process on NCCL through `distributed_init` and `make_mesh`: `make_multi_wav_step` on
  the mesh at `bench.py`'s batch in bf16 (k=10; K1 and the fused backward launch every
  step, one gradient all-reduce a step) timed in turns with the plain step; one fp32
  step on the mesh bitwise the plain step's (deterministic cuDNN; a reduce over one
  rank is the identity); `Wav2Letter(mesh=)` trains one facade epoch on phase F's
  corpus and checkpoints, and a single-process `Wav2Letter` loads it exactly. K2, two
  processes on the one card over gloo (NCCL refuses two ranks on one GPU; each is this
  script with ``--k2-worker``): the TP=2 forward and backward at full width on the
  bench batch in fp32 against the unsplit model (logits within 1e-4, gradients within
  1e-2 relative L2 per tensor), one DP and one TP step in bf16 with equal losses on
  both ranks, the sequence-parallel n=2 forward of a 60 s recording within 1e-5 of the
  unsplit forward and its LM-beam text equal to the unsplit decode's (one span and one
  backtrace launch on each rank), and `Transcriber(mesh=)` on phase B's 16 x 8 s batch
  giving the plain Transcriber's texts.
* phase L (after phase C): the conv data-gradient kernel (`ops/conv_dgrad.py`,
  ``csrc/conv_dgrad.cu``) against its plain version `dgrad_reference` on the same CUDA
  tensors, bf16 dX within one bf16 ulp plus 1e-4 of the largest |dX| (DGRAD_RTOL,
  DGRAD_ATOL), at the edges (one frame, fewer frames than taps, odd frames and channels,
  a frame past the 128-frame tile) and at big_conv_1's shapes (B=64 at T' = 1,536, 513
  and 410, and a tensor-parallel rank's 1,000 channels) and the inner convs'; cuDNN's
  data gradient beside it; the kernel's ms, bound, plain ms and cuDNN's ms at each; the
  kernel's launches and the `conv.dgrad_*` trace counters in `make_device_epoch_step`
  at the training cell's batch (eight launches a step, big_conv_1 and the inner convs;
  none with 8 layers frozen).
* phase M (after phase L): the Conformer's relative-position attention kernel pair
  (`ops/rel_attention.py`, ``csrc/rel_attention.cu``) against its plain version
  `rel_attention_reference`, at the edges and at the training cell's shape: O, the LSE
  and every gradient, each within a fixed limit set by the kernel's own bf16 roundings
  (ATTN_LIMITS; the library route it replaced is printed beside it); its ms beside its
  bound, the library route's and the plain version's; the tiles run, the largest tensor
  the block's attention allocates and the device kernels it runs; the kernel's launches
  (2 a block) and tile counters in the Conformer's resident training call
  (`make_device_epoch_step` at the cell's batch and padded length).
* with ``--dgrad-only``: the kernel builds and phase L alone, and no result line;
  with ``--attention-only``: the kernel builds and phase M alone, and no result line;
  with ``--facade-only``: the kernel builds and phases F, I and G alone, and no result;
  with ``--bundle-only``: the kernel builds and phases B and J alone, and no result;
  with ``--parallel-only``: the kernel builds, phase B, phase F's corpus staging and
  phase K alone, and no result.
* with ``--profile`` only: the split of one 16 x 8 s `transcribe_batch` into features,
  model and beam, single-request latencies, and the device's busy share and kernel
  counts from one `torch.profiler` trace (``chiprun_out/profile.json``); and the split of
  one train step into features, forward, CTC forward, backward and Adam (also with
  cuDNN's autotuner on), and the device's busy share of one k-step call
  (``chiprun_out/profile_train.json``).

Any failed check exits non-zero before the result is printed. The last three lines are
a summary of the span kernel's, the serving batch's and the piece round's times, the
kernel table ``{"kernels": [...]}`` (the kernels of the main paths; the single-frame
step entry is a test entry and is reported by phase A) and ``{"ok": true, "device":
{...}}``.
Needs one CUDA device; exits non-zero without one.
"""
import contextlib
import json
import math
import re
import subprocess
import sys
import tempfile
import threading
import time
import urllib.request
from pathlib import Path
from typing import Optional

import numpy as np

ROOT = Path(__file__).resolve().parent
SEED = 0
TOLERANCE = 1e-6   # float outputs of kernel vs plain step: bitwise, or within this
# Served log-probs on the card vs the same model on the CPU. On an H100 the fp32 path
# differs by ~2e-6 at full width and the same path in TF32 by ~1.2e-3 (and decodes
# other text), so this limit tells them apart.
FP32_TOLERANCE = 1e-4
# One fp32 train step on the card vs the CPU (phases C and I): loss, relative; the
# gradients (Adam's first moments) and the parameters' changes, relative L2 per tensor.
# The same step with TF32 on must exceed one of them.
FP32_LOSS_RTOL = 1e-5
FP32_GRAD_RTOL = 1e-2
FP32_DELTA_RTOL = 1e-2


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


def device_ms(fn, iterations: int) -> float:
    """Mean device milliseconds per launch of ``fn`` over ``iterations`` launches queued
    behind a device sleep long enough to cover the host's issuing them, so that they run
    back to back on the device whatever the host takes per call (for kernels shorter
    than their launch's host cost). Fails if the host did not keep ahead."""
    import torch

    fn()
    torch.cuda.synchronize()
    start = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    sleep_s = 2.0 * iterations * (time.perf_counter() - start) + 0.005
    begin, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(int(sleep_s * 2e9))  # cycles: at least sleep_s at clocks <= 2 GHz
    issued = time.perf_counter()
    begin.record()
    for _ in range(iterations):
        fn()
    end.record()
    issued = time.perf_counter() - issued
    torch.cuda.synchronize()
    check(issued < sleep_s, "device_ms: issuing {} launches took {:.4f} s, longer than the "
          "{:.4f} s the device slept".format(iterations, issued, sleep_s))
    return begin.elapsed_time(end) / iterations


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


def span_states(batch, r, word_lm, device, rng=None):
    """A fresh carry (`decode_lm.fresh_carry`), or with ``rng`` phase A's seeded beam
    states with dead lanes and three lanes of one hash (live), as a carry."""
    import torch

    from speechless_tpu_torch.ops import decode_lm

    carry = decode_lm.fresh_carry(batch, r, word_lm, device)
    if rng is not None:
        seeded = random_step_inputs(rng, batch, r, 8, 29, 40, device)[1:7]
        seeded[0][:, [1, r // 2, r - 1]] = -1.0  # the three lanes of one hash are live
        carry[:6] = seeded
    return [leaf.contiguous() for leaf in carry]


def lm_bytes_read(word_lm, carries, parents, chars, space_index) -> int:
    """The word-LM table bytes a span needs for this run's beams: for every distinct
    (trie node, context) a carry of the run holds, the node's word, the unigram and
    backoff reads, and the keys of both slots of each of the three 2-choice probes with
    the value of the slot that matched; for every distinct char extension, its trie
    edge. ``carries`` are the carries before and after each frame (CPU)."""
    import torch

    from speechless_tpu_torch.lm.device_lm import _slot

    lm = word_lm.to("cpu")
    nodes = torch.cat([c[6].reshape(-1) for c in carries])
    ctx = torch.cat([c[7].reshape(-1, 2) for c in carries])
    states = torch.unique(torch.stack([nodes, ctx[:, 0], ctx[:, 1]], dim=1), dim=0)
    node, c1, c2 = states.unbind(1)
    completed = torch.where(node > 0, lm.node_word[node.clamp(min=0).long()], -1)
    w = torch.where(completed >= 0, completed, lm.unk_id)
    total = 4 * (int(torch.unique(node[node > 0]).numel()) + int(torch.unique(w).numel())
                 + int(torch.unique(c2).numel()))

    def probe_bytes(table_keys, value_bytes, keys):
        keys = torch.unique(torch.stack(keys, dim=1), dim=0).unbind(1)
        size, width = table_keys.shape
        touched, hits = set(), set()
        for side in (0, 1):
            slots = _slot(keys, size, side)
            match = torch.ones_like(slots, dtype=torch.bool)
            for column, key in enumerate(keys):
                match &= table_keys[slots, column] == key
            touched.update(slots.tolist())
            hits.update(slots[match].tolist())
        return 4 * width * len(touched) + value_bytes * len(hits)

    total += probe_bytes(lm.bi_k, 8, (c2, w)) + probe_bytes(lm.bi_k, 8, (c1, c2))
    total += probe_bytes(lm.tri_k, 4, (c1, c2, w))
    # Trie edges: (parent's node, char) of every char extension.
    walks = set()
    for t in range(parents.shape[1]):
        parent_nodes = carries[t][6].gather(1, parents[:, t].long())
        is_char = (chars[:, t] >= 0) & (chars[:, t] != space_index) & (parent_nodes >= 0)
        walks.update(zip(parent_nodes[is_char].tolist(), chars[:, t][is_char].tolist()))
    return total + 4 * len(walks)


def check_span(name, frames, carry, counts, word_lm, static, record_lm=False):
    """`lm_span` (the span kernel) against `lm_span_reference` over `lm_step_reference`
    (the plain loop) on the same CUDA tensors: carry, backpointers and tail bonus
    bitwise. The plain loop runs one frame at a time (the carry is the whole state, so
    this equals one span) and is timed with CUDA events. Returns the kernel's outputs,
    the plain time, the frames that took the sorted network and, with ``record_lm``,
    the LM bytes of the run (`lm_bytes_read`)."""
    import torch

    from speechless_tpu_torch.ops import decode_lm

    got = decode_lm.lm_span(frames, [leaf.clone() for leaf in carry], counts, word_lm,
                            **static)
    sorted_frames = int(decode_lm.lm_span.sorted_frames.sum())
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    plain_carry, parents, chars, history = carry, [], [], [[leaf.cpu() for leaf in carry]]
    start.record()
    for t in range(frames.shape[0]):
        plain_carry, p, c, bonus = decode_lm.lm_span_reference(
            frames[t:t + 1], plain_carry, (counts > t).to(torch.int32), word_lm,
            step=decode_lm.lm_step_reference, **static)
        parents.append(p)
        chars.append(c)
        if record_lm:
            history.append([leaf.cpu() for leaf in plain_carry])
    end.record()
    torch.cuda.synchronize()
    plain_ms = start.elapsed_time(end)
    want = (plain_carry, torch.cat(parents, dim=1), torch.cat(chars, dim=1), bonus)
    names = ["pb", "pnb", "hash", "last", "len", "lm", "trie node", "word context"]
    for label, g, w in zip(names[:len(carry)] + ["parents", "chars", "tail bonus"],
                           list(got[0]) + list(got[1:]), list(want[0]) + list(want[1:])):
        check(g.dtype == w.dtype and torch.equal(g, w),
              "lm_span {}: {} differs from the plain loop".format(name, label))
    lm_bytes = 0
    if record_lm and word_lm is not None:
        lm_bytes = lm_bytes_read(word_lm, history, want[1].cpu(), want[2].cpu(),
                                 word_lm.space_index)
    return got, plain_ms, sorted_frames, lm_bytes


def phase_a(device, blank, space_index, word_lm):
    """The span kernel (K4) against its plain loop at the serving shape with and without
    the word LM, over a lane sweep and from seeded states that take the step's sorted
    network; the single-frame entry of the step against the plain step; times, bounds
    and the decode's wall on the span kernel and on the old per-frame route."""
    import torch

    from speechless_tpu_torch.ops import _kernels, beam_common, decode_lm

    k, beam_width, classes, max_len = 8, 25, 29, 513
    static = dict(k=k, blank=blank, beam_width=beam_width, max_decoded_length=max_len,
                  space_index=space_index)
    weights = dict(lm_weight=0.8, word_count_weight=0.0, valid_word_count_weight=2.3)
    rng = np.random.default_rng(SEED)

    # The single-frame entry: seeded states whose duplicate live hashes take the sorted
    # network, and the states of a real decode, which take the rank network.
    for trial in range(8):
        inputs = random_step_inputs(rng, 16, 32, k, classes, 40, device)
        for label, got, want in zip("pb pnb hash last len lm idx".split(),
                                    decode_lm.lm_step(*inputs, **static),
                                    decode_lm.lm_step_reference(*inputs, **static)):
            check(got.dtype == want.dtype and torch.equal(got, want),
                  "step trial {}: {} differs".format(trial, label))
    for width, k_other, classes_other in ((1, 1, 4), (8, 2, 6), (8, 7, 120), (8, 8, 29),
                                          (16, 8, 29), (40, 8, 33)):
        r_other = max(8, 1 << (width - 1).bit_length())
        other = dict(static, k=k_other, blank=classes_other - 1, beam_width=width)
        shaped = random_step_inputs(rng, 5, r_other, k_other, classes_other, 40, device)
        for label, got, want in zip("pb pnb hash last len lm idx".split(),
                                    decode_lm.lm_step(*shaped, **other),
                                    decode_lm.lm_step_reference(*shaped, **other)):
            check(torch.equal(got, want), "step W={} k={} C={}: {} differs".format(
                width, k_other, classes_other, label))

    # The serving shape: 16 x 513 frames of peaky-but-noisy posteriors, ragged lengths.
    frames_n = 513
    log_probs = torch.from_numpy(serving_posteriors(rng, 16, frames_n, classes, blank)
                                 ).to(device)
    lengths = torch.tensor(rng.integers(frames_n // 2, frames_n + 1, 16), dtype=torch.int32,
                           device=device)
    lengths[0] = frames_n
    frames = decode_lm.pack_frames(log_probs, k)
    span_static = dict(k=k, blank=blank, beam_width=beam_width, max_decoded_length=max_len,
                       **weights)
    results = {}
    for label, lm in (("word LM", word_lm), ("no LM", None)):
        carry = span_states(16, 32, lm, device)
        got, plain_ms, sorted_frames, lm_bytes = check_span(
            "16 x 513 " + label, frames, carry, lengths, lm, span_static,
            record_lm=lm is not None)
        ms = cuda_ms(lambda: decode_lm.lm_span(frames, carry, lengths, lm, **span_static),
                     20)
        active = int(lengths.sum())
        # Least time: the active frames' packed rows, the counts and the carry read once;
        # the carry, backpointers and tail bonus written once; the LM bytes this run's
        # beams need. Operations, per active row-frame: a comparison sort of the (k + 1) W
        # live candidates and a segmented log-sum-exp over them, as for K3.
        live = (k + 1) * beam_width
        moved = (active * frames.shape[2] * 4 + lengths.numel() * 4
                 + 2 * sum(t.numel() * t.element_size() for t in carry)
                 + sum(t.numel() * t.element_size() for t in got[1:]) + lm_bytes)
        bound_ms, bound_by = bound(moved, active * (live * math.log2(live) + 4 * live))
        results[label] = dict(ms=ms, per_frame_us=ms / frames_n * 1e3, plain_ms=plain_ms,
                              bound_ms=bound_ms, bound_by=bound_by, bytes=moved,
                              lm_bytes=lm_bytes, sorted_frames=sorted_frames,
                              active_frames=active, outputs=got)
        print("phase A span 16 x 513 ({}): kernel == plain loop (carry, parents, chars, "
              "tail bonus bitwise); {} of {} row-frames took the sorted network; kernel "
              "{:.4f} ms per launch ({:.2f} us per frame), plain loop {:.1f} ms, bound "
              "{:.6f} ms ({}: {} bytes, {} of them LM tables)".format(
                  label, sorted_frames, active, ms, ms / frames_n * 1e3, plain_ms,
                  bound_ms, bound_by, moved, lm_bytes))

    # Lane sweep (16 to 1024 candidate lanes; the >48 KB shared memory of 1024) over 12
    # frames, with the word LM where the alphabet is the LM's.
    for width, k_other, classes_other in ((1, 1, 4), (8, 2, 6), (8, 7, 120), (8, 8, 29),
                                          (16, 8, 29), (40, 8, 33)):
        r_other = max(8, 1 << (width - 1).bit_length())
        lm = word_lm if classes_other == classes else None
        sweep_lp = torch.from_numpy(serving_posteriors(rng, 5, 12, classes_other,
                                                       classes_other - 1)).to(device)
        sweep_static = dict(span_static, k=k_other, blank=classes_other - 1,
                            beam_width=width)
        check_span("W={} k={} C={}".format(width, k_other, classes_other),
                   decode_lm.pack_frames(sweep_lp, k_other),
                   span_states(5, r_other, lm, device),
                   torch.tensor([12, 9, 1, 0, 12], dtype=torch.int32, device=device), lm,
                   sweep_static)
    # The exactness branch: a span from seeded states with three live lanes of one hash.
    _, _, exact_frames, _ = check_span(
        "seeded duplicate hashes", frames[:8], span_states(16, 32, word_lm, device, rng),
        torch.full((16,), 8, dtype=torch.int32, device=device), word_lm, span_static)
    check(exact_frames > 0, "the seeded duplicate hashes never took the sorted network")
    print("phase A span: kernel == plain loop bitwise at W/k/C = 1/1/4, 8/2/6, 8/7/120, "
          "8/8/29, 16/8/29, 40/8/33 over 12 frames (16 to 1024 candidate lanes, word LM at "
          "C=29), and from seeded states with duplicate live hashes ({} of 128 row-frames "
          "took the sorted network)".format(exact_frames))

    # Tokens: the kernel route of the decode against the plain span's outputs.
    full = results["word LM"]["outputs"]
    tokens = decode_lm._beam_search(log_probs, lengths, blank, word_lm, beam_width,
                                    max_len, 0.8, 0.0, 2.3, k)
    carry, parents, chars, tail = full
    final = torch.logaddexp(carry[0], carry[1]) + carry[5] + tail
    best = final.argmax(dim=1)
    plain_tokens = beam_common.backtrace_tokens(parents, chars, best,
                                                carry[4].gather(1, best[:, None])[:, 0],
                                                max_len)
    check(all(torch.equal(a, b) for a, b in zip(tokens, plain_tokens)),
          "beam_search_decode_lm 16 x 513: span-kernel tokens differ from the plain loop's")

    # The single-frame entry's device time (raw launches) on seeded states (the sorted
    # network, as every frame ran before the rank network) and on decode states (the
    # rank network), and the decode's wall on the span kernel and on the per-frame route
    # (the step entry per frame with the LM gathers as torch ops between frames).
    step_ms = {}
    decode_state = decode_lm.lm_span(frames[:200], span_states(16, 32, word_lm, device),
                                     lengths, word_lm, **span_static)[0]
    entry = _kernels.function("lm_beam_step")
    seeded = random_step_inputs(rng, 16, 32, k, classes, 40, device)
    real = [frames[200]] + decode_state[:6] + [seeded[7]]
    for label, inputs in (("sorted", seeded), ("rank", real)):
        outputs = [torch.empty_like(t) for t in inputs[1:7]] + [torch.empty_like(inputs[3])]
        raw = (*(t.data_ptr() for t in inputs + outputs), 16, inputs[0].shape[1], 32, k,
               512, classes, blank, beam_width, max_len, space_index,
               torch.cuda.current_stream().cuda_stream)
        step_ms[label] = cuda_ms(lambda: check(entry(*raw) == 0, "raw step launch failed"),
                                 2000)
    walls = {}
    for label, step in (("span", None), ("per-frame", decode_lm.lm_step)):
        decode_lm._beam_search(log_probs, lengths, blank, word_lm, beam_width, max_len,
                               0.8, 0.0, 2.3, k, step=step)
        torch.cuda.synchronize()
        start = time.perf_counter()
        decode_lm._beam_search(log_probs, lengths, blank, word_lm, beam_width, max_len,
                               0.8, 0.0, 2.3, k, step=step)
        torch.cuda.synchronize()
        walls[label] = time.perf_counter() - start
    print("phase A step entry (one frame, 16 rows, 512 lanes): {:.5f} ms per launch on "
          "seeded states (sorted network), {:.5f} ms on decode states (rank network); "
          "beam_search_decode_lm 16 x 513 with the word LM: tokens equal to the plain "
          "loop's ({} tokens), wall {:.4f} s on the span kernel, {:.4f} s on the "
          "per-frame route".format(step_ms["sorted"], step_ms["rank"],
                                   int(tokens[1].sum()), walls["span"],
                                   walls["per-frame"]))
    lm_result = results["word LM"]
    return {"max_abs_err": 0.0, "ms": lm_result["ms"], "plain_ms": lm_result["plain_ms"],
            "bound_ms": lm_result["bound_ms"], "bound_by": lm_result["bound_by"],
            "per_frame_us": lm_result["per_frame_us"],
            "no_lm_ms": results["no LM"]["ms"], "step_ms": step_ms, "walls": walls,
            "decode_outputs": full, "frames": frames, "lengths": lengths}


def serving_params(config):
    """The serving model's seeded weights, the output layer scaled for peaky frames
    (a decisive argmax and real words from random weights)."""
    from speechless_tpu_torch.models import wav2letter as w2l

    params = w2l.init_params(config, SEED)
    params[-1]["w"] = params[-1]["w"] * 8.0
    return params


def phase_b(device, lm_directory):
    """The serving path through the HTTP server, then the batch rate at 16 x 8 s."""
    import torch

    from speechless_tpu_torch.features.spectrogram import features_batch
    from speechless_tpu_torch.models import wav2letter as w2l
    from speechless_tpu_torch.ops import beam_common, decode_lm
    from speechless_tpu_torch.serving import CHARSETS, Transcriber, grouped_padded_batches
    from speechless_tpu_torch.serving_http import TranscriptionServer

    alphabet = CHARSETS["english"]
    config = w2l.Wav2LetterConfig(input_size_per_time_step=128,
                                  grapheme_set_size=len(alphabet) + 1)
    params = serving_params(config)
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
        decode_lm.lm_span.launches = decode_lm.lm_step.launches = 0
        beam_common.beam_backtrace.launches = 0
        threads = [threading.Thread(target=send, args=(i,)) for i in range(len(audios))]
        for thread in threads:
            thread.start()
        for thread in threads:
            thread.join(timeout=600)
        launches = {"lm_beam_span": decode_lm.lm_span.launches,
                    "beam_backtrace": beam_common.beam_backtrace.launches,
                    "lm_beam_step": decode_lm.lm_step.launches}
        with urllib.request.urlopen("http://127.0.0.1:{}/metrics".format(server.port),
                                    timeout=60) as response:
            metrics = json.loads(response.read())
    finally:
        server.stop()
    check(all(r is not None for r in results), "a request did not complete")
    buckets = len({transcriber._bucket(len(a)) for a in audios})
    check(launches == {"lm_beam_span": buckets, "beam_backtrace": buckets,
                       "lm_beam_step": 0},
          "serving {} length buckets launched {} (want one span and one backtrace per "
          "bucket, no per-frame step)".format(buckets, launches))
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
          "rows); launches {}".format(metrics["requests"], metrics["batches"], buckets,
                                      launches))

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
        check(plain_text == direct[index][0], "request {}: plain-loop beam {!r} != "
              "{!r}".format(index, plain_text, direct[index][0]))
    print("phase B 2 s + 1.6 s bucket: log-probs {} finite, max |card - CPU| {} (fp32, "
          "limit {}); the plain loop (lm_span_reference, plain backtrace) on both rows "
          "gives the served texts".format(tuple(log_probs.shape), fp32_err,
                                          FP32_TOLERANCE))

    batch = [audio(8.0) for _ in range(16)]
    transcriber.transcribe_batch(batch)
    runs = 5
    decode_lm.lm_span.launches = decode_lm.lm_step.launches = 0
    torch.cuda.synchronize()
    start = time.perf_counter()
    for _ in range(runs):
        texts = transcriber.transcribe_batch(batch)
    torch.cuda.synchronize()
    elapsed = time.perf_counter() - start
    check(len(texts) == 16 and all(isinstance(t, str) for t, _ in texts), "batch output")
    check(decode_lm.lm_span.launches == runs and decode_lm.lm_step.launches == 0,
          "{} batches of 16 x 8 s launched the span kernel {} times and the step {}".format(
              runs, decode_lm.lm_span.launches, decode_lm.lm_step.launches))
    print("phase B transcribe_batch 16 x 8 s: {:.4f} s per batch, {:.2f} utterances/s, "
          "{:.1f} x realtime; one span launch per batch".format(
              elapsed / runs, 16 * runs / elapsed, 16 * 8.0 * runs / elapsed))
    return launches, transcriber, batch, audios[0], audio, elapsed / runs


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
    # would count them a second time, and the device-side copies of the program's own
    # spans (user annotations, `utils/trace.py`) are ranges, not work.
    per_name = {}
    for event in prof.events():
        if event.device_type == DeviceType.CUDA and not getattr(
                event, "is_user_annotation", False):
            count_us = per_name.setdefault(event.name, [0, 0.0])
            count_us[0] += 1
            count_us[1] += event.time_range.elapsed_us()
    busy_s = sum(us for _, us in per_name.values()) / 1e6
    top = sorted(per_name.items(), key=lambda item: -item[1][1])
    numbers.update(
        device_busy_s=busy_s,
        device_idle_share=1.0 - busy_s / numbers["transcribe_batch_s"],
        device_ops_per_batch=sum(count for count, _ in per_name.values()),
        lm_beam_span=[[count, us / 1e3] for name, (count, us) in top
                      if "lm_beam_span" in name],
        beam_backtrace=[[count, us / 1e3] for name, (count, us) in top
                        if "beam_backtrace" in name],
        top_device_ops_ms=[[name[:72], count, us / 1e3] for name, (count, us) in top[:12]])
    out_path.parent.mkdir(parents=True, exist_ok=True)
    out_path.write_text(json.dumps(numbers, indent=1))
    print("profile (written to {}): {}".format(out_path, json.dumps(
        {key: value for key, value in numbers.items() if key != "top_device_ops_ms"})))


# Peak rates of one H100 SXM (NVIDIA's data sheet): device memory, fp32 outside the
# tensor cores, bf16 tensor cores (dense). Used for the least time a kernel could take.
HBM_BYTES_PER_S = 3.35e12
FP32_OPS_PER_S = 67e12
BF16_FLOPS_PER_S = 989e12


def bound(bytes_moved: float, operations: float):
    """(least ms, what bounds it): the larger of bytes over the memory rate and
    operations over the fp32 rate."""
    byte_ms, op_ms = bytes_moved / HBM_BYTES_PER_S * 1e3, operations / FP32_OPS_PER_S * 1e3
    return (byte_ms, "bytes") if byte_ms >= op_ms else (op_ms, "operations")


# ---- phase C: training -------------------------------------------------------------
BENCH_BATCH, BENCH_SAMPLES, BENCH_LABELS, BENCH_STEPS = 64, 131072, 192, 10
CTC_LOSS_RTOL = 1e-5   # kernel vs plain CTC loss, relative
CTC_ABS_TOL = 1e-5     # kernel vs plain gradient, and alpha/beta (scaled, see below)
# vs torch.nn.functional.ctc_loss, another algorithm: loss relative; gradient absolute,
# since occupancies exp(alpha + beta - logZ) of log-space values near 3T carry ~T ulps.
ORACLE_LOSS_RTOL, ORACLE_GRAD_ATOL = 1e-4, 1e-3


def ctc_case(rng, batch, t_max, u_max, classes, device):
    """Seeded log-probs and -1-padded labels. Edge rows: 0 has 1 frame and an empty
    label, 1 has 1 frame and 1 label, 2 is all adjacent repeats, 3 is infeasible (one
    frame fewer than its labels and repeats need), 4 is as long as the bench's rows;
    the rest are random feasible rows."""
    import torch

    blank = classes - 1
    label_lengths = rng.integers(u_max // 2, u_max + 1, batch).astype(np.int32)
    labels = np.full((batch, u_max), -1, np.int32)
    for row, count in enumerate(label_lengths):
        labels[row, :count] = rng.integers(0, blank, count)
    label_lengths[0], labels[0] = 0, -1
    label_lengths[1], labels[1], labels[1, 0] = 1, -1, 3
    label_lengths[2], labels[2] = u_max, np.repeat(rng.integers(0, blank, u_max), 2)[:u_max]
    repeats = ((labels[:, 1:] == labels[:, :-1]) & (labels[:, 1:] >= 0)).sum(1)
    needed = np.minimum(label_lengths + repeats, t_max - 1)
    lengths = rng.integers(needed, t_max).astype(np.int32)
    lengths[0] = lengths[1] = 1
    lengths[3] = needed[3] - 1
    lengths[4] = t_max - 1
    logits = torch.tensor(rng.normal(size=(batch, t_max, classes)) * 2, dtype=torch.float32)
    feasible = (label_lengths + repeats <= lengths) & (lengths > 0)
    return (torch.log_softmax(logits, -1).to(device),
            *(torch.from_numpy(x).to(device) for x in (lengths, labels, label_lengths)),
            feasible)


def compare_ctc_kernels(where: str, log_probs, lengths, labels, label_lengths, feasible):
    """K1 against `alpha_reference` and `final_log_prob` (bitwise), the fused backward's
    beta (through its test pointer) and gradient against `beta_reference` +
    `occupancy_gradient`, the loss and gradient of `ctc_kernels.ctc_loss` against
    `ctc.ctc_loss`, and both against `F.ctc_loss` on the ``feasible`` rows (a numpy
    mask), on the given (B, T, C) fp32 log-probs (blank C-1) and -1-padded labels.
    Returns the errors, and the kernels' arguments and outputs for timing them."""
    import torch
    import torch.nn.functional as F

    from speechless_tpu_torch.ops import ctc, ctc_kernels

    batch, t_max, classes = log_probs.shape
    device = log_probs.device
    blank = classes - 1
    extended, skip = ctc.extended_labels(labels, blank)
    s_counts = (2 * label_lengths + 1).to(torch.int32)
    args = (log_probs, lengths, extended, skip, s_counts)
    t_index = torch.arange(t_max, device=device)[:, None, None]
    live = torch.arange(extended.shape[1], device=device)[None, None, :] < s_counts[None, :, None]
    result = {"S": extended.shape[1]}
    weights = torch.linspace(0.5, 2.0, batch, device=device)
    alphas, kernel_final = ctc_kernels.ctc_alpha(*args)
    want_alphas = ctc.alpha_reference(*args)
    final = ctc.final_log_prob(want_alphas[-1], s_counts)
    grad, betas = ctc_kernels.ctc_beta_grad(*args, want_alphas, final, weights,
                                            with_betas=True)
    want_betas = ctc.beta_reference(*args)
    want_grad = ctc.occupancy_gradient(log_probs, lengths, extended, s_counts, want_alphas,
                                       want_betas, final, weights)
    torch.cuda.synchronize()
    check(torch.equal(alphas, want_alphas) and torch.equal(kernel_final, final),
          "{}: K1 alphas or log P(label) differ from alpha_reference and final_log_prob at "
          "S={}".format(where, extended.shape[1]))
    # alpha is held on t < max(length, 1) (alpha_0 is always written), beta on
    # t < length, both on the live states. Their magnitude reaches ~3 * T here, where
    # one fp32 ulp is ~1e-4, so the error is scaled by max(1, |plain|).
    for name, got, want, valid in (
            ("alpha", alphas, want_alphas,
             live & (t_index < lengths.clamp(min=1)[None, :, None])),
            ("beta", betas, want_betas, live & (t_index < lengths[None, :, None]))):
        diff = (got - want).abs()[valid]
        scaled = float((diff / want.abs()[valid].clamp(min=1.0)).max())
        result[name + "_abs_err"], result[name + "_scaled_err"] = float(diff.max()), scaled
        check(bool(torch.isfinite(got[valid]).all()), name + " kernel: non-finite values")
        check(scaled <= CTC_ABS_TOL, "{}: {} kernel vs plain at S={}: scaled error {}".format(
            where, name, extended.shape[1], scaled))
    result["beta_grad_abs_err"] = float((grad - want_grad).abs().max())
    check(bool(torch.isfinite(grad).all()), "fused backward: non-finite gradient")
    check(result["beta_grad_abs_err"] <= CTC_ABS_TOL,
          "{}: fused backward gradient vs beta_reference + occupancy_gradient at S={}: {}"
          .format(where, extended.shape[1], result["beta_grad_abs_err"]))

    losses, grads = {}, {}
    for name, loss_fn in (("kernel", ctc_kernels.ctc_loss), ("plain", ctc.ctc_loss)):
        x = log_probs.clone().requires_grad_()
        loss = loss_fn(x, lengths, labels, label_lengths, blank)
        (loss * weights).sum().backward()
        losses[name], grads[name] = loss.detach(), x.grad
    torch.cuda.synchronize()
    check(bool(torch.isfinite(grads["kernel"]).all()), "kernel CTC gradient not finite")
    result["loss_rel_err"] = float(((losses["kernel"] - losses["plain"]).abs()
                                    / losses["plain"].abs()).max())
    result["grad_abs_err"] = float((grads["kernel"] - grads["plain"]).abs().max())
    check(result["loss_rel_err"] <= CTC_LOSS_RTOL, "{}: CTC loss kernel vs plain: {}".format(
        where, result["loss_rel_err"]))
    check(result["grad_abs_err"] <= CTC_ABS_TOL, "{}: CTC gradient kernel vs plain: {}"
          .format(where, result["grad_abs_err"]))

    # Second oracle: F.ctc_loss (blank C-1) on the feasible rows. Its gradient is
    # d/d(logits) of a log-softmax input, softmax - occupancy: ours plus exp(log_probs).
    rows = torch.from_numpy(np.flatnonzero(feasible)).to(device)
    lp_rows = log_probs[rows].transpose(0, 1).contiguous().requires_grad_()
    oracle = F.ctc_loss(lp_rows, labels[rows].clamp(min=0).long(), lengths[rows].long(),
                        label_lengths[rows].long(), blank=blank, reduction="none")
    (oracle * weights[rows]).sum().backward()
    frames = (torch.arange(t_max, device=device)[None, :] < lengths[rows][:, None])[..., None]
    ours = (grads["kernel"][rows] + torch.exp(log_probs[rows]) * weights[rows][:, None, None])
    result["oracle_loss_rel_err"] = float(((losses["kernel"][rows] - oracle.detach()).abs()
                                           / oracle.detach().abs()).max())
    result["oracle_grad_abs_err"] = float(
        torch.where(frames, ours - lp_rows.grad.transpose(0, 1), 0.0).abs().max())
    check(result["oracle_loss_rel_err"] <= ORACLE_LOSS_RTOL and
          result["oracle_grad_abs_err"] <= ORACLE_GRAD_ATOL,
          "{}: CTC vs F.ctc_loss: loss {} grad {}".format(
              where, result["oracle_loss_rel_err"], result["oracle_grad_abs_err"]))
    result["max_abs_err"] = max(result["alpha_abs_err"], result["beta_abs_err"],
                                result["beta_grad_abs_err"], result["grad_abs_err"])
    print("{} CTC B={} T={} U={} S={} ({} feasible rows): K1 vs alpha_reference and "
          "final_log_prob bitwise, abs {:.3g}; fused backward vs plain: beta abs {:.3g} "
          "scaled {:.3g}, gradient abs {:.3g}; loss rel {:.3g}, loss gradient abs {:.3g}; "
          "vs F.ctc_loss loss rel {:.3g}, grad abs {:.3g}".format(
              where, batch, t_max, labels.shape[1], extended.shape[1], len(rows),
              result["alpha_abs_err"], result["beta_abs_err"], result["beta_scaled_err"],
              result["beta_grad_abs_err"], result["loss_rel_err"], result["grad_abs_err"],
              result["oracle_loss_rel_err"], result["oracle_grad_abs_err"]), flush=True)
    return result, args, (alphas, final, weights, grad)


def check_ctc_kernels(rng, batch, t_max, u_max, classes, device, timed: bool):
    """`compare_ctc_kernels` on a seeded `ctc_case`; with ``timed``, CUDA-event times of
    K1, the fused backward and their plain versions, of the whole CTC forward and
    backward, and of `F.ctc_loss`'s."""
    import torch
    import torch.nn.functional as F

    from speechless_tpu_torch.ops import ctc, ctc_kernels

    log_probs, lengths, labels, label_lengths, feasible = ctc_case(
        rng, batch, t_max, u_max, classes, device)
    blank = classes - 1
    result, args, (alphas, final, weights, grad) = compare_ctc_kernels(
        "phase C", log_probs, lengths, labels, label_lengths, feasible)
    extended = args[2]
    if not timed:
        return result

    lp_tbc = log_probs.transpose(0, 1).contiguous()
    targets = (labels.clamp(min=0).long(), lengths.long(), label_lengths.long())

    def library_loss(x):
        return F.ctc_loss(x, *targets, blank=blank, reduction="none", zero_infinity=True)

    def port_loss(x, loss_fn=ctc_kernels.ctc_loss):
        return loss_fn(x, lengths, labels, label_lengths, blank)

    def forward_backward_ms(loss_fn, source, iterations):
        """(forward ms, backward ms): the loss alone, then d(sum(loss * weights))/dx from
        one retained graph."""
        x = source.clone().requires_grad_()
        forward_ms = cuda_ms(lambda: loss_fn(x), iterations)
        loss = loss_fn(x)
        backward_ms = cuda_ms(
            lambda: torch.autograd.grad(loss, x, weights, retain_graph=True), iterations)
        return forward_ms, backward_ms

    result.update(
        alpha_ms=cuda_ms(lambda: ctc_kernels.ctc_alpha(*args), 50),
        beta_grad_ms=cuda_ms(lambda: ctc_kernels.ctc_beta_grad(*args, alphas, final,
                                                               weights), 50),
        alpha_plain_ms=cuda_ms(lambda: ctc.alpha_reference(*args), 3),
        beta_grad_plain_ms=cuda_ms(lambda: ctc.gradient_reference(*args, alphas, final,
                                                                  weights), 3))
    result["fwd_ms"], result["bwd_ms"] = forward_backward_ms(port_loss, log_probs, 30)
    result["plain_fwd_ms"], result["plain_bwd_ms"] = forward_backward_ms(
        lambda x: port_loss(x, ctc.ctc_loss), log_probs, 3)
    result["library_fwd_ms"], result["library_bwd_ms"] = forward_backward_ms(
        library_loss, lp_tbc, 30)
    # Least times: each input read once and each output written once (K1: α and log
    # P(label); the backward: the gradient); ~14 fp32 operations per state and step for a
    # recursion (3 max, 4 subtract/add, 3 exp, 1 log, 3 add), 4 more for the gradient
    # (add, subtract, exp, the class sum).
    in_bytes = sum(t.numel() * t.element_size() for t in args)
    state_steps = t_max * batch * extended.shape[1]
    result["bound_ms"], result["bound_by"] = bound(in_bytes + 4 * state_steps + 4 * batch,
                                                   14.0 * state_steps)
    backward_bytes = (in_bytes + alphas.numel() * 4 + final.numel() * 4 + weights.numel() * 4
                      + grad.numel() * 4)
    result["beta_grad_bound_ms"], result["beta_grad_bound_by"] = bound(
        backward_bytes, 18.0 * state_steps)
    print("phase C CTC times at B={} T={} S={}: K1 {:.4f} ms (bound {:.4f} ms by {}), "
          "fused backward {:.4f} ms (bound {:.4f} ms by {}) per launch; plain alpha {:.2f} "
          "ms, plain beta + occupancy gradient {:.2f} ms; CTC forward {:.4f} ms, backward "
          "{:.4f} ms (plain {:.2f} / {:.2f}); F.ctc_loss forward {:.4f} ms, backward {:.4f} "
          "ms".format(batch, t_max, extended.shape[1], result["alpha_ms"],
                      result["bound_ms"], result["bound_by"], result["beta_grad_ms"],
                      result["beta_grad_bound_ms"], result["beta_grad_bound_by"],
                      result["alpha_plain_ms"], result["beta_grad_plain_ms"],
                      result["fwd_ms"], result["bwd_ms"], result["plain_fwd_ms"],
                      result["plain_bwd_ms"], result["library_fwd_ms"],
                      result["library_bwd_ms"]))
    return result


def bench_wav_batch(rng, config, steps, device):
    """`bench.py`'s batch: 64 x 131,072 samples of seeded noise with 192 random labels a
    row, one batch repeated over the steps axis."""
    import torch

    from speechless_tpu_torch.train import trainer

    wavs = torch.tensor(rng.normal(size=(1, BENCH_BATCH, BENCH_SAMPLES)) * 0.1,
                        dtype=torch.float32, device=device)
    labels = torch.tensor(rng.integers(0, config.grapheme_set_size - 1,
                                       (1, BENCH_BATCH, BENCH_LABELS)),
                          dtype=torch.int32, device=device)
    full = lambda value: torch.full((steps, BENCH_BATCH), value, dtype=torch.int32,
                                    device=device)
    return trainer.WavBatch(wavs.expand(steps, -1, -1), full(BENCH_SAMPLES),
                            labels.expand(steps, -1, -1), full(BENCH_LABELS))


def precision_check(device):
    """One fp32 step of the full-width model on a 2 x 2 s batch on the card against the
    same step on the CPU, and the same step with TF32 forced on, which must fail the
    limits (`fp32_step_card_vs_cpu`)."""
    from speechless_tpu_torch.models import wav2letter as w2l
    from speechless_tpu_torch.train import trainer

    config = w2l.Wav2LetterConfig(128, 29)
    rng = np.random.default_rng(SEED + 2)
    wavs = two_second_tones(rng)
    labels = rng.integers(0, 28, (1, 2, 24)).astype(np.int32)
    batch = trainer.WavBatch(wavs, np.full((1, 2), 32000, np.int32), labels,
                             np.full((1, 2), 24, np.int32))
    return fp32_step_card_vs_cpu("phase C", device, config, w2l.init_params(config, SEED + 2),
                                 batch, "ctc", trainer.make_multi_wav_step)


def phase_c(device, profile: bool, out_path: Path):
    """The training slice: K1/K2 checks and times, `make_multi_wav_step` at full width
    in bf16 (k=10 steps a call, one warm-up call and three timed), and the precision
    check. Returns the kernels' numbers and the train phase's launch counts."""
    import torch

    from speechless_tpu_torch.models import wav2letter as w2l
    from speechless_tpu_torch.ops import ctc_kernels
    from speechless_tpu_torch.train import trainer

    rng = np.random.default_rng(SEED + 3)
    frames = (BENCH_SAMPLES // 128 + 2) // 2  # logits per row: 1025 feature frames / 2
    ctc_bench = check_ctc_kernels(rng, BENCH_BATCH, frames, BENCH_LABELS, 29, device, True)
    ctc_long = check_ctc_kernels(rng, 16, 1401, 600, 29, device, False)
    check(ctc_long["S"] > 1024, "the long CTC check must exceed 1024 states")
    # The most states a row may have (16 a thread in K1, 32 in the backward's chain).
    check_ctc_kernels(rng, 5, 40, (ctc_kernels.MAX_STATES - 1) // 2, 29, device, False)

    config = w2l.Wav2LetterConfig(128, 29, compute_dtype=torch.bfloat16)
    optimizer = trainer.make_optimizer(1e-4)
    state = trainer.init_train_state(config, optimizer, params=w2l.init_params(config, SEED),
                                     device=device)
    batch = bench_wav_batch(rng, config, BENCH_STEPS, device)
    multi_step = trainer.make_multi_wav_step(config, optimizer, device=device)
    ctc_kernels.ctc_alpha.launches = ctc_kernels.ctc_beta_grad.launches = 0
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    start = time.perf_counter()
    state, metrics = multi_step(state, batch)
    first = metrics["step_losses"].tolist()
    warm_up_s = time.perf_counter() - start
    calls, losses = 3, []
    torch.cuda.synchronize()
    start = time.perf_counter()
    for _ in range(calls):
        state, metrics = multi_step(state, batch)
        losses.append(metrics["step_losses"])
    torch.cuda.synchronize()
    elapsed = time.perf_counter() - start
    launches = {"ctc_alpha": ctc_kernels.ctc_alpha.launches,
                "ctc_beta_grad": ctc_kernels.ctc_beta_grad.launches}
    losses = torch.stack(losses).cpu().numpy()
    check(np.isfinite(first).all() and np.isfinite(losses).all(), "non-finite step loss")
    check(float(losses[-1].mean()) < first[0], "the last call's mean loss {} is not below "
          "the first step's {}".format(float(losses[-1].mean()), first[0]))
    expected = (calls + 1) * BENCH_STEPS
    check(launches == {"ctc_alpha": expected, "ctc_beta_grad": expected},
          "CTC kernel launches in {} train steps: {}".format(expected, launches))
    steps = calls * BENCH_STEPS
    utterances_per_s = BENCH_BATCH * steps / elapsed
    flops = w2l.conv_flops_per_example(config, BENCH_SAMPLES // 128 + 1) * utterances_per_s
    train = {"ms_per_step": elapsed / steps * 1e3, "utterances_per_s": utterances_per_s,
             "mfu": flops / BF16_FLOPS_PER_S, "peak_memory_gb":
                 torch.cuda.max_memory_allocated() / 1e9, "warm_up_call_s": warm_up_s,
             "first_step_loss": first[0], "last_call_mean_loss": float(losses[-1].mean())}
    print("phase C train: make_multi_wav_step, full-width wav2letter in bf16, B={} x {} "
          "samples, {} labels, k={}: {:.2f} ms per step, {:.1f} utterances/s, MFU {:.4f} "
          "of 989 TFLOP/s bf16, peak memory {:.2f} GB; loss {:.2f} (first step) -> {:.2f} "
          "(last call's mean); warm-up call {:.2f} s; ctc_alpha/ctc_beta_grad launches {}/{}"
          .format(BENCH_BATCH, BENCH_SAMPLES, BENCH_LABELS, BENCH_STEPS,
                  train["ms_per_step"], utterances_per_s, train["mfu"],
                  train["peak_memory_gb"], first[0], train["last_call_mean_loss"],
                  warm_up_s, launches["ctc_alpha"], launches["ctc_beta_grad"]))
    precision_check(device)
    if profile:
        profile_train_step(config, state, batch, multi_step, out_path)
    return {"ctc": ctc_bench, "ctc_long": ctc_long, "train": train, "launches": launches}


def profile_train_step(config, state, batch, multi_step, out_path: Path) -> None:
    """One train step split into features, forward, CTC forward, backward and Adam
    (CUDA events, mean of 5 steps), and the device's busy share of one k-step call
    from a `torch.profiler` trace. Writes ``out_path``."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    parts = ("features", "forward", "ctc_forward", "backward", "adam")
    numbers = {"step_split_ms": split_train_step(config, state, batch, parts)}
    # The same split with cuDNN's autotuner on (off by default; the port does not turn
    # it on): how much of the step the default convolution algorithms leave.
    torch.backends.cudnn.benchmark = True
    try:
        numbers["step_split_ms_cudnn_benchmark"] = split_train_step(config, state, batch,
                                                                    parts)
    finally:
        torch.backends.cudnn.benchmark = False
    torch.cuda.synchronize()
    start = time.perf_counter()
    multi_step(state, batch)
    torch.cuda.synchronize()
    call_s = time.perf_counter() - start
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        multi_step(state, batch)
        torch.cuda.synchronize()
    per_name = {}
    for event in prof.events():
        if event.device_type == DeviceType.CUDA:
            count_us = per_name.setdefault(event.name, [0, 0.0])
            count_us[0] += 1
            count_us[1] += event.time_range.elapsed_us()
    busy_s = sum(us for _, us in per_name.values()) / 1e6
    top = sorted(per_name.items(), key=lambda item: -item[1][1])
    numbers.update({"k_step_call_s": call_s, "device_busy_s": busy_s,
                    "device_idle_share": 1.0 - busy_s / call_s,
                    "device_ops_per_call": sum(count for count, _ in per_name.values()),
                    "top_device_ops_ms": [[name[:72], count, us / 1e3]
                                          for name, (count, us) in top[:15]]})
    out_path.parent.mkdir(parents=True, exist_ok=True)
    out_path.write_text(json.dumps(numbers, indent=1))
    print("profile train (written to {}): {}".format(out_path, json.dumps(
        {key: value for key, value in numbers.items() if key != "top_device_ops_ms"})))


def split_train_step(config, state, batch, parts, runs: int = 5):
    """Mean CUDA-event milliseconds of each part of one train step over ``runs`` steps
    (after one warm-up step)."""
    import torch

    from speechless_tpu_torch.features.spectrogram import features_batch
    from speechless_tpu_torch.models import wav2letter as w2l
    from speechless_tpu_torch.ops.ctc_kernels import ctc_loss_from_logits
    from speechless_tpu_torch.precision import ieee_fp32

    totals = dict.fromkeys(parts, 0.0)
    for run in range(runs + 1):
        events = [torch.cuda.Event(enable_timing=True) for _ in range(len(parts) + 1)]
        micro = type(batch)(*(field[0] for field in batch))
        with ieee_fp32():
            events[0].record()
            features, counts = features_batch(micro.wavs, micro.wav_lengths)
            events[1].record()
            logits = state.model(features)
            events[2].record()
            lengths = w2l.prediction_lengths(config, counts).to(torch.int32)
            loss = ctc_loss_from_logits(logits, lengths, micro.labels, micro.label_lengths,
                                        config.grapheme_set_size - 1).mean()
            events[3].record()
            loss.backward()
            events[4].record()
            state.opt_state.step()
            events[5].record()
        torch.cuda.synchronize()
        if run:  # the first run warms up
            for i, part in enumerate(parts):
                totals[part] += events[i].elapsed_time(events[i + 1]) / runs
    return totals


# ---- phase D: streaming ------------------------------------------------------------
# The streaming decoder's serving shapes: 16 streams, 32-frame pieces, W=25 in r=32
# lanes, a 512-grapheme token buffer (`serving_streaming.beam_decoder_for`'s defaults).
STREAM_N, STREAM_CF, STREAM_MAX_LEN, STREAM_FRAMES = 16, 32, 512, 513
SCORE_RTOL = 1e-6     # kernel vs plain-step stream decoder scores, relative
HTTP_SESSIONS = ("beam",) * 6 + ("beam_pipelined", "greedy_final")
HTTP_RESIDENT_SESSIONS = ("beam",) * 7 + ("greedy_final",)  # resident has no pipelining
HTTP_SECONDS, HTTP_CHUNK_S = 8.0, 0.5


def stitch_case(rng, streams, frames, lanes, max_len, classes, device, kind="serving"):
    """Seeded stitch inputs: valid backpointers (parents in [0, lanes), 60 % of the
    chars -1), 20 % dead lanes (length 0, score NEG_INF), streams 0-1 with count 0
    (identity pointers, no chars), streams 2-3 entering near capacity, and exit lengths
    that are each lane's entry length plus its emissions, as the beam step gives. Edge
    kinds: ``every_frame_emits`` (no -1 chars past stream 1), ``exit_below_entry`` (exit
    lengths 1-3 below the ancestor's entry length), ``max_len_reached`` (entries within
    2 of max_len, exits capped there) and ``nan_scores`` (NaN scores in three streams,
    one all NaN)."""
    import torch

    parents = rng.integers(0, lanes, (streams, frames, lanes)).astype(np.int32)
    chars = rng.integers(0, classes - 1, (streams, frames, lanes)).astype(np.int32)
    if kind != "every_frame_emits":
        chars[rng.random(chars.shape) < 0.6] = -1
    parents[:2], chars[:2] = np.arange(lanes, dtype=np.int32), -1
    prev_len = rng.integers(0, max_len - frames + 1, (streams, lanes)).astype(np.int32)
    prev_len[2:4] = max_len - frames - rng.integers(0, 3, (2, lanes))
    if kind == "max_len_reached":
        prev_len = (max_len - rng.integers(0, 3, (streams, lanes))).astype(np.int32)
    tokens = rng.integers(0, classes - 1, (streams, lanes, max_len)).astype(np.int32)
    tokens[np.arange(max_len)[None, None, :] >= prev_len[..., None]] = -1
    lane, emitted = np.tile(np.arange(lanes), (streams, 1)), np.zeros((streams, lanes), int)
    for t in range(frames - 1, -1, -1):
        emitted += np.take_along_axis(chars[:, t], lane, 1) >= 0
        lane = np.take_along_axis(parents[:, t], lane, 1)
    entry = np.take_along_axis(prev_len, lane, 1)
    new_len = entry + emitted
    if kind == "exit_below_entry":
        new_len = entry - rng.integers(1, 4, entry.shape)
    new_len = np.clip(new_len, 0, max_len).astype(np.int32)
    final = rng.normal(-50.0, 10.0, (streams, lanes)).astype(np.float32)
    dead = rng.random((streams, lanes)) < 0.2
    dead[:, 0] = False
    new_len[dead], final[dead] = 0, -1e30
    if kind == "nan_scores":
        final[2, [3, lanes - 2]] = np.nan
        final[3] = np.nan
        final[4, 0] = -np.inf
    return [torch.from_numpy(x).to(device)
            for x in (parents, chars, tokens, prev_len, new_len, final)]


def stitch_bytes(parents, prev_len, outputs) -> int:
    """The bytes the stitch must move for this run's inputs: of each stream, the
    backpointers (parent and char) of the lanes its walks pass through, each frame's
    live set read once; the entry lengths and entry-buffer prefixes
    ``tokens[a][:prev_len[a]]`` of its distinct ancestor lanes ``a``; every exit length
    and score; and every output written once."""
    parents, prev_len = parents.cpu().numpy(), prev_len.cpu().numpy()
    streams, frames, lanes = parents.shape
    words = 2 * streams * lanes  # new_len and final
    for n in range(streams):
        live = np.arange(lanes)
        for t in range(frames - 1, -1, -1):
            words += 2 * live.size  # parents[n, t, b] and chars[n, t, b]
            live = np.unique(parents[n, t, live])
        words += live.size + int(prev_len[n, live].sum())
    return 4 * words + sum(t.numel() * t.element_size() for t in outputs)


def serving_posteriors(rng, streams, frames, classes, blank):
    """Peaky-but-noisy log posteriors of the serving shape (phase A's)."""
    import torch

    targets = rng.integers(0, classes - 1, (streams, frames))
    targets[rng.random((streams, frames)) < 0.5] = blank
    logits = rng.normal(size=(streams, frames, classes)) * 1.5
    logits[np.arange(streams)[:, None], np.arange(frames)[None, :], targets] += 6.0
    return torch.log_softmax(torch.tensor(logits, dtype=torch.float32), -1).numpy()


def check_stitch_kernel(rng, device, classes):
    """`stream_stitch` (CUDA) against `stitch_reference` on the same CUDA tensors at the
    serving shape and at seeded edge shapes: rows and best rows equal, scalars bitwise.
    The kernel's device time per launch (launches queued behind a device sleep), the
    wrapper's time per call, the plain version's, and the least time by bytes."""
    import torch

    from speechless_tpu_torch.ops.decode_incremental_kernel import (stitch_reference,
                                                                    stream_stitch)

    lanes = 32
    max_abs_err = 0.0
    # Four cases at the serving shape (F=32 and 25); one whose backpointers (F=128,
    # r=64: 64 KB) take the kernel's larger staging; the edges: one frame, every frame
    # emitting, exits below the entry length, max_len reached, NaN scores, a max_len
    # that is no multiple of 4 (the kernel's one-word copies), 512 lanes, and
    # backpointers too large to stage (F=128, r=256: 256 KB), read from device memory.
    shapes = [(STREAM_N, STREAM_CF - 7 * (trial % 2), lanes, STREAM_MAX_LEN, "serving")
              for trial in range(4)]
    shapes += [(4, 128, 64, STREAM_MAX_LEN, "serving"),
               (STREAM_N, 1, lanes, STREAM_MAX_LEN, "serving"),
               (STREAM_N, STREAM_CF, lanes, STREAM_MAX_LEN, "every_frame_emits"),
               (STREAM_N, STREAM_CF, lanes, STREAM_MAX_LEN, "exit_below_entry"),
               (STREAM_N, STREAM_CF, lanes, STREAM_MAX_LEN, "max_len_reached"),
               (STREAM_N, STREAM_CF, lanes, STREAM_MAX_LEN, "nan_scores"),
               (STREAM_N, STREAM_CF, lanes, 510, "serving"),
               (4, 8, 512, 64, "serving"), (4, 128, 256, 256, "serving")]
    for trial, (streams, frames, width, max_len, kind) in enumerate(shapes):
        args = stitch_case(rng, streams, frames, width, max_len, classes, device, kind)
        kernel, plain = stream_stitch(*args), stitch_reference(*args)
        torch.cuda.synchronize()
        for name, got, want in zip(("rows", "best rows", "scalars"), kernel, plain):
            check(got.dtype == want.dtype and torch.equal(got.view(torch.int32),
                                                          want.view(torch.int32)),
                  "stitch trial {} ({}, F={} r={} max_len={}): {} differ".format(
                      trial, kind, frames, width, max_len, name))
        finite = torch.isfinite(plain[2])
        max_abs_err = max(max_abs_err, float((kernel[2] - plain[2])[finite].abs().max()))
    args = stitch_case(rng, STREAM_N, STREAM_CF, lanes, STREAM_MAX_LEN, classes, device)
    ms = device_ms(lambda: stream_stitch(*args), 500)
    wrapper_ms = cuda_ms(lambda: stream_stitch(*args), 500)
    plain_ms = cuda_ms(lambda: stitch_reference(*args), 20)
    outputs = stream_stitch(*args)
    for got, want in zip(outputs, stitch_reference(*args)):
        check(torch.equal(got, want), "timed stitch launches disagree with the plain version")
    # Least time: what this run's data needs read once (`stitch_bytes`) and each output
    # written once; the kernel's arithmetic (a few integer operations per backpointer
    # and per output word) is negligible beside its bytes.
    moved = stitch_bytes(args[0], args[3], outputs)
    bound_ms, bound_by = bound(moved, 0.0)
    print("phase D stitch: kernel == plain (rows, best rows, scalars bitwise) over {} "
          "seeded cases: N={} F={}/{} r={} max_len={} (count-0 streams, streams near "
          "capacity, dead lanes), N=4 F=128 r=64, F=1, every frame emitting, exits below "
          "the entry length, max_len reached, NaN scores, max_len=510, N=4 F=8 r=512, N=4 "
          "F=128 r=256 max_len=256 (unstaged); "
          "kernel {:.5f} ms per launch on the device, wrapper {:.5f} ms per call, plain "
          "{:.4f} ms, bound {:.6f} ms ({}: {} bytes needed of the {} in the tensors)".format(
              len(shapes), STREAM_N, STREAM_CF, STREAM_CF - 7, lanes, STREAM_MAX_LEN, ms,
              wrapper_ms, plain_ms, bound_ms, bound_by, moved,
              sum(t.numel() * t.element_size() for t in args + list(outputs))))
    return {"max_abs_err": max_abs_err, "ms": ms, "wrapper_ms": wrapper_ms,
            "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by}


def check_stream_decoder(rng, device, blank, word_lm, profile_path=None):
    """`KernelBeamStreamDecoder` with the word LM on the card: 16 serving-shape streams
    of 513 frames fed by `feed_batch` in 32-frame pieces, once on the kernels (one span
    launch and one stitch launch per piece round) and once on the plain loop (tokens
    equal, scores within SCORE_RTOL), and against the offline `beam_search_decode_lm`
    over the same frames (chunked equals offline). A third run synchronizes around
    every kernel call to split a piece round into the span kernel, the stitch and the
    rest (packing, stacking, ranking); a fourth runs on the kernels while another
    thread decodes offline (same results, its time per round)."""
    import torch

    from speechless_tpu_torch.ops import decode_incremental_kernel, decode_lm
    from speechless_tpu_torch.ops.decode_incremental_kernel import (
        KernelBeamStreamDecoder, stitch_reference, stream_stitch)

    classes = blank + 1
    log_probs = serving_posteriors(rng, STREAM_N, STREAM_FRAMES, classes, blank)
    spent = {"span": 0.0, "stitch": 0.0}

    def timed(fn, key):
        def run(*args, **kwargs):
            torch.cuda.synchronize()
            start = time.perf_counter()
            out = fn(*args, **kwargs)
            torch.cuda.synchronize()
            spent[key] += time.perf_counter() - start
            return out
        return run

    routes, rounds = {}, -(-STREAM_FRAMES // STREAM_CF)

    def stream_all(step, stitch):
        decoder = KernelBeamStreamDecoder(
            blank=blank, beam_width=25, max_decoded_length=STREAM_MAX_LEN,
            chunk_frames=STREAM_CF, word_lm=word_lm, prune_classes=8, device=device,
            step=step, stitch=stitch)
        states = [decoder.init_state() for _ in range(STREAM_N)]
        torch.cuda.synchronize()
        start = time.perf_counter()
        for p in range(rounds):
            piece = [row[p * STREAM_CF:(p + 1) * STREAM_CF] for row in log_probs]
            results = decoder.feed_batch(states, piece)
            states = [state for state, _ in results]
        torch.cuda.synchronize()
        return results, time.perf_counter() - start

    launches = {}
    for name, step, stitch in (("warm-up", None, stream_stitch),
                               ("kernel", None, stream_stitch),
                               ("plain", decode_lm.lm_step_reference, stitch_reference)):
        decode_lm.lm_span.launches = decode_lm.lm_step.launches = 0
        stream_stitch.launches = 0
        routes[name] = stream_all(step, stitch)
        launches[name] = (decode_lm.lm_span.launches, stream_stitch.launches,
                          decode_lm.lm_step.launches)
    check(launches["kernel"] == (rounds, rounds, 0),
          "{} piece rounds launched (span, stitch, step) {}".format(rounds,
                                                                  launches["kernel"]))
    # The split: the decoder's span function and stitch, each synchronized and timed.
    original = decode_incremental_kernel.span_function
    decode_incremental_kernel.span_function = lambda step: timed(decode_lm.lm_span, "span")
    try:
        routes["split"] = stream_all(None, timed(stream_stitch, "stitch"))
    finally:
        decode_incremental_kernel.span_function = original

    # The same run on the kernels while another thread decodes one stream offline
    # (another beam, as a two-pass final is in the HTTP run).
    stop = threading.Event()

    def offline_loop():
        one = torch.from_numpy(log_probs[:1]).to(device)
        while not stop.is_set():
            decode_lm.beam_search_decode_lm(
                one, torch.full((1,), STREAM_FRAMES, device=device), blank, word_lm,
                beam_width=25, max_decoded_length=STREAM_MAX_LEN, prune_classes=8)

    rival = threading.Thread(target=offline_loop)
    rival.start()
    try:
        routes["contended"] = stream_all(None, stream_stitch)
    finally:
        stop.set()
        rival.join(timeout=600)
    check(not rival.is_alive(), "the offline decode thread did not stop")
    for route in ("contended", "split"):
        for (_, got), (_, want) in zip(routes[route][0], routes["kernel"][0]):
            check(np.array_equal(got.tokens, want.tokens) and got.score == want.score,
                  "stream decoder: the {} run changed the results".format(route))
    for (got_state, got), (_, want) in zip(routes["kernel"][0], routes["plain"][0]):
        check(np.array_equal(got.tokens, want.tokens), "stream decoder: kernel and plain "
              "tokens differ")
        check(abs(got.score - want.score) <= SCORE_RTOL * abs(want.score),
              "stream decoder: scores {} vs {}".format(got.score, want.score))
        check(got_state.committed.size == 0, "a stream rolled over; offline would differ")
    tokens, counts = decode_lm.beam_search_decode_lm(
        torch.from_numpy(log_probs).to(device),
        torch.full((STREAM_N,), STREAM_FRAMES, device=device), blank, word_lm,
        beam_width=25, max_decoded_length=STREAM_MAX_LEN, prune_classes=8)
    tokens, counts = tokens.cpu().numpy(), counts.cpu().numpy()
    for row, (_, got) in enumerate(routes["kernel"][0]):
        check(np.array_equal(got.tokens, tokens[row, :counts[row]]),
              "stream {}: chunked and offline tokens differ".format(row))
    if profile_path is not None:
        profile_piece_round(log_probs, blank, word_lm, device, profile_path)
    piece_ms = {name: seconds / rounds * 1e3 for name, (_, seconds) in routes.items()}
    split = {"span_ms": spent["span"] / rounds * 1e3,
             "stitch_ms": spent["stitch"] / rounds * 1e3}
    split["rest_ms"] = piece_ms["split"] - split["span_ms"] - split["stitch_ms"]
    print("phase D decoder: {} streams x {} frames, W=25, word LM, {}-frame pieces by "
          "feed_batch: kernel and plain tokens identical ({} tokens), scores within {}, "
          "and equal to the offline beam_search_decode_lm; launches in {} rounds (span, "
          "stitch, step) {}; {:.3f} ms per piece round on the kernels ({:.3f} ms with an "
          "offline decode in another thread), {:.2f} ms on the plain loop; synchronized "
          "split of a round ({:.3f} ms): span kernel {:.3f} ms, stitch {:.3f} ms, the "
          "rest {:.3f} ms".format(
              STREAM_N, STREAM_FRAMES, STREAM_CF, int(counts.sum()), SCORE_RTOL, rounds,
              launches["kernel"], piece_ms["kernel"], piece_ms["contended"],
              piece_ms["plain"], piece_ms["split"], split["span_ms"], split["stitch_ms"],
              split["rest_ms"]))
    return dict(piece_ms, **split)


def profile_piece_round(log_probs, blank, word_lm, device, out_path: Path) -> None:
    """One 16-stream, 32-frame piece round on the kernels under `torch.profiler` (only
    with ``--profile``): the device's busy share and its kernels. Writes ``out_path``."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from speechless_tpu_torch.ops.decode_incremental_kernel import KernelBeamStreamDecoder

    decoder = KernelBeamStreamDecoder(blank=blank, beam_width=25,
                                      max_decoded_length=STREAM_MAX_LEN,
                                      chunk_frames=STREAM_CF, word_lm=word_lm,
                                      prune_classes=8, device=device)
    states = [decoder.init_state() for _ in range(STREAM_N)]
    first = [row[:STREAM_CF] for row in log_probs]
    states = [state for state, _ in decoder.feed_batch(states, first)]
    second = [row[STREAM_CF:2 * STREAM_CF] for row in log_probs]
    torch.cuda.synchronize()
    start = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        decoder.feed_batch(states, second)
        torch.cuda.synchronize()
    wall_s = time.perf_counter() - start
    per_name = {}
    for event in prof.events():
        if event.device_type == DeviceType.CUDA:
            count_us = per_name.setdefault(event.name, [0, 0.0])
            count_us[0] += 1
            count_us[1] += event.time_range.elapsed_us()
    busy_s = sum(us for _, us in per_name.values()) / 1e6
    top = sorted(per_name.items(), key=lambda item: -item[1][1])
    numbers = {"piece_round_wall_s_traced": wall_s, "device_busy_s": busy_s,
               "device_idle_share": 1.0 - busy_s / wall_s,
               "device_ops_per_round": sum(count for count, _ in per_name.values()),
               "top_device_ops_ms": [[name[:72], count, us / 1e3]
                                     for name, (count, us) in top[:12]]}
    out_path.parent.mkdir(parents=True, exist_ok=True)
    out_path.write_text(json.dumps(numbers, indent=1))
    print("profile stream piece round (written to {}): {}".format(out_path, json.dumps(
        {key: value for key, value in numbers.items() if key != "top_device_ops_ms"})))


def http_request(port: int, path: str, body: bytes = b"",
                 content_type: str = "application/json"):
    request = urllib.request.Request("http://127.0.0.1:{}{}".format(port, path),
                                     data=body, method="POST")
    request.add_header("Content-Type", content_type)
    start = time.perf_counter()
    with urllib.request.urlopen(request, timeout=600) as response:
        return response.status, json.loads(response.read()), time.perf_counter() - start


def record_resident_blocks(pool, sessions, consumed):
    """Record, per session, the log-posterior block (its valid rows) that each resident
    dispatch advanced the session's carry over: the rows the dispatch's advance range
    picked (`_resident_advance`) and the blocks handed to `advance_in_program`."""
    session_of = {pool._sessions[sid]._row: sid for sid in sessions}
    decoder, current = pool._resident_decoder, {}
    advance_range, advance = pool._resident_advance, decoder.advance_in_program

    def recording_range(payloads):
        out = advance_range(payloads)
        current["rows"] = [payloads[slot][0] for slot in out[2]]
        return out

    def recording_advance(state, log_probs, counts):
        for row, block, count in zip(current["rows"], log_probs.cpu().numpy(), counts):
            if row in session_of:
                consumed.setdefault(session_of[row], []).append(block[:count].copy())
        return advance(state, log_probs, counts)

    pool._resident_advance = recording_range
    decoder.advance_in_program = recording_advance


def resident_against_host_pool(transcriber, audios, chunk, http_finals):
    """Each audio alone, fed in ``chunk``-sample pieces and finished, through a resident
    device pool and through the host pool's sync beam, on a transcriber whose length
    bucket is the pool's window: both run the features and the model on (1, window)
    rows, so the posteriors and the finals must agree. (In the concurrent HTTP pass a
    dispatch's row count varies, and fp32 convolutions of another batch size may differ
    in the last bits.) Returns how many of ``http_finals`` equal these finals."""
    import copy

    from speechless_tpu_torch.serving_device_stream import DeviceStreamingPool
    from speechless_tpu_torch.serving_streaming import StreamingSessionPool

    resident = DeviceStreamingPool(transcriber, beam_mode="resident")
    twin = copy.copy(transcriber)
    twin.sample_buckets = (resident.window,)
    host = StreamingSessionPool(twin)
    resident.start()
    host.start()
    equal = 0
    try:
        for audio, http_final in zip(audios, http_finals):
            finals = []
            for pool in (resident, host):
                sid = pool.create(partial_decode="beam")
                for start in range(0, len(audio), chunk):
                    pool.feed(sid, audio[start:start + chunk])
                finals.append(pool.finish(sid))
            check(finals[0] == finals[1] and finals[0], "alone, the resident final {!r} "
                  "!= the host pool's sync beam {!r}".format(*finals))
            equal += http_final == finals[0]
    finally:
        resident.stop()
        host.stop()
    return equal


def phase_d_http(transcriber, make_audio, label, device_streams=False,
                 beam_mode="posterior"):
    """Eight concurrent `/v1/stream` sessions on the card, each fed 8 s in 0.5 s chunks,
    then finished: on the host pool (6 beam, 1 beam_pipelined, 1 greedy with
    final_decode), or with ``device_streams`` on the device pool (`serve
    --device-streams`: warmed, then the same sessions; ``beam_mode="resident"`` runs 7
    beam sessions, the mode has no pipelined one). Every reply must be 200 and the
    two-pass final the offline transcript, and each beam final must equal a replay of
    the rows its beam consumed (resident: the blocks its carry advanced over inside the
    dispatches) through the plain-step decoder. Resident mode also holds each beam
    session's audio, alone, against the host pool's sync beam
    (`resident_against_host_pool`). Returns the launch counts of this run and the feed
    latencies."""
    import torch

    from speechless_tpu_torch.ops import decode_lm
    from speechless_tpu_torch.ops.decode_incremental_kernel import (
        KernelBeamStreamDecoder, stitch_reference, stream_stitch)
    from speechless_tpu_torch.serving_http import TranscriptionServer

    resident = beam_mode == "resident"
    modes = HTTP_RESIDENT_SESSIONS if resident else HTTP_SESSIONS
    audios = [make_audio(HTTP_SECONDS) for _ in modes]
    chunk = int(HTTP_CHUNK_S * 16000)
    server = TranscriptionServer(transcriber, port=0, max_batch=16, max_wait_ms=20.0,
                                 device_streams=device_streams, beam_mode=beam_mode)
    pool = server.streams
    if device_streams:
        pool.warm_up()  # as `serve --device-streams` does before it binds
    server.start()
    consumed, finals, latencies = {}, {}, {"greedy": [], "beam": []}
    statuses, finishes = [], []  # finishes: (mode, start s, seconds)
    try:
        sessions = []
        for mode in modes:
            body = ({"partial_decode": "greedy", "final_decode": True}
                    if mode == "greedy_final" else {"partial_decode": mode})
            status, payload, _ = http_request(server.port, "/v1/stream",
                                              json.dumps(body).encode())
            statuses.append(status)
            sid = payload["session"]
            sessions.append(sid)
            if mode == "greedy_final" or resident:
                continue  # resident blocks are recorded in the dispatch, below
            # Record the rows each advance consumes (the beam_advance_fn seam).
            stream = pool._sessions[sid]  # a `StreamSession` on either pool
            log = consumed.setdefault(sid, [])
            seam = "_beam_submit" if mode == "beam_pipelined" else "_beam_advance"
            original = getattr(stream, seam)

            def recording(state, rows, original=original, log=log):
                log.append(np.array(rows, copy=True))
                return original(state, rows)

            setattr(stream, seam, recording)

        if resident:
            record_resident_blocks(pool, sessions, consumed)

        def run(index):
            sid, audio = sessions[index], audios[index]
            kind = "greedy" if modes[index] == "greedy_final" else "beam"
            for feed, start in enumerate(range(0, len(audio), chunk)):
                status, _, seconds = http_request(
                    server.port, "/v1/stream/" + sid,
                    audio[start:start + chunk].astype("<f4").tobytes(),
                    "application/octet-stream")
                statuses.append(status)
                latencies[kind].append((seconds, feed))
            began = time.perf_counter()
            status, payload, seconds = http_request(server.port,
                                                    "/v1/stream/{}/finish".format(sid))
            statuses.append(status)
            finals[sid] = payload
            finishes.append((modes[index], round(began - origin, 3), round(seconds, 4)))

        if device_streams:
            advance_batcher = None if resident else pool._get_beam_batcher()
            batchers = [("feed", pool.batcher)] + (
                [] if resident else [("advance", advance_batcher)])
        else:
            advance_batcher = pool.beam_batcher
            batchers = [("window", pool.batcher), ("posterior", pool.posterior_batcher),
                        ("advance", advance_batcher)]
        # Every dispatch of the stream batchers: (start s, seconds, batch size, work:
        # audio samples of the windows or chunks, or frames of the advances).
        dispatches = {}
        origin = time.perf_counter()
        for name, batcher in batchers:
            def logged(batch, serve=batcher._serve, log=dispatches.setdefault(name, [])):
                start = time.perf_counter()
                try:
                    serve(batch)
                finally:
                    log.append((round(start - origin, 3),
                                round(time.perf_counter() - start, 4), len(batch),
                                sum(len(item.payload[1]) if isinstance(item.payload, tuple)
                                    else len(item.payload) for item in batch)))
            batcher._serve = logged
        decode_lm.lm_span.launches = decode_lm.lm_step.launches = 0
        stream_stitch.launches = 0
        threads = [threading.Thread(target=run, args=(i,)) for i in range(len(sessions))]
        for thread in threads:
            thread.start()
        for thread in threads:
            thread.join(timeout=900)
        launches = {"lm_beam_span": decode_lm.lm_span.launches,
                    "stream_stitch": stream_stitch.launches,
                    "lm_beam_step": decode_lm.lm_step.launches}
        metrics = (pool.batcher if resident else advance_batcher).metrics()
        served = pool._resident_decoder if resident else advance_batcher.decoder
    finally:
        server.stop()
    check(len(finals) == len(sessions), "a stream session did not finish")
    check(all(status == 200 for status in statuses), "stream replies: {}".format(
        sorted(set(statuses))))
    check(launches["lm_beam_span"] > 0 and launches["stream_stitch"] > 0
          and launches["lm_beam_step"] == 0,
          "the stream sessions launched the kernels {}".format(launches))
    check(isinstance(served, KernelBeamStreamDecoder), "the stream beam is not on the "
          "kernel decoder: {}".format(type(served).__name__))
    beam_sids = [sid for sid, mode in zip(sessions, modes) if mode != "greedy_final"]
    # Replay every beam session's consumed rows (resident: the blocks its carry advanced
    # over inside the dispatches), advance by advance, through the plain-step decoder
    # (the sessions together by feed_batch: exact per stream).
    plain = KernelBeamStreamDecoder(
        blank=served.blank, beam_width=served.beam_width,
        max_decoded_length=served.max_decoded_length, chunk_frames=served.chunk_frames,
        word_lm=served.word_lm, lm_weight=served.lm_weight,
        word_count_weight=served.word_count_weight,
        valid_word_count_weight=served.valid_word_count_weight,
        prune_classes=served.prune_classes, device=served.device,
        step=decode_lm.lm_step_reference, stitch=stitch_reference)
    states = [plain.init_state() for _ in beam_sids]
    results = [None] * len(beam_sids)
    empty = np.zeros((0, transcriber.blank_index + 1), np.float32)
    for advance in range(max(len(consumed[sid]) for sid in beam_sids)):
        rows = [consumed[sid][advance] if advance < len(consumed[sid]) else empty
                for sid in beam_sids]
        for i, (state, result) in enumerate(plain.feed_batch(states, rows)):
            states[i] = state
            if advance < len(consumed[beam_sids[i]]):
                results[i] = result
    for sid, result in zip(beam_sids, results):
        replay = transcriber.codec.decode_graphemes(result.tokens.tolist(),
                                                    merge_repeated=False)
        check(finals[sid]["text"] == replay, "session {}: final {!r} != plain replay "
              "{!r}".format(sid, finals[sid]["text"], replay))
    host_equal = None
    if resident:
        host_equal = resident_against_host_pool(
            transcriber, [audios[sessions.index(sid)] for sid in beam_sids], chunk,
            [finals[sid]["text"] for sid in beam_sids])
    two_pass = sessions[modes.index("greedy_final")]
    offline = transcriber.transcribe_audio(audios[modes.index("greedy_final")])
    check(finals[two_pass]["text"] == offline, "two-pass final {!r} != offline {!r}".format(
        finals[two_pass]["text"], offline))
    torch.cuda.synchronize()
    numbers = {"launches": launches, "dispatch_batches": metrics["batches"],
               "http_finals_equal_lone": host_equal,
               "frames_consumed": sum(len(r) for sid in consumed for r in consumed[sid])}
    for kind, values in latencies.items():
        values = sorted(values)
        numbers[kind + "_feed_p50_s"] = values[len(values) // 2][0]
        numbers[kind + "_feed_p95_s"] = values[min(len(values) - 1,
                                                   int(len(values) * 0.95))][0]
        numbers[kind + "_slowest_feeds"] = [[round(s, 4), f] for s, f in values[-4:]]
    numbers["slowest_dispatches"] = {name: sorted(log, key=lambda d: -d[1])[:3]
                                     for name, log in dispatches.items()}
    numbers["finishes"] = sorted(finishes, key=lambda f: f[1])
    pool_name = ("device pool, " + beam_mode) if device_streams else "host pool"
    held = "equal their plain-step replays ({} frames)".format(numbers["frames_consumed"])
    if resident:
        held += ("; alone, each session's audio gave the same final on the resident "
                 "pool as on the host pool's sync beam ({} of {} HTTP finals equal to "
                 "them)".format(host_equal, len(beam_sids)))
    print("phase D HTTP ({}, {} pass): {} sessions ({}) x {} feeds of {} s on {}: every "
          "reply 200; the {} beam finals {}, the two-pass final the offline transcript; "
          "{} {} in {} batches; feed latency greedy p50 {:.4f} s p95 {:.4f} s, beam p50 "
          "{:.4f} s p95 {:.4f} s; slowest [s, feed index] greedy {} beam {}; launches "
          "lm_beam_span {} stream_stitch {} lm_beam_step {}; finals: {}".format(
              pool_name, label, len(sessions), ", ".join(modes),
              int(HTTP_SECONDS / HTTP_CHUNK_S), HTTP_CHUNK_S, transcriber.device,
              len(beam_sids), held, metrics["feeds" if resident else "advances"],
              "feeds" if resident else "advances", metrics["batches"],
              numbers["greedy_feed_p50_s"], numbers["greedy_feed_p95_s"],
              numbers["beam_feed_p50_s"], numbers["beam_feed_p95_s"],
              numbers["greedy_slowest_feeds"], numbers["beam_slowest_feeds"],
              launches["lm_beam_span"], launches["stream_stitch"],
              launches["lm_beam_step"], [finals[sid]["text"][:24] for sid in sessions]))
    print("phase D HTTP ({}, {} pass) slowest dispatches [start s, seconds, batch, work]: "
          "{}; finishes [mode, start s, seconds]: {}".format(
              pool_name, label, numbers["slowest_dispatches"], numbers["finishes"]))
    return numbers


SPLIT_STAGES = ("inputs", "row_update", "features", "model", "softmax_slice",
                "packing", "span", "ranking", "stitch", "write_back", "fetch")


def split_resident_feed(transcriber, make_audio):
    """One resident dispatch of 16 beam sessions at the 8 s window (``beam_cf=40``), split
    into stages: 16 sessions are fed 0.5 s chunks in lockstep, one 16-row dispatch a
    round. On the even rounds of the last eight, the dispatch synchronizes at every
    stage boundary and times each stage by CUDA events and by the host clock: the
    host's inputs (the chunks, the advance range, the uploads), the row update, the
    features, the model, the softmax and slice of the advance blocks (with the carries'
    reset and gather), the packing of the frames, the span kernel, the ranking, the
    stitch kernel, the write-back of the carries, and the fetch (one copy to the host
    after the last launch). The odd rounds run unsynchronized: their dispatch wall by
    the host clock."""
    import torch

    from speechless_tpu_torch import serving_device_stream as sds
    from speechless_tpu_torch.ops import decode_incremental_kernel, decode_lm
    from speechless_tpu_torch.ops.decode_incremental_kernel import stream_stitch

    streams, rounds = 16, int(HTTP_SECONDS / HTTP_CHUNK_S)
    chunk = int(HTTP_CHUNK_S * 16000)
    pool = sds.DeviceStreamingPool(transcriber, max_sessions=streams, max_batch=streams,
                                   max_wait_ms=500.0, beam_mode="resident")
    decoder = pool._resident_decoder
    pool.warm_up()
    sessions = [pool.create_stream(partial_decode="beam") for _ in range(streams)]
    marks, plain_walls, timing = [], [], {"on": False}

    def mark(name):
        if timing["on"]:
            torch.cuda.synchronize()
            event = torch.cuda.Event(enable_timing=True)
            event.record()
            marks[-1].append((name, time.perf_counter(), event))

    def marked(fn, before, after=None):
        def run(*args, **kwargs):
            mark(before)
            out = fn(*args, **kwargs)
            if after is not None:
                mark(after)
            return out
        return run

    def dispatch(group, real=pool._dispatch):
        # Session 0 rides every round's dispatch; its total moves only after it. The
        # flushes at finish carry empty pieces.
        feed = (sessions[0]._total // chunk if len(group) == streams
                and all(len(item.payload[1]) for item in group) else -1)
        timed = feed >= rounds - 8
        timing["on"] = timed and feed % 2 == 0
        if timing["on"]:
            marks.append([])
        start = time.perf_counter()
        try:
            mark("inputs")
            real(group)
            mark("end")
        finally:
            if timed and not timing["on"]:
                plain_walls.append(time.perf_counter() - start)
            timing["on"] = False

    model = transcriber.model
    features, span_function = sds.features_batch, decode_incremental_kernel.span_function
    pool._dispatch = dispatch
    pool._feed = marked(pool._feed, "row_update", "fetch")
    sds.features_batch = marked(features, "features")
    model.forward = marked(model.forward, "model", "softmax_slice")
    decoder.advance_in_program = marked(decoder.advance_in_program, "packing",
                                        "write_back")
    decode_incremental_kernel.span_function = lambda step: marked(
        decode_lm.lm_span, "span", "ranking")
    decoder._stitch_fn = marked(stream_stitch, "stitch")
    audios = [make_audio(HTTP_SECONDS) for _ in range(streams)]
    barrier = threading.Barrier(streams)
    errors = []

    def run(i):
        try:
            for r in range(rounds):
                barrier.wait(timeout=300)
                sessions[i].feed(audios[i][r * chunk:(r + 1) * chunk])
            sessions[i].finish()
        except Exception as error:  # noqa: BLE001 — reported by the check below
            errors.append(error)
            barrier.abort()

    pool.start()
    try:
        threads = [threading.Thread(target=run, args=(i,)) for i in range(streams)]
        for thread in threads:
            thread.start()
        for thread in threads:
            thread.join(timeout=600)
    finally:
        pool.stop()
        sds.features_batch = features
        del model.forward
        decode_incremental_kernel.span_function = span_function
    check(not errors and not any(thread.is_alive() for thread in threads),
          "the split run failed: {}".format(errors[:1]))
    check(all(session.text for session in sessions), "a split session has no text")
    order = list(SPLIT_STAGES) + ["end"]
    complete = [m for m in marks if [name for name, _, _ in m] == order]
    check(len(complete) == 4 and len(plain_walls) == 4,
          "{} timed and {} plain 16-row dispatches (marks {})".format(
              len(complete), len(plain_walls), [[n for n, _, _ in m] for m in marks][:2]))
    split = {}
    for i, stage in enumerate(SPLIT_STAGES):
        split[stage + "_ms"] = float(np.mean(
            [m[i][2].elapsed_time(m[i + 1][2]) for m in complete]))
        split[stage + "_wall_ms"] = float(np.mean(
            [(m[i + 1][1] - m[i][1]) * 1e3 for m in complete]))
    split["synchronized_wall_ms"] = float(np.mean(
        [(m[-1][1] - m[0][1]) * 1e3 for m in complete]))
    split["dispatch_wall_ms"] = float(np.median(plain_walls)) * 1e3
    print("phase D resident feed split ({} streams, {} s window, beam_cf {}, mean of {} "
          "synchronized 16-row dispatches; CUDA events between the stage boundaries, ms, "
          "the host clock in brackets): {}; synchronized dispatch {:.3f} ms; "
          "unsynchronized dispatch wall (median of {}) {:.3f} ms".format(
              streams, pool.window / 16000, pool._beam_cf, len(complete),
              ", ".join("{} {:.4f} [{:.4f}]".format(stage, split[stage + "_ms"],
                                                    split[stage + "_wall_ms"])
                        for stage in SPLIT_STAGES),
              split["synchronized_wall_ms"], len(plain_walls), split["dispatch_wall_ms"]))
    return split


def check_lexicon_stream(device, transcriber, lm_directory, make_audio):
    """A lexicon-constrained stream session on the card (`beam_decoder_for` routes it to
    the plain-step `decode_incremental.BeamStreamDecoder`, whose stitch is the kernel):
    8 s in 0.5 s chunks, finished; the rows its beam consumed, fed to the same decoder
    on the CPU, give the same transcript; every completed word is in the vocabulary.
    Then the decoder's piece round: 16 serving-shape streams, one 32-frame piece each
    by `feed_batch` (W=25), three rounds timed by the host clock around a synchronize."""
    import torch

    from speechless_tpu_torch.ops.decode_incremental import BeamStreamDecoder
    from speechless_tpu_torch.ops.decode_incremental_kernel import stream_stitch
    from speechless_tpu_torch.serving import Transcriber
    from speechless_tpu_torch.serving_streaming import StreamingTranscriber

    lexicon = Transcriber(transcriber.config, serving_params(transcriber.config),
                          transcriber.codec.allowed_characters, device=device,
                          kenlm_directory=lm_directory, lexicon_constrained=True)
    stream = StreamingTranscriber(lexicon, partial_decode="beam")
    decoder = stream._beam_decoder
    check(type(decoder) is BeamStreamDecoder and decoder.lexicon_constrained,
          "the lexicon stream runs on {}".format(type(decoder).__name__))
    consumed = []
    advance = stream._beam_advance

    def recording(state, rows):
        consumed.append(np.array(rows, copy=True))
        return advance(state, rows)

    stream._beam_advance = recording
    audio = make_audio(HTTP_SECONDS)
    stream_stitch.launches = 0
    start = time.perf_counter()
    text = stream.transcribe_stream(audio, int(HTTP_CHUNK_S * 16000))
    torch.cuda.synchronize()
    session_s = time.perf_counter() - start
    launches = stream_stitch.launches
    check(launches > 0, "the lexicon stream launched no stitch")
    cpu = BeamStreamDecoder(
        blank=decoder.blank, beam_width=decoder.beam_width,
        max_decoded_length=decoder.max_decoded_length, chunk_frames=decoder.chunk_frames,
        word_lm=decoder.word_lm, lm_weight=decoder.lm_weight,
        word_count_weight=decoder.word_count_weight,
        valid_word_count_weight=decoder.valid_word_count_weight,
        prune_classes=decoder.prune_classes, lexicon_constrained=True, device="cpu")
    state = cpu.init_state()
    for rows in consumed:
        state, result = cpu.feed(state, rows)
    cpu_text = lexicon.codec.decode_graphemes(result.tokens.tolist(), merge_repeated=False)
    check(text == cpu_text, "lexicon stream: card {!r} != CPU {!r}".format(text, cpu_text))
    vocabulary = {word for sentence in readme_sentences() for word in sentence.split()}
    words = text.split(" ")
    check(all(word in vocabulary for word in words[:-1] if word),
          "a lexicon stream word left the vocabulary: {!r}".format(text))
    check(bool(text.strip()), "the lexicon stream decoded nothing")
    rng = np.random.default_rng(SEED + 6)
    classes = lexicon.blank_index + 1
    log_probs = serving_posteriors(rng, STREAM_N, 3 * STREAM_CF, classes,
                                   lexicon.blank_index)
    piece_decoder = BeamStreamDecoder(
        blank=lexicon.blank_index, beam_width=25, max_decoded_length=STREAM_MAX_LEN,
        chunk_frames=STREAM_CF, word_lm=lexicon.word_lm, lm_weight=0.8,
        prune_classes=8, lexicon_constrained=True, device=device)
    states = [piece_decoder.init_state() for _ in range(STREAM_N)]
    walls = []
    for p in range(3):
        pieces = [row[p * STREAM_CF:(p + 1) * STREAM_CF] for row in log_probs]
        torch.cuda.synchronize()
        start = time.perf_counter()
        states = [s for s, _ in piece_decoder.feed_batch(states, pieces)]
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - start)
    numbers = {"session_s": session_s, "stitch_launches": launches,
               "frames": sum(len(rows) for rows in consumed),
               "piece_round_ms": float(np.median(walls)) * 1e3}
    print("phase D lexicon stream: {} s in {} s chunks on {} ({} frames, {} stitch "
          "launches) in {:.3f} s, its text equal to the same rows through the decoder on "
          "the CPU, every completed word in the vocabulary: {!r}; piece round of the "
          "plain-step lexicon decoder ({} streams x {} frames, W=25, median of 3): {:.2f} "
          "ms".format(HTTP_SECONDS, HTTP_CHUNK_S, device, numbers["frames"], launches,
                      session_s, text[:48], STREAM_N, STREAM_CF,
                      numbers["piece_round_ms"]))
    return numbers


def phase_d(device, transcriber, make_audio, lm_directory, profile_path=None):
    """The streaming slice: the stitch kernel, the stream decoder on the kernels, and
    the HTTP stream sessions on the host pool, the device pool's posterior mode and its
    resident mode, each twice: on a fresh server (the first windows of each batch size
    and length meet cold convolution shapes) and again on a new server in the same
    process (warm). The warm passes are the main paths whose launches are reported.
    Then the split of a resident dispatch and a lexicon-constrained stream session."""
    rng = np.random.default_rng(SEED + 4)
    blank = transcriber.blank_index
    stitch = check_stitch_kernel(rng, device, blank + 1)
    decoder = check_stream_decoder(rng, device, blank, transcriber.word_lm, profile_path)
    passes, seconds = {}, {}
    for name, options in (("http", {}), ("device", {"device_streams": True}),
                          ("resident", {"device_streams": True,
                                        "beam_mode": "resident"})):
        start = time.perf_counter()
        passes[name + "_cold"] = phase_d_http(transcriber, make_audio, "cold", **options)
        passes[name] = phase_d_http(transcriber, make_audio, "warm", **options)
        seconds[name + " passes"] = time.perf_counter() - start
    print("phase D launches in the warm resident pass (the device pool's main path): "
          "lm_beam_span {lm_beam_span}, stream_stitch {stream_stitch}, lm_beam_step "
          "{lm_beam_step}".format(**passes["resident"]["launches"]))
    print("phase D feed latency, warm passes of one call (s): " + "; ".join(
        "{} greedy p50 {:.4f} p95 {:.4f}, beam p50 {:.4f} p95 {:.4f}".format(
            name, numbers["greedy_feed_p50_s"], numbers["greedy_feed_p95_s"],
            numbers["beam_feed_p50_s"], numbers["beam_feed_p95_s"])
        for name, numbers in (("host pool", passes["http"]),
                              ("device pool posterior", passes["device"]),
                              ("device pool resident", passes["resident"]))))
    start = time.perf_counter()
    split = split_resident_feed(transcriber, make_audio)
    seconds["split"] = time.perf_counter() - start
    lexicon = check_lexicon_stream(device, transcriber, lm_directory, make_audio)
    seconds["lexicon"] = time.perf_counter() - start - seconds["split"]
    print("phase D wall (s): " + ", ".join("{} {:.1f}".format(name, value)
                                           for name, value in seconds.items()))
    return dict(passes, stitch=stitch, decoder=decoder, split=split, lexicon=lexicon)


# ---- phase E: offline decoding -----------------------------------------------------
SKIP_BLANK = math.log(0.999)  # the fast-path threshold of decode_pallas.py's docstring
NBEST = 5


def e_case(rng, batch, frames, classes, blank, lengths, confident_every=None):
    """Seeded peaky-but-noisy log posteriors (phase A's) with the given row lengths;
    with ``confident_every``, every such frame's blank is near-certain."""
    import torch

    log_probs = serving_posteriors(rng, batch, frames, classes, blank)
    if confident_every:
        logits = log_probs.copy()
        logits[:, ::confident_every, blank] += 30.0
        log_probs = torch.log_softmax(torch.from_numpy(logits), -1).numpy()
    return log_probs, np.asarray(lengths, np.int32)


def check_prefix_beam(name, log_probs, lengths, blank, beam_width, k, skip, device,
                      iterations):
    """K3 (`prefix_beam`) against `prefix_beam_reference` on the same CUDA tensors:
    parents, chars and lengths equal, pb/pnb bitwise. Times the wrapper (CUDA events,
    mean of ``iterations`` launches) and the one plain run; the fast path's share of
    the active frames; the least time from the bytes and operations this run needs."""
    import torch

    from speechless_tpu_torch.ops.beam_common import next_pow2
    from speechless_tpu_torch.ops.decode_lm import pack_frames
    from speechless_tpu_torch.ops.decode_whole import (_threshold, prefix_beam,
                                                       prefix_beam_reference)

    log_probs = torch.as_tensor(log_probs, device=device)
    lengths = torch.as_tensor(lengths, dtype=torch.int32, device=device)
    batch, t_max, classes = log_probs.shape
    frames = pack_frames(log_probs, k)
    static = dict(k=k, blank=blank, beam_width=beam_width, max_decoded_length=t_max,
                  skip_blank_log_prob=skip)
    got = prefix_beam(frames, lengths, **static)
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    want = prefix_beam_reference(frames, lengths, **static)
    end.record()
    torch.cuda.synchronize()
    plain_ms = start.elapsed_time(end)
    for label, g, w in zip("parents chars pb pnb len".split(), got, want):
        check(g.dtype == w.dtype and torch.equal(g, w),
              "prefix_beam {}: {} differs from the plain version".format(name, label))
    timed = []
    ms = cuda_ms(lambda: timed.append(prefix_beam(frames, lengths, **static)), iterations)
    for g, w in zip(timed[-1], want):
        check(torch.equal(g, w), "timed prefix_beam launches disagree with the plain version")
    n_pad = next_pow2((k + 1) * got[0].shape[2])  # the kernel's lanes, for the report
    active = torch.arange(t_max, device=device)[None, :] < lengths[:, None].long()
    fast = active & (log_probs[..., blank] > _threshold(skip))
    active_frames, fast_frames = int(active.sum()), int(fast.sum())
    # Least time: the active frames' packed rows and the lengths read once, every output
    # written once. Operations: what the function needs, not this kernel's padded
    # network: per full-update row-frame a comparison sort of the (k + 1) W live
    # candidates (n log2 n) and a segmented log-sum-exp over them (~4 n); per fast-path
    # row-frame ~4 per beam.
    live = (k + 1) * beam_width
    per_full = live * math.log2(live) + 4 * live
    moved = (active_frames * frames.shape[2] * 4 + lengths.numel() * 4
             + sum(t.numel() * t.element_size() for t in got))
    bound_ms, bound_by = bound(moved, (active_frames - fast_frames) * per_full
                               + fast_frames * beam_width * 4)
    result = {"ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by,
              "bytes": moved, "fast_share": fast_frames / max(active_frames, 1),
              "n_pad": n_pad, "max_abs_err": max(float((g - w).abs().max())
                                                 for g, w in zip(got[2:4], want[2:4]))}
    print("phase E prefix_beam {}: B={} T={} C={} W={} k={} ({} lanes) skip={}: kernel == "
          "plain (parents, chars, len equal; pb, pnb bitwise); fast path {:.1%} of {} "
          "active frames; kernel {:.4f} ms per launch, plain {:.1f} ms, bound {:.6f} ms "
          "({}: {} bytes)".format(name, batch, t_max, classes, beam_width, k, n_pad,
                                  "off" if skip is None else round(skip, 6),
                                  result["fast_share"], active_frames, ms, plain_ms,
                                  bound_ms, bound_by, moved))
    return result, got


def check_backtrace(name, parents, chars, best, counts, max_len, iterations=0):
    """`beam_backtrace` (the kernel) against `backtrace_tokens` (plain PyTorch) on the
    same CUDA tensors: tokens and counts equal. With ``iterations``, the kernel's device
    time per launch (launches queued behind a device sleep), the wrapper's time per
    call, the plain version's, and the least time by bytes: two words a frame along
    each start's path, each start and count read once, the tokens written once."""
    import torch

    from speechless_tpu_torch.ops.beam_common import backtrace_tokens, beam_backtrace

    best, counts = best.to(torch.int32), counts.to(torch.int32)
    got = beam_backtrace(parents, chars, best, counts, max_len)
    want = backtrace_tokens(parents, chars, best, counts, max_len)
    for label, g, w in zip(("tokens", "counts"), got, want):
        check(g.dtype == w.dtype and torch.equal(g, w),
              "beam_backtrace {}: {} differ from the plain version".format(name, label))
    if not iterations:
        return None
    ms = device_ms(lambda: beam_backtrace(parents, chars, best, counts, max_len), iterations)
    call_ms = cuda_ms(lambda: beam_backtrace(parents, chars, best, counts, max_len),
                      iterations)
    plain_ms = cuda_ms(lambda: backtrace_tokens(parents, chars, best, counts, max_len), 5)
    t_max = parents.shape[1]
    moved = 4 * (2 * best.numel() * t_max + 2 * best.numel()) + got[0].numel() * 4
    bound_ms, bound_by = bound(moved, 0.0)
    print("phase E beam_backtrace {}: B={} T={} r={} starts {} max_len={}: kernel == plain "
          "(tokens, counts); kernel {:.5f} ms per launch on the device, {:.5f} ms per "
          "wrapper call, plain {:.3f} ms, bound {:.6f} ms ({}: {} bytes)".format(
              name, parents.shape[0], t_max, parents.shape[2], tuple(best.shape), max_len,
              ms, call_ms, plain_ms, bound_ms, bound_by, moved))
    return {"ms": ms, "call_ms": call_ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
            "bound_by": bound_by, "max_abs_err": 0.0}


def backtrace_case(rng, batch, t_max, lanes, starts, device):
    """Seeded backpointers (parents in [0, lanes), 60 % of the chars -1, row 0 emitting
    on every frame), ``starts`` final lanes a row ((B,) when 1) and counts: the emitted
    count, off by up to 2, 0 on the last row and past T on the first."""
    import torch

    from speechless_tpu_torch.ops.beam_common import backtrace_tokens

    parents = rng.integers(0, lanes, (batch, t_max, lanes)).astype(np.int32)
    chars = rng.integers(0, 28, (batch, t_max, lanes)).astype(np.int32)
    chars[1:][rng.random(chars[1:].shape) < 0.6] = -1
    best = rng.integers(0, lanes, (batch, starts)).astype(np.int32)
    parents, chars, best = (torch.from_numpy(x).to(device) for x in (parents, chars, best))
    full = torch.full((batch,), t_max, device=device)
    emitted = torch.stack([(backtrace_tokens(parents, chars, best[:, s], full, t_max)[0]
                            >= 0).sum(-1) for s in range(starts)], 1)
    counts = emitted + torch.from_numpy(rng.integers(-2, 3, (batch, starts))).to(device)
    counts[-1, 0], counts[0, -1] = 0, t_max + 3
    counts = counts.clamp(min=0).to(torch.int32)
    if starts == 1:
        best, counts = best[:, 0].contiguous(), counts[:, 0].contiguous()
    return parents, chars, best, counts


def check_backtrace_edges(rng, device):
    """The backtrace kernel on seeded rows: 1024 lanes (timed), five starts a row (the
    n-best form, timed), T = 1, 33 and 1401 frames, max_len below the counts and above
    T; the first row of each emits on every frame. Returns the timed cases."""
    timed = {}
    timed["r1024"] = check_backtrace("r=1024", *backtrace_case(rng, 16, 513, 1024, 1, device),
                                     513, 100)
    timed["nbest5"] = check_backtrace("n-best form", *backtrace_case(rng, 1, 513, 32, 5,
                                                                     device), 256, 200)
    for t_max in (1, 33, 1401):
        for starts in (1, 3):
            case = backtrace_case(rng, 4, t_max, 32, starts, device)
            for max_len in (max(1, t_max // 3), t_max + 7):
                check_backtrace("T={}".format(t_max), *case, max_len)
    print("phase E beam_backtrace edges: kernel == plain at T = 1, 33, 1401 (r=32, one and "
          "three starts a row, max_len below the counts and past T, rows emitting on every "
          "frame)")
    return timed


def phase_e(device, transcriber, batch, lm_directory, vocabulary, span_outputs):
    """Offline decoding on the card: K3 against its plain version in cases (a) to (c), K3
    with skipping off against the span kernel's no-LM beam, the router's skip route
    launching K3 once, the backtrace kernel against its plain version on K3's and on
    phase A's span outputs, and the plain batched beam (n-best over HTTP,
    lexicon-constrained batches, repeatability, the card against the CPU)."""
    import torch

    from speechless_tpu_torch.ops.beam_common import backtrace_tokens, beam_backtrace
    from speechless_tpu_torch.ops.decode_beam import beam_search_decode, beam_search_nbest
    from speechless_tpu_torch.ops.decode_lm import beam_search_decode_frames
    from speechless_tpu_torch.ops.decode_whole import beam_search_decode_whole, prefix_beam
    from speechless_tpu_torch.ops.device_beam import beam_search_decode_device
    from speechless_tpu_torch.serving import Transcriber, grouped_padded_batches
    from speechless_tpu_torch.serving_http import TranscriptionServer

    rng = np.random.default_rng(SEED + 5)
    blank = transcriber.blank_index
    classes = blank + 1
    # (a) the full-width model's posteriors of 16 x 8 s.
    _, wavs, lengths = next(grouped_padded_batches(batch, transcriber._bucket, 16))
    with torch.inference_mode():
        served, frames = transcriber._log_probs(wavs, lengths)
    served, frames = served.clone(), frames.clone()
    cases = {}
    cases["a"], full = check_prefix_beam("(a) served 16 x 8 s", served, frames, blank, 25,
                                         8, SKIP_BLANK, device, 20)
    # (b) every other frame blank-confident, ragged lengths from 1 to 513.
    ragged = np.concatenate([[1, 2], np.linspace(37, 513, 14).round()]).astype(np.int32)
    peaky, peaky_lengths = e_case(rng, 16, 513, classes, blank, ragged, confident_every=2)
    for skip, label in ((SKIP_BLANK, "b_skip"), (None, "b_exact")):
        cases[label], _ = check_prefix_beam("(b) peaky ragged", peaky, peaky_lengths, blank,
                                            25, 8, skip, device, 20)
    # (c) other widths: 32 to 1024 candidate lanes.
    for width in (4, 8, 16, 40):
        for k in ((3, 5, 8) if width != 40 else (8,)):
            log_probs, lens = e_case(rng, 5, 60, classes, blank, [60, 41, 17, 1, 60],
                                     confident_every=3)
            cases["c_{}_{}".format(width, k)], _ = check_prefix_beam(
                "(c)", log_probs, lens, blank, width, k, SKIP_BLANK if k != 5 else None,
                device, 50)
    lanes = sorted({case["n_pad"] for case in cases.values()})
    check(lanes[0] == 32 and lanes[-1] == 1024, "the K3 cases cover lanes {}".format(lanes))

    # K3 with skipping off is the span kernel's no-LM beam (JAX's claim for both no-LM
    # routes).
    options = dict(beam_width=25, max_decoded_length=served.shape[1], prune_classes=8)
    whole = beam_search_decode_whole(served, frames, blank, **options)
    loop = beam_search_decode_frames(served, frames, blank, **options)
    check(torch.equal(whole[0], loop[0]) and torch.equal(whole[1], loop[1]),
          "K3 without skipping and the span kernel's no-LM beam differ")

    # The router's skip route: one K3 launch, the plain version's tokens.
    prefix_beam.launches = 0
    tokens, counts = beam_search_decode_device(served, frames, blank,
                                               skip_blank_log_prob=SKIP_BLANK, **options)
    torch.cuda.synchronize()
    launches = prefix_beam.launches
    check(launches == 1, "the router's skip route launched K3 {} times".format(launches))
    parents, chars, pb, pnb, lens = full
    best = torch.logaddexp(pb, pnb).argmax(dim=1)
    plain = backtrace_tokens(parents, chars, best, lens.gather(1, best[:, None])[:, 0],
                             served.shape[1])
    check(torch.equal(tokens, plain[0]) and torch.equal(counts, plain[1]),
          "the router's skip route and the plain K3 give other tokens")
    backtraces = {"k3": check_backtrace("on K3 (a)", parents, chars, best,
                                        lens.gather(1, best[:, None])[:, 0],
                                        served.shape[1], 200)}
    carry, span_parents, span_chars, tail = span_outputs
    span_best = (torch.logaddexp(carry[0], carry[1]) + carry[5] + tail).argmax(dim=1)
    backtraces["span"] = check_backtrace(
        "on the span (word LM)", span_parents, span_chars, span_best,
        carry[4].gather(1, span_best[:, None])[:, 0], span_parents.shape[1], 200)
    backtraces.update(check_backtrace_edges(rng, device))
    # The no-LM routes end to end on (a) (synchronized host clock, mean of 3 after one).
    def wall_s(fn, runs=3):
        fn()
        torch.cuda.synchronize()
        start = time.perf_counter()
        for _ in range(runs):
            fn()
        torch.cuda.synchronize()
        return (time.perf_counter() - start) / runs

    routes = {
        "k3_skip_s": wall_s(lambda: beam_search_decode_whole(
            served, frames, blank, skip_blank_log_prob=SKIP_BLANK, **options)),
        "k3_exact_s": wall_s(lambda: beam_search_decode_whole(served, frames, blank,
                                                              **options)),
        "span_no_lm_s": wall_s(lambda: beam_search_decode_frames(served, frames, blank,
                                                                 **options)),
        "plain_beam_s": wall_s(lambda: beam_search_decode(served, frames, blank, **options),
                               runs=1)}
    print("phase E: K3 without skipping == the span kernel's no-LM beam ({} tokens); the "
          "router's skip route launched K3 {} time, tokens == the plain version's; no-LM "
          "decode of (a), wall per call: K3 {:.4f} s with skipping, {:.4f} s without, the "
          "span kernel {:.4f} s, the plain batched beam {:.4f} s".format(
              int(whole[1].sum()), launches, routes["k3_skip_s"], routes["k3_exact_s"],
              routes["span_no_lm_s"], routes["plain_beam_s"]))

    # The plain batched beam: n-best over HTTP, against a direct call; one backtrace
    # launch a request.
    audio = batch[0]
    want = transcriber.transcribe_nbest(audio, NBEST)
    server = TranscriptionServer(transcriber, port=0, max_batch=16, max_wait_ms=20.0)
    server.start()
    try:
        body = json.dumps({"pcm": audio.tolist(), "sample_rate": 16000}).encode()
        seconds = []
        beam_backtrace.launches = 0
        for _ in range(3):
            status, payload, elapsed = http_request(
                server.port, "/v1/transcribe?nbest={}".format(NBEST), body)
            seconds.append(elapsed)
        torch.cuda.synchronize()
        plain_launches = {"nbest_requests": beam_backtrace.launches}
    finally:
        server.stop()
    check(plain_launches["nbest_requests"] == 3, "3 ?nbest={} requests launched the "
          "backtrace {} times".format(NBEST, plain_launches["nbest_requests"]))
    check(status == 200, "?nbest={} answered {}".format(NBEST, status))
    check([(h["text"], h["score"]) for h in payload["hypotheses"]]
          == [(text, round(score, 4)) for text, score in want],
          "?nbest={} {} != direct {}".format(NBEST, payload["hypotheses"], want))
    check(len(want) > 1, "n-best returned {} hypotheses".format(len(want)))
    # A lexicon-constrained transcriber with the same LM: every completed word is in
    # the vocabulary, the trailing one a prefix of a vocabulary word.
    lexicon = Transcriber(transcriber.config, serving_params(transcriber.config),
                          transcriber.codec.allowed_characters, device=device,
                          kenlm_directory=lm_directory, lexicon_constrained=True)
    lexicon.transcribe_batch(batch[:2])
    torch.cuda.synchronize()
    beam_backtrace.launches = 0
    start = time.perf_counter()
    texts = lexicon.transcribe_batch(batch)
    lexicon_s = time.perf_counter() - start
    plain_launches["lexicon_batch"] = beam_backtrace.launches
    dispatches = len(list(grouped_padded_batches(batch, lexicon._bucket, 16)))
    check(plain_launches["lexicon_batch"] == dispatches, "the lexicon batch's {} "
          "dispatches launched the backtrace {} times".format(
              dispatches, plain_launches["lexicon_batch"]))
    words = [text.split(" ") for text, _ in texts]
    check(all(w in vocabulary for row in words for w in row[:-1] if w)
          and all(any(v.startswith(row[-1]) for v in vocabulary) for row in words),
          "a lexicon-constrained transcript left the vocabulary: {}".format(texts))
    check(any(len(row) > 1 for row in words), "no lexicon transcript completed a word")
    # Repeatability on the card, and the card against the CPU on the peaky batch.
    nbest_runs = [beam_search_nbest(served, frames, blank, NBEST,
                                    word_lm=transcriber.word_lm, lm_weight=0.8, **options)
                  for _ in range(2)]
    check(all(torch.equal(a, b) for a, b in zip(*nbest_runs)),
          "two runs of the plain beam on the card differ")
    lexicon_options = dict(beam_width=25, max_decoded_length=513, prune_classes=8,
                           lm_weight=0.8, lexicon_constrained=True)
    on_card = beam_search_decode(torch.from_numpy(peaky).to(device),
                                 torch.from_numpy(peaky_lengths).to(device), blank,
                                 word_lm=transcriber.word_lm, **lexicon_options)
    on_cpu = beam_search_decode(torch.from_numpy(peaky), torch.from_numpy(peaky_lengths),
                                blank, word_lm=transcriber.word_lm.to("cpu"),
                                **lexicon_options)
    check(all(torch.equal(a.cpu(), b) for a, b in zip(on_card, on_cpu)),
          "the plain beam's tokens on the card and on the CPU differ")
    # The n-best list of the served posteriors, card against CPU: tokens and counts
    # equal, scores within 1e-4 relative (PERF.md section 2).
    cpu_nbest = beam_search_nbest(served.cpu(), frames.cpu(), blank, NBEST,
                                  word_lm=transcriber.word_lm.to("cpu"), lm_weight=0.8,
                                  **options)
    check(all(torch.equal(a.cpu(), b) for a, b in zip(nbest_runs[0][:2], cpu_nbest[:2]))
          and torch.allclose(nbest_runs[0][2].cpu(), cpu_nbest[2], rtol=1e-4, atol=0.0),
          "the n-best lists on the card and on the CPU differ")
    numbers = {"nbest_request_s": sorted(seconds)[1], "lexicon_batch_s": lexicon_s,
               "plain_beam_launches": plain_launches}
    print("phase E plain beam: ?nbest={} answered 200 with the direct call's {} "
          "hypotheses (request {:.3f} s, median of 3); lexicon transcribe_batch 16 x 8 s "
          "{:.3f} s, every word in the LM's vocabulary ({} words); backtrace launches: {} "
          "(one a request, one a dispatch); n-best twice on the card bitwise equal and "
          "equal to the CPU's (tokens; scores within 1e-4); the lexicon beam on the peaky "
          "batch equal on card and CPU ({} tokens)".format(
              NBEST, len(want), numbers["nbest_request_s"], lexicon_s,
              sum(len(row) for row in words), plain_launches, int(on_cpu[1].sum())))
    numbers.update(routes, cases=cases, launches=launches, backtraces=backtraces)
    return numbers


# Phase F: the corpus sets `Configuration.english()` composes, as synthetic LibriSpeech
# trees: (utterances, seed). The hard tier's chapter field hashes each set's signature,
# so example ids stay unique across the composition.
FACADE_SETS = {"dev-clean": (48, 11), "dev-other": (8, 12), "train-clean-100": (8, 13),
               "train-clean-360": (8, 14), "train-other-500": (8, 15), "test-clean": (16, 16)}
FACADE_BATCH, FACADE_BATCHES, FACADE_EPOCHS = 16, 4, 2
# The fp32 facade epoch (2 updates) card vs CPU, parameter deltas, relative L2 per
# tensor. Adam moves every element by about lr whatever its gradient's size, so an
# element whose gradient changes sign under fp32 rounding (a ReLU input within rounding
# of zero upstream) moves by 2 lr more on one side: the two packages' full-width parity
# test on the CPU (tests/test_torch_system.py) sees about 0.1 after 2 updates, and this
# epoch the card and the CPU differ by 0.0935 (NVIDIA H100 80GB HBM3, 700 W). Phase C's 1e-2 (one update on 2 s tones) does not hold here; this limit
# catches a wrong rate, optimizer or batch (relative L2 near 1 or more), and phase C's
# check keeps telling fp32 from TF32.
FACADE_DELTA_RTOL = 0.25


def stage_facade_corpora(data: Path) -> None:
    from speechless_tpu_torch.data.synthetic import generate_corpus

    for name, (count, seed) in FACADE_SETS.items():
        generate_corpus(data / "corpus" / "English", name, utterance_count=count,
                        speaker_count=4, min_duration_s=2.0, max_duration_s=6.0, seed=seed,
                        difficulty="hard")


def facade_fp32_epoch(data: Path, device) -> dict:
    """One facade epoch in fp32 (2 batches of 2) on the card and on the CPU from the same
    weights and the same batches: the epoch loss within phase C's 1e-5 and the
    parameter deltas within `FACADE_DELTA_RTOL`."""
    import random

    import torch

    from speechless_tpu_torch.configuration import Configuration, DataDirectories
    from speechless_tpu_torch.system import Wav2Letter
    from speechless_tpu_torch.text.charsets import english_frequent_characters as alphabet
    from speechless_tpu_torch.train import checkpoint

    config = Configuration.english(DataDirectories(data))
    config.batch_size, config.training_batches_per_epoch = 2, 2
    nets = config.directories.nets_base_directory
    Wav2Letter(128, alphabet, seed=SEED + 5, device="cpu").save(nets / "fp32-base", 0)
    losses, deltas = {}, {}
    base = checkpoint.load_params(nets / "fp32-base", 0)
    for where in ("cpu", device):
        facade = Wav2Letter(128, alphabet, load_model_from_directory=nets / "fp32-base",
                            load_epoch=0, compute_dtype=torch.float32, device=where)
        run = "fp32-{}".format(torch.device(where).type)
        random.seed(SEED + 5)
        config.train(facade, run_name=run, epoch_limit=1, callback_step=2)
        scalars = (config.directories.tensorboard_log_base_directory / run /
                   "scalars.csv").read_text().strip().splitlines()
        losses[where] = float(scalars[-1].split(",")[2])
        deltas[where] = [{k: layer[k] - start[k] for k in ("w", "b")}
                         for layer, start in zip(facade.params, base)]
    loss_err = abs(losses[device] - losses["cpu"]) / abs(losses["cpu"])
    delta_err = max(float(np.linalg.norm(g[k] - c[k]) / np.linalg.norm(c[k]))
                    for g, c in zip(deltas[device], deltas["cpu"]) for k in ("w", "b")
                    if np.linalg.norm(c[k]) > 0)
    print("phase F fp32 facade epoch (2 batches of 2) card vs CPU: loss {:.6f} vs {:.6f}, "
          "rel {:.3g}; parameter-delta rel L2 {:.3g} (limits {} and {})".format(
              losses[device], losses["cpu"], loss_err, delta_err, FP32_LOSS_RTOL,
              FACADE_DELTA_RTOL), flush=True)
    check(loss_err <= FP32_LOSS_RTOL and delta_err <= FACADE_DELTA_RTOL,
          "the fp32 facade epoch on the card differs from the CPU: loss {:.3g}, deltas "
          "{:.3g}".format(loss_err, delta_err))
    return {"loss_rel": loss_err, "delta_rel_l2": delta_err}


def run_cli(numbers: dict, phase: str, device, name: str, *arguments, key=None):
    """One CLI command in process (`speechless_tpu_torch.__main__.main`) with the CTC
    kernels' launch counters set to 0 just before it: records its wall under
    ``numbers["commands_s"]`` and the launches of K1 and the fused backward under
    ``numbers["launches"]``; returns the launches."""
    import torch

    from speechless_tpu_torch.__main__ import main as cli
    from speechless_tpu_torch.ops import ctc_kernels

    key = key or name
    ctc_kernels.ctc_alpha.launches = ctc_kernels.ctc_beta_grad.launches = 0
    start = time.perf_counter()
    cli([name, *arguments, "--device", str(device)])
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()
    numbers["commands_s"][key] = time.perf_counter() - start
    numbers["launches"][key] = (ctc_kernels.ctc_alpha.launches,
                                ctc_kernels.ctc_beta_grad.launches)
    print("phase {} {}: {:.3f} s, ctc_alpha/ctc_beta_grad launches {}/{}".format(
        phase, key, numbers["commands_s"][key], *numbers["launches"][key]), flush=True)
    return numbers["launches"][key]


def phase_f(device, card: str, train: Optional[dict], data: Path) -> dict:
    """The facade on the card: the CLI's summarize, fill-cache, train, test (greedy and
    --kenlm) and validate in process over synthetic corpora staged under ``data``, with
    the CTC kernels' launches counted per command; the port's Transcriber on the trained
    checkpoint; one fp32 facade epoch card vs CPU. Leaves the corpora and the run under
    ``data`` for phase G."""
    import logging

    from speechless_tpu_torch import system
    from speechless_tpu_torch.configuration import Configuration, DataDirectories
    from speechless_tpu_torch.features.audio_io import load_audio
    from speechless_tpu_torch.lm.arpa_builder import build_kenlm_directory
    from speechless_tpu_torch.serving import Transcriber
    from speechless_tpu_torch.text.charsets import english_frequent_characters as alphabet

    results, beam_wall = [], [0.0]
    record = system.Wav2Letter.test_and_predict_grouped_batches
    beam = system.beam_search_decode

    def recording(self, grouped):
        results.append(record(self, grouped))
        return results[-1]

    def timed_beam(*args, **kwargs):
        start = time.perf_counter()
        try:
            return beam(*args, **kwargs)
        finally:
            beam_wall[0] += time.perf_counter() - start

    system.Wav2Letter.test_and_predict_grouped_batches = recording
    system.beam_search_decode = timed_beam
    logging.getLogger("results").setLevel(logging.WARNING)  # the CLI's per-batch logs
    numbers = {"commands_s": {}, "launches": {}}
    try:
        start = time.perf_counter()
        stage_facade_corpora(data)
        numbers["staging_s"] = time.perf_counter() - start
        common = ["--config", "english", "--data-dir", str(data),
                  "--batch-size", str(FACADE_BATCH)]

        def command(name, *arguments):
            return run_cli(numbers, "F", device, name, *common, *arguments,
                           key=name + (" --kenlm" if "--kenlm" in arguments else ""))

        command("summarize")
        check((data / "corpus" / "English" / "corpus.csv").exists(), "no corpus.csv")
        command("fill-cache")
        cache = data / "spectrogram-cache" / "English"
        entries = len(list(cache.glob("*.npy")))
        check(entries == sum(count for count, _ in FACADE_SETS.values()),
              "the cache holds {} entries".format(entries))
        alpha, backward = command("train", "--batches-per-epoch", str(FACADE_BATCHES),
                                  "--epochs", str(FACADE_EPOCHS))
        steps = FACADE_BATCHES * FACADE_EPOCHS
        previews = FACADE_EPOCHS + 1  # one before training, one after each epoch
        check(backward == steps, "fused CTC backward launches in {} train steps: {}"
              .format(steps, backward))
        check(alpha == steps + previews, "K1 launches in {} train steps and {} preview "
              "batches: {}".format(steps, previews, alpha))
        (run,) = [d.name for d in (data / "nets").iterdir()]
        nets = data / "nets" / run
        check((nets / "weights-epoch1.npz").exists() and
              (nets / "weights-epoch2.npz").exists(), "missing epoch checkpoints")
        rows = (data / "logs" / run / "scalars.csv").read_text().strip().splitlines()[1:]
        check(len(rows) == FACADE_EPOCHS, "scalars.csv has {} rows".format(len(rows)))
        scalars = [[float(v) for v in row.split(",")] for row in rows]
        check(all(np.isfinite(row[2]) for row in scalars), "non-finite epoch loss")
        numbers["scalars"], numbers["run"] = scalars, run

        configuration = Configuration.english(DataDirectories(data))
        build_kenlm_directory([e.label for e in configuration.corpus.training_examples],
                              data / "kenlm" / "english", allowed_characters=alphabet,
                              order=3)
        test_batches = -(-FACADE_SETS["test-clean"][0] // FACADE_BATCH)
        for decoder in ([], ["--kenlm"]):
            beam_wall[0] = 0.0
            alpha, backward = command("test", *decoder, "--run", run, "--epoch",
                                      str(FACADE_EPOCHS))
            check((alpha, backward) == (test_batches, 0),
                  "K1/backward launches in {} eval batches: {}/{}".format(
                      test_batches, alpha, backward))
            result = results[-1]
            check(len(result.results) == FACADE_SETS["test-clean"][0],
                  "evaluated {} test utterances".format(len(result.results)))
            numbers["kenlm" if decoder else "greedy"] = {
                "ler": result.average_letter_error_rate,
                "wer": result.average_word_error_rate, "loss": result.average_loss,
                "groups": {name: len(batches.results) for name, batches in
                           result.result_batches_by_group_name.items()},
                "beam_wall_s": beam_wall[0]}
        check(np.isfinite(numbers["greedy"]["loss"]), "non-finite test loss")
        check(numbers["kenlm"]["beam_wall_s"] > 0, "the LM test ran no host beam")
        sweep = data / "sweep.csv"
        alpha, _ = command("validate", "--run", run, "--csv", str(sweep))
        lines = sweep.read_text().strip().splitlines()
        check(len(lines) == 1 + FACADE_EPOCHS and alpha == FACADE_EPOCHS * test_batches,
              "validate: {} lines, {} K1 launches".format(len(lines), alpha))

        start = time.perf_counter()
        transcriber = Transcriber.from_checkpoint(nets, FACADE_EPOCHS, alphabet,
                                                  device=device)
        audios = [load_audio(e.audio_file)
                  for e in configuration.corpus.test_examples[:4]]
        texts = transcriber.transcribe_batch(audios)
        check(len(texts) == 4 and all(isinstance(text, str) for text, _ in texts),
              "the Transcriber on the trained checkpoint: {}".format(texts))
        numbers["transcripts"] = [text for text, _ in texts]
        numbers["commands_s"]["transcriber"] = time.perf_counter() - start
        start = time.perf_counter()
        numbers["fp32"] = facade_fp32_epoch(data, device)
        numbers["commands_s"]["fp32 epoch card and CPU"] = time.perf_counter() - start
    finally:
        system.Wav2Letter.test_and_predict_grouped_batches = record
        system.beam_search_decode = beam
        logging.getLogger("results").setLevel(logging.INFO)

    print(card)
    print("phase F facade (CLI in process; synthetic LibriSpeech sets, hard tier, 2-6 s; {} "
          "training, {} test utterances; staged in {:.2f} s): command walls (s) {}".format(
              sum(c for name, (c, _) in FACADE_SETS.items() if name != "test-clean"),
              FACADE_SETS["test-clean"][0], numbers["staging_s"],
              {k: round(v, 3) for k, v in numbers["commands_s"].items()}))
    print("phase F cache fill: {} entries in {:.3f} s".format(
        sum(c for c, _ in FACADE_SETS.values()), numbers["commands_s"]["fill-cache"]))
    for row in numbers["scalars"]:
        print("phase F train epoch {:.0f} (step {:.0f}): loss {:.4f}, {:.2f} utterances/s, "
              "{:.4f} s per batch (B={}, bf16) beside phase C's make_multi_wav_step "
              "{} utterances/s at B={}".format(
                  *row, FACADE_BATCH, "{:.1f}".format(train["utterances_per_s"])
                  if train else "(not run)", BENCH_BATCH))
    for name in ("greedy", "kenlm"):
        print("phase F test {}: LER {:.4f}, WER {:.4f}, loss {:.3f} over {}; host beam wall "
              "{:.3f} s".format(name, numbers[name]["ler"], numbers[name]["wer"],
                                numbers[name]["loss"], numbers[name]["groups"],
                                numbers[name]["beam_wall_s"]))
    print("phase F launches (ctc_alpha, ctc_beta_grad) per command: {}".format(
        numbers["launches"]))
    print("phase F Transcriber on the epoch-{} checkpoint: {}".format(
        FACADE_EPOCHS, numbers["transcripts"][:2]))
    return numbers


# ---- phase I: ASG, the raw-wave model and the activations ----------------------------
ASG_FRAMES = 513               # phase C's logit frames at the bench batch
ASG_RTOL = 1e-5                # ASG loss card vs CPU, relative
# ASG gradients card vs CPU, times max(1, |value|). At the bench shape the path scores
# reach ~1e3, where one fp32 ulp is ~6e-5, so the fp32 gradients themselves sit ~1e-3
# from an fp64 evaluation of the same inputs (printed beside the check): 1e-5 is the
# tier-1 limit at T <= 40, and no fp32 evaluation order can meet it here.
ASG_GRAD_TOL = 1e-3
ASG_EPOCHS, RAW_EPOCHS = 2, 1  # the facade's ASG run and each raw-wave run
# One fp32 ASG step card vs CPU: parameter changes, relative L2 per tensor. Adam's
# first step moves every element by lr times the sign of its gradient, and on an H100
# (700 W) the ASG gradients' fp32 rounding flipped the sign of one bias in a conv of 250
# (0.127 = 2 / sqrt(250) for one flip: inner convs 2 and 3 on this phase's draw, the
# first conv on another): phase F's limit for that effect holds here. The gradients
# themselves (Adam's first moments) keep phase C's `FP32_GRAD_RTOL` (1.97e-3 in fp32,
# 5.69e-2 with TF32 forced on, whose changes reach 0.364).
ASG_DELTA_RTOL = FACADE_DELTA_RTOL


def asg_labels(rng, codec, rows: int, length: int) -> np.ndarray:
    """``(rows, length)`` graphemes of random English text coded by ``codec`` (repeats
    become its twice/thrice graphemes; longer runs, which ASG cannot code, are cut to
    three), each row cut to ``length``."""
    alphabet = codec.allowed_characters
    out = np.empty((rows, length), np.int32)
    for row in range(rows):
        encoded = []
        while len(encoded) < length:
            text = "".join(alphabet[i] for i in rng.integers(0, len(alphabet), 2 * length))
            encoded = codec.encode(re.sub(r"(.)\1{3,}", r"\1\1\1", text).strip() or "a")
        out[row] = encoded[:length]
    return out


def asg_bench_case(rng, codec, device):
    """ASG at the bench shape: (64, 513, C) log-probs, 192-grapheme labels, seeded
    lengths and the edge rows: an empty label, U = T' (96 of each), U > T' (192 labels,
    96 frames) and one frame with one label."""
    import torch

    classes = codec.grapheme_set_size
    log_probs = torch.log_softmax(torch.tensor(
        rng.normal(size=(BENCH_BATCH, ASG_FRAMES, classes)) * 2.0, dtype=torch.float32), -1)
    lengths = rng.integers(ASG_FRAMES // 2, ASG_FRAMES + 1, BENCH_BATCH).astype(np.int32)
    label_lengths = np.minimum(BENCH_LABELS, lengths).astype(np.int32)
    labels = asg_labels(rng, codec, BENCH_BATCH, BENCH_LABELS)
    half = BENCH_LABELS // 2
    lengths[:4] = (ASG_FRAMES // 2, half, half, 1)
    label_lengths[:4] = (0, half, BENCH_LABELS, 1)
    labels[np.arange(BENCH_LABELS)[None] >= label_lengths[:, None]] = -1
    trans, init = (torch.from_numpy(t) for t in asg_tables(classes))
    return [t.to(device) for t in (log_probs, torch.from_numpy(lengths),
                                   torch.from_numpy(labels), torch.from_numpy(label_lengths),
                                   trans, init)]


def asg_tables(classes: int):
    from speechless_tpu_torch.ops import asg

    return asg.log_score_tables(asg.default_asg_transition_probabilities(classes),
                                asg.default_asg_initial_probabilities(classes))


def check_asg_bench(rng, codec, device) -> dict:
    """`asg_loss` (forward and backward) and `asg_viterbi_decode` on the card against
    the same calls on the CPU at the bench shape, and their device times."""
    import torch

    from speechless_tpu_torch.ops import asg

    case = asg_bench_case(rng, codec, device)

    def forward_backward(where, dtype=torch.float32):
        emissions, lengths, labels, label_lengths, trans, init = (
            t.to(where) for t in case)
        leaves = [t.to(dtype).clone().requires_grad_() for t in (emissions, trans, init)]
        loss = asg.asg_loss(leaves[0], lengths, labels, label_lengths,
                            transition_log_scores=leaves[1], initial_log_scores=leaves[2])
        loss.sum().backward()
        return loss.detach().cpu().double(), [leaf.grad.cpu().double() for leaf in leaves]

    def errors(got, want):
        loss, grads = got
        return (float(((loss - want[0]).abs() / want[0].abs().clamp(min=1e-30)).max()),
                max(float(((g - w).abs() / w.abs().clamp(min=1.0)).max())
                    for g, w in zip(grads, want[1])))

    cpu = forward_backward("cpu")
    card = forward_backward(device)
    exact = forward_backward(device, torch.float64)
    card_loss = card[0]
    loss_err, grad_err = errors(card, cpu)
    check(bool((card_loss[[0, 2]] == 0).all()) and bool(torch.isfinite(card_loss).all()),
          "ASG: the empty and U > T' rows must score 0: {}".format(card_loss[:4]))
    check(loss_err <= ASG_RTOL and grad_err <= ASG_GRAD_TOL,
          "ASG card vs CPU: loss rel {:.3g}, gradients {:.3g}".format(loss_err, grad_err))
    emissions, lengths, _, _, trans, init = case
    cpu_path = asg.asg_viterbi_decode(*(t.cpu() for t in (emissions, lengths, trans, init)))
    card_path = asg.asg_viterbi_decode(emissions, lengths, trans, init).cpu()
    check(torch.equal(card_path, cpu_path), "ASG Viterbi paths differ card vs CPU in {} "
          "entries".format(int((card_path != cpu_path).sum())))

    leaves = [t.clone().requires_grad_() for t in (case[0], case[4], case[5])]

    def fwd():
        with torch.no_grad():
            asg.asg_loss(case[0], case[1], case[2], case[3], transition_log_scores=case[4],
                         initial_log_scores=case[5])

    def fwd_bwd():
        asg.asg_loss(leaves[0], case[1], case[2], case[3], transition_log_scores=leaves[1],
                     initial_log_scores=leaves[2]).sum().backward()

    numbers = {"loss_rel": loss_err, "grad_err": grad_err,
               "fp64_card": errors(card, exact), "fp64_cpu": errors(cpu, exact),
               "forward_ms": cuda_ms(fwd, 3), "forward_backward_ms": cuda_ms(fwd_bwd, 3),
               "viterbi_ms": cuda_ms(lambda: asg.asg_viterbi_decode(
                   emissions, lengths, trans, init), 3)}
    numbers["backward_ms"] = numbers["forward_backward_ms"] - numbers["forward_ms"]
    return numbers


@contextlib.contextmanager
def tf32_forced():
    """The port's `ieee_fp32` hooks (trainer, model, features, CTC) replaced by one that
    turns TF32 on: the control that an fp32 check must fail."""
    import torch

    from speechless_tpu_torch.features import spectrogram
    from speechless_tpu_torch.models import wav2letter as w2l
    from speechless_tpu_torch.ops import ctc
    from speechless_tpu_torch.train import trainer

    @contextlib.contextmanager
    def tf32_on():
        saved = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
        torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = True
        try:
            yield
        finally:
            torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved

    patched = [(module, module.ieee_fp32) for module in (trainer, w2l, spectrogram, ctc)]
    for module, _ in patched:
        module.ieee_fp32 = tf32_on
    try:
        yield
    finally:
        for module, original in patched:
            module.ieee_fp32 = original


def fp32_step_card_vs_cpu(where: str, device, config, params, batch, criterion: str,
                          make_step, delta_rtol: float = FP32_DELTA_RTOL) -> dict:
    """One fp32 update by ``make_step`` (`trainer.make_multi_wav_step` for a `WavBatch`,
    `make_multi_step` for a `Batch`) on the card and on the CPU from the same weights,
    then the same update on the card with TF32 forced on (`tf32_forced`). Each card
    step against the CPU's: the loss's relative difference, and the largest relative L2
    difference of a tensor's gradient (Adam's first moment after one step is 0.1 times
    it) and of a tensor's change (the ASG tables included). The fp32 step must stay
    within `FP32_LOSS_RTOL`, `FP32_GRAD_RTOL` and ``delta_rtol``; the TF32 step must
    exceed one of them."""
    from speechless_tpu_torch.train import trainer

    def one_step(on):
        optimizer = trainer.make_optimizer(1e-4)
        state = trainer.init_train_state(config, optimizer, params=params, device=on)
        state, metrics = make_step(config, optimizer, criterion, device=on)(state, batch)
        leaves = state.opt_state.leaves()
        moments = (len(leaves) - 1) // 2
        return float(metrics["loss"]), state.params, leaves[1:1 + moments]

    def rel(got, want):
        return float(np.linalg.norm(got - want) / np.linalg.norm(want))

    cpu_loss, cpu_params, cpu_mu = one_step("cpu")
    readings = {}
    for name in ("fp32", "tf32"):
        with tf32_forced() if name == "tf32" else contextlib.nullcontext():
            card_loss, card_params, card_mu = one_step(device)
        deltas = {(i, k): rel(g[k] - p[k], c[k] - p[k])
                  for i, (c, g, p) in enumerate(zip(cpu_params, card_params, params))
                  for k in p if np.linalg.norm(c[k] - p[k]) > 0}
        readings[name] = {
            "loss_rel": abs(card_loss - cpu_loss) / abs(cpu_loss),
            "grad_rel_l2": max(rel(g, c) for g, c in zip(card_mu, cpu_mu)
                               if np.linalg.norm(c) > 0),
            "delta_rel_l2": max(deltas.values()),
            "worst": sorted(deltas.items(), key=lambda e: -e[1])[:3]}

    def within(r):
        return (r["loss_rel"] <= FP32_LOSS_RTOL and r["grad_rel_l2"] <= FP32_GRAD_RTOL
                and r["delta_rel_l2"] <= delta_rtol)

    for name, r in readings.items():
        print("{} one {} step on 2 x 2 s, card vs CPU, {}: loss rel {:.3g}, gradients rel "
              "L2 {:.3g}, parameter changes rel L2 {:.3g}; largest changes (layer, key): {} "
              "(limits {}, {} and {})".format(
                  where, criterion, "fp32" if name == "fp32" else "TF32 forced on",
                  r["loss_rel"], r["grad_rel_l2"], r["delta_rel_l2"],
                  [(key, round(v, 4)) for key, v in r["worst"]], FP32_LOSS_RTOL,
                  FP32_GRAD_RTOL, delta_rtol), flush=True)
    check(within(readings["fp32"]), "{}: the fp32 {} step on the card differs from the "
          "CPU's".format(where, criterion))
    check(not within(readings["tf32"]), "{}: the TF32 {} step passes the fp32 limits: they "
          "cannot tell them apart".format(where, criterion))
    return readings


def two_second_tones(rng) -> np.ndarray:
    """phase C's precision waves: (1, 2, 32,000) tones with noise, one step."""
    t = np.arange(32000) / 16000.0
    return np.stack([0.3 * np.sin(2 * np.pi * f * t) + 0.05 * rng.normal(size=t.size)
                     for f in (440.0, 1234.0)]).astype(np.float32)[None]


def two_second_wavs(rng, labels):
    """A one-step `WavBatch` of `two_second_tones` with the (2, U) ``labels``."""
    from speechless_tpu_torch.train import trainer

    return trainer.WavBatch(two_second_tones(rng), np.full((1, 2), 32000, np.int32),
                            labels[None], np.full((1, 2), labels.shape[1], np.int32))


def timed_calls(multi_step, state, batch, calls: int):
    """One warm-up call, then ``calls`` timed ones (synchronized host clock): returns
    the state, the first step's loss, the last call's step losses and ms per step."""
    import torch

    state, metrics = multi_step(state, batch)
    first = metrics["step_losses"].tolist()
    torch.cuda.synchronize()
    start = time.perf_counter()
    for _ in range(calls):
        state, metrics = multi_step(state, batch)
    torch.cuda.synchronize()
    steps = calls * BENCH_STEPS
    last = metrics["step_losses"].cpu().numpy()
    check(np.isfinite(first).all() and np.isfinite(last).all(), "non-finite step loss")
    check(float(last.mean()) < first[0], "the last call's mean loss {} is not below the "
          "first step's {}".format(float(last.mean()), first[0]))
    return state, first[0], float(last.mean()), (time.perf_counter() - start) / steps * 1e3


def asg_training(rng, codec, device) -> dict:
    """`make_multi_step` with ``asg_trainable`` at full width in bf16 on the bench batch's
    features (k=10): losses finite and falling, the tables changed; then one fp32 step
    on 2 x 2 s card vs CPU."""
    import torch

    from speechless_tpu_torch.features.spectrogram import features_batch
    from speechless_tpu_torch.models import wav2letter as w2l
    from speechless_tpu_torch.train import trainer

    classes = codec.grapheme_set_size
    trans, init = asg_tables(classes)
    tables = {"asg_transitions": trans, "asg_initials": init}
    config = w2l.Wav2LetterConfig(128, classes, compute_dtype=torch.bfloat16)
    params = w2l.init_params(config, SEED + 9) + [tables]
    optimizer = trainer.make_optimizer(1e-4)
    state = trainer.init_train_state(config, optimizer, params=params, device=device)
    wavs = torch.tensor(rng.normal(size=(BENCH_BATCH, BENCH_SAMPLES)) * 0.1,
                        dtype=torch.float32, device=device)
    features, frames = features_batch(wavs, torch.full((BENCH_BATCH,), BENCH_SAMPLES,
                                                       dtype=torch.int32, device=device))
    labels = torch.from_numpy(asg_labels(rng, codec, BENCH_BATCH, BENCH_LABELS)).to(device)
    stack = lambda t: t.expand(BENCH_STEPS, *t.shape)
    batch = trainer.Batch(stack(features), stack(frames), stack(labels),
                          stack(torch.full((BENCH_BATCH,), BENCH_LABELS, dtype=torch.int32,
                                           device=device)))
    multi_step = trainer.make_multi_step(config, optimizer, "asg_trainable", device=device)
    state, first, last, ms = timed_calls(multi_step, state, batch, calls=1)
    moved = [float(np.abs(state.params[-1][k] - tables[k]).max()) for k in sorted(tables)]
    check(min(moved) > 0, "the ASG tables did not change: {}".format(moved))

    fp32 = w2l.Wav2LetterConfig(128, classes)
    small = asg_labels(rng, codec, 2, 24)
    precision = fp32_step_card_vs_cpu("phase I ASG", device, fp32,
                                      w2l.init_params(fp32, SEED + 10) + [tables],
                                      two_second_wavs(rng, small), "asg_trainable",
                                      trainer.make_multi_wav_step,
                                      delta_rtol=ASG_DELTA_RTOL)
    return {"ms_per_step": ms, "first_step_loss": first, "last_call_mean_loss": last,
            "table_change": moved, "fp32": precision}


def raw_wave_training(rng, device) -> dict:
    """`make_multi_step` on the raw-wave model at full width in bf16 on (64, 131,072, 1)
    z-normalized waves (`bench.py`'s batch as waveforms, k=10), K1 and the fused backward
    counted; then K1 and the fused backward held against their plain versions on the
    log-probs the trained model gives that batch (`compare_ctc_kernels`), one fp32 step
    on 2 x 2 s card vs CPU with its TF32 control, and an elu forward card vs CPU."""
    import torch

    from speechless_tpu_torch.models import wav2letter as w2l
    from speechless_tpu_torch.ops import ctc_kernels
    from speechless_tpu_torch.train import trainer

    config = w2l.Wav2LetterConfig(1, 29, compute_dtype=torch.bfloat16,
                                  use_raw_wave_input=True)
    optimizer = trainer.make_optimizer(1e-4)
    state = trainer.init_train_state(config, optimizer, params=w2l.init_params(config, SEED + 11),
                                     device=device)
    waves = torch.tensor(rng.normal(size=(BENCH_BATCH, BENCH_SAMPLES)), dtype=torch.float32,
                         device=device)
    waves = ((waves - waves.mean(1, keepdim=True)) / waves.std(1, keepdim=True))[..., None]
    labels = torch.tensor(rng.integers(0, 28, (BENCH_BATCH, BENCH_LABELS)), dtype=torch.int32,
                          device=device)
    full = lambda value: torch.full((BENCH_STEPS, BENCH_BATCH), value, dtype=torch.int32,
                                    device=device)
    stack = lambda t: t.expand(BENCH_STEPS, *t.shape)
    batch = trainer.Batch(stack(waves), full(BENCH_SAMPLES), stack(labels), full(BENCH_LABELS))
    multi_step = trainer.make_multi_step(config, optimizer, device=device)
    calls = 1
    ctc_kernels.ctc_alpha.launches = ctc_kernels.ctc_beta_grad.launches = 0
    state, first, last, ms = timed_calls(multi_step, state, batch, calls)
    launches = {"ctc_alpha": ctc_kernels.ctc_alpha.launches,
                "ctc_beta_grad": ctc_kernels.ctc_beta_grad.launches}
    steps = (calls + 1) * BENCH_STEPS
    check(launches == {"ctc_alpha": steps, "ctc_beta_grad": steps},
          "CTC kernel launches in {} raw-wave steps: {}".format(steps, launches))
    utterances_per_s = BENCH_BATCH / ms * 1e3
    mfu = w2l.conv_flops_per_example(config, BENCH_SAMPLES) * utterances_per_s \
        / BF16_FLOPS_PER_S

    # The kernels at this path's shape, on the log-probs the trained model gives the
    # batch, as the train step forms them (`loss_fn`); these launches are not counted.
    with torch.no_grad():
        log_probs = torch.log_softmax(state.model(waves, train=True,
                                                  generator=state.generator), -1)
    lengths = w2l.prediction_lengths(config, batch.input_lengths[0]).to(torch.int32)
    label_lengths = batch.label_lengths[0]
    repeats = ((labels[:, 1:] == labels[:, :-1]) & (labels[:, 1:] >= 0)).sum(1)
    feasible = ((label_lengths + repeats <= lengths) & (lengths > 0)).cpu().numpy()
    kernels, _, _ = compare_ctc_kernels("phase I raw-wave", log_probs.contiguous(), lengths,
                                        labels, label_lengths, feasible)

    fp32 = w2l.Wav2LetterConfig(1, 29, use_raw_wave_input=True)
    tones = two_second_wavs(rng, rng.integers(0, 28, (2, 24)).astype(np.int32))
    normalized = (tones.wavs - tones.wavs.mean(-1, keepdims=True)) \
        / tones.wavs.std(-1, keepdims=True)
    precision = fp32_step_card_vs_cpu(
        "phase I raw-wave", device, fp32, w2l.init_params(fp32, SEED + 12),
        trainer.Batch(normalized[..., None], *tones[1:]), "ctc", trainer.make_multi_step)
    elu = w2l.Wav2LetterConfig(1, 29, use_raw_wave_input=True, activation="elu")
    elu_params = w2l.init_params(elu, SEED + 13)
    inputs = torch.tensor(rng.normal(size=(2, 32000, 1)), dtype=torch.float32)
    with torch.no_grad():
        cpu = torch.log_softmax(w2l.build_model(elu, elu_params, device="cpu")(inputs), -1)
        card = torch.log_softmax(w2l.build_model(elu, elu_params, device=device)(
            inputs.to(device)), -1).cpu()
    elu_err = float((card - cpu).abs().max())
    check(elu_err <= FP32_TOLERANCE, "elu forward card vs CPU: {:.3g}".format(elu_err))
    return {"ms_per_step": ms, "utterances_per_s": utterances_per_s, "mfu": mfu,
            "first_step_loss": first, "last_call_mean_loss": last, "launches": launches,
            "kernels": kernels, "fp32": precision, "elu_err": elu_err,
            "logits": tuple(log_probs.shape)}


def facade_variant(data: Path, device, epochs: int, **options) -> dict:
    """`Configuration.english().train_from_beginning` with the model options in
    ``options`` (``device_resident`` goes to the training loop) over phase F's corpora,
    B=16, 4 batches an epoch; then the grouped test of the last epoch. Returns the run,
    its walls, the CTC kernels' launches in training, and the test's LER/WER."""
    import torch

    from speechless_tpu_torch.configuration import Configuration, DataDirectories
    from speechless_tpu_torch.ops import ctc_kernels

    configuration = Configuration.english(DataDirectories(data))
    configuration.batch_size = FACADE_BATCH
    configuration.training_batches_per_epoch = FACADE_BATCHES
    resident = options.pop("device_resident", False)
    nets = data / "nets"
    before = set(nets.iterdir()) if nets.exists() else set()
    ctc_kernels.ctc_alpha.launches = ctc_kernels.ctc_beta_grad.launches = 0
    start = time.perf_counter()
    configuration.train_from_beginning(epoch_limit=epochs, device_resident=resident,
                                       wav2letter_kwargs=dict(options, device=device))
    torch.cuda.synchronize()
    train_s = time.perf_counter() - start
    launches = (ctc_kernels.ctc_alpha.launches, ctc_kernels.ctc_beta_grad.launches)
    (run,) = [path.name for path in set(nets.iterdir()) - before]
    start = time.perf_counter()
    result = configuration.test_model_grouped_by_loaded_corpus_name(configuration.load_model(
        run, epochs, allowed_characters_for_loaded_model=None, device=device, **options))
    loss = result.average_loss
    check(np.isfinite(loss), "non-finite test loss in {}".format(run))
    return {"run": run, "train_s": train_s, "test_s": time.perf_counter() - start,
            "launches": launches, "ler": result.average_letter_error_rate,
            "wer": result.average_word_error_rate, "loss": loss}


def phase_i(device, card: str, train: Optional[dict], data: Path) -> dict:
    """ASG, the raw-wave model and the activations on the card, after phase F and in its
    data directory: the ASG loss and Viterbi at the bench shape card vs CPU and their
    times, ASG training with trainable tables, the raw-wave model's training with the
    CTC kernels counted, fp32 steps and an elu forward card vs CPU, and the facade's ASG
    and raw-wave runs (host and resident) with their test LER/WER."""
    import logging

    from speechless_tpu_torch.text.charsets import english_frequent_characters as alphabet
    from speechless_tpu_torch.text.graphemes import AsgGraphemeCodec

    start = time.perf_counter()
    rng = np.random.default_rng(SEED + 8)
    codec = AsgGraphemeCodec(alphabet)
    print(card)
    numbers = {"asg": check_asg_bench(rng, codec, device)}
    asg = numbers["asg"]
    print("phase I ASG at (64, {}, {}) log-probs, 192-grapheme labels (AsgGraphemeCodec) "
          "with an empty, a U = T' and a U > T' row, card vs CPU: loss rel {:.3g} (limit "
          "{}), gradients {:.3g} (limit {} x max(1, |g|)); against fp64 on the card: card "
          "{:.3g} / {:.3g}, CPU {:.3g} / {:.3g}; Viterbi paths equal; device ms: forward "
          "{:.2f}, backward {:.2f}, Viterbi {:.2f}".format(
              ASG_FRAMES, codec.grapheme_set_size, asg["loss_rel"], ASG_RTOL,
              asg["grad_err"], ASG_GRAD_TOL, *asg["fp64_card"], *asg["fp64_cpu"],
              asg["forward_ms"], asg["backward_ms"], asg["viterbi_ms"]), flush=True)
    numbers["asg_training"] = trained = asg_training(rng, codec, device)
    print("phase I ASG training (asg_trainable, make_multi_step, bf16, B={} x 1025 frames, "
          "{} graphemes, k={}): {:.2f} ms per step beside phase C's CTC step {}; loss {:.2f} "
          "(first step) -> {:.2f} (last call's mean); largest table change {} (fp32 "
          "step card vs CPU above)".format(
              BENCH_BATCH, BENCH_LABELS, BENCH_STEPS, trained["ms_per_step"],
              "{:.2f} ms".format(train["ms_per_step"]) if train else "(not run)",
              trained["first_step_loss"], trained["last_call_mean_loss"],
              trained["table_change"]), flush=True)
    numbers["raw_wave"] = raw = raw_wave_training(rng, device)
    print("phase I raw-wave model (make_multi_step, bf16, B={} x {} samples, logits "
          "{} as measured, k={}): {:.2f} ms per step, {:.1f} utterances/s, MFU {:.4f} of "
          "989 TFLOP/s bf16; loss {:.2f} -> {:.2f}; ctc_alpha/ctc_beta_grad launches {}/{} "
          "in {} steps; K1 and the fused backward vs plain at that shape and the fp32 step "
          "above; elu forward log-probs card vs CPU {:.3g}".format(
              BENCH_BATCH, BENCH_SAMPLES, raw["logits"], BENCH_STEPS, raw["ms_per_step"],
              raw["utterances_per_s"], raw["mfu"], raw["first_step_loss"],
              raw["last_call_mean_loss"], raw["launches"]["ctc_alpha"],
              raw["launches"]["ctc_beta_grad"], 2 * BENCH_STEPS, raw["elu_err"]), flush=True)
    logging.getLogger("results").setLevel(logging.WARNING)  # the previews' per-batch logs
    try:
        numbers["facade"] = facade = {
            "asg": facade_variant(data, device, ASG_EPOCHS, use_asg=True,
                                  train_asg_transitions=True),
            "raw_wave": facade_variant(data, device, RAW_EPOCHS, use_raw_wave_input=True),
            "raw_wave_resident": facade_variant(data, device, RAW_EPOCHS,
                                                use_raw_wave_input=True,
                                                device_resident=True)}
    finally:
        logging.getLogger("results").setLevel(logging.INFO)
    for name, run in facade.items():
        print("phase I facade {} ({} epoch(s) of {} batches of {}): train {:.2f} s, test "
              "{:.2f} s; test LER {:.4f}, WER {:.4f}, loss {:.3f}; ctc_alpha/ctc_beta_grad "
              "launches in training {}/{}".format(
                  name, ASG_EPOCHS if name == "asg" else RAW_EPOCHS, FACADE_BATCHES,
                  FACADE_BATCH, run["train_s"], run["test_s"], run["ler"], run["wer"],
                  run["loss"], *run["launches"]), flush=True)
    check(facade["asg"]["launches"] == (0, 0), "the ASG run launched CTC kernels: {}".format(
        facade["asg"]["launches"]))
    for name in ("raw_wave", "raw_wave_resident"):
        check(facade[name]["launches"][1] == RAW_EPOCHS * FACADE_BATCHES,
              "{}: fused backward launches {}".format(name, facade[name]["launches"]))
    numbers["seconds"] = time.perf_counter() - start
    print("phase I wall {:.1f} s".format(numbers["seconds"]), flush=True)
    return numbers


# ---- phase G: transfer, the resident corpus, SpecAugment and remat ----------------------
# Synthetic German sets in the LibriSpeech layout (German characters, hard tier, 2-6 s):
# (utterances, seed). Saved as corpus/German/corpus.csv, which `--config german` loads.
GERMAN_SETS = {"synthetic-de-train": (48, 21), "synthetic-de-test": (16, 22)}
GERMAN_BATCH, TRANSFER_FREEZE, TRANSFER_BATCHES, TRANSFER_EPOCHS = 16, 8, 4, 2
# The resident run's third epoch runs under torch.profiler; its second is the timed one.
RESIDENT_BATCHES, RESIDENT_EPOCHS = 8, 3
VARIANT_STEPS = 5  # steps a call of the bench-batch variants (full, freeze 8, remat)
# train-clean-100 at its real size: its utterance count, the 3,072-frame bucket of its
# longest utterances (24.6 s), 128 mel bins in fp16 (22.4 GB), labels of about 16
# characters a second; batch 64, four steps.
USER_ROWS, USER_FRAMES, USER_LABELS, USER_BATCH, USER_STEPS = 28539, 3072, 384, 64, 4


def stage_german_corpus(data: Path) -> None:
    from speechless_tpu_torch.data.corpus import ComposedCorpus, TrainingTestSplit
    from speechless_tpu_torch.data.librispeech import LibriSpeechCorpus
    from speechless_tpu_torch.data.synthetic import generate_corpus
    from speechless_tpu_torch.text.charsets import german_frequent_characters as alphabet

    base = data / "corpus" / "German"
    corpora = []
    for name, (count, seed) in GERMAN_SETS.items():
        generate_corpus(base, name, utterance_count=count, speaker_count=4,
                        min_duration_s=2.0, max_duration_s=6.0, characters=alphabet,
                        seed=seed, difficulty="hard")
        split = (TrainingTestSplit.test_only if name.endswith("test")
                 else TrainingTestSplit.training_only)
        corpora.append(LibriSpeechCorpus(base, name, allowed_characters=alphabet,
                                         training_test_split=split))
    ComposedCorpus(corpora).save(base / "corpus.csv")


def remapped_output_layer(layer: dict, source, target) -> dict:
    """The output layer a transfer load must produce, built here in numpy: each target
    character's column from the source's, zeros for characters the source lacks, the
    blank (last column) from the blank."""
    columns = [source.index(c) if c in source else None for c in target] + [len(source)]
    w = np.zeros(layer["w"].shape[:2] + (len(columns),), np.float32)
    b = np.zeros(len(columns), np.float32)
    for index, column in enumerate(columns):
        if column is not None:
            w[:, :, index], b[index] = layer["w"][:, :, column], layer["b"][column]
    return {"w": w, "b": b}


def equal_layers(params, reference, layers) -> bool:
    return all(np.array_equal(params[i][k], reference[i][k])
               for i in layers for k in ("w", "b"))


def copies_in_trace(prof, out_path: Path) -> dict:
    """Host-to-device copies and kernels in a `torch.profiler` trace (its chrome
    export, written to ``out_path``)."""
    out_path.parent.mkdir(parents=True, exist_ok=True)
    prof.export_chrome_trace(str(out_path))
    events = json.loads(out_path.read_text())["traceEvents"]
    copies = [e for e in events
              if e.get("cat") == "gpu_memcpy" and "HtoD" in e.get("name", "")]
    kernels = [e for e in events if e.get("cat") == "kernel"]
    return {"h2d_copies": len(copies),
            "h2d_bytes": sum(int(e.get("args", {}).get("bytes", 0)) for e in copies),
            "kernels": len(kernels), "kernel_ms": sum(e.get("dur", 0) for e in kernels) / 1e3}


def step_variants(device) -> dict:
    """`bench.py`'s batch at full width in bf16 with the German characters: the full
    step, the transfer step (layers 0-7 frozen: no gradient below big_conv_1) and the
    full step with remat, `make_multi_wav_step` with k=VARIANT_STEPS. One warm-up call
    each, then timed calls in turns (full, freeze 8, remat, remat, freeze 8, full): ms a
    step and the peak memory of each."""
    import torch

    from speechless_tpu_torch.models import wav2letter as w2l
    from speechless_tpu_torch.train import trainer

    variants = {"full": (0, False), "freeze 8": (TRANSFER_FREEZE, False),
                "remat": (0, True)}
    runs = {}
    for name, (frozen, remat) in variants.items():
        config = w2l.Wav2LetterConfig(128, 33, compute_dtype=torch.bfloat16, remat=remat)
        optimizer = trainer.make_optimizer(
            1e-4, trainable=w2l.trainable_mask(config, frozen) if frozen else None)
        state = trainer.init_train_state(config, optimizer,
                                         params=w2l.init_params(config, SEED), device=device)
        runs[name] = [state, trainer.make_multi_wav_step(config, optimizer, device=device)]
    batch = bench_wav_batch(np.random.default_rng(SEED + 9), config, VARIANT_STEPS, device)
    seconds = {name: [] for name in variants}
    peaks = {}
    for name in list(variants) + ["full", "freeze 8", "remat", "remat", "freeze 8", "full"]:
        state, step = runs[name]
        torch.cuda.synchronize()
        resident = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        start = time.perf_counter()
        runs[name][0], metrics = step(state, batch)
        losses = metrics["step_losses"].cpu().numpy()
        elapsed = time.perf_counter() - start
        check(np.isfinite(losses).all(), "{}: non-finite step loss".format(name))
        if name in peaks:
            seconds[name].append(elapsed)
        peaks[name] = (torch.cuda.max_memory_allocated() / 1e9,
                       (torch.cuda.max_memory_allocated() - resident) / 1e9)
    numbers = {name: {"ms_per_step": [s / VARIANT_STEPS * 1e3 for s in seconds[name]],
                      "peak_gb": peaks[name][0], "step_peak_gb": peaks[name][1]}
               for name in variants}
    check(peaks["remat"][1] < peaks["full"][1], "remat's step peak {:.2f} GB is not below "
          "the full step's {:.2f} GB".format(peaks["remat"][1], peaks["full"][1]))
    del runs
    torch.cuda.empty_cache()
    return numbers


def resident_fp32_check(data: Path, device) -> dict:
    """One fp32 resident epoch of 2 steps of 2 rows on given indices, full width, German
    characters, over the German training set packed on the card and on the CPU: each
    step's loss within FP32_LOSS_RTOL and the parameter deltas within
    FACADE_DELTA_RTOL."""
    from speechless_tpu_torch.configuration import Configuration, DataDirectories
    from speechless_tpu_torch.data.device_dataset import build_device_dataset
    from speechless_tpu_torch.models import wav2letter as w2l
    from speechless_tpu_torch.text.graphemes import CtcGraphemeCodec
    from speechless_tpu_torch.train import trainer

    configuration = Configuration.german(directories=DataDirectories(data))
    examples = configuration.batch_generator.labeled_training_spectrograms
    config = w2l.Wav2LetterConfig(128, len(configuration.allowed_characters) + 1)
    params = w2l.init_params(config, SEED + 7)
    indices = np.random.default_rng(SEED + 7).permutation(len(examples))[:4].reshape(2, 2)
    losses, deltas = {}, {}
    for where in ("cpu", device):
        dataset, _ = build_device_dataset(examples, CtcGraphemeCodec(
            configuration.allowed_characters), where)
        optimizer = trainer.make_optimizer(1e-4)
        state = trainer.init_train_state(config, optimizer, params=params, device=where)
        state, metrics = trainer.make_device_epoch_step(config, optimizer, 2, 2)(
            state, dataset, indices=indices)
        losses[where] = metrics["step_losses"].cpu().numpy()
        deltas[where] = [{k: layer[k] - start[k] for k in ("w", "b")}
                         for layer, start in zip(state.params, params)]
    frames = tuple(dataset.inputs.shape[1:])
    del dataset, state
    loss_err = float(np.max(np.abs(losses[device] - losses["cpu"]) / np.abs(losses["cpu"])))
    delta_err = max(float(np.linalg.norm(g[k] - c[k]) / np.linalg.norm(c[k]))
                    for g, c in zip(deltas[device], deltas["cpu"]) for k in ("w", "b")
                    if np.linalg.norm(c[k]) > 0)
    print("phase G fp32 resident epoch (2 steps of 2 rows on given indices, rows padded to "
          "{}) card vs CPU: step losses {} vs {}, rel {:.3g}; parameter-delta rel L2 {:.3g} "
          "(limits {} and {})".format(frames, losses[device].tolist(), losses["cpu"].tolist(),
                                      loss_err, delta_err, FP32_LOSS_RTOL, FACADE_DELTA_RTOL),
          flush=True)
    check(loss_err <= FP32_LOSS_RTOL and delta_err <= FACADE_DELTA_RTOL,
          "the fp32 resident epoch on the card differs from the CPU: loss {:.3g}, deltas "
          "{:.3g}".format(loss_err, delta_err))
    return {"loss_rel": loss_err, "delta_rel_l2": delta_err}


def spec_augment_check(device) -> dict:
    """SpecAugment's masks on the card from given uniform draws equal the CPU's, at the
    resident batch's shape (16 x 768 frames x 128 mel, fp16)."""
    import torch

    from speechless_tpu_torch.ops.specaugment import (Draws, SpecAugment, apply_spec_augment,
                                                      draw)

    rng = np.random.default_rng(SEED + 8)
    inputs = torch.tensor(rng.normal(size=(GERMAN_BATCH, 768, 128)), dtype=torch.float16)
    lengths = torch.tensor(rng.integers(250, 769, GERMAN_BATCH), dtype=torch.int32)
    config = SpecAugment()
    draws = draw(torch.Generator().manual_seed(SEED), GERMAN_BATCH, config, "cpu")
    want = apply_spec_augment(inputs, lengths, config, draws=draws)
    got = apply_spec_augment(inputs.to(device), lengths.to(device), config,
                             draws=Draws(*(d.to(device) for d in draws))).cpu()
    masked = int((want == 0).sum())
    check(torch.equal(got, want) and masked > 0,
          "SpecAugment on the card differs from the CPU on the same draws")
    return {"masked_cells": masked, "cells": want.numel()}


def user_size_resident(device) -> dict:
    """A `DeviceDataset` of train-clean-100's size built on the card (features drawn
    there, so no 22 GB host array), then `make_device_epoch_step` at B=64 for
    USER_STEPS steps in bf16: the epoch's time by CUDA events, and the sampling and
    gather alone (`sample_indices` and `index_select` of every field, the same steps)."""
    import torch

    from speechless_tpu_torch.data.device_dataset import DeviceDataset, check_fits
    from speechless_tpu_torch.models import wav2letter as w2l
    from speechless_tpu_torch.train import trainer

    nbytes = USER_ROWS * (USER_FRAMES * 128 * 2 + USER_LABELS * 4 + 8)
    torch.cuda.empty_cache()  # the free memory `check_fits` reads excludes cached blocks
    check_fits(nbytes, device)
    generator = torch.Generator(device=device).manual_seed(SEED)
    start = time.perf_counter()
    inputs = torch.empty((USER_ROWS, USER_FRAMES, 128), dtype=torch.float16, device=device)
    lengths = torch.randint(USER_FRAMES // 3, USER_FRAMES + 1, (USER_ROWS,),
                            generator=generator, device=device, dtype=torch.int32)
    frames = torch.arange(USER_FRAMES, device=device)
    for first in range(0, USER_ROWS, 4096):
        chunk = inputs[first:first + 4096]
        chunk.normal_(generator=generator)
        chunk.masked_fill_(frames[None, :, None] >= lengths[first:first + 4096, None, None],
                           0.0)
    label_lengths = (lengths // 8).to(torch.int32)
    labels = torch.randint(0, 28, (USER_ROWS, USER_LABELS), generator=generator,
                           device=device, dtype=torch.int32)
    labels.masked_fill_(torch.arange(USER_LABELS, device=device)[None]
                        >= label_lengths[:, None], -1)
    dataset = DeviceDataset(inputs, lengths, labels, label_lengths)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - start

    config = w2l.Wav2LetterConfig(128, 29, compute_dtype=torch.bfloat16)
    optimizer = trainer.make_optimizer(1e-4)
    state = trainer.init_train_state(config, optimizer, params=w2l.init_params(config, SEED),
                                     device=device)
    state, _ = trainer.make_device_epoch_step(config, optimizer, USER_BATCH, 1)(
        state, dataset, generator)  # cuDNN's plans for this shape
    epoch = trainer.make_device_epoch_step(config, optimizer, USER_BATCH, USER_STEPS)
    torch.cuda.reset_peak_memory_stats()
    events = [torch.cuda.Event(enable_timing=True) for _ in range(4)]
    torch.cuda.synchronize()
    events[0].record()
    state, metrics = epoch(state, dataset, generator)
    events[1].record()
    for _ in range(USER_STEPS):
        rows = trainer.sample_indices(USER_ROWS, USER_BATCH, 1, generator)[0]
        gathered = [field.index_select(0, rows) for field in dataset]
    events[3].record()
    torch.cuda.synchronize()
    losses = metrics["step_losses"].cpu().numpy()
    check(np.isfinite(losses).all(), "non-finite loss in the train-clean-100-size epoch")
    epoch_ms = events[0].elapsed_time(events[1])
    gather_ms = events[1].elapsed_time(events[3])
    numbers = {"rows": USER_ROWS, "frames": USER_FRAMES, "resident_gb": dataset.nbytes() / 1e9,
               "build_s": build_s, "ms_per_step": epoch_ms / USER_STEPS,
               "sample_gather_ms_per_step": gather_ms / USER_STEPS,
               "sample_gather_share": gather_ms / epoch_ms,
               "utterances_per_s": USER_BATCH * USER_STEPS / epoch_ms * 1e3,
               "peak_gb": torch.cuda.max_memory_allocated() / 1e9,
               "losses": losses.tolist(), "gathered_mb": sum(
                   f.numel() * f.element_size() for f in gathered) / 1e6}
    del dataset, inputs, labels, gathered, state
    torch.cuda.empty_cache()
    return numbers


def phase_g(device, card: str, facade: dict, data: Path) -> dict:
    """Transfer, the device-resident corpus, SpecAugment, remat and the German and mixed
    configurations on the card, after phase F (whose epoch-2 English checkpoint is the
    donor) and over its data directory."""
    import logging
    import shutil

    import torch

    from speechless_tpu_torch import system
    from speechless_tpu_torch.configuration import Configuration, DataDirectories
    from speechless_tpu_torch.data import device_dataset
    from speechless_tpu_torch.lm.arpa_builder import build_kenlm_directory
    from speechless_tpu_torch.text.charsets import english_frequent_characters as english
    from speechless_tpu_torch.text.charsets import german_frequent_characters as german
    from speechless_tpu_torch.train import checkpoint, trainer

    numbers = {"commands_s": {}, "launches": {}}
    baseline, baseline_epoch = Configuration.english_baseline
    nets, logs = data / "nets", data / "logs"
    (nets / baseline).mkdir(parents=True)
    shutil.copyfile(nets / facade["run"] / checkpoint.model_file_name(FACADE_EPOCHS),
                    nets / baseline / checkpoint.model_file_name(baseline_epoch))
    donor = checkpoint.load_params(nets / baseline, baseline_epoch)
    start = time.perf_counter()
    stage_german_corpus(data)
    numbers["staging_s"] = time.perf_counter() - start
    common = ["--config", "german", "--data-dir", str(data), "--batch-size", str(GERMAN_BATCH)]

    def command(name, *arguments, key=None, options=common):
        before = set(nets.iterdir()) | set(logs.iterdir())
        launches = run_cli(numbers, "G", device, name, *options, *arguments, key=key)
        return launches, [path.name for path in (set(nets.iterdir()) | set(logs.iterdir()))
                          - before]

    def scalars(run):
        rows = (logs / run / "scalars.csv").read_text().strip().splitlines()[1:]
        rows = [[float(v) for v in row.split(",")] for row in rows]
        check(rows and all(np.isfinite(row[2]) for row in rows),
              "{}: non-finite or missing epoch losses {}".format(run, rows))
        return rows

    results, trained, resident = [], [], {}
    record_grouped = system.Wav2Letter.test_and_predict_grouped_batches
    record_train = system.Wav2Letter.train
    build, make_epoch = device_dataset.build_device_dataset, trainer.make_device_epoch_step

    def recording_grouped(self, grouped):
        results.append(record_grouped(self, grouped))
        return results[-1]

    def recording_train(self, *args, **kwargs):
        trained.append(self.params)
        record_train(self, *args, **kwargs)
        trained.append(self.params)

    def recording_build(*args, **kwargs):
        dataset, megabytes = build(*args, **kwargs)
        resident.update(megabytes=megabytes, shape=tuple(dataset.inputs.shape),
                        dtype=str(dataset.inputs.dtype))
        return dataset, megabytes

    def profiled_epoch_step(*args, **kwargs):
        epoch_step, calls = make_epoch(*args, **kwargs), []

        def step(*a, **k):
            calls.append(None)
            if len(calls) < RESIDENT_EPOCHS:
                return epoch_step(*a, **k)
            activities = [torch.profiler.ProfilerActivity.CPU,
                          torch.profiler.ProfilerActivity.CUDA]
            with torch.profiler.profile(activities=activities) as prof:
                result = epoch_step(*a, **k)
                torch.cuda.synchronize()
            resident["trace"] = copies_in_trace(
                prof, ROOT / "chiprun_out" / "profile_resident.json")
            return result

        return step

    system.Wav2Letter.test_and_predict_grouped_batches = recording_grouped
    system.Wav2Letter.train = recording_train
    logging.getLogger("results").setLevel(logging.WARNING)
    try:
        command("summarize")
        command("fill-cache")
        entries = len(list((data / "spectrogram-cache" / "German").glob("*.npy")))
        check(entries == sum(c for c, _ in GERMAN_SETS.values()),
              "the German cache holds {} entries".format(entries))

        # transfer --freeze 8: the run continues the donor's epoch numbering.
        trained.clear()
        limit = baseline_epoch + TRANSFER_EPOCHS
        (alpha, backward), runs = command(
            "transfer", "--freeze", str(TRANSFER_FREEZE), "--batches-per-epoch",
            str(TRANSFER_BATCHES), "--epochs", str(limit))
        (transfer_run,) = {run for run in runs if run.endswith("-freeze-8")}
        steps = TRANSFER_BATCHES * TRANSFER_EPOCHS
        check((alpha, backward) == (steps + TRANSFER_EPOCHS + 1, steps),
              "transfer: K1/backward launches {}/{} in {} steps and {} previews".format(
                  alpha, backward, steps, TRANSFER_EPOCHS + 1))
        before, after = trained
        want = remapped_output_layer(donor[-1], english, german)
        check(equal_layers(before, donor, range(10))
              and equal_layers([want], [before[-1]], [0]),
              "the transfer load is not the donor with its output layer remapped")
        check(not before[-1]["w"][:, :, [german.index(c) for c in "äöüß"]].any(),
              "the new characters' filters are not zero")
        saved = checkpoint.load_params(nets / transfer_run, limit)
        check(equal_layers(after, donor, range(TRANSFER_FREEZE))
              and equal_layers(saved, donor, range(TRANSFER_FREEZE))
              and not equal_layers(saved, donor, [9]),
              "transfer training changed a frozen layer, or no trainable one")
        numbers["transfer"] = scalars(transfer_run)

        trained.clear()
        _, runs = command("transfer", "--freeze", str(TRANSFER_FREEZE), "--reinitialize",
                          "--batches-per-epoch", str(TRANSFER_BATCHES), "--epochs",
                          str(baseline_epoch + 1), key="transfer --reinitialize")
        before, after = trained
        check(equal_layers(before, donor, range(TRANSFER_FREEZE))
              and equal_layers(after, donor, range(TRANSFER_FREEZE))
              and not any(np.array_equal(before[i]["w"][..., :28], donor[i]["w"][..., :28])
                          for i in range(TRANSFER_FREEZE, 11)),
              "--reinitialize: layers 0-7 must be the donor's and layers 8-10 fresh")
        trained.clear()

        numbers["variants"] = step_variants(device)

        device_dataset.build_device_dataset = recording_build
        trainer.make_device_epoch_step = profiled_epoch_step
        try:
            (alpha, backward), runs = command(
                "train", "--device-resident", "--batches-per-epoch", str(RESIDENT_BATCHES),
                "--epochs", str(RESIDENT_EPOCHS), key="train --device-resident")
        finally:
            device_dataset.build_device_dataset, trainer.make_device_epoch_step = build, \
                make_epoch
        (resident_run,) = set(runs)
        steps = RESIDENT_BATCHES * RESIDENT_EPOCHS
        check((alpha, backward) == (steps + RESIDENT_EPOCHS + 1, steps),
              "resident: K1/backward launches {}/{} in {} steps".format(alpha, backward,
                                                                         steps))
        numbers["resident"] = dict(resident, scalars=scalars(resident_run))
        trace = resident["trace"]
        batch_label_bytes = GERMAN_BATCH * 64 * 4
        check(trace["kernels"] > 0 and trace["h2d_bytes"] < batch_label_bytes,
              "the resident epoch's trace: {} kernels, {} host-to-device bytes in {} copies "
              "(one batch's labels are {} bytes)".format(trace["kernels"], trace["h2d_bytes"],
                                                         trace["h2d_copies"],
                                                         batch_label_bytes))
        numbers["fp32"] = resident_fp32_check(data, device)

        (alpha, backward), runs = command(
            "train", "--spec-augment", "--remat", "--batches-per-epoch",
            str(TRANSFER_BATCHES), "--epochs", "1", key="train --spec-augment --remat")
        (augmented_run,) = set(runs)
        numbers["augmented"] = scalars(augmented_run)
        check(backward == TRANSFER_BATCHES, "--spec-augment --remat: {} backward launches"
              .format(backward))
        numbers["spec_augment"] = spec_augment_check(device)

        command("average", "--run", transfer_run, "--last", "2")
        averaged_epoch = limit + 1000
        averaged = checkpoint.load_params(nets / transfer_run, averaged_epoch)
        last = [checkpoint.load_params(nets / transfer_run, e) for e in (limit - 1, limit)]
        check(all(np.array_equal(averaged[i][k], ((last[0][i][k].astype(np.float64)
                                                   + last[1][i][k]) * 0.5).astype(np.float32))
                  for i in range(11) for k in ("w", "b")),
              "the averaged checkpoint is not the mean of the last two epochs")

        configuration = Configuration.german(directories=DataDirectories(data))
        build_kenlm_directory([e.label for e in configuration.corpus.training_examples],
                              data / "kenlm" / "german", allowed_characters=german, order=3)
        test_count = GERMAN_SETS["synthetic-de-test"][0]
        for decoder in ([], ["--kenlm"]):
            key = "test" + (" --kenlm" if decoder else "")
            (alpha, backward), _ = command("test", *decoder, "--run", transfer_run, "--epoch",
                                           str(averaged_epoch), key=key)
            result = results[-1]
            check((alpha, backward) == (-(-test_count // GERMAN_BATCH), 0)
                  and len(result.results) == test_count,
                  "{}: {} results, K1/backward launches {}/{}".format(
                      key, len(result.results), alpha, backward))
            numbers[key] = {"ler": result.average_letter_error_rate,
                            "wer": result.average_word_error_rate,
                            "loss": result.average_loss}

        mixed = ["--config", "mixed_german_english", "--data-dir", str(data),
                 "--batch-size", str(GERMAN_BATCH)]
        command("summarize", key="summarize mixed", options=mixed)
        command("test", "--run", transfer_run, "--epoch", str(averaged_epoch),
                key="test mixed", options=mixed)
        groups = results[-1].result_batches_by_group_name
        counts = {name: len(batches.results) for name, batches in groups.items()}
        check(counts == {"English": FACADE_SETS["test-clean"][0], "German": test_count},
              "the mixed configuration's groups: {}".format(counts))
        numbers["mixed"] = {name: {"examples": len(batches.results),
                                   "ler": batches.average_letter_error_rate,
                                   "wer": batches.average_word_error_rate}
                            for name, batches in groups.items()}
    finally:
        system.Wav2Letter.test_and_predict_grouped_batches = record_grouped
        system.Wav2Letter.train = record_train
        logging.getLogger("results").setLevel(logging.INFO)
    numbers["user_size"] = user_size_resident(device)

    print(card)
    print("phase G (CLI in process; donor: phase F's epoch-{} English checkpoint as {} epoch "
          "{}; German synthetic sets, hard tier, 2-6 s, {} training and {} test utterances, "
          "staged in {:.2f} s): command walls (s) {}".format(
              FACADE_EPOCHS, baseline, baseline_epoch, GERMAN_SETS["synthetic-de-train"][0],
              test_count, numbers["staging_s"],
              {k: round(v, 3) for k, v in numbers["commands_s"].items()}))
    print("phase G launches (ctc_alpha, ctc_beta_grad) per command: {}".format(
        numbers["launches"]))
    for row in numbers["transfer"]:
        print("phase G transfer --freeze 8 epoch {:.0f} (step {:.0f}): loss {:.4f}, {:.2f} "
              "utterances/s (B={}, bf16); layers 0-7 bitwise the donor's".format(
                  *row[:4], GERMAN_BATCH))
    variants = numbers["variants"]
    print("phase G bench batch (B={} x {} samples, 33 classes, bf16, k={}), ms a step in "
          "turns: {}; peak memory GB (above the resident states): {}".format(
              BENCH_BATCH, BENCH_SAMPLES, VARIANT_STEPS,
              {name: [round(ms, 2) for ms in v["ms_per_step"]]
               for name, v in variants.items()},
              {name: (round(v["peak_gb"], 3), round(v["step_peak_gb"], 3))
               for name, v in variants.items()}))
    rows, host = numbers["resident"]["scalars"], facade["scalars"]
    print("phase G device-resident corpus: {:.1f} MB, {} {}; epoch 2 {:.2f} utterances/s "
          "(B={}, {} batches) beside phase F's host-pipeline epoch 2 {:.2f} utterances/s "
          "(B={}, {} batches); epochs {}".format(
              numbers["resident"]["megabytes"], numbers["resident"]["shape"],
              numbers["resident"]["dtype"], rows[1][3], GERMAN_BATCH, RESIDENT_BATCHES,
              host[1][3], FACADE_BATCH, FACADE_BATCHES,
              [(int(r[0]), round(r[2], 4), round(r[3], 2)) for r in rows]))
    print("phase G resident epoch {} under torch.profiler: {} kernels ({:.3f} ms of device "
          "time), {} host-to-device copies of {} bytes (trace: chiprun_out/"
          "profile_resident.json)".format(RESIDENT_EPOCHS, trace["kernels"],
                                          trace["kernel_ms"], trace["h2d_copies"],
                                          trace["h2d_bytes"]))
    print("phase G train --spec-augment --remat: {}; SpecAugment on the card from given "
          "draws equal to the CPU ({} of {} cells masked)".format(
              [(int(r[0]), round(r[2], 4)) for r in numbers["augmented"]],
              numbers["spec_augment"]["masked_cells"], numbers["spec_augment"]["cells"]))
    for key in ("test", "test --kenlm"):
        print("phase G {} (German, the average of epochs {} and {}): LER {:.4f}, WER {:.4f}, "
              "loss {:.3f}".format(key, limit - 1, limit, numbers[key]["ler"],
                                   numbers[key]["wer"], numbers[key]["loss"]))
    print("phase G test --config mixed_german_english, per group: {}".format(numbers["mixed"]))
    user = numbers["user_size"]
    print("phase G train-clean-100-size resident corpus: {} rows x {} frames x 128 mel fp16, "
          "{:.2f} GB built on the card in {:.2f} s; B={} bf16: {:.2f} ms a step ({:.1f} "
          "utterances/s), sampling and gather {:.3f} ms a step ({:.4f} of the step), peak "
          "memory {:.2f} GB; losses {}".format(
              user["rows"], user["frames"], user["resident_gb"], user["build_s"], USER_BATCH,
              user["ms_per_step"], user["utterances_per_s"], user["sample_gather_ms_per_step"],
              user["sample_gather_share"], user["peak_gb"],
              [round(loss, 2) for loss in user["losses"]]))
    return numbers


# ---- phase H: the rest of the Transcriber's routes ---------------------------------------
# int8 compute on the card vs the CPU: the activation scales are per tensor, so an fp32
# trunk that rounds otherwise on the card moves some x_q by one step, and the log-probs
# by more than the fp32 limit: 2.50e-3 at most on phase B's batch on an NVIDIA H100 80GB
# HBM3 (700 W), with 63 and 28,046 x_q entries one step apart at big_conv_1 and
# big_conv_2. The limit is four times that.
INT8_LOGPROB_LIMIT = 1e-2
WARM_BEAM_KERNELS = {"lm_beam_span", "stream_stitch"}  # what a kernel-route beam feed loads


def exact_int8_sums(x_q, w_q, spec):
    """The int32 sums of a SAME-padded int8 conv computed exactly on the CPU: ``x_q``
    ``(B, Cin, T)`` and ``w_q`` ``(Cout, Cin, K)`` as float64, unfolded and multiplied
    (every product and partial sum is an integer below ``Cin * K * 127**2 < 2**53``, so
    float64 is exact in any order), returned as int64 ``(B, T', Cout)``."""
    import torch
    import torch.nn.functional as F

    from speechless_tpu_torch.models.wav2letter import same_padding

    batch, _, frames = x_q.shape
    x = F.pad(x_q.to(torch.float64), same_padding(frames, spec.kernel_size, spec.stride))
    columns = x.unfold(2, spec.kernel_size, spec.stride).permute(0, 2, 1, 3)
    out_frames = columns.shape[1]
    sums = columns.reshape(batch * out_frames, -1) @ w_q.to(torch.float64).reshape(
        w_q.shape[0], -1).t()
    return sums.round().to(torch.int64).reshape(batch, out_frames, -1)


def kernel_loads(lines):
    """The kernel names of `_kernels`' "loaded kernel <name>" log lines."""
    return [line.split("loaded kernel ", 1)[1].split()[0] for line in lines
            if "loaded kernel " in line]


def warm_beam_server(npz: Path, lm_directory: Path, audio, device) -> dict:
    """A fresh ``serve --warm-beam --no-warm-up`` process on the host pool: the kernels
    it loads before it binds, then one ``/v1/stream`` beam session fed ``audio`` in
    0.5 s chunks and finished, and the kernels loaded after the bind."""
    import queue
    import signal

    process = subprocess.Popen(
        [sys.executable, "-m", "speechless_tpu_torch", "serve", "--checkpoint", str(npz),
         "--kenlm", str(lm_directory), "--warm-beam", "--no-warm-up", "--port", "0",
         "--device", str(device)], cwd=str(ROOT), stderr=subprocess.PIPE, text=True)
    lines = queue.Queue()

    def read_log():
        for log_line in process.stderr:
            lines.put(log_line)
        lines.put(None)

    threading.Thread(target=read_log, daemon=True).start()
    start, before, after = time.perf_counter(), [], []
    try:
        while not before or "serving on http://" not in before[-1]:
            before.append(lines.get(timeout=600))
            check(before[-1] is not None, "serve --warm-beam exited: {}".format(
                "".join(before[:-1])[-3000:]))
        bound_s = time.perf_counter() - start
        port = int(before[-1].rsplit(":", 1)[1].split()[0])
        status, created, _ = http_request(port, "/v1/stream", b'{"partial_decode": "beam"}')
        check(status == 200, "stream create answered {}".format(status))
        sid = created["session"]
        feeds = []
        for begin in range(0, len(audio), 8000):
            status, _, seconds = http_request(port, "/v1/stream/" + sid,
                                              audio[begin:begin + 8000].astype("<f4")
                                              .tobytes(), "application/octet-stream")
            check(status == 200, "a stream feed answered {}".format(status))
            feeds.append(seconds)
        status, final, _ = http_request(port, "/v1/stream/{}/finish".format(sid))
        check(status == 200, "the stream finish answered {}".format(status))
    finally:
        process.send_signal(signal.SIGINT)
        try:
            process.wait(timeout=60)
        finally:
            process.kill()
    while True:
        line = lines.get(timeout=60)
        if line is None:
            break
        after.append(line)
    return {"before": kernel_loads(before), "after": kernel_loads(after),
            "bound_s": bound_s, "feeds_s": feeds, "text": final["text"]}


def phase_h(device, card: str, transcriber, batch, lm_directory: Path, batch_s: float
            ) -> dict:
    """The rest of the Transcriber's routes at full width on phase B's weights and LM:
    weight-only int8 and int8-compute serving (card vs CPU), forced alignment (card vs
    CPU Viterbi), FLAC input through ``transcribe``, the host pool's beam warm-up in a
    fresh ``serve --warm-beam`` process, a quantized resident device-pool session
    against the host pool, and `measure_latency`."""
    import contextlib
    import io

    import scipy.io.wavfile as wavfile
    import torch

    from speechless_tpu_torch.__main__ import main as cli
    from speechless_tpu_torch.features.flac_encoder import encode_flac
    from speechless_tpu_torch.features.spectrogram import features_batch
    from speechless_tpu_torch.models import wav2letter as w2l
    from speechless_tpu_torch.ops import beam_common, decode_lm
    from speechless_tpu_torch.ops.decode_incremental_kernel import stream_stitch
    from speechless_tpu_torch.ops.device_beam import beam_search_decode_device
    from speechless_tpu_torch.ops.forced_align import ctc_forced_align
    from speechless_tpu_torch.precision import ieee_fp32
    from speechless_tpu_torch.serving import CHARSETS, Transcriber, grouped_padded_batches
    from speechless_tpu_torch.serving_streaming import StreamingSessionPool

    alphabet = CHARSETS["english"]
    config = transcriber.config
    params = serving_params(config)
    numbers = {"launches": {}, "walls_s": {}}
    clock = [time.perf_counter()]

    def lap(name):
        now = time.perf_counter()
        numbers["walls_s"][name] = round(now - clock[0], 3)
        clock[0] = now

    def reset():
        decode_lm.lm_span.launches = decode_lm.lm_step.launches = 0
        beam_common.beam_backtrace.launches = stream_stitch.launches = 0

    def launches():
        return {"lm_beam_span": decode_lm.lm_span.launches,
                "beam_backtrace": beam_common.beam_backtrace.launches,
                "stream_stitch": stream_stitch.launches,
                "lm_beam_step": decode_lm.lm_step.launches}

    _, wavs, lengths = next(grouped_padded_batches(batch, transcriber._bucket, 16))
    with torch.inference_mode():
        cpu_features, _ = features_batch(torch.from_numpy(wavs), torch.from_numpy(lengths))
        features, _ = features_batch(torch.from_numpy(wavs).to(device),
                                     torch.from_numpy(lengths).to(device))

    def card_and_cpu(card_transcriber, cpu_transcriber, plain=True):
        """Served log-probs of the 16 x 8 s group on the card and the same model's on
        the CPU, the valid-frame mask, the plain loop's transcripts of the card's
        log-probs on the card (``plain``; the kernels must give the same) and the
        transcripts of the CPU's own log-probs through the CPU's beam."""
        with torch.inference_mode():
            log_probs, frames = card_transcriber._log_probs(wavs, lengths)
            cpu_log_probs = torch.log_softmax(cpu_transcriber.model(cpu_features), dim=-1)
            decoder = cpu_transcriber._decoder
            texts = []
            if plain:
                tokens, counts = decode_lm._beam_search(
                    log_probs, frames, card_transcriber.blank_index,
                    card_transcriber.word_lm, decoder["beam_width"], log_probs.shape[1],
                    decoder["lm_weight"], decoder["word_count_weight"],
                    decoder["valid_word_count_weight"], decoder["prune_classes"],
                    step=decode_lm.lm_step_reference)
                texts.append((tokens.cpu(), counts.cpu()))
            texts.append(beam_search_decode_device(
                cpu_log_probs, frames.cpu(), blank=cpu_transcriber.blank_index,
                word_lm=cpu_transcriber.word_lm, max_decoded_length=cpu_log_probs.shape[1],
                **decoder))
        texts = [[cpu_transcriber.codec.decode_graphemes(
            tokens[row, :int(counts[row])].tolist(), merge_repeated=False)
            for row in range(len(batch))] for tokens, counts in texts]
        valid = torch.arange(log_probs.shape[1])[None, :] < frames.cpu()[:, None]
        return log_probs.cpu(), cpu_log_probs, valid, texts

    def served(route_transcriber, name):
        """``transcribe_batch`` of the 16 x 8 s batch: the texts, the launches of one
        call and the ms a batch over 5 timed calls."""
        route_transcriber.transcribe_batch(batch)
        torch.cuda.synchronize()
        reset()
        texts = [text for text, _ in route_transcriber.transcribe_batch(batch)]
        torch.cuda.synchronize()
        numbers["launches"][name] = launches()
        check(numbers["launches"][name] == {"lm_beam_span": 1, "beam_backtrace": 1,
                                            "stream_stitch": 0, "lm_beam_step": 0},
              "{} serving of 16 x 8 s launched {}".format(name, numbers["launches"][name]))
        start = time.perf_counter()
        for _ in range(5):
            route_transcriber.transcribe_batch(batch)
        torch.cuda.synchronize()
        numbers[name + "_batch_ms"] = (time.perf_counter() - start) / 5 * 1e3
        return texts

    # -- weight-only int8 ---------------------------------------------------------------
    quantized = Transcriber(config, params, alphabet, device=device,
                            kenlm_directory=lm_directory, quantize_weights=True)
    cpu_quantized = Transcriber(config, params, alphabet, device="cpu",
                                kenlm_directory=lm_directory, quantize_weights=True)
    texts = served(quantized, "quantized")
    lap("weight-only int8: transcribers and served batches")
    log_probs, cpu_log_probs, valid, (same_texts, cpu_texts) = card_and_cpu(quantized,
                                                                           cpu_quantized)
    lap("weight-only int8: CPU model, plain loop, CPU beam")
    check(bool(torch.isfinite(log_probs).all()), "quantized log-probs not finite")
    numbers["quantized_gap"] = float((log_probs - cpu_log_probs).abs()[valid].max())
    check(numbers["quantized_gap"] <= FP32_TOLERANCE, "weight-only int8 log-probs card vs "
          "CPU differ by {} > {}".format(numbers["quantized_gap"], FP32_TOLERANCE))
    check(texts == same_texts, "weight-only int8 transcripts differ from the plain loop's "
          "on the same log-probs: {} vs {}".format(texts[:2], same_texts[:2]))
    # End to end (the CPU's own log-probs through the CPU's beam), rounding can flip a
    # near-tie of the beam on these random weights; the count is recorded, for the fp32
    # model too.
    fp32_cpu = Transcriber(config, params, alphabet, device="cpu",
                           kenlm_directory=lm_directory)
    fp32_texts = [text for text, _ in transcriber.transcribe_batch(batch)]
    _, _, _, (fp32_cpu_texts,) = card_and_cpu(transcriber, fp32_cpu, plain=False)
    lap("fp32: CPU model and CPU beam")
    numbers["end_to_end_equal"] = {
        "fp32": sum(a == b for a, b in zip(fp32_texts, fp32_cpu_texts)),
        "quantized": sum(a == b for a, b in zip(texts, cpu_texts))}
    numbers["weight_bytes"] = {
        "fp32": sum(t.numel() * t.element_size() for t in transcriber.model.parameters()),
        "int8": sum(t.numel() * t.element_size() for t in quantized.model.buffers())}
    with torch.inference_mode():
        numbers["dequantize_ms"] = cuda_ms(lambda: [conv.dequantized(torch.float32)
                                                    for conv in quantized.model.layers], 20)
        numbers["model_ms"] = {
            "fp32": cuda_ms(lambda: transcriber.model(features), 10),
            "quantized": cuda_ms(lambda: quantized.model(features), 10)}
    print("phase H weight-only int8 (16 x 8 s, LM beam): log-probs card vs CPU max {} "
          "(limit {}), transcripts equal the plain loop's on the same log-probs ({} of {} "
          "non-empty); {:.3f} ms a batch "
          "beside phase B's fp32 {:.3f} ms; model {:.3f} ms (fp32 {:.3f} ms), of which the "
          "per-call dequantize of all 11 layers {:.4f} ms; weights on the device {} bytes "
          "int8 + scales + biases vs {} bytes fp32; launches {}; transcripts of the CPU's "
          "own log-probs equal the card's in {} of {} rows (fp32 model: {})".format(
              numbers["quantized_gap"], FP32_TOLERANCE, sum(bool(t) for t in texts),
              len(texts),
              numbers["quantized_batch_ms"], batch_s * 1e3,
              numbers["model_ms"]["quantized"], numbers["model_ms"]["fp32"],
              numbers["dequantize_ms"], numbers["weight_bytes"]["int8"],
              numbers["weight_bytes"]["fp32"], numbers["launches"]["quantized"],
              numbers["end_to_end_equal"]["quantized"], len(texts),
              numbers["end_to_end_equal"]["fp32"]), flush=True)

    lap("weight-only int8: timings")
    # -- int8 compute -------------------------------------------------------------------
    int8 = Transcriber(config, params, alphabet, device=device,
                       kenlm_directory=lm_directory, int8_compute=True)
    cpu_int8 = Transcriber(config, params, alphabet, device="cpu",
                           kenlm_directory=lm_directory, int8_compute=True)
    texts8 = served(int8, "int8")
    lap("int8 compute: transcribers and served batches")
    log_probs8, cpu_log_probs8, valid, (same_texts8, cpu_texts8) = card_and_cpu(int8,
                                                                                cpu_int8)
    lap("int8 compute: CPU model, plain loop, CPU beam")
    first = config.layer_names.index("big_conv_1")
    no_masks = [None] * len(config.layers)
    numbers["x_q_steps"], numbers["x_q_differing"] = [], []
    with torch.inference_mode():  # each big conv's input, as the forward computes it
        inputs = [int8.model._layers(features.transpose(1, 2), 0, first, no_masks)]
        inputs.append(int8.model._layers(inputs[0], first, first + 1, no_masks))
        cpu_inputs = [cpu_int8.model._layers(cpu_features.transpose(1, 2), 0, first,
                                             no_masks)]
        cpu_inputs.append(cpu_int8.model._layers(cpu_inputs[0], first, first + 1,
                                                 no_masks))
    for layer_index, x_in, cpu_x_in in zip((first, first + 1), inputs, cpu_inputs):
        spec, layer = config.layers[layer_index], int8.model.layers[layer_index]
        with torch.inference_mode():
            x_q, _ = w2l.quantize_activations(x_in)
            cpu_x_q, _ = w2l.quantize_activations(cpu_x_in)
            sums = w2l.int8_conv_sums(x_q, layer.w_q, spec)
        exact = exact_int8_sums(x_q.cpu(), layer.w_q.cpu(), spec)
        check(sums.dtype == torch.int32 and torch.equal(sums.cpu().to(torch.int64), exact),
              "{}'s int32 sums on the card differ from the exact CPU product".format(
                  spec.name))
        steps = (x_q.cpu().to(torch.int32) - cpu_x_q.to(torch.int32)).abs()
        numbers["x_q_steps"].append(int(steps.max()))
        numbers["x_q_differing"].append(int((steps > 0).sum()))
    lap("int8 compute: x_q and the exact sums")
    numbers["int8_gap"] = float((log_probs8 - cpu_log_probs8).abs()[valid].max())
    numbers["int8_vs_fp32_gap"] = float((log_probs8 - cpu_log_probs).abs()[valid].max())
    check(bool(torch.isfinite(log_probs8).all()), "int8 log-probs not finite")
    check(numbers["int8_gap"] <= INT8_LOGPROB_LIMIT, "int8 log-probs card vs CPU differ by "
          "{} > {}".format(numbers["int8_gap"], INT8_LOGPROB_LIMIT))
    check(texts8 == same_texts8, "int8 transcripts differ from the plain loop's on the same "
          "log-probs: {} vs {}".format(texts8[:2], same_texts8[:2]))
    numbers["end_to_end_equal"]["int8"] = sum(a == b for a, b in zip(texts8, cpu_texts8))
    layer = int8.model.layers[first]
    with torch.inference_mode():
        x_q, _ = w2l.quantize_activations(inputs[0])
        padded = torch.nn.functional.pad(x_q, w2l.same_padding(x_q.shape[2], 32, 1))
        columns = padded.unfold(2, 32, 1).permute(0, 2, 1, 3).reshape(-1, 250 * 32)
        weight = layer.w_q.reshape(layer.w_q.shape[0], -1).t()
        numbers["int8_mm_ms"] = cuda_ms(lambda: w2l.int8_matmul(columns, weight), 20)
        activations = torch.randn((16, 250, x_q.shape[2]), device=device)
        numbers["int8_conv_ms"] = cuda_ms(lambda: w2l.int8_conv(
            activations, layer, config.layers[first], torch.float32), 20)
        fp32_conv = transcriber.model.layers[first]
        fp32_input = torch.nn.functional.pad(activations, w2l.same_padding(
            x_q.shape[2], 32, 1))
        with ieee_fp32():
            numbers["fp32_conv_ms"] = cuda_ms(lambda: fp32_conv(fp32_input), 20)
        numbers["model_ms"]["int8"] = cuda_ms(lambda: int8.model(features), 10)
    rows, depth = columns.shape
    numbers["int8_mm_tops"] = 2.0 * rows * depth * weight.shape[1] / numbers["int8_mm_ms"] / 1e9
    print("phase H int8 compute (16 x 8 s, LM beam): big_conv_1/big_conv_2 int32 sums on "
          "the card equal the exact CPU product of the same x_q (bitwise); x_q card vs CPU "
          "differ in {} entries by at most {} step(s); log-probs card vs CPU max {} (limit "
          "{}), vs the weight-only model on the CPU {}; transcripts equal the plain loop's on "
          "the same log-probs, and the CPU int8 model's end to end in {} of {} rows; {:.3f} ms a "
          "batch; big_conv_1's int8 product ({} x {} x {}, cuBLAS torch._int_mm) {:.4f} ms "
          "({:.1f} TOPS), its whole int8 path {:.4f} ms, the fp32 implicit-GEMM conv "
          "{:.4f} ms (TF32 off); model {:.3f} ms; launches {}".format(
              numbers["x_q_differing"], max(numbers["x_q_steps"]), numbers["int8_gap"],
              INT8_LOGPROB_LIMIT, numbers["int8_vs_fp32_gap"],
              numbers["end_to_end_equal"]["int8"], len(texts8), numbers["int8_batch_ms"],
              rows, depth, weight.shape[1], numbers["int8_mm_ms"], numbers["int8_mm_tops"],
              numbers["int8_conv_ms"], numbers["fp32_conv_ms"], numbers["model_ms"]["int8"],
              numbers["launches"]["int8"]), flush=True)

    lap("int8 compute: timings")
    # -- forced alignment ---------------------------------------------------------------
    audio = batch[0]
    frame_log_probs = transcriber.frame_log_probs(audio)
    best = frame_log_probs.argmax(axis=-1)
    greedy = [int(t) for i, t in enumerate(best)
              if t != transcriber.blank_index and (i == 0 or t != best[i - 1])]
    text = transcriber.codec.decode_graphemes(greedy, merge_repeated=False)
    labels = transcriber.codec.encode(text)
    check(len(labels) > 10, "the greedy transcript is too short: {!r}".format(text))
    outputs = []
    for on in (device, torch.device("cpu")):
        outputs.append([x.cpu() for x in ctc_forced_align(
            torch.from_numpy(frame_log_probs[None]).to(on),
            torch.tensor([len(frame_log_probs)], device=on),
            torch.tensor([labels], dtype=torch.int32, device=on),
            torch.tensor([len(labels)], device=on), blank=transcriber.blank_index)])
    (starts, ends, score), (cpu_starts, cpu_ends, cpu_score) = outputs
    check(torch.equal(starts, cpu_starts) and torch.equal(ends, cpu_ends),
          "alignment spans on the card differ from the CPU Viterbi's")
    check(float(score[0]) > -1e29, "the greedy transcript did not align")
    numbers["align_score_gap"] = abs(float(score[0]) - float(cpu_score[0]))
    words = transcriber.align_audio(audio, text)
    start = time.perf_counter()
    words = transcriber.align_audio(audio, text)
    numbers["align_s"] = time.perf_counter() - start
    check(len(words) == len(text.split()), "align_audio gave {} words for {} in the text"
          .format(len(words), len(text.split())))
    print("phase H alignment: 8 s request ({} frames) to its greedy transcript ({} labels, "
          "{} words); spans card == CPU Viterbi; score gap {}; align_audio wall {:.4f} s "
          "(a host-issued frame loop of {} steps and a reverse walk)".format(
              len(frame_log_probs), len(labels), len(words), numbers["align_score_gap"],
              numbers["align_s"], len(frame_log_probs) - 1), flush=True)

    lap("alignment")
    # -- FLAC through the transcribe CLI ------------------------------------------------
    work = lm_directory / "phase-h"
    work.mkdir()
    npz = work / "weights-epoch1.npz"
    np.savez(npz, **{"layer{}.{}".format(i, key): value for i, layer in enumerate(params)
                     for key, value in layer.items()})
    pcm = np.clip(np.round(batch[0] * 32767), -32768, 32767).astype(np.int16)
    wavfile.write(work / "request.wav", 16000, pcm)
    start = time.perf_counter()
    encode_flac(str(work / "request.flac"), [pcm.astype(np.int64).tolist()])
    numbers["flac_encode_s"] = time.perf_counter() - start
    printed = []
    for name in ("request.wav", "request.flac"):  # one file a call: the one-row route
        out = io.StringIO()
        with contextlib.redirect_stdout(out):
            cli(["transcribe", str(work / name), "--checkpoint", str(npz), "--kenlm",
                 str(lm_directory), "--device", str(device)])
        printed += [line.split("\t", 1) for line in out.getvalue().splitlines()]
    direct = transcriber.transcribe_audio(pcm.astype(np.float32) / 32768.0)
    check(len(printed) == 2 and printed[0][1] == printed[1][1] == direct,
          "transcribe printed {} for the wav and the FLAC, the direct call {!r}".format(
              printed, direct))
    print("phase H FLAC: the 8 s request as 16-bit FLAC ({} bytes, encoded in {:.2f} s) and "
          "wav: transcribe prints the same text for both, equal to a direct call: "
          "{!r}".format((work / "request.flac").stat().st_size, numbers["flac_encode_s"],
                        direct[:60]), flush=True)

    lap("FLAC")
    # -- the host pool's beam warm-up ---------------------------------------------------
    pool = StreamingSessionPool(quantized)
    reset()
    pool.warm_up_beam()
    torch.cuda.synchronize()
    numbers["launches"]["warm_up_beam"] = launches()
    check(numbers["launches"]["warm_up_beam"]["lm_beam_span"] == 2
          and numbers["launches"]["warm_up_beam"]["stream_stitch"] == 2,
          "warm_up_beam launched {}".format(numbers["launches"]["warm_up_beam"]))
    server = warm_beam_server(npz, lm_directory, batch[1], device)
    numbers["warm_beam"] = server
    check(WARM_BEAM_KERNELS <= set(server["before"]), "serve --warm-beam loaded {} before "
          "binding (want {})".format(server["before"], sorted(WARM_BEAM_KERNELS)))
    check(not server["after"], "the first beam session's feeds loaded {}".format(
        server["after"]))
    check(bool(server["text"]), "the beam session's final is empty")
    print("phase H serve --warm-beam (a fresh process, host pool, --no-warm-up): kernels "
          "loaded before binding {} (bound {:.2f} s after start); the first /v1/stream beam "
          "session ({} feeds of 0.5 s, p50 {:.4f} s, first {:.4f} s) loaded {}; in process, "
          "warm_up_beam launches {}".format(
              server["before"], server["bound_s"], len(server["feeds_s"]),
              float(np.median(server["feeds_s"])), server["feeds_s"][0],
              server["after"] or "none",
              numbers["launches"]["warm_up_beam"]), flush=True)

    lap("warm-beam")
    # -- a quantized resident device-pool session -----------------------------------------
    reset()
    resident_against_host_pool(quantized, [batch[2]], 8000, [None])
    torch.cuda.synchronize()
    numbers["launches"]["quantized_pools"] = launches()
    check(numbers["launches"]["quantized_pools"]["lm_beam_span"] > 0
          and numbers["launches"]["quantized_pools"]["stream_stitch"] > 0,
          "the quantized pools launched {}".format(numbers["launches"]["quantized_pools"]))
    print("phase H quantized device pool: one resident session equals the host pool's sync "
          "beam on the quantized transcriber; launches of both pools {}".format(
              numbers["launches"]["quantized_pools"]), flush=True)

    lap("quantized pools")
    # -- measure_latency ------------------------------------------------------------------
    numbers["latency"] = {"fp32": transcriber.measure_latency(4.0),
                          "quantized": quantized.measure_latency(4.0),
                          "int8": int8.measure_latency(4.0)}
    print(card)
    lap("measure_latency")
    print("phase H measure_latency(4.0) p50/p95 s (one 4 s request, LM beam): {}; walls (s) "
          "{}".format({name: [round(v, 5) for v in pair]
                       for name, pair in numbers["latency"].items()}, numbers["walls_s"]),
          flush=True)
    return numbers


def phase_h_cli(device, data: Path, run: str) -> None:
    """``transcribe --config english --data-dir --run --epoch 2`` over phase F's run
    prints what ``--checkpoint`` on the same file prints."""
    import contextlib
    import io

    from speechless_tpu_torch.__main__ import main as cli

    files = [str(f) for f in sorted((data / "corpus" / "English").rglob("*.wav"))[:3]]
    printed = []
    for backend in (["--config", "english", "--data-dir", str(data), "--run", run,
                     "--epoch", str(FACADE_EPOCHS)],
                    ["--checkpoint", str(data / "nets" / run / "weights-epoch{}.npz".format(
                        FACADE_EPOCHS))]):
        out = io.StringIO()
        with contextlib.redirect_stdout(out):
            cli(["transcribe", *files, *backend, "--json", "--device", str(device)])
        printed.append([json.loads(line) for line in out.getvalue().splitlines()])
    check(len(printed[0]) == 3 and printed[0] == printed[1],
          "transcribe --run/--epoch printed {}, --checkpoint {}".format(*printed))
    print("phase H transcribe --json --run {} --epoch {} == --checkpoint (texts and "
          "confidences): {}".format(run, FACADE_EPOCHS, [(r["text"][:40], r["confidence"])
                                                         for r in printed[0]]), flush=True)


BUNDLE_CONFIDENCE_TOLERANCE = 1e-4   # bundle vs live confidences and log-probs (fp32)


def bundle_bytes(directory: Path) -> dict:
    """A bundle's bytes: its program files and its weights."""
    return {"programs": sum(f.stat().st_size for f in directory.glob("*.pt2")),
            "weights": sum(f.stat().st_size for f in directory.glob("weights-*.npz"))}


def fresh_bundle_transcribe(directory: Path, files, device) -> dict:
    """``python -X importtime -m speechless_tpu_torch transcribe --bundle --json`` in a
    fresh process: its records, its wall and the port modules it imported."""
    start = time.perf_counter()
    done = subprocess.run(
        [sys.executable, "-X", "importtime", "-m", "speechless_tpu_torch", "transcribe",
         *map(str, files), "--bundle", str(directory), "--json", "--device", str(device)],
        cwd=str(ROOT),
        capture_output=True, text=True, timeout=600)
    wall_s = time.perf_counter() - start
    check(done.returncode == 0, "transcribe --bundle exited {}: {}".format(
        done.returncode, done.stderr[-3000:]))
    imported = {line.rsplit("|", 1)[-1].strip() for line in done.stderr.splitlines()
                if line.startswith("import time:")}
    return {"records": [json.loads(line) for line in done.stdout.splitlines() if line],
            "wall_s": wall_s,
            "port_modules": sorted(m for m in imported
                                   if m.startswith("speechless_tpu_torch"))}


def dispatch_profile(serve, batch) -> dict:
    """One ``serve(batch)`` under `torch.profiler`: the device's busy ms and operations
    (device-side events only, less the program spans' annotations), the host's aten
    operations and the wall in ms."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    serve(batch)
    torch.cuda.synchronize()
    start = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        serve(batch)
        torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - start) * 1e3
    events = prof.events()
    device = [e for e in events if e.device_type == DeviceType.CUDA
              and not getattr(e, "is_user_annotation", False)]
    return {"device_ms": sum(e.time_range.elapsed_us() for e in device) / 1e3,
            "device_ops": len(device),
            "host_aten_ops": sum(1 for e in events if e.device_type == DeviceType.CPU
                                 and e.name.startswith("aten::")),
            "wall_ms": wall_ms}


def issue_split(paths: dict, runs: int) -> dict:
    """For each of ``paths`` (name -> a call that enqueues one dispatch and returns its
    device tensors), the median ms until the call returns (the host issuing the
    dispatch) and until the device has finished it, over ``runs`` calls of each path
    in turns, each started on an idle device."""
    import torch

    times = {name: ([], []) for name in paths}
    for _ in range(runs):
        for name, fn in paths.items():
            torch.cuda.synchronize()
            start = time.perf_counter()
            fn()
            times[name][0].append(time.perf_counter() - start)
            torch.cuda.synchronize()
            times[name][1].append(time.perf_counter() - start)
    return {name: {"issue_ms": float(np.median(issue)) * 1e3,
                   "done_ms": float(np.median(done)) * 1e3}
            for name, (issue, done) in times.items()}


def phase_j(device, card: str, transcriber, batch, lm_directory: Path) -> dict:
    """Export bundles on phase B's full-width transcriber and LM: export the 16 x 8 s
    batch's bucket for cuda, replay it in a fresh ``transcribe --bundle`` process and in
    this one, and hold it to the live path, the plain loop and the live device pool."""
    import scipy.io.wavfile as wavfile
    import torch

    from speechless_tpu_torch.ops import beam_common, decode_lm
    from speechless_tpu_torch.serving_device_stream import DeviceStreamingPool
    from speechless_tpu_torch.serving_export import ExportedTranscriber, export_transcriber
    from speechless_tpu_torch.serving_host import grouped_padded_batches

    numbers = {"launches": {}}
    phase_start = time.perf_counter()
    bucket = transcriber._bucket(len(batch[0]))
    check(all(transcriber._bucket(len(a)) == bucket for a in batch),
          "the 16 x 8 s batch spans more than one bucket")

    def reset():
        torch.cuda.synchronize()
        decode_lm.lm_span.launches = decode_lm.lm_step.launches = 0
        beam_common.beam_backtrace.launches = 0

    def launches():
        torch.cuda.synchronize()
        return {"lm_beam_span": decode_lm.lm_span.launches,
                "beam_backtrace": beam_common.beam_backtrace.launches,
                "lm_beam_step": decode_lm.lm_step.launches}

    with tempfile.TemporaryDirectory() as work:
        work = Path(work)
        directory = work / "bundle"
        start = time.perf_counter()
        export_transcriber(transcriber, directory, platforms=(device.type,),
                           sample_buckets=(bucket,), batch_sizes=(1, 16), streaming=True,
                           device_streaming={"posteriors": True})
        numbers["export_s"] = time.perf_counter() - start
        numbers["bytes"] = bundle_bytes(directory)
        print(card)
        print("phase J export for {}: bucket {} ({} s), batch sizes 1 and 16, streaming, "
              "device-streaming with posteriors: {:.2f} s; bundle bytes: programs {}, "
              "weights {}; manifest lm_fused {}".format(
                  device.type, bucket, bucket / 16000.0, numbers["export_s"],
                  numbers["bytes"]["programs"], numbers["bytes"]["weights"],
                  json.loads((directory / "manifest.json").read_text())["lm_fused"]),
              flush=True)

        # -- a fresh `transcribe --bundle` process: float32 wavs, read back exactly --------
        files = []
        for index, audio in enumerate(batch):
            files.append(work / "utterance{:02d}.wav".format(index))
            wavfile.write(files[-1], 16000, audio.astype(np.float32))
        live = transcriber.transcribe_batch(batch)
        # The fresh process runs beside the in-process checks below (most of its wall is
        # its own start-up and loads), and is read before anything is timed.
        fresh = {}
        fresh_thread = threading.Thread(target=lambda: fresh.update(
            fresh_bundle_transcribe(directory, files, device)))
        fresh_thread.start()

        # -- in process: the batched program against the live path -------------------------
        start = time.perf_counter()
        bundle = ExportedTranscriber(directory, device=device)
        numbers["load_s"] = time.perf_counter() - start
        bundle.transcribe_batch(batch)
        reset()
        replayed = bundle.transcribe_batch(batch)
        numbers["launches"]["batch"] = launches()
        check(numbers["launches"]["batch"] == {"lm_beam_span": 1, "beam_backtrace": 1,
                                               "lm_beam_step": 0},
              "one replayed 16 x 8 s dispatch launched {}".format(
                  numbers["launches"]["batch"]))
        check([text for text, _ in replayed] == [text for text, _ in live],
              "the bundle's transcripts differ from the live ones")
        gap = max(abs(a - b) for (_, a), (_, b) in zip(replayed, live))
        check(gap <= BUNDLE_CONFIDENCE_TOLERANCE, "bundle confidences differ by {}".format(
            gap))
        numbers["confidence_gap"] = gap

        # -- the single programs: posteriors, and tokens against the plain loop ------------
        reset()
        singles = [bundle.transcribe_audio(audio) for audio in batch]
        posteriors = [bundle.frame_log_probs(audio) for audio in batch]
        numbers["launches"]["singles"] = launches()
        check(numbers["launches"]["singles"] == {"lm_beam_span": 16, "beam_backtrace": 16,
                                                 "lm_beam_step": 0},
              "16 single-utterance replays launched {}".format(
                  numbers["launches"]["singles"]))
        numbers["log_prob_gap"] = max(
            float(np.abs(mine - transcriber.frame_log_probs(audio)).max())
            for mine, audio in zip(posteriors, batch))
        check(numbers["log_prob_gap"] <= BUNDLE_CONFIDENCE_TOLERANCE,
              "bundle log-probs differ from the live ones by {}".format(
                  numbers["log_prob_gap"]))
        # The control: the posterior program replayed with TF32 on must fail that limit
        # (no graph records the flags; the loader turns them off around each replay).
        padded = np.zeros((1, bucket), np.float32)
        padded[0, :len(batch[0])] = batch[0]
        saved = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
        torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = True
        try:
            with torch.inference_mode():
                tf32_log_probs, _ = bundle._posterior_programs[bucket].module(
                    bundle.weights, torch.from_numpy(padded).to(device),
                    torch.tensor([len(batch[0])], dtype=torch.int32, device=device))
        finally:
            torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved
        numbers["tf32_log_prob_gap"] = float(np.abs(
            tf32_log_probs[0, :len(posteriors[0])].cpu().numpy() - posteriors[0]).max())
        check(numbers["tf32_log_prob_gap"] > BUNDLE_CONFIDENCE_TOLERANCE,
              "the TF32 control replay is within {} of the fp32 one".format(
                  numbers["tf32_log_prob_gap"]))
        frames = max(len(p) for p in posteriors)
        stacked = np.zeros((len(batch), frames, posteriors[0].shape[1]), np.float32)
        for row, rows in enumerate(posteriors):
            stacked[row, :len(rows)] = rows
        start = time.perf_counter()
        tokens, counts = decode_lm._beam_search(
            torch.from_numpy(stacked).to(device),
            torch.tensor([len(p) for p in posteriors], device=device),
            transcriber.blank_index, transcriber.word_lm, 25, frames, 0.8, 0.0, 2.3, 8,
            step=decode_lm.lm_step_reference)
        numbers["plain_s"] = time.perf_counter() - start
        tokens, counts = tokens.cpu().numpy(), counts.cpu().numpy()
        plain = [transcriber.codec.decode_graphemes(tokens[row, :int(counts[row])].tolist(),
                                                    merge_repeated=False)
                 for row in range(len(batch))]
        check(plain == singles, "the single programs' transcripts {} differ from the plain "
              "loop's on their own posteriors {}".format(singles, plain))
        print("phase J in process: load {:.2f} s; the batched program's 16 texts equal the "
              "live ones (confidences within {:.3g}), one span and one backtrace launch a "
              "dispatch; the 16 single programs' texts equal the plain loop "
              "(lm_span_reference, backtrace_tokens; {:.2f} s) on their posteriors, which "
              "are within {:.3g} of the live log-probs (replayed with TF32 on: {:.3g})"
              .format(numbers["load_s"], gap, numbers["plain_s"], numbers["log_prob_gap"],
                      numbers["tf32_log_prob_gap"]),
              flush=True)

        fresh_thread.join(timeout=600)
        check(bool(fresh), "the fresh transcribe --bundle process did not finish")
        numbers["fresh"] = {key: fresh[key] for key in ("wall_s", "port_modules")}
        check([r["text"] for r in fresh["records"]] == [text for text, _ in live],
              "transcribe --bundle printed {} (live {})".format(
                  [r["text"] for r in fresh["records"]], [text for text, _ in live]))
        fresh_gap = max(abs(r["confidence"] - c)
                        for r, (_, c) in zip(fresh["records"], live))
        check(fresh_gap <= BUNDLE_CONFIDENCE_TOLERANCE, "transcribe --bundle confidences "
              "differ from the live ones by {}".format(fresh_gap))
        model_code = [m for m in fresh["port_modules"] if m.startswith((
            "speechless_tpu_torch.models", "speechless_tpu_torch.features.spectrogram"))
            or m == "speechless_tpu_torch.serving"]
        check(not model_code, "transcribe --bundle imported model code: {}".format(
            model_code))
        print("phase J a fresh `transcribe --bundle --json` of the 16 wavs (float32; run "
              "beside the checks above): {:.2f} s, texts equal to the live "
              "transcribe_batch, confidences within {:.3g}; it imported no model, features "
              "or Transcriber module ({} port modules)".format(
                  fresh["wall_s"], fresh_gap, len(fresh["port_modules"])), flush=True)

        # -- ms per 16 x 8 s dispatch, bundle and live in turns ----------------------------
        runs = 5
        times = {"live": [], "bundle": []}
        for name in ("live", "bundle", "bundle", "live"):
            serve = (transcriber if name == "live" else bundle).transcribe_batch
            torch.cuda.synchronize()
            start = time.perf_counter()
            for _ in range(runs):
                serve(batch)
            torch.cuda.synchronize()
            times[name].append((time.perf_counter() - start) / runs * 1e3)
        numbers["ms"] = times
        numbers["profile"] = {name: dispatch_profile(serve, batch) for name, serve in (
            ("live", transcriber.transcribe_batch), ("bundle", bundle.transcribe_batch))}
        _, wavs, lengths = next(grouped_padded_batches(batch, transcriber._bucket, 16))

        def live_dispatch():
            with torch.inference_mode():
                return transcriber._decode(*transcriber._log_probs(wavs, lengths))

        numbers["issue"] = issue_split({
            "live": live_dispatch,
            "bundle": lambda: bundle.replay(bundle._batch_programs[(bucket, 16)], wavs,
                                            lengths)}, runs=10)
        print(card)
        print("phase J ms per 16 x 8 s dispatch (host clock after a sync, {} a turn, turns "
              "live, bundle, bundle, live): bundle {}, live {}; one dispatch each under "
              "torch.profiler: {}; the device tensors of a dispatch without the host's "
              "fetch, medians of 10 in turns, ms until the call returns (the host's issue) "
              "and until the device is done: {}".format(
                  runs, [round(t, 4) for t in times["bundle"]],
                  [round(t, 4) for t in times["live"]], json.dumps(numbers["profile"]),
                  json.dumps(numbers["issue"])), flush=True)

        # -- the device pool over the bundle against the live pool -------------------------
        reset()
        finals = {}
        for name, backend in (("live", transcriber), ("bundle", bundle)):
            pool = DeviceStreamingPool(backend, window_s=8.0, margin_s=2.0)
            pool.start()
            try:
                finals[name] = pool.create_stream().transcribe_stream(batch[3], 8000)
            finally:
                pool.stop()
        numbers["launches"]["pools"] = launches()
        check(finals["bundle"] == finals["live"] and bool(finals["live"]),
              "the bundle pool's final {!r} != the live pool's {!r}".format(
                  finals["bundle"], finals["live"]))
        try:
            DeviceStreamingPool(bundle, beam_mode="resident")
            check(False, "a bundle pool took beam_mode='resident'")
        except ValueError as error:
            check("resident" in str(error), "resident refusal: {}".format(error))
        print("phase J device pool over the bundle (its baked 8 s window, 64 sessions, <= "
              "16 rows a dispatch, posterior mode): one greedy session fed 8 s in 0.5 s "
              "chunks gives the live pool's final ({} chars); beam_mode='resident' "
              "refused".format(
                  len(finals["live"])), flush=True)

        # -- a cpu bundle on the card -----------------------------------------------------
        cpu_only = work / "cpu-bundle"
        cpu_only.mkdir()
        manifest = json.loads((directory / "manifest.json").read_text())
        manifest["platforms"] = ["cpu"]
        (cpu_only / "manifest.json").write_text(json.dumps(manifest))
        try:
            ExportedTranscriber(cpu_only, device=device)
            check(False, "a cpu bundle loaded on the card")
        except ValueError as error:
            check("exported for platforms" in str(error), "cpu refusal: {}".format(error))
    numbers["wall_s"] = time.perf_counter() - phase_start
    print("phase J a cpu-only bundle is refused on the card; phase J {:.1f} s".format(
        numbers["wall_s"]), flush=True)
    return numbers


# ---- phase K: parallelism (a world of one on NCCL, two processes sharing the card) --------
K_TP_LOGITS_TOL = 1e-4   # TP=2 logits vs the unsplit model, absolute (fp32)
K_SP_LOGITS_TOL = 1e-5   # sequence-parallel n=2 logits vs the unsplit forward, absolute
K_RECORDING_S = 60.0     # the sequence-parallel recording
K_WORKER_TIMEOUT_S = 400


def k_recording(seconds: float) -> np.ndarray:
    """A seeded recording of tones under a slow envelope, with noise (phase B's kind)."""
    rng = np.random.default_rng(SEED + 9)
    t = np.arange(int(seconds * 16000)) / 16000.0
    tones = sum(0.2 * np.sin(2 * np.pi * f * t + p) for f, p in
                zip(rng.uniform(100, 3000, 4), rng.uniform(0, 6, 4)))
    return (tones * (0.5 + 0.5 * np.sin(2 * np.pi * 0.7 * t))
            + 0.05 * rng.normal(size=t.size)).astype(np.float32)


def bench_features(rng, config, device):
    """`bench.py`'s batch as features: (64, 1025, 128) fp32, its labels and lengths."""
    import torch

    from speechless_tpu_torch.features.spectrogram import features_batch
    from speechless_tpu_torch.train import trainer

    wavs = torch.tensor(rng.normal(size=(BENCH_BATCH, BENCH_SAMPLES)) * 0.1,
                        dtype=torch.float32, device=device)
    lengths = torch.full((BENCH_BATCH,), BENCH_SAMPLES, dtype=torch.int32, device=device)
    features, frames = features_batch(wavs, lengths)
    labels = torch.tensor(rng.integers(0, config.grapheme_set_size - 1,
                                       (BENCH_BATCH, BENCH_LABELS)),
                          dtype=torch.int32, device=device)
    return trainer.Batch(features, frames, labels,
                         torch.full((BENCH_BATCH,), BENCH_LABELS, dtype=torch.int32,
                                    device=device))


def phase_k1(device, card: str, train: Optional[dict], data: Path, backend: str) -> dict:
    """A world of one process (``backend``: NCCL on the card) through the real entry
    points: `distributed_init`, `make_mesh`, the data-parallel step at `bench.py`'s
    batch in bf16 (k=10 a call; the gradient all-reduce over one rank) timed in turns
    with the plain step, one fp32 step bitwise the plain step's, and `Wav2Letter(mesh=)`
    training one facade epoch on phase F's corpus, whose checkpoint a single-process
    `Wav2Letter` loads exactly."""
    import torch
    import torch.distributed as dist

    from speechless_tpu_torch.configuration import Configuration, DataDirectories
    from speechless_tpu_torch.models import wav2letter as w2l
    from speechless_tpu_torch.ops import ctc_kernels
    from speechless_tpu_torch.parallel import distributed_init, make_mesh
    from speechless_tpu_torch.parallel.distributed import free_port
    from speechless_tpu_torch.parallel.mesh import collectives
    from speechless_tpu_torch.system import Wav2Letter
    from speechless_tpu_torch.text.charsets import english_frequent_characters
    from speechless_tpu_torch.train import trainer

    distributed_init(backend, "tcp://localhost:{}".format(free_port()), 1, 0,
                     device_type=device.type)
    check(dist.get_world_size() == 1, "phase K1 wants a world of one")
    mesh = make_mesh(1, device_type=device.type)
    numbers = {}
    try:
        rng = np.random.default_rng(SEED + 3)
        config = w2l.Wav2LetterConfig(128, 29, compute_dtype=torch.bfloat16)
        optimizer = trainer.make_optimizer(1e-4)
        params = w2l.init_params(config, SEED)
        batch = bench_wav_batch(rng, config, BENCH_STEPS, device)
        states = {name: trainer.init_train_state(config, optimizer, params=params,
                                                 device=device,
                                                 mesh=mesh if name == "mesh" else None)
                  for name in ("plain", "mesh")}
        multi_step = trainer.make_multi_wav_step(config, optimizer, device=device)
        for name in states:  # warm-up calls
            states[name], _ = multi_step(states[name], batch)
        ms = {"plain": [], "mesh": []}
        for name in ("plain", "mesh", "mesh", "plain"):
            ctc_kernels.ctc_alpha.launches = ctc_kernels.ctc_beta_grad.launches = 0
            torch.cuda.synchronize()
            start = time.perf_counter()
            with collectives.recording() as events:
                states[name], metrics = multi_step(states[name], batch)
            torch.cuda.synchronize()
            ms[name].append((time.perf_counter() - start) / BENCH_STEPS * 1e3)
            if name == "mesh":
                numbers["launches"] = {"ctc_alpha": ctc_kernels.ctc_alpha.launches,
                                       "ctc_beta_grad": ctc_kernels.ctc_beta_grad.launches}
                numbers["all_reduces"] = sum(1 for op, axis, _ in events
                                             if (op, axis) == ("all_reduce", "data"))
                check(bool(torch.isfinite(metrics["step_losses"]).all()),
                      "phase K1: a non-finite loss on the mesh")
        check(numbers["launches"] == {"ctc_alpha": BENCH_STEPS, "ctc_beta_grad": BENCH_STEPS},
              "phase K1: {} mesh steps launched the CTC kernels {}".format(
                  BENCH_STEPS, numbers["launches"]))
        check(numbers["all_reduces"] == BENCH_STEPS, "phase K1: {} data all-reduces in {} "
              "steps".format(numbers["all_reduces"], BENCH_STEPS))
        numbers["ms"] = ms
        print("phase K1 ({}; {} world of 1): make_multi_wav_step at B={} x {} samples, "
              "bf16, k={}, ms per step in turns plain {:.2f}, mesh {:.2f}, mesh {:.2f}, "
              "plain {:.2f} (phase C: {}); ctc_alpha/ctc_beta_grad launches {}/{} and {} "
              "gradient all-reduces in one mesh call".format(
                  card, backend, BENCH_BATCH, BENCH_SAMPLES, BENCH_STEPS, ms["plain"][0],
                  ms["mesh"][0], ms["mesh"][1], ms["plain"][1],
                  "{:.2f}".format(train["ms_per_step"]) if train else "not run",
                  numbers["launches"]["ctc_alpha"], numbers["launches"]["ctc_beta_grad"],
                  numbers["all_reduces"]))

        # One fp32 step with deterministic cuDNN algorithms: the all-reduce over one
        # rank (a sum of one, divided by one) must leave the step bitwise the plain one.
        config32 = w2l.Wav2LetterConfig(128, 29)
        one = bench_wav_batch(np.random.default_rng(SEED + 4), config32, 1, device)
        stepped = {}
        saved = torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark
        torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = True, False
        try:
            for name in ("plain", "mesh"):
                state = trainer.init_train_state(config32, optimizer, params=params,
                                                 device=device,
                                                 mesh=mesh if name == "mesh" else None)
                state, metrics = trainer.make_multi_wav_step(config32, optimizer,
                                                             device=device)(state, one)
                stepped[name] = (float(metrics["loss"]), state.params)
        finally:
            torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = saved
        equal = [np.array_equal(a[key], b[key]) for a, b in zip(stepped["plain"][1],
                                                                  stepped["mesh"][1])
                 for key in a]
        check(stepped["plain"][0] == stepped["mesh"][0] and all(equal),
              "phase K1: the fp32 mesh step differs from the plain step (loss {} vs {}, "
              "{} of {} tensors equal)".format(stepped["mesh"][0], stepped["plain"][0],
                                               sum(equal), len(equal)))
        print("phase K1 ({}): one fp32 step at the bench batch on the mesh: loss {} and all "
              "{} parameter tensors bitwise the plain step's".format(
                  card, stepped["mesh"][0], len(equal)))

        configuration = Configuration.english(DataDirectories(data))
        configuration.batch_size = FACADE_BATCH
        configuration.training_batches_per_epoch = FACADE_BATCHES
        facade = Wav2Letter(128, english_frequent_characters, mesh=mesh, device=device)
        ctc_kernels.ctc_alpha.launches = ctc_kernels.ctc_beta_grad.launches = 0
        start = time.perf_counter()
        configuration.train(facade, "parallel-world-1", epoch_limit=1)
        torch.cuda.synchronize()
        numbers["facade_s"] = time.perf_counter() - start
        numbers["facade_launches"] = {"ctc_alpha": ctc_kernels.ctc_alpha.launches,
                                      "ctc_beta_grad": ctc_kernels.ctc_beta_grad.launches}
        check(numbers["facade_launches"]["ctc_beta_grad"] == FACADE_BATCHES,
              "phase K1: the mesh facade's epoch launched the backward {} times".format(
                  numbers["facade_launches"]["ctc_beta_grad"]))
        loaded = Wav2Letter(128, english_frequent_characters, device=device,
                            load_model_from_directory=configuration.directories
                            .nets_base_directory / "parallel-world-1", load_epoch=1)
        check(loaded.mesh is None and loaded.state.step == facade.state.step == FACADE_BATCHES,
              "phase K1: the single-process load (mesh {}, step {})".format(
                  loaded.mesh, loaded.state.step))
        same = all(np.array_equal(a[key], b[key]) for a, b in zip(loaded.params,
                                                                  facade.params) for key in a)
        leaves = all(np.array_equal(a, b) for a, b in zip(loaded.state.opt_state.leaves(),
                                                          facade.state.opt_state.leaves()))
        check(same and leaves, "phase K1: the checkpoint does not load back exactly")
        print("phase K1 ({}): Wav2Letter(mesh=) trained 1 epoch of {} batches of {} on phase "
              "F's corpus in {:.2f} s (ctc_alpha/ctc_beta_grad launches {}), checkpointed; "
              "a single-process Wav2Letter loads it with its parameters, optimizer leaves "
              "and step exactly".format(card, FACADE_BATCHES, FACADE_BATCH,
                                        numbers["facade_s"],
                                        tuple(numbers["facade_launches"].values())))
    finally:
        dist.destroy_process_group()
    return numbers


def phase_k2(device, card: str, batch) -> dict:
    """Two processes on the one card over gloo (NCCL refuses two ranks on one GPU):
    each runs `phase_k2_worker` and writes its numbers; both must pass their checks."""
    from speechless_tpu_torch.lm.arpa_builder import build_kenlm_directory
    from speechless_tpu_torch.parallel.distributed import free_port
    from speechless_tpu_torch.serving import CHARSETS

    with tempfile.TemporaryDirectory() as directory:
        directory = Path(directory)
        build_kenlm_directory(readme_sentences(), directory / "lm",
                              allowed_characters=CHARSETS["english"])
        np.save(directory / "batch.npy", np.stack(batch))
        port = free_port()
        start = time.perf_counter()
        workers = [subprocess.Popen(
            [sys.executable, str(ROOT / "chip_smoke.py"), "--k2-worker", str(rank),
             str(port), str(directory), device.type], cwd=str(ROOT),
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
            for rank in range(2)]
        outputs = []
        try:
            for worker in workers:
                outputs.append(worker.communicate(timeout=K_WORKER_TIMEOUT_S)[0])
        finally:
            for worker in workers:
                if worker.poll() is None:
                    worker.kill()
                    worker.communicate()
        wall = time.perf_counter() - start
        for rank, out in enumerate(outputs):
            for line in out.splitlines():
                print("phase K2 rank {}: {}".format(rank, line))
        check(all(worker.returncode == 0 for worker in workers),
              "phase K2: a worker failed (exit codes {})".format(
                  [worker.returncode for worker in workers]))
        results = [json.loads((directory / "k2-rank{}.json".format(rank)).read_text())
                   for rank in range(2)]
    check(results[0]["step_losses"] == results[1]["step_losses"],
          "phase K2: the step losses differ across ranks: {}".format(
              [r["step_losses"] for r in results]))
    launches = {name: sum(r["launches"][name] for r in results)
                for name in results[0]["launches"]}
    print("phase K2 ({}): 2 processes on one card over gloo in {:.1f} s; TP=2 logits max "
          "|diff| {:.3g} (limit {}), gradients rel L2 <= {:.3g} (limit {}); DP x TP step "
          "losses {} equal on both ranks; sequence-parallel n=2 logits of {:.0f} s max "
          "|diff| {:.3g} (limit {}), LM text equal; Transcriber(mesh=) texts equal; "
          "launches over both ranks {}".format(
              card, wall, max(r["tp_logits_err"] for r in results), K_TP_LOGITS_TOL,
              max(r["tp_grad_rel_l2"] for r in results), FP32_GRAD_RTOL,
              results[0]["step_losses"], K_RECORDING_S,
              max(r["sp_logits_err"] for r in results), K_SP_LOGITS_TOL, launches))
    return {"wall_s": wall, "launches": launches, "results": results}


def phase_k2_worker(rank: int, port: int, directory: Path, device_type: str) -> None:
    """One rank of phase K2 (a process of its own): the TP=2 forward and backward at
    full width on the bench batch against the unsplit model, one DP step and one TP
    step, the sequence-parallel n=2 forward and LM decode of a 60 s recording against
    the unsplit ones, and `Transcriber(mesh=)` on phase B's batch against the plain
    Transcriber."""
    import torch
    import torch.distributed as dist

    from speechless_tpu_torch.features.spectrogram import features_batch
    from speechless_tpu_torch.models import wav2letter as w2l
    from speechless_tpu_torch.ops import beam_common, ctc_kernels, decode_lm
    from speechless_tpu_torch.parallel import distributed_init, make_mesh
    from speechless_tpu_torch.parallel import mesh as pmesh
    from speechless_tpu_torch.parallel.sequence import sequence_parallel_logits
    from speechless_tpu_torch.serving import CHARSETS, Transcriber
    from speechless_tpu_torch.train import trainer

    device = distributed_init("gloo", "tcp://localhost:{}".format(port), 2, rank,
                              device_type=device_type)
    out = {"launches": {"ctc_alpha": 0, "ctc_beta_grad": 0, "lm_beam_span": 0,
                        "beam_backtrace": 0}}

    def count(name, launches):
        out["launches"][name] += launches

    def rel(got, want):
        return float(torch.linalg.vector_norm(got - want) / torch.linalg.vector_norm(want))

    # The TP=2 forward and backward in fp32 against the unsplit model.
    tp_mesh = make_mesh(2, device_type=device_type)
    split = pmesh.model_split(tp_mesh)
    config = w2l.Wav2LetterConfig(128, 29)
    params = w2l.init_params(config, SEED)
    batch = bench_features(np.random.default_rng(SEED + 7), config, device)
    unsplit = w2l.build_model(config, params, device=device).train()
    tp = w2l.build_model(config, pmesh.shard_params(params, pmesh.param_specs(
        config.layer_names), split.rank, split.size), device=device,
        tensor_parallel=split).train()
    ctc_kernels.ctc_alpha.launches = ctc_kernels.ctc_beta_grad.launches = 0
    for model in (unsplit, tp):
        loss, _ = trainer.loss_fn(config, model, batch)
        loss.backward()
    count("ctc_alpha", ctc_kernels.ctc_alpha.launches)
    count("ctc_beta_grad", ctc_kernels.ctc_beta_grad.launches)
    with torch.no_grad():
        out["tp_logits_err"] = float((tp(batch.inputs) - unsplit(batch.inputs)).abs().max())
    out["tp_grad_rel_l2"] = max(
        rel(tp.full_tensor(p, p.grad), q.grad)
        for conv, reference in zip(tp.layers, unsplit.layers)
        for p, q in ((conv.weight, reference.weight), (conv.bias, reference.bias)))
    check(out["tp_logits_err"] <= K_TP_LOGITS_TOL, "rank {}: TP logits differ by {}".format(
        rank, out["tp_logits_err"]))
    check(out["tp_grad_rel_l2"] <= FP32_GRAD_RTOL, "rank {}: TP gradients differ by {} rel "
          "L2".format(rank, out["tp_grad_rel_l2"]))
    print("TP=2 at the bench batch (fp32): logits max |diff| {:.3g}, gradients rel L2 <= "
          "{:.3g} against the unsplit model".format(out["tp_logits_err"],
                                                    out["tp_grad_rel_l2"]))
    del unsplit, tp, batch

    # One bf16 step on each mesh: DP (each rank on half the rows) and TP.
    config16 = w2l.Wav2LetterConfig(128, 29, compute_dtype=torch.bfloat16)
    out["step_losses"] = {}
    wav_batch = bench_wav_batch(np.random.default_rng(SEED + 8), config16, 1, device)
    for name, parallelism in (("dp", 1), ("tp", 2)):
        mesh = make_mesh(parallelism, device_type=device_type)
        rows = pmesh.batch_rows(mesh, BENCH_BATCH)
        local = trainer.WavBatch(*(field[:, rows] for field in wav_batch))
        optimizer = trainer.make_optimizer(1e-4)
        state = trainer.init_train_state(config16, optimizer, params=params, device=device,
                                         mesh=mesh)
        ctc_kernels.ctc_alpha.launches = ctc_kernels.ctc_beta_grad.launches = 0
        state, metrics = trainer.make_multi_wav_step(config16, optimizer, device=device)(
            state, local)
        count("ctc_alpha", ctc_kernels.ctc_alpha.launches)
        count("ctc_beta_grad", ctc_kernels.ctc_beta_grad.launches)
        out["step_losses"][name] = float(metrics["loss"])
        check(np.isfinite(out["step_losses"][name]), "rank {}: a non-finite {} step "
              "loss".format(rank, name))
    print("one bf16 step at the bench batch: DP (2 x 1) loss {}, TP (1 x 2) loss {}".format(
        out["step_losses"]["dp"], out["step_losses"]["tp"]))

    # Sequence parallelism over the data axis (n=2) of a 60 s recording, with the LM.
    alphabet = CHARSETS["english"]
    serve_config = w2l.Wav2LetterConfig(128, len(alphabet) + 1)
    serve_params = serving_params(serve_config)
    transcriber = Transcriber(serve_config, serve_params, alphabet, device=device,
                              kenlm_directory=directory / "lm")
    data_mesh = make_mesh(1, device_type=device_type)
    recording = k_recording(K_RECORDING_S)
    bucket = -(-len(recording) // transcriber._SP_BUCKET_SAMPLES) \
        * transcriber._SP_BUCKET_SAMPLES
    wav = np.zeros((1, bucket), np.float32)
    wav[0, :len(recording)] = recording
    with torch.inference_mode():
        features, frames = features_batch(torch.from_numpy(wav).to(device), torch.tensor(
            [len(recording)], dtype=torch.int32, device=device))
        split_logits = sequence_parallel_logits(transcriber.model, features, data_mesh)
        # The split forward zero-pads the frames to 2 chunks of a multiple of the
        # stride ratio, as JAX's does: the unsplit reference runs on the same frames.
        padded = torch.nn.functional.pad(features, (0, 0, 0, split_logits.shape[1] * 2
                                                    - features.shape[1]))
        whole = transcriber.model(padded)
        out["sp_logits_err"] = float((split_logits - whole).abs().max())
        # What the padding moves: the recording's last frames against the forward on
        # the unpadded frames (JAX's padding does the same; ROADMAP.md section 3).
        counts = w2l.prediction_lengths(serve_config, frames)
        unpadded = transcriber.model(features)[:, :int(counts[0])]
        out["sp_padding_shift"] = float(
            (split_logits[:, :int(counts[0])] - unpadded).abs().max())
        tokens, counts, _ = transcriber._decode(torch.log_softmax(whole, dim=-1), counts)
        want = transcriber.codec.decode_graphemes(tokens[0, :int(counts[0])].tolist(),
                                                  merge_repeated=False)
    decode_lm.lm_span.launches = beam_common.beam_backtrace.launches = 0
    got = transcriber.transcribe_long_audio(recording, sequence_parallel=True, mesh=data_mesh)
    sp_launches = (decode_lm.lm_span.launches, beam_common.beam_backtrace.launches)
    count("lm_beam_span", sp_launches[0])
    count("beam_backtrace", sp_launches[1])
    check(out["sp_logits_err"] <= K_SP_LOGITS_TOL, "rank {}: sequence-parallel logits "
          "differ by {}".format(rank, out["sp_logits_err"]))
    check(got == want and len(got) > 0, "rank {}: the sequence-parallel text differs from "
          "the unsplit one ({} vs {} characters)".format(rank, len(got), len(want)))
    check(device_type != "cuda" or sp_launches == (1, 1), "rank {}: the sequence-parallel "
          "decode launched the span and backtrace kernels {} times".format(rank, sp_launches))
    print("sequence-parallel n=2, {:.0f} s in a {}-sample bucket: logits {} max |diff| "
          "{:.3g} against the unsplit forward on the same padded frames ({:.3g} on the "
          "recording's frames against the forward on the unpadded frames); LM text ({} "
          "characters) equal to the unsplit decode's; span/backtrace launches {}".format(
              K_RECORDING_S, bucket, tuple(whole.shape), out["sp_logits_err"],
              out["sp_padding_shift"], len(got), sp_launches))

    # Transcriber(mesh=) on phase B's 16 x 8 s batch against the plain Transcriber.
    audios = list(np.load(directory / "batch.npy"))
    want_texts = [text for text, _ in transcriber.transcribe_batch(audios)]
    served = Transcriber(serve_config, serve_params, alphabet, device=device,
                         kenlm_directory=directory / "lm", mesh=data_mesh)
    decode_lm.lm_span.launches = beam_common.beam_backtrace.launches = 0
    texts = [text for text, _ in served.transcribe_batch(audios)]
    mesh_launches = (decode_lm.lm_span.launches, beam_common.beam_backtrace.launches)
    count("lm_beam_span", mesh_launches[0])
    count("beam_backtrace", mesh_launches[1])
    check(texts == want_texts, "rank {}: Transcriber(mesh=) texts differ in {} of {} "
          "rows".format(rank, sum(a != b for a, b in zip(texts, want_texts)), len(texts)))
    check(device_type != "cuda" or mesh_launches == (1, 1), "rank {}: the mesh batch "
          "launched the span and backtrace kernels {} times".format(rank, mesh_launches))
    print("Transcriber(mesh=) on 16 x 8 s: this rank decoded 8 rows, all 16 texts equal "
          "the plain Transcriber's; span/backtrace launches {}".format(mesh_launches))
    (directory / "k2-rank{}.json".format(rank)).write_text(json.dumps(out))
    dist.destroy_process_group()


def phase_k(device, card: str, train: Optional[dict], data: Path, batch) -> dict:
    """Phase K: K1 (a world of one on NCCL) and K2 (two processes on the card)."""
    start = time.perf_counter()
    k1 = phase_k1(device, card, train, data, "nccl")
    k2 = phase_k2(device, card, batch)
    wall = time.perf_counter() - start
    print("phase K ({}): {:.1f} s".format(card, wall))
    return {"k1": k1, "k2": k2, "wall_s": wall}


# ---- phase L: the conv data-gradient kernel -----------------------------------------
BF16_OPS_PER_S = 989e12
# (name, batch, frames, out channels, in channels, taps): big_conv_1 at the training
# cell's frames, bench.py's, the raw-wave model's, and a tensor-parallel rank's width;
# then an inner conv, whose two times set the width rule (`conv_dgrad.KERNEL_MIN_TAPS`).
DGRAD_SHAPES = (("big_conv_1 cell", 64, 1536, 2000, 250, 32),
                ("big_conv_1 bench", 64, 513, 2000, 250, 32),
                ("big_conv_1 raw wave", 64, 410, 2000, 250, 32),
                ("big_conv_1 TP rank", 64, 1536, 1000, 250, 32),
                ("inner_conv cell", 64, 1536, 250, 250, 7))
# Edges: one frame, fewer frames than taps, odd frames and channels, a frame past the
# 128-frame tile, input channels far below 256.
DGRAD_EDGES = ((3, 1, 37, 250, 32), (2, 5, 2000, 250, 32), (3, 37, 37, 250, 7),
               (2, 129, 100, 17, 9), (1, 300, 64, 250, 32))
# Kernel vs the plain version, both in the working type: each sums in fp32 in its own
# order and rounds once to bf16, so a sum near a rounding boundary may round to the
# neighbouring bf16 value: one ulp, at most 2^-7 of the value; plus the two fp32 sums'
# difference. The tensor cores add each group of products after aligning them to the
# largest, truncating, so over big_conv_1's 64,000 terms the kernel's sum drifts from the
# plain version's by up to ~4e-5 of the largest |dX| (a fifth of a bf16 ulp of it; on an
# H100, 3 % of the values round to the neighbour); cuDNN's legacy engine drifts further
# (72 %). A dropped tap, frame or channel block moves values by a tenth of the
# largest or more.
DGRAD_RTOL, DGRAD_ATOL = 2.0 ** -7, 1e-4
DGRAD_STEPS = 4  # steps a call of `resident_step_launches`


def dgrad_case(rng, batch, frames, cout, cin, taps, device):
    """Seeded bf16 output gradient ``(B, Cout, T)`` and weight ``(Cout, Cin, K)``
    (Glorot-scaled, as the model's)."""
    import torch

    grad = torch.tensor(rng.normal(size=(batch, cout, frames)), dtype=torch.bfloat16,
                        device=device)
    limit = math.sqrt(6.0 / (taps * (cin + cout)))
    weight = torch.tensor(rng.uniform(-limit, limit, (cout, cin, taps)),
                          dtype=torch.bfloat16, device=device)
    return grad, weight


def dgrad_gaps(got, want) -> dict:
    """How far the kernel's bf16 ``got`` lies from the plain version's ``want``: the worst
    excess over the limit (<= 0 passes), the share of values that differ, and the largest
    difference over the largest |dX|."""
    import torch

    got, want = got.float(), want.float()
    diff = (got - want).abs()
    scale = float(want.abs().max())
    limit = DGRAD_RTOL * torch.maximum(got.abs(), want.abs()) + DGRAD_ATOL * scale
    return {"excess": float((diff - limit).max()), "differ": float((diff > 0).float().mean()),
            "max_abs": float(diff.max()), "max_rel": float(diff.max()) / max(scale, 1e-30)}


def phase_l(device, card: str) -> dict:
    """Phase L: the conv data-gradient kernel (`ops/conv_dgrad.py`, ``csrc/conv_dgrad.cu``)
    against its plain version `dgrad_reference` on the same CUDA tensors (bf16 dX within
    DGRAD_RTOL of each value and DGRAD_ATOL of the largest) at the edges and at the main
    path's shapes; cuDNN's bf16 data gradient beside it as a second reading. Then at
    each of DGRAD_SHAPES: the kernel's ms (the wrapper's whole call: weight layout, frame
    padding and the launch), its bound (FLOPs over 989 TFLOP/s bf16, or bytes of dY, W
    and dX over 3.35 TB/s), the plain version's ms (fp32 einsums, TF32 off) and cuDNN's
    (`library_ms`: ``aten.convolution_backward`` for the data gradient alone on the
    padded input, the call the port no longer makes for a routed conv). Last, the
    launches and trace counters of `make_device_epoch_step` at the training cell's
    batch (64 rows of 3,072 frames) in bf16, the full step and freeze 8, and the
    full step's ms."""
    import torch

    from speechless_tpu_torch.ops import conv_dgrad
    from speechless_tpu_torch.precision import ieee_fp32

    start = time.perf_counter()
    rng = np.random.default_rng(SEED + 12)

    def plain(grad, weight, pad_low):
        with ieee_fp32():
            return conv_dgrad.dgrad_reference(grad, weight, pad_low)

    def cudnn(grad, padded, weight):
        return torch.ops.aten.convolution_backward(
            grad, padded, weight, None, [1], [0], [1], False, [0], 1,
            [True, False, False])[0]

    cases = [("edge", *edge) for edge in DGRAD_EDGES] + list(DGRAD_SHAPES)
    results = {}
    for name, batch, frames, cout, cin, taps in cases:
        grad, weight = dgrad_case(rng, batch, frames, cout, cin, taps, device)
        pad_low = (taps - 1) // 2
        got = conv_dgrad.conv_dgrad(grad, weight, pad_low)
        torch.cuda.synchronize()
        want = plain(grad, weight, pad_low)
        padded = torch.nn.functional.pad(
            torch.zeros((batch, cin, frames), dtype=torch.bfloat16, device=device),
            (pad_low, taps - 1 - pad_low))
        library = cudnn(grad, padded, weight)[:, :, pad_low:pad_low + frames]
        gaps = dgrad_gaps(got, want)
        gaps["cudnn"] = dgrad_gaps(library, want)
        key = "{} {}x{}x{}->{} k{}".format(name, batch, frames, cout, cin, taps)
        results[key] = gaps
        print("phase L {}: kernel vs plain excess {:.3g} (<= 0 passes), {:.4f} of values "
              "differ, max {:.3g} of max|dX|; cuDNN vs plain excess {:.3g}, differ {:.4f}, "
              "max {:.3g}".format(key, gaps["excess"], gaps["differ"], gaps["max_rel"],
                                  gaps["cudnn"]["excess"], gaps["cudnn"]["differ"],
                                  gaps["cudnn"]["max_rel"]), flush=True)
        del got, want, library, padded
    for key, gaps in results.items():
        check(gaps["excess"] <= 0, "conv_dgrad {} differs from dgrad_reference beyond one "
              "bf16 ulp: excess {:.3g}".format(key, gaps["excess"]))

    timings = {}
    for name, batch, frames, cout, cin, taps in DGRAD_SHAPES:
        grad, weight = dgrad_case(rng, batch, frames, cout, cin, taps, device)
        pad_low = (taps - 1) // 2
        padded = torch.nn.functional.pad(
            torch.zeros((batch, cin, frames), dtype=torch.bfloat16, device=device),
            (pad_low, taps - 1 - pad_low))
        flops = 2.0 * batch * frames * cout * cin * taps
        nbytes = 2.0 * (batch * cout * frames + cout * cin * taps + batch * cin * frames)
        bound_ms = max(flops / BF16_OPS_PER_S, nbytes / HBM_BYTES_PER_S) * 1e3
        ms = cuda_ms(lambda: conv_dgrad.conv_dgrad(grad, weight, pad_low), 20)
        layout_ms = cuda_ms(lambda: conv_dgrad.weight_layout(weight), 20)  # of ms
        library_ms = cuda_ms(lambda: cudnn(grad, padded, weight), 10)
        plain_ms = cuda_ms(lambda: plain(grad, weight, pad_low), 2)
        timings[name] = {"shape": [batch, frames, cout, cin, taps], "ms": ms,
                         "layout_ms": layout_ms, "bound_ms": bound_ms,
                         "bound_by": "operations",
                         "plain_ms": plain_ms, "library_ms": library_ms,
                         "tflops": flops / ms / 1e9, "library_tflops": flops / library_ms / 1e9}
        print("phase L {} ({}): kernel {:.4f} ms ({:.1f} TFLOP/s; W's layout {:.4f} of "
              "it), bound {:.4f} ms, plain {:.2f} ms, cuDNN {:.4f} ms ({:.1f} "
              "TFLOP/s)".format(name, card, ms, flops / ms / 1e9, layout_ms, bound_ms,
                                plain_ms, library_ms, flops / library_ms / 1e9), flush=True)
        del grad, weight, padded
    torch.cuda.empty_cache()
    steps = resident_step_launches(device)
    wall = time.perf_counter() - start
    print("phase L ({}): {:.1f} s".format(card, wall))
    return {"gaps": results, "timings": timings, "steps": steps, "wall_s": wall}


def resident_step_launches(device) -> dict:
    """`make_device_epoch_step` at the training cell's batch (64 rows of 3,072 frames,
    bf16) on a 256-row resident corpus: the kernel's launches in one call of
    DGRAD_STEPS steps and the trace counters ``conv.dgrad_kernel`` and
    ``conv.dgrad_cudnn`` under a profiler, for the full step and for freeze 8 (no data
    gradient below big_conv_1: no launch); then the full step's ms, CUDA events."""
    import torch

    from speechless_tpu_torch.data.device_dataset import DeviceDataset
    from speechless_tpu_torch.models import wav2letter as w2l
    from speechless_tpu_torch.ops import conv_dgrad
    from speechless_tpu_torch.train import trainer
    from speechless_tpu_torch.utils import trace

    rows, frames, labels = 256, USER_FRAMES, USER_LABELS
    generator = torch.Generator(device=device).manual_seed(SEED)
    lengths = torch.randint(frames // 3, frames + 1, (rows,), generator=generator,
                            device=device, dtype=torch.int32)
    inputs = torch.randn((rows, frames, 128), generator=generator, device=device,
                         dtype=torch.float16)
    inputs.masked_fill_(torch.arange(frames, device=device)[None, :, None]
                        >= lengths[:, None, None], 0.0)
    label_lengths = (lengths // 8).to(torch.int32)
    label_rows = torch.randint(0, 28, (rows, labels), generator=generator, device=device,
                               dtype=torch.int32)
    label_rows.masked_fill_(torch.arange(labels, device=device)[None]
                            >= label_lengths[:, None], -1)
    dataset = DeviceDataset(inputs, lengths, label_rows, label_lengths)
    numbers = {}
    for name, frozen in (("full", 0), ("freeze 8", TRANSFER_FREEZE)):
        config = w2l.Wav2LetterConfig(128, 29, compute_dtype=torch.bfloat16)
        optimizer = trainer.make_optimizer(
            1e-4, trainable=w2l.trainable_mask(config, frozen) if frozen else None)
        state = trainer.init_train_state(config, optimizer,
                                         params=w2l.init_params(config, SEED),
                                         device=device)
        epoch = trainer.make_device_epoch_step(config, optimizer, USER_BATCH, DGRAD_STEPS)
        state, _ = epoch(state, dataset, generator)  # warm-up: cuDNN's plans
        torch.cuda.synchronize()
        before = conv_dgrad.conv_dgrad.launches
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
            state, metrics = epoch(state, dataset, generator)
            torch.cuda.synchronize()
        counters = trace.snapshot()["counters"]
        launches = conv_dgrad.conv_dgrad.launches - before
        events = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
        events[0].record()
        state, metrics = epoch(state, dataset, generator)
        events[1].record()
        torch.cuda.synchronize()
        losses = metrics["step_losses"].cpu().numpy()
        check(np.isfinite(losses).all(), "{}: non-finite step loss".format(name))
        numbers[name] = {"launches": launches,
                         "dgrad_kernel": counters.get("conv.dgrad_kernel", 0),
                         "dgrad_cudnn": counters.get("conv.dgrad_cudnn", 0),
                         "ms_per_step": events[0].elapsed_time(events[1]) / DGRAD_STEPS}
        print("phase L make_device_epoch_step {} ({} x {} frames, {} steps a call): kernel "
              "launches {}, counters conv.dgrad_kernel {} conv.dgrad_cudnn {}; {:.2f} ms a "
              "step".format(name, USER_BATCH, frames, DGRAD_STEPS, launches,
                            numbers[name]["dgrad_kernel"], numbers[name]["dgrad_cudnn"],
                            numbers[name]["ms_per_step"]), flush=True)
        del state, epoch
    inner = 7 if conv_dgrad.KERNEL_MIN_TAPS <= 7 else 0  # the inner convs' route
    check(numbers["full"]["launches"] == DGRAD_STEPS * (1 + inner)
          and numbers["full"]["dgrad_kernel"] == numbers["full"]["launches"]
          and numbers["full"]["dgrad_cudnn"] == DGRAD_STEPS * (7 - inner),
          "the full step's data gradients took the wrong route: {}".format(numbers["full"]))
    check(numbers["freeze 8"]["launches"] == 0 and numbers["freeze 8"]["dgrad_kernel"] == 0
          and numbers["freeze 8"]["dgrad_cudnn"] == 0,
          "freeze 8 computed a data gradient: {}".format(numbers["freeze 8"]))
    del dataset, inputs, label_rows
    torch.cuda.empty_cache()
    return numbers


# ---- phase M: the Conformer's relative-position attention kernel pair ---------------
ATTN_HEADS, ATTN_FRAMES, ATTN_BATCH = 8, 616, 32   # the Conformer training cell's shape
ATTN_TRAFFIC = ROOT / "benchmark" / "traffic" / "train-clean-100-resident-10ms.json"
# (T', lengths) of the edge cases: lengths 1, 63, 64, 65 and T' in a T' that is not a
# multiple of the 64-frame tile; a short T' of two tiles.
ATTN_EDGES = ((ATTN_FRAMES, (1, 63, 64, 65, ATTN_FRAMES, 300)), (70, (70, 1, 64, 65, 6)))
# The kernel's largest gap from the plain version (fp32, TF32 off, on the same bf16
# inputs, with qu, qv and the position term rounded to bf16 as the kernel rounds them),
# as a share of the plain version's largest |value|, by output. O, dk and dv are stored
# in bf16 (2^-9 of a value) from fp32 sums of products whose bf16 factors (P, dS) were
# rounded once (2^-9 each, averaging out over the sum): 4 x 2^-9. dq, dp and the
# gradients of u and v are sums of dS over keys or rows, where dP - D nearly cancels
# before dS is rounded to bf16, so that rounding weighs more against their largest
# value: 2 %. A fault (a wrong tile, skew, mask or sum) moves an output by its own size.
ATTN_LIMITS = {"O": 2.0 ** -7, "dk": 2.0 ** -7, "dv": 2.0 ** -7,
               "dq": 0.02, "dp": 0.02, "du": 0.02, "dv_bias": 0.02}
ATTN_LSE_ATOL = 1e-3  # fp32 on both sides from the same rounded qu, qv: sums in another order
ATTN_STEPS = 2  # steps of the Conformer's resident call in phase M


def attention_input_frames(count: int) -> list:
    """Input frames of ``count`` rows at the quantiles (i + 0.5) / count of the training
    cell's utterance lengths (its traffic file: seconds at a 160-sample hop)."""
    import statistics

    mix = json.loads(ATTN_TRAFFIC.read_text())
    spec, normal = mix["lengths"], statistics.NormalDist()
    frames = []
    for i in range(count):
        seconds = spec["mean_s"] + spec["sd_s"] * normal.inv_cdf((i + 0.5) / count)
        seconds = min(max(seconds, spec["min_s"]), spec["max_s"])
        frames.append(1 + int(round(seconds * 16000)) // mix["hop_samples"])
    return frames


def attention_lengths(count: int) -> list:
    """T' of `attention_input_frames`' rows (the Conformer's 4x subsampling)."""
    return [((frames - 1) // 2 + 1 - 1) // 2 + 1 for frames in attention_input_frames(count)]


def attention_case(rng, lengths, frames, device):
    """bf16 q, k, v (B, T', 8, 64) and p (the projected sinusoids of a Glorot W_pos), fp32
    u and v in U(-0.5, 0.5) (the cell's draw), int32 lengths."""
    import torch

    from speechless_tpu_torch.models import conformer

    d = ATTN_HEADS * 64
    shape = (len(lengths), frames, ATTN_HEADS, 64)
    q, k, v = (torch.tensor(rng.normal(size=shape), dtype=torch.bfloat16, device=device)
               for _ in range(3))
    u, vb = (torch.tensor(rng.uniform(-0.5, 0.5, (ATTN_HEADS, 64)), dtype=torch.float32,
                          device=device) for _ in range(2))
    limit = math.sqrt(6.0 / (2 * d))
    weight = torch.tensor(rng.uniform(-limit, limit, (d, d)), dtype=torch.float32,
                          device=device)
    p = (conformer.relative_positions(frames, d, device) @ weight.T).to(torch.bfloat16)
    return (q, k, v, u, vb, p.view(2 * frames - 1, ATTN_HEADS, 64).contiguous(),
            torch.tensor(lengths, dtype=torch.int32, device=device))


def library_attention_call(q, k, v, u, vb, p, lengths):
    """The library route the kernel replaced (`conformer.library_attention`) in bf16."""
    import torch

    from speechless_tpu_torch.models import conformer

    valid = torch.arange(q.shape[1], device=q.device)[None, :] < lengths[:, None]
    return conformer.library_attention(q, k, v, u, vb, p,
                                       ~(valid[:, None, :, None] & valid[:, None, None, :]),
                                       ~valid[:, None, :, None], torch.bfloat16)


def attention_gaps(rng, lengths, frames, device) -> dict:
    """The kernel against the plain version (fp32, TF32 off, qu, qv and the position term
    rounded to bf16 as the kernel rounds them) on the same bf16 inputs: for O and each
    gradient the largest difference, absolute (``kernel_abs``) and over the plain
    version's largest |value| (``kernel``, held to ATTN_LIMITS); the library route's
    share beside it, for comparison only; the LSE's largest absolute difference; whether
    rows past a length are exactly 0."""
    import torch

    from speechless_tpu_torch.ops import rel_attention
    from speechless_tpu_torch.precision import ieee_fp32

    inputs = attention_case(rng, lengths, frames, device)
    q, k, v, u, vb, p, lens = inputs
    leaves = [t.clone().requires_grad_(True) for t in (q, k, v, u, vb, p)]
    grad = torch.tensor(rng.normal(size=q.shape), dtype=torch.bfloat16, device=device)
    names = ("O", "dq", "dk", "dv", "du", "dv_bias", "dp")

    def plain(*args, with_lse=False):
        return rel_attention.rel_attention_reference(*args, rounding=torch.bfloat16,
                                                     with_lse=with_lse)

    def run(fn, cast):
        args = [leaf.detach().to(cast(leaf)).requires_grad_(True) for leaf in leaves]
        out = fn(*args, lens)
        grads = torch.autograd.grad(out, args, grad.to(out.dtype))
        return [t.detach().float() for t in (out, *grads)]

    with ieee_fp32():
        want = run(plain, lambda leaf: torch.float32)
    got = run(rel_attention.rel_attention, lambda leaf: leaf.dtype)
    library = run(library_attention_call, lambda leaf: leaf.dtype)
    torch.cuda.synchronize()
    gaps = {}
    for name, g, l, w in zip(names, got, library, want):
        scale = max(float(w.abs().max()), 1e-30)
        gaps[name] = {"kernel": float((g - w).abs().max()) / scale,
                      "kernel_abs": float((g - w).abs().max()),
                      "library": float((l - w).abs().max()) / scale}
    o = torch.empty_like(q)
    o32 = torch.empty(q.shape, dtype=torch.float32, device=device)
    lse = torch.empty((len(lengths), ATTN_HEADS, frames), dtype=torch.float32, device=device)
    rel_attention._launch(q, k, v, u, vb, p, lens, o, o32, lse)
    with ieee_fp32(), torch.no_grad():
        _, want_lse = plain(*(t.float() for t in (q, k, v, u, vb, p)), lens, with_lse=True)
        gaps["LSE"] = {"kernel_abs": float((lse - want_lse).abs().max())}
    zero_rows = all(bool((got[0][row, own:] == 0).all()) for row, own in enumerate(lengths))
    gaps["zero_rows_past_length"] = zero_rows
    return gaps


def check_attention_gaps(name: str, gaps: dict) -> None:
    for tensor, gap in gaps.items():
        if tensor == "LSE":
            check(gap["kernel_abs"] <= ATTN_LSE_ATOL, "rel_attention {}: LSE off by {:.3g}"
                  .format(name, gap["kernel_abs"]))
        elif tensor == "zero_rows_past_length":
            check(gap, "rel_attention {}: a row past its length is not 0".format(name))
        else:
            check(gap["kernel"] <= ATTN_LIMITS[tensor],
                  "rel_attention {} {}: kernel {:.3g} of the largest value from the plain "
                  "version, limit {:.3g} (the library route: {:.3g})".format(
                      name, tensor, gap["kernel"], ATTN_LIMITS[tensor], gap["library"]))


def conformer_step_launches(device) -> dict:
    """The Conformer's resident training call (`make_device_epoch_step`, ATTN_STEPS steps)
    at the training cell's shape: 32 rows a step from a 64-row resident corpus of 2,464
    padded input frames (616 after subsampling) at the traffic's length quantiles, bf16
    compute. After a warm-up call, the kernel entry's launches in one call (the count
    set to 0 just before it), under a profiler the ``conformer.attn_tiles*`` counters,
    and the call's ms by CUDA events."""
    import torch

    from speechless_tpu_torch.data.device_dataset import DeviceDataset
    from speechless_tpu_torch.models import conformer
    from speechless_tpu_torch.ops import rel_attention
    from speechless_tpu_torch.train import trainer
    from speechless_tpu_torch.utils import trace

    config = conformer.ConformerConfig(compute_dtype=torch.bfloat16)
    rows, padded = 2 * ATTN_BATCH, 4 * ATTN_FRAMES
    generator = torch.Generator(device=device).manual_seed(SEED)
    lengths = torch.tensor(attention_input_frames(rows), dtype=torch.int32, device=device)
    inputs = torch.randn((rows, padded, config.feat_in), generator=generator, device=device,
                         dtype=torch.float16)
    inputs.masked_fill_(torch.arange(padded, device=device)[None, :, None]
                        >= lengths[:, None, None], 0.0)
    label_lengths = (lengths // 10).to(torch.int32)  # 15 a second at 100 frames a second
    label_width = -(-int(label_lengths.max()) // 64) * 64
    label_rows = torch.randint(0, config.grapheme_set_size - 1, (rows, label_width),
                               generator=generator, device=device, dtype=torch.int32)
    label_rows.masked_fill_(torch.arange(label_width, device=device)[None]
                            >= label_lengths[:, None], -1)
    dataset = DeviceDataset(inputs, lengths, label_rows, label_lengths)
    optimizer = trainer.make_optimizer(1e-4)
    state = trainer.init_train_state(config, optimizer,
                                     params=conformer.init_params(config, SEED),
                                     device=device)
    epoch = trainer.make_device_epoch_step(config, optimizer, ATTN_BATCH, ATTN_STEPS)
    state, _ = epoch(state, dataset, generator)  # warm-up: cuDNN's plans
    torch.cuda.synchronize()
    rel_attention.rel_attention.launches = 0
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        state, metrics = epoch(state, dataset, generator)
        torch.cuda.synchronize()
        counters = trace.snapshot()["counters"]
    launches = rel_attention.rel_attention.launches
    events = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
    events[0].record()
    state, metrics = epoch(state, dataset, generator)
    events[1].record()
    torch.cuda.synchronize()
    losses = metrics["step_losses"].cpu().numpy()
    check(np.isfinite(losses).all(), "the Conformer's resident step: non-finite loss")
    numbers = {"launches": launches, "expected": 2 * config.n_layers * ATTN_STEPS,
               "attn_tiles": counters.get("conformer.attn_tiles", 0),
               "attn_tiles_run": counters.get("conformer.attn_tiles_run", 0),
               "ms_per_step": events[0].elapsed_time(events[1]) / ATTN_STEPS}
    print("phase M make_device_epoch_step Conformer-CTC Large ({} x {} frames, {} steps a "
          "call): kernel launches {} (expected {}: forward and backward in each of {} "
          "blocks), counters conformer.attn_tiles {} conformer.attn_tiles_run {}; {:.2f} ms "
          "a step".format(ATTN_BATCH, padded, ATTN_STEPS, launches, numbers["expected"],
                          config.n_layers, numbers["attn_tiles"], numbers["attn_tiles_run"],
                          numbers["ms_per_step"]), flush=True)
    check(launches == numbers["expected"],
          "the Conformer's step launched the attention kernel {} times, expected {}".format(
              launches, numbers["expected"]))
    check(0 < numbers["attn_tiles_run"] < numbers["attn_tiles"],
          "the Conformer's step counted tiles {}".format(numbers))
    del state, epoch, dataset, inputs
    torch.cuda.empty_cache()
    return numbers


def phase_m(device, card: str) -> dict:
    """Phase M: the Conformer's relative-position attention kernel pair
    (`ops/rel_attention.py`, ``csrc/rel_attention.cu``). At the edges (ATTN_EDGES) and at
    the training cell's shape (32 rows of T' = 616 at the traffic's length quantiles, 8
    heads of 64), O, the LSE and every gradient (q, k, v, u, v, p) against the plain
    version (fp32, TF32 off) on the same bf16 inputs: each output within its limit of
    ATTN_LIMITS (the kernel's own bf16 roundings; the library route's gap is printed
    beside it, for comparison only), the LSE within ATTN_LSE_ATOL, rows past a length
    exactly 0. Then at the cell's shape: the forward + backward ms of the kernel pair, of
    the library route (`library_ms`) and of the plain version, the bound (the own pairs'
    operations over 989 TFLOP/s bf16 or the tensors' bytes over 3.35 TB/s), the tiles
    run, the largest tensor the block's attention allocates on each route, the device
    kernels of one forward + backward of the block's attention (no ``fmha``), and the
    kernel's launches and tile counters in the Conformer's resident training call
    (`conformer_step_launches`). The limits are checked last, after every number is
    printed."""
    import torch
    from torch.utils._python_dispatch import TorchDispatchMode

    from speechless_tpu_torch.models import conformer
    from speechless_tpu_torch.ops import rel_attention
    from speechless_tpu_torch.precision import ieee_fp32

    start = time.perf_counter()
    rng = np.random.default_rng(SEED + 13)
    cell_lengths = attention_lengths(ATTN_BATCH)
    cases = [("edge T'={}".format(frames), frames, lengths) for frames, lengths in ATTN_EDGES]
    cases.append(("cell", ATTN_FRAMES, cell_lengths))
    results = {}
    for name, frames, lengths in cases:
        gaps = attention_gaps(rng, lengths, frames, device)
        results[name] = gaps
        print("phase M {} (lengths {}): {}".format(
            name, lengths if len(lengths) < 8 else "{}..{}".format(min(lengths), max(lengths)),
            json.dumps(gaps)), flush=True)
        torch.cuda.empty_cache()

    q, k, v, u, vb, p, lens = attention_case(rng, cell_lengths, ATTN_FRAMES, device)
    grad = torch.tensor(rng.normal(size=q.shape), dtype=torch.bfloat16, device=device)
    leaves = [t.clone().requires_grad_(True) for t in (q, k, v, u, vb, p)]
    fp32_leaves = [t.detach().float().requires_grad_(True) for t in leaves]

    def forward_backward(fn, args, dtype=torch.bfloat16):
        out = fn(*args, lens)
        return torch.autograd.grad(out, args, grad.to(dtype))

    def plain():
        with ieee_fp32():
            return forward_backward(lambda *a: rel_attention.rel_attention_reference(
                *a, rounding=torch.bfloat16), fp32_leaves, torch.float32)

    # device times: each call queued behind a device sleep, so the host's issue is hidden
    ms = device_ms(lambda: forward_backward(rel_attention.rel_attention, leaves), 20)
    forward_ms = device_ms(lambda: rel_attention.rel_attention(*leaves, lens), 20)
    library_ms = device_ms(lambda: forward_backward(library_attention_call, leaves), 10)
    plain_ms = cuda_ms(plain, 2)
    own = sum(length * length for length in cell_lengths) * ATTN_HEADS
    # per own pair: the forward's content, position and value products; the backward's
    # recomputed content and position, dV, dP, dK, dq's two parts and d(band): 11 x 2 x 64
    flops = own * 11 * 2 * 64
    tensor_bytes = ATTN_BATCH * ATTN_FRAMES * ATTN_HEADS * 64 * 2
    # q, k, v, O, dO, dq, dk, dv (bf16), p and dp, LSE
    nbytes = 8 * tensor_bytes + 2 * (2 * ATTN_FRAMES - 1) * ATTN_HEADS * 64 * 2 \
        + ATTN_BATCH * ATTN_HEADS * ATTN_FRAMES * 4
    bound_ms = max(flops / BF16_OPS_PER_S, nbytes / HBM_BYTES_PER_S) * 1e3
    tiles, tiles_run = rel_attention.tile_counts(lens, ATTN_FRAMES)
    timing = {"ms": ms, "forward_ms": forward_ms, "library_ms": library_ms,
              "plain_ms": plain_ms, "bound_ms": bound_ms,
              "bound_by": "operations" if flops / BF16_OPS_PER_S > nbytes / HBM_BYTES_PER_S
              else "bytes", "own_pair_tflops": flops / ms / 1e9,
              "tiles": tiles, "tiles_run": int(tiles_run),
              "tile_share": 100.0 * int(tiles_run) / tiles}
    print("phase M cell ({}): kernel pair forward + backward {:.4f} ms (forward {:.4f}; "
          "{:.1f} TFLOP/s on the own pairs' work), bound {:.4f} ms ({}), library route "
          "{:.4f} ms, plain {:.2f} ms; tiles run {} of {} ({:.2f} %)".format(
              card, ms, forward_ms, timing["own_pair_tflops"], bound_ms, timing["bound_by"],
              library_ms, plain_ms, timing["tiles_run"], tiles, timing["tile_share"]),
          flush=True)

    class LargestTensor(TorchDispatchMode):
        def __init__(self):
            super().__init__()
            self.numel = 0

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            out = func(*args, **(kwargs or {}))
            for tensor in (out if isinstance(out, (tuple, list)) else (out,)):
                if isinstance(tensor, torch.Tensor):
                    self.numel = max(self.numel, tensor.numel())
            return out

    config = conformer.ConformerConfig(compute_dtype=torch.bfloat16)
    block = conformer.RelPositionAttention(config, device=device)
    x = torch.randn((ATTN_BATCH, ATTN_FRAMES, config.d_model), device=device,
                    requires_grad=True)
    positions = conformer.relative_positions(ATTN_FRAMES, config.d_model, device)
    valid = torch.arange(ATTN_FRAMES, device=device)[None, :] < lens[:, None]
    routes = {"kernel": conformer.attention_core(True, valid, torch.bfloat16),
              "library": conformer.attention_core(False, valid, torch.bfloat16)}
    largest, kernels = {}, {}
    for route, attend in routes.items():
        watch = LargestTensor()
        with watch:
            block(x, positions, attend, torch.bfloat16).float().square().mean().backward()
        largest[route] = watch.numel
        torch.cuda.synchronize()
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
            block(x, positions, attend, torch.bfloat16).float().square().mean().backward()
            torch.cuda.synchronize()
        kernels[route] = sorted({event.name for event in prof.events()
                                 if event.device_type == torch.autograd.DeviceType.CUDA})
    scores = ATTN_BATCH * ATTN_HEADS * ATTN_FRAMES * ATTN_FRAMES
    print("phase M the block's attention, forward + backward: largest tensor {} elements on "
          "the kernel's route, {} on the library route (B H T'^2 = {}); the kernel route's "
          "device kernels: {}".format(largest["kernel"], largest["library"], scores,
                                      kernels["kernel"]), flush=True)
    del block, x, leaves, fp32_leaves, routes
    torch.cuda.empty_cache()
    step = conformer_step_launches(device)

    for name, gaps in results.items():
        check_attention_gaps(name, gaps)
    check(largest["kernel"] < scores, "the kernel's route allocated a score-sized tensor")
    check(not any("fmha" in name for name in kernels["kernel"])
          and any("rel_attention_fwd_kernel" in name for name in kernels["kernel"])
          and any("rel_attention_bwd_kernel" in name for name in kernels["kernel"]),
          "the kernel's route ran {}".format(kernels["kernel"]))
    wall = time.perf_counter() - start
    print("phase M ({}): {:.1f} s".format(card, wall))
    return {"gaps": results, "timing": timing, "largest": largest, "step": step,
            "wall_s": wall}


def main() -> None:
    import argparse

    import torch

    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--profile", action="store_true",
                        help="also split transcribe_batch's and a train step's time into "
                             "their layers and trace one batch, one stream piece round and "
                             "one k-step call (writes chiprun_out/profile.json, "
                             "profile_stream.json and profile_train.json)")
    parser.add_argument("--facade-only", action="store_true",
                        help="build the kernels and run phases F, I and G alone; prints "
                             "no result line")
    parser.add_argument("--bundle-only", action="store_true",
                        help="build the kernels and run phases B and J alone; prints no "
                             "result line")
    parser.add_argument("--parallel-only", action="store_true",
                        help="build the kernels and run phase B, phase F's corpus staging "
                             "and phase K alone; prints no result line")
    parser.add_argument("--dgrad-only", action="store_true",
                        help="build the kernels and run phase L (the conv data-gradient "
                             "kernel) alone; prints no result line")
    parser.add_argument("--attention-only", action="store_true",
                        help="build the kernels and run phase M (the Conformer's "
                             "relative-position attention kernel pair) alone; prints no "
                             "result line")
    parser.add_argument("--k2-worker", nargs=4, metavar=("RANK", "PORT", "DIR", "DEVICE"),
                        help=argparse.SUPPRESS)  # one rank of phase K2, started by it
    args = parser.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device")
    sys.path.insert(0, str(ROOT))
    if args.k2_worker:
        rank, port, directory, device_type = args.k2_worker
        phase_k2_worker(int(rank), int(port), Path(directory), device_type)
        return
    from speechless_tpu_torch.lm.arpa_builder import build_kenlm_directory
    from speechless_tpu_torch.lm.device_lm import build_device_word_lm
    from speechless_tpu_torch.lm.ngram import load_language_model
    from speechless_tpu_torch.ops import _kernels
    from speechless_tpu_torch.serving import CHARSETS

    check("jax" not in sys.modules, "the port imported jax")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         timeout=60)
    card = smi.stdout.strip().splitlines()[0] if smi.stdout.strip() else "nvidia-smi: n/a"
    print(card)
    # PyTorch's defaults, left as they are: the port's features and model turn TF32
    # off themselves (speechless_tpu_torch/precision.py).
    print("torch {} CUDA {}; {} x {}; process-wide TF32 flags: matmul {} cudnn {}".format(
        torch.__version__, torch.version.cuda, torch.cuda.device_count(),
        torch.cuda.get_device_name(0), torch.backends.cuda.matmul.allow_tf32,
        torch.backends.cudnn.allow_tf32))
    device = torch.device("cuda:0")

    start = time.perf_counter()
    _kernels.build_all()  # one nvcc per source, all started together
    print("kernel builds: nvcc {}, {:.2f} s for all".format(" ".join(_kernels.NVCC_FLAGS),
                                                            time.perf_counter() - start))
    for name, build in _kernels.builds.items():
        print("  speechless_tpu_torch/csrc/{}.cu in {:.2f} s -> {}".format(
            name, build["seconds"], Path(build["path"]).name))
        for line in build["log"].splitlines():
            if any(word in line for word in ("registers", "Compiling entry", "spill",
                                             "wgmma", "setmaxnreg", "arning")):
                print("    ptxas: " + line.strip())

    if args.dgrad_only:
        phase_l(device, card)
        print("chip_smoke --dgrad-only: phase L passed; no result line")
        return
    if args.attention_only:
        phase_m(device, card)
        print("chip_smoke --attention-only: phase M passed; no result line")
        return
    if args.facade_only:
        with tempfile.TemporaryDirectory() as directory:
            facade = phase_f(device, card, None, Path(directory))
            phase_i(device, card, None, Path(directory))
            phase_g(device, card, facade, Path(directory))
        print("chip_smoke --facade-only: phases F and G passed; no result line")
        return
    alphabet = CHARSETS["english"]
    with tempfile.TemporaryDirectory() as lm_directory:
        sentences = readme_sentences()
        build_kenlm_directory(sentences, Path(lm_directory), allowed_characters=alphabet)
        word_lm = build_device_word_lm(
            load_language_model(Path(lm_directory), prefer_native=False), alphabet).to(device)
        print("word LM: {} sentences of README.md, {} trie nodes, {} unigrams".format(
            len(sentences), word_lm.trie.shape[0], word_lm.uni_logp.shape[0]))
        if args.bundle_only:
            _, transcriber, batch, _, _, _ = phase_b(device, Path(lm_directory))
            phase_j(device, card, transcriber, batch, Path(lm_directory))
            print("chip_smoke --bundle-only: phases B and J passed; no result line")
            return
        if args.parallel_only:
            _, _, batch, _, _, _ = phase_b(device, Path(lm_directory))
            with tempfile.TemporaryDirectory() as directory:
                stage_facade_corpora(Path(directory))
                phase_k(device, card, None, Path(directory), batch)
            print("chip_smoke --parallel-only: phases B and K passed; no result line")
            return
        step = phase_a(device, len(alphabet), alphabet.index(" "), word_lm)
        launches, transcriber, batch, short_audio, make_audio, batch_s = phase_b(
            device, Path(lm_directory))
        if args.profile:
            phase_profile(transcriber, batch, short_audio,
                          ROOT / "chiprun_out" / "profile.json")
        streaming = phase_d(device, transcriber, make_audio, Path(lm_directory),
                            ROOT / "chiprun_out" / "profile_stream.json"
                            if args.profile else None)
        offline = phase_e(device, transcriber, batch, Path(lm_directory),
                          {word for sentence in sentences for word in sentence.split()},
                          step["decode_outputs"])
        routes = phase_h(device, card, transcriber, batch, Path(lm_directory), batch_s)
        bundles = phase_j(device, card, transcriber, batch, Path(lm_directory))
    train = phase_c(device, args.profile, ROOT / "chiprun_out" / "profile_train.json")
    dgrad = phase_l(device, card)
    attention = phase_m(device, card)
    with tempfile.TemporaryDirectory() as directory:
        facade = phase_f(device, card, train["train"], Path(directory))
        model_variants = phase_i(device, card, train["train"], Path(directory))
        transfer = phase_g(device, card, facade, Path(directory))
        phase_h_cli(device, Path(directory), facade["run"])
        parallel = phase_k(device, card, train["train"], Path(directory), batch)
    check(not [m for m in sys.modules if m.split(".")[0] in ("jax", "speechless_tpu")],
          "the port imported jax or the JAX package")

    ctc, raw_ctc = train["ctc"], model_variants["raw_wave"]["kernels"]
    backtrace = offline["backtraces"]["span"]
    print("phase G launches on its paths (ctc_alpha, ctc_beta_grad): {}".format(
        transfer["launches"]))
    print("phase I launches on the raw-wave paths (ctc_alpha, ctc_beta_grad): bench batch "
          "{}, facade {}".format(model_variants["raw_wave"]["launches"], {
              name: run["launches"] for name, run in model_variants["facade"].items()}))
    print("phase H launches on its paths (lm_beam_span, beam_backtrace, stream_stitch, "
          "lm_beam_step): {}".format(routes["launches"]))
    print("phase J launches on its paths (lm_beam_span, beam_backtrace, lm_beam_step): "
          "{}".format(bundles["launches"]))
    replayed = {name: sum(run[name] for run in bundles["launches"].values())
                for name in ("lm_beam_span", "beam_backtrace")}
    print("phase K launches on its paths: K1 (the world-1 mesh step, k={}) {}, its facade "
          "epoch {}; K2 (both ranks) {}".format(
              BENCH_STEPS, parallel["k1"]["launches"], parallel["k1"]["facade_launches"],
              parallel["k2"]["launches"]))
    k2_launches = parallel["k2"]["launches"]
    print(card)  # again beside the summary: the long output's head may be cut
    print("summary: span kernel {:.4f} ms per 16 x 513 launch ({:.2f} us per frame; "
          "no LM {:.4f} ms); step entry {:.5f} ms per frame on the sorted network, {:.5f} "
          "ms on the rank network; transcribe_batch 16 x 8 s {:.4f} s; stream piece round "
          "{:.3f} ms".format(step["ms"], step["per_frame_us"], step["no_lm_ms"],
                             step["step_ms"]["sorted"], step["step_ms"]["rank"], batch_s,
                             streaming["decoder"]["kernel"]))
    print(json.dumps({"kernels": [{
        "name": "lm_beam_span", "route": "cuda",
        "source": "speechless_tpu_torch/csrc/lm_beam_span.cu",
        "replaces": "speechless_tpu/ops/decode_pallas_lm.py:124",
        "launches": launches["lm_beam_span"] + replayed["lm_beam_span"]
        + k2_launches["lm_beam_span"],
        "max_abs_err": step["max_abs_err"],
        "ms": step["ms"], "plain_ms": step["plain_ms"], "bound_ms": step["bound_ms"],
        "bound_by": step["bound_by"], "library_ms": None}, {
        "name": "beam_backtrace", "route": "cuda",
        "source": "speechless_tpu_torch/csrc/beam_backtrace.cu",
        "replaces": "speechless_tpu/ops/decode_jax.py:34",
        "launches": launches["beam_backtrace"] + replayed["beam_backtrace"]
        + k2_launches["beam_backtrace"],
        "max_abs_err": backtrace["max_abs_err"],
        "ms": backtrace["ms"], "plain_ms": backtrace["plain_ms"],
        "bound_ms": backtrace["bound_ms"], "bound_by": backtrace["bound_by"],
        "library_ms": None}, {
        "name": "ctc_alpha", "route": "cuda",
        "source": "speechless_tpu_torch/csrc/ctc_alpha.cu",
        "replaces": "speechless_tpu/ops/ctc_pallas.py:45",
        "launches": train["launches"]["ctc_alpha"] + parallel["k1"]["launches"]["ctc_alpha"],
        "max_abs_err": max(ctc["alpha_abs_err"], train["ctc_long"]["alpha_abs_err"],
                           raw_ctc["alpha_abs_err"]),
        "ms": ctc["alpha_ms"], "plain_ms": ctc["alpha_plain_ms"],
        "bound_ms": ctc["bound_ms"], "bound_by": ctc["bound_by"],
        "library_ms": ctc["library_fwd_ms"]}, {
        "name": "ctc_beta_grad", "route": "cuda",
        "source": "speechless_tpu_torch/csrc/ctc_beta_grad.cu",
        "replaces": "speechless_tpu/ops/ctc_pallas.py:70",
        "launches": train["launches"]["ctc_beta_grad"]
        + parallel["k1"]["launches"]["ctc_beta_grad"],
        "max_abs_err": max(ctc["beta_abs_err"], ctc["beta_grad_abs_err"],
                           train["ctc_long"]["beta_abs_err"],
                           train["ctc_long"]["beta_grad_abs_err"], raw_ctc["beta_abs_err"],
                           raw_ctc["beta_grad_abs_err"]),
        "ms": ctc["beta_grad_ms"], "plain_ms": ctc["beta_grad_plain_ms"],
        "bound_ms": ctc["beta_grad_bound_ms"], "bound_by": ctc["beta_grad_bound_by"],
        "library_ms": ctc["library_bwd_ms"]}, {
        "name": "stream_stitch", "route": "cuda",
        "source": "speechless_tpu_torch/csrc/stream_stitch.cu",
        "replaces": "speechless_tpu/ops/decode_incremental_pallas.py:78",
        "launches": streaming["http"]["launches"]["stream_stitch"],
        "max_abs_err": streaming["stitch"]["max_abs_err"], "ms": streaming["stitch"]["ms"],
        "plain_ms": streaming["stitch"]["plain_ms"],
        "bound_ms": streaming["stitch"]["bound_ms"],
        "bound_by": streaming["stitch"]["bound_by"], "library_ms": None}, {
        "name": "prefix_beam", "route": "cuda",
        "source": "speechless_tpu_torch/csrc/prefix_beam.cu",
        "replaces": "speechless_tpu/ops/decode_pallas.py:188",
        "launches": offline["launches"],
        "max_abs_err": max(case["max_abs_err"] for case in offline["cases"].values()),
        "ms": offline["cases"]["a"]["ms"], "plain_ms": offline["cases"]["a"]["plain_ms"],
        "bound_ms": offline["cases"]["a"]["bound_ms"],
        "bound_by": offline["cases"]["a"]["bound_by"], "library_ms": None}, {
        "name": "conv_dgrad", "route": "cuda",
        "source": "speechless_tpu_torch/csrc/conv_dgrad.cu",
        "replaces": "none (cuDNN's data gradients of big_conv_1 and the inner convs)",
        "launches": dgrad["steps"]["full"]["launches"],
        "max_abs_err": max(gaps["max_abs"] for gaps in dgrad["gaps"].values()),
        "ms": dgrad["timings"]["big_conv_1 cell"]["ms"],
        "plain_ms": dgrad["timings"]["big_conv_1 cell"]["plain_ms"],
        "bound_ms": dgrad["timings"]["big_conv_1 cell"]["bound_ms"],
        "bound_by": "operations",
        "library_ms": dgrad["timings"]["big_conv_1 cell"]["library_ms"]}, {
        "name": "rel_attention", "route": "cuda",
        "source": "speechless_tpu_torch/csrc/rel_attention.cu",
        "replaces": "none (rel_shift, the pair mask and SDPA's memory-efficient kernels)",
        "launches": attention["step"]["launches"],
        "max_abs_err": max(gap["kernel_abs"] for gaps in attention["gaps"].values()
                           for gap in gaps.values() if isinstance(gap, dict)),
        "max_rel_err": max(gap["kernel"] for gaps in attention["gaps"].values()
                           for gap in gaps.values() if isinstance(gap, dict) and "kernel" in gap),
        "ms": attention["timing"]["ms"], "plain_ms": attention["timing"]["plain_ms"],
        "bound_ms": attention["timing"]["bound_ms"],
        "bound_by": attention["timing"]["bound_by"],
        "library_ms": attention["timing"]["library_ms"]}]}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
