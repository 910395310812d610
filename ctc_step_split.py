#!/usr/bin/env python3
"""Where a step of the CTC alpha recursion (kernel K1) spends its time, on one NVIDIA GPU.

    python3 ctc_step_split.py

At the bench shape of `chip_smoke.py` phase C (B=64, T=513, U=192, S=385, 29 classes)
it prints, with CUDA events:

* the port's CTC forward (`ops/ctc.py::CtcLoss` on `ops/ctc_kernels.py`: extended
  labels, K1, `final_log_prob`) and its backward (the fused backward kernel and whatever
  runs around it), each beside `torch.nn.functional.ctc_loss`'s forward and backward on
  the same log-probs, and the same with `log_softmax` in front; K1 and the fused
  backward kernel alone;
* variants of the alpha recursion, built here from the source below: the emissions
  gathered from device memory one step ahead (the first K1's loop) or staged in shared
  memory before the loop, with and without the alpha stores, at 1, 4, 7 and 13 warps a row
  (each thread walking ceil(S / threads) states). Each variant must equal
  `alpha_reference` bitwise (the stores-off variants write the last slice only, which
  is checked).

Needs one CUDA device and nvcc; exits non-zero without them. Prints the card's name
and power limit first and one JSON object last.
"""
import ctypes
import json
import subprocess
import sys
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent

VARIANTS_SOURCE = r"""
#include <cuda_runtime.h>
namespace {
constexpr float kNegInf = -1e30f;
__device__ __forceinline__ float logsumexp3(float a, float b, float c) {
  const float m = fmaxf(fmaxf(fmaxf(a, b), c), kNegInf);
  return m + logf(expf(a - m) + expf(b - m) + expf(c - m));
}
// The first K1's loop (one block a row, states strided over the threads, the state
// vector double-buffered in shared memory), with the emission source (STAGE: the
// row's log-probs copied into shared memory before the loop) and the per-step alpha
// stores (STORE) as switches.
template <int K, bool STAGE, bool STORE>
__global__ void __launch_bounds__(1024)
alpha_variant(const float* __restrict__ log_probs, const int* __restrict__ extended,
              const unsigned char* __restrict__ skip, const int* __restrict__ lengths,
              const int* __restrict__ s_counts, float* __restrict__ alphas, int batch,
              int t_max, int class_count, int s_count) {
  extern __shared__ float shared[];
  float* state = shared;
  float* staged = shared + 2 * s_count;
  const int row = blockIdx.x;
  const int length = lengths[row];
  const int live_count = s_counts[row];
  const float* row_log_probs = log_probs + static_cast<size_t>(row) * t_max * class_count;
  const size_t row_states = static_cast<size_t>(row) * s_count;
  if (STAGE)
    for (int i = threadIdx.x; i < t_max * class_count; i += blockDim.x)
      staged[i] = row_log_probs[i];
  const float* source = STAGE ? staged : row_log_probs;
  int label[K];
  bool can_skip[K], live[K];
  float emit[K], value[K];
#pragma unroll
  for (int k = 0; k < K; ++k) {
    const int s = threadIdx.x + k * blockDim.x;
    const bool in_range = s < s_count;
    label[k] = in_range ? extended[row_states + s] : 0;
    can_skip[k] = in_range && s >= 2 && skip[row_states + s] != 0;
    live[k] = in_range && s < live_count;
    value[k] = (live[k] && s < 2) ? row_log_probs[label[k]] : kNegInf;
    if (in_range) {
      state[s] = value[k];
      alphas[row_states + s] = value[k];
    }
  }
  __syncthreads();
#pragma unroll
  for (int k = 0; k < K; ++k) emit[k] = (t_max > 1) ? source[class_count + label[k]] : 0.0f;
  const int active_end = min(length, t_max);
  for (int t = 1; t < active_end; ++t) {
    const float* prev = state + ((t - 1) & 1) * s_count;
    float* cur = state + (t & 1) * s_count;
    float* out = alphas + (static_cast<size_t>(t) * batch + row) * s_count;
#pragma unroll
    for (int k = 0; k < K; ++k) {
      const int s = threadIdx.x + k * blockDim.x;
      if (s >= s_count) continue;
      if (live[k]) {
        const float advance = s >= 1 ? prev[s - 1] : kNegInf;
        const float skipped = can_skip[k] ? prev[s - 2] : kNegInf;
        value[k] = logsumexp3(prev[s], advance, skipped) + emit[k];
      }
      cur[s] = value[k];
      if (STORE) out[s] = value[k];
      if (t + 1 < t_max) emit[k] = source[(t + 1) * class_count + label[k]];
    }
    __syncthreads();
  }
  for (int t = max(STORE ? active_end : t_max - 1, 1); t < t_max; ++t) {
    float* out = alphas + (static_cast<size_t>(t) * batch + row) * s_count;
#pragma unroll
    for (int k = 0; k < K; ++k) {
      const int s = threadIdx.x + k * blockDim.x;
      if (s < s_count) out[s] = value[k];
    }
  }
}
template <int K, bool STAGE, bool STORE>
int launch(const float* lp, const int* ext, const unsigned char* skip, const int* len,
           const int* sc, float* alphas, int batch, int t_max, int classes, int s_count,
           int threads, cudaStream_t stream) {
  const int shared_bytes = (2 * s_count + (STAGE ? t_max * classes : 0)) * 4;
  cudaError_t status = cudaFuncSetAttribute(
      alpha_variant<K, STAGE, STORE>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      shared_bytes);
  if (status != cudaSuccess) return static_cast<int>(status);
  alpha_variant<K, STAGE, STORE><<<batch, threads, shared_bytes, stream>>>(
      lp, ext, skip, len, sc, alphas, batch, t_max, classes, s_count);
  return static_cast<int>(cudaGetLastError());
}
}  // namespace

#define CASE(KK, STAGE, STORE) \
  if (k == KK && stage == STAGE && store == STORE) \
    return launch<KK, STAGE, STORE>(lp, ext, skip, len, sc, alphas, batch, t_max, \
                                    classes, s_count, threads, st);
#define CASES(KK) CASE(KK, false, true) CASE(KK, false, false) CASE(KK, true, true) \
                  CASE(KK, true, false)

extern "C" int alpha_variant(const float* lp, const int* ext, const unsigned char* skip,
                             const int* len, const int* sc, float* alphas, int batch,
                             int t_max, int classes, int s_count, int k, int stage,
                             int store, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int threads = ((s_count + k - 1) / k + 31) / 32 * 32;
  CASES(1) CASES(2) CASES(4) CASES(13)
  return static_cast<int>(cudaErrorInvalidValue);
}
"""


def build_variants():
    sys.path.insert(0, str(ROOT))
    from speechless_tpu_torch.ops import _kernels

    out_dir = ROOT / "build" / "ctc_step_split"
    out_dir.mkdir(parents=True, exist_ok=True)
    source = out_dir / "alpha_variants.cu"
    source.write_text(VARIANTS_SOURCE)
    library = out_dir / "alpha_variants.so"
    log = subprocess.run([_kernels._nvcc(), *_kernels.NVCC_FLAGS, "-o", str(library),
                          str(source)], capture_output=True, text=True)
    if log.returncode != 0:
        raise SystemExit("nvcc failed:\n" + log.stdout + log.stderr)
    for line in (log.stdout + log.stderr).splitlines():
        if "registers" in line or "spill" in line:
            print("  ptxas: " + line.strip())
    entry = ctypes.CDLL(str(library)).alpha_variant
    entry.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 7 + [ctypes.c_void_p]
    entry.restype = ctypes.c_int
    return entry


def main() -> None:
    import torch
    import torch.nn.functional as F

    if not torch.cuda.is_available():
        raise SystemExit("ctc_step_split: no CUDA device")
    sys.path.insert(0, str(ROOT))
    import chip_smoke
    from speechless_tpu_torch.ops import _kernels, ctc, ctc_kernels

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True)
    print(smi.stdout.strip())
    device = torch.device("cuda:0")
    _kernels.build_all()
    entry = build_variants()
    cuda_ms = chip_smoke.cuda_ms
    rng = np.random.default_rng(chip_smoke.SEED + 3)
    batch, t_max, u_max, classes = chip_smoke.BENCH_BATCH, 513, chip_smoke.BENCH_LABELS, 29
    log_probs, lengths, labels, label_lengths, _ = chip_smoke.ctc_case(
        rng, batch, t_max, u_max, classes, device)
    blank = classes - 1
    logits = log_probs.clone()  # log-softmax of log-probs is the identity, up to rounding
    weights = torch.linspace(0.5, 2.0, batch, device=device)
    numbers = {}

    # The whole CTC forward and backward, the port's and the library's.
    def port_forward(x):
        return ctc_kernels.ctc_loss(x, lengths, labels, label_lengths, blank)

    lp_tbc = log_probs.transpose(0, 1).contiguous()
    targets = (labels.clamp(min=0).long(), lengths.long(), label_lengths.long())

    def library_forward(x):
        return F.ctc_loss(x, *targets, blank=blank, reduction="none", zero_infinity=True)

    for name, forward, source in (
            ("port", port_forward, log_probs),
            ("library", library_forward, lp_tbc),
            ("port_from_logits", lambda x: port_forward(torch.log_softmax(x, -1)), logits),
            ("library_from_logits",
             lambda x: library_forward(torch.log_softmax(x, -1).transpose(0, 1)), logits)):
        x = source.clone().requires_grad_()
        numbers[name + "_fwd_ms"] = cuda_ms(lambda: forward(x), 30)
        loss = forward(x)
        numbers[name + "_bwd_ms"] = cuda_ms(
            lambda: torch.autograd.grad(loss, x, weights, retain_graph=True), 30)

    extended, skip = ctc.extended_labels(labels, blank)
    s_counts = (2 * label_lengths + 1).to(torch.int32)
    args = (log_probs, lengths, extended, skip, s_counts)
    want = ctc.alpha_reference(*args)
    s_count = extended.shape[1]
    numbers["alpha_kernel_ms"] = cuda_ms(lambda: ctc_kernels.ctc_alpha(*args), 50)
    alphas, final = ctc_kernels.ctc_alpha(*args)
    numbers["beta_grad_kernel_ms"] = cuda_ms(
        lambda: ctc_kernels.ctc_beta_grad(*args, alphas, final, weights), 50)
    stream = torch.cuda.current_stream().cuda_stream
    for k, warps in ((13, 1), (4, 4), (2, 7), (1, 13)):
        for stage in (0, 1):
            for store in (1, 0):
                out = torch.full_like(want, float("nan"))

                def run():
                    status = entry(log_probs.data_ptr(), extended.data_ptr(),
                                   skip.data_ptr(), lengths.data_ptr(), s_counts.data_ptr(),
                                   out.data_ptr(), batch, t_max, classes, s_count, k,
                                   stage, store, stream)
                    if status:
                        raise RuntimeError("variant launch failed: {}".format(status))

                run()
                torch.cuda.synchronize()
                checked = want if store else want[-1]
                got = out if store else out[-1]
                if not torch.equal(got, checked):
                    raise SystemExit("variant K={} stage={} store={} differs".format(
                        k, stage, store))
                name = "alpha_{}warps_{}_{}".format(
                    warps, "staged" if stage else "global", "stores" if store else "nostores")
                numbers[name + "_ms"] = cuda_ms(run, 50)
                numbers[name + "_us_per_step"] = numbers[name + "_ms"] * 1e3 / t_max
    for key, value in numbers.items():
        print("{}: {:.5f}".format(key, value))
    print(json.dumps(numbers))


if __name__ == "__main__":
    main()
