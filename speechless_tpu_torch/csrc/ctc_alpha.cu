// CTC forward (alpha) recursion over time, hand-written for Hopper (kernel K1).
//
// Replaces the TPU kernel speechless_tpu/ops/ctc_pallas.py::_alpha_kernel and computes
// what it computes: alpha_0[s] = E_0[s] for s < 2, then
//   alpha_t[s] = lse(alpha_{t-1}[s], alpha_{t-1}[s-1], skip[s] ? alpha_{t-1}[s-2]) + E_t[s]
// for live states s < 2U_b+1, with each row frozen from t = length_b on, and NEG_INF =
// -1e30 (finite, as in the JAX package) for dead states. E_t[s] = log_probs[b, t,
// extended[b, s]] is gathered here; the TPU needed it precomputed as a one-hot matmul.
// Every alpha_t is written to (T, B, S) fp32: the backward pass needs them. The plain
// PyTorch twin is speechless_tpu_torch/ops/ctc.py::alpha_reference.
//
// What bounds it on the H100: the chain of T dependent steps, not bytes. At the bench
// shape (B=64, T=513, S=385) it must read 3.8 MB of log-probs and write 50.6 MB of
// alphas, about 16 us at 3.35 TB/s, but each step waits for the previous one: a barrier,
// three shared-memory reads, three expf and a logf. With one block per row the chain is
// T steps long whatever the card's width.
// What the design does about it: one thread block per batch row (rows are independent,
// so the batch spreads over the SMs) loops over time inside the block, in place of the
// TPU's sequential grid. Each thread owns K states (K = 1 up to 1024 states, 2 up to
// 2048, ... 16 up to 16384) and keeps their labels, skip flags and next emission in
// registers; the state vector is double-buffered in shared memory, so one
// __syncthreads() per step separates the reads of alpha_{t-1} from the writes of
// alpha_t. The next step's emission is loaded before the barrier, off the chain, and
// the alpha stores are coalesced and never waited on. Frozen steps (t >= length) copy
// registers to memory with no barrier. Built without fast math: expf/logf as IEEE.
#include <cuda_runtime.h>

namespace {

constexpr float kNegInf = -1e30f;
constexpr int kMaxThreads = 1024;

// speechless_tpu/ops/ctc.py::_logsumexp3: the max clamped at NEG_INF, so that three
// NEG_INF inputs give NEG_INF + log 3 and never a NaN.
__device__ __forceinline__ float logsumexp3(float a, float b, float c) {
  const float m = fmaxf(fmaxf(fmaxf(a, b), c), kNegInf);
  return m + logf(expf(a - m) + expf(b - m) + expf(c - m));
}

template <int K>
__global__ void __launch_bounds__(kMaxThreads)
ctc_alpha_kernel(const float* __restrict__ log_probs, const int* __restrict__ extended,
                 const unsigned char* __restrict__ skip, const int* __restrict__ lengths,
                 const int* __restrict__ s_counts, float* __restrict__ alphas, int batch,
                 int t_max, int class_count, int s_count) {
  extern __shared__ float state[];  // [2][s_count]: alpha_{t-1} and alpha_t
  const int row = blockIdx.x;
  const int length = lengths[row];
  const int live_count = s_counts[row];
  const float* row_log_probs = log_probs + static_cast<size_t>(row) * t_max * class_count;
  const size_t row_states = static_cast<size_t>(row) * s_count;

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
    emit[k] = (t_max > 1) ? row_log_probs[class_count + label[k]] : 0.0f;
  }
  __syncthreads();

  const int active_end = min(length, t_max);  // steps 1 .. active_end-1 advance
  for (int t = 1; t < active_end; ++t) {
    const float* prev = state + ((t - 1) & 1) * s_count;
    float* cur = state + (t & 1) * s_count;
    float* out = alphas + (static_cast<size_t>(t) * batch + row) * s_count;
#pragma unroll
    for (int k = 0; k < K; ++k) {
      const int s = threadIdx.x + k * blockDim.x;
      if (s >= s_count) continue;
      if (live[k]) {  // dead states stay NEG_INF
        const float advance = s >= 1 ? prev[s - 1] : kNegInf;
        const float skipped = can_skip[k] ? prev[s - 2] : kNegInf;
        value[k] = logsumexp3(prev[s], advance, skipped) + emit[k];
      }
      cur[s] = value[k];
      out[s] = value[k];
      if (t + 1 < t_max) emit[k] = row_log_probs[(t + 1) * class_count + label[k]];
    }
    __syncthreads();
  }
  // Frozen from t = length on: every later slice repeats the last alpha.
  for (int t = max(active_end, 1); t < t_max; ++t) {
    float* out = alphas + (static_cast<size_t>(t) * batch + row) * s_count;
#pragma unroll
    for (int k = 0; k < K; ++k) {
      const int s = threadIdx.x + k * blockDim.x;
      if (s < s_count) out[s] = value[k];
    }
  }
}

template <int K>
int launch(const float* log_probs, const int* extended, const unsigned char* skip,
           const int* lengths, const int* s_counts, float* alphas, int batch, int t_max,
           int class_count, int s_count, cudaStream_t stream) {
  const int threads = ((s_count + K - 1) / K + 31) / 32 * 32;
  const int shared_bytes = 2 * s_count * static_cast<int>(sizeof(float));
  if (shared_bytes > 48 * 1024) {
    const cudaError_t status = cudaFuncSetAttribute(
        ctc_alpha_kernel<K>, cudaFuncAttributeMaxDynamicSharedMemorySize, shared_bytes);
    if (status != cudaSuccess) return static_cast<int>(status);
  }
  ctc_alpha_kernel<K><<<batch, threads, shared_bytes, stream>>>(
      log_probs, extended, skip, lengths, s_counts, alphas, batch, t_max, class_count,
      s_count);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// C entry point (loaded with ctypes). log_probs (B, T, C) fp32, extended (B, S) int32,
// skip (B, S) uint8, lengths and s_counts (B,) int32, alphas (T, B, S) fp32, all
// contiguous on one device. One block per row on `stream`; allocates
// nothing; returns the launch's cudaError_t (0 = success), or cudaErrorInvalidValue
// when S exceeds 16 * 1024 states.
extern "C" int ctc_alpha(const float* log_probs, const int* extended,
                         const unsigned char* skip, const int* lengths, const int* s_counts,
                         float* alphas, int batch, int t_max, int class_count, int s_count,
                         void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (s_count <= kMaxThreads)
    return launch<1>(log_probs, extended, skip, lengths, s_counts, alphas, batch, t_max,
                     class_count, s_count, st);
  if (s_count <= 2 * kMaxThreads)
    return launch<2>(log_probs, extended, skip, lengths, s_counts, alphas, batch, t_max,
                     class_count, s_count, st);
  if (s_count <= 4 * kMaxThreads)
    return launch<4>(log_probs, extended, skip, lengths, s_counts, alphas, batch, t_max,
                     class_count, s_count, st);
  if (s_count <= 8 * kMaxThreads)
    return launch<8>(log_probs, extended, skip, lengths, s_counts, alphas, batch, t_max,
                     class_count, s_count, st);
  if (s_count <= 16 * kMaxThreads)
    return launch<16>(log_probs, extended, skip, lengths, s_counts, alphas, batch, t_max,
                      class_count, s_count, st);
  return static_cast<int>(cudaErrorInvalidValue);
}
