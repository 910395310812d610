// CTC backward (beta) recursion over reversed time, hand-written for Hopper (kernel K2).
//
// Replaces the TPU kernel speechless_tpu/ops/ctc_pallas.py::_beta_kernel and computes
// what it computes: with scored_{t+1}[s] = beta_{t+1}[s] + E_{t+1}[s] (E_T read as
// E_{T-1}, beta_T the terminal),
//   beta_t[s] = lse(scored[s], scored[s+1], skip_from[s] ? scored[s+2]),
// skip_from[s] = skip[s+2], replaced by the terminal (0 at the row's last two live
// states, NEG_INF = -1e30 elsewhere) at t = length_b - 1 and NEG_INF for dead states
// s >= 2U_b+1. Past a row's length beta has no meaning (the gradient masks it): the
// kernel writes NEG_INF there and starts the recursion at t = length_b - 1. E_t[s] =
// log_probs[b, t, extended[b, s]] is gathered here. Output: (T, B, S) fp32. The plain
// PyTorch twin is speechless_tpu_torch/ops/ctc.py::beta_reference; the occupancy ->
// gradient contraction runs after it in PyTorch (ops/ctc.py::occupancy_gradient), as it
// ran in XLA after the Pallas kernel.
//
// What bounds it on the H100: as for K1 (ctc_alpha.cu), the chain of T dependent steps.
// At the bench shape it must read 3.8 MB and write 50.6 MB (about 16 us at 3.35 TB/s),
// but each step waits on the previous one's barrier, shared-memory reads, expf and logf.
// What the design does about it: the same as K1's. One block per batch row loops over
// time in reverse; each thread owns K states and keeps their label, skip_from flag,
// terminal value and next emission in registers. Shared memory holds scored_{t+1}
// (beta plus the owner's emission, added by the owner), double-buffered with one
// __syncthreads() per step, so a thread reads its neighbours' scored values without
// gathering their emissions. The next step's emission is loaded before the barrier.
// Built without fast math: expf/logf as IEEE.
#include <cuda_runtime.h>

namespace {

constexpr float kNegInf = -1e30f;
constexpr int kMaxThreads = 1024;

// speechless_tpu/ops/ctc.py::_logsumexp3 (see ctc_alpha.cu).
__device__ __forceinline__ float logsumexp3(float a, float b, float c) {
  const float m = fmaxf(fmaxf(fmaxf(a, b), c), kNegInf);
  return m + logf(expf(a - m) + expf(b - m) + expf(c - m));
}

template <int K>
__global__ void __launch_bounds__(kMaxThreads)
ctc_beta_kernel(const float* __restrict__ log_probs, const int* __restrict__ extended,
                const unsigned char* __restrict__ skip, const int* __restrict__ lengths,
                const int* __restrict__ s_counts, float* __restrict__ betas, int batch,
                int t_max, int class_count, int s_count) {
  extern __shared__ float scored[];  // [2][s_count]: scored_{t+1} and scored_t
  const int row = blockIdx.x;
  const int length = lengths[row];
  const int live_count = s_counts[row];
  const float* row_log_probs = log_probs + static_cast<size_t>(row) * t_max * class_count;
  const size_t row_states = static_cast<size_t>(row) * s_count;
  // The recursion runs from t = start down to 0; later slices are NEG_INF.
  const int start = min(length, t_max) - 1;

  int label[K];
  bool skip_from[K], live[K];
  float terminal[K], emit[K];
#pragma unroll
  for (int k = 0; k < K; ++k) {
    const int s = threadIdx.x + k * blockDim.x;
    const bool in_range = s < s_count;
    label[k] = in_range ? extended[row_states + s] : 0;
    skip_from[k] = s + 2 < s_count && skip[row_states + s + 2] != 0;
    live[k] = in_range && s < live_count;
    terminal[k] = (live[k] && (s == live_count - 1 || s == max(live_count - 2, 0)))
                      ? 0.0f : kNegInf;
    if (in_range) {
      scored[s] = terminal[k] + row_log_probs[(t_max - 1) * class_count + label[k]];
      for (int t = max(start + 1, 0); t < t_max; ++t)
        betas[(static_cast<size_t>(t) * batch + row) * s_count + s] = kNegInf;
    }
    emit[k] = (start >= 0) ? row_log_probs[start * class_count + label[k]] : 0.0f;
  }
  __syncthreads();

  for (int t = start; t >= 0; --t) {
    const int step = start - t;
    const float* next = scored + (step & 1) * s_count;
    float* cur = scored + ((step + 1) & 1) * s_count;
    float* out = betas + (static_cast<size_t>(t) * batch + row) * s_count;
#pragma unroll
    for (int k = 0; k < K; ++k) {
      const int s = threadIdx.x + k * blockDim.x;
      if (s >= s_count) continue;
      float value = kNegInf;
      if (live[k]) {
        if (t == length - 1) {
          value = terminal[k];
        } else {
          const float advance = s + 1 < s_count ? next[s + 1] : kNegInf;
          const float skipped = skip_from[k] ? next[s + 2] : kNegInf;
          value = logsumexp3(next[s], advance, skipped);
        }
      }
      out[s] = value;
      cur[s] = value + emit[k];
      if (t >= 1) emit[k] = row_log_probs[(t - 1) * class_count + label[k]];
    }
    __syncthreads();
  }
}

template <int K>
int launch(const float* log_probs, const int* extended, const unsigned char* skip,
           const int* lengths, const int* s_counts, float* betas, int batch, int t_max,
           int class_count, int s_count, cudaStream_t stream) {
  const int threads = ((s_count + K - 1) / K + 31) / 32 * 32;
  const int shared_bytes = 2 * s_count * static_cast<int>(sizeof(float));
  if (shared_bytes > 48 * 1024) {
    const cudaError_t status = cudaFuncSetAttribute(
        ctc_beta_kernel<K>, cudaFuncAttributeMaxDynamicSharedMemorySize, shared_bytes);
    if (status != cudaSuccess) return static_cast<int>(status);
  }
  ctc_beta_kernel<K><<<batch, threads, shared_bytes, stream>>>(
      log_probs, extended, skip, lengths, s_counts, betas, batch, t_max, class_count,
      s_count);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// C entry point (loaded with ctypes). log_probs (B, T, C) fp32, extended (B, S) int32,
// skip (B, S) uint8 (the forward's skip mask, not shifted), lengths and s_counts (B,)
// int32, betas (T, B, S) fp32, all contiguous on one device. One block per row on
// `stream`; allocates nothing; returns the launch's cudaError_t (0 = success), or
// cudaErrorInvalidValue when S exceeds 16 * 1024 states.
extern "C" int ctc_beta(const float* log_probs, const int* extended,
                        const unsigned char* skip, const int* lengths, const int* s_counts,
                        float* betas, int batch, int t_max, int class_count, int s_count,
                        void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (s_count <= kMaxThreads)
    return launch<1>(log_probs, extended, skip, lengths, s_counts, betas, batch, t_max,
                     class_count, s_count, st);
  if (s_count <= 2 * kMaxThreads)
    return launch<2>(log_probs, extended, skip, lengths, s_counts, betas, batch, t_max,
                     class_count, s_count, st);
  if (s_count <= 4 * kMaxThreads)
    return launch<4>(log_probs, extended, skip, lengths, s_counts, betas, batch, t_max,
                     class_count, s_count, st);
  if (s_count <= 8 * kMaxThreads)
    return launch<8>(log_probs, extended, skip, lengths, s_counts, betas, batch, t_max,
                     class_count, s_count, st);
  if (s_count <= 16 * kMaxThreads)
    return launch<16>(log_probs, extended, skip, lengths, s_counts, betas, batch, t_max,
                      class_count, s_count, st);
  return static_cast<int>(cudaErrorInvalidValue);
}
