// CTC forward (alpha) recursion over time, hand-written for Hopper (kernel K1).
//
// Replaces the TPU kernel speechless_tpu/ops/ctc_pallas.py::_alpha_kernel and computes
// what it computes: alpha_0[s] = E_0[s] for s < 2, then
//   alpha_t[s] = lse(alpha_{t-1}[s], alpha_{t-1}[s-1], skip[s] ? alpha_{t-1}[s-2]) + E_t[s]
// for live states s < 2U_b+1, with each row frozen from t = length_b on, and NEG_INF =
// -1e30 (finite, as in the JAX package) for dead states. E_t[s] = log_probs[b, t,
// extended[b, s]] is gathered here; the TPU needed it precomputed as a one-hot matmul.
// Every alpha_t is written to (T, B, S) fp32: the backward pass needs them. The row's
// log P(label), the log-sum-exp of the last two live states of the frozen alpha, is
// written to `final_log_prob` (B,). The plain PyTorch twins are
// speechless_tpu_torch/ops/ctc.py::alpha_reference and final_log_prob.
//
// What bounds it on the H100: the chain of T dependent steps, not bytes. At the bench
// shape (B=64, T=513, S=385) it must read 3.8 MB of log-probs and write 50.6 MB of
// alphas, about 16 us at 3.35 TB/s, but each step needs the one before it: one barrier,
// three expf and a logf on the state's path. With one block per row the chain is T steps
// long whatever the card's width.
// What the design does about it: one thread block per batch row loops over time. The
// emission of a step is read from shared memory, never from device memory on the
// chain: the row's log-probs are staged in windows of frames by cp.async, each window
// copied while the one before it is consumed. Each thread keeps K consecutive states
// in registers (K = 1 up to 1024 states, 2 up to 2048, ... 16 up to 16384) and leaves
// only the two its right neighbour needs in shared memory (ctc_common.cuh), double-
// buffered so one __syncthreads() a step orders them. The alpha stores leave registers
// as the step ends and are never waited on. Frozen steps (t >= length) store registers
// with no barrier. Built without fast math: expf/logf as IEEE, so the kernel equals
// alpha_reference bit for bit.
#include <cuda_runtime.h>

#include "ctc_common.cuh"

namespace {

using ctc::kNegInf;
constexpr int kMaxThreads = 1024;
constexpr int kWindowFrames = 64;  // frames per staged window (fewer for many classes)

template <int K>
__global__ void __launch_bounds__(kMaxThreads)
ctc_alpha_kernel(const float* __restrict__ log_probs, const int* __restrict__ extended,
                 const unsigned char* __restrict__ skip, const int* __restrict__ lengths,
                 const int* __restrict__ s_counts, float* __restrict__ alphas,
                 float* __restrict__ final_log_prob, int batch, int t_max, int class_count,
                 int s_count, int window) {
  extern __shared__ float shared[];
  float* published = shared;                       // [2][2 * threads]
  float* windows = shared + 4 * blockDim.x;        // [2][window * class_count]
  float* last_two = windows + 2 * window * class_count;  // [2]
  const int row = blockIdx.x;
  const int length = lengths[row];
  const int live_count = min(s_counts[row], s_count);
  const float* row_log_probs = log_probs + static_cast<size_t>(row) * t_max * class_count;
  const size_t row_states = static_cast<size_t>(row) * s_count;
  const int first = threadIdx.x * K;
  const int window_floats = window * class_count;
  const int active_end = min(length, t_max);   // steps 1 .. active_end-1 advance
  const int frames_needed = max(active_end, 1);

  // Windows 0 and 1 start copying at once; window w lives in buffer w & 1.
  for (int w = 0; w < 2; ++w) {
    const int begin = w * window;
    ctc::copy_span_async(windows + w * window_floats, row_log_probs + begin * class_count,
                         max(0, min(frames_needed - begin, window)) * class_count,
                         blockDim.x);
    ctc::commit_copies();
  }

  int label[K];
  unsigned skip_bits = 0;
  float value[K];
#pragma unroll
  for (int k = 0; k < K; ++k) {
    const int s = first + k;
    label[k] = s < s_count ? extended[row_states + s] : 0;
    if (s < s_count && s >= 2 && skip[row_states + s] != 0) skip_bits |= 1u << k;
  }
  ctc::wait_copies<1>();
  __syncthreads();  // window 0 is in shared memory
#pragma unroll
  for (int k = 0; k < K; ++k) {
    const int s = first + k;
    value[k] = (s < live_count && s < 2) ? windows[label[k]] : kNegInf;
    if (s < s_count) alphas[row_states + s] = value[k];
  }
  if (K == 1) {
    published[threadIdx.x] = value[0];
  } else {
    published[2 * threadIdx.x] = value[K - 2];
    published[2 * threadIdx.x + 1] = value[K - 1];
  }
  __syncthreads();

  int frame = 0, buffer = 0;  // position of step t in its window, and the window's buffer
  for (int t = 1; t < active_end; ++t) {
    if (++frame == window) {  // entering a new window: wait for it, refill the old one
      frame = 0;
      buffer ^= 1;
      ctc::wait_copies<0>();
      __syncthreads();
      const int begin = t + window;
      ctc::copy_span_async(windows + (buffer ^ 1) * window_floats,
                           row_log_probs + static_cast<size_t>(begin) * class_count,
                           max(0, min(frames_needed - begin, window)) * class_count,
                           blockDim.x);
      ctc::commit_copies();
    }
    const float* emission = windows + buffer * window_floats + frame * class_count;
    const float* before = published + ((t - 1) & 1) * 2 * blockDim.x;
    float* after = published + (t & 1) * 2 * blockDim.x;
    const float edge1 = first >= 1 ? before[ctc::alpha_slot<K>(first - 1)] : kNegInf;
    const float edge2 = first >= 2 ? before[ctc::alpha_slot<K>(first - 2)] : kNegInf;
    // Downwards, so that value[k - 1] and value[k - 2] still hold alpha_{t-1}.
#pragma unroll
    for (int k = K - 1; k >= 0; --k) {
      if (first + k < live_count) {  // dead states stay NEG_INF
        const float advance = k >= 1 ? value[k - 1] : edge1;
        const float back2 = k >= 2 ? value[k - 2] : (k == 1 ? edge1 : edge2);
        const float skipped = (skip_bits >> k) & 1u ? back2 : kNegInf;
        value[k] = ctc::logsumexp3(value[k], advance, skipped) + emission[label[k]];
      }
    }
    if (K == 1) {
      after[threadIdx.x] = value[0];
    } else {
      after[2 * threadIdx.x] = value[K - 2];
      after[2 * threadIdx.x + 1] = value[K - 1];
    }
    float* out = alphas + (static_cast<size_t>(t) * batch + row) * s_count;
#pragma unroll
    for (int k = 0; k < K; ++k)
      if (first + k < s_count) out[first + k] = value[k];
    __syncthreads();
  }
  // Frozen from t = length on: every later slice repeats the last alpha.
  for (int t = max(active_end, 1); t < t_max; ++t) {
    float* out = alphas + (static_cast<size_t>(t) * batch + row) * s_count;
#pragma unroll
    for (int k = 0; k < K; ++k)
      if (first + k < s_count) out[first + k] = value[k];
  }
  // log P(label): ops/ctc.py::final_log_prob's _logsumexp2 of the last live state and
  // the one before it (NEG_INF for a row with one state).
#pragma unroll
  for (int k = 0; k < K; ++k) {
    if (first + k == live_count - 1) last_two[0] = value[k];
    if (first + k == live_count - 2) last_two[1] = value[k];
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    const float last = last_two[0];
    const float second = live_count >= 2 ? last_two[1] : kNegInf;
    const float m = fmaxf(fmaxf(last, second), kNegInf);
    final_log_prob[row] = m + logf(expf(last - m) + expf(second - m));
  }
  ctc::wait_copies<0>();
}

template <int K>
int launch(const float* log_probs, const int* extended, const unsigned char* skip,
           const int* lengths, const int* s_counts, float* alphas, float* final_log_prob,
           int batch, int t_max, int class_count, int s_count, cudaStream_t stream) {
  const int threads = ((s_count + K - 1) / K + 31) / 32 * 32;
  const int window = max(1, min(kWindowFrames, 8192 / class_count));
  const int shared_bytes =
      (4 * threads + 2 * window * class_count + 2) * static_cast<int>(sizeof(float));
  if (shared_bytes > 48 * 1024) {
    const cudaError_t status = cudaFuncSetAttribute(
        ctc_alpha_kernel<K>, cudaFuncAttributeMaxDynamicSharedMemorySize, shared_bytes);
    if (status != cudaSuccess) return static_cast<int>(status);
  }
  ctc_alpha_kernel<K><<<batch, threads, shared_bytes, stream>>>(
      log_probs, extended, skip, lengths, s_counts, alphas, final_log_prob, batch, t_max,
      class_count, s_count, window);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// C entry point (loaded with ctypes). log_probs (B, T, C) fp32, extended (B, S) int32,
// skip (B, S) uint8, lengths and s_counts (B,) int32, alphas (T, B, S) and
// final_log_prob (B,) fp32, all contiguous on one device. One block per row on
// `stream`; allocates nothing; returns the launch's cudaError_t (0 = success), or
// cudaErrorInvalidValue when S exceeds 16 * 1024 states.
extern "C" int ctc_alpha(const float* log_probs, const int* extended,
                         const unsigned char* skip, const int* lengths, const int* s_counts,
                         float* alphas, float* final_log_prob, int batch, int t_max,
                         int class_count, int s_count, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
#define CTC_ALPHA_LAUNCH(K)                                                           \
  return launch<K>(log_probs, extended, skip, lengths, s_counts, alphas, final_log_prob, \
                   batch, t_max, class_count, s_count, st)
  if (s_count <= kMaxThreads) CTC_ALPHA_LAUNCH(1);
  if (s_count <= 2 * kMaxThreads) CTC_ALPHA_LAUNCH(2);
  if (s_count <= 4 * kMaxThreads) CTC_ALPHA_LAUNCH(4);
  if (s_count <= 8 * kMaxThreads) CTC_ALPHA_LAUNCH(8);
  if (s_count <= 16 * kMaxThreads) CTC_ALPHA_LAUNCH(16);
#undef CTC_ALPHA_LAUNCH
  return static_cast<int>(cudaErrorInvalidValue);
}
