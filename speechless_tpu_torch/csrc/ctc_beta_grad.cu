// CTC backward, hand-written for Hopper: the beta recursion (kernel K2) fused with the
// occupancy contraction into the gradient.
//
// Replaces the TPU kernel speechless_tpu/ops/ctc_pallas.py::_beta_kernel and the XLA
// contraction after it (`_ctc_bwd`, ctc_pallas.py:222-228), and computes what they
// compute. With scored_{t+1}[s] = beta_{t+1}[s] + E_{t+1}[s] (E_T read as E_{T-1},
// beta_T the terminal),
//   beta_t[s] = lse(scored[s], scored[s+1], skip_from[s] ? scored[s+2]),
// skip_from[s] = skip[s+2], replaced by the terminal (0 at the row's last two live
// states, NEG_INF = -1e30 elsewhere) at t = length_b - 1 and NEG_INF for dead states
// s >= 2U_b+1; then for t < length_b
//   grad[b, t, c] = -(sum over live s with extended[s] = c of
//                     exp((alpha_t[s] + beta_t[s]) - logZ_b)) * grad_out[b]
// and 0 * grad_out[b] for t >= length_b. E_t[s] = log_probs[b, t, extended[b, s]].
// beta itself goes to memory only when the caller passes `betas` (the checks do; the
// train step does not): NEG_INF past each row's length. The plain PyTorch twin is
// ops/ctc.py::beta_reference followed by ops/ctc.py::occupancy_gradient.
//
// What bounds it on the H100: as for K1 (ctc_alpha.cu), the chain of T dependent steps.
// At the bench shape it must read 3.8 MB of log-probs and 50.6 MB of alphas and write
// 3.8 MB of gradient (about 17 us at 3.35 TB/s).
// What the design does about it: one block per row, split into two kinds of warps.
// The chain warps run K1's structure backwards in time: K consecutive states a thread
// in registers, the two edge values a neighbour needs in double-buffered shared memory,
// one named barrier (chain warps only) a step, the emissions staged in windows of
// frames by cp.async. Each alpha_t comes from device memory straight into registers,
// loaded several steps ahead (8 / K). Each step a chain thread forms gamma =
// exp((alpha + beta) - logZ) for its states and writes it, at the state's position in
// the row's live states sorted by class (a stable counting sort by warp ballots, once
// per row), into one half of a shared-memory ring of G steps (up to 32). When a group
// of G steps is in, the chain warps signal the reducer warps (bar.arrive) and go on in
// the other half. The reducer warps sum the group, off the chain: each thread one
// segment of at most L same-class positions of one step (L the least of 16 and up with
// L * L >= S), in position order, then each class of each step its segments in order,
// and store the gradient. A fixed summation order: no atomics, deterministic. Built
// without fast math.
#include <cuda_runtime.h>

#include "ctc_common.cuh"

namespace {

using ctc::kNegInf;
constexpr int kMaxThreads = 1024;
constexpr int kReducerThreads = 256;
constexpr int kMaxChainThreads = kMaxThreads - kReducerThreads;
constexpr int kMaxGroup = 32;        // steps a half of the gamma ring holds
constexpr int kWindowFrames = 64;    // frames per staged emission window
// Named barriers (0 is __syncthreads): the chain warps' step barrier, the reducer
// warps' barrier, and for each half of the ring "gamma is in" (chain arrives, reducers
// wait) and "the half is free" (reducers arrive, chain waits).
constexpr int kChainBarrier = 1, kReducerBarrier = 2, kFullBarrier = 3, kFreeBarrier = 5;

__device__ __forceinline__ void barrier_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}
__device__ __forceinline__ void barrier_arrive(int id, int threads) {
  asm volatile("bar.arrive %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

// Positions one reducer thread sums: the least L >= 16 with L * L >= S.
__host__ __device__ inline int segment_length(int s_count) {
  int length = 16;
  while (length * length < s_count) ++length;
  return length;
}
__host__ __device__ inline int segment_capacity(int s_count, int class_count) {
  const int length = segment_length(s_count);
  return (s_count + length - 1) / length + class_count;
}

// Stage frames [low, high] of the row's log-probs (frame t at (t - low) * C).
__device__ inline void stage_window(float* window, const float* row_log_probs, int low,
                                    int high, int class_count, int threads) {
  ctc::copy_span_async(window, row_log_probs + static_cast<size_t>(max(low, 0)) * class_count,
                       max(0, high - low + 1) * class_count, threads);
  ctc::commit_copies();
}

template <int K>
__global__ void __launch_bounds__(kMaxThreads)
ctc_beta_grad_kernel(const float* __restrict__ log_probs, const int* __restrict__ extended,
                     const unsigned char* __restrict__ skip, const int* __restrict__ lengths,
                     const int* __restrict__ s_counts, const float* __restrict__ alphas,
                     const float* __restrict__ final_log_prob,
                     const float* __restrict__ grad_out, float* __restrict__ grad,
                     float* __restrict__ betas, int batch, int t_max, int class_count,
                     int s_count, int group, int chain_threads) {
  constexpr int kAhead = K >= 8 ? 1 : 8 / K;  // steps an alpha is loaded ahead
  extern __shared__ float shared[];
  const int capacity = segment_capacity(s_count, class_count);
  const int window_floats = kWindowFrames * class_count;
  float* published = shared;                                // [2][2 * chain threads]
  float* windows = published + 4 * chain_threads;           // [2][window frames * C]
  float* ring = windows + 2 * window_floats;                // [2][group][S], by class
  float* partial = ring + 2 * group * s_count;              // [group][capacity]
  int* class_first = reinterpret_cast<int*>(partial + group * capacity);  // [C]
  int* class_segment = class_first + class_count;           // [C + 1]
  int* segment_first = class_segment + class_count + 1;     // [capacity + 1]

  const int row = blockIdx.x;
  const int length = lengths[row];
  const int live_count = min(s_counts[row], s_count);
  const int start = min(length, t_max) - 1;  // the recursion runs from here down to 0
  const int groups = start >= 0 ? start / group + 1 : 0;
  const float* row_log_probs = log_probs + static_cast<size_t>(row) * t_max * class_count;
  const size_t row_states = static_cast<size_t>(row) * s_count;
  const int threads = blockDim.x;

  // The row's live states sorted by class, stably: rank within the class by ballots
  // (one warp per class), class offsets by one thread, then segments (all threads).
  int* sort_labels = reinterpret_cast<int*>(ring);  // the ring is free until the loop
  int* rank = sort_labels + s_count;
  for (int s = threadIdx.x; s < live_count; s += threads)
    sort_labels[s] = extended[row_states + s];
  __syncthreads();
  const int lane = threadIdx.x & 31;
  for (int c = threadIdx.x >> 5; c < class_count; c += threads >> 5) {
    int running = 0;
    for (int base = 0; base < live_count; base += 32) {
      const int s = base + lane;
      const bool match = s < live_count && sort_labels[s] == c;
      const unsigned ballot = __ballot_sync(0xffffffffu, match);
      if (match) rank[s] = running + __popc(ballot & ((1u << lane) - 1u));
      running += __popc(ballot);
    }
    if (lane == 0) class_first[c] = running;  // the class's count, for now
  }
  __syncthreads();
  const int length_of_segment = segment_length(s_count);
  if (threadIdx.x == 0) {
    int position = 0, segment = 0;
    for (int c = 0; c < class_count; ++c) {
      const int count = class_first[c];
      class_first[c] = position;
      class_segment[c] = segment;
      position += count;
      segment += (count + length_of_segment - 1) / length_of_segment;
    }
    class_segment[class_count] = segment;
    segment_first[segment] = position;
  }
  __syncthreads();
  for (int c = threadIdx.x; c < class_count; c += threads)
    for (int j = class_segment[c]; j < class_segment[c + 1]; ++j)
      segment_first[j] = class_first[c] + (j - class_segment[c]) * length_of_segment;

  if (threadIdx.x >= chain_threads) {
    // ---- reducer warps ----------------------------------------------------------
    const int reducer = threadIdx.x - chain_threads;
    const float scale = grad_out[row];
    __syncthreads();  // the tables are complete
    // Past the row's length: a zero gradient (times grad_out, as the plain version
    // multiplies) and, for the checks, beta = NEG_INF.
    const int from = max(start + 1, 0);
    float* tail = grad + (static_cast<size_t>(row) * t_max + from) * class_count;
    for (int i = reducer; i < (t_max - from) * class_count; i += kReducerThreads)
      tail[i] = 0.0f * scale;
    if (betas != nullptr)
      for (int t = from; t < t_max; ++t)
        for (int s = reducer; s < s_count; s += kReducerThreads)
          betas[(static_cast<size_t>(t) * batch + row) * s_count + s] = kNegInf;
    const int segments = class_segment[class_count];
    for (int g = 0; g < groups; ++g) {
      const int t_hi = start - g * group;
      const int steps = min(group, t_hi + 1);
      const float* half = ring + (g & 1) * group * s_count;
      barrier_sync(kFullBarrier + (g & 1), threads);  // the group's gamma is in
      // Segment partials: positions in order within one class and one step.
      for (int q = reducer; q < steps * segments; q += kReducerThreads) {
        const int j = q / segments, segment = q - j * segments;
        const float* sorted = half + j * s_count;
        float sum = 0.0f;
        for (int p = segment_first[segment]; p < segment_first[segment + 1]; ++p)
          sum += sorted[p];
        partial[j * capacity + segment] = sum;
      }
      barrier_sync(kReducerBarrier, kReducerThreads);
      barrier_arrive(kFreeBarrier + (g & 1), threads);  // the half may take new gamma
      // Each class of each step: its segments in order.
      for (int q = reducer; q < steps * class_count; q += kReducerThreads) {
        const int j = q / class_count, c = q - j * class_count;
        float sum = 0.0f;
        for (int segment = class_segment[c]; segment < class_segment[c + 1]; ++segment)
          sum += partial[j * capacity + segment];
        grad[(static_cast<size_t>(row) * t_max + (t_hi - j)) * class_count + c] =
            -sum * scale;
      }
      barrier_sync(kReducerBarrier, kReducerThreads);  // the partials may be rewritten
    }
    return;
  }

  // ---- chain warps ----------------------------------------------------------------
  const int first = threadIdx.x * K;
  const float log_z = final_log_prob[row];
  int label[K], position[K];
  unsigned skip_from = 0;
  float scored[K];
#pragma unroll
  for (int k = 0; k < K; ++k) {
    const int s = first + k;
    label[k] = s < s_count ? extended[row_states + s] : 0;
    position[k] = s < live_count ? class_first[label[k]] + rank[s] : 0;
    if (s + 2 < s_count && skip[row_states + s + 2] != 0) skip_from |= 1u << k;
    // scored_{t+1} of the first step: the terminal plus E_{T-1} (used only when the
    // row is longer than T; otherwise its first step is the terminal itself).
    const bool terminal = s < live_count && (s == live_count - 1 ||
                                             s == max(live_count - 2, 0));
    scored[k] = s < s_count
        ? (terminal ? 0.0f : kNegInf) +
              row_log_probs[static_cast<size_t>(t_max - 1) * class_count + label[k]]
        : kNegInf;
  }
  float alpha[kAhead][K];  // alpha_t for the next kAhead steps, t = start - slot first
#pragma unroll
  for (int d = 0; d < kAhead; ++d)
#pragma unroll
    for (int k = 0; k < K; ++k)
      alpha[d][k] = start - d >= 0 && first + k < live_count
          ? __ldg(alphas + (static_cast<size_t>(start - d) * batch + row) * s_count + first + k)
          : 0.0f;
  __syncthreads();  // the tables are read (the ring's scratch is free)
  // Emission windows walk down from `start`: window w holds frames
  // [start - (w + 1) * W + 1, start - w * W], frame t at (t - low) * C.
  int low = start - kWindowFrames + 1, buffer = 0;
  stage_window(windows, row_log_probs, max(low, 0), start, class_count, chain_threads);
  stage_window(windows + window_floats, row_log_probs, max(low - kWindowFrames, 0),
               low - 1, class_count, chain_threads);
  if (K == 1) {
    published[threadIdx.x] = scored[0];
  } else {
    published[2 * threadIdx.x] = scored[0];
    published[2 * threadIdx.x + 1] = scored[1];
  }
  ctc::wait_copies<1>();
  barrier_sync(kChainBarrier, chain_threads);

  int parity = 0;  // the buffer of `published` that holds the previous step's values
  for (int g = 0; g < groups; ++g) {
    const int t_hi = start - g * group;
    const int steps = min(group, t_hi + 1);
    float* half = ring + (g & 1) * group * s_count;
    if (g >= 2) barrier_sync(kFreeBarrier + (g & 1), threads);  // group g - 2 is summed
    for (int j0 = 0; j0 < steps; j0 += kAhead) {
#pragma unroll
      for (int d = 0; d < kAhead; ++d) {  // the group is a multiple of kAhead steps
        const int j = j0 + d;
        if (j >= steps) break;
        const int t = t_hi - j;
        if (t < max(low, 0)) {  // entering the next window: wait for it, refill the old
          low -= kWindowFrames;
          buffer ^= 1;
          ctc::wait_copies<0>();
          barrier_sync(kChainBarrier, chain_threads);
          stage_window(windows + (buffer ^ 1) * window_floats, row_log_probs,
                       max(low - kWindowFrames, 0), low - 1, class_count, chain_threads);
        }
        const float* emission =
            windows + buffer * window_floats + (t - max(low, 0)) * class_count;
        const float* before = published + parity * 2 * chain_threads;
        float* after = published + (parity ^ 1) * 2 * chain_threads;
        const int next = first + K;  // the right neighbour's first state
        const float edge1 = next < s_count ? before[ctc::beta_slot<K>(next)] : kNegInf;
        const float edge2 =
            next + 1 < s_count ? before[ctc::beta_slot<K>(next + 1)] : kNegInf;
        float* beta_out = betas != nullptr
            ? betas + (static_cast<size_t>(t) * batch + row) * s_count : nullptr;
        // Upwards, so that scored[k + 1] and scored[k + 2] still hold scored_{t+1}.
#pragma unroll
        for (int k = 0; k < K; ++k) {
          const int s = first + k;
          if (s >= s_count) continue;
          float value = kNegInf;
          if (s < live_count) {
            if (t == length - 1) {
              value = (s == live_count - 1 || s == max(live_count - 2, 0)) ? 0.0f : kNegInf;
            } else {
              const float advance = k + 1 < K ? scored[k + 1] : edge1;
              const float ahead2 = k + 2 < K ? scored[k + 2] : (k + 2 == K ? edge1 : edge2);
              const float skipped = (skip_from >> k) & 1u ? ahead2 : kNegInf;
              value = ctc::logsumexp3(scored[k], advance, skipped);
            }
            half[j * s_count + position[k]] = expf((alpha[d][k] + value) - log_z);
          }
          if (beta_out != nullptr) beta_out[s] = value;
          scored[k] = value + emission[label[k]];
        }
        if (K == 1) {
          after[threadIdx.x] = scored[0];
        } else {
          after[2 * threadIdx.x] = scored[0];
          after[2 * threadIdx.x + 1] = scored[1];
        }
        // The alpha kAhead steps on takes this slot.
        const int ahead = t - kAhead;
#pragma unroll
        for (int k = 0; k < K; ++k)
          alpha[d][k] = ahead >= 0 && first + k < live_count
              ? __ldg(alphas + (static_cast<size_t>(ahead) * batch + row) * s_count +
                      first + k)
              : 0.0f;
        parity ^= 1;
        barrier_sync(kChainBarrier, chain_threads);
      }
    }
    barrier_arrive(kFullBarrier + (g & 1), threads);  // the group's gamma is in
  }
  // Take the reducers' last two "free" arrivals, so every barrier ends complete.
  for (int g = max(groups - 2, 0); g < groups; ++g)
    barrier_sync(kFreeBarrier + (g & 1), threads);
  ctc::wait_copies<0>();
}

template <int K>
int launch(const float* log_probs, const int* extended, const unsigned char* skip,
           const int* lengths, const int* s_counts, const float* alphas,
           const float* final_log_prob, const float* grad_out, float* grad, float* betas,
           int batch, int t_max, int class_count, int s_count, cudaStream_t stream) {
  constexpr int kAhead = K >= 8 ? 1 : 8 / K;
  const int chain_threads = ((s_count + K - 1) / K + 31) / 32 * 32;
  int device = 0, shared_limit = 0;
  cudaError_t status = cudaGetDevice(&device);
  if (status == cudaSuccess)
    status = cudaDeviceGetAttribute(&shared_limit, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                                    device);
  if (status != cudaSuccess) return static_cast<int>(status);
  const int capacity = segment_capacity(s_count, class_count);
  const int fixed_bytes =
      (4 * chain_threads + 2 * kWindowFrames * class_count + 2 * class_count + capacity + 2) *
      4;
  const int group_bytes = (2 * s_count + capacity) * 4;
  // Steps a half holds: a multiple of kAhead, at least kAhead; the sort's scratch
  // (2 S ints) lives in the ring before the loop.
  int group = min(kMaxGroup, (shared_limit - fixed_bytes) / group_bytes);
  group = group / kAhead * kAhead;
  if (group < kAhead) return static_cast<int>(cudaErrorInvalidValue);
  const int shared_bytes = fixed_bytes + group * group_bytes;
  if (shared_bytes > 48 * 1024) {
    status = cudaFuncSetAttribute(ctc_beta_grad_kernel<K>,
                                  cudaFuncAttributeMaxDynamicSharedMemorySize, shared_bytes);
    if (status != cudaSuccess) return static_cast<int>(status);
  }
  ctc_beta_grad_kernel<K><<<batch, chain_threads + kReducerThreads, shared_bytes, stream>>>(
      log_probs, extended, skip, lengths, s_counts, alphas, final_log_prob, grad_out, grad,
      betas, batch, t_max, class_count, s_count, group, chain_threads);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// C entry point (loaded with ctypes). log_probs (B, T, C) fp32, extended (B, S) int32,
// skip (B, S) uint8 (the forward's skip mask, not shifted), lengths and s_counts (B,)
// int32, alphas (T, B, S) fp32 (K1's output), final_log_prob and grad_out (B,) fp32,
// grad (B, T, C) fp32, betas (T, B, S) fp32 or null, all contiguous on one device. One
// block per row on `stream`; allocates nothing; returns the launch's cudaError_t (0 =
// success), or cudaErrorInvalidValue when S exceeds 16 * 1024 states or the row's
// shared memory does not fit.
extern "C" int ctc_beta_grad(const float* log_probs, const int* extended,
                             const unsigned char* skip, const int* lengths,
                             const int* s_counts, const float* alphas,
                             const float* final_log_prob, const float* grad_out, float* grad,
                             float* betas, int batch, int t_max, int class_count,
                             int s_count, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
#define CTC_BETA_GRAD_LAUNCH(K)                                                          \
  return launch<K>(log_probs, extended, skip, lengths, s_counts, alphas, final_log_prob, \
                   grad_out, grad, betas, batch, t_max, class_count, s_count, st)
  if (s_count > 16 * 1024) return static_cast<int>(cudaErrorInvalidValue);
  if (s_count <= kMaxChainThreads) CTC_BETA_GRAD_LAUNCH(1);
  if (s_count <= 2 * kMaxChainThreads) CTC_BETA_GRAD_LAUNCH(2);
  if (s_count <= 4 * kMaxChainThreads) CTC_BETA_GRAD_LAUNCH(4);
  if (s_count <= 8 * kMaxChainThreads) CTC_BETA_GRAD_LAUNCH(8);
  if (s_count <= 16 * kMaxChainThreads) CTC_BETA_GRAD_LAUNCH(16);
  CTC_BETA_GRAD_LAUNCH(32);
#undef CTC_BETA_GRAD_LAUNCH
}
