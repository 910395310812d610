// Pieces shared by the CTC kernels K1 (ctc_alpha.cu) and the fused backward
// (ctc_beta_grad.cu): the clamped log-sum-exp of the JAX package, the asynchronous
// global -> shared copies that stage a row's emissions ahead of the recursion, and the
// layout of the states over the threads.
//
// State layout: thread i of a row's block owns the K consecutive states iK .. iK+K-1 and
// keeps their values in registers. A step needs the neighbours s-1, s-2 (alpha) or s+1,
// s+2 (beta); inside a thread they are registers, across a thread edge they come from
// `published`, where every thread leaves the two values its neighbour needs: its last
// two states for alpha, its first two for beta (for K = 1 its single state, read from
// one and two threads away). `published` is double-buffered by step parity, so one
// barrier a step separates its reads from the next step's writes.
#pragma once
#include <cuda_runtime.h>

namespace ctc {

constexpr float kNegInf = -1e30f;

// speechless_tpu/ops/ctc.py::_logsumexp3: the max clamped at NEG_INF, so that three
// NEG_INF inputs give NEG_INF + log 3 and never a NaN. IEEE expf/logf (no fast math),
// in the plain version's order, so the kernels equal it bit for bit.
__device__ __forceinline__ float logsumexp3(float a, float b, float c) {
  const float m = fmaxf(fmaxf(fmaxf(a, b), c), kNegInf);
  return m + logf(expf(a - m) + expf(b - m) + expf(c - m));
}

// One 4-byte asynchronous copy global -> shared (no alignment is assumed: a row of
// (T, C) log-probs starts wherever row * T * C floats puts it).
__device__ __forceinline__ void copy_async(float* shared, const float* global) {
  const unsigned address = static_cast<unsigned>(__cvta_generic_to_shared(shared));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(address), "l"(global)
               : "memory");
}
__device__ __forceinline__ void commit_copies() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
// Wait until at most `kPending` of this thread's committed groups are still in flight.
template <int kPending>
__device__ __forceinline__ void wait_copies() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kPending) : "memory");
}

// Copy `count` contiguous floats with threads 0 .. threads-1 (not committed).
__device__ __forceinline__ void copy_span_async(float* shared, const float* global,
                                                int count, int threads) {
  for (int i = threadIdx.x; i < count; i += threads) copy_async(shared + i, global + i);
}

// Slots of `published` (per parity: 2 * threads floats) where the value of state s is
// left by its owner, for states that are among the two an owner publishes.
template <int K>
__device__ __forceinline__ int alpha_slot(int s) {  // s is one of the owner's last two
  return K == 1 ? s : 2 * (s / K) + (s % K) - (K - 2);
}
template <int K>
__device__ __forceinline__ int beta_slot(int s) {  // s is one of the owner's first two
  return K == 1 ? s : 2 * (s / K) + (s % K);
}

}  // namespace ctc
