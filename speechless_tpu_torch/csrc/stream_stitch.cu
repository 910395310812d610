// The token-buffer stitch and the best-lane ranking of one streaming beam chunk,
// hand-written for Hopper.
//
// Replaces the stitch and the ranking of the TPU kernel path
// speechless_tpu/ops/decode_incremental_pallas.py::_pallas_stream_core (lines 124-178;
// the frame loop before them runs the span kernel, csrc/lm_beam_span.cu). For each
// stream n and lane l, with the chunk's F frames of backpointers (parent lane, emitted
// char or -1):
//   * walk back from lane l through the F frames to its ancestor lane a at chunk entry,
//     collecting the chars it emitted in time order ("packed", -1 after the last);
//   * new row: tokens[a][j] for j < prev_len[a], then packed[min(j - prev_len[a], F-1)],
//     and -1 from new_len[l] on;
//   * best = the first lane with the largest final score (NaN ranks highest, as in
//     torch.argmax); best row = the new row of that lane; scalars = (new_len[best],
//     final[best], max over lanes of new_len), in fp32.
// The plain PyTorch twin is speechless_tpu_torch/ops/decode_incremental_kernel.py::
// stitch_reference.
//
// What bounds it on the H100: latency. The function must move the entry buffers' live
// prefixes in and the new buffers out (1.2 MB at the serving shape: 0.36 us at
// 3.35 TB/s), behind a chase of F dependent backpointer reads per lane. The design:
//   * a stream's rows are spread over several CTAs, one warp a row (at N=16, r=32: 8
//     CTAs of 4 warps a stream, 128 CTAs), so all rows are in flight at once;
//   * each CTA stages the stream's backpointers (8 KB at F=32, r=32) and the small
//     inputs (entry and exit lengths, scores) in shared memory by cp.async, behind
//     one barrier; no later step waits on a read from device memory for a length;
//   * each warp ranks the lanes itself from the staged scores (a warp reduction), so
//     the best lane is known before any row is written, and lane 0 chases its row's
//     lane back through shared memory, keeping the emitted chars in shared memory;
//   * the warp then writes its row in 16-byte vectors (the ancestor's prefix read in
//     16-byte vectors, the emitted chars, the tail, -1 from new_len on), and the warp
//     of the best lane writes the same vectors to best_rows.
// The new buffers are a second array: a lane reads other lanes' entry rows, so the
// kernel never writes in place. Allocates nothing.
#include <climits>
#include <cuda_runtime.h>
#include <math_constants.h>

namespace {

constexpr int kSharedLimit = 227 * 1024;  // dynamic shared memory a block may opt into

struct Layout {
  int ctas;        // CTAs a stream
  int warps;       // warps (rows) a CTA
  int staged;      // backpointers staged in shared memory (else read from device memory)
  int shared_bytes;
};

// a ranks before b in torch.argmax's order: larger first, NaN largest.
__device__ __forceinline__ bool ranks_before(float a, int ia, float b, int ib) {
  const bool a_nan = isnan(a), b_nan = isnan(b);
  if (a_nan != b_nan) return a_nan;
  if (!a_nan && a != b) return a > b;
  return ia < ib;
}

__device__ __forceinline__ void copy_async4(void* shared, const void* global) {
  const unsigned address = static_cast<unsigned>(__cvta_generic_to_shared(shared));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(address), "l"(global)
               : "memory");
}
__device__ __forceinline__ void copy_async16(void* shared, const void* global) {
  const unsigned address = static_cast<unsigned>(__cvta_generic_to_shared(shared));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(address), "l"(global)
               : "memory");
}

// Copy `count` contiguous words into shared memory (16 bytes a copy where the source
// allows it; `shared` is 16-byte aligned), not waited for.
__device__ void stage(int* shared, const int* global, int count) {
  if ((reinterpret_cast<size_t>(global) & 15) == 0 && (count & 3) == 0) {
    for (int i = 4 * threadIdx.x; i < count; i += 4 * blockDim.x)
      copy_async16(shared + i, global + i);
  } else {
    for (int i = threadIdx.x; i < count; i += blockDim.x) copy_async4(shared + i, global + i);
  }
}

// One row element: the ancestor's prefix, the emitted chars, the tail, -1 from stop on.
__device__ __forceinline__ int element(int j, int old, int entry, int count, int stop,
                                       int tail, const int* packed_reversed) {
  if (j >= stop) return -1;
  if (j < entry) return old;
  if (j < entry + count) return packed_reversed[count - 1 - (j - entry)];
  return tail;
}

// kVector words of a row from position j (-1s where `live` is false), and their store.
template <int kVector>
__device__ __forceinline__ int4 load_words(const int* row, int j, bool live) {
  if (!live) return make_int4(-1, -1, -1, -1);
  if (kVector == 4) return *reinterpret_cast<const int4*>(row + j);
  return make_int4(row[j], -1, -1, -1);
}
template <int kVector>
__device__ __forceinline__ void store_words(int* row, int j, int4 words) {
  if (kVector == 4) {
    *reinterpret_cast<int4*>(row + j) = words;
  } else {
    row[j] = words.x;
  }
}

// Vectors a lane reads of its row's entry prefix before the rank (512 words at kVector
// 4), so that the reads are in flight while the warp ranks.
constexpr int kReadAhead = 4;

// kVector: 4 where max_len is a multiple of 4 (16-byte row copies), else 1. kStaged:
// the backpointers staged in shared memory (else the chase reads device memory); a
// template argument, so that the staged chase compiles to shared-memory loads.
template <int kVector, bool kStaged>
__global__ void __launch_bounds__(1024)
stream_stitch_kernel(const int* __restrict__ parents, const int* __restrict__ chars,
                     const int* __restrict__ tokens, const int* __restrict__ prev_len,
                     const int* __restrict__ new_len, const float* __restrict__ final_score,
                     int* __restrict__ rows, int* __restrict__ best_rows,
                     float* __restrict__ scalars, int frames, int lanes, int max_len,
                     Layout layout) {
  extern __shared__ __align__(16) int shared[];
  const int n = blockIdx.x / layout.ctas;
  const int part = blockIdx.x - n * layout.ctas;
  const int warp = threadIdx.x >> 5, lane_id = threadIdx.x & 31;
  const int lane_words = (lanes + 3) & ~3;
  int* entry_len = shared;                                          // [lanes]
  int* exit_len = entry_len + lane_words;                           // [lanes]
  float* scores = reinterpret_cast<float*>(exit_len + lane_words);  // [lanes]
  int* packed = reinterpret_cast<int*>(scores + lane_words);        // [warps][frames]
  int* staged_parents = packed + ((layout.warps * frames + 3) & ~3);
  int* staged_chars = staged_parents + ((frames * lanes + 3) & ~3);
  const int pointers = frames * lanes;
  const int* row_parents = parents + static_cast<size_t>(n) * pointers;
  const int* row_chars = chars + static_cast<size_t>(n) * pointers;

  stage(entry_len, prev_len + static_cast<size_t>(n) * lanes, lanes);
  stage(exit_len, new_len + static_cast<size_t>(n) * lanes, lanes);
  stage(reinterpret_cast<int*>(scores),
        reinterpret_cast<const int*>(final_score) + static_cast<size_t>(n) * lanes, lanes);
  if (kStaged) {
    stage(staged_parents, row_parents, pointers);
    stage(staged_chars, row_chars, pointers);
  }
  asm volatile("cp.async.commit_group;\n" ::: "memory");
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
  __syncthreads();

  const int lane = part * layout.warps + warp;  // this warp's row
  if (lane >= lanes) return;

  // The chase: this row's ancestor at chunk entry and its emitted chars, latest first.
  const int* chase_parents = kStaged ? staged_parents : row_parents;
  const int* chase_chars = kStaged ? staged_chars : row_chars;
  int* packed_reversed = packed + warp * frames;
  int ancestor = lane, count = 0;
  if (lane_id == 0) {
    for (int t = frames - 1; t >= 0; --t) {
      // Both reads before the store, which the compiler may not move them past.
      const int c = chase_chars[t * lanes + ancestor];
      const int parent = chase_parents[t * lanes + ancestor];
      if (c >= 0) packed_reversed[count++] = c;
      ancestor = min(max(parent, 0), lanes - 1);
    }
  }
  ancestor = __shfl_sync(0xffffffffu, ancestor, 0);
  count = __shfl_sync(0xffffffffu, count, 0);
  __syncwarp();
  const int entry = entry_len[ancestor];
  const int stop = exit_len[lane];
  const int* old_row = tokens + (static_cast<size_t>(n) * lanes + ancestor) * max_len;
  int4 old[kReadAhead];
#pragma unroll
  for (int k = 0; k < kReadAhead; ++k) {
    const int j = kVector * (lane_id + 32 * k);
    old[k] = load_words<kVector>(old_row, j, j < max_len && j < entry && j < stop);
  }

  // The best lane (first of the largest scores) and the longest live length, ranked by
  // every warp from the staged scores while its reads are in flight.
  float best_score = -CUDART_INF_F;
  int best = INT_MAX, longest = 0;
  for (int l = lane_id; l < lanes; l += 32) {
    if (ranks_before(scores[l], l, best_score, best)) {
      best_score = scores[l];
      best = l;
    }
    longest = max(longest, exit_len[l]);
  }
  for (int offset = 16; offset > 0; offset >>= 1) {
    const float other_score = __shfl_xor_sync(0xffffffffu, best_score, offset);
    const int other = __shfl_xor_sync(0xffffffffu, best, offset);
    longest = max(longest, __shfl_xor_sync(0xffffffffu, longest, offset));
    if (other != INT_MAX && ranks_before(other_score, other, best_score, best)) {
      best_score = other_score;
      best = other;
    }
  }
  if (part == 0 && warp == 0 && lane_id == 0) {
    scalars[3 * n] = static_cast<float>(exit_len[best]);
    scalars[3 * n + 1] = best_score;
    scalars[3 * n + 2] = static_cast<float>(longest);
  }

  // The row, and the best row from the same registers.
  const int tail = count == frames ? packed_reversed[0] : -1;
  int* out = rows + (static_cast<size_t>(n) * lanes + lane) * max_len;
  int* best_out = lane == best ? best_rows + static_cast<size_t>(n) * max_len : nullptr;
  auto write = [&](int j, int4 words) {
    int4 value;
    value.x = element(j, words.x, entry, count, stop, tail, packed_reversed);
    if (kVector == 4) {
      value.y = element(j + 1, words.y, entry, count, stop, tail, packed_reversed);
      value.z = element(j + 2, words.z, entry, count, stop, tail, packed_reversed);
      value.w = element(j + 3, words.w, entry, count, stop, tail, packed_reversed);
    }
    store_words<kVector>(out, j, value);
    if (best_out) store_words<kVector>(best_out, j, value);
  };
#pragma unroll
  for (int k = 0; k < kReadAhead; ++k) {
    const int j = kVector * (lane_id + 32 * k);
    if (j < max_len) write(j, old[k]);
  }
  for (int j = kVector * (lane_id + 32 * kReadAhead); j < max_len; j += kVector * 32)
    write(j, load_words<kVector>(old_row, j, j < entry && j < stop));
}

// The launch layout: one warp a row, at least 4 and at most 32 warps a CTA, up to 8
// CTAs a stream (more where r > 256); the backpointers staged where they fit.
bool plan(int frames, int lanes, Layout* layout) {
  const int warps = min(32, max(4, (lanes + 7) / 8));
  const int lane_words = (lanes + 3) & ~3;
  const long long small = 3LL * lane_words + ((static_cast<long long>(warps) * frames + 3) & ~3LL);
  const long long pointer_words = 2LL * ((static_cast<long long>(frames) * lanes + 3) & ~3LL);
  if (small * 4 > kSharedLimit) return false;
  layout->warps = warps;
  layout->ctas = (lanes + warps - 1) / warps;
  layout->staged = (small + pointer_words) * 4 <= kSharedLimit;
  layout->shared_bytes = static_cast<int>((layout->staged ? small + pointer_words : small) * 4);
  return true;
}

}  // namespace

// C entry point (loaded with ctypes). parents, chars (N, F, r) int32; tokens (N, r,
// max_len) int32; prev_len, new_len (N, r) int32; final_score (N, r) fp32; outputs rows
// (N, r, max_len) int32 (not aliasing tokens), best_rows (N, max_len) int32, scalars
// (N, 3) fp32; all contiguous on one device. Several CTAs per stream on `stream`;
// returns the launch's cudaError_t (0 = success), or cudaErrorInvalidValue for F < 1
// or a chunk whose per-row chase buffers do not fit in shared memory.
extern "C" int stream_stitch(const int* parents, const int* chars, const int* tokens,
                             const int* prev_len, const int* new_len,
                             const float* final_score, int* rows, int* best_rows,
                             float* scalars, int streams, int frames, int lanes,
                             int max_len, void* stream) {
  Layout layout;
  if (frames < 1 || lanes < 1 || !plan(frames, lanes, &layout))
    return static_cast<int>(cudaErrorInvalidValue);
  if (streams == 0) return 0;
  const bool vector = (max_len & 3) == 0;
  const int variant = 2 * vector + layout.staged;
  void (*const kernels[4])(const int*, const int*, const int*, const int*, const int*,
                           const float*, int*, int*, float*, int, int, int, Layout) = {
      stream_stitch_kernel<1, false>, stream_stitch_kernel<1, true>,
      stream_stitch_kernel<4, false>, stream_stitch_kernel<4, true>};
  static bool opted_in[4] = {false, false, false, false};
  if (!opted_in[variant]) {
    const cudaError_t status = cudaFuncSetAttribute(
        kernels[variant], cudaFuncAttributeMaxDynamicSharedMemorySize, kSharedLimit);
    if (status != cudaSuccess) return static_cast<int>(status);
    opted_in[variant] = true;
  }
  kernels[variant]<<<static_cast<unsigned>(streams) * layout.ctas, 32 * layout.warps,
                     layout.shared_bytes, static_cast<cudaStream_t>(stream)>>>(
      parents, chars, tokens, prev_len, new_len, final_score, rows, best_rows, scalars,
      frames, lanes, max_len, layout);
  return static_cast<int>(cudaGetLastError());
}
