// The token-buffer stitch and the best-lane ranking of one streaming beam chunk,
// hand-written for Hopper.
//
// Replaces the stitch and the ranking of the TPU kernel path
// speechless_tpu/ops/decode_incremental_pallas.py::_pallas_stream_core (lines 124-178;
// the frame loop before them runs the beam-step kernel, csrc/lm_beam_step.cu). For each
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
// What bounds it on the H100: a dependent pointer chase, not bytes. The function must
// move the entry buffers in and the new buffers out (N * r * max_len * 8 bytes, 1 MB at
// the serving shape: 0.3 us at 3.35 TB/s), but each lane's walk is F dependent loads.
// What the design does about it: one block per stream. The chunk's backpointers (8 KB
// at F=32, r=32) are staged in shared memory, so the chase reads shared memory, and
// each thread walks one lane twice: once for the ancestor and the emission count, once
// to write its emitted chars straight to their final places (the count fixes where the
// walk's last char goes). The rows' copied prefixes and -1 tails are then written by
// the whole block, row by row, with neighbouring threads on neighbouring addresses.
// The new buffers are a second array: a lane reads other lanes' entry rows, so the
// kernel never writes in place. Allocates nothing.
#include <climits>
#include <cuda_runtime.h>
#include <math_constants.h>

namespace {

constexpr int kThreads = 256;
// Dynamic shared memory a launch may take without opting in (48 KB less room for the
// kernel's static word).
constexpr int kStagedBytes = 47 * 1024;

// a ranks before b in torch.argmax's order: larger first, NaN largest.
__device__ __forceinline__ bool ranks_before(float a, int ia, float b, int ib) {
  const bool a_nan = isnan(a), b_nan = isnan(b);
  if (a_nan != b_nan) return a_nan;
  if (!a_nan && a != b) return a > b;
  return ia < ib;
}

__global__ void __launch_bounds__(kThreads)
stream_stitch_kernel(const int* __restrict__ parents, const int* __restrict__ chars,
                     const int* __restrict__ tokens, const int* __restrict__ prev_len,
                     const int* __restrict__ new_len, const float* __restrict__ final_score,
                     int* __restrict__ rows, int* __restrict__ best_rows,
                     float* __restrict__ scalars, int frames, int lanes, int max_len,
                     bool staged) {
  extern __shared__ int shared[];
  int* ancestor = shared;            // [lanes]
  int* emitted = ancestor + lanes;   // [lanes]
  int* last_char = emitted + lanes;  // [lanes]: the lane's latest emitted char
  __shared__ int best_lane;

  const int n = blockIdx.x;
  const int tid = threadIdx.x;
  const size_t pointers = static_cast<size_t>(frames) * lanes;
  const int* row_parents = parents + n * pointers;
  const int* row_chars = chars + n * pointers;
  if (staged) {
    int* staged_parents = last_char + lanes;
    int* staged_chars = staged_parents + pointers;
    for (size_t i = tid; i < pointers; i += blockDim.x) {
      staged_parents[i] = row_parents[i];
      staged_chars[i] = row_chars[i];
    }
    row_parents = staged_parents;
    row_chars = staged_chars;
    __syncthreads();
  }
  const int* entry_len = prev_len + static_cast<size_t>(n) * lanes;
  const int* exit_len = new_len + static_cast<size_t>(n) * lanes;
  const float* scores = final_score + static_cast<size_t>(n) * lanes;
  const int* old_rows = tokens + static_cast<size_t>(n) * lanes * max_len;
  int* new_rows = rows + static_cast<size_t>(n) * lanes * max_len;

  // 1. Each lane's ancestor at chunk entry, its emission count and its latest char.
  for (int lane = tid; lane < lanes; lane += blockDim.x) {
    int b = lane, count = 0, latest = -1;
    for (int t = frames - 1; t >= 0; --t) {
      const int c = row_chars[t * lanes + b];
      if (c >= 0) {
        if (count == 0) latest = c;
        ++count;
      }
      b = min(max(row_parents[t * lanes + b], 0), lanes - 1);
    }
    ancestor[lane] = b;
    emitted[lane] = count;
    last_char[lane] = latest;
  }
  __syncthreads();

  // 2. Each lane's emitted chars, walked again from the end: the i-th from the end is
  //    packed[count - 1 - i], at position entry + count - 1 - i.
  for (int lane = tid; lane < lanes; lane += blockDim.x) {
    const int count = emitted[lane];
    const int entry = entry_len[ancestor[lane]];
    const int stop = min(exit_len[lane], max_len);
    int* out = new_rows + static_cast<size_t>(lane) * max_len;
    int b = lane, i = 0;
    for (int t = frames - 1; t >= 0 && i < count; --t) {
      const int c = row_chars[t * lanes + b];
      if (c >= 0) {
        const int position = entry + count - 1 - i;
        if (position < stop) out[position] = c;
        ++i;
      }
      b = min(max(row_parents[t * lanes + b], 0), lanes - 1);
    }
  }

  // 3. Everything else of every row, by the whole block: the entry prefix copied from
  //    the ancestor's old row, -1 from new_len on, and past the packed chars
  //    packed[F-1] (-1 unless every frame emitted).
  for (int lane = 0; lane < lanes; ++lane) {
    const int a = ancestor[lane];
    const int entry = entry_len[a];
    const int count = emitted[lane];
    const int stop = exit_len[lane];
    const int tail = count == frames ? last_char[lane] : -1;
    const int* source = old_rows + static_cast<size_t>(a) * max_len;
    int* out = new_rows + static_cast<size_t>(lane) * max_len;
    for (int j = tid; j < max_len; j += blockDim.x) {
      if (j >= stop) {
        out[j] = -1;
      } else if (j < entry) {
        out[j] = source[j];
      } else if (j >= entry + count) {
        out[j] = tail;
      }  // else: an emitted char, written in step 2
    }
  }

  // 4. The best lane (first of the largest scores) and the longest live length.
  if (tid < 32) {
    float best_score = -CUDART_INF_F;
    int best = INT_MAX, longest = 0;
    for (int lane = tid; lane < lanes; lane += 32) {
      if (ranks_before(scores[lane], lane, best_score, best)) {
        best_score = scores[lane];
        best = lane;
      }
      longest = max(longest, exit_len[lane]);
    }
    for (int offset = 16; offset > 0; offset >>= 1) {
      const float other_score = __shfl_down_sync(0xffffffffu, best_score, offset);
      const int other = __shfl_down_sync(0xffffffffu, best, offset);
      longest = max(longest, __shfl_down_sync(0xffffffffu, longest, offset));
      if (other != INT_MAX && ranks_before(other_score, other, best_score, best)) {
        best_score = other_score;
        best = other;
      }
    }
    if (tid == 0) {
      best_lane = best;
      scalars[3 * n] = static_cast<float>(exit_len[best]);
      scalars[3 * n + 1] = best_score;
      scalars[3 * n + 2] = static_cast<float>(longest);
    }
  }
  __syncthreads();  // the rows and best_lane are visible to the whole block

  // 5. The best lane's new row.
  const int* best_row = new_rows + static_cast<size_t>(best_lane) * max_len;
  int* out = best_rows + static_cast<size_t>(n) * max_len;
  for (int j = tid; j < max_len; j += blockDim.x) out[j] = best_row[j];
}

}  // namespace

// C entry point (loaded with ctypes). parents, chars (N, F, r) int32; tokens (N, r,
// max_len) int32; prev_len, new_len (N, r) int32; final_score (N, r) fp32; outputs rows
// (N, r, max_len) int32 (not aliasing tokens), best_rows (N, max_len) int32, scalars
// (N, 3) fp32; all contiguous on one device. One block per stream on `stream`; returns
// the launch's cudaError_t (0 = success), or cudaErrorInvalidValue for F < 1 or more
// lanes than the per-lane shared arrays hold.
extern "C" int stream_stitch(const int* parents, const int* chars, const int* tokens,
                             const int* prev_len, const int* new_len,
                             const float* final_score, int* rows, int* best_rows,
                             float* scalars, int streams, int frames, int lanes,
                             int max_len, void* stream) {
  const int lane_bytes = 3 * lanes * static_cast<int>(sizeof(int));
  if (frames < 1 || lane_bytes > kStagedBytes) return static_cast<int>(cudaErrorInvalidValue);
  if (streams == 0) return 0;
  const long long staged_bytes =
      lane_bytes + 2LL * frames * lanes * static_cast<long long>(sizeof(int));
  const bool staged = staged_bytes <= kStagedBytes;
  stream_stitch_kernel<<<streams, kThreads, staged ? staged_bytes : lane_bytes,
                         static_cast<cudaStream_t>(stream)>>>(
      parents, chars, tokens, prev_len, new_len, final_score, rows, best_rows, scalars,
      frames, lanes, max_len, staged);
  return static_cast<int>(cudaGetLastError());
}
