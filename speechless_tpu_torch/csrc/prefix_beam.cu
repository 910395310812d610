// The whole-utterance CTC prefix beam without an LM, hand-written for Hopper.
//
// Replaces the TPU kernel speechless_tpu/ops/decode_pallas.py::_beam_kernel. One thread
// block runs one utterance through all its frames: the loop over frames inside the
// block takes the place of the TPU's sequential (batch, time blocks) grid, and nothing
// carries across blocks. The beam state (pb, pnb, hash, last char, length; r lanes)
// stays in shared memory from the first frame to the last. Each frame:
//
// * when the blank's log-prob exceeds skip_blank_log_prob (decode_pallas.py:236-245),
//   the fast path: only the blank / non-blank split of each beam updates; hash, last
//   char and length stay, and the backpointers are (own lane, no char);
// * otherwise the full update of beam_step.cuh with no LM rider (K4's step): expand,
//   merge equal prefix hashes with the min-index representative (decode_pallas.py:
//   323-330), keep the top W by -score with the index as secondary; the step's rank
//   network, or its sorted network when a hash gathers more than two live candidates.
//
// The next frame's packed row is copied into shared memory with cp.async while the
// current frame runs (two row buffers), so no frame waits on a device-memory load.
//
// Every frame's (parent, char) row goes to (B, T, r) int32 (rows past the utterance's
// length pass every beam through); the final pb, pnb and length to (B, r). The top-k
// packing (decode_lm.pack_frames), the winner and the backtrace stay torch ops, as
// they stayed XLA ops around the Pallas call. The plain PyTorch twin is
// speechless_tpu_torch/ops/decode_whole.py::prefix_beam_reference.
//
// What bounds it on the H100: latency. It moves ~3.6 MB at 16 x 513 frames (the
// frames in, the backpointers out: ~1.1 us at 3.35 TB/s), but each utterance is T
// dependent frames of ~100 barrier or shuffle stages (two bitonic sorts and the merge),
// and one block per utterance keeps 16 of the 132 SMs busy at B = 16. What the design
// does about it: no launch or host step between frames, the state never leaves shared
// memory, and the frame step pays a handful of barriers instead of ~40. Several
// utterances per block is later work.
#include "beam_step.cuh"

namespace {

constexpr int kEmptyHash = -2128831035;  // 0x811C9DC5 as int32
constexpr int kStateArrays = 6;          // pb, pnb, hash, last, len, selected index

__global__ void prefix_beam_kernel(
    const float* __restrict__ frames, const int* __restrict__ lengths,
    int* __restrict__ parents, int* __restrict__ chars, float* __restrict__ out_pb,
    float* __restrict__ out_pnb, int* __restrict__ out_len, int batch, int t_max,
    int frame_width, int r, int k, int class_count, int blank, int beam_width,
    int max_len, float skip_blank_log_prob) {
  extern __shared__ int smem[];
  const int n = blockDim.x;
  const int lane = threadIdx.x;
  const int row = blockIdx.x;
  float* st_pb = reinterpret_cast<float*>(smem + beam::kScratchWords * n);
  float* st_pnb = st_pb + r;
  int* st_hash = reinterpret_cast<int*>(st_pnb + r);
  int* st_last = st_hash + r;
  int* st_len = st_last + r;
  int* st_idx = st_len + r;
  float* rows = reinterpret_cast<float*>(st_idx + r);  // two packed frame rows

  if (lane < r) {  // one live empty prefix in lane 0
    st_pb[lane] = lane == 0 ? 0.f : beam::kNegInf;
    st_pnb[lane] = beam::kNegInf;
    st_hash[lane] = lane == 0 ? kEmptyHash : 0;
    st_last[lane] = -1;
    st_len[lane] = 0;
  }
  beam::init_scratch(smem);
  const int length = min(max(lengths[row], 0), t_max);
  if (length > 0) beam::prefetch_row(rows, frames + static_cast<size_t>(row) * frame_width,
                                     frame_width);
  for (int t = 0; t < length; ++t) {
    __pipeline_wait_prior(0);
    __syncthreads();  // frame t has landed; every thread is done with frame t - 1
    const float* fr = rows + (t & 1) * frame_width;
    if (t + 1 < length) {
      beam::prefetch_row(rows + ((t + 1) & 1) * frame_width,
                         frames + (static_cast<size_t>(t + 1) * batch + row) * frame_width,
                         frame_width);
    }
    const size_t out = (static_cast<size_t>(row) * t_max + t) * r;
    const float lp_blank = fr[2 * k + blank];
    if (lp_blank > skip_blank_log_prob) {  // the same branch for the whole block
      if (lane < r) {
        const float pb = st_pb[lane], pnb = st_pnb[lane];
        const int last = st_last[lane];
        const float total = beam::logaddexp(pb, pnb);
        const bool valid = total > beam::kAliveFloor;
        const float lp_last =
            (last >= 0 && last < class_count) ? fr[2 * k + last] : beam::kNegInf;
        st_pb[lane] = valid ? total + lp_blank : beam::kNegInf;
        st_pnb[lane] = (valid && last >= 0) ? pnb + lp_last : beam::kNegInf;
        parents[out + lane] = lane;
        chars[out + lane] = -1;
      }
    } else {
      beam::beam_step(fr, st_pb, st_pnb, st_hash, st_last, st_len, nullptr, nullptr,
                      st_pb, st_pnb, st_hash, st_last, st_len, nullptr, st_idx, smem, r,
                      k, class_count, blank, beam_width, max_len, -2);
      __syncthreads();  // a beam slot may be written by another lane's candidate
      if (lane < r) {
        const int idx = st_idx[lane];
        parents[out + lane] = idx / (k + 1);
        chars[out + lane] = idx % (k + 1) > 0 ? st_last[lane] : -1;
      }
    }
  }
  // Frames past the utterance's length pass every beam through.
  const size_t tail = static_cast<size_t>(t_max - length) * r;
  const size_t tail_at = (static_cast<size_t>(row) * t_max + length) * r;
  for (size_t i = lane; i < tail; i += n) {
    parents[tail_at + i] = static_cast<int>(i % r);
    chars[tail_at + i] = -1;
  }
  __syncthreads();
  if (lane < r) {
    const size_t at = static_cast<size_t>(row) * r + lane;
    out_pb[at] = st_pb[lane];
    out_pnb[at] = st_pnb[lane];
    out_len[at] = st_len[lane];
  }
}

}  // namespace

// C entry point (loaded with ctypes). Launches one block of n_pad threads per
// utterance on `stream`, allocates nothing, and returns the launch's cudaError_t
// (0 = success). `frames` is (t_max, batch, frame_width) as decode_lm.pack_frames
// lays it out; frames whose blank log-prob exceeds skip_blank_log_prob (+inf: none)
// take the fast path.
extern "C" int prefix_beam(const float* frames, const int* lengths, int* parents,
                           int* chars, float* out_pb, float* out_pnb, int* out_len,
                           int batch, int t_max, int frame_width, int r, int k, int n_pad,
                           int class_count, int blank, int beam_width, int max_len,
                           float skip_blank_log_prob, void* stream) {
  if (batch == 0) return 0;
  const int shared_bytes = static_cast<int>(sizeof(int)) *
                           (beam::kScratchWords * n_pad + kStateArrays * r + 2 * frame_width);
  if (shared_bytes > 48 * 1024) {
    const cudaError_t status = cudaFuncSetAttribute(
        prefix_beam_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, shared_bytes);
    if (status != cudaSuccess) return static_cast<int>(status);
  }
  prefix_beam_kernel<<<batch, n_pad, shared_bytes, static_cast<cudaStream_t>(stream)>>>(
      frames, lengths, parents, chars, out_pb, out_pnb, out_len, batch, t_max,
      frame_width, r, k, class_count, blank, beam_width, max_len, skip_blank_log_prob);
  return static_cast<int>(cudaGetLastError());
}
