// One frame of the word-LM-fused CTC prefix beam search, hand-written for Hopper.
//
// Replaces the TPU kernel speechless_tpu/ops/decode_pallas_lm.py::_lm_step_kernel and
// computes what it computes, bit for bit: the frame network of beam_step.cuh (expand,
// sort by prefix hash, segmented log-sum-exp merge with the LM score as a rider, sort
// on -(score + lm), keep the top W). The plain PyTorch twin is
// speechless_tpu_torch/ops/decode_lm.py::lm_step_reference.
//
// What bounds it on the H100: latency, not bytes or FLOPs. A row reads and writes a few
// KB per frame, but its candidates pass two bitonic sorts of n_pad lanes (45 dependent
// compare-exchange stages each at n_pad = 512, the serving shape) plus log2(n_pad)
// merge stages, every one a round of cross-lane exchange, once per frame.
// What the design does about it: one thread block per utterance row (rows are
// independent, so a batch spreads over the SMs) and one thread per candidate lane;
// partners closer than a warp are exchanged by shuffles (35 of the 45 stages), and the
// sorts carry a source lane instead of the payloads. Everything stays in registers and
// shared memory; the kernel allocates nothing.
//
// The LM gathers (trie walk, cuckoo probes, word bonuses) run as torch ops between
// frames, as they ran as XLA ops outside the Pallas kernel.
#include "beam_step.cuh"

namespace {

__global__ void lm_beam_step_kernel(
    const float* __restrict__ frame, const float* __restrict__ pb,
    const float* __restrict__ pnb, const int* __restrict__ hash,
    const int* __restrict__ last, const int* __restrict__ len,
    const float* __restrict__ lm, const float* __restrict__ bonus,
    float* __restrict__ out_pb, float* __restrict__ out_pnb, int* __restrict__ out_hash,
    int* __restrict__ out_last, int* __restrict__ out_len, float* __restrict__ out_lm,
    int* __restrict__ out_idx, int frame_width, int r, int k, int class_count, int blank,
    int beam_width, int max_len, int space_index) {
  extern __shared__ int smem[];
  const size_t row = blockIdx.x;
  const size_t at = row * r;  // this row's r state lanes
  beam::beam_step(frame + row * frame_width, pb + at, pnb + at, hash + at, last + at,
                  len + at, lm + at, bonus + at, out_pb + at, out_pnb + at, out_hash + at,
                  out_last + at, out_len + at, out_lm + at, out_idx + at, smem, r, k,
                  class_count, blank, beam_width, max_len, space_index);
}

}  // namespace

// C entry point (loaded with ctypes). Launches one block of n_pad threads per row on
// `stream`, allocates nothing, and returns the launch's cudaError_t (0 = success).
extern "C" int lm_beam_step(const float* frame, const float* pb, const float* pnb,
                            const int* hash, const int* last, const int* len,
                            const float* lm, const float* bonus, float* out_pb,
                            float* out_pnb, int* out_hash, int* out_last, int* out_len,
                            float* out_lm, int* out_idx, int batch, int frame_width, int r,
                            int k, int n_pad, int class_count, int blank, int beam_width,
                            int max_len, int space_index, void* stream) {
  const int shared_bytes = beam::kScratchArrays * n_pad * static_cast<int>(sizeof(int));
  if (shared_bytes > 48 * 1024) {
    const cudaError_t status = cudaFuncSetAttribute(
        lm_beam_step_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, shared_bytes);
    if (status != cudaSuccess) return static_cast<int>(status);
  }
  lm_beam_step_kernel<<<batch, n_pad, shared_bytes, static_cast<cudaStream_t>(stream)>>>(
      frame, pb, pnb, hash, last, len, lm, bonus, out_pb, out_pnb, out_hash, out_last,
      out_len, out_lm, out_idx, frame_width, r, k, class_count, blank, beam_width, max_len,
      space_index);
  return static_cast<int>(cudaGetLastError());
}
