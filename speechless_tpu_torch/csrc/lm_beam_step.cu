// One frame of the word-LM-fused CTC prefix beam search, hand-written for Hopper: the
// single-frame test entry of the shared frame step.
//
// No serving path launches it any more: offline decoding and streaming run every frame
// of a span in one launch of lm_beam_span.cu (K4, the port of
// speechless_tpu/ops/decode_pallas_lm.py::_lm_step_kernel). This entry runs the same
// beam::beam_step of beam_step.cuh on one frame of given states, so that chip_smoke.py
// can hold the step against speechless_tpu_torch/ops/decode_lm.py::lm_step_reference on
// states no decode produces: random bonuses and duplicate live hashes, which take the
// step's sorted network (its exactness branch).
//
// One thread block per row, one thread per candidate lane; the step's scratch (the
// sorted network's arrays and the rank network's hash table) lives in dynamic shared
// memory. The kernel allocates nothing.
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
  beam::init_scratch(smem);
  __syncthreads();
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
  const int shared_bytes = beam::kScratchWords * n_pad * static_cast<int>(sizeof(int));
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
