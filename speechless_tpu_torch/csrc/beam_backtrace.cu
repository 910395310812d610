// The beam backtrace on the device: each row's winning prefix rebuilt from its
// per-frame backpointers, hand-written for Hopper.
//
// Not a TPU kernel: it replaces the XLA gathers of speechless_tpu/ops/decode_jax.py::
// backtrace_tokens (ported as speechless_tpu_torch/ops/beam_common.py::backtrace_tokens,
// its plain PyTorch twin), which launch two small gathers per frame from the host. One
// warp per row: lane 0 follows the parent pointers from the row's best final beam back
// to the first frame, writing the character each frame emitted (or -1) to a (B, T)
// scratch row; then the warp front-compacts the emitted characters in time order, 32
// frames a ballot, into (B, max_len) tokens, -1 past the row's count.
//
// What bounds it on the H100: latency. The walk is T dependent loads (the next parent
// is read from the lane the last one named), each an L2 round trip since the beam
// kernels have just written the pointers; the bytes it needs, two words a frame and
// the tokens, take well under a microsecond. What the design does about it: one launch
// for every row at once instead of two host-launched gathers a frame.
#include <cuda_runtime.h>

namespace {

__global__ void beam_backtrace_kernel(const int* __restrict__ parents,
                                      const int* __restrict__ chars,
                                      const int* __restrict__ best,
                                      const int* __restrict__ counts,
                                      int* __restrict__ path, int* __restrict__ tokens,
                                      int t_max, int r, int max_len) {
  const int lane = threadIdx.x;
  const size_t row = blockIdx.x;
  int* row_path = path + row * t_max;
  if (lane == 0) {
    int beam = best[row];
    for (int t = t_max - 1; t >= 0; --t) {
      const size_t at = (row * t_max + t) * r + beam;
      row_path[t] = chars[at];
      beam = parents[at];
    }
  }
  __syncwarp();
  const int count = counts[row];
  int* row_tokens = tokens + row * max_len;
  // Front-compact: the i-th emitted character (in time order) goes to position i.
  int emitted = 0;
  for (int base = 0; base < t_max; base += 32) {
    const int t = base + lane;
    const int c = t < t_max ? row_path[t] : -1;
    const unsigned ballot = __ballot_sync(0xffffffffu, c >= 0);
    const int at = emitted + __popc(ballot & ((1u << lane) - 1u));
    if (c >= 0 && at < count && at < max_len) row_tokens[at] = c;
    emitted += __popc(ballot);
  }
  // Past the emitted ones: -1, except that positions past t_max repeat the last packed
  // entry, as backtrace_tokens' clamped gather does (an emitted char only when every
  // frame emitted).
  const int last = row_path[t_max - 1];
  for (int i = lane; i < max_len; i += 32) {
    if (i < min(emitted, count)) continue;
    row_tokens[i] = (i < count && i >= t_max && emitted == t_max) ? last : -1;
  }
}

}  // namespace

// C entry point (loaded with ctypes). Launches one warp per row on `stream`, allocates
// nothing (`path` is (batch, t_max) int32 scratch), and returns the launch's cudaError_t
// (0 = success). parents and chars are (batch, t_max, r) int32, best and counts
// (batch,) int32, tokens (batch, max_len) int32.
extern "C" int beam_backtrace(const int* parents, const int* chars, const int* best,
                              const int* counts, int* path, int* tokens, int batch,
                              int t_max, int r, int max_len, void* stream) {
  if (batch == 0) return 0;
  beam_backtrace_kernel<<<batch, 32, 0, static_cast<cudaStream_t>(stream)>>>(
      parents, chars, best, counts, path, tokens, t_max, r, max_len);
  return static_cast<int>(cudaGetLastError());
}
