// Data gradient of a SAME-padded stride-1 bf16 conv, hand-written for Hopper.
//
// Replaces no TPU kernel: the JAX package leaves its convs to XLA. It replaces cuDNN's
// legacy `dgrad_engine<bf16, 128, 6, 7, 3, 3, 5>`, which cuDNN picks for big_conv_1's
// data gradient (2000 -> 250 channels, 32 taps) and which ran at ~25 TFLOP/s, three
// quarters of a resident training step. The plain PyTorch twin is
// speechless_tpu_torch/ops/conv_dgrad.py::dgrad_reference. For each batch row b:
//   dX[b, ci, s] = sum over taps k and output channels co of
//                  W[co, ci, k] * dY[b, co, s + pad_low - k]   (zero outside 0 <= . < T)
// i.e. dX^T (T x Cin) = sum_k shift_k(dY^T) (T x Cout) . W_k (Cout x Cin): an implicit
// GEMM with M = frames, N = Cin (zero-padded to 256) and a reduction over Cout x K
// (64,000 for big_conv_1), accumulated in fp32 and rounded once to bf16.
//
// What bounds it on the H100: the tensor cores. At the training cell's shape (B=64,
// T=1536, Cout=2000, Cin=250, K=32) it is 3.15 TFLOP, 3.18 ms at 989 TFLOP/s bf16,
// against 0.47 GB of dY, W and dX (0.14 ms at 3.35 TB/s). The design:
//   * a persistent grid, one block per SM, walks (batch row, 128-frame) tiles;
//   * warpgroup 0 is the producer: one thread keeps TMA loads in flight into a ring of
//     four 48 KB shared-memory stages, each one (64 output channels, tap k) slice of the
//     reduction: dY's 128 frames from frame s0 + pad_low - k, channels co..co+63, and
//     W_k's 256 x 64 (input x output channels) box. TMA's zero fill outside the tensor
//     gives SAME's edges, a ragged T and the last partial channel block with no
//     masking code, and the 32 taps' reads of one dY window come from L2;
//   * TMA moves the contiguous dimension only in 16-byte steps, so a one-frame shift
//     needs frames as rows: a first kernel copies dY to (B, T, Cout') through 64 x 64
//     shared-memory tiles (0.8 GB of traffic at the cell's shape; PyTorch's strided
//     copy took ~2.3 ms of it, the tiles read and write whole sectors);
//   * warpgroups 1 and 2 are consumers, 64 frames each: wgmma m64n256k16 with both
//     operands K-major (output channels contiguous) and 128-byte swizzled, fp32
//     accumulators in registers (128 a thread), one wgmma group kept in flight while
//     the stage before it is handed back to the producer;
//   * the epilogue rounds each sum to bf16 once and stores dX at its unpadded
//     (B, Cin, T) place, only for the Cin real channels and the T real frames.
// The wrapper lays W out as (K, 256, Cout') bf16 (Cin zero-padded, Cout' the next
// multiple of 8, TMA's 16-byte row rule) and allocates dY's frame-major copy; the
// kernels allocate nothing. A barrier wait of seconds can only be a fault, and traps
// rather than hold the card.
#include <cstdint>
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kTileFrames = 128;                       // M of a tile: 64 a consumer
constexpr int kChannels = 256;                         // N: input channels, padded
constexpr int kBlockK = 64;                            // output channels a stage
constexpr int kStages = 4;
constexpr int kHalfBytes = 64 * kBlockK * 2;           // one consumer's dY rows, 8 KB
constexpr int kWeightOffset = 2 * kHalfBytes;          // W_k's box after dY's
constexpr int kStageBytes = kWeightOffset + kChannels * kBlockK * 2;  // 48 KB
constexpr int kThreads = 384;                          // producer + two consumers
constexpr int kConsumerWarps = 8;
constexpr int kSharedBytes = kStages * kStageBytes + 2 * kStages * 8 + 1024;
constexpr uint64_t kWaitLimitNs = 4000000000ull;

__device__ __forceinline__ void bar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void bar_expect(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
               "r"(bytes) : "memory");
}

__device__ __forceinline__ void bar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}

__device__ __forceinline__ uint32_t bar_try_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  asm volatile(
      "{\n .reg .pred p;\n"
      " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
      " selp.u32 %0, 1, 0, p;\n}\n"
      : "=r"(done) : "r"(bar), "r"(parity) : "memory");
  return done;
}

__device__ __forceinline__ uint64_t now_ns() {
  uint64_t t;
  asm volatile("mov.u64 %0, %%globaltimer;\n" : "=l"(t));
  return t;
}

// Waits until the barrier's phase of parity `parity` has completed. A wait of seconds
// (a whole launch takes milliseconds) can only be a fault: it traps, and the launch
// fails, rather than hold the card.
__device__ __forceinline__ void bar_wait(uint32_t bar, uint32_t parity) {
  if (bar_try_wait(bar, parity)) return;
  const uint64_t start = now_ns();
  while (!bar_try_wait(bar, parity)) {
    if (now_ns() - start > kWaitLimitNs) __trap();
  }
}

__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                         int c0, int c1, int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4, %5}], [%2];\n"
      ::"r"(dst), "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}

// wgmma shared-memory descriptor of a 128-byte-swizzled tile at `address`.
__device__ __forceinline__ uint64_t descriptor(uint32_t address, uint32_t leading,
                                               uint32_t stride) {
  return static_cast<uint64_t>((address & 0x3FFFF) >> 4) |
         static_cast<uint64_t>(leading >> 4) << 16 |
         static_cast<uint64_t>(stride >> 4) << 32 | 1ull << 62;
}

// d (64 x 256, fp32) += A (64 x 16) . B (16 x 256), both K-major; `accumulate` 0
// overwrites d.
__device__ __forceinline__ void wgmma(float (&d)[128], uint64_t a, uint64_t b,
                                      int accumulate) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, "
      "%110, %111, %112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, "
      "%123, %124, %125, %126, %127}, %128, %129, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
        "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), "+f"(d[64]), "+f"(d[65]),
        "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]),
        "+f"(d[78]), "+f"(d[79]), "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]),
        "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]), "+f"(d[88]), "+f"(d[89]),
        "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
        "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]), "+f"(d[100]), "+f"(d[101]),
        "+f"(d[102]), "+f"(d[103]), "+f"(d[104]), "+f"(d[105]), "+f"(d[106]),
        "+f"(d[107]), "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]),
        "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]), "+f"(d[116]),
        "+f"(d[117]), "+f"(d[118]), "+f"(d[119]), "+f"(d[120]), "+f"(d[121]),
        "+f"(d[122]), "+f"(d[123]), "+f"(d[124]), "+f"(d[125]), "+f"(d[126]),
        "+f"(d[127])
      : "l"(a), "l"(b), "r"(accumulate));
}

// Keeps the compiler from moving reads or writes of d across the wgmma waits.
__device__ __forceinline__ void fence_registers(float (&d)[128]) {
#pragma unroll
  for (int i = 0; i < 128; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

__global__ void __launch_bounds__(kThreads, 1)
conv_dgrad_kernel(const __grid_constant__ CUtensorMap dy_map,
                  const __grid_constant__ CUtensorMap w_map, __nv_bfloat16* __restrict__ dx,
                  int cin, int frames, int taps, int pad_low, int channel_blocks,
                  int frame_tiles, int tiles) {
  extern __shared__ __align__(1024) unsigned char shared_raw[];
  // Swizzled tiles need 1024-byte alignment; barriers follow the stages.
  const uint32_t base =
      (static_cast<uint32_t>(__cvta_generic_to_shared(shared_raw)) + 1023u) & ~1023u;
  const uint32_t full = base + kStages * kStageBytes;  // full[s] at full + 8 s
  const uint32_t empty = full + kStages * 8;            // empty[s] at empty + 8 s
  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      bar_init(full + 8 * s, 1);
      bar_init(empty + 8 * s, kConsumerWarps);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  const int iterations = channel_blocks * taps;

  if (threadIdx.x < 128) {
    // Producer warpgroup: one thread starts every load.
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    if (threadIdx.x == 0) {
      int stage = 0;
      uint32_t phase = 0;
      for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
        const int b = tile / frame_tiles;
        const int s0 = (tile % frame_tiles) * kTileFrames;
        for (int block = 0; block < channel_blocks; ++block) {
          for (int k = 0; k < taps; ++k) {
            bar_wait(empty + 8 * stage, phase ^ 1);
            const uint32_t bar = full + 8 * stage;
            const uint32_t dst = base + stage * kStageBytes;
            bar_expect(bar, kStageBytes);
            tma_load(dst, &dy_map, bar, block * kBlockK, s0 + pad_low - k, b);
            tma_load(dst + kWeightOffset, &w_map, bar, block * kBlockK, 0, k);
            if (++stage == kStages) {
              stage = 0;
              phase ^= 1;
            }
          }
        }
      }
    }
  } else {
    // Consumer warpgroups: 64 frames of the tile each.
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
    const int half = (threadIdx.x - 128) >> 7;
    const int warp = (threadIdx.x >> 5) & 3;
    const int lane = threadIdx.x & 31;
    float d[128];
#pragma unroll
    for (int i = 0; i < 128; ++i) d[i] = 0.0f;
    int stage = 0, previous = 0;
    uint32_t phase = 0;
    for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
      const int b = tile / frame_tiles;
      const int s0 = (tile % frame_tiles) * kTileFrames;
      for (int it = 0; it < iterations; ++it) {
        bar_wait(full + 8 * stage, phase);
        const uint32_t a = base + stage * kStageBytes + half * kHalfBytes;
        const uint32_t w = base + stage * kStageBytes + kWeightOffset;
        asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
#pragma unroll
        for (int kk = 0; kk < kBlockK / 16; ++kk) {
          // 16 output channels: 32 bytes into each 128-byte row of both operands.
          wgmma(d, descriptor(a + kk * 32, 16, 1024), descriptor(w + kk * 32, 16, 1024),
                it > 0 || kk > 0);
        }
        asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
        if (it > 0) {
          asm volatile("wgmma.wait_group.sync.aligned 1;\n" ::: "memory");
          if (lane == 0) bar_arrive(empty + 8 * previous);
        }
        previous = stage;
        if (++stage == kStages) {
          stage = 0;
          phase ^= 1;
        }
      }
      asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
      fence_registers(d);
      if (lane == 0) bar_arrive(empty + 8 * previous);
      // d[4j + 2h + e]: frame row warp * 16 + lane / 4 + 8h, channel 8j + 2 (lane % 4) + e.
      const int row = s0 + half * 64 + warp * 16 + (lane >> 2);
      __nv_bfloat16* out = dx + static_cast<size_t>(b) * cin * frames;
#pragma unroll
      for (int j = 0; j < 32; ++j) {
#pragma unroll
        for (int h = 0; h < 2; ++h) {
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int s = row + 8 * h, c = 8 * j + 2 * (lane & 3) + e;
            if (s < frames && c < cin)
              out[static_cast<size_t>(c) * frames + s] = __float2bfloat16_rn(d[4 * j + 2 * h + e]);
          }
        }
      }
      fence_registers(d);
    }
  }
}

// dy (B, cout, frames) -> rows (B, frames, cout_stride), zero for the channels from
// cout on: one 64-channel x 64-frame tile a block, each warp reading 32 frames of a
// channel and writing 32 channels of a frame (whole 32-byte sectors both ways); the
// tile's rows are 66 values long, so a warp's column reads hit distinct banks.
constexpr int kTile = 64;

__global__ void __launch_bounds__(256)
frames_to_rows_kernel(const __nv_bfloat16* __restrict__ dy, __nv_bfloat16* __restrict__ rows,
                      int cout, int frames, int cout_stride) {
  __shared__ __nv_bfloat16 tile[kTile][kTile + 2];
  const int t0 = blockIdx.x * kTile, c0 = blockIdx.y * kTile;
  const size_t b = blockIdx.z;
  const __nv_bfloat16 zero = __float2bfloat16_rn(0.0f);
  for (int i = threadIdx.x; i < kTile * kTile; i += 256) {
    const int c = i / kTile, t = i % kTile;
    tile[c][t] = c0 + c < cout && t0 + t < frames
                     ? dy[(b * cout + c0 + c) * frames + t0 + t] : zero;
  }
  __syncthreads();
  for (int i = threadIdx.x; i < kTile * kTile; i += 256) {
    const int t = i / kTile, c = i % kTile;
    if (t0 + t < frames && c0 + c < cout_stride)
      rows[(b * frames + t0 + t) * cout_stride + c0 + c] = tile[c][t];
  }
}

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave,
                                 CUtensorMapSwizzle, CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled, looked up through the runtime (no link against libcuda).
EncodeTiled encoder() {
  static EncodeTiled encode = nullptr;
  if (encode == nullptr) {
    void* entry = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t status = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &entry, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t status =
        cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &entry, cudaEnableDefault, &found);
#endif
    if (status == cudaSuccess && found == cudaDriverEntryPointSuccess)
      encode = reinterpret_cast<EncodeTiled>(entry);
  }
  return encode;
}

// A 3-d bf16 tensor map of (d0, d1, d2) elements, d0 contiguous and rows `stride1`
// elements apart, with a box of 64 x rows x 1, 128-byte swizzled, zeros outside.
bool encode_map(CUtensorMap* map, const void* data, cuuint64_t d0, cuuint64_t d1,
                cuuint64_t d2, cuuint64_t stride1, cuuint32_t rows) {
  const EncodeTiled encode = encoder();
  if (encode == nullptr) return false;
  const cuuint64_t dims[3] = {d0, d1, d2};
  const cuuint64_t strides[2] = {stride1 * 2, stride1 * d1 * 2};  // bytes
  const cuuint32_t box[3] = {64, rows, 1};
  const cuuint32_t element_strides[3] = {1, 1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(data), dims,
                strides, box, element_strides, CU_TENSOR_MAP_INTERLEAVE_NONE,
                CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

}  // namespace

// C entry point (loaded with ctypes). dy (B, cout, frames) bf16, the conv's output
// gradient; dy_rows (B, frames, cout_stride) bf16 scratch, written here; w (taps, 256,
// cout_stride) bf16, W[co, ci, k] at [k, ci, co], zero for ci >= cin (channels past cout
// unread); cout_stride a multiple of 8. dx (B, cin, frames) bf16, written whole. SAME's
// low padding is pad_low frames. Launches both kernels on `stream`; allocates nothing;
// returns the launches' cudaError_t (0 = success), cudaErrorInvalidValue for shapes it
// does not take.
extern "C" int conv_dgrad(const void* dy, void* dy_rows, const void* w, void* dx, int batch,
                          int cout, int cin, int frames, int cout_stride, int taps,
                          int pad_low, void* stream) {
  if (batch < 1 || cout < 1 || cin < 1 || cin > kChannels || frames < 1 || taps < 1 ||
      cout_stride < cout || cout_stride % 8 != 0 ||
      reinterpret_cast<uintptr_t>(dy_rows) % 16 != 0 || reinterpret_cast<uintptr_t>(w) % 16 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  CUtensorMap dy_map, w_map;
  if (!encode_map(&dy_map, dy_rows, cout, frames, batch, cout_stride, kTileFrames) ||
      !encode_map(&w_map, w, cout, kChannels, taps, cout_stride, kChannels))
    return static_cast<int>(cudaErrorInvalidValue);
  int device = 0, sms = 0;
  cudaError_t status = cudaGetDevice(&device);
  if (status == cudaSuccess)
    status = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (status == cudaSuccess)
    status = cudaFuncSetAttribute(conv_dgrad_kernel,
                                  cudaFuncAttributeMaxDynamicSharedMemorySize, kSharedBytes);
  if (status != cudaSuccess) return static_cast<int>(status);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const dim3 copy_grid((frames + kTile - 1) / kTile, (cout_stride + kTile - 1) / kTile, batch);
  frames_to_rows_kernel<<<copy_grid, 256, 0, st>>>(
      static_cast<const __nv_bfloat16*>(dy), static_cast<__nv_bfloat16*>(dy_rows), cout,
      frames, cout_stride);
  const int frame_tiles = (frames + kTileFrames - 1) / kTileFrames;
  const int tiles = batch * frame_tiles;
  const int grid = tiles < sms ? tiles : sms;
  conv_dgrad_kernel<<<grid, kThreads, kSharedBytes, st>>>(
      dy_map, w_map, static_cast<__nv_bfloat16*>(dx), cin, frames, taps, pad_low,
      (cout + kBlockK - 1) / kBlockK, frame_tiles, tiles);
  return static_cast<int>(cudaGetLastError());
}
