// The Conformer's relative-position self-attention (Transformer-XL's, NeMo's rel_pos),
// forward and backward, hand-written for Hopper.
//
// Replaces no TPU kernel: the JAX package leaves its attention to XLA. It replaces the
// library chain the port ran on the card: the position matmul over all 2T'-1 offsets,
// NeMo's rel_shift (a strided copy forward, a scatter backward), the -10000 mask of
// padded pairs, SDPA's memory-efficient kernels with that (B, H, T', T') float mask and
// the zeroing of padded query rows. The plain PyTorch twin is
// speechless_tpu_torch/ops/rel_attention.py::rel_attention_reference. Per head, with
// s = 1/sqrt(64), qu = bf16(q + u), qv = bf16((q + v) * s) and p_r the projected
// sinusoid of offset r (row T'-1-r of p):
//   S_ij = s * (qu_i . k_j) + qv_i . p_(i-j)   for keys j < len, else -inf
//   O_i  = softmax_j(S_ij) V                    for queries i < len, else 0
//
// What bounds it on the H100: the library chain is bound by HBM traffic, five passes
// over score-shaped tensors, forward and backward. Here no (B, H, T', T') tensor is
// written at all; the tensor cores bound the work, which is mma.sync m16n8k16 (bf16
// in, fp32 sums) on 64 x 64 tiles, FlashAttention-2's schedule:
//   * one block of four warps a (row, head, 64-query tile) in the forward and a (row,
//     head, 64-key tile) in the backward; each warp owns 16 rows of its tile;
//   * tiles past a row's length are never loaded: a query tile wholly past it writes
//     zeros, a key tile wholly past it is not visited; the boundary tile is masked;
//   * the position term of a tile pair [i0, i0+64) x [j0, j0+64) needs the 127 offsets
//     i0-j0-63 .. i0-j0+63: one band of p rows, loaded like a K tile. A warp's 16 query
//     rows need 79 of them, so its band product Qv (16 x 64) . band^T is 80 columns
//     wide (1.25 times its QK^T product). The warp parks it in shared memory, rounded
//     once to bf16 as the library route rounds its position term (kept in fp32, the
//     training check's three steps strayed further from their fp32 reference on some
//     seeds), and reads it back skewed onto the score tile: row m takes band column
//     m - n + 63;
//   * online softmax in fp32 (exp2 of log2(e)-scaled scores); the row's log-sum-exp is
//     kept for the backward;
//   * K, V and band tiles are double-buffered with cp.async (16-byte copies, zero fill
//     past the tensor), XOR-swizzled so that ldmatrix reads are free of bank conflicts.
// The backward recomputes P = exp(S - LSE) per (key tile, query tile) and forms
//   dV += P^T dO, dP = dO V^T, dS = P * (dP - D) with D_i = dO_i . O_i (a first pass,
//   from O's fp32 sums: in dP - D the two nearly cancel, and D from the bf16 O put 3-10 %
//   errors into dq on the training cell's rows),
//   dK += s dS^T qu, and, through shared memory, dq += s (dS K + dX band), where dX is
//   dS skewed into band layout (zero off the band), and d(band) += dX^T qv.
// dq and dp are summed over key tiles with fp32 atomics (two floats a reduction); the
// band sums of one block ride a ring of 128 offsets in registers that is flushed 64
// offsets a query tile. du and dv (the biases) are column sums of the two parts of dq.
// The kernels allocate nothing; the wrapper zeroes the fp32 sums.
#include <cmath>
#include <cstdint>
#include <initializer_list>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kD = 64;           // head width
constexpr int kTile = 64;        // query and key tile
constexpr int kThreads = 128;    // four warps, 16 tile rows each
constexpr int kBandRows = 128;   // band rows loaded a tile pair (127 used)
constexpr int kWarpBand = 80;    // band columns one warp's 16 query rows need
constexpr int kXStride = 88;     // fp32 row stride of a warp's band scores
constexpr float kScale = 0.125f;  // 1 / sqrt(64)
constexpr float kLog2e = 1.4426950408889634f;

constexpr int kTileBytes = kTile * kD * 2;            // 8 KB of bf16
constexpr int kBandBytes = kBandRows * kD * 2;        // 16 KB
constexpr int kXBytes = 4 * 16 * kXStride * 4;        // 22 KB: four warps' band scores
// forward: two stages of (K, V, band), then the band scores
constexpr int kFwdStage = 2 * kTileBytes + kBandBytes;
constexpr int kFwdX = 2 * kFwdStage;
constexpr int kFwdBytes = kFwdX + kXBytes;
// backward: K, V, then qu, qv, dO, band, LSE, D, band scores, dS^T, dX, bias sums
constexpr int kBwdK = 0;
constexpr int kBwdV = kBwdK + kTileBytes;
constexpr int kBwdQu = kBwdV + kTileBytes;
constexpr int kBwdQv = kBwdQu + kTileBytes;
constexpr int kBwdDo = kBwdQv + kTileBytes;
constexpr int kBwdBand = kBwdDo + kTileBytes;
constexpr int kBwdLse = kBwdBand + kBandBytes;
constexpr int kBwdDelta = kBwdLse + kTile * 4;
constexpr int kBwdX = kBwdDelta + kTile * 4;
constexpr int kBwdDs = kBwdX + kXBytes;
constexpr int kBwdDx = kBwdDs + kTileBytes;            // 64 query rows x 128 band cols
constexpr int kBwdBias = kBwdDx + kTile * kBandRows * 2;
constexpr int kBwdBytes = kBwdBias + 2 * 4 * kD * 4;

using bf16 = __nv_bfloat16;

struct Args {
  const bf16* q;          // (B, T, H, 64)
  const bf16* k;
  const bf16* v;
  const float* u;         // (H, 64)
  const float* vb;        // (H, 64)
  const bf16* p;          // (2T - 1, H, 64): offset r at row T - 1 - r
  const int* lengths;     // (B,)
  bf16* o;                // (B, T, H, 64)
  float* o32;             // (B, T, H, 64): O before its rounding to bf16, for D
  float* lse;             // (B, H, T)
  const bf16* dout;       // (B, T, H, 64)
  float* delta;           // (B, H, T), written by the first backward pass
  bf16* qu;               // (B, T, H, 64), written by the first backward pass
  bf16* qv;
  float* dq;              // (B, T, H, 64), summed into (zeroed by the caller)
  bf16* dk;               // (B, T, H, 64), written whole
  bf16* dv;
  float* dp;              // (2T - 1, H, 64), summed into (zeroed by the caller)
  float* du;              // (H, 64), summed into (zeroed by the caller)
  float* dvb;
  int batch, frames, heads;
};

__device__ __forceinline__ uint32_t smem_u32(const void* pointer) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(pointer));
}

// Byte offset of 16-byte chunk `chunk` of row `row` in a tile of 64-element bf16 rows
// (128 bytes), chunks XOR-swizzled by the row's low three bits.
__device__ __forceinline__ uint32_t swz(int row, int chunk) {
  return row * 128 + ((chunk ^ (row & 7)) << 4);
}

// The same for the backward's dX tile of 128-element rows (256 bytes).
__device__ __forceinline__ uint32_t swz_wide(int row, int chunk) {
  return row * 256 + ((chunk ^ (row & 7)) << 4);
}

__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src),
               "r"(valid ? 16 : 0) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int kPending>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kPending) : "memory");
}

__device__ __forceinline__ void ldsm_x4(uint32_t address, uint32_t* r) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(address));
}

__device__ __forceinline__ void ldsm_x4_t(uint32_t address, uint32_t* r) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(address));
}

// c (16 x 8, fp32) += a (16 x 16, bf16, row-major) . b (16 x 8, bf16)
__device__ __forceinline__ void mma(float* c, const uint32_t* a, uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// The position term as the score tile adds it: rounded once to bf16.
__device__ __forceinline__ float2 band_term(float lo, float hi) {
  return make_float2(__bfloat162float(__float2bfloat16_rn(lo)),
                     __bfloat162float(__float2bfloat16_rn(hi)));
}

__device__ __forceinline__ uint32_t pack(float lo, float hi) {
  __nv_bfloat162 pair = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&pair);
}

// address[0] += a, address[1] += b in device memory: one vector reduction on Hopper.
__device__ __forceinline__ void red_add2(float* address, float a, float b) {
#if CUDART_VERSION >= 12040
  atomicAdd(reinterpret_cast<float2*>(address), make_float2(a, b));
#else
  atomicAdd(address, a);
  atomicAdd(address + 1, b);
#endif
}

// A fragments of a 16 x 64 row-major tile at rows [row0, row0 + 16) of a swizzled
// 64-wide tile: frag[ks] covers columns [16 ks, 16 ks + 16).
__device__ __forceinline__ void load_a_rows(uint32_t tile, int row0, int lane,
                                            uint32_t (*frag)[4]) {
#pragma unroll
  for (int ks = 0; ks < 4; ++ks)
    ldsm_x4(tile + swz(row0 + (lane & 15), 2 * ks + (lane >> 4)), frag[ks]);
}

// acc[n] (16 x 16 kPairs of n-tiles) += a (16 x 64) . B where B[k][n] = tile[n0 + n][k]: the
// tile holds B^T row-major (rows n, k contiguous), as K does for Q K^T.
template <int kPairs>
__device__ __forceinline__ void mma_bt(float (*acc)[4], uint32_t (*a)[4], uint32_t tile,
                                       int n0, int lane) {
#pragma unroll
  for (int ks = 0; ks < 4; ++ks) {
#pragma unroll
    for (int np = 0; np < kPairs; ++np) {
      uint32_t b[4];
      const int row = n0 + 16 * np + (lane & 7) + ((lane >> 4) << 3);
      ldsm_x4(tile + swz(row, 2 * ks + ((lane >> 3) & 1)), b);
      mma(acc[2 * np], a[ks], b[0], b[1]);
      mma(acc[2 * np + 1], a[ks], b[2], b[3]);
    }
  }
}

// acc[n] (16 x 64, n over d) += a (16 x 16 ks-steps) . tile[k0 + k][d]: the tile holds B
// row-major (rows k, d contiguous), as V does for P V.
__device__ __forceinline__ void mma_b(float (*acc)[4], const uint32_t* a, uint32_t tile,
                                      int k0, int lane) {
  const int idx = lane >> 3;
#pragma unroll
  for (int dp = 0; dp < 4; ++dp) {
    uint32_t b[4];
    ldsm_x4_t(tile + swz(k0 + (lane & 7) + ((idx & 1) << 3), 2 * dp + (idx >> 1)), b);
    mma(acc[2 * dp], a, b[0], b[1]);
    mma(acc[2 * dp + 1], a, b[2], b[3]);
  }
}

// The bf16 A fragment of columns [16 kk, 16 kk + 16) of a 16-row accumulator tile.
__device__ __forceinline__ void acc_to_a(float (*acc)[4], int kk, uint32_t* a) {
  a[0] = pack(acc[2 * kk][0], acc[2 * kk][1]);
  a[1] = pack(acc[2 * kk][2], acc[2 * kk][3]);
  a[2] = pack(acc[2 * kk + 1][0], acc[2 * kk + 1][1]);
  a[3] = pack(acc[2 * kk + 1][2], acc[2 * kk + 1][3]);
}

__device__ __forceinline__ size_t row_offset(int b, int t, int h, int frames, int heads) {
  return ((static_cast<size_t>(b) * frames + t) * heads + h) * kD;
}

// cp.async of `rows` 64-wide bf16 rows into a swizzled tile: row r reads source row
// first + r (zero fill where `first + r` is outside [0, limit)); rows of a source are
// `step` rows apart (step -1: the band, whose offsets fall as its rows rise).
__device__ __forceinline__ void load_rows(uint32_t tile, const bf16* base, size_t stride,
                                          int rows, int first, int step, int limit) {
  for (int index = threadIdx.x; index < rows * 8; index += kThreads) {
    const int r = index >> 3, chunk = index & 7;
    const int source = first + step * r;
    const bool valid = source >= 0 && source < limit;
    const bf16* from = valid ? base + source * stride + chunk * 8 : base;
    cp_async16(tile + swz(r, chunk), from, valid);
  }
}

__device__ __forceinline__ void zero_rows(bf16* base, size_t stride, int first, int limit) {
  for (int index = threadIdx.x; index < kTile * 8; index += kThreads) {
    const int r = index >> 3, chunk = index & 7;
    if (first + r < limit)
      *reinterpret_cast<uint4*>(base + (first + r) * stride + chunk * 8) = make_uint4(0, 0, 0, 0);
  }
}

__global__ void __launch_bounds__(kThreads, 2) rel_attention_fwd_kernel(const Args a) {
  extern __shared__ __align__(128) unsigned char shared[];
  const int i0 = blockIdx.x * kTile, h = blockIdx.y, b = blockIdx.z;
  const int frames = a.frames, heads = a.heads;
  const int len = min(a.lengths[b], frames);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const size_t stride = static_cast<size_t>(heads) * kD;
  bf16* o = a.o + row_offset(b, 0, h, frames, heads);
  float* o32 = a.o32 + row_offset(b, 0, h, frames, heads);
  float* lse = a.lse + (static_cast<size_t>(b) * heads + h) * frames;
  if (i0 >= len) {  // a query tile wholly past the row's length: zeros
    zero_rows(o, stride, i0, frames);
    for (int index = threadIdx.x; index < kTile * kD / 4; index += kThreads) {
      const int r = index / (kD / 4), quad = index % (kD / 4);
      if (i0 + r < frames)
        *reinterpret_cast<float4*>(o32 + (i0 + r) * stride + 4 * quad) = make_float4(0, 0, 0, 0);
    }
    for (int r = threadIdx.x; r < kTile; r += kThreads)
      if (i0 + r < frames) lse[i0 + r] = 0.f;
    return;
  }
  const uint32_t base = smem_u32(shared);
  float* band_scores = reinterpret_cast<float*>(shared + kFwdX) + warp * 16 * kXStride;
  const bf16* k = a.k + row_offset(b, 0, h, frames, heads);
  const bf16* v = a.v + row_offset(b, 0, h, frames, heads);
  const bf16* p = a.p + static_cast<size_t>(h) * kD;

  auto load = [&](int stage, int j0) {
    const uint32_t at = base + stage * kFwdStage;
    load_rows(at, k, stride, kTile, j0, 1, frames);
    load_rows(at + kTileBytes, v, stride, kTile, j0, 1, frames);
    // band row c holds offset i0 - j0 + c - 63, p's row T - 1 - that
    load_rows(at + 2 * kTileBytes, p, stride, kBandRows, frames + 62 - i0 + j0, -1,
              2 * frames - 1);
    cp_async_commit();
  };
  load(0, 0);

  // This warp's query rows as A fragments: qu = bf16(q + u), qv = bf16((q + v) s).
  uint32_t qu[4][4], qv[4][4];
  {
    const bf16* q = a.q + row_offset(b, 0, h, frames, heads);
#pragma unroll
    for (int ks = 0; ks < 4; ++ks)
#pragma unroll
      for (int part = 0; part < 4; ++part) {
        const int row = i0 + 16 * warp + g + 8 * (part & 1);
        const int col = 16 * ks + 8 * (part >> 1) + 2 * t;
        float x0 = 0.f, x1 = 0.f;
        if (row < frames) {
          const __nv_bfloat162 pair =
              *reinterpret_cast<const __nv_bfloat162*>(q + row * stride + col);
          x0 = __bfloat162float(pair.x);
          x1 = __bfloat162float(pair.y);
        }
        const float* u = a.u + h * kD + col;
        const float* vb = a.vb + h * kD + col;
        qu[ks][part] = pack(x0 + u[0], x1 + u[1]);
        qv[ks][part] = pack((x0 + vb[0]) * kScale, (x1 + vb[1]) * kScale);
      }
  }

  float acc[8][4];
#pragma unroll
  for (int n = 0; n < 8; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;
  float row_max[2] = {-INFINITY, -INFINITY}, row_sum[2] = {0.f, 0.f};
  const int key_tiles = (len + kTile - 1) / kTile;
  for (int kt = 0; kt < key_tiles; ++kt) {
    const int j0 = kt * kTile;
    if (kt + 1 < key_tiles) {
      load((kt + 1) & 1, j0 + kTile);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const uint32_t tk = base + (kt & 1) * kFwdStage, tv = tk + kTileBytes,
                   tband = tk + 2 * kTileBytes;
    float s[8][4];
#pragma unroll
    for (int n = 0; n < 8; ++n) s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.f;
    mma_bt<4>(s, qu, tk, 0, lane);
    {
      float x[kWarpBand / 8][4];
#pragma unroll
      for (int n = 0; n < kWarpBand / 8; ++n) x[n][0] = x[n][1] = x[n][2] = x[n][3] = 0.f;
      mma_bt<kWarpBand / 16>(x, qv, tband, 16 * warp, lane);
#pragma unroll
      for (int n = 0; n < kWarpBand / 8; ++n) {
        *reinterpret_cast<float2*>(band_scores + g * kXStride + 8 * n + 2 * t) =
            band_term(x[n][0], x[n][1]);
        *reinterpret_cast<float2*>(band_scores + (g + 8) * kXStride + 8 * n + 2 * t) =
            band_term(x[n][2], x[n][3]);
      }
    }
    __syncwarp();
    // the skew: score (m, n) takes the warp's band column m - n + 63
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int m = g + 8 * (e >> 1), col = 8 * n + 2 * t + (e & 1);
        float value = s[n][e] * kScale + band_scores[m * kXStride + m - col + 63];
        if (j0 + col >= len) value = -INFINITY;
        s[n][e] = value;
      }
    __syncwarp();
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      float most = -INFINITY;
#pragma unroll
      for (int n = 0; n < 8; ++n) most = fmaxf(most, fmaxf(s[n][2 * half], s[n][2 * half + 1]));
      most = fmaxf(most, __shfl_xor_sync(0xffffffffu, most, 1));
      most = fmaxf(most, __shfl_xor_sync(0xffffffffu, most, 2));
      const float updated = fmaxf(row_max[half], most);  // finite: key j0 < len is valid
      const float rescale = exp2f((row_max[half] - updated) * kLog2e);
      const float shift = updated * kLog2e;
      float total = 0.f;
#pragma unroll
      for (int n = 0; n < 8; ++n)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const float weight = exp2f(fmaf(s[n][2 * half + e], kLog2e, -shift));
          s[n][2 * half + e] = weight;
          total += weight;
        }
      row_sum[half] = row_sum[half] * rescale + total;
      row_max[half] = updated;
#pragma unroll
      for (int n = 0; n < 8; ++n) {
        acc[n][2 * half] *= rescale;
        acc[n][2 * half + 1] *= rescale;
      }
    }
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      uint32_t weights[4];
      acc_to_a(s, kk, weights);
      mma_b(acc, weights, tv, 16 * kk, lane);
    }
    __syncthreads();  // the stage is reloaded two tiles on
  }

#pragma unroll
  for (int half = 0; half < 2; ++half) {
    float total = row_sum[half];
    total += __shfl_xor_sync(0xffffffffu, total, 1);
    total += __shfl_xor_sync(0xffffffffu, total, 2);
    const int row = i0 + 16 * warp + g + 8 * half;
    const bool valid = row < len;
    const float inverse = valid ? 1.f / total : 0.f;
    if (row < frames) {
#pragma unroll
      for (int n = 0; n < 8; ++n) {
        const float lo = acc[n][2 * half] * inverse, hi = acc[n][2 * half + 1] * inverse;
        *reinterpret_cast<uint32_t*>(o + row * stride + 8 * n + 2 * t) = pack(lo, hi);
        *reinterpret_cast<float2*>(o32 + row * stride + 8 * n + 2 * t) = make_float2(lo, hi);
      }
      if (t == 0) lse[row] = valid ? row_max[half] + logf(total) : 0.f;
    }
  }
}

// D_i = dO_i . O_i in fp32 from O's fp32 copy (0 past the row's length) and the
// backward's qu and qv: one warp a (row, frame, head), two channels a lane.
__global__ void rel_attention_prep_kernel(const Args a) {
  const int frames = a.frames, heads = a.heads;
  const size_t item = static_cast<size_t>(blockIdx.x) * 8 + (threadIdx.x >> 5);
  if (item >= static_cast<size_t>(a.batch) * frames * heads) return;
  const int lane = threadIdx.x & 31, h = static_cast<int>(item % heads);
  const int frame = static_cast<int>((item / heads) % frames);
  const int b = static_cast<int>(item / (static_cast<size_t>(heads) * frames));
  const size_t at = item * kD + 2 * lane;
  const float2 o = *reinterpret_cast<const float2*>(a.o32 + at);
  const __nv_bfloat162 d = *reinterpret_cast<const __nv_bfloat162*>(a.dout + at);
  float dot = o.x * __bfloat162float(d.x) + o.y * __bfloat162float(d.y);
#pragma unroll
  for (int width = 16; width > 0; width >>= 1)
    dot += __shfl_xor_sync(0xffffffffu, dot, width);
  const __nv_bfloat162 q = *reinterpret_cast<const __nv_bfloat162*>(a.q + at);
  const float x0 = __bfloat162float(q.x), x1 = __bfloat162float(q.y);
  const int col = h * kD + 2 * lane;
  *reinterpret_cast<uint32_t*>(a.qu + at) = pack(x0 + a.u[col], x1 + a.u[col + 1]);
  *reinterpret_cast<uint32_t*>(a.qv + at) =
      pack((x0 + a.vb[col]) * kScale, (x1 + a.vb[col + 1]) * kScale);
  if (lane == 0)
    a.delta[(static_cast<size_t>(b) * heads + h) * frames + frame] =
        frame < min(a.lengths[b], frames) ? dot : 0.f;
}

__global__ void __launch_bounds__(kThreads, 2) rel_attention_bwd_kernel(const Args a) {
  extern __shared__ __align__(128) unsigned char shared[];
  const int j0 = blockIdx.x * kTile, h = blockIdx.y, b = blockIdx.z;
  const int frames = a.frames, heads = a.heads;
  const int len = min(a.lengths[b], frames);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int idx = lane >> 3;
  const size_t stride = static_cast<size_t>(heads) * kD;
  bf16* dk = a.dk + row_offset(b, 0, h, frames, heads);
  bf16* dv = a.dv + row_offset(b, 0, h, frames, heads);
  if (j0 >= len) {  // a key tile wholly past the row's length: no gradient
    zero_rows(dk, stride, j0, frames);
    zero_rows(dv, stride, j0, frames);
    return;
  }
  const uint32_t base = smem_u32(shared);
  const uint32_t tk = base + kBwdK, tv = base + kBwdV, tqu = base + kBwdQu,
                 tqv = base + kBwdQv, tdo = base + kBwdDo, tband = base + kBwdBand,
                 tds = base + kBwdDs, tdx = base + kBwdDx;
  float* lse_rows = reinterpret_cast<float*>(shared + kBwdLse);
  float* delta_rows = reinterpret_cast<float*>(shared + kBwdDelta);
  float* x_all = reinterpret_cast<float*>(shared + kBwdX);
  float* bias_sums = reinterpret_cast<float*>(shared + kBwdBias);  // [2][4][64]
  unsigned char* dx_bytes = shared + kBwdDx;
  const size_t head_at = row_offset(b, 0, h, frames, heads);
  const float* lse = a.lse + (static_cast<size_t>(b) * heads + h) * frames;
  const float* delta = a.delta + (static_cast<size_t>(b) * heads + h) * frames;

  for (int index = threadIdx.x; index < kTile * kBandRows * 2 / 16; index += kThreads)
    reinterpret_cast<uint4*>(dx_bytes)[index] = make_uint4(0, 0, 0, 0);
  for (int index = threadIdx.x; index < 2 * 4 * kD; index += kThreads) bias_sums[index] = 0.f;
  load_rows(tk, a.k + head_at, stride, kTile, j0, 1, frames);
  load_rows(tv, a.v + head_at, stride, kTile, j0, 1, frames);

  float dk_acc[8][4], dv_acc[8][4], ring[2][8][4];
#pragma unroll
  for (int n = 0; n < 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk_acc[n][e] = dv_acc[n][e] = ring[0][n][e] = ring[1][n][e] = 0.f;

  const int query_tiles = (len + kTile - 1) / kTile;
  for (int qt = 0; qt < query_tiles; ++qt) {
    const int i0 = qt * kTile;
    load_rows(tqu, a.qu + head_at, stride, kTile, i0, 1, frames);
    load_rows(tqv, a.qv + head_at, stride, kTile, i0, 1, frames);
    load_rows(tdo, a.dout + head_at, stride, kTile, i0, 1, frames);
    load_rows(tband, a.p + static_cast<size_t>(h) * kD, stride, kBandRows,
              frames + 62 - i0 + j0, -1, 2 * frames - 1);
    cp_async_commit();
    if (threadIdx.x < kTile) {
      const int row = i0 + threadIdx.x;
      lse_rows[threadIdx.x] = row < frames ? lse[row] : 0.f;
    } else {
      const int row = i0 + threadIdx.x - kTile;
      delta_rows[threadIdx.x - kTile] = row < frames ? delta[row] : 0.f;
    }
    cp_async_wait<0>();
    __syncthreads();

    // Band scores of this warp's 16 query rows: qv . band^T over 80 band columns.
    {
      uint32_t qv_frag[4][4];
      load_a_rows(tqv, 16 * warp, lane, qv_frag);
      float x[kWarpBand / 8][4];
#pragma unroll
      for (int n = 0; n < kWarpBand / 8; ++n) x[n][0] = x[n][1] = x[n][2] = x[n][3] = 0.f;
      mma_bt<kWarpBand / 16>(x, qv_frag, tband, 16 * warp, lane);
      float* mine = x_all + warp * 16 * kXStride;
#pragma unroll
      for (int n = 0; n < kWarpBand / 8; ++n) {
        *reinterpret_cast<float2*>(mine + g * kXStride + 8 * n + 2 * t) =
            band_term(x[n][0], x[n][1]);
        *reinterpret_cast<float2*>(mine + (g + 8) * kXStride + 8 * n + 2 * t) =
            band_term(x[n][2], x[n][3]);
      }
    }
    __syncthreads();

    // S^T for this warp's 16 keys against the 64 queries, then P^T = exp(S^T - LSE).
    float pt[8][4];
    {
      uint32_t k_frag[4][4];
      load_a_rows(tk, 16 * warp, lane, k_frag);
#pragma unroll
      for (int n = 0; n < 8; ++n) pt[n][0] = pt[n][1] = pt[n][2] = pt[n][3] = 0.f;
      mma_bt<4>(pt, k_frag, tqu, 0, lane);
    }
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int key = 16 * warp + g + 8 * (e >> 1), m = 8 * n + 2 * t + (e & 1);
        const int local = m & 15;
        const float score = pt[n][e] * kScale +
            x_all[(m >> 4) * 16 * kXStride + local * kXStride + local - key + 63];
        pt[n][e] = (i0 + m < len && j0 + key < len)
                       ? exp2f((score - lse_rows[m]) * kLog2e) : 0.f;
      }
    // dV += P^T dO
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      uint32_t weights[4];
      acc_to_a(pt, kk, weights);
      mma_b(dv_acc, weights, tdo, 16 * kk, lane);
    }
    // dP^T = V dO^T, then dS^T = P^T (dP^T - D)
    float ds[8][4];
    {
      uint32_t v_frag[4][4];
      load_a_rows(tv, 16 * warp, lane, v_frag);
#pragma unroll
      for (int n = 0; n < 8; ++n) ds[n][0] = ds[n][1] = ds[n][2] = ds[n][3] = 0.f;
      mma_bt<4>(ds, v_frag, tdo, 0, lane);
    }
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        ds[n][e] = pt[n][e] * (ds[n][e] - delta_rows[8 * n + 2 * t + (e & 1)]);
    // dK += dS^T qu (scaled at the end)
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      uint32_t grads[4];
      acc_to_a(ds, kk, grads);
      mma_b(dk_acc, grads, tqu, 16 * kk, lane);
    }
    // dS^T to shared memory, as (key, query) rows and skewed into band layout dX
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int key = 16 * warp + g + 8 * half, m = 8 * n + 2 * t;
        const float lo = ds[n][2 * half], hi = ds[n][2 * half + 1];
        asm volatile("st.shared.b32 [%0], %1;\n" ::"r"(tds + swz(key, m >> 3) + (m & 7) * 2),
                     "r"(pack(lo, hi)));
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int c = m + e - key + 63;
          *reinterpret_cast<bf16*>(dx_bytes + swz_wide(m + e, c >> 3) + (c & 7) * 2) =
              __float2bfloat16_rn(e ? hi : lo);
        }
      }
    __syncthreads();

    // dq for this warp's 16 queries: s (dS K + dX band), and the bias sums.
    {
      float dq_acc[8][4];
#pragma unroll
      for (int n = 0; n < 8; ++n) dq_acc[n][0] = dq_acc[n][1] = dq_acc[n][2] = dq_acc[n][3] = 0.f;
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {  // dS (queries x keys) from dS^T rows
        uint32_t grads[4];
        ldsm_x4_t(tds + swz(16 * kk + (lane & 7) + ((idx >> 1) << 3), 2 * warp + (idx & 1)),
                  grads);
        mma_b(dq_acc, grads, tk, 16 * kk, lane);
      }
      float content[8][2];
#pragma unroll
      for (int n = 0; n < 8; ++n)
#pragma unroll
        for (int e = 0; e < 2; ++e) content[n][e] = dq_acc[n][e] + dq_acc[n][2 + e];
#pragma unroll
      for (int kk = 0; kk < 5; ++kk) {  // dX rows of this warp, band columns 16 warp + ..
        uint32_t grads[4];
        const int row = 16 * warp + (lane & 15);
        ldsm_x4(tdx + swz_wide(row, 2 * (warp + kk) + (lane >> 4)), grads);
        mma_b(dq_acc, grads, tband, 16 * (warp + kk), lane);
      }
      float* dq = a.dq + head_at;
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int row = i0 + 16 * warp + g + 8 * half;
        if (row < len) {
#pragma unroll
          for (int n = 0; n < 8; ++n)
            red_add2(dq + row * stride + 8 * n + 2 * t, dq_acc[n][2 * half] * kScale,
                     dq_acc[n][2 * half + 1] * kScale);
        }
      }
      // column sums over the 16 rows: u's from dS K, v's from dX band
#pragma unroll
      for (int n = 0; n < 8; ++n)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          float part_u = content[n][e];
          float part_v = dq_acc[n][e] + dq_acc[n][2 + e] - part_u;
#pragma unroll
          for (int width = 4; width < 32; width <<= 1) {
            part_u += __shfl_xor_sync(0xffffffffu, part_u, width);
            part_v += __shfl_xor_sync(0xffffffffu, part_v, width);
          }
          if (g == 0) {
            bias_sums[warp * kD + 8 * n + 2 * t + e] += part_u;
            bias_sums[(4 + warp) * kD + 8 * n + 2 * t + e] += part_v;
          }
        }
    }

    // d(band) += dX^T qv into the ring: this warp's 32 ring rows are band rows
    // (32 warp - 64 qt) mod 128 onwards; band rows [0, 64) are final after this tile.
    const int band0 = (32 * warp + 64 * (qt & 1)) & 127;
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
#pragma unroll
      for (int ks = 0; ks < 4; ++ks) {
        uint32_t grads[4];
        ldsm_x4_t(tdx + swz_wide(16 * ks + (lane & 7) + ((idx >> 1) << 3),
                                 (band0 + 16 * mt) / 8 + (idx & 1)),
                  grads);
        mma_b(ring[mt], grads, tqv, 16 * ks, lane);
      }
    if (band0 < 64 || qt + 1 == query_tiles) {
      float* dp = a.dp + static_cast<size_t>(h) * kD;
#pragma unroll
      for (int mt = 0; mt < 2; ++mt)
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const int c = band0 + 16 * mt + g + 8 * half;
          const int row = frames + 62 - i0 + j0 - c;  // p's row of offset i0 - j0 + c - 63
          if (row >= 0 && row < 2 * frames - 1) {
#pragma unroll
            for (int n = 0; n < 8; ++n)
              red_add2(dp + row * stride + 8 * n + 2 * t, ring[mt][n][2 * half],
                       ring[mt][n][2 * half + 1]);
          }
#pragma unroll
          for (int n = 0; n < 8; ++n) ring[mt][n][2 * half] = ring[mt][n][2 * half + 1] = 0.f;
        }
    }
    __syncthreads();  // the next query tile overwrites every shared tile
  }

#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int row = j0 + 16 * warp + g + 8 * half;
    if (row < frames) {
#pragma unroll
      for (int n = 0; n < 8; ++n) {
        *reinterpret_cast<uint32_t*>(dk + row * stride + 8 * n + 2 * t) =
            pack(dk_acc[n][2 * half] * kScale, dk_acc[n][2 * half + 1] * kScale);
        *reinterpret_cast<uint32_t*>(dv + row * stride + 8 * n + 2 * t) =
            pack(dv_acc[n][2 * half], dv_acc[n][2 * half + 1]);
      }
    }
  }
  for (int index = threadIdx.x; index < 2 * kD; index += kThreads) {
    const int which = index / kD, col = index % kD;
    const float* sums = bias_sums + which * 4 * kD + col;
    const float total = (sums[0] + sums[kD] + sums[2 * kD] + sums[3 * kD]) * kScale;
    atomicAdd((which ? a.dvb : a.du) + h * kD + col, total);
  }
}

bool aligned(const void* pointer, uintptr_t bytes) {
  return reinterpret_cast<uintptr_t>(pointer) % bytes == 0;
}

}  // namespace

// C entry point (loaded with ctypes). q, k, v (B, T, H, 64) bf16; u, vb (H, 64) fp32; p
// (2T - 1, H, 64) bf16; lengths (B,) int32. Forward (backward = 0): writes o (B, T, H,
// 64) bf16, its fp32 copy o32 and lse (B, H, T) fp32 whole. Backward (backward = 1):
// reads o32, lse and dout (B, T, H, 64) bf16; writes delta (B, H, T) fp32 and qu, qv
// (B, T, H, 64) bf16 (scratch), dk, dv (B, T, H, 64) bf16 whole; adds into dq (B, T, H,
// 64), dp (2T - 1, H, 64), du and dvb (H, 64), fp32, which the caller zeroes. Unused pointers may be null. Launches on
// `stream`; allocates nothing; returns the launches' cudaError_t (0 = success),
// cudaErrorInvalidValue for shapes or alignments it does not take.
extern "C" int rel_attention(const void* q, const void* k, const void* v, const void* u,
                             const void* vb, const void* p, const void* lengths, void* o,
                             void* o32, void* lse, const void* dout, void* delta, void* qu,
                             void* qv, void* dq, void* dk, void* dv, void* dp, void* du, void* dvb,
                             int batch, int frames, int heads, int backward, void* stream) {
  if (batch < 1 || frames < 1 || heads < 1 || batch > 65535 || heads > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  for (const void* pointer : {q, k, v, p, static_cast<const void*>(o),
                              static_cast<const void*>(o32)})
    if (!aligned(pointer, 16)) return static_cast<int>(cudaErrorInvalidValue);
  if (backward)
    for (const void* pointer : {dout, static_cast<const void*>(qu), static_cast<const void*>(qv),
                                static_cast<const void*>(dk), static_cast<const void*>(dv),
                                static_cast<const void*>(dq), static_cast<const void*>(dp)})
      if (!aligned(pointer, 16)) return static_cast<int>(cudaErrorInvalidValue);
  Args args{static_cast<const bf16*>(q), static_cast<const bf16*>(k),
            static_cast<const bf16*>(v), static_cast<const float*>(u),
            static_cast<const float*>(vb), static_cast<const bf16*>(p),
            static_cast<const int*>(lengths), static_cast<bf16*>(o), static_cast<float*>(o32),
            static_cast<float*>(lse), static_cast<const bf16*>(dout), static_cast<float*>(delta),
            static_cast<bf16*>(qu), static_cast<bf16*>(qv), static_cast<float*>(dq),
            static_cast<bf16*>(dk), static_cast<bf16*>(dv), static_cast<float*>(dp),
            static_cast<float*>(du), static_cast<float*>(dvb), batch, frames, heads};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const dim3 grid((frames + kTile - 1) / kTile, heads, batch);
  cudaError_t status;
  if (!backward) {
    status = cudaFuncSetAttribute(rel_attention_fwd_kernel,
                                  cudaFuncAttributeMaxDynamicSharedMemorySize, kFwdBytes);
    if (status != cudaSuccess) return static_cast<int>(status);
    rel_attention_fwd_kernel<<<grid, kThreads, kFwdBytes, st>>>(args);
    return static_cast<int>(cudaGetLastError());
  }
  status = cudaFuncSetAttribute(rel_attention_bwd_kernel,
                                cudaFuncAttributeMaxDynamicSharedMemorySize, kBwdBytes);
  if (status != cudaSuccess) return static_cast<int>(status);
  const size_t items = static_cast<size_t>(batch) * frames * heads;
  rel_attention_prep_kernel<<<static_cast<unsigned>((items + 7) / 8), 256, 0, st>>>(args);
  rel_attention_bwd_kernel<<<grid, kThreads, kBwdBytes, st>>>(args);
  return static_cast<int>(cudaGetLastError());
}
