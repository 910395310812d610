// One frame of the CTC prefix beam for one row, shared by the LM span kernel
// (lm_beam_span.cu, K4), its single-frame test entry (lm_beam_step.cu) and the
// whole-utterance beam (prefix_beam.cu, K3).
//
// What it computes is the Pallas kernels' frame (decode_pallas_lm.py::_lm_step_kernel,
// decode_pallas.py::_full_update): expand W beams into r*(k+1) candidates (stay, or
// extend by one of the frame's top-k classes), merge candidates of equal int32 prefix
// hash with a segmented log-sum-exp that keeps the min-index representative and carries
// the LM score as a rider, then keep the top W by -(score + lm) with the index as
// tie-break. The plain PyTorch twin is speechless_tpu_torch/ops/decode_lm.py::
// lm_step_reference, whose network (two bitonic sorts and a Hillis-Steele merge) this
// header also carries as `sorted_network`.
//
// Two networks, one result. The incoming live beams of a decode carry distinct hashes,
// so a hash gathers at most two live candidates: the stay of prefix p and the extension
// of p's parent by p's last character. For two members the reference's merge is
// logaddexp(x, y), which is symmetric bit for bit, and both members carry the same last
// character and length; the top-W order (-score, index) is total over the merged
// prefixes, so any exact selection gives the reference's output. `beam_step` therefore
// first inserts every live candidate into a shared-memory hash table (two block
// barriers), merges each pair into its min-index member, and ranks the merged prefixes
// by counting, each against a broadcast of all the others (the rank network). When a
// hash gathers three or more live candidates, or a pair disagrees on last character or
// length (duplicate live hashes in the incoming beams, or a 32-bit collision), the
// whole block takes `sorted_network` instead, the reference's network step by step.
// Both branches are block-uniform, so no barrier is split.
//
// One thread per candidate lane (blockDim.x = n_pad, a power of two). In the sorted
// network compare-exchange partners closer than a warp come by __shfl_xor_sync; only
// strides of 32 and more pay a shared-memory round trip and barrier, and the sorts carry
// a 4-byte source lane instead of the payloads. Built without fast math: expf/log1pf
// match torch's CUDA logaddexp exactly, and the step has no float multiply for nvcc to
// contract.
#pragma once

#include <cuda_pipeline.h>
#include <cuda_runtime.h>

namespace beam {

constexpr float kNegInf = -1e30f;
constexpr float kAliveFloor = -5e29f;  // NEG_INF / 2
constexpr int kDeadKey = 2147483647;   // INT32_MAX: dead candidates sort last
constexpr int kIntMax = 2147483647;
constexpr unsigned kHashMultiplier = 16777619u;
constexpr int kSortArrays = 15;        // lane-indexed 4-byte arrays of the sorted network
// Per lane, the rank network's hash table (2 n 8-byte tags, 2 n counts, 4 n members)
// and its n 8-byte rank keys, in 4-byte words.
constexpr int kRankWords = 12;
constexpr int kScratchWords = kSortArrays + kRankWords;  // 4-byte words of scratch a lane

// torch's CUDA logaddexp for float, operation for operation.
__device__ __forceinline__ float logaddexp(float a, float b) {
  if (isinf(a) && a == b) return a;
  const float m = fmaxf(a, b);
  return m + log1pf(expf(-fabsf(a - b)));
}

// The rank network's tables inside `scratch` (blockDim.x = n lanes).
struct RankTables {
  unsigned long long* tags;  // 2n hash-table slots: (1 << 32 | hash), 0 = empty
  unsigned long long* keys;  // n rank keys, larger = earlier; 0 = no merged prefix
  int* counts;               // 2n: live candidates that hashed to the slot
  int* members;              // 4n: the first two lanes of each slot
};

__device__ __forceinline__ RankTables rank_tables(int* scratch, int n) {
  int* base = scratch + kSortArrays * n;  // 8-byte aligned: n is a power of two >= 16
  RankTables t;
  t.tags = reinterpret_cast<unsigned long long*>(base);
  t.keys = reinterpret_cast<unsigned long long*>(base + 4 * n);
  t.counts = base + 6 * n;
  t.members = base + 8 * n;
  return t;
}

// Empties the hash table. Call once before the first `beam_step` on a scratch area,
// with a barrier after it; every `beam_step` leaves the table empty again.
__device__ void init_scratch(int* scratch) {
  const int n = blockDim.x;
  const RankTables t = rank_tables(scratch, n);
  for (int i = threadIdx.x; i < 2 * n; i += n) {
    t.tags[i] = 0ull;
    t.counts[i] = 0;
  }
}

// Starts copying one packed frame row from device memory into shared memory (cp.async,
// 4 bytes a thread at a time) without waiting for it: a frame loop starts the next row
// while the current frame runs, then `__pipeline_wait_prior(0)` and a barrier before use.
__device__ __forceinline__ void prefetch_row(float* dst, const float* src, int width) {
  for (int i = threadIdx.x; i < width; i += blockDim.x) {
    __pipeline_memcpy_async(dst + i, src + i, sizeof(float));
  }
  __pipeline_commit();
}

// float -> unsigned with the same order; -0 and +0 map alike (they compare equal).
__device__ __forceinline__ unsigned ordered_bits(float x) {
  if (x == 0.f) x = 0.f;
  const unsigned u = __float_as_uint(x);
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}

// Bitonic sort of one row, one lane per thread, ascending by key then (with
// kSecondary) by sec. XOR-partner compare-exchange with no swap on equal keys, the
// network of decode_pallas_lm.py::_row_bitonic_sort. `src` rides along as the payload.
template <typename Key, bool kSecondary>
__device__ void bitonic_sort(Key& key, int& sec, int& src, int lane, int n, unsigned mask,
                             Key* s_key, int* s_sec, int* s_src) {
  for (int size = 2; size <= n; size <<= 1) {
    const bool ascending = (lane & size) == 0;
    for (int stride = size >> 1; stride > 0; stride >>= 1) {
      Key p_key;
      int p_sec = 0;
      int p_src;
      if (stride >= 32) {
        s_key[lane] = key;
        if constexpr (kSecondary) s_sec[lane] = sec;
        s_src[lane] = src;
        __syncthreads();
        const int partner = lane ^ stride;
        p_key = s_key[partner];
        if constexpr (kSecondary) p_sec = s_sec[partner];
        p_src = s_src[partner];
        __syncthreads();
      } else {
        p_key = __shfl_xor_sync(mask, key, stride);
        if constexpr (kSecondary) p_sec = __shfl_xor_sync(mask, sec, stride);
        p_src = __shfl_xor_sync(mask, src, stride);
      }
      bool greater = key > p_key;
      bool less = key < p_key;
      if constexpr (kSecondary) {
        const bool equal = key == p_key;
        greater = greater || (equal && sec > p_sec);
        less = less || (equal && sec < p_sec);
      }
      const bool upper = (lane & stride) != 0;
      const bool take = ascending ? (upper ? less : greater) : (upper ? greater : less);
      if (take) {
        key = p_key;
        if constexpr (kSecondary) sec = p_sec;
        src = p_src;
      }
    }
  }
}

// The reference's network: sort the candidates (payloads in scratch, written by
// `beam_step`) by prefix hash, Hillis-Steele segmented log-sum-exp within runs, sort on
// -score with the index as secondary, keep the top W. Exact for any candidate set.
__device__ void sorted_network(int key, float* out_pb, float* out_pnb, int* out_hash,
                               int* out_last, int* out_len, float* out_lm, int* out_idx,
                               int* scratch, int r, int k, int beam_width) {
  const int n = blockDim.x;
  const int lane = threadIdx.x;
  const unsigned mask = n >= 32 ? 0xffffffffu : ((1u << n) - 1u);
  float* p_pb = reinterpret_cast<float*>(scratch);
  float* p_pnb = p_pb + n;
  int* p_idx = reinterpret_cast<int*>(p_pnb + n);
  int* p_last = p_idx + n;
  int* p_len = p_last + n;
  float* p_lm = reinterpret_cast<float*>(p_len + n);
  int* p_key = reinterpret_cast<int*>(p_lm + n);
  int* s_key = p_key + n;
  int* s_sec = s_key + n;
  int* s_src = s_sec + n;
  float* m_pb = reinterpret_cast<float*>(s_src + n);
  float* m_pnb = m_pb + n;
  int* m_idx = reinterpret_cast<int*>(m_pnb + n);
  float* m_rider = reinterpret_cast<float*>(m_idx + n);
  int* m_blocked = reinterpret_cast<int*>(m_rider + n);

  // ---- sort by prefix hash ----
  int src = lane;
  int unused = 0;
  bitonic_sort<int, false>(key, unused, src, lane, n, mask, s_key, s_sec, s_src);
  float mpb = p_pb[src], mpnb = p_pnb[src], rider = p_lm[src];
  int midx = p_idx[src];
  const int s_last = p_last[src], s_len = p_len[src];

  // ---- segmented log-sum-exp merge of equal prefixes ----
  s_key[lane] = key;
  __syncthreads();
  const bool run_start = lane == 0 || key != s_key[lane - 1];
  m_blocked[lane] = run_start;
  __syncthreads();
  int blocked = lane + 1 < n ? m_blocked[lane + 1] : 1;
  for (int shift = 1; shift < n; shift <<= 1) {
    __syncthreads();
    m_pb[lane] = mpb;
    m_pnb[lane] = mpnb;
    m_idx[lane] = midx;
    m_rider[lane] = rider;
    m_blocked[lane] = blocked;
    __syncthreads();
    float pb_r = kNegInf, pnb_r = kNegInf, rider_r = 0.f;
    int idx_r = kIntMax, blocked_r = 1;
    if (lane + shift < n) {
      pb_r = m_pb[lane + shift];
      pnb_r = m_pnb[lane + shift];
      idx_r = m_idx[lane + shift];
      rider_r = m_rider[lane + shift];
      blocked_r = m_blocked[lane + shift];
    }
    if (!blocked) {
      mpb = logaddexp(mpb, pb_r);
      mpnb = logaddexp(mpnb, pnb_r);
      if (idx_r < midx) rider = rider_r;
      midx = min(midx, idx_r);
    }
    blocked |= blocked_r;
  }
  if (!run_start) {  // only run starts represent a merged prefix
    mpb = kNegInf;
    mpnb = kNegInf;
  }
  const float score =
      (run_start && key != kDeadKey) ? logaddexp(mpb, mpnb) + rider : kNegInf;

  // ---- top-W: sort on -score, ties by representative index ----
  p_pb[lane] = mpb;
  p_pnb[lane] = mpnb;
  p_key[lane] = key;
  p_idx[lane] = midx;
  p_last[lane] = s_last;
  p_len[lane] = s_len;
  p_lm[lane] = rider;
  __syncthreads();
  float neg_score = -score;
  int sec = midx;
  src = lane;
  bitonic_sort<float, true>(neg_score, sec, src, lane, n, mask,
                            reinterpret_cast<float*>(s_key), s_sec, s_src);
  if (lane < r) {
    const float f_pb = p_pb[src], f_pnb = p_pnb[src];
    const bool in_beam = lane < beam_width && logaddexp(f_pb, f_pnb) > kAliveFloor;
    out_pb[lane] = in_beam ? f_pb : kNegInf;
    out_pnb[lane] = in_beam ? f_pnb : kNegInf;
    out_hash[lane] = in_beam ? p_key[src] : 0;
    out_last[lane] = in_beam ? p_last[src] : -1;
    out_len[lane] = in_beam ? p_len[src] : 0;
    if (out_lm != nullptr) out_lm[lane] = in_beam ? p_lm[src] : 0.f;
    out_idx[lane] = in_beam ? p_idx[src] : lane * (k + 1);
  }
}

// One frame of one row, called by every thread of the block; put a barrier between two
// calls on the same scratch. The state pointers hold the row's r lanes (pb, pnb, lm
// float; hash, last, len int), in device or shared memory; `fr` is the row's packed
// frame (top-k scores, top-k classes as floats, the class row). `lm`, `bonus` and
// `out_lm` may be null: no LM, every rider 0. The outputs may alias the inputs: every
// input is read before the first barrier and every output written after the last.
// `scratch` holds kScratchWords * blockDim.x ints, its hash table emptied by
// `init_scratch` before the first call. Returns true when the frame took the sorted
// network.
__device__ bool beam_step(const float* fr, const float* pb, const float* pnb,
                          const int* hash, const int* last, const int* len,
                          const float* lm, const float* bonus, float* out_pb,
                          float* out_pnb, int* out_hash, int* out_last, int* out_len,
                          float* out_lm, int* out_idx, int* scratch, int r, int k,
                          int class_count, int blank, int beam_width, int max_len,
                          int space_index) {
  const int n = blockDim.x;  // n_pad candidate lanes, a power of two
  const int lane = threadIdx.x;
  float* p_pb = reinterpret_cast<float*>(scratch);
  float* p_pnb = p_pb + n;
  int* p_idx = reinterpret_cast<int*>(p_pnb + n);
  int* p_last = p_idx + n;
  int* p_len = p_last + n;
  float* p_lm = reinterpret_cast<float*>(p_len + n);
  const RankTables table = rank_tables(scratch, n);

  // ---- candidate expansion: lane -> (parent beam w, extension e) ----
  const int w = lane % r;
  const int e = lane / r;
  float c_pb = kNegInf, c_pnb = kNegInf, c_total = kNegInf, c_lplast = kNegInf;
  float c_lm = 0.f, c_bonus = 0.f;
  int c_hash = 0, c_last = -1, c_len = 0;
  bool c_valid = false;
  if (e <= k) {
    c_pb = pb[w];
    c_pnb = pnb[w];
    c_total = logaddexp(c_pb, c_pnb);
    c_valid = c_total > kAliveFloor;
    c_hash = hash[w];
    c_last = last[w];
    c_len = len[w];
    c_lplast = (c_last >= 0 && c_last < class_count) ? fr[2 * k + c_last] : kNegInf;
    if (lm != nullptr) {
      c_lm = lm[w];
      c_bonus = bonus[w];
    }
  }
  float cand_pb, cand_pnb, cand_lm;
  int cand_hash, cand_last, cand_len;
  if (e == 0) {  // stay: emit blank, or repeat the last character
    cand_pb = c_valid ? c_total + fr[2 * k + blank] : kNegInf;
    cand_pnb = (c_valid && c_last >= 0) ? c_pnb + c_lplast : kNegInf;
    cand_hash = c_hash;
    cand_last = c_last;
    cand_len = c_len;
    cand_lm = c_lm;
  } else {  // extend with the e-th pruned class (lanes past k are dead)
    const bool extends = e <= k;
    const float ext_score = extends ? fr[e - 1] : kNegInf;
    const int ext_char = extends ? static_cast<int>(fr[k + e - 1]) : -1;
    const float ext_base = ext_char == c_last ? c_pb : c_total;
    const bool ext_ok = c_valid && ext_char >= 0 && ext_char != blank && c_len < max_len;
    cand_pb = kNegInf;
    cand_pnb = ext_ok ? ext_base + ext_score : kNegInf;
    cand_hash = static_cast<int>(static_cast<unsigned>(c_hash) * kHashMultiplier
                                 + static_cast<unsigned>(ext_char + 2));
    cand_last = ext_char;
    cand_len = min(c_len + 1, max_len);
    cand_lm = ext_char != space_index ? c_lm : c_lm + c_bonus;
  }
  const bool alive = logaddexp(cand_pb, cand_pnb) > kAliveFloor;
  const int idx = alive ? w * (k + 1) + e : kIntMax;
  p_pb[lane] = cand_pb;
  p_pnb[lane] = cand_pnb;
  p_idx[lane] = idx;
  p_last[lane] = cand_last;
  p_len[lane] = cand_len;
  p_lm[lane] = cand_lm;

  // ---- rank network: group live candidates by hash in a shared-memory table ----
  int slot = -1;
  // A live hash equal to the dead key joins the dead run in the reference: rare, exact
  // only in the sorted network.
  bool crowded = alive && cand_hash == kDeadKey;
  if (alive) {
    const int table_bits = __ffs(2 * n) - 1;
    const unsigned long long tag = (1ull << 32) | static_cast<unsigned>(cand_hash);
    unsigned s = (static_cast<unsigned>(cand_hash) * 2654435761u) >> (32 - table_bits);
    for (;;) {
      const unsigned long long seen = atomicCAS(&table.tags[s], 0ull, tag);
      if (seen == 0ull || seen == tag) break;
      s = (s + 1) & (2 * n - 1);
    }
    slot = static_cast<int>(s);
    const int position = atomicAdd(&table.counts[slot], 1);
    if (position < 2) {
      table.members[2 * slot + position] = lane;
    } else {
      crowded = true;
    }
  }
  bool exact = __syncthreads_or(crowded) != 0;
  bool representative = false;
  float m_pb = cand_pb, m_pnb = cand_pnb;
  if (!exact) {
    // A pair merges into its min-index member; a single stands for itself.
    bool conflict = false;
    unsigned long long rank_key = 0ull;
    if (alive) {
      representative = true;
      if (table.counts[slot] == 2) {
        const int first = table.members[2 * slot];
        const int other = first == lane ? table.members[2 * slot + 1] : first;
        conflict = p_last[other] != cand_last || p_len[other] != cand_len;
        m_pb = logaddexp(cand_pb, p_pb[other]);
        m_pnb = logaddexp(cand_pnb, p_pnb[other]);
        representative = idx < p_idx[other];
      }
      if (representative) {
        const float score = logaddexp(m_pb, m_pnb) + cand_lm;
        rank_key = (static_cast<unsigned long long>(ordered_bits(score)) << 32)
                   | (0xffffffffu - static_cast<unsigned>(idx));
      }
    }
    table.keys[lane] = rank_key;
    exact = __syncthreads_or(conflict) != 0;
  }
  if (slot >= 0) {  // every read of the table is done: leave it empty
    table.tags[slot] = 0ull;
    table.counts[slot] = 0;
  }
  if (exact) {
    sorted_network(alive ? cand_hash : kDeadKey, out_pb, out_pnb, out_hash, out_last,
                   out_len, out_lm, out_idx, scratch, r, k, beam_width);
    return true;
  }

  // ---- top-W by rank: how many merged prefixes come before this one ----
  if (representative || lane < r) {
    const unsigned long long mine = table.keys[lane];
    const int candidates = (k + 1) * r;  // even: r >= 8
    int before = 0, merged = 0;
    for (int j = 0; j < candidates; j += 2) {
      const ulonglong2 pair = *reinterpret_cast<const ulonglong2*>(table.keys + j);
      before += (pair.x > mine) + (pair.y > mine);
      merged += (pair.x != 0ull) + (pair.y != 0ull);
    }
    if (representative && before < beam_width) {
      out_pb[before] = m_pb;
      out_pnb[before] = m_pnb;
      out_hash[before] = cand_hash;
      out_last[before] = cand_last;
      out_len[before] = cand_len;
      if (out_lm != nullptr) out_lm[before] = cand_lm;
      out_idx[before] = idx;
    }
    if (lane < r && lane >= min(merged, beam_width)) {  // no prefix for this beam slot
      out_pb[lane] = kNegInf;
      out_pnb[lane] = kNegInf;
      out_hash[lane] = 0;
      out_last[lane] = -1;
      out_len[lane] = 0;
      if (out_lm != nullptr) out_lm[lane] = 0.f;
      out_idx[lane] = lane * (k + 1);
    }
  }
  return false;
}

}  // namespace beam
