// The word-LM-fused CTC prefix beam over a span of frames in one launch, hand-written
// for Hopper (K4 redesigned).
//
// Replaces the TPU kernel speechless_tpu/ops/decode_pallas_lm.py::_lm_step_kernel
// together with the XLA gathers the TPU had to leave between its calls
// (decode_pallas_lm.py::_make_scan_body): it computes what a loop of
// speechless_tpu_torch/ops/decode_lm.py::_advance over lm_step_reference computes, bit
// for bit; that loop, lm_span_reference, is its plain PyTorch twin. One thread block
// per row loops over the frames. The carry (pb, pnb, hash, last, length, LM score and,
// with a word LM, the trie node and the two-word context) stays in shared memory from
// the first frame to the last. Each frame, in _advance's order:
//
// 1. the word bonus of every beam (ops/beam_common.py::word_bonuses): the trie node's
//    completed word and the Katz backoff of lm/device_lm.py::score_word_device, the
//    unigram and backoff reads and three 2-choice probes with the uint32 slot mixes of
//    device_lm.py:182-200, read from the DeviceWordLm tables in device memory (they
//    stay in L2), summed with __fmul_rn/__fadd_rn in torch's order so that no
//    contraction changes a bit. It is computed at the end of the frame before, for the
//    beams that frame made;
// 2. the frame step of beam_step.cuh;
// 3. the `t < counts[row]` mask: a row runs its own frames and then stops;
// 4. the trie walk and the context shift through each new beam's parent;
// 5. the (parent, emitted char) backpointers, written to (B, F, r) int32, with
//    identity pointers for the frames past the row's count.
// The next frame's packed row is copied in with cp.async while the current one runs.
// After the last frame the kernel writes the carry and the word bonus of the final
// beams (the trailing word's share of the final ranking).
//
// What bounds it on the H100: latency. A 16 x 513 span moves ~4 MB (the frames in, the
// backpointers out: ~1.2 us at 3.35 TB/s), but every row is a chain of F dependent
// frames, each a few block barriers and three dependent L2 round trips for the LM (the
// node's word, the probe keys, the trie edge); 16 rows keep 16 of 132 SMs busy. What
// the design does about it: no launch and no host step between frames, the state never
// leaves shared memory, and the frame step takes the rank network (a handful of
// barriers) instead of two bitonic sorts.
#include "beam_step.cuh"

namespace {

// A row's carry in device memory: (B, r) blocks; word_ctx is (B, r, 2). The word-LM
// leaves are null without an LM.
struct Carry {
  float* pb;
  float* pnb;
  int* hash;
  int* last;
  int* len;
  float* lm;
  int* trie_node;
  int* word_ctx;
};

// The DeviceWordLm tables (lm/device_lm.py) and the fusion weights.
struct WordLm {
  const int* trie;        // (nodes, trie_classes) char transitions, -1 = no edge
  const int* node_word;   // (nodes,) completed word id, -1 = none
  const float* uni_logp;  // (V,)
  const float* uni_bo;    // (V,)
  const int* bi_keys;     // (bi_size, 2)
  const float* bi_logp;
  const float* bi_bo;
  const int* tri_keys;    // (tri_size, 3)
  const float* tri_logp;
  int trie_classes;
  unsigned bi_size;
  unsigned tri_size;
  int unk_id;
  float lm_weight;
  float word_count_weight;
  float valid_word_count_weight;
};

constexpr int kStateArrays = 12;  // r-lane arrays of the carry in shared memory

// device_lm.py::_slot's uint32 mixes, one per side of the 2-choice table.
__device__ __forceinline__ unsigned mix(int a, int b, int side) {
  return side == 0 ? (static_cast<unsigned>(a) * 2654435761u) ^
                         (static_cast<unsigned>(b) * 40503u)
                   : (static_cast<unsigned>(a) * 3266489917u) ^
                         (static_cast<unsigned>(b) * 668265263u);
}

__device__ __forceinline__ unsigned mix(int a, int b, int c, int side) {
  return mix(a, b, side) ^
         (static_cast<unsigned>(c) * (side == 0 ? 2246822519u : 374761393u));
}

// Bigram probe of (a, b): sets the log10 p and backoff of a hit, 0 on a miss.
__device__ __forceinline__ bool probe2(const WordLm& lm, int a, int b, float& logp,
                                       float& backoff) {
  const unsigned sa = mix(a, b, 0) % lm.bi_size, sb = mix(a, b, 1) % lm.bi_size;
  const float pa = lm.bi_logp[sa], pb = lm.bi_logp[sb];
  const float ba = lm.bi_bo[sa], bb = lm.bi_bo[sb];
  const bool hit_a = lm.bi_keys[2 * sa] == a && lm.bi_keys[2 * sa + 1] == b;
  const bool hit_b = lm.bi_keys[2 * sb] == a && lm.bi_keys[2 * sb + 1] == b;
  const bool hit = hit_a || hit_b;
  logp = hit ? (hit_a ? pa : pb) : 0.f;
  backoff = hit ? (hit_a ? ba : bb) : 0.f;
  return hit;
}

__device__ __forceinline__ bool probe3(const WordLm& lm, int a, int b, int c,
                                       float& logp) {
  const unsigned sa = mix(a, b, c, 0) % lm.tri_size, sb = mix(a, b, c, 1) % lm.tri_size;
  const float pa = lm.tri_logp[sa], pb = lm.tri_logp[sb];
  const int* ka = lm.tri_keys + 3 * sa;
  const int* kb = lm.tri_keys + 3 * sb;
  const bool hit_a = ka[0] == a && ka[1] == b && ka[2] == c;
  const bool hit_b = kb[0] == a && kb[1] == b && kb[2] == c;
  logp = hit_a ? pa : (hit_b ? pb : 0.f);
  return hit_a || hit_b;
}

// device_lm.py::score_word_device: log10 P(w | c1, c2) with Katz backoff.
__device__ float score_word(const WordLm& lm, int c1, int c2, int w) {
  const float uni = lm.uni_logp[w];
  const float bo1 = lm.uni_bo[c2];
  float bi_logp, unused, tri_logp, ctx_logp, bo2;
  const bool bi_hit = probe2(lm, c2, w, bi_logp, unused);
  const bool tri_hit = probe3(lm, c1, c2, w, tri_logp);
  probe2(lm, c1, c2, ctx_logp, bo2);  // a missing context backs off by 0
  const float bi_score = bi_hit ? bi_logp : __fadd_rn(bo1, uni);
  return tri_hit ? tri_logp : __fadd_rn(bo2, bi_score);
}

// beam_common.py::word_bonuses for one beam: the bonus a space extension would earn
// now, and the normalized id of the word in progress (OOV -> <unk>).
__device__ void word_bonus(const WordLm& lm, int node, int c1, int c2, float& bonus,
                           int& normalized) {
  const int completed = node > 0 ? lm.node_word[node] : -1;
  normalized = completed >= 0 ? completed : lm.unk_id;
  const float log10_p = score_word(lm, c1, c2, normalized);
  bonus = node != 0
              ? __fadd_rn(__fadd_rn(__fmul_rn(lm.lm_weight, log10_p), lm.word_count_weight),
                          __fmul_rn(lm.valid_word_count_weight, completed >= 0 ? 1.f : 0.f))
              : 0.f;
}

// kMaxLanes bounds the block (512 or 1024 candidate lanes) so that ptxas fits the
// registers of 1024 threads into the SM's 65,536 only where a launch needs them.
template <int kMaxLanes>
__global__ void __launch_bounds__(kMaxLanes) lm_beam_span_kernel(
    const float* __restrict__ frames, const int* __restrict__ counts, Carry in, Carry out,
    int* __restrict__ parents, int* __restrict__ chars, float* __restrict__ tail_bonus,
    int* __restrict__ sorted_frames, WordLm lm, bool has_lm, int span, int batch,
    int frame_width, int r, int k, int class_count, int blank, int beam_width,
    int max_len, int space_index) {
  extern __shared__ int smem[];
  const int n = blockDim.x;
  const int lane = threadIdx.x;
  const int row = blockIdx.x;
  int* scratch = smem;
  float* st_pb = reinterpret_cast<float*>(smem + beam::kScratchWords * n);
  float* st_pnb = st_pb + r;
  int* st_hash = reinterpret_cast<int*>(st_pnb + r);
  int* st_last = st_hash + r;
  int* st_len = st_last + r;
  float* st_lm = reinterpret_cast<float*>(st_len + r);
  float* st_bonus = st_lm + r;
  int* st_idx = reinterpret_cast<int*>(st_bonus + r);
  int* st_node = st_idx + r;
  int* st_ctx1 = st_node + r;
  int* st_ctx2 = st_ctx1 + r;
  int* st_norm = st_ctx2 + r;
  float* rows = reinterpret_cast<float*>(st_norm + r);  // two packed frame rows

  const size_t at = static_cast<size_t>(row) * r;
  beam::init_scratch(scratch);
  if (lane < r) {
    st_pb[lane] = in.pb[at + lane];
    st_pnb[lane] = in.pnb[at + lane];
    st_hash[lane] = in.hash[at + lane];
    st_last[lane] = in.last[at + lane];
    st_len[lane] = in.len[at + lane];
    st_lm[lane] = in.lm[at + lane];
    st_bonus[lane] = 0.f;
    if (has_lm) {
      const int node = in.trie_node[at + lane];
      const int c1 = in.word_ctx[2 * (at + lane)], c2 = in.word_ctx[2 * (at + lane) + 1];
      st_node[lane] = node;
      st_ctx1[lane] = c1;
      st_ctx2[lane] = c2;
      word_bonus(lm, node, c1, c2, st_bonus[lane], st_norm[lane]);
    }
  }
  const int length = min(max(counts[row], 0), span);
  if (length > 0) {
    beam::prefetch_row(rows, frames + static_cast<size_t>(row) * frame_width, frame_width);
  }
  int sorted = 0;
  for (int t = 0; t < length; ++t) {
    __pipeline_wait_prior(0);
    __syncthreads();  // frame t has landed; the beams and their bonuses are current
    const float* fr = rows + (t & 1) * frame_width;
    if (t + 1 < length) {
      beam::prefetch_row(rows + ((t + 1) & 1) * frame_width,
                         frames + (static_cast<size_t>(t + 1) * batch + row) * frame_width,
                         frame_width);
    }
    sorted += beam::beam_step(fr, st_pb, st_pnb, st_hash, st_last, st_len, st_lm, st_bonus,
                              st_pb, st_pnb, st_hash, st_last, st_len, st_lm, st_idx,
                              scratch, r, k, class_count, blank, beam_width, max_len,
                              space_index);
    __syncthreads();  // the new beams, written by whichever lane ranked them
    int parent_node = 0, parent_ctx1 = 0, parent_ctx2 = 0, parent_norm = 0, new_last = -1;
    bool emitted = false;
    if (lane < r) {
      const int idx = st_idx[lane];
      const int parent = idx / (k + 1);
      emitted = idx % (k + 1) > 0;
      new_last = st_last[lane];
      const size_t bp = (static_cast<size_t>(row) * span + t) * r + lane;
      parents[bp] = parent;
      chars[bp] = emitted ? new_last : -1;
      if (has_lm) {
        parent_node = st_node[parent];
        parent_ctx1 = st_ctx1[parent];
        parent_ctx2 = st_ctx2[parent];
        parent_norm = st_norm[parent];
      }
    }
    if (has_lm) {
      __syncthreads();  // every lane has read its parent's word state
      if (lane < r) {
        const bool is_space = emitted && new_last == space_index;
        const bool is_char = emitted && !is_space;
        int node = is_space ? 0 : parent_node;
        if (is_char) {
          const int c = min(max(new_last, 0), lm.trie_classes - 1);
          node = parent_node < 0
                     ? -1
                     : lm.trie[static_cast<size_t>(parent_node) * lm.trie_classes + c];
        }
        const bool shift = is_space && parent_node != 0;  // a word completed
        const int c1 = shift ? parent_ctx2 : parent_ctx1;
        const int c2 = shift ? parent_norm : parent_ctx2;
        st_node[lane] = node;
        st_ctx1[lane] = c1;
        st_ctx2[lane] = c2;
        word_bonus(lm, node, c1, c2, st_bonus[lane], st_norm[lane]);
      }
    }
  }
  // Frames past the row's count pass every beam through.
  const size_t tail = static_cast<size_t>(span - length) * r;
  const size_t tail_at = (static_cast<size_t>(row) * span + length) * r;
  for (size_t i = lane; i < tail; i += n) {
    parents[tail_at + i] = static_cast<int>(i % r);
    chars[tail_at + i] = -1;
  }
  __syncthreads();
  if (lane < r) {
    out.pb[at + lane] = st_pb[lane];
    out.pnb[at + lane] = st_pnb[lane];
    out.hash[at + lane] = st_hash[lane];
    out.last[at + lane] = st_last[lane];
    out.len[at + lane] = st_len[lane];
    out.lm[at + lane] = st_lm[lane];
    tail_bonus[at + lane] = st_bonus[lane];
    if (has_lm) {
      out.trie_node[at + lane] = st_node[lane];
      out.word_ctx[2 * (at + lane)] = st_ctx1[lane];
      out.word_ctx[2 * (at + lane) + 1] = st_ctx2[lane];
    }
  }
  if (lane == 0) sorted_frames[row] = sorted;
}

}  // namespace

// C entry point (loaded with ctypes). Launches one block of n_pad threads per row on
// `stream`, allocates nothing, and returns the launch's cudaError_t (0 = success).
// `frames` is (span, batch, frame_width) as decode_lm.pack_frames lays it out; the
// carry leaves are (batch, r) (word_ctx (batch, r, 2)); `trie` null means no word LM,
// and then trie_node, word_ctx and the other tables may be null too. Outputs: the carry
// after the span, backpointers (batch, span, r), the final beams' word bonus (batch, r)
// and, per row, how many frames took the step's sorted network.
extern "C" int lm_beam_span(
    const float* frames, const int* counts, float* pb, float* pnb, int* hash, int* last,
    int* len, float* lm, int* trie_node, int* word_ctx, float* out_pb, float* out_pnb,
    int* out_hash, int* out_last, int* out_len, float* out_lm, int* out_trie_node,
    int* out_word_ctx, int* parents, int* chars, float* tail_bonus, int* sorted_frames,
    const int* trie, const int* node_word, const float* uni_logp, const float* uni_bo,
    const int* bi_keys, const float* bi_logp, const float* bi_bo, const int* tri_keys,
    const float* tri_logp, int batch, int span, int frame_width, int r, int k, int n_pad,
    int class_count, int blank, int beam_width, int max_len, int space_index,
    int trie_classes, int bi_size, int tri_size, int unk_id, float lm_weight,
    float word_count_weight, float valid_word_count_weight, void* stream) {
  if (batch == 0) return 0;
  const Carry in{pb, pnb, hash, last, len, lm, trie_node, word_ctx};
  const Carry out{out_pb, out_pnb, out_hash, out_last, out_len, out_lm, out_trie_node,
                  out_word_ctx};
  const WordLm word_lm{trie, node_word, uni_logp, uni_bo, bi_keys, bi_logp, bi_bo,
                       tri_keys, tri_logp, trie_classes, static_cast<unsigned>(bi_size),
                       static_cast<unsigned>(tri_size), unk_id, lm_weight,
                       word_count_weight, valid_word_count_weight};
  const int shared_bytes = static_cast<int>(sizeof(int)) *
                           (beam::kScratchWords * n_pad + kStateArrays * r + 2 * frame_width);
  auto kernel = n_pad <= 512 ? lm_beam_span_kernel<512> : lm_beam_span_kernel<1024>;
  if (shared_bytes > 48 * 1024) {
    const cudaError_t status = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, shared_bytes);
    if (status != cudaSuccess) return static_cast<int>(status);
  }
  kernel<<<batch, n_pad, shared_bytes, static_cast<cudaStream_t>(stream)>>>(
      frames, counts, in, out, parents, chars, tail_bonus, sorted_frames, word_lm,
      trie != nullptr, span, batch, frame_width, r, k, class_count, blank, beam_width,
      max_len, space_index);
  return static_cast<int>(cudaGetLastError());
}
