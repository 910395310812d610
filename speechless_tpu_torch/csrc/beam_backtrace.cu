// The beam backtrace on the device: each start's winning prefix rebuilt from its row's
// per-frame backpointers, hand-written for Hopper.
//
// Not a TPU kernel: it replaces the XLA gathers of speechless_tpu/ops/decode_jax.py::
// backtrace_tokens (ported as speechless_tpu_torch/ops/beam_common.py::backtrace_tokens,
// its plain PyTorch twin), which launch two small gathers per frame from the host. A
// row has `starts` final lanes to trace (one, or an n-best list); each reads the row's
// pointers, and its emitted chars go to tokens front-compacted in time order, -1 past
// its count, and past t_max the last packed entry (an emitted char only when every
// frame emitted), as backtrace_tokens' clamped gather gives.
//
// What bounds it on the H100: the chain of dependent pointer reads, not bytes (two words
// a frame along each path). Following T = 513 parents one after another through L2
// took 0.17 us a frame (backtrace_split.py). The design cuts the chain into segments
// and the reads into shared memory:
//   * a row's frames are split over the CTAs of a thread-block cluster (up to 8, one
//     per 32 frames), so 16 rows keep 128 SMs busy; each CTA's frames are cut into
//     segments of at most 32 frames, and each segment's (parent, char) pointers are
//     staged in shared memory by cp.async;
//   * map: for every lane at a segment's exit, one thread walks the segment and records
//     the lane it reaches at the segment's entry and how many chars it emitted; the
//     CTA composes its segments' maps into one map over its frames;
//   * resolve: each CTA follows every start from the last CTA to the first, one hop a
//     CTA through the other CTAs' maps in distributed shared memory, which gives the
//     lane at its own frames' exit and the number of chars emitted before them; each
//     start's lane and count are read from device memory while the first pointers
//     stage, off the chain;
//   * rewalk: one thread a (segment, start) walks its segment again from the resolved
//     lane and writes the chars straight to their final positions in tokens; the CTAs
//     fill the rest of the rows (-1, or the last char) in stripes.
// The dependent chain is about 2 x (segment length) shared-memory steps, the CTA's
// segments, and one distributed-shared-memory hop per CTA. Where a CTA's frames do not
// fit in shared memory at once (many lanes), its segments are staged in groups, and
// each group is staged and mapped again for the rewalk.
#include <cooperative_groups.h>
#include <cuda_runtime.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kMaxCluster = 8;        // CTAs a row (the portable cluster size)
constexpr int kMaxSegment = 32;       // frames a segment
constexpr int kStageBytes = 160 * 1024;   // staged pointers a CTA
constexpr int kSharedLimit = 227 * 1024;  // dynamic shared memory a block may opt into

struct Layout {
  int cluster;      // CTAs a row
  int cta_frames;   // frames a CTA (the last one may have fewer)
  int segment;      // frames a segment
  int group;        // segments staged at once
  int threads;
  int shared_bytes;
};

__device__ __forceinline__ void copy_async4(int* shared, const int* global) {
  const unsigned address = static_cast<unsigned>(__cvta_generic_to_shared(shared));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(address), "l"(global)
               : "memory");
}
__device__ __forceinline__ void copy_async16(int* shared, const int* global) {
  const unsigned address = static_cast<unsigned>(__cvta_generic_to_shared(shared));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(address), "l"(global)
               : "memory");
}

// Copy `count` contiguous ints into shared memory (16 bytes a copy where the source
// allows it; `shared` is 16-byte aligned) and wait for them, block-wide.
__device__ void stage(int* shared, const int* global, int count) {
  if ((reinterpret_cast<size_t>(global) & 15) == 0 && (count & 3) == 0) {
    for (int i = 4 * threadIdx.x; i < count; i += 4 * blockDim.x)
      copy_async16(shared + i, global + i);
  } else {
    for (int i = threadIdx.x; i < count; i += blockDim.x) copy_async4(shared + i, global + i);
  }
}

__global__ void __launch_bounds__(1024)
beam_backtrace_kernel(const int* __restrict__ parents, const int* __restrict__ chars,
                      const int* __restrict__ best, const int* __restrict__ counts,
                      int* __restrict__ tokens, int t_max, int r, int starts, int max_len,
                      Layout layout) {
  extern __shared__ __align__(16) int shared[];
  cg::cluster_group cluster = cg::this_cluster();
  const int q = static_cast<int>(cluster.block_rank());
  const int cluster_size = layout.cluster;
  const size_t row = blockIdx.x / cluster_size;
  const int tid = threadIdx.x, threads = blockDim.x;
  const int seg_len = layout.segment, group = layout.group;

  const int stage_words = (group * seg_len * r + 3) & ~3;
  int* staged_parents = shared;
  int* staged_chars = staged_parents + stage_words;
  int* seg_entry = staged_chars + stage_words;  // [group][r]
  int* seg_count = seg_entry + group * r;       // [group][r]
  int* cta_entry = seg_count + group * r;       // [r]: read by the other CTAs
  int* cta_count = cta_entry + r;               // [r]
  int* start_best = cta_count + r;              // [starts]
  int* start_limit = start_best + starts;       // [starts]: its count
  int* start_exit = start_limit + starts;       // [starts]
  int* start_end = start_exit + starts;         // [starts]: position after the CTA's chars
  int* start_emitted = start_end + starts;      // [starts]
  int* seg_exit = start_emitted + starts;       // [group][starts]
  int* seg_end = seg_exit + group * starts;     // [group][starts]

  const int f0 = min(t_max, q * layout.cta_frames);
  const int f1 = min(t_max, f0 + layout.cta_frames);
  const int segments = (f1 - f0 + seg_len - 1) / seg_len;
  const int groups = (segments + group - 1) / group;
  const int* row_parents = parents + row * t_max * r;
  const int* row_chars = chars + row * t_max * r;

  // Start copying group g's frames into shared memory; returns its segment count.
  auto stage_group = [&](int g) {
    const int first = f0 + g * group * seg_len;
    const int count = (min(f1, first + group * seg_len) - first) * r;
    stage(staged_parents, row_parents + static_cast<size_t>(first) * r, count);
    stage(staged_chars, row_chars + static_cast<size_t>(first) * r, count);
    asm volatile("cp.async.commit_group;\n" ::: "memory");
    return (min(f1, first + group * seg_len) - first + seg_len - 1) / seg_len;
  };
  // Wait for the staged group and map each of its `local` segments: for every lane at
  // the segment's exit, the lane at its entry and the chars emitted on the way.
  auto map_group = [&](int g, int local) {
    const int frames = min(f1, f0 + (g + 1) * group * seg_len) - (f0 + g * group * seg_len);
    asm volatile("cp.async.wait_group 0;\n" ::: "memory");
    __syncthreads();
    for (int job = tid; job < local * r; job += threads) {
      const int j = job / r;
      int lane = job - j * r, emitted = 0;
      for (int t = min(frames, (j + 1) * seg_len) - 1; t >= j * seg_len; --t) {
        emitted += staged_chars[t * r + lane] >= 0;
        lane = staged_parents[t * r + lane];
      }
      seg_entry[job] = lane;
      seg_count[job] = emitted;
    }
    __syncthreads();
  };

  // 1. Map the CTA's frames, groups from the last to the first, composing each group's
  //    segment maps into the CTA's map. While the first group stages, each start's
  //    lane and count are read from device memory, off the chain.
  for (int g = groups - 1; g >= 0; --g) {
    const int local = stage_group(g);
    if (g == groups - 1) {
      for (int s = tid; s < starts; s += threads) {
        start_best[s] = best[row * starts + s];
        start_limit[s] = counts[row * starts + s];
      }
    }
    map_group(g, local);
    for (int x = tid; x < r; x += threads) {
      const bool first = g == groups - 1;
      int lane = first ? x : cta_entry[x];
      int emitted = first ? 0 : cta_count[x];
      for (int j = local - 1; j >= 0; --j) {
        emitted += seg_count[j * r + lane];
        lane = seg_entry[j * r + lane];
      }
      cta_entry[x] = lane;
      cta_count[x] = emitted;
    }
    __syncthreads();
  }
  cluster.sync();  // every CTA's map is visible to the cluster

  // 2. Resolve each start through the CTAs' maps, last to first: the lane at this CTA's
  //    exit and the chars emitted in the CTAs after it.
  for (int s = tid; s < starts; s += threads) {
    int lane = start_best[s], after = 0, exit_lane = 0, emitted = 0;
    for (int p = cluster_size - 1; p >= 0; --p) {
      if (p == q) {
        exit_lane = lane;
        after = emitted;
      }
      emitted += *cluster.map_shared_rank(cta_count + lane, p);
      lane = *cluster.map_shared_rank(cta_entry + lane, p);
    }
    start_exit[s] = exit_lane;
    start_end[s] = emitted - after;
    start_emitted[s] = emitted;
  }
  __syncthreads();
  // This CTA reads no other CTA's memory from here on.
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");

  // 3. Rewalk, groups from the last to the first (the last group is still staged when
  //    the CTA has one group): each (segment, start) writes its chars in place.
  for (int g = groups - 1; g >= 0; --g) {
    const int local = min(group, segments - g * group);
    if (groups > 1) map_group(g, stage_group(g));
    for (int s = tid; s < starts; s += threads) {
      int lane = start_exit[s], position = start_end[s];
      for (int j = local - 1; j >= 0; --j) {
        seg_exit[j * starts + s] = lane;
        seg_end[j * starts + s] = position;
        position -= seg_count[j * r + lane];
        lane = seg_entry[j * r + lane];
      }
      start_exit[s] = lane;
      start_end[s] = position;
    }
    __syncthreads();
    const int frames = min(f1, f0 + (g + 1) * group * seg_len) - (f0 + g * group * seg_len);
    for (int job = tid; job < local * starts; job += threads) {
      const int j = job / starts, s = job - j * starts;
      int* out = tokens + (row * starts + s) * max_len;
      const int limit = min(start_limit[s], max_len);
      int lane = seg_exit[job], position = seg_end[job];
      for (int t = min(frames, (j + 1) * seg_len) - 1; t >= j * seg_len; --t) {
        const int c = staged_chars[t * r + lane];
        const int parent = staged_parents[t * r + lane];
        if (c >= 0) {
          --position;
          if (position < limit) out[position] = c;
        }
        lane = parent;
      }
    }
    __syncthreads();
  }

  // 4. The rest of every row, in stripes over the cluster: -1, except positions at or
  //    past t_max below the count when every frame emitted (the last char).
  const int stripe = (max_len + cluster_size - 1) / cluster_size;
  const int lo = q * stripe, hi = min(max_len, lo + stripe);
  for (int job = tid; job < starts * (hi - lo); job += threads) {
    const int s = job / (hi - lo), i = lo + job - s * (hi - lo);
    const int count = start_limit[s], emitted = start_emitted[s];
    if (i < min(emitted, count)) continue;
    tokens[(row * starts + s) * max_len + i] =
        (i < count && i >= t_max && emitted == t_max)
            ? row_chars[static_cast<size_t>(t_max - 1) * r + start_best[s]]
            : -1;
  }
  // No CTA leaves while another may still read its map.
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

// The launch layout: a cluster of ceil(T / 32) CTAs (at most 8) a row, each CTA's
// frames cut into segments of at most 32, staged all at once where they fit in
// kStageBytes and in groups of segments otherwise. Every CTA gets at least one frame:
// with Q = ceil(T / 32) CTAs, (Q - 1) * ceil(T / Q) < T.
bool plan(int t_max, int r, int starts, Layout* layout) {
  const int cluster = min(kMaxCluster, (t_max + kMaxSegment - 1) / kMaxSegment);
  const int cta_frames = (t_max + cluster - 1) / cluster;
  const long long frame_bytes = 8LL * r;
  const int fit = static_cast<int>(kStageBytes / frame_bytes);  // frames staged at once
  if (fit < 1) return false;
  int segment, group;
  if (cta_frames <= fit) {
    const int segments = (cta_frames + kMaxSegment - 1) / kMaxSegment;
    segment = (cta_frames + segments - 1) / segments;
    group = segments;
  } else {
    segment = min(kMaxSegment, fit);
    group = fit / segment;
  }
  const long long stage_words = (static_cast<long long>(group) * segment * r + 3) & ~3LL;
  const long long words = 2 * stage_words + 2LL * group * r + 2LL * r + 5LL * starts +
                          2LL * group * starts;
  if (words * 4 > kSharedLimit) return false;
  const int jobs = max(group * r, 32);
  layout->cluster = cluster;
  layout->cta_frames = cta_frames;
  layout->segment = segment;
  layout->group = group;
  layout->threads = min(1024, max(64, (jobs + 31) / 32 * 32));
  layout->shared_bytes = static_cast<int>(words * 4);
  return true;
}

}  // namespace

// C entry point (loaded with ctypes). parents and chars are (batch, t_max, r) int32;
// best and counts (batch, starts) int32 (start i of row b reads row b's pointers);
// tokens (batch, starts, max_len) int32. One cluster of CTAs per row on `stream`;
// allocates nothing. Returns the launch's cudaError_t (0 = success), or
// cudaErrorInvalidValue for t_max < 1 or a row whose staging does not fit in shared
// memory (more than ~20,000 lanes, or a very long n-best list).
extern "C" int beam_backtrace(const int* parents, const int* chars, const int* best,
                              const int* counts, int* tokens, int batch, int t_max, int r,
                              int starts, int max_len, void* stream) {
  Layout layout;
  if (t_max < 1 || r < 1 || starts < 0 || !plan(t_max, r, starts, &layout))
    return static_cast<int>(cudaErrorInvalidValue);
  if (batch == 0) return 0;
  static bool opted_in = false;
  if (!opted_in) {
    const cudaError_t status = cudaFuncSetAttribute(
        beam_backtrace_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSharedLimit);
    if (status != cudaSuccess) return static_cast<int>(status);
    opted_in = true;
  }
  cudaLaunchConfig_t config = {};
  config.gridDim = dim3(static_cast<unsigned>(batch) * layout.cluster);
  config.blockDim = dim3(layout.threads);
  config.dynamicSmemBytes = layout.shared_bytes;
  config.stream = static_cast<cudaStream_t>(stream);
  cudaLaunchAttribute attribute;
  attribute.id = cudaLaunchAttributeClusterDimension;
  attribute.val.clusterDim.x = layout.cluster;
  attribute.val.clusterDim.y = 1;
  attribute.val.clusterDim.z = 1;
  config.attrs = &attribute;
  config.numAttrs = 1;
  const cudaError_t status = cudaLaunchKernelEx(&config, beam_backtrace_kernel, parents,
                                                chars, best, counts, tokens, t_max, r,
                                                starts, max_len, layout);
  if (status != cudaSuccess) return static_cast<int>(status);
  return static_cast<int>(cudaGetLastError());
}
