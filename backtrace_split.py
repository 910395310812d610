#!/usr/bin/env python3
"""Where the beam backtrace (`csrc/beam_backtrace.cu`) spends its time, on one NVIDIA GPU,
with the stitch kernel (`csrc/stream_stitch.cu`), the other pointer chase, beside it.

    python3 backtrace_split.py [--tree DIR]

``--tree`` measures the port of another checkout (for example the parent commit,
unpacked by ``git archive`` into a directory that .gitignore lists) instead of this
one's; the variants below do not depend on it. On seeded backpointers it prints, with
CUDA events (kernel times from launches queued behind a device sleep, so that they
exclude the host's cost of a call):

* the port's `beam_backtrace` kernel and its wrapper at the serving shape (B=16 rows,
  T=513 frames, r=32 lanes), at r=1024, and in the n-best form (B=1, five starts);
* the port's `stream_stitch` kernel and its wrapper at the streaming shape (N=16
  streams, F=32 frames, r=32 lanes, max_len=512);
* variants of the first backtrace kernel's loop (one warp a row, lane 0 following the
  parent pointers, the path through a (B, T) scratch, then a ballot compaction), built
  here from the source below: the pointers read from device memory (the first kernel,
  with and without the compaction) or staged in shared memory by cp.async first (with
  and without the walk), each equal to `backtrace_tokens` where it writes tokens;
* an empty launch shaped as the new kernel's (16 rows of 8-CTA clusters, 64 threads
  a CTA, two cluster barriers), and the same without clusters;
* the latency of one dependent step of a pointer chase: through device memory (L2),
  through the block's shared memory, and through another block's shared memory in a
  cluster of 8 (distributed shared memory), each a chain of 4,096 steps by one thread.

The chain floor of a kernel is its dependent steps times these latencies. Needs one
CUDA device and nvcc; exits non-zero without them. Prints the card's name and power
limit first and one JSON object last.
"""
import ctypes
import json
import subprocess
import sys
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
CHAIN_STEPS = 4096

VARIANTS_SOURCE = r"""
#include <cooperative_groups.h>
#include <cuda_runtime.h>
namespace cg = cooperative_groups;
namespace {
__device__ __forceinline__ void copy_async16(void* shared, const void* global) {
  const unsigned address = static_cast<unsigned>(__cvta_generic_to_shared(shared));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(address), "l"(global)
               : "memory");
}
__device__ __forceinline__ void wait_all_copies() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// Front-compact a row's path (one warp), as the first kernel does.
__device__ void compact(const int* row_path, int* row_tokens, int t_max, int count,
                        int max_len, int lane) {
  int emitted = 0;
  for (int base = 0; base < t_max; base += 32) {
    const int t = base + lane;
    const int c = t < t_max ? row_path[t] : -1;
    const unsigned ballot = __ballot_sync(0xffffffffu, c >= 0);
    const int at = emitted + __popc(ballot & ((1u << lane) - 1u));
    if (c >= 0 && at < count && at < max_len) row_tokens[at] = c;
    emitted += __popc(ballot);
  }
  const int last = row_path[t_max - 1];
  for (int i = lane; i < max_len; i += 32) {
    if (i < min(emitted, count)) continue;
    row_tokens[i] = (i < count && i >= t_max && emitted == t_max) ? last : -1;
  }
}

// The first kernel: one warp a row, the walk reads device memory.
__global__ void walk_global(const int* __restrict__ parents, const int* __restrict__ chars,
                            const int* __restrict__ best, const int* __restrict__ counts,
                            int* __restrict__ path, int* __restrict__ tokens, int t_max,
                            int r, int max_len, int compact_too) {
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
  if (compact_too) compact(row_path, tokens + row * max_len, t_max, counts[row], max_len, lane);
}

// The row's pointers staged in shared memory (16-byte cp.async; r a multiple of 4),
// then the same walk and compaction on the staged copy (walk_too = 0: staging only).
__global__ void walk_staged(const int* __restrict__ parents, const int* __restrict__ chars,
                            const int* __restrict__ best, const int* __restrict__ counts,
                            int* __restrict__ tokens, int t_max, int r, int max_len,
                            int walk_too) {
  extern __shared__ int shared[];
  const size_t row = blockIdx.x;
  const int words = t_max * r;
  int* staged_parents = shared;
  int* staged_chars = shared + words;
  int* row_path = staged_chars + words;
  for (int i = 4 * threadIdx.x; i < words; i += 4 * blockDim.x) {
    copy_async16(staged_parents + i, parents + row * words + i);
    copy_async16(staged_chars + i, chars + row * words + i);
  }
  wait_all_copies();
  __syncthreads();
  if (!walk_too) {
    if (threadIdx.x == 0) tokens[row * max_len] = staged_chars[words - 1];
    return;
  }
  if (threadIdx.x == 0) {
    int beam = best[row];
    for (int t = t_max - 1; t >= 0; --t) {
      row_path[t] = staged_chars[t * r + beam];
      beam = staged_parents[t * r + beam];
    }
  }
  __syncthreads();
  if (threadIdx.x < 32)
    compact(row_path, tokens + row * max_len, t_max, counts[row], max_len, threadIdx.x);
}

// One thread follows `steps` dependent indices through device memory.
__global__ void chase_global(const int* next, int steps, int* out) {
  int at = 0;
  for (int i = 0; i < steps; ++i) at = __ldcg(next + at);  // L2, not L1
  out[0] = at;
}

// The same through the block's shared memory (the 1024-entry cycle staged first).
__global__ void chase_shared(const int* next, int steps, int* out) {
  __shared__ int cycle[1024];
  for (int i = threadIdx.x; i < 1024; i += blockDim.x) cycle[i] = next[i];
  __syncthreads();
  if (threadIdx.x == 0) {
    int at = 0;
    for (int i = 0; i < steps; ++i) at = cycle[at];
    out[0] = at;
  }
}

// The same through the shared memory of other blocks of a cluster of 8: step i reads
// block 1 + (i % 4)'s copy of the cycle from block 0.
__global__ void __cluster_dims__(8, 1, 1) chase_cluster(const int* next, int steps, int* out) {
  __shared__ int cycle[1024];
  cg::cluster_group cluster = cg::this_cluster();
  for (int i = threadIdx.x; i < 1024; i += blockDim.x) cycle[i] = next[i];
  cluster.sync();
  if (cluster.block_rank() == 0 && threadIdx.x == 0) {
    int at = 0;
    for (int i = 0; i < steps; ++i) at = *cluster.map_shared_rank(cycle + at, 1 + (i & 3));
    out[0] = at;
  }
  cluster.sync();
}

// Nothing but a cluster launch of 8 CTAs a row and two cluster barriers: the floor of
// a launch shaped as the backtrace kernel's.
__global__ void __cluster_dims__(8, 1, 1) cluster_barriers(int* out) {
  cg::cluster_group cluster = cg::this_cluster();
  cluster.sync();
  if (threadIdx.x == 0 && blockIdx.x == 0) out[0] = 1;
  cluster.sync();
}

// The same launch without clusters or barriers: an empty kernel of 8 CTAs a row.
__global__ void empty_launch(int* out) {
  if (threadIdx.x == 0 && blockIdx.x == 0) out[0] = 1;
}
}  // namespace

extern "C" int backtrace_variant(int variant, const int* parents, const int* chars,
                                 const int* best, const int* counts, int* path, int* tokens,
                                 int batch, int t_max, int r, int max_len, int steps,
                                 void* stream_pointer) {
  cudaStream_t stream = static_cast<cudaStream_t>(stream_pointer);
  if (variant <= 1) {
    walk_global<<<batch, 32, 0, stream>>>(parents, chars, best, counts, path, tokens, t_max,
                                          r, max_len, variant);
  } else if (variant <= 3) {
    const int bytes = (2 * t_max * r + t_max) * static_cast<int>(sizeof(int));
    cudaFuncSetAttribute(walk_staged, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    walk_staged<<<batch, 256, bytes, stream>>>(parents, chars, best, counts, tokens, t_max,
                                               r, max_len, variant == 3);
  } else if (variant == 4) {
    chase_global<<<1, 32, 0, stream>>>(parents, steps, tokens);
  } else if (variant == 5) {
    chase_shared<<<1, 32, 0, stream>>>(parents, steps, tokens);
  } else if (variant == 6) {
    chase_cluster<<<8, 32, 0, stream>>>(parents, steps, tokens);
  } else if (variant == 7) {
    cluster_barriers<<<8 * batch, 64, 0, stream>>>(tokens);
  } else {
    empty_launch<<<8 * batch, 64, 0, stream>>>(tokens);
  }
  return static_cast<int>(cudaGetLastError());
}
"""

VARIANTS = {"global_walk": 0, "global": 1, "staged_copy_only": 2, "staged": 3,
            "cluster_barriers": 7, "empty_launch": 8}
CHASES = {"l2": 4, "shared": 5, "cluster": 6}


def build_variants():
    from speechless_tpu_torch.ops import _kernels

    out_dir = ROOT / "build" / "backtrace_split"
    out_dir.mkdir(parents=True, exist_ok=True)
    source = out_dir / "backtrace_variants.cu"
    source.write_text(VARIANTS_SOURCE)
    library = out_dir / "backtrace_variants.so"
    log = subprocess.run([_kernels._nvcc(), *_kernels.NVCC_FLAGS, "-o", str(library),
                          str(source)], capture_output=True, text=True)
    if log.returncode != 0:
        raise SystemExit("nvcc failed:\n" + log.stdout + log.stderr)
    for line in (log.stdout + log.stderr).splitlines():
        if "registers" in line or "spill" in line:
            print("  ptxas: " + line.strip())
    entry = ctypes.CDLL(str(library)).backtrace_variant
    entry.argtypes = [ctypes.c_int] + [ctypes.c_void_p] * 6 + [ctypes.c_int] * 5 + [
        ctypes.c_void_p]
    entry.restype = ctypes.c_int
    return entry


def pointers(rng, batch, t_max, lanes, starts, device):
    """Seeded backpointers (parents in [0, lanes), 60 % of the chars -1), ``starts``
    final lanes a row and their counts (the emitted count, and a few off by some)."""
    import torch

    from speechless_tpu_torch.ops.beam_common import backtrace_tokens

    parents = rng.integers(0, lanes, (batch, t_max, lanes)).astype(np.int32)
    chars = rng.integers(0, 28, (batch, t_max, lanes)).astype(np.int32)
    chars[rng.random(chars.shape) < 0.6] = -1
    best = rng.integers(0, lanes, (batch, starts)).astype(np.int32)
    tensors = [torch.from_numpy(x).to(device) for x in (parents, chars, best)]
    full = torch.full((batch,), t_max, device=device)
    counts = torch.stack([(backtrace_tokens(*tensors[:2], tensors[2][:, s], full,
                                            t_max)[0] >= 0).sum(-1)
                          for s in range(starts)], dim=1).to(torch.int32)
    counts[:, ::3] += torch.from_numpy(rng.integers(-2, 3, counts[:, ::3].shape)).to(
        device, torch.int32)
    tensors.append(counts.clamp(min=0))
    if starts == 1:
        tensors[2], tensors[3] = tensors[2][:, 0].contiguous(), tensors[3][:, 0].contiguous()
    return tensors


def main() -> None:
    import argparse
    import importlib.util

    import torch

    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--tree", type=Path, default=ROOT,
                        help="the checkout whose port is measured (default: this one)")
    tree = parser.parse_args().tree.resolve()
    if not torch.cuda.is_available():
        raise SystemExit("backtrace_split: no CUDA device")
    spec = importlib.util.spec_from_file_location("chip_smoke", ROOT / "chip_smoke.py")
    chip_smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(chip_smoke)
    sys.path.insert(0, str(tree))
    from speechless_tpu_torch.ops import _kernels
    from speechless_tpu_torch.ops.beam_common import backtrace_tokens, beam_backtrace

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True)
    print(smi.stdout.strip())
    print("port measured: {}".format(Path(_kernels.__file__).parents[2]))
    # A tree before the (B, n) form takes one start a row.
    takes_starts = "(B, n)" in (beam_backtrace.__doc__ or "")
    device = torch.device("cuda:0")
    _kernels._build_many(["beam_backtrace", "stream_stitch"])  # built before any timing
    entry = build_variants()
    rng = np.random.default_rng(chip_smoke.SEED + 11)
    stream = torch.cuda.current_stream().cuda_stream
    numbers = {}

    # The port's kernel through its wrapper: times of the launch alone (device) and of
    # the whole call (host clock of back-to-back calls, CUDA events).
    # The n-best form twice: five starts on the row's pointers ((B, n) starts, where
    # the wrapper takes them), and the pointers repeated five times with one start each
    # (the plain batched beam's n-best route before the (B, n) form).
    cases = (("r32", 16, 513, 32, 1), ("r1024", 16, 513, 1024, 1),
             ("nbest5", 1, 513, 32, 5), ("nbest5_repeated", 1, 513, 32, 5))
    for label, batch, t_max, lanes, starts in cases:
        parents, chars, best, counts = pointers(rng, batch, t_max, lanes, starts, device)
        args = (parents, chars, best, counts, t_max)
        if label == "nbest5_repeated":
            args = (parents.repeat_interleave(starts, 0), chars.repeat_interleave(starts, 0),
                    best.reshape(-1), counts.reshape(-1), t_max)
        elif starts > 1 and not takes_starts:
            continue
        want = backtrace_tokens(*args)
        got = beam_backtrace(*args)
        if not all(torch.equal(g, w) for g, w in zip(got, want)):
            raise SystemExit("beam_backtrace {} differs from backtrace_tokens".format(label))
        numbers["kernel_{}_device_ms".format(label)] = chip_smoke.device_ms(
            lambda: beam_backtrace(*args), 200)
        numbers["kernel_{}_call_ms".format(label)] = chip_smoke.cuda_ms(
            lambda: beam_backtrace(*args), 200)

    # The stitch kernel beside it, at the streaming shape (`chip_smoke.py` phase D's).
    from speechless_tpu_torch.ops.decode_incremental_kernel import (stitch_reference,
                                                                    stream_stitch)

    args = chip_smoke.stitch_case(rng, chip_smoke.STREAM_N, chip_smoke.STREAM_CF, 32,
                                  chip_smoke.STREAM_MAX_LEN, 29, device)
    if not all(torch.equal(g, w) for g, w in zip(stream_stitch(*args),
                                                  stitch_reference(*args))):
        raise SystemExit("stream_stitch differs from stitch_reference")
    numbers["stitch_device_ms"] = chip_smoke.device_ms(lambda: stream_stitch(*args), 200)
    numbers["stitch_call_ms"] = chip_smoke.cuda_ms(lambda: stream_stitch(*args), 200)

    # Variants of the first kernel's loop at the serving shape.
    batch, t_max, lanes = 16, 513, 32
    parents, chars, best, counts = pointers(rng, batch, t_max, lanes, 1, device)
    want = backtrace_tokens(parents, chars, best, counts, t_max)[0]
    path = torch.empty((batch, t_max), dtype=torch.int32, device=device)
    for name, variant in VARIANTS.items():
        tokens = torch.full_like(want, -7)

        def run():
            status = entry(variant, parents.data_ptr(), chars.data_ptr(), best.data_ptr(),
                           counts.data_ptr(), path.data_ptr(), tokens.data_ptr(), batch,
                           t_max, lanes, t_max, 0, stream)
            if status:
                raise RuntimeError("variant {} launch failed: {}".format(name, status))

        run()
        torch.cuda.synchronize()
        if name in ("global", "staged") and not torch.equal(tokens, want):
            raise SystemExit("variant {} differs from backtrace_tokens".format(name))
        numbers[name + "_ms"] = chip_smoke.device_ms(run, 200)
        numbers[name + "_us_per_frame"] = numbers[name + "_ms"] * 1e3 / t_max

    # Latency of one dependent step: a random cycle through 1,024 entries.
    order = rng.permutation(1024)
    nxt = np.empty(1024, np.int32)
    nxt[order] = order[(np.arange(1024) + 1) % 1024]
    nxt = torch.from_numpy(nxt).to(device)
    out = torch.empty(1, dtype=torch.int32, device=device)
    for name, variant in CHASES.items():
        def chase(steps):
            status = entry(variant, nxt.data_ptr(), 0, 0, 0, 0, out.data_ptr(), 1, 1, 1, 1,
                           steps, stream)
            if status:
                raise RuntimeError("chase {} launch failed: {}".format(name, status))

        # Two chain lengths, so that the launch's own time drops out of the difference.
        long_ms = chip_smoke.device_ms(lambda: chase(CHAIN_STEPS), 50)
        short_ms = chip_smoke.device_ms(lambda: chase(CHAIN_STEPS // 4), 50)
        numbers["chase_{}_ns_per_step".format(name)] = (
            (long_ms - short_ms) * 1e6 / (CHAIN_STEPS - CHAIN_STEPS // 4))
    for key, value in numbers.items():
        print("{}: {:.6f}".format(key, value))
    print(json.dumps(numbers))


if __name__ == "__main__":
    main()
