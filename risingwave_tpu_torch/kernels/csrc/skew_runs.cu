// Hand-written CUDA kernels (sm_90a) for the ★ key-skew telemetry cores
// of risingwave_tpu/device/skew_stats.py:
//
//   vnode_occupancy :69, vnode_traffic :84  -> rw_vnode_hist
//   epoch_topk :102 (after its sort), weighted_topk :129
//                                           -> rw_topk_packed
//
// In the JAX package the histogram is a [16, n] one-hot sum over the
// CRC32 vnode of every key (core/vnode.py crc32_u64_jnp :246), and the
// top-K a pack plus lax.top_k. Both move a few bytes per row and do a
// little integer work, so they are bound by the bytes they read: 8 per
// key, plus 1 per live flag and 8 per weight or count.
//
// rw_vnode_hist: one pass in a grid-stride loop. The CRC table sits in
// shared memory (rw_common.cuh); each block adds into 16 shared 64-bit
// counters with shared atomics and then into the output with one global
// atomic per bucket. Integer adds, so the order does not matter.
//
// rw_topk_packed: each thread keeps its own top 4 in registers over a
// grid-stride loop; a shuffle butterfly merges the warp's lists (each
// step merges two disjoint groups of lanes, so no value counts twice),
// one thread merges the block's warps, and a one-block second launch of
// the same kernel merges the blocks' lists. In runs mode a thread at the
// start of a run of equal keys finds the run's end by a binary search.
// Simple and correct first: no vectorised loads.
#include "skew_runs.h"

#include "rw_common.cuh"

namespace {

constexpr int BUCKETS = 16;
constexpr int VNODES = 256;
constexpr int KEY_BITS = 40;
constexpr int64_t KEY_MASK = (int64_t(1) << KEY_BITS) - 1;
constexpr int64_t COUNT_MAX = (int64_t(1) << 22) - 1;
constexpr int64_t MAX_BLOCKS = 1024;

__global__ void k_vnode_hist(const int64_t* keys, const uint8_t* live,
                             const int64_t* weights, int64_t n,
                             int64_t empty_key, unsigned long long* out) {
  __shared__ uint32_t table[256];
  __shared__ unsigned long long cnt[BUCKETS];
  if (threadIdx.x < BUCKETS) cnt[threadIdx.x] = 0;
  crc32_table_fill(table);               // synchronises the block
  const int64_t stride = int64_t(gridDim.x) * blockDim.x;
  for (int64_t i = int64_t(blockIdx.x) * blockDim.x + threadIdx.x; i < n;
       i += stride) {
    const int64_t k = keys[i];
    if (live ? live[i] == 0 : k == empty_key) continue;
    const uint32_t vn = crc32_u64(table, k) % VNODES;
    const unsigned long long w =
        weights ? (unsigned long long)(weights[i]) : 1ull;
    atomicAdd(&cnt[vn * BUCKETS / VNODES], w);
  }
  __syncthreads();
  if (threadIdx.x < BUCKETS && cnt[threadIdx.x] != 0)
    atomicAdd(&out[threadIdx.x], cnt[threadIdx.x]);
}

// t[0] >= t[1] >= t[2] >= t[3]: insert x, keeping the 4 largest (with
// multiplicity). Fixed indices only, so t stays in registers.
__device__ __forceinline__ void top4_insert(long long (&t)[4], long long x) {
  if (x <= t[3]) return;
  if (x > t[0]) {
    t[3] = t[2]; t[2] = t[1]; t[1] = t[0]; t[0] = x;
  } else if (x > t[1]) {
    t[3] = t[2]; t[2] = t[1]; t[1] = x;
  } else if (x > t[2]) {
    t[3] = t[2]; t[2] = x;
  } else {
    t[3] = x;
  }
}

__device__ __forceinline__ long long pack(int64_t key, int64_t count) {
  const int64_t c = count < COUNT_MAX ? count : COUNT_MAX;
  return (long long)((c << KEY_BITS) | (key & KEY_MASK));
}

enum TopkMode { WEIGHTED = 0, RUNS = 1, VALUES = 2 };

// Block b writes the top 4 of its rows to out[4b .. 4b + 3].
template <int MODE>
__global__ void k_topk(const int64_t* keys, const int64_t* counts, int64_t n,
                       int64_t empty_key, int64_t* out) {
  long long t[4] = {0, 0, 0, 0};
  const int64_t stride = int64_t(gridDim.x) * blockDim.x;
  for (int64_t i = int64_t(blockIdx.x) * blockDim.x + threadIdx.x; i < n;
       i += stride) {
    const int64_t k = keys[i];
    if (MODE == VALUES) {
      top4_insert(t, (long long)k);
    } else if (MODE == WEIGHTED) {
      const int64_t c = counts[i];
      if (c > 0 && k != empty_key) top4_insert(t, pack(k, c));
    } else if (k != empty_key && (i == 0 || keys[i - 1] != k)) {
      const int64_t len = upper_bound(keys + i, n - i, k);
      top4_insert(t, pack(k, len));
    }
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    long long u[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) u[j] = __shfl_xor_sync(FULL, t[j], o);
#pragma unroll
    for (int j = 0; j < 4; ++j) top4_insert(t, u[j]);
  }
  __shared__ long long warp_top[WARPS][4];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (lane == 0) {
#pragma unroll
    for (int j = 0; j < 4; ++j) warp_top[warp][j] = t[j];
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    for (int w = 1; w < WARPS; ++w) {
#pragma unroll
      for (int j = 0; j < 4; ++j) top4_insert(t, warp_top[w][j]);
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) out[4 * int64_t(blockIdx.x) + j] = t[j];
  }
}

inline int64_t topk_blocks(int64_t n) {
  const int64_t b = (n + BLOCK - 1) / BLOCK;
  return b < 1 ? 1 : (b > MAX_BLOCKS ? MAX_BLOCKS : b);
}

}  // namespace

extern "C" {

int rw_vnode_hist(const int64_t* keys, const uint8_t* live,
                  const int64_t* weights, int64_t n, int64_t empty_key,
                  int64_t* out, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (n <= 0) return 0;
  const int64_t b = (n + BLOCK - 1) / BLOCK;
  k_vnode_hist<<<unsigned(b < MAX_BLOCKS ? b : MAX_BLOCKS), BLOCK, 0, st>>>(
      keys, live, weights, n, empty_key,
      reinterpret_cast<unsigned long long*>(out));
  RW_CHECK(RW_S_VNODE_HIST);
  return 0;
}

int64_t rw_topk_scratch_bytes(int64_t n) {
  return align256(4 * topk_blocks(n) * int64_t(sizeof(int64_t)));
}

int rw_topk_packed(const int64_t* keys, const int64_t* counts, int64_t n,
                   int64_t empty_key, int64_t* out, void* scratch,
                   void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int64_t nb = topk_blocks(n);
  int64_t* part = nb == 1 ? out : static_cast<int64_t*>(scratch);
  if (counts)
    k_topk<WEIGHTED><<<unsigned(nb), BLOCK, 0, st>>>(keys, counts, n,
                                                     empty_key, part);
  else
    k_topk<RUNS><<<unsigned(nb), BLOCK, 0, st>>>(keys, nullptr, n,
                                                 empty_key, part);
  RW_CHECK(RW_S_TOPK_ROWS);
  if (nb > 1) {
    k_topk<VALUES><<<1, BLOCK, 0, st>>>(part, nullptr, 4 * nb, empty_key,
                                        out);
    RW_CHECK(RW_S_TOPK_MERGE);
  }
  return 0;
}

}  // extern "C"
