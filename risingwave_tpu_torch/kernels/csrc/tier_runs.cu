// Hand-written CUDA kernels (sm_90a) for the ★ state-tiering cores of
// risingwave_tpu/device/fused.py:
//
//   AggNode._tier_tail :1186, the join's touch tail :1584-1605 and the
//   promote cores' touch carry :1852-1860, :1891-1898
//                                            -> rw_touch_stamp
//   _agg_evict_core :1758, _mv_evict_core :1788, _join_evict_core :1809
//   (the membership searchsorted and the compact_rows passes)
//                                            -> rw_tier_partition
//
// rw_touch_stamp: in the JAX package two searchsorteds, two gathers and
// two masked sums over the key table. Here one thread per row of the new
// table does the two binary searches (a lower bound into the old keys to
// carry the row's stamp across the merge's permutation, one into the
// sorted touched / promoted keys), writes the stamp, and the block
// reduces its live and cold counts with warp shuffles into one 64-bit
// atomic add per block. It reads 8 bytes per key and writes 8 per stamp;
// the searches add about log2(n_old) + log2(n_src) dependent reads per
// row, most of them in L2 for the top levels.
//
// rw_tier_partition: in the JAX package a searchsorted of the table into
// the demoted keys, then one compact_rows pass (agg / MV) or two (join:
// the kept rows and the demoted rows). Here one three-phase scan
// (rw_common.cuh) over a packed int64 flag — 1 for a kept row, 2^32 for a
// hit — gives each row both its kept rank (low 32 bits of the exclusive
// prefix) and its hit rank (high 32 bits), so one pass moves each row to
// its prefix; a fill kernel writes the reference's fills past each
// prefix. Each row pays one binary search into the (small) demoted-key
// list per scan phase that reads its flag. Bound by the bytes of the
// table it reads once and of the one or two tables it writes.
//
// Simple and correct first: one thread per row, no vectorised loads.
#include "tier_runs.h"

#include "rw_common.cuh"

namespace {

__global__ void k_touch_stamp(const int64_t* keys, int64_t n,
                              const int64_t* old_keys,
                              const int64_t* old_touch, int64_t n_old,
                              const int64_t* src_keys,
                              const int64_t* src_vals, int64_t n_src,
                              const int64_t* tick_p, int64_t ttl,
                              int64_t empty_key, int64_t* ntouch,
                              unsigned long long* counts) {
  __shared__ unsigned long long red[2][WARPS];
  const int64_t i = int64_t(blockIdx.x) * BLOCK + threadIdx.x;
  const int64_t tick = *tick_p;
  unsigned long long live = 0, cold = 0;
  if (i < n) {
    const int64_t k = keys[i];
    int64_t t = 0;
    if (k != empty_key) {
      const int64_t j = lower_bound(old_keys, n_old, k);
      const bool ofound = j < n_old && old_keys[j] == k;
      const int64_t carried = ofound ? old_touch[j] : 0;
      const int64_t s = lower_bound(src_keys, n_src, k);
      const bool hit = s < n_src && src_keys[s] == k;
      if (src_vals)                    // promotion: the old table wins
        t = ofound ? carried : (hit ? src_vals[s] : 0);
      else                             // epoch stamp: a touch wins
        t = hit ? tick : carried;
      live = 1;
      cold = (tick - t >= ttl) ? 1 : 0;
    }
    ntouch[i] = t;
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    live += __shfl_down_sync(FULL, live, o);
    cold += __shfl_down_sync(FULL, cold, o);
  }
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (lane == 0) {
    red[0][warp] = live;
    red[1][warp] = cold;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    unsigned long long a = 0, b = 0;
    for (int w = 0; w < WARPS; ++w) {
      a += red[0][w];
      b += red[1][w];
    }
    if (a) atomicAdd(&counts[0], a);
    if (b) atomicAdd(&counts[1], b);
  }
}

// 1 for a kept row, 2^32 for a hit, 0 for an empty slot.
struct PartFlag {
  const int64_t* keys;
  const int64_t* dkeys;
  int64_t L;
  int64_t empty;
  __device__ long long operator()(int64_t i) const {
    const int64_t k = keys[i];
    if (k == empty) return 0;
    const int64_t j = lower_bound(dkeys, L, k);
    return (j < L && dkeys[j] == k) ? (1LL << 32) : 1LL;
  }
};

struct PartScatter {
  RwCols cols;
  int want_hits;
  __device__ void operator()(int64_t i, long long rank, long long v) const {
    if (v == 1) {
      const int64_t r = rank & 0xFFFFFFFFLL;
      for (int j = 0; j < cols.n; ++j)
        copy_elem(cols.dtype[j], cols.a[j], i, cols.out[j], r);
    } else if (v != 0 && want_hits) {
      const int64_t r = rank >> 32;
      for (int j = 0; j < cols.n; ++j)
        copy_elem(cols.dtype[j], cols.a[j], i,
                  const_cast<void*>(cols.b[j]), r);
    }
  }
};

__global__ void k_partition_fill(RwCols cols, int64_t n, int want_hits,
                                 const long long* total, int32_t* counts) {
  const int64_t i = int64_t(blockIdx.x) * BLOCK + threadIdx.x;
  const long long t = *total;
  const int64_t kept = t & 0xFFFFFFFFLL, hits = t >> 32;
  if (i == 0) {
    counts[0] = int32_t(kept);
    counts[1] = int32_t(hits);
  }
  if (i >= n) return;
  if (i >= kept)
    for (int j = 0; j < cols.n; ++j)
      put_bits(cols.dtype[j], cols.out[j], i, cols.fill[j]);
  if (want_hits && i >= hits)
    for (int j = 0; j < cols.n; ++j)
      put_bits(cols.dtype[j], const_cast<void*>(cols.b[j]), i,
               cols.fill[j]);
}

}  // namespace

extern "C" {

int rw_touch_stamp(const int64_t* keys, int64_t n, const int64_t* old_keys,
                   const int64_t* old_touch, int64_t n_old,
                   const int64_t* src_keys, const int64_t* src_vals,
                   int64_t n_src, const int64_t* tick, int64_t ttl,
                   int64_t empty_key, int64_t* ntouch, int64_t* counts,
                   void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (n <= 0) return 0;
  k_touch_stamp<<<blocks_of(n), BLOCK, 0, st>>>(
      keys, n, old_keys, old_touch, n_old, src_keys, src_vals, n_src, tick,
      ttl, empty_key, ntouch, reinterpret_cast<unsigned long long*>(counts));
  RW_CHECK(RW_T_TOUCH_STAMP);
  return 0;
}

int64_t rw_tier_scratch_bytes(int64_t n) { return scan_bytes<long long>(n); }

int rw_tier_partition(const int64_t* keys, int64_t n, const int64_t* dkeys,
                      int64_t L, RwCols cols, int want_hits,
                      int64_t empty_key, int32_t* counts, void* scratch,
                      void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (n <= 0) return 0;
  long long* sums = static_cast<long long*>(scratch);
  if (int rc = scan_apply(PartFlag{keys, dkeys, L, empty_key},
                          PartScatter{cols, want_hits}, n, sums, nullptr,
                          st))
    return rc;
  k_partition_fill<<<blocks_of(n), BLOCK, 0, st>>>(
      cols, n, want_hits, sums + tiles_of(n), counts);
  RW_CHECK(RW_T_PARTITION_FILL);
  return 0;
}

}  // extern "C"
