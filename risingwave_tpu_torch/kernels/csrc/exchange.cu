// Hand-written CUDA kernel (sm_90a) for the ★ bucket exchange of
// risingwave_tpu/device/shard_exec.py and parallel/sharded_agg.py:
//
//   _exchange_local :165 with _route_dest :148   -> rw_bucket_exchange
//   _bucketize (sharded_agg.py:36)              -> rw_bucket_exchange
//
// One call places one source shard's rows into [n, cap] send buffers, one
// per column: each live row's key gets its vnode (CRC32 mod 256, as the
// parity form of core/vnode.bucket_parity: eight popcounts), the vnode
// its destination shard (the contiguous-block inverse shard_of_vnode, or
// rebalanced block bounds), and the row its slot: the count of earlier
// live rows bound to the same destination. That rank is the contract —
// `cumsum(onehot) - 1` in the JAX package — because the receiver sees
// each key's rows in event order, which keeps an n-shard run bit-identical
// to the 1-shard one (float sums and the pair MV's order included), so no
// atomic may reorder rows within a bucket. Hot keys (key & hot_mask in a
// list) either broadcast (the row takes a slot in every bucket, ranked
// among the rows bound there) or salt (destination pk floor-mod n).
//
// Three launches:
//   k_exch_count  one 2048-row tile a block: the tile's count per class
//                 (n destinations and "broadcast"), shared atomics;
//   k_exch_scan   one block a class: exclusive scan of its tile counts
//                 over the tiles, and the class total;
//   k_exch_place  the tile blocks rank rows in rounds of 256 (one row a
//                 thread, in row order): a warp match per class gives the
//                 in-warp rank, per-warp counts in shared memory the rest,
//                 so the slot is the class's tile offset + the rows of
//                 earlier rounds + earlier warps + earlier lanes (+ the
//                 broadcast rows before it); every column is written at
//                 that slot. The fill blocks write each column's fill to
//                 the slots past each destination's count. Block 0 writes
//                 counts and need.
//
// Bound: the bytes — the key, mask, sign and pk read once and each
// column's [b] input read and [n, cap] buffer written once. At b = 2^20,
// n = 8, cap = 2^15 and five int64 columns that is about 63 MB, 19 us at
// 3.35 TB/s. This simple version reads the routing inputs twice (count,
// place) and writes rows at scattered slots.
#include "exchange.h"

#include "rw_common.cuh"

namespace {

constexpr int MAX_CLS = RW_EXCH_MAX_SHARDS + 1;

// the row's class: its destination 0..n-1, n when it broadcasts, -1 when
// it is dead (or past the end)
__device__ __forceinline__ int row_class(const RwExchArgs& a, int64_t i,
                                         int64_t b) {
  if (i >= b) return -1;
  if (!a.mask[i]) return -1;
  if (a.sign != nullptr && a.sign[i] == 0) return -1;
  const int64_t key = a.key[i];
  const uint64_t k = static_cast<uint64_t>(key);
  int vn = 0;
  for (int j = 0; j < a.vbits; ++j)
    vn |= (__popcll(k & a.vmask[j]) & 1) << j;
  vn ^= int(a.vflip);
  int dest;
  if (a.route == RW_ROUTE_BOUNDS) {
    dest = 0;
    for (int s = 1; s < a.n; ++s) dest += vn >= a.bounds[s];
  } else {
    dest = int(((int64_t(vn) + 1) * a.n - 1) >> a.vbits);
  }
  if (a.hot != RW_HOT_NONE) {
    const int64_t k40 = key & a.hot_mask;
    bool hot = false;
    for (int h = 0; h < a.n_hot; ++h) hot |= k40 == a.hot_keys[h];
    if (hot) {
      if (a.hot == RW_HOT_BCAST) return a.n;
      int64_t r = a.pk[i] % a.n;          // floor-mod, as jnp's `%`
      if (r < 0) r += a.n;
      dest = int(r);
    }
  }
  return dest;
}

__global__ void k_exch_count(const __grid_constant__ RwExchArgs a, int64_t b,
                             int32_t* __restrict__ tile_cnt) {
  __shared__ int32_t cnt[MAX_CLS];
  const int ncls = a.n + 1;
  for (int c = threadIdx.x; c < ncls; c += BLOCK) cnt[c] = 0;
  __syncthreads();
  const int64_t base = int64_t(blockIdx.x) * TILE;
#pragma unroll
  for (int r = 0; r < ITEMS; ++r) {
    const int c = row_class(a, base + r * BLOCK + threadIdx.x, b);
    if (c >= 0) atomicAdd(&cnt[c], 1);
  }
  __syncthreads();
  for (int c = threadIdx.x; c < ncls; c += BLOCK)
    tile_cnt[int64_t(blockIdx.x) * ncls + c] = cnt[c];
}

// block c: tile_base[t][c] = sum of tile_cnt[t'][c] over t' < t, and
// totals[c]
__global__ void k_exch_scan(const int32_t* __restrict__ tile_cnt,
                            int64_t tiles, int ncls,
                            int32_t* __restrict__ tile_base,
                            int32_t* __restrict__ totals) {
  __shared__ int32_t wt[WARPS];
  const int c = blockIdx.x;
  const int64_t per = (tiles + BLOCK - 1) / BLOCK;
  const int64_t t0 = threadIdx.x * per;
  const int64_t t1 = t0 + per < tiles ? t0 + per : tiles;
  int32_t s = 0;
  for (int64_t t = t0; t < t1; ++t) s += tile_cnt[t * ncls + c];
  int32_t total;
  int32_t run = block_excl_scan<int32_t>(s, wt, total);
  for (int64_t t = t0; t < t1; ++t) {
    tile_base[t * ncls + c] = run;
    run += tile_cnt[t * ncls + c];
  }
  if (threadIdx.x == 0) totals[c] = total;
}

__device__ __forceinline__ void write_row(const RwCols& cols, int64_t src,
                                          int64_t dst) {
  for (int j = 0; j < cols.n; ++j)
    copy_elem(cols.dtype[j], cols.a[j], src, cols.out[j], dst);
}

__global__ void k_exch_place(const __grid_constant__ RwExchArgs a,
                             const __grid_constant__ RwCols cols, int64_t b,
                             int64_t tiles, const int32_t* __restrict__
                             tile_base, const int32_t* __restrict__ totals,
                             int64_t* __restrict__ counts,
                             int64_t* __restrict__ need) {
  __shared__ int32_t fill_at[RW_EXCH_MAX_SHARDS];   // per destination
  __shared__ int32_t base[MAX_CLS];   // tile offset + earlier rounds
  __shared__ int32_t wc[WARPS][MAX_CLS];   // this round's per-warp counts
  const int n = a.n, ncls = n + 1;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (blockIdx.x == 0 && threadIdx.x == 0) {
    int64_t mx = 0;
    for (int d = 0; d < n; ++d) {
      const int64_t c = int64_t(totals[d]) + totals[n];
      counts[d] = c;
      mx = c > mx ? c : mx;
    }
    *need = mx;
  }
  if (blockIdx.x >= tiles) {
    // ---- fill: every slot past its destination's count ----------------
    for (int d = threadIdx.x; d < n; d += BLOCK) {
      const int64_t c = int64_t(totals[d]) + totals[n];
      fill_at[d] = int32_t(c < a.cap ? c : a.cap);
    }
    __syncthreads();
    const int64_t total = int64_t(n) * a.cap;
    const int64_t stride = int64_t(gridDim.x - tiles) * BLOCK;
    for (int64_t e = (blockIdx.x - tiles) * int64_t(BLOCK) + threadIdx.x;
         e < total; e += stride) {
      const int64_t d = e / a.cap, p = e - d * a.cap;
      if (p < fill_at[d]) continue;
      const int64_t at = d * a.cap + p;
      for (int j = 0; j < cols.n; ++j)
        put_bits(cols.dtype[j], cols.out[j], at, cols.fill[j]);
    }
    return;
  }
  // ---- place: one tile, in rounds of BLOCK rows ------------------------
  for (int c = threadIdx.x; c < ncls; c += BLOCK)
    base[c] = tile_base[int64_t(blockIdx.x) * ncls + c];
  for (int k = threadIdx.x; k < WARPS * MAX_CLS; k += BLOCK)
    (&wc[0][0])[k] = 0;
  __syncthreads();
  const unsigned lt = (1u << lane) - 1u;
  const int64_t t0 = int64_t(blockIdx.x) * TILE;
  for (int r = 0; r < ITEMS; ++r) {
    const int64_t i = t0 + r * BLOCK + threadIdx.x;
    const int c = row_class(a, i, b);
    const unsigned same = __match_any_sync(FULL, c);
    const unsigned bc = __ballot_sync(FULL, c == n);
    if (c >= 0 && c < n && (same & lt) == 0) wc[warp][c] = __popc(same);
    if (lane == 0) wc[warp][n] = __popc(bc);
    __syncthreads();
    // broadcast rows before this one (whole input)
    int32_t q = base[n] + __popc(bc & lt);
    for (int w = 0; w < warp; ++w) q += wc[w][n];
    if (c >= 0 && c < n) {
      int32_t p = base[c] + __popc(same & lt);
      for (int w = 0; w < warp; ++w) p += wc[w][c];
      const int64_t slot = int64_t(p) + q;
      if (slot < a.cap) write_row(cols, i, int64_t(c) * a.cap + slot);
    }
    if (bc) {
      // a broadcast row takes a slot in every destination, ranked among
      // the rows bound there (warp-uniform loop)
      for (int d = 0; d < n; ++d) {
        const unsigned md = __ballot_sync(FULL, c == d);
        if (c == n) {
          int32_t p = base[d] + __popc(md & lt);
          for (int w = 0; w < warp; ++w) p += wc[w][d];
          const int64_t slot = int64_t(p) + q;
          if (slot < a.cap) write_row(cols, i, int64_t(d) * a.cap + slot);
        }
      }
    }
    __syncthreads();
    for (int k = threadIdx.x; k < ncls; k += BLOCK) {
      int32_t s = 0;
      for (int w = 0; w < WARPS; ++w) {
        s += wc[w][k];
        wc[w][k] = 0;
      }
      base[k] += s;
    }
    __syncthreads();
  }
}

constexpr int64_t FILL_ROWS = 16 * BLOCK;   // slots a fill block takes

}  // namespace

extern "C" {

int64_t rw_exchange_scratch_bytes(int64_t b, int32_t n) {
  const int64_t cells = tiles_of(b) * (n + 1);
  return align256(4 * cells) * 2 + align256(4 * int64_t(n + 1));
}

int rw_bucket_exchange(RwExchArgs args, RwCols cols, int64_t b,
                       int64_t* counts, int64_t* need, void* scratch,
                       void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int ncls = args.n + 1;
  const int64_t tiles = tiles_of(b);
  char* ws = static_cast<char*>(scratch);
  int32_t* tile_cnt = reinterpret_cast<int32_t*>(ws);
  int32_t* tile_base = reinterpret_cast<int32_t*>(
      ws + align256(4 * tiles * ncls));
  int32_t* totals = reinterpret_cast<int32_t*>(
      ws + 2 * align256(4 * tiles * ncls));
  if (tiles > 0) {
    k_exch_count<<<unsigned(tiles), BLOCK, 0, st>>>(args, b, tile_cnt);
    RW_CHECK(RW_S_EXCH_COUNT);
  }
  k_exch_scan<<<ncls, BLOCK, 0, st>>>(tile_cnt, tiles, ncls, tile_base,
                                      totals);
  RW_CHECK(RW_S_EXCH_SCAN);
  const int64_t slots = int64_t(args.n) * args.cap;
  int64_t fills = (slots + FILL_ROWS - 1) / FILL_ROWS;
  if (fills > 4 * 132) fills = 4 * 132;
  if (fills < 1) fills = 1;
  k_exch_place<<<unsigned(tiles + fills), BLOCK, 0, st>>>(
      args, cols, b, tiles, tile_base, totals, counts, need);
  RW_CHECK(RW_S_EXCH_PLACE);
  return 0;
}

}  // extern "C"
