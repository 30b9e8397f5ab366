// Device helpers shared by the kernel sources (sorted_runs.cu,
// join_runs.cu, multiset_runs.cu, window_runs.cu, skew_runs.cu): tile
// geometry, launch checks, typed column access, one- and two-key binary
// searches, the two-key merge placement, the three-phase block scan, the
// decoupled look-back of the one-sweep scans and the CRC32 vnode hash.
//
// Everything here lives in an anonymous namespace: each source compiles
// its own copy, so the library links without device-side relocation.
#pragma once

#include "sorted_runs.h"

#include <cuda_runtime.h>

#include <cmath>
#include <cstdint>

namespace {

constexpr int BLOCK = 256;                 // threads per block (= radix digits)
constexpr int ITEMS = 8;                   // rows per thread per tile
constexpr int TILE = BLOCK * ITEMS;        // rows per tile
constexpr int WARPS = BLOCK / 32;
constexpr unsigned FULL = 0xffffffffu;
constexpr int64_t EMPTY_KEY = 0x7fffffffffffffffLL;

inline int64_t tiles_of(int64_t n) { return (n + TILE - 1) / TILE; }
inline unsigned blocks_of(int64_t n) {
  return unsigned((n + BLOCK - 1) / BLOCK);
}
inline int64_t align256(int64_t b) { return (b + 255) & ~int64_t(255); }

// Right after a launch: return the error of a refused launch, tagged with
// its site (sorted_runs.h, join_runs.h), from the enclosing function.
#define RW_CHECK(site)                                      \
  do {                                                      \
    const cudaError_t e_ = cudaGetLastError();              \
    if (e_ != cudaSuccess) return (site) * RW_SITE_STRIDE + int(e_); \
  } while (0)

// ---------------------------------------------------------------------------
// typed column access (RwCols columns are int64 / int32 / f64 / bool)
// ---------------------------------------------------------------------------

__device__ __forceinline__ void put_bits(int dt, void* out, int64_t i,
                                         int64_t bits) {
  switch (dt) {
    case RW_I64:
    case RW_F64: static_cast<int64_t*>(out)[i] = bits; break;
    case RW_I32: static_cast<int32_t*>(out)[i] = static_cast<int32_t>(bits);
      break;
    default: static_cast<uint8_t*>(out)[i] = static_cast<uint8_t>(bits);
  }
}

__device__ __forceinline__ void copy_elem(int dt, const void* src,
                                          int64_t si, void* dst, int64_t di) {
  switch (dt) {
    case RW_I64:
    case RW_F64:
      static_cast<int64_t*>(dst)[di] = static_cast<const int64_t*>(src)[si];
      break;
    case RW_I32:
      static_cast<int32_t*>(dst)[di] = static_cast<const int32_t*>(src)[si];
      break;
    default:
      static_cast<uint8_t*>(dst)[di] = static_cast<const uint8_t*>(src)[si];
  }
}

// ---------------------------------------------------------------------------
// binary searches over a sorted int64 run
// ---------------------------------------------------------------------------

// first index whose value is >= key
__device__ __forceinline__ int64_t lower_bound(const int64_t* a, int64_t n,
                                               int64_t key) {
  int64_t lo = 0, hi = n;
  while (lo < hi) {
    const int64_t mid = (lo + hi) >> 1;
    if (a[mid] < key) lo = mid + 1; else hi = mid;
  }
  return lo;
}
// first index whose value is > key
__device__ __forceinline__ int64_t upper_bound(const int64_t* a, int64_t n,
                                               int64_t key) {
  int64_t lo = 0, hi = n;
  while (lo < hi) {
    const int64_t mid = (lo + hi) >> 1;
    if (a[mid] <= key) lo = mid + 1; else hi = mid;
  }
  return lo;
}

// (a1, a2) < (b1, b2), lexicographically
__device__ __forceinline__ bool lt2(int64_t a1, int64_t a2, int64_t b1,
                                    int64_t b2) {
  return a1 < b1 || (a1 == b1 && a2 < b2);
}
// first index whose (k1, k2) pair is >= key
__device__ __forceinline__ int64_t lower_bound2(const int64_t* k1,
                                                const int64_t* k2, int64_t n,
                                                int64_t q1, int64_t q2) {
  int64_t lo = 0, hi = n;
  while (lo < hi) {
    const int64_t mid = (lo + hi) >> 1;
    if (lt2(k1[mid], k2[mid], q1, q2)) lo = mid + 1; else hi = mid;
  }
  return lo;
}
// first index whose (k1, k2) pair is > key
__device__ __forceinline__ int64_t upper_bound2(const int64_t* k1,
                                                const int64_t* k2, int64_t n,
                                                int64_t q1, int64_t q2) {
  int64_t lo = 0, hi = n;
  while (lo < hi) {
    const int64_t mid = (lo + hi) >> 1;
    if (lt2(q1, q2, k1[mid], k2[mid])) hi = mid; else lo = mid + 1;
  }
  return lo;
}

// ---------------------------------------------------------------------------
// two-key runs: pair boundaries for a segment-id scan, and the merge-path
// placement of two (k1, k2)-sorted unique runs
// ---------------------------------------------------------------------------

// Row i of a (k1, k2)-sorted run starts a new pair (the scan's count).
struct Boundary2 {
  const int64_t* k1;
  const int64_t* k2;
  __device__ int operator()(int64_t i) const {
    return (i == 0 || k1[i] != k1[i - 1] || k2[i] != k2[i - 1]) ? 1 : 0;
  }
};
// The scan's exclusive prefix of boundaries is each row's segment id.
struct StoreSeg {
  int32_t* seg;
  __device__ void operator()(int64_t i, int rank, int) const {
    seg[i] = rank;
  }
};

// Both runs sorted on (k1, k2) and unique, so no sort: state row i lands
// at i + #(delta < its key), delta row j at j + #(state <= its key) — a
// stable merge with the state row first on ties. `src` records each
// merged row's origin (< c: state row, else c + delta row).
__global__ void k_place2(const int64_t* s1, const int64_t* s2, int64_t c,
                         const int64_t* d1, const int64_t* d2, int64_t b,
                         int64_t* m1, int64_t* m2, int32_t* src) {
  const int64_t p = int64_t(blockIdx.x) * BLOCK + threadIdx.x;
  if (p >= c + b) return;
  int64_t k1, k2, pos;
  if (p < c) {
    k1 = s1[p];
    k2 = s2[p];
    pos = p + lower_bound2(d1, d2, b, k1, k2);
  } else {
    k1 = d1[p - c];
    k2 = d2[p - c];
    pos = (p - c) + upper_bound2(s1, s2, c, k1, k2);
  }
  m1[pos] = k1;
  m2[pos] = k2;
  src[pos] = int32_t(p);
}

// ---------------------------------------------------------------------------
// three-phase exclusive scan: tile sums, scan of the tile sums, then a
// block scan of each tile plus its offset, handed row by row to `op`.
// T is the count type (int, or int64_t where a total may pass 2^31).
// F(i) -> T count of row i; Op(i, exclusive_prefix, value).
// ---------------------------------------------------------------------------

template <typename T>
__device__ __forceinline__ T block_excl_scan(T v, T* warp_tot, T& total) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  T x = v;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const T y = __shfl_up_sync(FULL, x, o);
    if (lane >= o) x += y;
  }
  if (lane == 31) warp_tot[warp] = x;
  __syncthreads();
  if (warp == 0) {
    T w = lane < WARPS ? warp_tot[lane] : T(0);
#pragma unroll
    for (int o = 1; o < WARPS; o <<= 1) {
      const T y = __shfl_up_sync(FULL, w, o);
      if (lane >= o) w += y;
    }
    if (lane < WARPS) warp_tot[lane] = w;
  }
  __syncthreads();
  const T excl = (warp ? warp_tot[warp - 1] : T(0)) + x - v;
  total = warp_tot[WARPS - 1];
  __syncthreads();
  return excl;
}

template <typename T, class F>
__global__ void k_tile_sums(F f, int64_t n, T* sums) {
  __shared__ T wt[WARPS];
  const int64_t base = int64_t(blockIdx.x) * TILE;
  T s = 0;
#pragma unroll
  for (int r = 0; r < ITEMS; ++r) {
    const int64_t i = base + r * BLOCK + threadIdx.x;
    if (i < n) s += f(i);
  }
  T total;
  block_excl_scan<T>(s, wt, total);
  if (threadIdx.x == 0) sums[blockIdx.x] = total;
}

// One block: exclusive scan of nt tile sums in place; sums[nt] = total.
template <typename T>
__global__ void k_scan_sums(T* sums, int64_t nt, T* total_out) {
  __shared__ T wt[WARPS];
  T carry = 0;
  for (int64_t c = 0; c < nt; c += BLOCK) {
    const int64_t i = c + threadIdx.x;
    const T v = i < nt ? sums[i] : T(0);
    T t;
    const T e = block_excl_scan<T>(v, wt, t);
    if (i < nt) sums[i] = carry + e;
    carry += t;
  }
  if (threadIdx.x == 0) {
    sums[nt] = carry;
    if (total_out) *total_out = carry;
  }
}

template <typename T, class F, class Op>
__global__ void k_tile_apply(F f, Op op, int64_t n, const T* offs) {
  __shared__ T wt[WARPS];
  const int64_t base = int64_t(blockIdx.x) * TILE;
  T carry = offs[blockIdx.x];
  for (int r = 0; r < ITEMS; ++r) {
    const int64_t i = base + r * BLOCK + threadIdx.x;
    const T v = i < n ? f(i) : T(0);
    T t;
    const T e = block_excl_scan<T>(v, wt, t);
    if (i < n) op(i, carry + e, v);
    carry += t;
  }
}

// Scratch of a scan over n rows: nt + 1 tile sums of type T.
template <typename T>
inline int64_t scan_bytes(int64_t n) {
  return align256((tiles_of(n) + 1) * int64_t(sizeof(T)));
}

template <typename T> struct NoDeduce { using type = T; };

// `total` (may be null) receives the scan's total; so does sums[nt].
template <typename T, class F, class Op>
int scan_apply(F f, Op op, int64_t n, T* sums,
               typename NoDeduce<T>::type* total, cudaStream_t s) {
  const int64_t nt = tiles_of(n);
  k_tile_sums<T><<<unsigned(nt), BLOCK, 0, s>>>(f, n, sums);
  RW_CHECK(RW_S_TILE_SUMS);
  k_scan_sums<T><<<1, BLOCK, 0, s>>>(sums, nt, total);
  RW_CHECK(RW_S_SCAN_SUMS);
  k_tile_apply<T><<<unsigned(nt), BLOCK, 0, s>>>(f, op, n, sums);
  RW_CHECK(RW_S_TILE_APPLY);
  return 0;
}

// ---------------------------------------------------------------------------
// decoupled look-back (the one-sweep scans of sorted_runs.cu): tiles take
// their index from an atomic ticket, so a tile's predecessors started
// before it and the wait below cannot deadlock. Each tile publishes its
// count at once (AGG), reads back through its predecessors' words until
// one holds an inclusive prefix (INCL), then publishes its own.
//
// A status word is hi 32 bits = tag << 2 | flag, lo 32 bits = value. The
// words come from torch.empty and are zeroed on the stream once per call
// (tag 0 never matches); a call that runs several passes over the same
// words tags each pass (pass + 1), so a word left by the pass before
// reads as "not yet published". A word carries its own value and nothing
// else is published through it, so GPU-scope relaxed loads and stores
// (never served from L1) are enough, and they let a window of W
// predecessors be read at once: with every tile resident, INCL crosses
// the tiles a window per load latency instead of a tile.
// ---------------------------------------------------------------------------

constexpr unsigned LB_AGG = 1u;
constexpr unsigned LB_INCL = 2u;

__device__ __forceinline__ void st_relaxed_u64(unsigned long long* p,
                                               unsigned long long v) {
  asm volatile("st.relaxed.gpu.global.u64 [%0], %1;" ::"l"(p), "l"(v)
               : "memory");
}

__device__ __forceinline__ unsigned long long ld_relaxed_u64(
    const unsigned long long* p) {
  unsigned long long v;
  asm volatile("ld.relaxed.gpu.global.u64 %0, [%1];" : "=l"(v) : "l"(p)
               : "memory");
  return v;
}

__device__ __forceinline__ unsigned long long lb_word(unsigned tag,
                                                      unsigned flag,
                                                      unsigned value) {
  return (static_cast<unsigned long long>((tag << 2) | flag) << 32) | value;
}

// A tile's own count, published before it looks back (tile 0's is
// already its inclusive prefix). Word of tile j at status[j * stride].
__device__ __forceinline__ void lookback_publish(unsigned long long* status,
                                                 int64_t tile, int64_t stride,
                                                 unsigned tag,
                                                 unsigned count) {
  st_relaxed_u64(status + tile * stride,
                 lb_word(tag, tile == 0 ? LB_INCL : LB_AGG, count));
}

// Exclusive prefix of `count` over the tiles before `tile`, after
// lookback_publish; publishes the tile's inclusive prefix. Spins, with a
// short sleep between reads, on the nearest unread word only; once it
// holds an AGG, reads the W words below it together and adds them nearest
// first, up to an INCL (done) or an unpublished word (spin there).
template <int W>
__device__ __forceinline__ unsigned lookback_wait(unsigned long long* status,
                                                  int64_t tile,
                                                  int64_t stride,
                                                  unsigned tag,
                                                  unsigned count) {
  if (tile == 0) return 0;
  unsigned excl = 0;
  int64_t j = tile - 1;
  for (;;) {
    unsigned long long w0 = ld_relaxed_u64(status + j * stride);
    while (unsigned(w0 >> 34) != tag) {     // not yet published this pass
      __nanosleep(64);
      w0 = ld_relaxed_u64(status + j * stride);
    }
    excl += unsigned(w0);
    if ((w0 >> 32) & LB_INCL) break;
    --j;
    unsigned long long w[W];
#pragma unroll
    for (int k = 0; k < W; ++k)
      w[k] = j - k >= 0 ? ld_relaxed_u64(status + (j - k) * stride) : 0ULL;
    bool done = false;
#pragma unroll
    for (int k = 0; k < W; ++k) {
      const unsigned hi = unsigned(w[k] >> 32);
      if ((hi >> 2) != tag) break;
      excl += unsigned(w[k]);
      --j;
      if (hi & LB_INCL) {
        done = true;
        break;
      }
    }
    if (done) break;
  }
  st_relaxed_u64(status + tile * stride, lb_word(tag, LB_INCL, excl + count));
  return excl;
}

// Thread 0 takes the block's tile index from `counter`; every thread of
// the block calls this and gets it.
__device__ __forceinline__ int64_t take_ticket(unsigned* counter,
                                               int* slot) {
  if (threadIdx.x == 0) *slot = int(atomicAdd(counter, 1u));
  __syncthreads();
  return *slot;
}

// ---------------------------------------------------------------------------
// CRC32 (IEEE, reflected — zlib's) of an int64 key's 8 big-endian bytes:
// the vnode hash (risingwave_tpu/core/vnode.py). The 256-entry table is
// built per block into shared memory (a data-dependent index into
// __constant__ memory would serialise the warp).
// ---------------------------------------------------------------------------

constexpr uint32_t CRC32_POLY = 0xEDB88320u;

__device__ __forceinline__ uint32_t crc32_table_entry(uint32_t i) {
  uint32_t c = i;
#pragma unroll
  for (int k = 0; k < 8; ++k) c = (c >> 1) ^ ((c & 1u) ? CRC32_POLY : 0u);
  return c;
}

// Every thread of the block calls this before the table is read.
__device__ __forceinline__ void crc32_table_fill(uint32_t* table) {
  for (int i = threadIdx.x; i < 256; i += blockDim.x)
    table[i] = crc32_table_entry(uint32_t(i));
  __syncthreads();
}

__device__ __forceinline__ uint32_t crc32_u64(const uint32_t* table,
                                              int64_t key) {
  const uint64_t v = uint64_t(key);
  uint32_t crc = 0xFFFFFFFFu;
#pragma unroll
  for (int b = 0; b < 8; ++b) {
    const uint32_t byte = uint32_t(v >> (8 * (7 - b))) & 0xFFu;
    crc = (crc >> 8) ^ table[(crc ^ byte) & 0xFFu];
  }
  return crc ^ 0xFFFFFFFFu;
}

}  // namespace
