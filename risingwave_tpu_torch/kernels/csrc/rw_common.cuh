// Device helpers shared by the kernel sources (sorted_runs.cu,
// join_runs.cu, multiset_runs.cu, window_runs.cu, skew_runs.cu,
// tier_runs.cu): tile
// geometry, launch checks, typed column access, one- and two-key binary
// searches, the three-phase block scan, the
// decoupled look-back of the one-sweep scans (32- and 64-bit), the
// compaction tiles' ranks and scratch, a warp-wide search and the
// merge-path co-rank.
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

__host__ __device__ inline int64_t tiles_of(int64_t n) {
  return (n + TILE - 1) / TILE;
}
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
// one-sweep compaction tiles (merge, compact_rows, merge_side): a tile of
// TILE rows, row r x BLOCK + t of it held by thread t as its item r, so
// stripe r of warp w is rows r x BLOCK + w x 32 .. and (stripe, warp) is
// row order. A ballot per stripe counts each warp's survivors.
// ---------------------------------------------------------------------------

static_assert(ITEMS * WARPS == 64, "tile_offsets scans 64 counts in warp 0");

// lookback_wait for a whole warp, the words at status[0 ..] (stride 1):
// lane k reads the word k tiles nearer than the window's far end, so a
// window of 32 costs each lane one register pair, not 32 (the tile
// kernels hold their rows' state in registers across the wait). The
// window is summed up to its first INCL (done) or first unpublished word
// (spin there). Every lane gets the exclusive prefix; lane 0 publishes
// the inclusive one.
__device__ __forceinline__ unsigned lookback_warp(unsigned long long* status,
                                                  int64_t tile, unsigned tag,
                                                  unsigned count) {
  const int lane = threadIdx.x & 31;
  unsigned excl = 0;
  for (int64_t j = tile - 1; j >= 0;) {      // j: the nearest unread word
    const unsigned long long w = j - lane >= 0
        ? ld_relaxed_u64(status + (j - lane))
        : lb_word(tag, LB_INCL, 0u);         // before tile 0: nothing
    const unsigned hi = unsigned(w >> 32);
    const bool pub = (hi >> 2) == tag;
    const unsigned unpub = __ballot_sync(FULL, !pub);
    const unsigned incl = __ballot_sync(FULL, pub && (hi & LB_INCL));
    const int stop = unpub ? __ffs(unpub) - 1 : 32;
    const int done = incl ? __ffs(incl) - 1 : 32;
    if (done < stop) {
      excl += __reduce_add_sync(FULL, lane <= done ? unsigned(w) : 0u);
      break;
    }
    excl += __reduce_add_sync(FULL, lane < stop ? unsigned(w) : 0u);
    j -= stop;
    if (stop < 32) __nanosleep(64);
  }
  if (lane == 0)
    st_relaxed_u64(status + tile, lb_word(tag, LB_INCL, excl + count));
  return excl;
}

// The 64-bit form, for counts that may pass 2^32 (probe's pairs): a word
// is flag << 62 | value, the value below 2^62 (q x C < 2^62 for
// q, C < 2^31). One pass per call over words zeroed on the stream, so no
// tag: flag 0 reads as unpublished.
constexpr int LB64_SHIFT = 62;
constexpr unsigned long long LB64_VALUE = (1ULL << LB64_SHIFT) - 1;

__device__ __forceinline__ unsigned long long lb64_word(unsigned flag,
                                                        int64_t value) {
  return (static_cast<unsigned long long>(flag) << LB64_SHIFT) |
         static_cast<unsigned long long>(value);
}

__device__ __forceinline__ int64_t warp_sum64(int64_t v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(FULL, v, o);
  return v;
}

// lookback_warp over 64-bit words, V words a lane (a window of 32 x V
// tiles a round trip: with hundreds of tiles resident at once, the
// inclusive prefix crosses them in few rounds): lane 0 has published the
// tile's `count` (lb64_word(tile == 0 ? LB_INCL : LB_AGG, count)) before
// the call; every lane gets the exclusive prefix, and lane 0 publishes
// the inclusive one.
template <int V>
__device__ __forceinline__ int64_t lookback_warp64(unsigned long long* status,
                                                   int64_t tile,
                                                   int64_t count) {
  const int lane = threadIdx.x & 31;
  int64_t excl = 0;
  for (int64_t j = tile - 1; j >= 0;) {
    // lane l holds words j - V l - k, k = 0 .. V - 1: nearest first
    int64_t v[V];
    unsigned fl[V];
#pragma unroll
    for (int k = 0; k < V; ++k) {
      const int64_t i = j - V * lane - k;
      const unsigned long long w = i >= 0 ? ld_relaxed_u64(status + i)
                                          : lb64_word(LB_INCL, 0);
      fl[k] = unsigned(w >> LB64_SHIFT);
      v[k] = int64_t(w & LB64_VALUE);
    }
    int ev = V;                      // the lane's first unpublished or INCL
#pragma unroll
    for (int k = V - 1; k >= 0; --k)
      if (fl[k] == 0 || (fl[k] & LB_INCL)) ev = k;
    const bool incl = ev < V && (fl[ev < V ? ev : 0] & LB_INCL);
    const unsigned evb = __ballot_sync(FULL, ev < V);
    const int fe = evb ? __ffs(evb) - 1 : 32;
    int64_t mine = 0;
#pragma unroll
    for (int k = 0; k < V; ++k)
      if (lane < fe || (lane == fe && (k < ev || (k == ev && incl))))
        mine += v[k];
    excl += warp_sum64(mine);
    if (fe == 32) {
      j -= 32 * V;
      continue;
    }
    if (__shfl_sync(FULL, int(incl), fe)) break;
    j -= V * fe + __shfl_sync(FULL, ev, fe);   // spin on that word
    __nanosleep(64);
  }
  if (lane == 0)
    st_relaxed_u64(status + tile, lb64_word(LB_INCL, excl + count));
  return excl;
}

// ---------------------------------------------------------------------------
// a search by a whole warp: the first i in [lo, hi) with pred(i) true,
// else hi (pred false, then true, along the range). Each round the 32
// lanes test the starts of 32 equal chunks and the ballot keeps one
// chunk, so a range of 2^20 takes 4 rounds of dependent loads, not 20.
// Every lane calls it and gets the result.
// ---------------------------------------------------------------------------

template <class Pred>
__device__ __forceinline__ int64_t warp_first_true(int64_t lo, int64_t hi,
                                                   Pred pred) {
  const int lane = threadIdx.x & 31;
  while (hi - lo > 32) {
    const int64_t step = (hi - lo + 31) / 32;
    const int64_t x = lo + lane * step;
    const unsigned b = __ballot_sync(FULL, x >= hi || pred(x));
    if (b == 0) {                          // past the last chunk's start
      lo += 31 * step + 1;
      continue;
    }
    const int k = __ffs(b) - 1;
    if (k == 0) return lo;                 // pred(lo)
    const int64_t xk = lo + k * step;      // >= hi, or pred(xk)
    lo += (k - 1) * step + 1;
    hi = xk < hi ? xk : hi;
  }
  const int64_t x = lo + lane;
  const unsigned b = __ballot_sync(FULL, x < hi && pred(x));
  return b ? lo + __ffs(b) - 1 : hi;
}

// Warp 0, every lane: cnt[r * WARPS + w] holds the survivors of stripe r
// of warp w; each becomes its exclusive offset in the tile. Publishes the
// tile's survivors (`total`) and returns those of the tiles before it, by
// decoupled look-back (tag 1), to every lane.
__device__ __forceinline__ unsigned tile_offsets(int* cnt, int64_t tile,
                                                 unsigned long long* status,
                                                 int& total) {
  const int lane = threadIdx.x & 31;
  const int v0 = cnt[2 * lane], v1 = cnt[2 * lane + 1];
  int x = v0 + v1;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int y = __shfl_up_sync(FULL, x, o);
    if (lane >= o) x += y;
  }
  const int excl = x - v0 - v1;
  cnt[2 * lane] = excl;
  cnt[2 * lane + 1] = excl + v0;
  total = __shfl_sync(FULL, x, 31);
  if (lane == 0) lookback_publish(status, tile, 1, 1u, unsigned(total));
  return lookback_warp(status, tile, 1u, unsigned(total));
}

// Scratch of a one-sweep pass over n rows: the ticket and the tiles'
// look-back words (zeroed on the stream once per call), then the
// merge-path cuts (tiles + 1 of them) where the pass merges two runs.
struct SweepScratch {
  unsigned* ticket;
  unsigned long long* status;     // [tiles]
  int64_t zero_bytes;
  int64_t* cuts;                  // [tiles + 1]
  int64_t bytes;
};

inline SweepScratch sweep_layout(void* scratch, int64_t n) {
  char* p = static_cast<char*>(scratch);
  const int64_t nt = tiles_of(n);
  SweepScratch s;
  s.ticket = reinterpret_cast<unsigned*>(p);
  s.status = reinterpret_cast<unsigned long long*>(p + 256);
  s.zero_bytes = 256 + align256(nt * 8);
  s.cuts = reinterpret_cast<int64_t*>(p + s.zero_bytes);
  s.bytes = s.zero_bytes + align256((nt + 1) * 8);
  return s;
}

// ---------------------------------------------------------------------------
// merge path: the rows of run a among the first p rows of the stable
// merge of sorted runs a (na rows) and b (nb rows), a row of a first on a
// tie. `b_lt_a(k, i)` is b[k] < a[i].
// ---------------------------------------------------------------------------

template <class BLtA>
__device__ __forceinline__ int64_t co_rank_by(int64_t na, int64_t nb,
                                              int64_t p, BLtA b_lt_a) {
  int64_t lo = p > nb ? p - nb : 0, hi = p < na ? p : na;
  while (lo < hi) {
    const int64_t mid = (lo + hi) >> 1;
    if (b_lt_a(p - 1 - mid, mid)) hi = mid; else lo = mid + 1;
  }
  return lo;
}

// runs sorted on one key
__device__ __forceinline__ int64_t co_rank(const int64_t* a, int64_t na,
                                           const int64_t* b, int64_t nb,
                                           int64_t p) {
  return co_rank_by(na, nb, p,
                    [=](int64_t k, int64_t i) { return b[k] < a[i]; });
}

// runs sorted on (k1, k2)
__device__ __forceinline__ int64_t co_rank(const int64_t* a1,
                                           const int64_t* a2, int64_t na,
                                           const int64_t* b1,
                                           const int64_t* b2, int64_t nb,
                                           int64_t p) {
  return co_rank_by(na, nb, p, [=](int64_t k, int64_t i) {
    return lt2(b1[k], b2[k], a1[i], a2[i]);
  });
}

}  // namespace
