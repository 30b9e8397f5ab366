// Hand-written CUDA kernels (sm_90a) for the four sorted-run cores of
// risingwave_tpu/device/sorted_state.py:
//
//   sort_cols     :189  -> rw_sort_perm       stable LSD radix sort
//   batch_reduce  :108  -> rw_batch_reduce    segment ids + per-segment reduce
//   merge         :227  -> rw_merge_combine   merge-path placement + combine
//   compact_rows  :206  -> rw_compact_rows    three-phase scan + scatter
//
// In the JAX package these are XLA programs built from lax.sort and
// segment ops. Every one of them moves a few words per row and does
// almost no arithmetic, so each is bound by device-memory bytes; the
// design keeps every pass a coalesced streaming pass (striped tiles of
// 256 threads x 8 rows) and does the data-dependent work (digit ranks,
// segment walks, binary searches) in registers and shared memory.
// Simple and correct first: no TMA, no persistent blocks, no
// decoupled look-back — each scan is three plain launches.
#include "rw_common.cuh"

namespace {

constexpr uint64_t SIGN = 0x8000000000000000ULL;

// ---------------------------------------------------------------------------
// typed column access
// ---------------------------------------------------------------------------

template <typename T> struct Lim;
template <> struct Lim<int64_t> {
  __device__ static int64_t hi() { return 0x7fffffffffffffffLL; }
  __device__ static int64_t lo() { return -0x7fffffffffffffffLL - 1; }
};
template <> struct Lim<int32_t> {
  __device__ static int32_t hi() { return 0x7fffffff; }
  __device__ static int32_t lo() { return -0x7fffffff - 1; }
};
template <> struct Lim<double> {
  __device__ static double hi() { return INFINITY; }
  __device__ static double lo() { return -INFINITY; }
};
template <> struct Lim<uint8_t> {
  __device__ static uint8_t hi() { return 1; }
  __device__ static uint8_t lo() { return 0; }
};

// a = earlier row (the state side in a merge), b = later row.
template <typename T>
__device__ __forceinline__ T comb(int kind, T a, T b) {
  if (kind == RW_SUM) return a + b;
  if (kind == RW_REPLACE) return b;
  if (kind == RW_MIN) return b < a ? b : a;
  return b > a ? b : a;
}
template <>
__device__ __forceinline__ double comb<double>(int kind, double a, double b) {
  if (kind == RW_SUM) return a + b;
  if (kind == RW_REPLACE) return b;
  if (a != a || b != b) return a + b;      // min/max propagate NaN
  if (kind == RW_MIN) return b < a ? b : a;
  return b > a ? b : a;
}
template <>
__device__ __forceinline__ uint8_t comb<uint8_t>(int kind, uint8_t a,
                                                 uint8_t b) {
  if (kind == RW_REPLACE) return b;
  if (kind == RW_MIN) return a & b;
  return a | b;                             // bool SUM and MAX
}

// identity of a reduction (not the storage neutral: bool MIN starts true)
template <typename T>
__device__ __forceinline__ T reduce_init(int kind) {
  if (kind == RW_MIN) return Lim<T>::hi();
  if (kind == RW_MAX) return Lim<T>::lo();
  return T(0);
}

// ---------------------------------------------------------------------------
// sort: stable LSD radix sort, 8-bit digits, 8 passes per int64 key
// (sign bit flipped so negative keys order first and EMPTY_KEY last).
// ---------------------------------------------------------------------------

__global__ void k_flip_gather(const int64_t* k, const int32_t* perm,
                              int64_t n, uint64_t* out) {
  const int64_t i = int64_t(blockIdx.x) * BLOCK + threadIdx.x;
  if (i >= n) return;
  const int64_t src = perm ? perm[i] : i;
  out[i] = static_cast<uint64_t>(k[src]) ^ SIGN;
}

__global__ void k_radix_hist(const uint64_t* keys, int64_t n, int shift,
                             int* counts, int64_t nt) {
  __shared__ int h[BLOCK];
  h[threadIdx.x] = 0;
  __syncthreads();
  const int64_t base = int64_t(blockIdx.x) * TILE;
#pragma unroll
  for (int r = 0; r < ITEMS; ++r) {
    const int64_t i = base + r * BLOCK + threadIdx.x;
    if (i < n) atomicAdd(&h[(keys[i] >> shift) & 255], 1);
  }
  __syncthreads();
  counts[int64_t(threadIdx.x) * nt + blockIdx.x] = h[threadIdx.x];
}

// Stable scatter of one tile: rows keep their input order within each
// digit. Per round of 256 rows, __match_any_sync ranks equal digits
// inside a warp; per-digit warp counts, prefix-summed over the block's
// warps in shared memory, order the warps; `run` carries the digit
// counts of earlier rounds of the tile.
__global__ void k_radix_scatter(const uint64_t* kin, const int32_t* pin,
                                int64_t n, int shift, const int* offs,
                                int64_t nt, uint64_t* kout, int32_t* pout) {
  __shared__ int base[BLOCK];
  __shared__ int run[BLOCK];
  __shared__ int rtot[BLOCK];
  __shared__ int wcnt[WARPS][BLOCK];
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  const unsigned lt = (1u << lane) - 1u;
  base[t] = offs[int64_t(t) * nt + blockIdx.x];
  run[t] = 0;
  const int64_t b0 = int64_t(blockIdx.x) * TILE;
  for (int r = 0; r < ITEMS; ++r) {
#pragma unroll
    for (int w = 0; w < WARPS; ++w) wcnt[w][t] = 0;
    __syncthreads();
    const int64_t i = b0 + int64_t(r) * BLOCK + t;
    const bool valid = i < n;
    const uint64_t k = valid ? kin[i] : 0;
    const int d = valid ? int((k >> shift) & 255) : BLOCK;
    const unsigned peers = __match_any_sync(FULL, d);
    const int wrank = __popc(peers & lt);
    if (valid && wrank == 0) wcnt[warp][d] = __popc(peers);
    __syncthreads();
    int acc = 0;
#pragma unroll
    for (int w = 0; w < WARPS; ++w) {
      const int c = wcnt[w][t];
      wcnt[w][t] = acc;
      acc += c;
    }
    rtot[t] = acc;
    __syncthreads();
    if (valid) {
      const int pos = base[d] + run[d] + wcnt[warp][d] + wrank;
      kout[pos] = k;
      pout[pos] = pin ? pin[i] : int32_t(i);
    }
    __syncthreads();
    run[t] += rtot[t];
  }
}

__global__ void k_sort_out(const uint64_t* uk, const int32_t* p, int64_t n,
                           int64_t* perm, int64_t* sorted_k1) {
  const int64_t i = int64_t(blockIdx.x) * BLOCK + threadIdx.x;
  if (i >= n) return;
  perm[i] = p[i];
  if (sorted_k1) sorted_k1[i] = static_cast<int64_t>(uk[i] ^ SIGN);
}

struct CountAt {
  const int* c;
  __device__ int operator()(int64_t i) const { return c[i]; }
};
struct StoreAt {
  int* c;
  __device__ void operator()(int64_t i, int rank, int) const { c[i] = rank; }
};

struct SortScratch {
  uint64_t* ka;
  uint64_t* kb;
  int32_t* pa;
  int32_t* pb;
  int* counts;
  int* sums;
};

SortScratch sort_layout(void* scratch, int64_t n) {
  char* p = static_cast<char*>(scratch);
  SortScratch s;
  const int64_t nc = BLOCK * tiles_of(n);
  s.ka = reinterpret_cast<uint64_t*>(p); p += align256(n * 8);
  s.kb = reinterpret_cast<uint64_t*>(p); p += align256(n * 8);
  s.pa = reinterpret_cast<int32_t*>(p); p += align256(n * 4);
  s.pb = reinterpret_cast<int32_t*>(p); p += align256(n * 4);
  s.counts = reinterpret_cast<int*>(p); p += align256(nc * 4);
  s.sums = reinterpret_cast<int*>(p);
  return s;
}

// ---------------------------------------------------------------------------
// batch_reduce: segment ids by a scan of key boundaries, then one thread
// per segment start walks its segment in sorted (= arrival) order.
// ---------------------------------------------------------------------------

struct Boundary {
  const int64_t* sk;
  __device__ int operator()(int64_t i) const {
    return (i == 0 || sk[i] != sk[i - 1]) ? 1 : 0;
  }
};

template <typename T>
__device__ void seg_reduce(int kind, const void* col, const int64_t* perm,
                           int64_t s, int64_t e, void* out, int64_t o) {
  const T* v = static_cast<const T*>(col);
  T acc;
  if (kind == RW_REPLACE) {
    acc = v[perm[e - 1]];                 // last arrival wins
  } else {
    acc = reduce_init<T>(kind);
    for (int64_t j = s; j < e; ++j) acc = comb<T>(kind, acc, v[perm[j]]);
  }
  static_cast<T*>(out)[o] = acc;
}

__global__ void k_segments(const int64_t* sk, const int64_t* perm, int64_t n,
                           const int32_t* seg, const int* nseg, RwCols cols,
                           int64_t* ukeys, int32_t* ucount) {
  const int64_t i = int64_t(blockIdx.x) * BLOCK + threadIdx.x;
  if (i >= n) return;
  // live segments: every boundary except a trailing EMPTY_KEY run
  const int64_t live = *nseg - (sk[n - 1] == EMPTY_KEY ? 1 : 0);
  if (i == 0) *ucount = int32_t(live);
  if (i >= live) {
    ukeys[i] = EMPTY_KEY;
    for (int c = 0; c < cols.n; ++c)
      put_bits(cols.dtype[c], cols.out[c], i, cols.fill[c]);
  }
  const int64_t k = sk[i];
  if (k == EMPTY_KEY || (i > 0 && sk[i - 1] == k)) return;
  int64_t e = i + 1;
  while (e < n && sk[e] == k) ++e;
  const int64_t s = seg[i];
  ukeys[s] = k;
  for (int c = 0; c < cols.n; ++c) {
    switch (cols.dtype[c]) {
      case RW_I64:
        seg_reduce<int64_t>(cols.kind[c], cols.a[c], perm, i, e, cols.out[c], s);
        break;
      case RW_I32:
        seg_reduce<int32_t>(cols.kind[c], cols.a[c], perm, i, e, cols.out[c], s);
        break;
      case RW_F64:
        seg_reduce<double>(cols.kind[c], cols.a[c], perm, i, e, cols.out[c], s);
        break;
      default:
        seg_reduce<uint8_t>(cols.kind[c], cols.a[c], perm, i, e, cols.out[c], s);
    }
  }
}

// ---------------------------------------------------------------------------
// merge: both sides sorted, so no sort — state row i lands at
// i + #(delta < key), delta row j at j + #(state <= key): a stable merge
// with the state row first on ties. Runs of <= 2 then combine positionally.
// ---------------------------------------------------------------------------

__global__ void k_merge_place(const int64_t* s, int64_t c, const int64_t* d,
                              int64_t b, int64_t* mk, int32_t* src) {
  const int64_t p = int64_t(blockIdx.x) * BLOCK + threadIdx.x;
  if (p >= c + b) return;
  int64_t key, pos;
  if (p < c) {
    key = s[p];
    pos = p + lower_bound(d, b, key);
  } else {
    key = d[p - c];
    pos = (p - c) + upper_bound(s, c, key);
  }
  mk[pos] = key;
  src[pos] = int32_t(p);
}

template <typename T>
__device__ __forceinline__ T side_val(const void* a, const void* b, int64_t c,
                                      int32_t r) {
  return r < c ? static_cast<const T*>(a)[r]
               : static_cast<const T*>(b)[r - c];
}

template <typename T>
__device__ __forceinline__ bool merge_col(int kind, const void* a,
                                          const void* b, int64_t c, int32_t r0,
                                          int32_t r1, void* out, int64_t p) {
  T v = side_val<T>(a, b, c, r0);
  if (r1 >= 0) v = comb<T>(kind, v, side_val<T>(a, b, c, r1));
  static_cast<T*>(out)[p] = v;
  return v != T(0);
}

__global__ void k_merge_combine(const int64_t* mk, const int32_t* src,
                                int64_t c, int64_t n, RwCols cols,
                                int drop_dead, int dead_col, uint8_t* alive) {
  const int64_t p = int64_t(blockIdx.x) * BLOCK + threadIdx.x;
  if (p >= n) return;
  const int64_t key = mk[p];
  const bool same_next = p + 1 < n && mk[p + 1] == key;
  const bool same_prev = p > 0 && mk[p - 1] == key;
  const int32_t r0 = src[p];
  const int32_t r1 = same_next ? src[p + 1] : -1;
  bool dead_nz = true;
  for (int j = 0; j < cols.n; ++j) {
    bool nz;
    switch (cols.dtype[j]) {
      case RW_I64:
        nz = merge_col<int64_t>(cols.kind[j], cols.a[j], cols.b[j], c, r0, r1,
                                cols.out[j], p);
        break;
      case RW_I32:
        nz = merge_col<int32_t>(cols.kind[j], cols.a[j], cols.b[j], c, r0, r1,
                                cols.out[j], p);
        break;
      case RW_F64:
        nz = merge_col<double>(cols.kind[j], cols.a[j], cols.b[j], c, r0, r1,
                               cols.out[j], p);
        break;
      default:
        nz = merge_col<uint8_t>(cols.kind[j], cols.a[j], cols.b[j], c, r0, r1,
                                cols.out[j], p);
    }
    if (j == dead_col) dead_nz = nz;
  }
  alive[p] = !same_prev && key != EMPTY_KEY && (!drop_dead || dead_nz);
}

// ---------------------------------------------------------------------------
// compact_rows: exclusive scan of the alive flags gives each alive row
// its output slot; rows past out_len are dropped; slots past the alive
// total get the fills.
// ---------------------------------------------------------------------------

struct AliveAt {
  const uint8_t* a;
  __device__ int operator()(int64_t i) const { return a[i] != 0; }
};
struct ScatterAlive {
  RwCols cols;
  int64_t out_len;
  __device__ void operator()(int64_t i, int rank, int v) const {
    if (!v || rank >= out_len) return;
    for (int j = 0; j < cols.n; ++j)
      copy_elem(cols.dtype[j], cols.a[j], i, cols.out[j], rank);
  }
};

__global__ void k_compact_fill(RwCols cols, int64_t len, const int* total) {
  const int64_t i = int64_t(blockIdx.x) * BLOCK + threadIdx.x;
  if (i >= len || i < *total) return;
  for (int j = 0; j < cols.n; ++j)
    put_bits(cols.dtype[j], cols.out[j], i, cols.fill[j]);
}

}  // namespace

extern "C" {

int64_t rw_scan_scratch_bytes(int64_t n) { return scan_bytes<int>(n); }

int64_t rw_sort_scratch_bytes(int64_t n) {
  return 2 * align256(n * 8) + 2 * align256(n * 4) +
         align256(BLOCK * tiles_of(n) * 4) + scan_bytes<int>(BLOCK * tiles_of(n));
}

int rw_sort_perm(const int64_t* k1, const int64_t* k2, int64_t n,
                 int64_t* perm, int64_t* sorted_k1, void* scratch,
                 void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (n <= 0) return 0;
  SortScratch s = sort_layout(scratch, n);
  const int64_t nt = tiles_of(n);
  const int64_t nc = BLOCK * nt;
  const int64_t* keys[2] = {k2 ? k2 : k1, k1};
  const int nkeys = k2 ? 2 : 1;
  const int32_t* pin = nullptr;             // identity before the first pass
  for (int kc = 0; kc < nkeys; ++kc) {      // least significant key first
    k_flip_gather<<<blocks_of(n), BLOCK, 0, st>>>(keys[kc], pin, n, s.ka);
    RW_CHECK(RW_S_FLIP_GATHER);
    for (int pass = 0; pass < 8; ++pass) {
      const int shift = 8 * pass;
      k_radix_hist<<<unsigned(nt), BLOCK, 0, st>>>(s.ka, n, shift, s.counts, nt);
      RW_CHECK(RW_S_RADIX_HIST);
      if (int rc = scan_apply(CountAt{s.counts}, StoreAt{s.counts}, nc,
                              s.sums, nullptr, st))
        return rc;
      k_radix_scatter<<<unsigned(nt), BLOCK, 0, st>>>(s.ka, pin, n, shift, s.counts,
                                            nt, s.kb, s.pb);
      RW_CHECK(RW_S_RADIX_SCATTER);
      uint64_t* tk = s.ka; s.ka = s.kb; s.kb = tk;
      int32_t* tp = s.pa; s.pa = s.pb; s.pb = tp;
      pin = s.pa;
    }
  }
  k_sort_out<<<blocks_of(n), BLOCK, 0, st>>>(s.ka, s.pa, n, perm, sorted_k1);
  RW_CHECK(RW_S_SORT_OUT);
  return 0;
}

int rw_batch_reduce(const int64_t* sk, const int64_t* perm, int64_t n,
                    RwCols cols, int64_t* ukeys, int32_t* ucount,
                    void* scratch, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (n <= 0) return 0;
  char* p = static_cast<char*>(scratch);
  int32_t* seg = reinterpret_cast<int32_t*>(p);
  int* sums = reinterpret_cast<int*>(p + align256(n * 4));
  if (int rc = scan_apply(Boundary{sk}, StoreSeg{seg}, n, sums, nullptr, st))
    return rc;
  k_segments<<<blocks_of(n), BLOCK, 0, st>>>(sk, perm, n, seg,
                                             sums + tiles_of(n), cols, ukeys,
                                             ucount);
  RW_CHECK(RW_S_SEGMENTS);
  return 0;
}

int rw_merge_combine(const int64_t* s, int64_t c, const int64_t* d,
                     int64_t b, RwCols cols, int drop_dead, int dead_col,
                     int64_t* mk, uint8_t* alive, int32_t* src,
                     void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int64_t n = c + b;
  if (n <= 0) return 0;
  k_merge_place<<<blocks_of(n), BLOCK, 0, st>>>(s, c, d, b, mk, src);
  RW_CHECK(RW_S_MERGE_PLACE);
  k_merge_combine<<<blocks_of(n), BLOCK, 0, st>>>(mk, src, c, n, cols,
                                                  drop_dead, dead_col, alive);
  RW_CHECK(RW_S_MERGE_COMBINE);
  return 0;
}

int rw_compact_rows(const uint8_t* alive, int64_t n, RwCols cols,
                    int64_t out_len, int32_t* total, void* scratch,
                    void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (n <= 0) return 0;
  const int64_t len = out_len < n ? out_len : n;
  int* sums = static_cast<int*>(scratch);
  if (int rc = scan_apply(AliveAt{alive}, ScatterAlive{cols, len}, n, sums,
                          total, st))
    return rc;
  if (len > 0) {
    k_compact_fill<<<blocks_of(len), BLOCK, 0, st>>>(cols, len,
                                                     sums + tiles_of(n));
    RW_CHECK(RW_S_COMPACT_FILL);
  }
  return 0;
}

}  // extern "C"
