// The tiled segmented reduce of rows already sorted by their key, shared by
// batch_reduce (sorted_runs.cu: one key) and batch_reduce_rows
// (join_runs.cu: two keys, the second read through the permutation), and
// the typed combine it and merge use.
//
// Replaces one thread per segment walking its whole segment (on q7's
// pre-combine 11 threads walked ~95K rows each while the card idled) and,
// for batch_reduce_rows, a gather of the second key, a three-launch
// boundary scan, that walk and a gather of every column: six launches
// after the sort. Bound: the sorted keys and the perm are read once (the
// second key gathered once), each column gathered once by the perm and
// written once per segment: bytes, at 3.35 TB/s; a gather through the
// permutation fetches a 32-byte sector for each value unless its column
// stays in L2. The design:
//   1. k_reduce_tiles: a tile of 256 threads x 8 consecutive rows takes
//      its index from a ticket. Head flags come from key boundaries (a
//      thread's neighbours' first and last keys by shared memory); the
//      block scans the head counts and gets the tile's first segment id by
//      decoupled look-back (the boundary scan fused into the pass). Each
//      thread reduces the runs inside its rows in row order; a block-wide
//      segmented scan over the threads' open runs (a fixed tree in each
//      warp, then the warps in order) joins the runs that cross threads.
//      The tile's segments' keys and values go out through shared memory,
//      so consecutive threads store consecutive slots.
//   2. A segment crossing a tile edge leaves partials in scratch: the
//      tile's first segment (from its first row) and, in the tile where the
//      segment starts (its owner), the last segment. k_reduce_carry: each
//      owner's block combines its partial with the next tiles' first
//      partials in tile order (in-order trees of 256 tiles), and every
//      thread fills the slots past the live segments.
//   3. REPLACE takes no scan and no carry: the stable sort puts a
//      segment's last arrival last, so the thread holding a segment's last
//      row writes that row's value to the segment's slot. With two keys
//      (batch_reduce_rows: every payload column is REPLACE) it stages that
//      row's index instead, and k_reduce_gather gathers the columns one
//      after another (blocks in column-major order), so the column being
//      gathered stays in L2 and its sectors leave device memory about
//      once, where gathering them together per tile fetched a sector for
//      every value.
//   4. Float SUM combines in an order fixed by n and the tile size, so it
//      is deterministic from run to run (not the sequential order of a
//      walk; the reference's own, XLA's segment_sum, is unspecified).
//      MIN/MAX propagate NaN (comb), integer and bool columns are exact.
//   5. The live segments are those whose first key is not EMPTY_KEY; the
//      EMPTY rows sort last, so they end at the first EMPTY row's segment,
//      which the tile kernel records. Slots from there on take the fill:
//      the column's `fill` bits or, with two keys (batch_reduce_rows'
//      padding, the reference's `v[clip(last, 0)]`), a REPLACE column's
//      value at sorted row 0. With two keys every segment writes both keys
//      at its slot (an EMPTY first key beside a live second one included,
//      as the reference's scatter does).
// Every gather of a thread's rows is issued before any of its stores: a
// store may alias another column, so interleaved each load would wait for
// the store before it. The look-back words are zeroed on the stream once
// per call.
#pragma once

#include <climits>

#include "rw_common.cuh"

namespace {

// ---------------------------------------------------------------------------
// typed combine
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
__device__ __forceinline__ int32_t comb<int32_t>(int kind, int32_t a,
                                                 int32_t b) {
  // an int32 SUM wraps, as the reference's int32 segment_sum
  if (kind == RW_SUM) return int32_t(uint32_t(a) + uint32_t(b));
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
// the tiled segmented reduce
// ---------------------------------------------------------------------------

constexpr int RT_HEAD = 1;        // the tile holds a segment head
constexpr int RT_FIRST = 2;       // its first row continues the tile before's
constexpr int RT_OWNER = 4;       // its last segment starts in it and runs on

struct RedScratch {
  char* zero;                     // ticket, live_end and status, zeroed per call
  int64_t zero_bytes;
  unsigned* ticket;
  int* live_end;                  // 1 + id of the first EMPTY-key segment, or 0
  unsigned long long* status;     // [tiles] head counts, by look-back
  int* nseg;                      // segments in all
  int* flags;                     // [tiles] RT_*
  int* last_seg;                  // [tiles] id of the tile's last segment
  int64_t* pfirst;                // [tiles][RW_MAX_COLS] first segment's partial
  int64_t* plast;                 // [tiles][RW_MAX_COLS] an owner's last one
  int32_t* usrc;                  // [n] (two keys) a segment's last row
  int64_t bytes;
};

RedScratch reduce_layout(void* scratch, int64_t n, bool two) {
  const uintptr_t base = reinterpret_cast<uintptr_t>(scratch);
  const int64_t nt = tiles_of(n);
  int64_t off = 0;
  auto take = [&](int64_t bytes) {
    const int64_t o = off;
    off += align256(bytes);
    return reinterpret_cast<char*>(base + uintptr_t(o));
  };
  RedScratch s;
  s.zero = take(0);
  s.ticket = reinterpret_cast<unsigned*>(take(4));
  s.live_end = reinterpret_cast<int*>(take(4));
  s.status = reinterpret_cast<unsigned long long*>(take(nt * 8));
  s.zero_bytes = off;
  s.nseg = reinterpret_cast<int*>(take(4));
  s.flags = reinterpret_cast<int*>(take(nt * 4));
  s.last_seg = reinterpret_cast<int*>(take(nt * 4));
  s.pfirst = reinterpret_cast<int64_t*>(take(nt * RW_MAX_COLS * 8));
  s.plast = reinterpret_cast<int64_t*>(take(nt * RW_MAX_COLS * 8));
  s.usrc = reinterpret_cast<int32_t*>(take(two ? n * 4 : 0));
  s.bytes = off;
  return s;
}

template <typename T>
__device__ __forceinline__ int64_t to_bits(T v) { return int64_t(v); }
template <>
__device__ __forceinline__ int64_t to_bits<double>(double v) {
  return __double_as_longlong(v);
}
template <typename T>
__device__ __forceinline__ T from_bits(int64_t b) { return T(b); }
template <>
__device__ __forceinline__ double from_bits<double>(int64_t b) {
  return __longlong_as_double(b);
}

template <typename T>
__device__ __forceinline__ T shfl_up_t(T v, int o) {
  return __shfl_up_sync(FULL, v, o);
}
template <>
__device__ __forceinline__ uint8_t shfl_up_t<uint8_t>(uint8_t v, int o) {
  return uint8_t(__shfl_up_sync(FULL, int(v), o));
}
template <typename T>
__device__ __forceinline__ T shfl_down_t(T v, int o) {
  return __shfl_down_sync(FULL, v, o);
}
template <>
__device__ __forceinline__ uint8_t shfl_down_t<uint8_t>(uint8_t v, int o) {
  return uint8_t(__shfl_down_sync(FULL, int(v), o));
}

// Exclusive segmented scan over the block's threads in thread order. A
// thread's element is (f: it holds a head, x: its open run — from its last
// head, or all its rows). Returns the partial of the segment open at the
// thread's first row, counted from its head or from the tile's first row,
// and sets `cf` when that head lies in the tile. Every thread calls it.
template <typename T>
__device__ T seg_scan_excl(int kind, bool f, T x, bool& cf, T* sv, int* sf) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  T v = x;
  bool fl = f;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const T yv = shfl_up_t<T>(v, o);
    const bool yf = __shfl_up_sync(FULL, int(fl), o) != 0;
    if (lane >= o) {
      if (!fl) v = comb<T>(kind, yv, v);
      fl = fl || yf;
    }
  }
  if (lane == 31) {
    sv[warp] = v;
    sf[warp] = fl;
  }
  __syncthreads();
  T wc = reduce_init<T>(kind);
  bool wf = false;
  for (int w = 0; w < warp; ++w) {
    wc = sf[w] ? sv[w] : comb<T>(kind, wc, sv[w]);
    wf = wf || sf[w];
  }
  const T ev = shfl_up_t<T>(v, 1);
  const bool ef = __shfl_up_sync(FULL, int(fl), 1) != 0;
  __syncthreads();                            // sv, sf free for the next call
  if (lane == 0) {
    cf = wf;
    return wc;
  }
  cf = ef || wf;
  return ef ? ev : comb<T>(kind, wc, ev);
}

// What a thread of k_reduce_tiles knows of its rows and its tile.
struct TileCtx {
  int64_t tile;
  int nrow;                       // rows it holds (0..ITEMS)
  unsigned heads;                 // bit j: its row j starts a segment
  int id0;                        // id of the segment open at its first row
  int last_id;                    // id of the tile's last segment
  bool ends;                      // its last row ends its segment
  bool tail;                      // it holds the tile's last row
  bool tail_ends;                 // that row ends its segment
  bool tail_empty;                // ... whose first key is EMPTY_KEY
  int gbase;                      // id of the tile's first head
  int tot;                        // heads in the tile
  int64_t* stage;                 // shared memory: [TILE] staged outputs
};

// out[first + q] = stage[q] for q in [q0, q1), consecutive threads to
// consecutive slots (the threads' own stores would land 8 slots apart).
// Every thread calls it.
template <typename T>
__device__ __forceinline__ void stage_out(const int64_t* stage, T* out,
                                          int64_t first, int q0, int q1) {
  __syncthreads();
  const T* st = reinterpret_cast<const T*>(stage);
  for (int q = q0 + threadIdx.x; q < q1; q += BLOCK) out[first + q] = st[q];
  __syncthreads();                        // the stage is free again
}

// A column's slots of the segments whose heads lie in the tile,
// [gbase, gbase + tot): a slot the tile did not stage (its last segment
// running on, an EMPTY segment) gets whatever the stage holds, and
// k_reduce_carry, launched after, writes it.
template <typename T>
__device__ __forceinline__ void stage_heads(const TileCtx& x, T* out) {
  stage_out<T>(x.stage, out, x.gbase, 0, x.tot);
}

// A SUM / MIN / MAX column of the thread's rows, their values vj already
// gathered (rows past nrow unread).
template <typename T>
__device__ __forceinline__ void reduce_vals(int kind, const T* vj,
                                            void* outp, int c,
                                            const TileCtx& x,
                                            const RedScratch& s,
                                            int64_t* sval, int* sflag) {
  // a segment written here started in the tile: its slot is staged
  T* st = reinterpret_cast<T*>(x.stage);
  int id = x.id0;
  const T init = reduce_init<T>(kind);
  T acc = init, pre = init;
  bool seen = false;
#pragma unroll
  for (int j = 0; j < ITEMS; ++j) {
    if (j < x.nrow) {
      if ((x.heads >> j) & 1u) {
        if (seen) st[id - x.gbase] = acc;  // a segment inside the thread
        else pre = acc;                   // the rows before the first head
        seen = true;
        ++id;
        acc = init;
      }
      acc = comb<T>(kind, acc, vj[j]);
    }
  }
  bool cf;
  const T carry = seg_scan_excl<T>(kind, seen, acc, cf,
                                   reinterpret_cast<T*>(sval), sflag);
  if (x.nrow > 0) {
    const bool pre_rows = !(x.heads & 1u);
    int64_t* pf = s.pfirst + x.tile * RW_MAX_COLS + c;
    if (seen && (pre_rows || threadIdx.x > 0)) {
      // the segment open at the thread's first row ends before its first head
      const T val = pre_rows ? comb<T>(kind, carry, pre) : carry;
      if (cf) st[x.id0 - x.gbase] = val;
      else *pf = to_bits<T>(val);         // it came in from the tile before
    }
    if (x.tail) {
      const T incl = seen ? acc : comb<T>(kind, carry, acc);
      if (!seen && !cf) *pf = to_bits<T>(incl);      // no head in the tile
      else if (!x.tail_ends)
        s.plast[x.tile * RW_MAX_COLS + c] = to_bits<T>(incl);
      else if (!x.tail_empty) st[x.last_id - x.gbase] = incl;
    }
  }
  stage_heads<T>(x, static_cast<T*>(outp));
}

template <typename T>
__device__ void reduce_col(int kind, const void* col, void* outp, int c,
                           const int64_t* pj, const TileCtx& x,
                           const RedScratch& s, int64_t* sval, int* sflag) {
  const T* v = static_cast<const T*>(col);
  // every gather before any store: a store may alias another column, so
  // interleaved they would wait for each load in turn
  T vj[ITEMS];
  if (kind == RW_REPLACE) {               // the same for every thread
    // written straight from the segment's last row: that row may lie in a
    // later tile than the head, so its slot is not this tile's to stage
    T* out = static_cast<T*>(outp);
    int id = x.id0, slot[ITEMS];
#pragma unroll
    for (int j = 0; j < ITEMS; ++j) {
      slot[j] = -1;
      if (j < x.nrow) {
        id += (x.heads >> j) & 1u;
        if (j + 1 < x.nrow ? (x.heads >> (j + 1)) & 1u : x.ends) {
          slot[j] = id;
          vj[j] = v[pj[j]];
        }
      }
    }
#pragma unroll
    for (int j = 0; j < ITEMS; ++j)
      if (slot[j] >= 0) out[slot[j]] = vj[j];
    return;
  }
#pragma unroll
  for (int j = 0; j < ITEMS; ++j)
    vj[j] = j < x.nrow ? v[pj[j]] : reduce_init<T>(kind);
  reduce_vals<T>(kind, vj, outp, c, x, s, sval, sflag);
}

// Rows are sorted by (sk, k2[perm]) with TWO, by sk alone without: sk is
// the first key in sorted order, k2 (TWO only) the second in original row
// order. ukeys / ukeys2 get each segment's keys (ukeys2 with TWO only).
// A segment whose first key is EMPTY_KEY is past the live ones: its values
// may be written here, and k_reduce_carry overwrites them with the fill.
// With TWO, column 0 is an int32 SUM (the sign), gathered with the keys.
template <bool TWO>
__global__ void __launch_bounds__(BLOCK, 2)
k_reduce_tiles(const int64_t* sk, const int64_t* k2, const int64_t* perm,
               int64_t n, RwCols cols, int64_t* ukeys, int64_t* ukeys2,
               RedScratch s) {
  __shared__ int slot;
  __shared__ int wt[WARPS];
  __shared__ int gbase_s;
  __shared__ int64_t sval[WARPS];
  __shared__ int sflag[WARPS];
  // each thread's first and last keys, for its neighbours' boundaries
  __shared__ int64_t xk[2][BLOCK], xq[2][TWO ? BLOCK : 1];
  __shared__ bool tail_ends_s;
  __shared__ int64_t stage[TILE];        // (TILE + 1 int32 slots used)
  __shared__ bool first_cont_s;
  const int t = threadIdx.x;
  const int64_t tile = take_ticket(s.ticket, &slot);
  const int64_t nt = (n + TILE - 1) / TILE;
  const int64_t t0 = tile * TILE;
  const int64_t r0 = t0 + int64_t(t) * ITEMS;
  const int nrow = r0 >= n ? 0 : (n - r0 < ITEMS ? int(n - r0) : ITEMS);
  int64_t kj[ITEMS], qj[ITEMS], pj[ITEMS];
  int32_t sg[ITEMS];
#pragma unroll
  for (int j = 0; j < ITEMS; ++j) {
    kj[j] = j < nrow ? sk[r0 + j] : EMPTY_KEY;
    pj[j] = j < nrow ? perm[r0 + j] : 0;
  }
#pragma unroll
  for (int j = 0; j < ITEMS; ++j) {
    qj[j] = TWO && j < nrow ? k2[pj[j]] : 0;
    sg[j] = TWO && j < nrow ? static_cast<const int32_t*>(cols.a[0])[pj[j]]
                            : 0;
  }
  int64_t lk = 0, lq = 0;                 // the thread's last row's keys
#pragma unroll
  for (int j = 0; j < ITEMS; ++j) {
    if (j < nrow) {
      lk = kj[j];
      lq = qj[j];
    }
  }
  xk[0][t] = kj[0];
  xk[1][t] = lk;
  if (TWO) {
    xq[0][t] = qj[0];
    xq[1][t] = lq;
  }
  __syncthreads();
  const bool has_prev = nrow > 0 && r0 > 0;
  int64_t prev = 0, prev2 = 0;            // the row before the thread's first
  if (has_prev && t > 0) {
    prev = xk[1][t - 1];
    if (TWO) prev2 = xq[1][t - 1];
  } else if (has_prev) {
    prev = sk[r0 - 1];
    if (TWO) prev2 = k2[perm[r0 - 1]];
  }
  // whether the row after the thread's last starts a segment
  const int64_t nx = r0 + nrow;
  bool ends = nrow > 0;
  if (ends && nx < n) {
    const bool inside = t + 1 < BLOCK;
    const int64_t nk = inside ? xk[0][t + 1] : sk[nx];
    const int64_t nq = !TWO ? 0 : inside ? xq[0][t + 1] : k2[perm[nx]];
    ends = nk != lk || (TWO && nq != lq);
  }
  unsigned heads = 0;
#pragma unroll
  for (int j = 0; j < ITEMS; ++j) {
    const bool h = j < nrow &&
                   (r0 + j == 0 || kj[j] != (j ? kj[j - 1] : prev) ||
                    (TWO && qj[j] != (j ? qj[j - 1] : prev2)));
    heads |= unsigned(h) << j;
  }
  const int64_t last = (t0 + TILE < n ? t0 + TILE : n) - 1;
  const bool tail = nrow > 0 && r0 + nrow - 1 == last;
  if (tail) tail_ends_s = ends;
  int tot;
  const int hex = block_excl_scan<int>(__popc(heads), wt, tot);
  const bool tail_ends = tail_ends_s;
  if (t == 0) {
    lookback_publish(s.status, tile, 1, 1u, unsigned(tot));
    const int gb = int(lookback_wait<32>(s.status, tile, 1, 1u,
                                         unsigned(tot)));
    gbase_s = gb;
    const bool first_cont = t0 > 0 && !(heads & 1u);
    first_cont_s = first_cont;
    s.flags[tile] = (tot > 0 ? RT_HEAD : 0) | (first_cont ? RT_FIRST : 0) |
                    (tot > 0 && !tail_ends ? RT_OWNER : 0);
    s.last_seg[tile] = gb + tot - 1;
    if (tile == nt - 1) *s.nseg = gb + tot;
  }
  __syncthreads();
  const int gbase = gbase_s;
  TileCtx x;
  x.gbase = gbase;
  x.tot = tot;
  x.stage = stage;
  // each segment's keys (with TWO its head row too, for k_reduce_gather),
  // staged at the head's slot; an EMPTY head's key is EMPTY_KEY, the fill
  // k_reduce_carry gives it anyway
#pragma unroll
  for (int j = 0, q = hex; j < ITEMS; ++j) {
    if ((heads >> j) & 1u) {
      // the first EMPTY row starts the first segment past the live ones
      if (kj[j] == EMPTY_KEY &&
          (r0 + j == 0 || (j ? kj[j - 1] : prev) != EMPTY_KEY))
        *s.live_end = gbase + q + 1;
      stage[q++] = kj[j];
    }
  }
  stage_heads<int64_t>(x, ukeys);
  if (TWO) {
#pragma unroll
    for (int j = 0, q = hex; j < ITEMS; ++j)
      if ((heads >> j) & 1u) stage[q++] = qj[j];
    stage_heads<int64_t>(x, ukeys2);
    // each segment's last row, for k_reduce_gather: staged at its id -
    // (gbase - 1), since the segment open at the tile's first row may end
    // here; the first and last staged slots are the tile's only when
    // those segments end in it
    int32_t* st32 = reinterpret_cast<int32_t*>(stage);
#pragma unroll
    for (int j = 0, q = hex; j < ITEMS; ++j) {
      if (j < nrow) {
        q += (heads >> j) & 1u;
        if (j + 1 < nrow ? (heads >> (j + 1)) & 1u : ends)
          st32[q] = int32_t(pj[j]);
      }
    }
    stage_out<int32_t>(stage, s.usrc, gbase - 1, first_cont_s ? 0 : 1,
                       tail_ends ? tot + 1 : tot);
  }
  x.tile = tile;
  x.nrow = nrow;
  x.heads = heads;
  x.ends = ends;
  x.id0 = gbase + hex - 1;
  x.last_id = gbase + tot - 1;
  x.tail = tail;
  x.tail_ends = tail_ends;
  x.tail_empty = tail && lk == EMPTY_KEY;
  for (int c = 0; c < cols.n; ++c) {
    if (TWO && c == 0) {
      reduce_vals<int32_t>(cols.kind[0], sg, cols.out[0], 0, x, s,
                           sval, sflag);
      continue;
    }
    if (TWO && cols.kind[c] == RW_REPLACE) continue;   // k_reduce_gather
    switch (cols.dtype[c]) {
      case RW_I64:
        reduce_col<int64_t>(cols.kind[c], cols.a[c], cols.out[c], c, pj, x, s,
                            sval, sflag);
        break;
      case RW_I32:
        reduce_col<int32_t>(cols.kind[c], cols.a[c], cols.out[c], c, pj, x, s,
                            sval, sflag);
        break;
      case RW_F64:
        reduce_col<double>(cols.kind[c], cols.a[c], cols.out[c], c, pj, x, s,
                           sval, sflag);
        break;
      default:
        reduce_col<uint8_t>(cols.kind[c], cols.a[c], cols.out[c], c, pj, x, s,
                            sval, sflag);
    }
  }
}

// An owner's crossing segment: its partial, then the first partials of
// tiles tile+1 .. e in order, 256 tiles at a time by an in-order tree
// (lane i joins lanes [i, i + 2o) at step o); thread 0 writes the result.
template <typename T>
__device__ void carry_col(int kind, void* outp, int c, int64_t tile,
                          int64_t e, int id, const RedScratch& s,
                          int64_t* sval, int* sflag) {
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  T* sv = reinterpret_cast<T*>(sval);
  T acc = from_bits<T>(s.plast[tile * RW_MAX_COLS + c]);
  for (int64_t j0 = tile + 1; j0 <= e; j0 += BLOCK) {
    const int64_t j = j0 + t;
    const bool ok = j <= e;                 // a prefix of the threads
    T x = ok ? from_bits<T>(s.pfirst[j * RW_MAX_COLS + c])
             : reduce_init<T>(kind);
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const T y = shfl_down_t<T>(x, o);
      const bool yok = lane + o < 32 && j + o <= e;
      if (yok) x = comb<T>(kind, x, y);
    }
    if (lane == 0) {
      sv[warp] = x;
      sflag[warp] = ok;
    }
    __syncthreads();
    if (t == 0)
      for (int w = 0; w < WARPS; ++w)
        if (sflag[w]) acc = comb<T>(kind, acc, sv[w]);
    __syncthreads();
  }
  if (t == 0) static_cast<T*>(outp)[id] = acc;
}

// Keys and values past the live segments (see the header; with TWO the
// REPLACE columns are k_reduce_gather's), the crossing segments, and
// ucount (null with TWO: batch_reduce_rows has none).
template <bool TWO>
__global__ void __launch_bounds__(BLOCK)
k_reduce_carry(const int64_t* sk, int64_t n, RwCols cols, int64_t* ukeys,
               int64_t* ukeys2, int32_t* ucount, RedScratch s) {
  __shared__ long long s_stop;
  __shared__ int64_t sval[WARPS];
  __shared__ int sflag[WARPS];
  const int t = threadIdx.x;
  const int64_t i = int64_t(blockIdx.x) * BLOCK + t;
  const int64_t nseg = *s.nseg;
  const int64_t live = *s.live_end ? *s.live_end - 1 : nseg;
  if (i == 0 && ucount) *ucount = int32_t(live);
  if (i < n) {
    if (TWO ? i >= nseg : i >= live) {
      ukeys[i] = EMPTY_KEY;
      if (TWO) ukeys2[i] = EMPTY_KEY;
    }
    if (i >= live)
      for (int c = 0; c < cols.n; ++c)
        if (!TWO || cols.kind[c] != RW_REPLACE)
          put_bits(cols.dtype[c], cols.out[c], i, cols.fill[c]);
  }
  const int64_t nt = (n + TILE - 1) / TILE;
  const int64_t tile = blockIdx.x;
  if (tile >= nt || !(s.flags[tile] & RT_OWNER)) return;
  const int64_t last = ((tile + 1) * TILE < n ? (tile + 1) * TILE : n) - 1;
  if (sk[last] == EMPTY_KEY) return;        // past the live ones: filled above
  // e: the last tile of the segment — tiles continue it while their first
  // row does, up to and including the first that holds a head
  long long e = -1;
  for (long long j0 = tile + 1; e < 0; j0 += BLOCK) {
    if (t == 0) s_stop = LLONG_MAX;
    __syncthreads();
    const long long j = j0 + t;
    const int f = j < nt ? s.flags[j] : 0;
    const long long stop = !(f & RT_FIRST) ? j - 1
                           : (f & RT_HEAD) ? j : LLONG_MAX;
    if (stop != LLONG_MAX) atomicMin(&s_stop, stop);
    __syncthreads();
    if (s_stop != LLONG_MAX) e = s_stop;
    __syncthreads();
  }
  const int id = s.last_seg[tile];
  for (int c = 0; c < cols.n; ++c) {
    if (cols.kind[c] == RW_REPLACE) continue;   // written by its last row
    switch (cols.dtype[c]) {
      case RW_I64:
        carry_col<int64_t>(cols.kind[c], cols.out[c], c, tile, e, id, s, sval,
                           sflag);
        break;
      case RW_I32:
        carry_col<int32_t>(cols.kind[c], cols.out[c], c, tile, e, id, s, sval,
                           sflag);
        break;
      case RW_F64:
        carry_col<double>(cols.kind[c], cols.out[c], c, tile, e, id, s, sval,
                          sflag);
        break;
      default:
        carry_col<uint8_t>(cols.kind[c], cols.out[c], c, tile, e, id, s, sval,
                           sflag);
    }
  }
}

constexpr int GATHER = 8;         // slots per thread of k_reduce_gather

template <typename T>
__device__ __forceinline__ void gather_slots(const void* a, void* out,
                                             int64_t i0, const int64_t* src) {
  T v[GATHER];
#pragma unroll
  for (int k = 0; k < GATHER; ++k)
    if (src[k] >= 0) v[k] = static_cast<const T*>(a)[src[k]];
#pragma unroll
  for (int k = 0; k < GATHER; ++k)
    if (src[k] >= 0) static_cast<T*>(out)[i0 + k * BLOCK] = v[k];
}

// Two keys: the blockIdx.y-th REPLACE column, slot i from its segment's
// last row, or from sorted row 0 past the live segments.
__global__ void __launch_bounds__(BLOCK)
k_reduce_gather(const int64_t* perm, int64_t n, RwCols cols, RedScratch s) {
  int c = 0;
  for (int k = 0, m = -1; k < cols.n; ++k)
    if (cols.kind[k] == RW_REPLACE && ++m == int(blockIdx.y)) {
      c = k;
      break;
    }
  const int64_t nseg = *s.nseg;
  const int64_t live = *s.live_end ? *s.live_end - 1 : nseg;
  const int64_t i0 = int64_t(blockIdx.x) * BLOCK * GATHER + threadIdx.x;
  int64_t src[GATHER];
#pragma unroll
  for (int k = 0; k < GATHER; ++k) {
    const int64_t i = i0 + k * BLOCK;
    src[k] = i >= n ? -1 : (i < live ? int64_t(s.usrc[i]) : perm[0]);
  }
  switch (cols.dtype[c]) {
    case RW_I64:
    case RW_F64: gather_slots<int64_t>(cols.a[c], cols.out[c], i0, src); break;
    case RW_I32: gather_slots<int32_t>(cols.a[c], cols.out[c], i0, src); break;
    default: gather_slots<uint8_t>(cols.a[c], cols.out[c], i0, src);
  }
}

// Launch the reduce over n > 0 sorted rows (see k_reduce_tiles); sites[3]
// name the tile, carry and gather launches.
template <bool TWO>
int reduce_tiles_launch(const int64_t* sk, const int64_t* k2,
                        const int64_t* perm, int64_t n, RwCols cols,
                        int64_t* ukeys, int64_t* ukeys2, int32_t* ucount,
                        void* scratch, cudaStream_t st, const int* sites) {
  const RedScratch s = reduce_layout(scratch, n, TWO);
  if (const cudaError_t e = cudaMemsetAsync(s.zero, 0, size_t(s.zero_bytes),
                                            st))
    return sites[0] * RW_SITE_STRIDE + int(e);
  k_reduce_tiles<TWO><<<unsigned(tiles_of(n)), BLOCK, 0, st>>>(
      sk, k2, perm, n, cols, ukeys, ukeys2, s);
  RW_CHECK(sites[0]);
  k_reduce_carry<TWO><<<blocks_of(n), BLOCK, 0, st>>>(sk, n, cols, ukeys,
                                                      ukeys2, ucount, s);
  RW_CHECK(sites[1]);
  int nrep = 0;
  for (int c = 0; c < cols.n; ++c) nrep += cols.kind[c] == RW_REPLACE;
  if (TWO && nrep > 0) {
    const dim3 grid(unsigned((n + BLOCK * GATHER - 1) / (BLOCK * GATHER)),
                    unsigned(nrep));
    k_reduce_gather<<<grid, BLOCK, 0, st>>>(perm, n, cols, s);
    RW_CHECK(sites[2]);
  }
  return 0;
}

}  // namespace
