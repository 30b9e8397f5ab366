// Hand-written CUDA kernel (sm_90a) for the ★ bucket exchange of
// risingwave_tpu/device/shard_exec.py and parallel/sharded_agg.py:
//
//   _exchange_local :165 with _route_dest :148   -> rw_bucket_exchange
//   _bucketize (sharded_agg.py:36)              -> rw_bucket_exchange
//
// One call is one whole exchange: it places the rows of every source
// shard into receiver-major buffers [n_dst, n_src, cap], one per column,
// so receiver d's n_src * cap rows are out[d] as they are, source-major,
// with no transpose afterwards. Each live row's key gets its vnode (CRC32
// mod 256, as the parity form of core/vnode.bucket_parity: eight
// popcounts), the vnode its destination shard (the contiguous-block
// inverse shard_of_vnode, or rebalanced block bounds), and the row its
// slot: the count of earlier live rows of its source bound to the same
// destination. That rank is the contract — `cumsum(onehot) - 1` in the
// JAX package — because the receiver sees each key's rows in event order,
// which keeps an n-shard run bit-identical to the 1-shard one (float sums
// and the pair MV's order included), so no atomic may decide an order.
// Hot keys (key & hot_mask in a list) either broadcast (the row takes a
// slot in every bucket, ranked among the rows bound there) or salt
// (destination pk floor-mod n).
//
// Bound: the bytes — the mask read whole, the sign at masked-in rows, the
// key at live rows and each column at placed rows, and every buffer
// written once. Most of what is written is fill: at q5m's join exchange
// (8 sources of 2^19 rows, cap 2^16, 4 x int64 + int32) the buffers are
// 151 MB and the live rows a few MB, about 0.060 ms at 3.35 TB/s.
//
// Replaces three launches per source shard (per-tile counts, a scan, a
// place pass that ranked each 256-row round with two barriers and wrote
// one element per row at a scattered slot; the fill blocks beside it),
// called once per source, and the transpose copy of every buffer after
// them. Three launches per call, whatever n_src is:
//   1. a memset of the call's work words (counts, need, ticket, look-back);
//   2. k_exch_place: one pass over every source's tiles of 2048 rows,
//      four 256-thread blocks an SM. A tile takes its index from an atomic
//      ticket that deals the sources' tiles in turn and maps it to
//      (source, tile of that source). It reads the mask, then the sign and
//      the key where the mask is set; compacts the live rows' keys into
//      shared memory in row order (a ballot per warp and item), so that
//      whole warps of live rows compute each row's class once (its
//      destination, or "broadcast") and rank it per class in row order
//      (the peers of a class by one ballot per bit of the class; per-warp
//      counts in shared memory) however sparse the tile is; publishes its
//      class counts and reads the source's earlier tiles' by decoupled
//      look-back (a warp a class, 32 words a read; a tile never looks into
//      another source's words). The live rows are laid out in shared
//      memory by class, stable in row order. A tile of at most 256 live
//      rows writes a row a thread, eight columns' loads in flight at once;
//      a fuller one stages each column in shared memory and writes it run
//      by run, consecutive threads on consecutive slots. The first loads
//      go out before the look-back's wait and each next column's before
//      the run goes out. A broadcast row's slot in bucket d adds the
//      tile's class-d rows before it, and a class-d row's the broadcast
//      rows before it (binary searches over the runs in shared memory,
//      only in a tile that holds broadcast rows). The last tile of a
//      source writes its counts and need.
//   3. k_exch_fill: each (column, destination, source) bucket's slots from
//      its count on get the fill, written once, by 16-byte stores where the
//      addresses allow.
// What still holds it (PERF.md §6): the fill is at the card's
// write rate; the place pass is latency-bound on sparse inputs (the
// ticket, then two dependent rounds of loads, then the look-back, per
// 2048-row tile at four tiles an SM).
#include "exchange.h"

#include "rw_common.cuh"

namespace {

constexpr int MAX_CLS = RW_EXCH_MAX_SHARDS + 1;
constexpr int PLACE_BLOCKS = 4;   // place blocks an SM: 64 registers a thread
constexpr int FILL_WIN = BLOCK * 16 * 4;   // bytes of a bucket a fill block takes

// The destination class of a live row: 0..n-1, or n when it broadcasts.
__device__ __forceinline__ int class_of(const RwExchArgs& a, int s,
                                        int64_t key, int64_t i) {
  const uint64_t k = static_cast<uint64_t>(key);
  int vn = 0;
  for (int j = 0; j < a.vbits; ++j)
    vn |= (__popcll(k & a.vmask[j]) & 1) << j;
  vn ^= int(a.vflip);
  int dest;
  if (a.route == RW_ROUTE_BOUNDS) {
    dest = 0;
    for (int d = 1; d < a.n; ++d) dest += vn >= a.bounds[d];
  } else {
    dest = int(((int64_t(vn) + 1) * a.n - 1) >> a.vbits);
  }
  if (a.hot != RW_HOT_NONE) {
    const int64_t k40 = key & a.hot_mask;
    bool hot = false;
    for (int h = 0; h < a.n_hot; ++h) hot |= k40 == a.hot_keys[h];
    if (hot) {
      if (a.hot == RW_HOT_BCAST) return a.n;
      int64_t r = a.pk[s][i] % a.n;       // floor-mod, as jnp's `%`
      if (r < 0) r += a.n;
      dest = int(r);
    }
  }
  return dest;
}

// element i of a column as raw bits
__device__ __forceinline__ uint64_t load_bits(int dt, const void* src,
                                              int64_t i) {
  switch (dt) {
    case RW_I64:
    case RW_F64: return uint64_t(static_cast<const int64_t*>(src)[i]);
    case RW_I32: return static_cast<const uint32_t*>(src)[i];
    default: return static_cast<const uint8_t*>(src)[i];
  }
}

// first index of the ascending run r[0, len) whose value is >= x
__device__ __forceinline__ int lower_bound16(const int16_t* r, int len,
                                             int x) {
  int lo = 0, hi = len;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (r[mid] < x) lo = mid + 1; else hi = mid;
  }
  return lo;
}

// A place tile's shared memory (static: under 48 KB).
struct PlaceSmem {
  union {
    int64_t ckey[TILE];       // the live rows' keys, compacted in row order
    uint64_t stage[TILE];     // then one column's values, laid out by class
  };
  int32_t slot[TILE];         // position p's slot, -1 at or past cap
  int16_t crow[TILE];         // compacted live row q's row in the tile
  int16_t posof[TILE];        // compacted live row q's position
  int16_t row[TILE];          // position p's row in the tile
  uint8_t cls[TILE];          // position p's class
  int32_t whist[WARPS][MAX_CLS];   // per warp: class counts, then offsets
  int32_t tcount[MAX_CLS];    // the tile's rows of each class
  int32_t tstart[MAX_CLS];    // the tile's first position of each class
  int32_t gexcl[MAX_CLS];     // the source's rows of each class before it
  int32_t wt[WARPS];
  int32_t wlive[WARPS];       // each warp's live rows
  int ticket;
};

__global__ void __launch_bounds__(BLOCK, PLACE_BLOCKS)
k_exch_place(const __grid_constant__ RwExchArgs a, int64_t tiles,
             unsigned* __restrict__ ticket,
             unsigned long long* __restrict__ status,
             int64_t* __restrict__ counts, int64_t* __restrict__ need) {
  __shared__ PlaceSmem sm;
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  const int n = a.n;
  const bool bcast = a.hot == RW_HOT_BCAST;
  const int ncls = bcast ? n + 1 : n;
  for (int i = t; i < WARPS * MAX_CLS; i += BLOCK) (&sm.whist[0][0])[i] = 0;
  // tickets deal the sources' tiles in turn (tile j of every source, then
  // j + 1), so the tiles resident at once sit near the front of every
  // source's look-back chain
  const int64_t g = take_ticket(ticket, &sm.ticket);
  const int64_t tile = g / a.n_src;
  const int s = int(g - tile * a.n_src);
  const int64_t b = a.b, t0 = tile * TILE;
  // 1. the live rows. Warp-striped: warp w holds rows w * 256 .. of the
  // tile, item it of lane l is row it * 32 + l of them, so (warp, item,
  // lane) is row order. The mask is read, then the sign and the key where
  // it is set, both at once.
  const int64_t w0 = t0 + int64_t(warp) * (32 * ITEMS) + lane;
  const uint8_t* mask = a.mask[s];
  const int32_t* sign = a.sign[s];
  const int64_t* key = a.key[s];
  bool live[ITEMS];
  int32_t sg[ITEMS];
  int64_t kv[ITEMS];
#pragma unroll
  for (int it = 0; it < ITEMS; ++it) {
    const int64_t i = w0 + it * 32;
    live[it] = i < b && mask[i] != 0;
  }
#pragma unroll
  for (int it = 0; it < ITEMS; ++it) {
    sg[it] = live[it] && sign != nullptr ? sign[w0 + it * 32] : 1;
    kv[it] = live[it] ? key[w0 + it * 32] : 0;
  }
  // 2. the live rows' keys compacted into shared memory in row order, so
  // the class and the rank below take whole warps of live rows however
  // sparse the tile is
  const unsigned lt = (1u << lane) - 1u;
  int cq[ITEMS];
  int wn = 0;
#pragma unroll
  for (int it = 0; it < ITEMS; ++it) {
    live[it] = live[it] && sg[it] != 0;
    const unsigned bl = __ballot_sync(FULL, live[it]);
    cq[it] = wn + __popc(bl & lt);
    wn += __popc(bl);
  }
  if (lane == 0) sm.wlive[warp] = wn;
  __syncthreads();
  int wbase = 0, nlive = 0;
#pragma unroll
  for (int w = 0; w < WARPS; ++w) {
    const int c = sm.wlive[w];
    wbase += w < warp ? c : 0;
    nlive += c;
  }
#pragma unroll
  for (int it = 0; it < ITEMS; ++it) {
    if (live[it]) {
      sm.ckey[wbase + cq[it]] = kv[it];
      sm.crow[wbase + cq[it]] = int16_t(warp * (32 * ITEMS) + it * 32 + lane);
    }
  }
  __syncthreads();
  // 3. each live row's class once, and its rank in its warp per class in
  // row order: warp w takes `rounds` x 32 consecutive live rows, so
  // (warp, round, lane) is row order again. A lane's peers are the lanes
  // whose class + 1 (0: none) agrees with its own in every bit, one
  // ballot a bit.
  const int rounds = (nlive + BLOCK - 1) / BLOCK;
  const int nbits = 32 - __clz(unsigned(ncls));
  const int q0 = warp * rounds * 32 + lane;
  int ccls[ITEMS], crank[ITEMS];
#pragma unroll
  for (int r = 0; r < ITEMS; ++r) {
    ccls[r] = -1;
    crank[r] = 0;
    if (r >= rounds) continue;
    const int q = q0 + r * 32;
    const int c = q < nlive ? class_of(a, s, sm.ckey[q], t0 + sm.crow[q])
                            : -1;
    ccls[r] = c;
    if (__ballot_sync(FULL, c >= 0) == 0) continue;
    const unsigned code = unsigned(c + 1);
    unsigned peers = FULL;
    for (int k = 0; k < nbits; ++k) {
      const unsigned bk = __ballot_sync(FULL, (code >> k) & 1u);
      peers &= ((code >> k) & 1u) ? bk : ~bk;
    }
    const int leader = __ffs(peers) - 1;
    int prior = 0;
    if (c >= 0 && lane == leader) {
      prior = sm.whist[warp][c];
      sm.whist[warp][c] = prior + __popc(peers);
    }
    __syncwarp();
    crank[r] = __shfl_sync(FULL, prior, leader) + __popc(peers & lt);
  }
  __syncthreads();
  // per class: each warp's offset in the class's run, the tile's count
  for (int c = t; c < ncls; c += BLOCK) {
    int acc = 0;
#pragma unroll
    for (int w = 0; w < WARPS; ++w) {
      const int v = sm.whist[w][c];
      sm.whist[w][c] = acc;
      acc += v;
    }
    sm.tcount[c] = acc;
  }
  __syncthreads();
  // every class's count published at once; the wait comes later
  unsigned long long* st = status + int64_t(s) * ncls * tiles;
  if (t < ncls)
    lookback_publish(st + t * tiles, tile, 1, 1u, unsigned(sm.tcount[t]));
  {
    int total;
    const int e = block_excl_scan<int>(t < ncls ? sm.tcount[t] : 0, sm.wt,
                                       total);
    if (t < ncls) sm.tstart[t] = e;
  }
  __syncthreads();
  // 4. positions: the tile's live rows by class, stable in row order
#pragma unroll
  for (int r = 0; r < ITEMS; ++r) {
    const int c = ccls[r];
    if (c >= 0) {
      const int q = q0 + r * 32;
      const int p = sm.tstart[c] + sm.whist[warp][c] + crank[r];
      sm.row[p] = sm.crow[q];
      sm.cls[p] = uint8_t(c);
      sm.posof[q] = int16_t(p);
    }
  }
  __syncthreads();
  // a tile of at most BLOCK live rows writes a row a thread, its columns
  // loaded straight from device memory; a fuller one stages each column
  // in shared memory. Either way the first loads go out before the
  // look-back's wait.
  const bool direct = nlive <= BLOCK;
  uint64_t v[ITEMS];
  if (direct) {
    if (t < nlive) {
      const int64_t r = t0 + sm.row[t];
#pragma unroll
      for (int k = 0; k < ITEMS; ++k)
        if (k < a.ncols) v[k] = load_bits(a.dtype[k], a.col[s][k], r);
    }
  } else if (a.ncols > 0) {
#pragma unroll
    for (int k = 0; k < ITEMS; ++k) {
      const int q = t + k * BLOCK;
      if (q < nlive) v[k] = load_bits(a.dtype[0], a.col[s][0],
                                      t0 + sm.crow[q]);
    }
  }
  // 5. the source's rows of each class before this tile: a warp a class
  // reads 32 earlier tiles' words at a time (the words of (source, class)
  // are one run by tile)
  for (int c = warp; c < ncls; c += WARPS) {
    const unsigned before = lookback_warp(st + c * tiles, tile, 1u,
                                          unsigned(sm.tcount[c]));
    if (lane == 0) sm.gexcl[c] = int(before);
  }
  __syncthreads();
  const int nonb = bcast ? sm.tstart[n] : nlive;   // positions bound once
  const int nbt = bcast ? sm.tcount[n] : 0;        // broadcast rows
  const int gb = bcast ? sm.gexcl[n] : 0;
  if (tile == tiles - 1 && t == 0) {
    const int64_t nb = bcast ? int64_t(gb) + nbt : 0;
    int64_t mx = 0;
    for (int d = 0; d < n; ++d) {
      const int64_t c = int64_t(sm.gexcl[d]) + sm.tcount[d] + nb;
      counts[int64_t(s) * n + d] = c;
      mx = c > mx ? c : mx;
    }
    need[s] = mx;
  }
  // 6. the rows out: a position's slot is its class's rows before the
  // tile, plus the broadcast rows before the tile, plus its rank in the
  // tile's run of its destination (class rows and broadcast rows merged
  // in row order)
  const int64_t seg = a.n_src;
  if (direct) {
    const int p = t;
    if (p >= nlive) return;
    const bool bc = p >= nonb;
    int64_t at = -1;
    if (!bc) {
      const int c = sm.cls[p];
      int k = p - sm.tstart[c];
      if (nbt) k += lower_bound16(sm.row + nonb, nbt, sm.row[p]);
      const int64_t sl = int64_t(sm.gexcl[c]) + gb + k;
      if (sl >= a.cap) return;
      at = (int64_t(c) * seg + s) * a.cap + sl;
    }
    const int64_t r = t0 + sm.row[p];
    for (int j0 = 0; j0 < a.ncols; j0 += ITEMS) {
      if (j0 > 0) {
#pragma unroll
        for (int k = 0; k < ITEMS; ++k)
          if (j0 + k < a.ncols)
            v[k] = load_bits(a.dtype[j0 + k], a.col[s][j0 + k], r);
      }
#pragma unroll
      for (int k = 0; k < ITEMS; ++k) {
        if (j0 + k >= a.ncols) break;
        const int dt = a.dtype[j0 + k];
        void* out = a.out[j0 + k];
        if (!bc) {
          put_bits(dt, out, at, int64_t(v[k]));
          continue;
        }
        for (int d = 0; d < n; ++d) {
          const int before = lower_bound16(sm.row + sm.tstart[d],
                                           sm.tcount[d], sm.row[p]);
          const int64_t sl = int64_t(sm.gexcl[d]) + gb + before + p - nonb;
          if (sl < a.cap)
            put_bits(dt, out, (int64_t(d) * seg + s) * a.cap + sl,
                     int64_t(v[k]));
        }
      }
    }
    return;
  }
  for (int p = t; p < nonb; p += BLOCK) {
    const int c = sm.cls[p];
    int k = p - sm.tstart[c];
    if (nbt) k += lower_bound16(sm.row + nonb, nbt, sm.row[p]);
    const int64_t sl = int64_t(sm.gexcl[c]) + gb + k;
    sm.slot[p] = sl < a.cap ? int32_t(sl) : -1;
  }
  for (int j = 0; j < a.ncols; ++j) {
    __syncthreads();   // the slots written / the last column's run read
#pragma unroll
    for (int k = 0; k < ITEMS; ++k) {
      const int q = t + k * BLOCK;
      if (q < nlive) sm.stage[sm.posof[q]] = v[k];
    }
    __syncthreads();
    if (j + 1 < a.ncols) {
#pragma unroll
      for (int k = 0; k < ITEMS; ++k) {
        const int q = t + k * BLOCK;
        if (q < nlive) v[k] = load_bits(a.dtype[j + 1], a.col[s][j + 1],
                                        t0 + sm.crow[q]);
      }
    }
    const int dt = a.dtype[j];
    void* out = a.out[j];
    for (int p = t; p < nonb; p += BLOCK) {
      const int sl = sm.slot[p];
      if (sl >= 0)
        put_bits(dt, out, (int64_t(sm.cls[p]) * seg + s) * a.cap + sl,
                 int64_t(sm.stage[p]));
    }
    for (int q = t; q < nbt * n; q += BLOCK) {
      const int bi = q / n, d = q - bi * n;
      const int before = lower_bound16(sm.row + sm.tstart[d], sm.tcount[d],
                                       sm.row[nonb + bi]);
      const int64_t sl = int64_t(sm.gexcl[d]) + gb + before + bi;
      if (sl < a.cap)
        put_bits(dt, out, (int64_t(d) * seg + s) * a.cap + sl,
                 int64_t(sm.stage[nonb + bi]));
    }
  }
}

// What the fill pass reads of the call (a small parameter block).
struct ExchFill {
  int32_t n, n_src;
  int64_t cap;
  int32_t dtype[RW_MAX_COLS];
  int64_t fill[RW_MAX_COLS];
  void* out[RW_MAX_COLS];
};

__device__ __forceinline__ int elem_bytes(int dt) {
  return dt == RW_I32 ? 4 : dt == RW_BOOL ? 1 : 8;
}

__device__ __forceinline__ void put_at(int dt, uintptr_t p, int64_t bits) {
  if (dt == RW_I32) *reinterpret_cast<int32_t*>(p) = int32_t(bits);
  else if (dt == RW_BOOL) *reinterpret_cast<uint8_t*>(p) = uint8_t(bits);
  else *reinterpret_cast<int64_t*>(p) = bits;
}

// 16 bytes of the fill, repeated
__device__ __forceinline__ uint4 fill_vec(int dt, int64_t bits) {
  const uint32_t lo = uint32_t(bits), hi = uint32_t(uint64_t(bits) >> 32);
  if (dt == RW_I32) return make_uint4(lo, lo, lo, lo);
  if (dt == RW_BOOL) {
    const uint32_t w = (lo & 0xffu) * 0x01010101u;
    return make_uint4(w, w, w, w);
  }
  return make_uint4(lo, hi, lo, hi);
}

// grid (window of FILL_WIN bytes, bucket d * n_src + s, column): the
// bucket's slots from min(count, cap) on, within the window.
__global__ void __launch_bounds__(BLOCK)
k_exch_fill(const __grid_constant__ ExchFill f,
            const int64_t* __restrict__ counts) {
  const int j = blockIdx.z, seg = blockIdx.y;
  const int d = seg / f.n_src, s = seg - d * f.n_src;
  const int dt = f.dtype[j], es = elem_bytes(dt);
  const int64_t seg_bytes = f.cap * es;
  const int64_t w_lo = int64_t(blockIdx.x) * FILL_WIN;
  if (w_lo >= seg_bytes) return;
  int64_t c = counts[int64_t(s) * f.n + d];
  c = c < f.cap ? c : f.cap;
  const int64_t lo = c * es > w_lo ? c * es : w_lo;
  const int64_t hi = w_lo + FILL_WIN < seg_bytes ? w_lo + FILL_WIN
                                                 : seg_bytes;
  if (lo >= hi) return;
  const uintptr_t base = reinterpret_cast<uintptr_t>(f.out[j]) +
                         uintptr_t(int64_t(seg) * seg_bytes);
  const uintptr_t A = base + uintptr_t(lo), E = base + uintptr_t(hi);
  const uintptr_t A16 = (A + 15) & ~uintptr_t(15), E16 = E & ~uintptr_t(15);
  const int64_t bits = f.fill[j];
  const int t = threadIdx.x;
  if (A16 >= E16) {          // no whole 16-byte word: element by element
    for (uintptr_t p = A + uintptr_t(t) * es; p < E; p += uintptr_t(BLOCK) * es)
      put_at(dt, p, bits);
    return;
  }
  const int head = int((A16 - A) / es), tail = int((E - E16) / es);
  if (t < head) put_at(dt, A + uintptr_t(t) * es, bits);
  else if (t < head + tail) put_at(dt, E16 + uintptr_t(t - head) * es, bits);
  const uint4 w = fill_vec(dt, bits);
  uint4* vp = reinterpret_cast<uint4*>(A16);
  const int64_t nv = int64_t(E16 - A16) / 16;
  for (int64_t k = t; k < nv; k += BLOCK) vp[k] = w;
}

// The call's work buffer: counts and need (the outputs), then the tiles'
// ticket and look-back words; all of it zeroed once per call.
struct ExchWork {
  int64_t* counts;                // [n_src][n]
  int64_t* need;                  // [n_src]
  unsigned* ticket;
  unsigned long long* status;     // [n_src][ncls][tiles]
  int64_t bytes;
};

int64_t work_head(int32_t n_src, int32_t n) {
  return align256(8 * (int64_t(n_src) * n + n_src));
}

int64_t work_bytes(int64_t b, int32_t n_src, int32_t n) {
  return work_head(n_src, n) + 256 +
         align256(tiles_of(b) * n_src * (n + 1) * 8);
}

ExchWork work_layout(void* work, int64_t b, int32_t n_src, int32_t n) {
  char* p = static_cast<char*>(work);
  const int64_t head = work_head(n_src, n);
  ExchWork w;
  w.counts = reinterpret_cast<int64_t*>(p);
  w.need = w.counts + int64_t(n_src) * n;
  w.ticket = reinterpret_cast<unsigned*>(p + head);
  w.status = reinterpret_cast<unsigned long long*>(p + head + 256);
  w.bytes = work_bytes(b, n_src, n);
  return w;
}

}  // namespace

extern "C" {

int64_t rw_exchange_work_bytes(int64_t b, int32_t n_src, int32_t n) {
  return work_bytes(b, n_src, n);
}

int rw_bucket_exchange(const RwExchArgs* args, void* work, void* stream) {
  const RwExchArgs& a = *args;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const ExchWork w = work_layout(work, a.b, a.n_src, a.n);
  const cudaError_t e = cudaMemsetAsync(work, 0, size_t(w.bytes), st);
  if (e != cudaSuccess) {
    cudaGetLastError();
    return RW_S_EXCH_ZERO * RW_SITE_STRIDE + int(e);
  }
  const int64_t tiles = tiles_of(a.b);
  if (tiles > 0) {
    k_exch_place<<<unsigned(tiles * a.n_src), BLOCK, 0, st>>>(
        a, tiles, w.ticket, w.status, w.counts, w.need);
    RW_CHECK(RW_S_EXCH_PLACE);
  }
  const int64_t windows = (a.cap * 8 + FILL_WIN - 1) / FILL_WIN;
  if (a.ncols > 0 && windows > 0) {
    ExchFill f;
    f.n = a.n;
    f.n_src = a.n_src;
    f.cap = a.cap;
    for (int j = 0; j < a.ncols; ++j) {
      f.dtype[j] = a.dtype[j];
      f.fill[j] = a.fill[j];
      f.out[j] = a.out[j];
    }
    const dim3 grid(unsigned(windows), unsigned(a.n * a.n_src),
                    unsigned(a.ncols));
    k_exch_fill<<<grid, BLOCK, 0, st>>>(f, w.counts);
    RW_CHECK(RW_S_EXCH_FILL);
  }
  return 0;
}

}  // extern "C"
