// Hand-written CUDA kernel (sm_90a) for the ★ hop-window expansion of
// risingwave_tpu/device/fused.py:
//
//   HopNode.apply :786  -> rw_hop_expand  one thread per output row
//
// In the JAX package it is a jnp.repeat of every column plus arange
// arithmetic, fused by XLA. It does one floor division per output row
// and moves every column n times (n = size / hop, 5 for q5's HOP(2 s,
// 10 s)), so it is bound by the bytes it writes: at q5's shape 2^20 rows
// x 8 columns in, 5 x 2^20 rows x 10 columns out, ~570 MB. Each thread
// writes one output row — every column, the window bounds, the row id,
// the sign and the mask — in one pass; neighbouring threads write
// neighbouring addresses of each column, and the n threads of one input
// row read it once from L1/L2. Simple and correct first: no vectorised
// stores, one 64-bit division per output row.
#include "window_runs.h"

#include "rw_common.cuh"

namespace {

// floor(a / b) for b > 0 (C++ division truncates toward zero; the
// reference's `//` floors, negative timestamps included)
__device__ __forceinline__ int64_t floor_div(int64_t a, int64_t b) {
  const int64_t q = a / b;
  return (a % b != 0 && a < 0) ? q - 1 : q;
}

__global__ void k_hop_expand(RwCols cols, int64_t rows, int n,
                             const int64_t* ts, int64_t hop, int64_t size,
                             const int64_t* pk, const int32_t* sign,
                             const uint8_t* mask, int64_t* start,
                             int64_t* end, int64_t* pk_out,
                             int32_t* sign_out, uint8_t* mask_out) {
  const int64_t o = int64_t(blockIdx.x) * BLOCK + threadIdx.x;
  if (o >= rows * n) return;
  const int64_t i = o / n;
  const int64_t k = o - i * n;
  for (int j = 0; j < cols.n; ++j)
    copy_elem(cols.dtype[j], cols.a[j], i, cols.out[j], o);
  // wrapping int64 arithmetic, as jnp's, done on uint64
  const uint64_t first = uint64_t(floor_div(ts[i], hop)) * uint64_t(hop);
  const uint64_t s = first - uint64_t(k) * uint64_t(hop);
  start[o] = int64_t(s);
  end[o] = int64_t(s + uint64_t(size));
  if (pk_out) pk_out[o] = int64_t(uint64_t(pk[i]) * uint64_t(n) + uint64_t(k));
  sign_out[o] = sign[i];
  mask_out[o] = mask[i];
}

}  // namespace

extern "C" {

int rw_hop_expand(RwCols cols, int64_t rows, int n, const int64_t* ts,
                  int64_t hop, int64_t size, const int64_t* pk,
                  const int32_t* sign, const uint8_t* mask, int64_t* start,
                  int64_t* end, int64_t* pk_out, int32_t* sign_out,
                  uint8_t* mask_out, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int64_t total = rows * n;
  if (total <= 0) return 0;
  k_hop_expand<<<blocks_of(total), BLOCK, 0, st>>>(
      cols, rows, n, ts, hop, size, pk, sign, mask, start, end, pk_out,
      sign_out, mask_out);
  RW_CHECK(RW_S_HOP_EXPAND);
  return 0;
}

}  // extern "C"
