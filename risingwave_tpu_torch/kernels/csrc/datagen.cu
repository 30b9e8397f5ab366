// Hand-written CUDA kernel (sm_90a) for the bid generator of the fused
// device pipeline, risingwave_tpu/device/datagen.py:
//
//   gen_bids :26 (jax.random split / uniform / randint)  -> rw_gen_bids
//
// jax.random's threefry2x32 (JAX 0.9.0, partitionable: jax/_src/prng.py
// :863-930, :1156, :1184-1199; jax/_src/random.py :435, :581), to the
// bit. One launch, one thread a row. Each block first derives the
// sub-keys from the key in device memory — split(key, 3) by three
// threads, then randint's split(k2, 2) by two — so the key never visits
// the host and a CUDA graph can replay the launch with a key that moves
// on the device. Each thread then hashes its row three times (the
// uniform's bits, randint's higher and lower bits) and writes its auction
// and price; block 0 writes the next key.
//
// Bound: 16 bytes written a row (3.35 TB/s: 5.0 us at 2^20 rows) against
// 238 32-bit integer instructions a row as sm_90 issues them (three
// hashes of 74: the key schedule's xor, two key adds, 20 rounds of
// IADD3 / funnel shift / LOP3, five injections of one add a word, the
// words' xor; the uniform's shift and or; randint's three remainders,
// multiply-add and offset): 0.25 G at 2^20 rows. An SM has 64 INT32
// lanes, so the card retires 16.75 T of them a second (a quarter of the
// table's 67 T/s float32, which counts an FMA of 128 lanes as two): 14.9
// us at 2^20 rows, so the integer work bounds the kernel, not its bytes.
// The design keeps the work in registers: no shared memory beyond ten
// key words, no loads past the two key words, coalesced 8-byte stores.
//
// The floats are XLA's: the uniform is the bits' top 23 as the mantissa
// of a float in [1, 2), minus 1 (the `* (max - min) + min` of [0, 1) is
// exact and left out); `u ** skew` is (u * u) * u for skew 3.0, u * u,
// u or sqrt(u) for 2.0, 1.0 and 0.5, as XLA's simplifier rewrites pow;
// every product is an explicit round-to-nearest multiply (no
// contraction, no fast math: -O3 alone), and the float -> int64
// conversion truncates. Any other skew takes powf, which need not round
// as XLA's pow does.
#include "datagen.h"

#include "rw_common.cuh"

namespace {

constexpr uint32_t KS_PARITY = 0x1BD11BDAu;

__device__ __forceinline__ uint32_t rotl(uint32_t x, int r) {
  return __funnelshift_l(x, x, r);
}

// four rounds of threefry2x32
template <int R0, int R1, int R2, int R3>
__device__ __forceinline__ void rounds4(uint32_t& x0, uint32_t& x1) {
  x0 += x1; x1 = rotl(x1, R0) ^ x0;
  x0 += x1; x1 = rotl(x1, R1) ^ x0;
  x0 += x1; x1 = rotl(x1, R2) ^ x0;
  x0 += x1; x1 = rotl(x1, R3) ^ x0;
}

// threefry2x32 of the counts (c0, c1) under the key (k0, k1)
__device__ __forceinline__ uint2 threefry(uint32_t k0, uint32_t k1,
                                          uint32_t c0, uint32_t c1) {
  const uint32_t k2 = k0 ^ k1 ^ KS_PARITY;
  uint32_t x0 = c0 + k0, x1 = c1 + k1;
  rounds4<13, 15, 26, 6>(x0, x1);  x0 += k1; x1 += k2 + 1u;
  rounds4<17, 29, 16, 24>(x0, x1); x0 += k2; x1 += k0 + 2u;
  rounds4<13, 15, 26, 6>(x0, x1);  x0 += k0; x1 += k1 + 3u;
  rounds4<17, 29, 16, 24>(x0, x1); x0 += k1; x1 += k2 + 4u;
  rounds4<13, 15, 26, 6>(x0, x1);  x0 += k2; x1 += k0 + 5u;
  return make_uint2(x0, x1);
}

__device__ __forceinline__ uint32_t bits32(uint32_t k0, uint32_t k1,
                                           uint32_t hi, uint32_t lo) {
  const uint2 b = threefry(k0, k1, hi, lo);
  return b.x ^ b.y;
}

__device__ __forceinline__ float skewed(float u, int form, float skew) {
  switch (form) {
    case RW_SKEW_ONE: return u;
    case RW_SKEW_SQUARE: return __fmul_rn(u, u);
    case RW_SKEW_CUBE: return __fmul_rn(__fmul_rn(u, u), u);
    case RW_SKEW_SQRT: return __fsqrt_rn(u);
    default: return powf(u, skew);
  }
}

__global__ void k_gen_bids(const int64_t* __restrict__ key, int64_t n,
                           float scale, int form, float skew, int32_t minval,
                           uint32_t span, uint32_t mult,
                           int64_t* __restrict__ auction,
                           int64_t* __restrict__ price,
                           int64_t* __restrict__ next_key) {
  // sk: next key, k1 (uniform), k2, then split(k2): higher, lower
  __shared__ uint32_t sk[10];
  const int t = threadIdx.x;
  if (t < 3) {
    const uint2 b = threefry(uint32_t(key[0]), uint32_t(key[1]), 0u,
                             uint32_t(t));
    sk[2 * t] = b.x;
    sk[2 * t + 1] = b.y;
  }
  __syncthreads();
  if (t < 2) {
    const uint2 b = threefry(sk[4], sk[5], 0u, uint32_t(t));
    sk[6 + 2 * t] = b.x;
    sk[7 + 2 * t] = b.y;
  }
  __syncthreads();
  if (blockIdx.x == 0 && t < 2) next_key[t] = int64_t(sk[t]);
  const int64_t i = int64_t(blockIdx.x) * BLOCK + t;
  if (i >= n) return;
  const uint32_t hi = uint32_t(uint64_t(i) >> 32), lo = uint32_t(i);
  const uint32_t ub = bits32(sk[2], sk[3], hi, lo);
  const float u = __fsub_rn(__uint_as_float((ub >> 9) | 0x3F800000u), 1.0f);
  auction[i] = static_cast<int64_t>(__fmul_rn(scale, skewed(u, form, skew)));
  const uint32_t hb = bits32(sk[6], sk[7], hi, lo);
  const uint32_t lb = bits32(sk[8], sk[9], hi, lo);
  const uint32_t off = ((hb % span) * mult + lb % span) % span;
  price[i] = int64_t(int32_t(uint32_t(minval) + off));
}

}  // namespace

extern "C" {

int rw_gen_bids(const int64_t* key, int64_t n, float scale, int form,
                float skew, int32_t minval, uint32_t span, uint32_t mult,
                int64_t* auction, int64_t* price, int64_t* next_key,
                void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const unsigned blocks = n > 0 ? blocks_of(n) : 1u;
  k_gen_bids<<<blocks, BLOCK, 0, st>>>(key, n, scale, form, skew, minval,
                                       span, mult, auction, price, next_key);
  RW_CHECK(RW_S_GEN_BIDS);
  return 0;
}

}  // extern "C"
