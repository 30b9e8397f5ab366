// Hand-written CUDA kernel (sm_90a) for the expression layer's device
// pass: every `eval_device` of risingwave_tpu/expr/expression.py
// (FunctionCall :156, Case :225, IsNull :262, Coalesce :294) over the
// device halves of risingwave_tpu/expr/functions.py (:113-147, :196,
// :232-242, :331-343, :737-741, :806-809, :861-866, :881-883).
//
//   Map / Filter / join condition -> rw_expr_eval  eight rows a thread
//
// In the JAX package a node's expression list is jnp code that XLA fuses
// into the epoch program: one elementwise pass. Here the host lowers the
// list once into a postfix program and folds it (kernels/expr_eval.py):
// an operand that is a column or a literal rides in the instruction that
// takes it instead of being pushed, so q3a's `price > 500` filter runs as
// two instructions, not four. The program rides in the kernel's
// parameters (__grid_constant__: every thread reads the same
// instruction, so dispatch is uniform across a warp).
//
// Bound: each input column read once a row and each output written once —
// bytes (at 2^20 rows q2c's filter moves 10 MB, ~3 us at 3.35 TB/s). One
// thread a row was bound by the instructions it ran instead, 4-6x the bytes:
// each program instruction cost a row tens of instructions (the `switch`
// decode, the parameter reads, a shift of all 8 stack slots on every push
// and pop). So:
//   * a thread takes XR = 8 rows (r x 64 + t of its block's 512): one
//     decode serves eight rows, and an op's validity is an 8-bit mask,
//     one instruction for all eight;
//   * the stack's top is in registers (`acc`), the values below it in
//     shared memory at slots the stack pointer names (a level of XR x 64
//     words, as many levels as the program needs: none for q3a's filter,
//     at most 7 in 28 KB),
//     so no push or pop shifts anything;
//   * the dispatch switches on (op, type): the common arithmetic,
//     comparison and logic ops are each a case compiled for its type, the
//     rest share a generic case;
//   * an instruction's column operands are loaded for all eight rows at
//     once (and the row mask at the start), coalesced, in any alignment
//     (an L1 prefetch of every input at the start was slower on the
//     card, and four rows a thread slower than eight);
//   * integer division by a literal multiplies by a magic number the
//     host computed (Granlund and Montgomery, "Division by invariant
//     integers using multiplication", 1994, Thm 4.2: exact for every
//     magnitude below 2^63), other integer division of values below
//     2^32 divides in 32 bits.
//
// Where it must not drift from the reference:
// * integers wrap at their own width: add / subtract / multiply /
//   negate run on uint64 and are cut back to int16 / int32;
// * integer division is sign(a)·sign(b)·floor(|a| / |b|) with |INT_MIN|
//   wrapping to itself, the floor written out (C++ `/` truncates), a
//   zero divisor replaced by 1 and the row made NULL;
// * no contraction: float add / subtract / multiply / divide are the
//   `__d*_rn` / `__f*_rn` intrinsics, so `a - trunc(a / b) * b` is never
//   an FMA (neither jnp nor torch's eager ops contract);
// * round and float -> int use rint (half to even); float -> int then
//   follows XLA's convert: NaN gives 0, past the range its nearest end;
// * tumble_start's `//` is XLA's: x // 0 is -1 (x == 0) or -2, and
//   INT64_MIN // -1 is INT64_MIN.
#include "expr_eval.h"

#include <type_traits>

#include "rw_common.cuh"

namespace {

__device__ __forceinline__ double as_f64(int64_t x) {
  return __longlong_as_double(x);
}
__device__ __forceinline__ int64_t of_f64(double d) {
  return __double_as_longlong(d);
}
__device__ __forceinline__ float as_f32(int64_t x) {
  return __double2float_rn(as_f64(x));   // exact: the slot holds a float
}
__device__ __forceinline__ int64_t of_f32(float f) {
  return of_f64(static_cast<double>(f));
}

// an integer result cut back to type t's width, sign-extended
__device__ __forceinline__ int64_t wrap(int t, uint64_t u) {
  if (t == RW_E_I16) return static_cast<int16_t>(static_cast<uint16_t>(u));
  if (t == RW_E_I32) return static_cast<int32_t>(static_cast<uint32_t>(u));
  return static_cast<int64_t>(u);
}

__device__ __forceinline__ int64_t sgn(int64_t a) {
  return (a > 0) - (a < 0);
}

// |a| at width t (|INT_MIN| wraps to INT_MIN, as jnp.abs)
__device__ __forceinline__ int64_t wabs(int t, int64_t a) {
  return wrap(t, a < 0 ? 0ull - static_cast<uint64_t>(a)
                       : static_cast<uint64_t>(a));
}

// floor(a / b) for b != 0 and not (INT64_MIN, -1)
__device__ __forceinline__ int64_t floordiv(int64_t a, int64_t b) {
  const int64_t q = a / b;
  return (a % b != 0 && ((a < 0) != (b < 0))) ? q - 1 : q;
}

// floor(|a| / |b|) of arith's magnitudes: in 32 bits when both lie in
// [0, 2^32) (|INT_MIN| stays negative and takes the 64-bit path)
__device__ __forceinline__ int64_t absdiv(int64_t a, int64_t b) {
  if (((static_cast<uint64_t>(a) | static_cast<uint64_t>(b)) >> 32) == 0)
    return static_cast<uint32_t>(a) / static_cast<uint32_t>(b);
  return floordiv(a, b);
}

// XLA's integer floor division, where b may be 0 or -1
__device__ __forceinline__ int64_t xla_floordiv(int64_t a, int64_t b) {
  if (b == 0) return a == 0 ? -1 : -2;
  if (a == INT64_MIN && b == -1) return INT64_MIN;
  return floordiv(a, b);
}

// rint of a float, converted to integer type t as XLA does: NaN gives
// 0, a value past the range its nearest end
__device__ __forceinline__ int64_t float_to_int(int t, double r) {
  const int64_t hi = t == RW_E_I16 ? 32767
                     : t == RW_E_I32 ? 2147483647 : INT64_MAX;
  const int64_t lo = -hi - 1;
  const double top = static_cast<double>(hi) + 1.0;   // 2^(bits-1), exact
  if (isnan(r)) return 0;
  if (r >= top) return hi;
  if (r < -top) return lo;
  return static_cast<int64_t>(r);
}

// convert a slot of type `from` to type `to` (astype; float -> int by
// rint and XLA's convert)
__device__ __forceinline__ int64_t convert(int to, int from, int64_t x) {
  const bool ffrom = from == RW_E_F32 || from == RW_E_F64;
  if (!ffrom) {
    if (to == RW_E_BOOL) return x != 0;
    if (to == RW_E_F64) return of_f64(__ll2double_rn(x));
    if (to == RW_E_F32) return of_f32(__ll2float_rn(x));
    return wrap(to, static_cast<uint64_t>(x));
  }
  const double d = as_f64(x);                 // exact for a float32 slot
  if (to == RW_E_BOOL) return d != 0.0;
  if (to == RW_E_F64) return x;
  if (to == RW_E_F32) return of_f32(__double2float_rn(d));
  const double r = from == RW_E_F32 ? static_cast<double>(rintf(as_f32(x)))
                                    : rint(d);
  return float_to_int(to, r);
}

__device__ __forceinline__ void store(int t, void* p, int64_t i, int64_t x) {
  switch (t) {
    case RW_E_BOOL: static_cast<uint8_t*>(p)[i] = static_cast<uint8_t>(x);
      break;
    case RW_E_I16: static_cast<int16_t*>(p)[i] = static_cast<int16_t>(x);
      break;
    case RW_E_I32: static_cast<int32_t*>(p)[i] = static_cast<int32_t>(x);
      break;
    case RW_E_F32: static_cast<float*>(p)[i] = as_f32(x); break;
    default: static_cast<int64_t*>(p)[i] = x;
  }
}

__device__ __forceinline__ int64_t arith(int op, int t, int64_t a,
                                         int64_t b, bool& ok) {
  if (t == RW_E_F64) {
    const double x = as_f64(a), y = as_f64(b);
    switch (op) {
      case RW_X_ADD: return of_f64(__dadd_rn(x, y));
      case RW_X_SUB: return of_f64(__dsub_rn(x, y));
      case RW_X_MUL: return of_f64(__dmul_rn(x, y));
      default: {
        ok = y != 0.0;
        const double s = ok ? y : 1.0;
        const double q = __ddiv_rn(x, s);
        return of_f64(op == RW_X_DIV ? q
                                     : __dsub_rn(x, __dmul_rn(trunc(q), s)));
      }
    }
  }
  if (t == RW_E_F32) {
    const float x = as_f32(a), y = as_f32(b);
    switch (op) {
      case RW_X_ADD: return of_f32(__fadd_rn(x, y));
      case RW_X_SUB: return of_f32(__fsub_rn(x, y));
      case RW_X_MUL: return of_f32(__fmul_rn(x, y));
      default: {
        ok = y != 0.0f;
        const float s = ok ? y : 1.0f;
        const float q = __fdiv_rn(x, s);
        return of_f32(op == RW_X_DIV ? q
                                     : __fsub_rn(x, __fmul_rn(truncf(q), s)));
      }
    }
  }
  const uint64_t ua = static_cast<uint64_t>(a), ub = static_cast<uint64_t>(b);
  switch (op) {
    case RW_X_ADD: return wrap(t, ua + ub);
    case RW_X_SUB: return wrap(t, ua - ub);
    case RW_X_MUL: return wrap(t, ua * ub);
    default: {
      ok = b != 0;
      const int64_t s = ok ? b : 1;
      const int64_t q = absdiv(wabs(t, a), wabs(t, s));
      const int64_t sq = wrap(t, static_cast<uint64_t>(sgn(a) * sgn(s)) *
                                     static_cast<uint64_t>(q));
      if (op == RW_X_DIV) return sq;
      return wrap(t, ua - static_cast<uint64_t>(sq) * static_cast<uint64_t>(s));
    }
  }
}

__device__ __forceinline__ bool compare(int op, int t, int64_t a,
                                        int64_t b) {
  if (t == RW_E_F32 || t == RW_E_F64) {
    const double x = as_f64(a), y = as_f64(b);
    switch (op) {
      case RW_X_EQ: return x == y;
      case RW_X_NE: return x != y;
      case RW_X_LT: return x < y;
      case RW_X_LE: return x <= y;
      case RW_X_GT: return x > y;
      default: return x >= y;
    }
  }
  switch (op) {
    case RW_X_EQ: return a == b;
    case RW_X_NE: return a != b;
    case RW_X_LT: return a < b;
    case RW_X_LE: return a <= b;
    case RW_X_GT: return a > b;
    default: return a >= b;
  }
}

__device__ __forceinline__ int64_t math1(int op, int t, int64_t a) {
  if (t == RW_E_F32) {
    const float x = as_f32(a);
    switch (op) {
      case RW_X_ABS: return of_f32(fabsf(x));
      case RW_X_FLOOR: return of_f32(floorf(x));
      case RW_X_CEIL: return of_f32(ceilf(x));
      case RW_X_ROUND: return of_f32(rintf(x));
      case RW_X_SQRT: return of_f32(sqrtf(x));
      case RW_X_EXP: return of_f32(expf(x));
      case RW_X_LN: return of_f32(logf(x));
      case RW_X_LOG10: return of_f32(log10f(x));
      case RW_X_SIN: return of_f32(sinf(x));
      case RW_X_COS: return of_f32(cosf(x));
      default: return of_f32(tanf(x));
    }
  }
  if (t == RW_E_F64) {
    const double x = as_f64(a);
    switch (op) {
      case RW_X_ABS: return of_f64(fabs(x));
      case RW_X_FLOOR: return of_f64(floor(x));
      case RW_X_CEIL: return of_f64(ceil(x));
      case RW_X_ROUND: return of_f64(rint(x));
      case RW_X_SQRT: return of_f64(sqrt(x));
      case RW_X_EXP: return of_f64(exp(x));
      case RW_X_LN: return of_f64(log(x));
      case RW_X_LOG10: return of_f64(log10(x));
      case RW_X_SIN: return of_f64(sin(x));
      case RW_X_COS: return of_f64(cos(x));
      default: return of_f64(tan(x));
    }
  }
  return wabs(t, a);   // integers: the lowering emits only ABS
}

constexpr int XR = 8;                  // rows a thread
constexpr int XB = 64;                 // threads a block
constexpr int XT = XB * XR;            // rows a block
constexpr unsigned XALL = (1u << XR) - 1u;
// the validity of the stack below its top: XR bits a level
using DeepBits = std::conditional_t<(XR * (RW_EXPR_MAX_DEPTH - 1) > 32),
                                    unsigned long long, unsigned>;

// A value of each of a thread's rows; bit r of `ok`: row r is not NULL.
struct Rows {
  int64_t v[XR];
  unsigned ok;
};

// bit r: row r's value is not 0
__device__ __forceinline__ unsigned truth(const Rows& x) {
  unsigned m = 0;
#pragma unroll
  for (int r = 0; r < XR; ++r) m |= unsigned(x.v[r] != 0) << r;
  return m;
}

// Row r of the thread is row0 + r x XB; bit r of `in`: that row is < n.
template <typename T>
__device__ __forceinline__ void ld_rows(const void* p, int64_t row0,
                                        unsigned in, int64_t (&v)[XR]) {
  const T* q = static_cast<const T*>(p) + row0;
#pragma unroll
  for (int r = 0; r < XR; ++r) {
    T x = T(0);
    if ((in >> r) & 1u) x = q[r * XB];
    if constexpr (sizeof(T) == 1) v[r] = x != 0;                // bool
    else if constexpr (std::is_same_v<T, float>) v[r] = of_f32(x);
    else v[r] = static_cast<int64_t>(x);
  }
}

__device__ __forceinline__ void load_rows(int t, const void* p, int64_t row0,
                                          unsigned in, int64_t (&v)[XR]) {
  switch (t) {
    case RW_E_BOOL: ld_rows<uint8_t>(p, row0, in, v); break;
    case RW_E_I16: ld_rows<int16_t>(p, row0, in, v); break;
    case RW_E_I32: ld_rows<int32_t>(p, row0, in, v); break;
    case RW_E_F32: ld_rows<float>(p, row0, in, v); break;
    default: ld_rows<int64_t>(p, row0, in, v);          // I64, F64
  }
}

__device__ __forceinline__ void store_rows(int t, void* p, int64_t row0,
                                           unsigned in, const Rows& x) {
#pragma unroll
  for (int r = 0; r < XR; ++r)
    if ((in >> r) & 1u) store(t, p, row0 + r * XB, x.v[r]);
}

// an operand from its source: an input column or the literal
__device__ __forceinline__ void leaf(const RwExprProg& p,
                                     const RwExprIns& in, int src,
                                     int64_t row0, unsigned inr, Rows& o) {
  if (src < RW_EXPR_MAX_IN) {
    load_rows(p.in_type[src], p.in[src], row0, inr, o.v);
    o.ok = XALL;
  } else {
#pragma unroll
    for (int r = 0; r < XR; ++r) o.v[r] = in.imm;
    o.ok = src == RW_SRC_LIT ? XALL : 0u;
  }
}

__device__ __forceinline__ bool binary(int op) {
  return (op >= RW_X_ADD && op <= RW_X_MOD) ||
         (op >= RW_X_EQ && op <= RW_X_OR) || op == RW_X_POW ||
         op == RW_X_TUMBLE || op == RW_X_COALESCE;
}

// arithmetic compiled for one (op, type)
template <int OP, int T>
__device__ __forceinline__ void bin(const Rows& a, const Rows& b, Rows& z) {
  unsigned ok = a.ok & b.ok;
#pragma unroll
  for (int r = 0; r < XR; ++r) {
    bool g = true;
    z.v[r] = arith(OP, T, a.v[r], b.v[r], g);
    if (!g) ok &= ~(1u << r);
  }
  z.ok = ok;
}

// floor(n / d) for 0 <= n < 2^63 and a literal d >= 1, from the host's
// m = floor(2^(63 + l) / d) + 1 and l = ceil(log2 d)
__device__ __forceinline__ uint64_t magicdiv(uint64_t n, uint64_t m, int l) {
  return l == 0 ? n : __umul64hi(n, m) >> (l - 1);
}

// integer DIV / MOD by a literal (arith's, the floor of the magnitudes
// by magicdiv; |INT_MIN| stays negative and takes floordiv)
template <int OP, int T>
__device__ __forceinline__ void bin_lit(const Rows& a, const Rows& b,
                                        Rows& z, uint64_t m, int l) {
  const int64_t s = b.v[0];                 // every row's: not 0
  const int64_t ws = wabs(T, s), ss = sgn(s);
#pragma unroll
  for (int r = 0; r < XR; ++r) {
    const int64_t x = a.v[r];
    const int64_t wa = wabs(T, x);
    const int64_t q = wa >= 0 ? static_cast<int64_t>(magicdiv(wa, m, l))
                              : floordiv(wa, ws);
    const int64_t sq = wrap(T, static_cast<uint64_t>(sgn(x) * ss) *
                                   static_cast<uint64_t>(q));
    z.v[r] = OP == RW_X_DIV
                 ? sq
                 : wrap(T, static_cast<uint64_t>(x) -
                               static_cast<uint64_t>(sq) *
                                   static_cast<uint64_t>(s));
  }
  z.ok = a.ok & b.ok;
}

// a comparison compiled for one op, on integer or float slots
template <int OP, bool FLOAT>
__device__ __forceinline__ void cmp(const Rows& a, const Rows& b, Rows& z) {
#pragma unroll
  for (int r = 0; r < XR; ++r)
    z.v[r] = compare(OP, FLOAT ? RW_E_F64 : RW_E_I64, a.v[r], b.v[r]);
  z.ok = a.ok & b.ok;
}

__device__ __forceinline__ void from_bits(unsigned m, Rows& z) {
#pragma unroll
  for (int r = 0; r < XR; ++r) z.v[r] = (m >> r) & 1u;
}

// The ops without a case of their own (the typed cases below cover the
// arithmetic, comparison and logic ops at every type the lowering
// emits), on one row, op and type at run time. `va` / `vb`: the
// operands' validity; returns the value and sets `ok`.
__device__ __forceinline__ int64_t generic(int op, int t, int param,
                                           int64_t a, int64_t b, bool va,
                                           bool vb, bool& ok) {
  ok = vb;
  switch (op) {
    case RW_X_NEG:
      return t == RW_E_F32 || t == RW_E_F64
                 ? of_f64(-as_f64(b))
                 : wrap(t, 0ull - static_cast<uint64_t>(b));
    case RW_X_CAST: return convert(t, param, b);
    case RW_X_TS2DATE:
      return wrap(RW_E_I32,
                  static_cast<uint64_t>(floordiv(b, 86400000000LL)));
    case RW_X_DATE2TS:
      return static_cast<int64_t>(static_cast<uint64_t>(b) *
                                  86400000000ull);
    case RW_X_POW:
      ok = va && vb;
      return of_f64(pow(as_f64(a), as_f64(b)));
    case RW_X_TUMBLE: {
      ok = va && vb;
      const uint64_t q = static_cast<uint64_t>(xla_floordiv(a, b));
      return static_cast<int64_t>(q * static_cast<uint64_t>(b));
    }
    case RW_X_ISNULL: ok = true; return !vb;
    case RW_X_ISNOTNULL: ok = true; return vb;
    case RW_X_COALESCE: {
      const bool take = !va && vb;
      ok = va || take;
      return take ? b : a;
    }
    default: return math1(op, t, b);   // ABS .. TAN
  }
}

// op over the rows of a (binary ops) and b; `m` the instruction's magic
__device__ __forceinline__ void compute(int op, int t, int param, uint64_t m,
                                        const Rows& a, const Rows& b,
                                        Rows& z) {
  switch (op * 8 + t) {
#define RW_LIT(OP, T) \
    case OP * 8 + T: \
      if (param) bin_lit<OP, T>(a, b, z, m, param - 1); \
      else bin<OP, T>(a, b, z); \
      return;
    RW_LIT(RW_X_DIV, RW_E_I16) RW_LIT(RW_X_DIV, RW_E_I32)
    RW_LIT(RW_X_DIV, RW_E_I64) RW_LIT(RW_X_MOD, RW_E_I16)
    RW_LIT(RW_X_MOD, RW_E_I32) RW_LIT(RW_X_MOD, RW_E_I64)
#undef RW_LIT
#define RW_BIN(OP, T) \
    case OP * 8 + T: bin<OP, T>(a, b, z); return;
#define RW_BIN_NUM(OP) \
    RW_BIN(OP, RW_E_I16) RW_BIN(OP, RW_E_I32) RW_BIN(OP, RW_E_I64) \
    RW_BIN(OP, RW_E_F32) RW_BIN(OP, RW_E_F64)
#define RW_BIN_F(OP) RW_BIN(OP, RW_E_F32) RW_BIN(OP, RW_E_F64)
    RW_BIN_NUM(RW_X_ADD) RW_BIN_NUM(RW_X_SUB) RW_BIN_NUM(RW_X_MUL)
    RW_BIN_F(RW_X_DIV) RW_BIN_F(RW_X_MOD)
#define RW_CMP(OP) \
    case OP * 8 + RW_E_BOOL: case OP * 8 + RW_E_I16: \
    case OP * 8 + RW_E_I32: case OP * 8 + RW_E_I64: \
      cmp<OP, false>(a, b, z); return; \
    case OP * 8 + RW_E_F32: case OP * 8 + RW_E_F64: \
      cmp<OP, true>(a, b, z); return;
    RW_CMP(RW_X_EQ) RW_CMP(RW_X_NE) RW_CMP(RW_X_LT) RW_CMP(RW_X_LE)
    RW_CMP(RW_X_GT) RW_CMP(RW_X_GE)
#undef RW_BIN
#undef RW_BIN_NUM
#undef RW_BIN_F
#undef RW_CMP
    case RW_X_AND * 8 + RW_E_BOOL: {
      const unsigned x = truth(a), y = truth(b);
      from_bits(x & a.ok & y & b.ok, z);
      z.ok = ((a.ok & b.ok) | (a.ok & ~x) | (b.ok & ~y)) & XALL;
      return;
    }
    case RW_X_OR * 8 + RW_E_BOOL: {
      const unsigned x = truth(a) & a.ok, y = truth(b) & b.ok;
      from_bits(x | y, z);
      z.ok = (a.ok & b.ok) | x | y;
      return;
    }
    case RW_X_NOT * 8 + RW_E_BOOL:
      from_bits(~truth(b), z);
      z.ok = b.ok;
      return;
    default: {
      unsigned ok = 0;
#pragma unroll
      for (int r = 0; r < XR; ++r) {
        bool g;
        z.v[r] = generic(op, t, param, a.v[r], b.v[r], (a.ok >> r) & 1u,
                         (b.ok >> r) & 1u, g);
        ok |= unsigned(g) << r;
      }
      z.ok = ok;
    }
  }
}

__global__ void __launch_bounds__(XB)
    k_expr_eval(const __grid_constant__ RwExprProg p, int64_t n) {
  // the stack below its top: level L of row r at deep[(L XR + r) XB + t]
  extern __shared__ int64_t deep[];
  const int t = threadIdx.x;
  const int64_t row0 = int64_t(blockIdx.x) * XT + t;
  unsigned inr = 0;
#pragma unroll
  for (int r = 0; r < XR; ++r) inr |= unsigned(row0 + r * XB < n) << r;
  // MASK: the rows' mask_in, loaded now and read at the MASK, so the
  // loads of the first instruction's columns do not wait on them
  uint8_t mk[XR];
#pragma unroll
  for (int r = 0; r < XR; ++r)
    mk[r] = p.mask_in != nullptr && (inr >> r) & 1u
                ? p.mask_in[row0 + r * XB] : uint8_t(0);
  Rows acc;                              // the top of the stack
#pragma unroll
  for (int r = 0; r < XR; ++r) acc.v[r] = 0;
  acc.ok = 0;
  DeepBits dok = 0;                      // level L's validity: bits L XR ..
  int sp = 0;                            // values on the stack
  auto spill = [&](int lv) {
#pragma unroll
    for (int r = 0; r < XR; ++r) deep[(lv * XR + r) * XB + t] = acc.v[r];
    dok = (dok & ~(DeepBits(XALL) << (lv * XR))) |
          (DeepBits(acc.ok) << (lv * XR));
  };
  auto unspill = [&](int lv, Rows& x) {
#pragma unroll
    for (int r = 0; r < XR; ++r) x.v[r] = deep[(lv * XR + r) * XB + t];
    x.ok = unsigned(dok >> (lv * XR)) & XALL;
  };
  for (int pc = 0; pc < p.n_ins; ++pc) {
    const RwExprIns in = p.ins[pc];
    const int op = in.op;
    if (op <= RW_X_NULL) {               // COL / LIT / NULL: push
      if (sp > 0) spill(sp - 1);
      leaf(p, in, in.b, row0, inr, acc);
      ++sp;
      continue;
    }
    if (op == RW_X_OUT || op == RW_X_MASK) {
      if (op == RW_X_OUT) {
        store_rows(in.t, p.out[in.param], row0, inr, acc);
      } else {
        const unsigned m = truth(acc) & acc.ok;
#pragma unroll
        for (int r = 0; r < XR; ++r)
          if ((inr >> r) & 1u)
            p.mask_out[row0 + r * XB] = mk[r] != 0 && (m >> r) & 1u;
      }
      if (--sp > 0) unspill(sp - 1, acc);
      continue;
    }
    if (op == RW_X_SELECT) {
      // (else, result, cond) with cond on top: a NULL cond is false
      Rows res, els;
      unspill(sp - 2, res);
      unspill(sp - 3, els);
      const unsigned hit = truth(acc) & acc.ok;
#pragma unroll
      for (int r = 0; r < XR; ++r)
        acc.v[r] = (hit >> r) & 1u ? res.v[r] : els.v[r];
      acc.ok = (hit & res.ok) | (~hit & els.ok & XALL);
      sp -= 2;
      continue;
    }
    // a unary op's operand is b; a binary op's are a, then b (the top)
    Rows a, b, z;
    int k = 0;                           // operands taken from the stack
    if (in.b == RW_SRC_STACK) {
      b = acc;
      k = 1;
    } else {
      leaf(p, in, in.b, row0, inr, b);
    }
    if (binary(op)) {
      if (in.a != RW_SRC_STACK) {
        leaf(p, in, in.a, row0, inr, a);
      } else if (k == 1) {
        unspill(sp - 2, a);
        k = 2;
      } else {
        a = acc;
        k = 1;
      }
    }
    compute(op, in.t, in.param, p.magic[pc], a, b, z);
    if (k == 0) {
      if (sp > 0) spill(sp - 1);
      ++sp;
    } else {
      sp -= k - 1;
    }
    acc = z;
  }
}

}  // namespace

extern "C" {

int rw_expr_eval(const RwExprProg* prog, int64_t n, void* stream) {
  if (n <= 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const size_t smem = size_t(prog->deep) * XR * XB * sizeof(int64_t);
  k_expr_eval<<<unsigned((n + XT - 1) / XT), XB, smem, st>>>(*prog, n);
  RW_CHECK(RW_S_EXPR_EVAL);
  return 0;
}

}  // extern "C"
