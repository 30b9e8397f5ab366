// Hand-written CUDA kernel (sm_90a) for the expression layer's device
// pass: every `eval_device` of risingwave_tpu/expr/expression.py
// (FunctionCall :156, Case :225, IsNull :262, Coalesce :294) over the
// device halves of risingwave_tpu/expr/functions.py (:113-147, :196,
// :232-242, :331-343, :737-741, :806-809, :861-866, :881-883).
//
//   Map / Filter / join condition -> rw_expr_eval  one thread a row
//
// In the JAX package a node's expression list is jnp code that XLA fuses
// into the epoch program: one elementwise pass. Here the host lowers the
// list once into a postfix program (kernels/expr_eval.py); the program
// rides in the kernel's parameters (__grid_constant__: every thread
// reads the same instruction, so dispatch is uniform across a warp), and
// each thread runs it over its row on a register stack of (64-bit value,
// valid bit) pairs: a push or pop shifts the stack, so every index is a
// constant and the stack stays in registers. Each input column is read
// from device memory once a row (a second reference of a column hits
// L1), each output written once, nothing else touches memory: at 2^20
// rows q2c's filter moves 10 MB, ~3 µs at 3.35 TB/s, and the
// interpretation (about ten instructions of a few dozen each) is of the
// same order. Simple first: one row a thread, no vector loads.
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

#include "rw_common.cuh"

namespace {

constexpr int D = RW_EXPR_MAX_DEPTH;

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

__device__ __forceinline__ int64_t load(int t, const void* p, int64_t i) {
  switch (t) {
    case RW_E_BOOL: return static_cast<const uint8_t*>(p)[i] != 0;
    case RW_E_I16: return static_cast<const int16_t*>(p)[i];
    case RW_E_I32: return static_cast<const int32_t*>(p)[i];
    case RW_E_F32: return of_f32(static_cast<const float*>(p)[i]);
    default: return static_cast<const int64_t*>(p)[i];   // I64, F64
  }
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
      const int64_t q = floordiv(wabs(t, a), wabs(t, s));
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

// The register stack: x[0] / bit 0 of `ok` is the top. Every index below
// is a constant once the loops unroll.
struct Stack {
  int64_t x[D];
  uint32_t ok;

  __device__ __forceinline__ void push(int64_t v, bool valid) {
#pragma unroll
    for (int k = D - 1; k > 0; --k) x[k] = x[k - 1];
    x[0] = v;
    ok = (ok << 1) | uint32_t(valid);
  }
  // replace the top `n` values by one
  template <int N>
  __device__ __forceinline__ void reduce(int64_t v, bool valid) {
    x[0] = v;
#pragma unroll
    for (int k = 1; k + N - 1 < D; ++k) x[k] = x[k + N - 1];
    ok = ((ok >> N) << 1) | uint32_t(valid);
  }
  __device__ __forceinline__ void pop() {
#pragma unroll
    for (int k = 0; k + 1 < D; ++k) x[k] = x[k + 1];
    ok >>= 1;
  }
  __device__ __forceinline__ bool valid(int k) const { return ok >> k & 1u; }
};

__global__ void __launch_bounds__(BLOCK)
    k_expr_eval(const __grid_constant__ RwExprProg p, int64_t n) {
  const int64_t i = int64_t(blockIdx.x) * BLOCK + threadIdx.x;
  if (i >= n) return;
  Stack s;
#pragma unroll
  for (int k = 0; k < D; ++k) s.x[k] = 0;
  s.ok = 0;
  for (int pc = 0; pc < p.n_ins; ++pc) {
    const int op = p.ins[pc].op;
    const int t = p.ins[pc].t;
    const int64_t imm = p.ins[pc].imm;
    switch (op) {
      case RW_X_COL: s.push(load(t, p.in[imm], i), true); break;
      case RW_X_LIT: s.push(imm, true); break;
      case RW_X_NULL: s.push(imm, false); break;
      case RW_X_ADD: case RW_X_SUB: case RW_X_MUL: case RW_X_DIV:
      case RW_X_MOD: {
        bool ok = true;
        const int64_t v = arith(op, t, s.x[1], s.x[0], ok);
        s.reduce<2>(v, ok && s.valid(0) && s.valid(1));
        break;
      }
      case RW_X_NEG:
        s.reduce<1>(t == RW_E_F32 || t == RW_E_F64
                        ? of_f64(-as_f64(s.x[0]))
                        : wrap(t, 0ull - static_cast<uint64_t>(s.x[0])),
                    s.valid(0));
        break;
      case RW_X_EQ: case RW_X_NE: case RW_X_LT: case RW_X_LE: case RW_X_GT:
      case RW_X_GE:
        s.reduce<2>(compare(op, t, s.x[1], s.x[0]),
                    s.valid(0) && s.valid(1));
        break;
      case RW_X_AND: case RW_X_OR: {
        const bool a = s.x[1] != 0, b = s.x[0] != 0;
        const bool va = s.valid(1), vb = s.valid(0);
        const bool ta = a && va, tb = b && vb;
        if (op == RW_X_AND)
          s.reduce<2>(ta && tb, (va && vb) || (va && !a) || (vb && !b));
        else
          s.reduce<2>(ta || tb, (va && vb) || ta || tb);
        break;
      }
      case RW_X_NOT: s.reduce<1>(s.x[0] == 0, s.valid(0)); break;
      case RW_X_CAST:
        s.reduce<1>(convert(t, int(imm), s.x[0]), s.valid(0));
        break;
      case RW_X_TS2DATE:
        s.reduce<1>(wrap(RW_E_I32, static_cast<uint64_t>(
                                       floordiv(s.x[0], 86400000000LL))),
                    s.valid(0));
        break;
      case RW_X_DATE2TS:
        s.reduce<1>(static_cast<int64_t>(static_cast<uint64_t>(s.x[0]) *
                                         86400000000ull),
                    s.valid(0));
        break;
      case RW_X_ABS: case RW_X_FLOOR: case RW_X_CEIL: case RW_X_ROUND:
      case RW_X_SQRT: case RW_X_EXP: case RW_X_LN: case RW_X_LOG10:
      case RW_X_SIN: case RW_X_COS: case RW_X_TAN:
        s.reduce<1>(math1(op, t, s.x[0]), s.valid(0));
        break;
      case RW_X_POW:
        s.reduce<2>(of_f64(pow(as_f64(s.x[1]), as_f64(s.x[0]))),
                    s.valid(0) && s.valid(1));
        break;
      case RW_X_TUMBLE: {
        const int64_t w = s.x[0];
        const uint64_t q = static_cast<uint64_t>(xla_floordiv(s.x[1], w));
        s.reduce<2>(static_cast<int64_t>(q * static_cast<uint64_t>(w)),
                    s.valid(0) && s.valid(1));
        break;
      }
      case RW_X_SELECT: {
        // (else, result, cond) with cond on top: a NULL cond is false
        const bool hit = s.valid(0) && s.x[0] != 0;
        s.reduce<3>(hit ? s.x[1] : s.x[2], hit ? s.valid(1) : s.valid(2));
        break;
      }
      case RW_X_ISNULL: s.reduce<1>(!s.valid(0), true); break;
      case RW_X_ISNOTNULL: s.reduce<1>(s.valid(0), true); break;
      case RW_X_COALESCE: {
        const bool take = !s.valid(1) && s.valid(0);
        s.reduce<2>(take ? s.x[0] : s.x[1], s.valid(1) || take);
        break;
      }
      case RW_X_OUT:
        store(t, p.out[imm], i, s.x[0]);
        s.pop();
        break;
      default:   // RW_X_MASK
        p.mask_out[i] = p.mask_in[i] & uint8_t(s.valid(0) && s.x[0] != 0);
        s.pop();
    }
  }
}

}  // namespace

extern "C" {

int rw_expr_eval(const RwExprProg* prog, int64_t n, void* stream) {
  if (n <= 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  k_expr_eval<<<blocks_of(n), BLOCK, 0, st>>>(*prog, n);
  RW_CHECK(RW_S_EXPR_EVAL);
  return 0;
}

}  // extern "C"
