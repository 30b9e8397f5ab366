// Plain C interface of the expression kernel (expr_eval.cu).
//
// The same conventions as sorted_runs.h: device pointers in, enqueue on
// `stream` without synchronising, allocate nothing, and return 0 or
// `site * RW_SITE_STRIDE + cudaError` for a refused launch.
#pragma once

#include "sorted_runs.h"

// Launch site of this file, continuing `RwSortedSite2` (binding.SITES).
enum RwExprSite : int32_t {
  RW_S_EXPR_EVAL = 34,
};

#define RW_EXPR_MAX_INS 128
#define RW_EXPR_MAX_IN 16
#define RW_EXPR_MAX_OUT 16
#define RW_EXPR_MAX_DEPTH 8

// Value types (kernels/expr_eval.py T_*). On the stack every value is a
// 64-bit slot: bool 0 / 1, integers sign-extended, float32 widened
// exactly to a double, float64 as is.
enum RwExprType : int32_t {
  RW_E_BOOL = 0, RW_E_I16, RW_E_I32, RW_E_I64, RW_E_F32, RW_E_F64,
};

// Opcodes (kernels/expr_eval.py OP_*), in that order. `t` is the type an
// op computes in (CAST: the type converted to, `param` the type converted
// from); OUT's `param` is an output slot.
enum RwExprOp : int32_t {
  RW_X_COL = 0, RW_X_LIT, RW_X_NULL, RW_X_ADD, RW_X_SUB, RW_X_MUL,
  RW_X_DIV, RW_X_MOD, RW_X_NEG, RW_X_EQ, RW_X_NE, RW_X_LT, RW_X_LE,
  RW_X_GT, RW_X_GE, RW_X_AND, RW_X_OR, RW_X_NOT, RW_X_CAST, RW_X_TS2DATE,
  RW_X_DATE2TS, RW_X_ABS, RW_X_FLOOR, RW_X_CEIL, RW_X_ROUND, RW_X_SQRT,
  RW_X_EXP, RW_X_LN, RW_X_LOG10, RW_X_SIN, RW_X_COS, RW_X_TAN, RW_X_POW,
  RW_X_TUMBLE, RW_X_SELECT, RW_X_ISNULL, RW_X_ISNOTNULL, RW_X_COALESCE,
  RW_X_OUT, RW_X_MASK,
};

// Where an operand comes from (kernels/expr_eval.py SRC_*): the value
// stack, an input slot 0 .. RW_EXPR_MAX_IN - 1, or the instruction's
// literal (`imm`, of type `lt`), valid or NULL.
enum RwExprSrc : int32_t {
  RW_SRC_STACK = -1,
  RW_SRC_LIT = RW_EXPR_MAX_IN,
  RW_SRC_NULL = RW_EXPR_MAX_IN + 1,
};

// One instruction of the folded program (kernels/expr_eval.py `code`): a
// unary op's operand is `b`, a binary op's `a` then `b`; COL / LIT / NULL
// push their source `b`; SELECT, OUT and MASK take the stack's.
struct RwExprIns {
  uint8_t op;
  uint8_t t;
  int8_t a;
  int8_t b;
  int16_t param;
  uint8_t lt;
  uint8_t pad;
  int64_t imm;
};

// A lowered program with its columns, passed to the kernel by value
// (3,488 bytes of kernel parameters). `deep`: the most values the
// program keeps below the top of its stack. `magic[pc]`: for an integer
// DIV / MOD by a literal d (not 0, not the type's minimum) whose `param`
// is l + 1, l = ceil(log2 |d|): floor(2^(63 + l) / |d|) + 1.
struct RwExprProg {
  int32_t n_ins;
  int32_t n_in;
  int32_t n_out;
  int32_t deep;
  int32_t in_type[RW_EXPR_MAX_IN];
  int32_t out_type[RW_EXPR_MAX_OUT];
  const void* in[RW_EXPR_MAX_IN];
  void* out[RW_EXPR_MAX_OUT];
  const uint8_t* mask_in;   // MASK: the row mask read
  uint8_t* mask_out;        // MASK: the new row mask written
  RwExprIns ins[RW_EXPR_MAX_INS];
  uint64_t magic[RW_EXPR_MAX_INS];
};

#ifdef __cplusplus
extern "C" {
#endif

// Run `prog` over rows [0, n): a thread runs every instruction over its
// eight rows, on a stack of at most RW_EXPR_MAX_DEPTH (value, valid)
// pairs, writing each OUT's value to its output column and a MASK's
// `mask_in & value & valid` to mask_out.
int rw_expr_eval(const RwExprProg* prog, int64_t n, void* stream);

#ifdef __cplusplus
}
#endif
