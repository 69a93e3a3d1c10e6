// Merge op codes shared by the coo_expand and merge_join kernels.
//
// A merge f(x, y) reaches a kernel as a code built on the host by
// repro_torch/kernels/merge_codes.py:
//   MERGE_BILINEAR: c0 + cx*x + cy*y + cxy*(x*y); a zero coefficient drops
//                   its term, so x*y is one multiply and x+y one add, as in
//                   the plain PyTorch versions;
//   MERGE_SAFE_DIV: x == 0 ? 0 : x / (y == 0 ? 1 : y);
//   MERGE_PROGRAM:  any other merge of the compiler's op set, as a register
//                   program (struct MergeProgram) that the kernels' program
//                   instances run with the interpreter below.
// The first two are a MergeCode; a program is a MergeProgram. Either is a
// kernel parameter passed by value, so launches on two streams with two
// programs never share state.
#pragma once

#include <cuda_runtime.h>

#define MERGE_BILINEAR 0
#define MERGE_SAFE_DIV 1
#define MERGE_PROGRAM 2

struct MergeCode {
  int op;
  double c0, cx, cy, cxy;
};

// The merge with its coefficients converted to T once, for a loop of
// merges.
template <typename T>
struct TypedMerge {
  int op;
  bool hx, hy, hxy;
  T c0, cx, cy, cxy;
  __device__ explicit TypedMerge(const MergeCode& m)
      : op(m.op), hx(m.cx != 0.0), hy(m.cy != 0.0), hxy(m.cxy != 0.0),
        c0(T(m.c0)), cx(T(m.cx)), cy(T(m.cy)), cxy(T(m.cxy)) {}
  __device__ __forceinline__ T operator()(T x, T y) const {
    if (op == MERGE_SAFE_DIV) {
      return x == T(0) ? T(0) : x / (y == T(0) ? T(1) : y);
    }
    T r = c0;
    if (hx) r = r + cx * x;
    if (hy) r = r + cy * y;
    if (hxy) r = r + cxy * (x * y);
    return r;
  }
};

template <typename T>
__device__ __forceinline__ T apply_merge(const MergeCode& m, T x, T y) {
  return TypedMerge<T>(m)(x, y);
}

// ---------------------------------------------------------------------------
// Merge programs (MERGE_PROGRAM)
//
// A program is n <= kProgCode instructions over kProgRegs registers of the
// value type T, x in r0 and y in r1 at the start, the result in r0 at the
// end. An instruction is one 32-bit word:
//   bits 0-5 the op (PROG_*), 6-8 the destination register, then three
//   5-bit operand slots at 9, 14 and 19: slot s < kProgRegs is register s,
//   slot kProgRegs + k the constant k (kept in double on the host,
//   converted to T once a CTA).
// Booleans are 0/1 in T. The ops follow what torch computes on the card:
// + - * / and sqrt correctly rounded (the __*_rn intrinsics, never
// contracted into an FMA); maximum/minimum propagate NaN and otherwise
// take fmax/fmin; clamp by a constant keeps NaN in x and takes fmax/fmin
// of the bound; sign is (0 < a) - (a < 0), 0 for NaN and +0 for -0;
// sigmoid is 1 / (1 + exp(-a)); the transcendentals are CUDA's math
// library (expf, logf, log1pf, expm1f, tanhf, powf, rsqrtf and their
// double forms), as torch's CUDA kernels call them.
// ---------------------------------------------------------------------------

constexpr int kProgCode = 32;
constexpr int kProgRegs = 8;
constexpr int kProgConsts = 16;

struct MergeProgram {
  int n;
  unsigned code[kProgCode];
  double consts[kProgConsts];
};

enum ProgOp {
  PROG_MOV, PROG_ADD, PROG_SUB, PROG_MUL, PROG_DIV, PROG_NEG, PROG_ABS,
  PROG_LT, PROG_LE, PROG_GT, PROG_GE, PROG_EQ, PROG_NE, PROG_AND, PROG_OR,
  PROG_NOT, PROG_WHERE, PROG_MAX, PROG_MIN, PROG_CLAMP_MIN, PROG_CLAMP_MAX,
  PROG_SIGN, PROG_EXP, PROG_LOG, PROG_LOG1P, PROG_EXPM1, PROG_SQRT,
  PROG_RSQRT, PROG_TANH, PROG_SIGMOID, PROG_POW
};

__device__ __forceinline__ float add_rn(float a, float b) {
  return __fadd_rn(a, b);
}
__device__ __forceinline__ double add_rn(double a, double b) {
  return __dadd_rn(a, b);
}
__device__ __forceinline__ float sub_rn(float a, float b) {
  return __fsub_rn(a, b);
}
__device__ __forceinline__ double sub_rn(double a, double b) {
  return __dsub_rn(a, b);
}
__device__ __forceinline__ float mul_rn(float a, float b) {
  return __fmul_rn(a, b);
}
__device__ __forceinline__ double mul_rn(double a, double b) {
  return __dmul_rn(a, b);
}
__device__ __forceinline__ float div_rn(float a, float b) {
  return __fdiv_rn(a, b);
}
__device__ __forceinline__ double div_rn(double a, double b) {
  return __ddiv_rn(a, b);
}
__device__ __forceinline__ float sqrt_rn(float a) { return __fsqrt_rn(a); }
__device__ __forceinline__ double sqrt_rn(double a) { return __dsqrt_rn(a); }

// CUDA's math library by value type, named apart from the C overloads
#define PROG_MATH(name, f32, f64)                                         \
  __device__ __forceinline__ float name(float a) { return f32(a); }       \
  __device__ __forceinline__ double name(double a) { return f64(a); }
PROG_MATH(m_abs, fabsf, fabs)
PROG_MATH(m_exp, expf, exp)
PROG_MATH(m_log, logf, log)
PROG_MATH(m_log1p, log1pf, log1p)
PROG_MATH(m_expm1, expm1f, expm1)
PROG_MATH(m_rsqrt, rsqrtf, rsqrt)
PROG_MATH(m_tanh, tanhf, tanh)
#undef PROG_MATH
__device__ __forceinline__ float m_max(float a, float b) {
  return fmaxf(a, b);
}
__device__ __forceinline__ double m_max(double a, double b) {
  return fmax(a, b);
}
__device__ __forceinline__ float m_min(float a, float b) {
  return fminf(a, b);
}
__device__ __forceinline__ double m_min(double a, double b) {
  return fmin(a, b);
}
__device__ __forceinline__ float m_pow(float a, float b) { return powf(a, b); }
__device__ __forceinline__ double m_pow(double a, double b) {
  return pow(a, b);
}

// One instruction's op on its operands (a warp-uniform switch).
template <typename T>
__device__ __forceinline__ T prog_op(unsigned op, T a, T b, T c) {
  const T one = T(1), zero = T(0);
  switch (op) {
    case PROG_MOV: return a;
    case PROG_ADD: return add_rn(a, b);
    case PROG_SUB: return sub_rn(a, b);
    case PROG_MUL: return mul_rn(a, b);
    case PROG_DIV: return div_rn(a, b);
    case PROG_NEG: return -a;
    case PROG_ABS: return m_abs(a);
    case PROG_LT: return a < b ? one : zero;
    case PROG_LE: return a <= b ? one : zero;
    case PROG_GT: return a > b ? one : zero;
    case PROG_GE: return a >= b ? one : zero;
    case PROG_EQ: return a == b ? one : zero;
    case PROG_NE: return a != b ? one : zero;
    case PROG_AND: return (a != zero && b != zero) ? one : zero;
    case PROG_OR: return (a != zero || b != zero) ? one : zero;
    case PROG_NOT: return a == zero ? one : zero;
    case PROG_WHERE: return a != zero ? b : c;
    // a != a: NaN
    case PROG_MAX: return a != a ? a : (b != b ? b : m_max(a, b));
    case PROG_MIN: return a != a ? a : (b != b ? b : m_min(a, b));
    case PROG_CLAMP_MIN: return a != a ? a : m_max(a, b);
    case PROG_CLAMP_MAX: return a != a ? a : m_min(a, b);
    case PROG_SIGN: return T(zero < a) - T(a < zero);
    case PROG_EXP: return m_exp(a);
    case PROG_LOG: return m_log(a);
    case PROG_LOG1P: return m_log1p(a);
    case PROG_EXPM1: return m_expm1(a);
    case PROG_SQRT: return sqrt_rn(a);
    case PROG_RSQRT: return m_rsqrt(a);
    case PROG_TANH: return m_tanh(a);
    case PROG_SIGMOID: return div_rn(one, add_rn(one, m_exp(-a)));
    case PROG_POW: return m_pow(a, b);
    default: return zero;  // the host emits no other op
  }
}

// A program in shared memory, loaded once a CTA from the kernel parameter.
// Every thread runs the same instruction stream, so the op switch never
// diverges. The registers are a fixed array indexed only by compile-time
// constants (each operand and the destination go through an unrolled
// select), so they stay in registers and never reach local memory.
template <typename T>
struct SharedProgram {
  int n;
  unsigned code[kProgCode];
  T k[kProgConsts];

  // Called by one thread; the caller synchronises before the first use.
  __device__ __forceinline__ void load(const MergeProgram& p) {
    n = p.n;
#pragma unroll
    for (int i = 0; i < kProgCode; ++i) code[i] = p.code[i];
#pragma unroll
    for (int i = 0; i < kProgConsts; ++i) k[i] = T(p.consts[i]);
  }

  __device__ __forceinline__ T operand(const T (&r)[kProgRegs],
                                       unsigned s) const {
    if (s >= kProgRegs) return k[s - kProgRegs];
    T v = r[0];
#pragma unroll
    for (int q = 1; q < kProgRegs; ++q)
      if (s == (unsigned)q) v = r[q];
    return v;
  }

  __device__ __forceinline__ T operator()(T x, T y) const {
    T r[kProgRegs];
    r[0] = x;
    r[1] = y;
#pragma unroll
    for (int q = 2; q < kProgRegs; ++q) r[q] = T(0);
    for (int pc = 0; pc < n; ++pc) {
      const unsigned w = code[pc];
      const T v = prog_op<T>(w & 63u, operand(r, (w >> 9) & 31u),
                             operand(r, (w >> 14) & 31u),
                             operand(r, (w >> 19) & 31u));
      const unsigned d = (w >> 6) & 7u;
#pragma unroll
      for (int q = 0; q < kProgRegs; ++q)
        if (d == (unsigned)q) r[q] = v;
    }
    return r[0];
  }
};

// W values in a vector held in registers, read and written at a run-time
// index k < W through an unrolled select (no local memory).
template <int W, typename T>
__device__ __forceinline__ T lane_get(const T* v, int k) {
  T out = v[0];
#pragma unroll
  for (int q = 1; q < W; ++q)
    if (k == q) out = v[q];
  return out;
}
template <int W, typename T>
__device__ __forceinline__ void lane_set(T* v, int k, T x) {
#pragma unroll
  for (int q = 0; q < W; ++q)
    if (k == q) v[q] = x;
}
