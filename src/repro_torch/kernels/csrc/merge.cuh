// Merges as the coo_expand and merge_join kernels evaluate them.
//
// A merge f(x, y) reaches a kernel in one of two forms, both built on the
// host by repro_torch/kernels/merge_codes.py:
//   a code (struct MergeCode), evaluated by the main library's instances:
//     MERGE_BILINEAR: c0 + cx*x + cy*y + cxy*(x*y); a zero coefficient
//                     drops its term, so x*y is one multiply and x+y one
//                     add, as in the plain PyTorch versions;
//     MERGE_SAFE_DIV: x == 0 ? 0 : x / (y == 0 ? 1 : y);
//   any other merge as C++ emitted from its trace: a functor
//   Merge<T>{}(x, y) that calls the op helpers below, compiled at first use
//   into its own instances of both kernels (kernels/build.py), so nvcc
//   inlines the merge into the kernel body.
//
// The op helpers follow what torch computes, op by op; each is
// __host__ __device__ so that the CPU tests compile the same emitted
// function with g++ (-ffp-contract=off) and hold it to torch on the CPU.
// On the device:
//   + - * / and sqrt are correctly rounded (the __*_rn intrinsics): nvcc
//   would otherwise contract a product and a sum of two torch ops into one
//   FMA, which torch, one kernel an op, never does; add/sub with alpha is
//   the FMA that torch's own kernel computes;
//   maximum/minimum propagate NaN and otherwise take fmax/fmin; clamp by a
//   constant keeps NaN in x and takes fmax/fmin of the bound (by a tensor
//   it is maximum/minimum, chosen on the host);
//   sign is (0 < a) - (a < 0): 0 for NaN, +0 for -0;
//   sigmoid is 1 / (1 + exp(-a)); remainder, floor division and integer
//   pow are c10's / ATen's formulas (remainder from fmod, floor division
//   per c10::div_floor_floating / div_floor_integer, powi);
//   round is half to even (nearbyint);
//   the transcendentals are CUDA's math library (expf, erff, sinf, powf,
//   lgammaf, erfinvf, ... and their double forms), as torch's CUDA kernels
//   call them; the special functions torch computes by its own formulas
//   (digamma, ndtri, log_ndtr, i0, i1, ...) and the activations are
//   merge_special.cuh's ports of torch's kernels, one body for each op,
//   FMA-contracted by nvcc as torch's are.
// On the host the same formulas in plain C++, except where torch's CPU
// kernels decide otherwise: maximum/minimum and clamp return x86
// maxps/minps's operand on a tie of zeros, fmax/fmin the first; erfinv,
// digamma and i1 are ATen/native/Math.h's CPU forms.
// float16 and bfloat16 values are held in float and rounded to their type
// after each op (r_f16, r_bf16: on the host by bits, round to nearest
// even with subnormals, overflow to inf, NaN kept; on the device by the
// PTX conversions), as torch computes them in float32 and stores the
// rounded result.
// Integer ops of every width wrap (two's complement) and never trap: a
// division by zero gives 0 (torch on the CPU raises there; the card's
// kernels give garbage), the most negative value / -1 gives itself.
// A float that is NaN, infinite or out of range has no C++ conversion to
// an integer, and torch gives a different answer on each side (f2i): the
// device helper compiles the static_cast torch CUDA's kernels compile
// (the PTX conversion saturates, NaN gives 0), and the card holds it to
// torch CUDA; the host helper gives what torch gives on an x86 CPU (the
// type's most negative value for int32/int64, int8/int16 cut from that
// int32, uint8 from the int64). bool of a float is a != 0 (NaN is true).
#pragma once

#include <cmath>
#include <cstdint>
#include <cstring>
#include <type_traits>

#ifdef __CUDACC__
#include <cuda_runtime.h>
#define MERGE_HD __host__ __device__ __forceinline__
#else
#define MERGE_HD inline
#endif

#define MERGE_BILINEAR 0
#define MERGE_SAFE_DIV 1

struct MergeCode {
  int op;
  double c0, cx, cy, cxy;
};

#ifdef __CUDACC__
// The code with its coefficients converted to T once, for a loop of
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

// The functor a kernel calls for its merge parameter: a code's TypedMerge,
// a generated merge as it is.
template <typename T>
__device__ __forceinline__ TypedMerge<T> device_merge(const MergeCode& m) {
  return TypedMerge<T>(m);
}
template <typename T, typename F>
__device__ __forceinline__ const F& device_merge(const F& f) {
  return f;
}
#endif

// ---------------------------------------------------------------------------
// Bits, constants and predicates
// ---------------------------------------------------------------------------

MERGE_HD float f32_bits(uint32_t u) {
#ifdef __CUDA_ARCH__
  return __uint_as_float(u);
#else
  float f;
  std::memcpy(&f, &u, 4);
  return f;
#endif
}
MERGE_HD double f64_bits(uint64_t u) {
#ifdef __CUDA_ARCH__
  return __longlong_as_double((long long)u);
#else
  double f;
  std::memcpy(&f, &u, 8);
  return f;
#endif
}
MERGE_HD bool m_signbit(float a) {
#ifdef __CUDA_ARCH__
  return __float_as_uint(a) >> 31;
#else
  uint32_t u;
  std::memcpy(&u, &a, 4);
  return u >> 31;
#endif
}
MERGE_HD bool m_signbit(double a) {
#ifdef __CUDA_ARCH__
  return (unsigned long long)__double_as_longlong(a) >> 63;
#else
  uint64_t u;
  std::memcpy(&u, &a, 8);
  return u >> 63;
#endif
}
MERGE_HD float inf_of(float) { return f32_bits(0x7f800000u); }
MERGE_HD double inf_of(double) { return f64_bits(0x7ff0000000000000ull); }

typedef signed char i8;
typedef unsigned char u8;
typedef short i16;
typedef int i32;
typedef long long i64;
typedef unsigned long long u64;

// ---------------------------------------------------------------------------
// Correctly rounded arithmetic, never contracted
// ---------------------------------------------------------------------------

#ifdef __CUDA_ARCH__
#define MERGE_RN(name, f32, f64, op)                                      \
  MERGE_HD float name(float a, float b) { return f32(a, b); }             \
  MERGE_HD double name(double a, double b) { return f64(a, b); }
#else
#define MERGE_RN(name, f32, f64, op)                                      \
  MERGE_HD float name(float a, float b) { return a op b; }                \
  MERGE_HD double name(double a, double b) { return a op b; }
#endif
MERGE_RN(add_rn, __fadd_rn, __dadd_rn, +)
MERGE_RN(sub_rn, __fsub_rn, __dsub_rn, -)
MERGE_RN(mul_rn, __fmul_rn, __dmul_rn, *)
MERGE_RN(div_rn, __fdiv_rn, __ddiv_rn, /)
#undef MERGE_RN

MERGE_HD float sqrt_rn(float a) {
#ifdef __CUDA_ARCH__
  return __fsqrt_rn(a);
#else
  return std::sqrt(a);
#endif
}
MERGE_HD double sqrt_rn(double a) {
#ifdef __CUDA_ARCH__
  return __dsqrt_rn(a);
#else
  return std::sqrt(a);
#endif
}
template <typename T> MERGE_HD T m_sqrt(T a) { return sqrt_rn(a); }
// a + alpha * b rounded once, as torch's add with alpha computes it
MERGE_HD float fma_rn(float a, float b, float c) { return fmaf(a, b, c); }
MERGE_HD double fma_rn(double a, double b, double c) { return fma(a, b, c); }

// ---------------------------------------------------------------------------
// The math library by value type, named apart from the C overloads
// ---------------------------------------------------------------------------

#define MERGE_MATH1(name, f32, f64)                                       \
  MERGE_HD float name(float a) { return f32(a); }                         \
  MERGE_HD double name(double a) { return f64(a); }
MERGE_MATH1(m_fabs, fabsf, fabs)
MERGE_MATH1(m_exp, expf, exp)
MERGE_MATH1(m_exp2, exp2f, exp2)
MERGE_MATH1(m_expm1, expm1f, expm1)
MERGE_MATH1(m_log, logf, log)
MERGE_MATH1(m_log2, log2f, log2)
MERGE_MATH1(m_log10, log10f, log10)
MERGE_MATH1(m_log1p, log1pf, log1p)
MERGE_MATH1(m_erf, erff, erf)
MERGE_MATH1(m_erfc, erfcf, erfc)
MERGE_MATH1(m_sin, sinf, sin)
MERGE_MATH1(m_cos, cosf, cos)
MERGE_MATH1(m_tan, tanf, tan)
MERGE_MATH1(m_asin, asinf, asin)
MERGE_MATH1(m_acos, acosf, acos)
MERGE_MATH1(m_atan, atanf, atan)
MERGE_MATH1(m_sinh, sinhf, sinh)
MERGE_MATH1(m_cosh, coshf, cosh)
MERGE_MATH1(m_tanh, tanhf, tanh)
MERGE_MATH1(m_asinh, asinhf, asinh)
MERGE_MATH1(m_acosh, acoshf, acosh)
MERGE_MATH1(m_atanh, atanhf, atanh)
MERGE_MATH1(m_floor, floorf, floor)
MERGE_MATH1(m_ceil, ceilf, ceil)
MERGE_MATH1(m_trunc, truncf, trunc)
MERGE_MATH1(m_round, nearbyintf, nearbyint)   // half to even
#undef MERGE_MATH1
#define MERGE_MATH2(name, f32, f64)                                       \
  MERGE_HD float name(float a, float b) { return f32(a, b); }             \
  MERGE_HD double name(double a, double b) { return f64(a, b); }
MERGE_MATH2(m_pow, powf, pow)
MERGE_MATH2(m_fmod, fmodf, fmod)
MERGE_MATH2(m_atan2, atan2f, atan2)
MERGE_MATH2(m_hypot, hypotf, hypot)
MERGE_MATH2(m_copysign, copysignf, copysign)
#ifdef __CUDA_ARCH__
MERGE_MATH2(m_fmax, fmaxf, fmax)
MERGE_MATH2(m_fmin, fminf, fmin)
#else
// torch.fmax / fmin on the CPU: a NaN operand is ignored, a tie of zeros
// gives the first operand
template <typename T> MERGE_HD T m_fmax(T a, T b) {
  return (b != b || a >= b) ? a : b;
}
template <typename T> MERGE_HD T m_fmin(T a, T b) {
  return (b != b || a <= b) ? a : b;
}
#endif
#undef MERGE_MATH2

template <typename T> MERGE_HD bool m_isinf(T a) {
  return m_fabs(a) == inf_of(a);
}
template <typename T> MERGE_HD bool m_isfinite(T a) {
  return m_fabs(a) < inf_of(a);     // false for NaN
}

#ifdef __CUDA_ARCH__
MERGE_HD float m_rsqrt(float a) { return rsqrtf(a); }
MERGE_HD double m_rsqrt(double a) { return rsqrt(a); }
#else
MERGE_HD float m_rsqrt(float a) { return 1.0f / std::sqrt(a); }
MERGE_HD double m_rsqrt(double a) { return 1.0 / std::sqrt(a); }
#endif

// ---------------------------------------------------------------------------
// Ops whose torch rule needs more than an operator
// ---------------------------------------------------------------------------

// torch.maximum / minimum: NaN propagates
template <typename T> MERGE_HD T nan_max(T a, T b) {
#ifdef __CUDA_ARCH__
  return a != a ? a : (b != b ? b : m_fmax(a, b));
#else
  return a != a ? a : (b != b ? b : (a > b ? a : b));
#endif
}
template <typename T> MERGE_HD T nan_min(T a, T b) {
#ifdef __CUDA_ARCH__
  return a != a ? a : (b != b ? b : m_fmin(a, b));
#else
  return a != a ? a : (b != b ? b : (a < b ? a : b));
#endif
}
// torch.clamp by a constant bound: NaN in a stays, a NaN bound is ignored
template <typename T> MERGE_HD T clamp_min(T a, T lo) {
#ifdef __CUDA_ARCH__
  return a != a ? a : m_fmax(a, lo);
#else
  return lo > a ? lo : a;
#endif
}
template <typename T> MERGE_HD T clamp_max(T a, T hi) {
#ifdef __CUDA_ARCH__
  return a != a ? a : m_fmin(a, hi);
#else
  return hi < a ? hi : a;
#endif
}
template <typename T> MERGE_HD T sign_of(T a) {
  return T(T(0) < a) - T(a < T(0));
}
template <typename T> MERGE_HD T sigmoid(T a) {
  return div_rn(T(1), add_rn(T(1), m_exp(-a)));
}
// torch.remainder: the result takes the divisor's sign (named apart from
// C's IEEE remainder)
template <typename T> MERGE_HD T m_remainder(T a, T b) {
  T mod = m_fmod(a, b);
  if (mod != T(0) && (b < T(0)) != (mod < T(0))) mod = add_rn(mod, b);
  return mod;
}
// torch.floor_divide, div(rounding_mode="floor"): c10::div_floor_floating
template <typename T> MERGE_HD T floor_div(T a, T b) {
  if (b == T(0)) return div_rn(a, b);
  const T mod = m_fmod(a, b);
  T div = div_rn(sub_rn(a, mod), b);
  if (mod != T(0) && (b < T(0)) != (mod < T(0))) div = sub_rn(div, T(1));
  if (div == T(0)) return m_copysign(T(0), div_rn(a, b));
  T fl = m_floor(div);
  if (sub_rn(div, fl) > T(0.5)) fl = add_rn(fl, T(1));
  return fl;
}

// Integers of every width: wrapping (two's complement, computed in 64
// bits and cut to the type), never trapping
template <typename I> MERGE_HD I i_add(I a, I b) { return (I)((u64)a + (u64)b); }
template <typename I> MERGE_HD I i_sub(I a, I b) { return (I)((u64)a - (u64)b); }
template <typename I> MERGE_HD I i_mul(I a, I b) { return (I)((u64)a * (u64)b); }
template <typename I> MERGE_HD I i_neg(I a) { return (I)(0ull - (u64)a); }
template <typename I> MERGE_HD I i_abs(I a) { return a < I(0) ? i_neg(a) : a; }
template <typename I> MERGE_HD I i_max(I a, I b) { return a > b ? a : b; }
template <typename I> MERGE_HD I i_min(I a, I b) { return a < b ? a : b; }
// the most negative value of I (0 for an unsigned I)
template <typename I> MERGE_HD I i_lowest() {
  return std::is_signed<I>::value ? (I)(1ull << (8 * sizeof(I) - 1)) : I(0);
}
template <typename I> MERGE_HD bool i_bad_div(I a, I b) {
  return b == I(0) || (std::is_signed<I>::value && b == I(-1)
                       && a == i_lowest<I>());
}
template <typename I> MERGE_HD I trunc_div(I a, I b) {
  return b == I(0) ? I(0) : (i_bad_div(a, b) ? a : (I)(a / b));
}
template <typename I> MERGE_HD I i_fmod(I a, I b) {
  return i_bad_div(a, b) ? I(0) : (I)(a % b);
}
// c10::div_floor_integer
template <typename I> MERGE_HD I i_floor_div(I a, I b) {
  if (b == I(0)) return I(0);
  if (i_bad_div(a, b)) return a;
  const I q = (I)(a / b), r = (I)(a % b);
  return (r != I(0) && ((a < I(0)) != (b < I(0)))) ? (I)(q - 1) : q;
}
template <typename I> MERGE_HD I i_remainder(I a, I b) {
  I mod = i_fmod(a, b);
  if (mod != I(0) && (b < I(0)) != (mod < I(0))) mod = i_add(mod, b);
  return mod;
}
// ATen's powi
template <typename I> MERGE_HD I i_pow(I a, I b) {
  if (b < I(0)) {
    if (a == I(1)) return I(1);
    if (a == I(-1)) return (b & I(1)) ? I(-1) : I(1);
    return I(0);
  }
  I r = 1;
  while (b) {
    if (b & I(1)) r = i_mul(r, a);
    b = (I)(b / 2);
    a = i_mul(a, a);
  }
  return r;
}
// torch.bitwise_left_shift / right_shift: a shift by a negative count or
// by the width or more gives 0 (left) or the sign (right)
template <typename I> MERGE_HD I i_shl(I a, I b) {
  if (b < I(0) || (u64)b >= 8 * sizeof(I)) return I(0);
  return (I)((u64)a << (int)b);
}
template <typename I> MERGE_HD I i_shr(I a, I b) {
  const int most = 8 * sizeof(I) - (std::is_signed<I>::value ? 1 : 0);
  if (b < I(0) || (u64)b >= (u64)most) return (I)(a >> most);
  return (I)(a >> (int)b);
}
// torch.gcd / lcm (ATen's calc_gcd; never trapping)
template <typename I> MERGE_HD I i_gcd(I a, I b) {
  a = i_abs(a);
  b = i_abs(b);
  while (a != I(0)) {
    const I c = a;
    a = i_fmod(b, a);
    b = c;
  }
  return b;
}
template <typename I> MERGE_HD I i_lcm(I a, I b) {
  const I g = i_gcd(a, b);
  return g == I(0) ? I(0) : i_abs(i_mul(trunc_div(a, g), b));
}

// ---------------------------------------------------------------------------
// Casts
// ---------------------------------------------------------------------------

// float16 and bfloat16 values are held in float, rounded to their type
// after each op (torch computes them in float32, its "opmath", and stores
// the rounded result); round to nearest even, subnormals, overflow to inf
#ifdef __CUDA_ARCH__
MERGE_HD float r_f16(float a) {
  unsigned short h;
  float r;
  asm("cvt.rn.f16.f32 %0, %1;" : "=h"(h) : "f"(a));
  asm("cvt.f32.f16 %0, %1;" : "=f"(r) : "h"(h));
  return r;
}
MERGE_HD float r_bf16(float a) {
  unsigned short h;
  asm("cvt.rn.bf16.f32 %0, %1;" : "=h"(h) : "f"(a));
  return __uint_as_float((uint32_t)h << 16);
}
#else
MERGE_HD uint32_t f32_to_bits(float a) {
  uint32_t u;
  std::memcpy(&u, &a, 4);
  return u;
}
// the FP16 library's fp16_ieee_from_fp32_value, then back to float
MERGE_HD float r_f16(float f) {
  float base = (std::fabs(f) * f32_bits(0x77800000u)) * f32_bits(0x08800000u);
  const uint32_t w = f32_to_bits(f), shl1_w = w + w, sign = w & 0x80000000u;
  uint32_t bias = shl1_w & 0xFF000000u;
  if (bias < 0x71000000u) bias = 0x71000000u;
  base = f32_bits((bias >> 1) + 0x07800000u) + base;
  const uint32_t bits = f32_to_bits(base);
  const uint32_t nonsign = ((bits >> 13) & 0x00007C00u) + (bits & 0x00000FFFu);
  const uint32_t h = (sign >> 16) | (shl1_w > 0xFF000000u ? 0x7E00u : nonsign);
  const uint32_t e = (h >> 10) & 0x1fu, m = h & 0x3ffu, s = (h & 0x8000u) << 16;
  if (e == 0) {
    const float v = (float)m * f32_bits(0x33800000u);     // m * 2^-24
    return s ? -v : v;
  }
  if (e == 31) return f32_bits(s | 0x7f800000u | (m << 13));
  return f32_bits(s | ((e + 112) << 23) | (m << 13));
}
// c10::BFloat16's round_to_nearest_even
MERGE_HD float r_bf16(float a) {
  if (a != a) return a;
  const uint32_t u = f32_to_bits(a);
  return f32_bits(((u + ((u >> 16) & 1u) + 0x7FFFu) >> 16) << 16);
}
#endif

// a float to an integer type, as torch converts it (c10::convert); out of
// range or NaN the C++ cast is undefined, and torch gives what each
// machine's conversion gives: on the card the PTX conversion's (nvcc
// compiles the same static_cast torch's kernels do: saturating, NaN to
// 0), on the host x86's (cvttss2si: the type's most negative value for
// int32 and int64, int8 and int16 cut from int32, uint8 from int64)
#ifdef __CUDA_ARCH__
template <typename I, typename F> MERGE_HD I f2i(F a) {
  return static_cast<I>(a);
}
template <> MERGE_HD u8 f2i<u8, float>(float a) { return (u8)(i64)a; }
template <> MERGE_HD u8 f2i<u8, double>(double a) { return (u8)(i64)a; }
#else
MERGE_HD i32 x86_i32(double d) {
  return (d > -2147483649.0 && d < 2147483648.0) ? (i32)d
                                                  : (i32)0x80000000u;
}
MERGE_HD i64 x86_i64(double d) {
  return (d >= -9223372036854775808.0 && d < 9223372036854775808.0)
             ? (i64)d : (i64)(1ull << 63);
}
template <typename I, typename F> MERGE_HD I f2i(F a) {
  return sizeof(I) == 8 || std::is_unsigned<I>::value ? (I)x86_i64(a)
                                                      : (I)x86_i32(a);
}
#endif

#include "merge_special.cuh"
