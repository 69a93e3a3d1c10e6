// Merge op codes shared by the coo_expand and merge_join kernels.
//
// A merge f(x, y) reaches a kernel as an op code built on the host by
// repro_torch/kernels/merge_codes.py:
//   MERGE_BILINEAR: c0 + cx*x + cy*y + cxy*(x*y); a zero coefficient drops
//                   its term, so x*y is one multiply and x+y one add, as in
//                   the plain PyTorch versions;
//   MERGE_SAFE_DIV: x == 0 ? 0 : x / (y == 0 ? 1 : y).
#pragma once

#include <cuda_runtime.h>

#define MERGE_BILINEAR 0
#define MERGE_SAFE_DIV 1

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
