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

template <typename T>
__device__ __forceinline__ T apply_merge(const MergeCode& m, T x, T y) {
  if (m.op == MERGE_SAFE_DIV) {
    return x == T(0) ? T(0) : x / (y == T(0) ? T(1) : y);
  }
  T r = T(m.c0);
  if (m.cx != 0.0) r = r + T(m.cx) * x;
  if (m.cy != 0.0) r = r + T(m.cy) * y;
  if (m.cxy != 0.0) r = r + T(m.cxy) * (x * y);
  return r;
}
