// merge_join's code instances: a bilinear merge or the safe division
// (MergeCode), the kernel of merge_join.cuh. Every other merge runs in its
// own generated instances (kernels/build.py).
#include "merge_join.cuh"

extern "C" int merge_join_launch(int value_code, const void* a, const void* b,
                                 const void* mask_a, const void* mask_b,
                                 void* out, long long m, long long n,
                                 long long ldb, int bs, int mode, int vec,
                                 int transposed, int op,
                                 double c0, double cx, double cy, double cxy,
                                 void* stream) {
  const MergeCode merge{op, c0, cx, cy, cxy};
  return merge_join_dispatch(value_code, a, b, mask_a, mask_b, out, m, n, ldb,
                             bs, mode, vec, transposed, merge, merge, stream);
}
