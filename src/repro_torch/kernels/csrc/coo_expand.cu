// coo_expand's code instances: a bilinear merge or the safe division
// (MergeCode), the kernel of coo_expand.cuh. The joins' widths (2 + 1 for
// D2D, 2 + 2 for V2V) have fixed-width instances for each vt of the grid
// with float values and for 8 alone with double; any other width runs the
// run-time-width instance. Every other merge runs in its own generated
// run-time-width instances (kernels/build.py).
#include <type_traits>

#include "coo_expand.cuh"

// Launches the fixed-width instance <CA, CB> for vt; cudaErrorInvalidValue
// for a vt with no such instance.
template <typename T, typename C, int CA, int CB>
static int by_vt(const void* ends, const void* delta, const void* a_vals,
                 const void* a_coords, const void* b_vals,
                 const void* b_coords, int ns, int nb, long long cap, int vt,
                 const MergeCode& m, void* idx_out, void* val_out,
                 cudaStream_t s) {
#define COO_EXPAND_VT(V)                                                  \
  return coo_expand_run<T, C, CA, CB, V>(ends, delta, a_vals, a_coords,   \
                                         b_vals, b_coords, ns, nb, CA, CB, \
                                         cap, V, m, idx_out, val_out, s)
  if (vt == kVt) COO_EXPAND_VT(kVt);
  if constexpr (std::is_same<T, float>::value) {
    if (vt == 4) COO_EXPAND_VT(4);
    if (vt == 6) COO_EXPAND_VT(6);
  }
#undef COO_EXPAND_VT
  return (int)cudaErrorInvalidValue;
}

extern "C" int coo_expand_launch(int value_code, int coord_code,
                                 const void* ends, const void* delta,
                                 const void* a_vals, const void* a_coords,
                                 const void* b_vals, const void* b_coords,
                                 int ns, int nb, int ca, int cb, long long cap,
                                 int vt, int op, double c0, double cx,
                                 double cy, double cxy, void* idx_out,
                                 void* val_out, void* stream) {
  const int rc = coo_expand_check(ns, nb, ca, cb, cap, vt);
  if (rc >= 0) return rc;
  const MergeCode m{op, c0, cx, cy, cxy};
  const cudaStream_t s = (cudaStream_t)stream;
  return by_type(value_code, coord_code, [&](auto t, auto c) {
    using T = decltype(t);
    using C = decltype(c);
    if (ca == 2 && cb == 1)
      return by_vt<T, C, 2, 1>(ends, delta, a_vals, a_coords, b_vals,
                               b_coords, ns, nb, cap, vt, m, idx_out,
                               val_out, s);
    if (ca == 2 && cb == 2)
      return by_vt<T, C, 2, 2>(ends, delta, a_vals, a_coords, b_vals,
                               b_coords, ns, nb, cap, vt, m, idx_out,
                               val_out, s);
    return coo_expand_run<T, C, 0, 0, kVt>(ends, delta, a_vals, a_coords,
                                           b_vals, b_coords, ns, nb, ca, cb,
                                           cap, vt, m, idx_out, val_out, s);
  });
}

extern "C" const char* repro_torch_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
