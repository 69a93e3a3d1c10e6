// coo_expand: fused segment expansion of the device COO join tier.
//
// Replaces the TPU kernel coo_expand_pallas (src/repro/kernels/coo_join.py,
// body _search_kernel): for every output slot t < cap,
//   seg    = #(ends <= t), clamped to ns-1     (searchsorted-right)
//   sb     = clamp(t + delta[seg], 0, nb-1)
//   val[t] = merge(a_vals[seg], b_vals[sb])
//   idx[t] = a_coords[seg] ++ b_coords[sb]
// Slots at or past the join's true total hold clamped values that the
// caller masks with its `valid` vector.
//
// Bound on the H100: device-memory bytes. Each slot writes (ca+cb) coords
// of 2 or 4 bytes plus one value, and reads a handful of words from the
// nnz-sized side buffers; the binary search is ~log2(ns) dependent loads
// from `ends`, which is a few MiB at most and stays in the 50 MB L2.
// Design: one thread per slot, 256 threads a block; no shared memory; the
// side buffers are read through the read-only cache (__ldg), and the two
// outputs are written once each. Coordinates are templated on int16/int32
// and values on float/double.
#include <cstdint>

#include "merge.cuh"

template <typename T, typename C>
__global__ void coo_expand_kernel(const int32_t* __restrict__ ends,
                                  const int32_t* __restrict__ delta,
                                  const T* __restrict__ a_vals,
                                  const C* __restrict__ a_coords,
                                  const T* __restrict__ b_vals,
                                  const C* __restrict__ b_coords,
                                  int ns, int nb, int ca, int cb,
                                  long long cap, MergeCode merge,
                                  C* __restrict__ idx_out,
                                  T* __restrict__ val_out) {
  long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= cap) return;
  // searchsorted-right over the inclusive segment ends
  int lo = 0, hi = ns;
  while (lo < hi) {
    int mid = (lo + hi) >> 1;
    if ((long long)__ldg(ends + mid) <= t) lo = mid + 1; else hi = mid;
  }
  int seg = lo < ns - 1 ? lo : ns - 1;
  long long sbl = t + (long long)__ldg(delta + seg);
  int sb = (int)(sbl < 0 ? 0 : (sbl > nb - 1 ? nb - 1 : sbl));
  val_out[t] = apply_merge<T>(merge, __ldg(a_vals + seg), __ldg(b_vals + sb));
  C* o = idx_out + t * (long long)(ca + cb);
  for (int c = 0; c < ca; ++c) o[c] = __ldg(a_coords + (long long)seg * ca + c);
  for (int c = 0; c < cb; ++c) o[ca + c] = __ldg(b_coords + (long long)sb * cb + c);
}

template <typename T, typename C>
static cudaError_t launch(const void* ends, const void* delta,
                          const void* a_vals, const void* a_coords,
                          const void* b_vals, const void* b_coords, int ns,
                          int nb, int ca, int cb, long long cap,
                          MergeCode merge, void* idx_out, void* val_out,
                          cudaStream_t stream) {
  const int threads = 256;
  long long blocks = (cap + threads - 1) / threads;
  coo_expand_kernel<T, C><<<(unsigned)blocks, threads, 0, stream>>>(
      (const int32_t*)ends, (const int32_t*)delta, (const T*)a_vals,
      (const C*)a_coords, (const T*)b_vals, (const C*)b_coords, ns, nb, ca,
      cb, cap, merge, (C*)idx_out, (T*)val_out);
  return cudaGetLastError();
}

extern "C" int coo_expand_launch(int value_code, int coord_code,
                                 const void* ends, const void* delta,
                                 const void* a_vals, const void* a_coords,
                                 const void* b_vals, const void* b_coords,
                                 int ns, int nb, int ca, int cb, long long cap,
                                 int op, double c0, double cx, double cy,
                                 double cxy, void* idx_out, void* val_out,
                                 void* stream) {
  if (cap <= 0) return 0;
  if (ns <= 0 || nb <= 0) return (int)cudaErrorInvalidValue;
  MergeCode m{op, c0, cx, cy, cxy};
  cudaStream_t s = (cudaStream_t)stream;
  // value_code: 0 float, 1 double; coord_code: 0 int16, 1 int32
  if (value_code == 0 && coord_code == 0)
    return (int)launch<float, int16_t>(ends, delta, a_vals, a_coords, b_vals,
                                       b_coords, ns, nb, ca, cb, cap, m,
                                       idx_out, val_out, s);
  if (value_code == 0 && coord_code == 1)
    return (int)launch<float, int32_t>(ends, delta, a_vals, a_coords, b_vals,
                                       b_coords, ns, nb, ca, cb, cap, m,
                                       idx_out, val_out, s);
  if (value_code == 1 && coord_code == 0)
    return (int)launch<double, int16_t>(ends, delta, a_vals, a_coords, b_vals,
                                        b_coords, ns, nb, ca, cb, cap, m,
                                        idx_out, val_out, s);
  if (value_code == 1 && coord_code == 1)
    return (int)launch<double, int32_t>(ends, delta, a_vals, a_coords, b_vals,
                                        b_coords, ns, nb, ca, cb, cap, m,
                                        idx_out, val_out, s);
  return (int)cudaErrorInvalidValue;
}

extern "C" const char* repro_torch_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
