// merge_join: block-skip overlay join (direct or transposed operand).
//
// Replaces the TPU kernel merge_join_pallas (src/repro/kernels/
// merge_join.py, body _kernel, gating rule mode_for): for each
// bs x bs tile (i, j), out = merge(A tile, B tile) where the tile is live,
// else 0. Live is ma & mb under MODE_BOTH (0), ma under MODE_X (1), mb under
// MODE_Y (2), always under MODE_ALL (3).
//
// Bound on the H100: device-memory bytes — 2 * sizeof(T) per live element
// read, sizeof(T) per element written; there is one merge per element.
// Design: one CTA per tile (a 1-D grid, so any tile count fits); the CTA
// reads the two mask bits and derives `live` from the mode. A dead tile
// only gets the zero store: its inputs are never loaded. A live tile is
// read and written with 16-byte vector accesses when the row length and
// the pointers allow it (the wrapper checks), else element by element.
// The ragged last row and column of tiles are masked here, so the wrapper
// pads nothing.
// The kernel is a template over its merge parameter P (merge.cuh): a
// MergeCode in the main library (merge_join.cu), a merge's generated
// functor in that merge's own library (kernels/build.py), where nvcc
// inlines it into the body like any other op.
#pragma once

#include <cstdint>

#include "merge.cuh"

template <typename T> struct Vec16;
template <> struct Vec16<float> { using V = float4; static constexpr int W = 4; };
template <> struct Vec16<double> { using V = double2; static constexpr int W = 2; };

template <typename T, bool VEC, typename P>
__global__ void merge_join_kernel(
    const T* __restrict__ a, const T* __restrict__ b,
    const bool* __restrict__ mask_a, const bool* __restrict__ mask_b,
    T* __restrict__ out, long long m, long long n, int bs, int gn, int mode,
    P merge) {
  const auto mrg = device_merge<T>(merge);
  const long long tile = blockIdx.x;
  const long long bi = tile / gn, bj = tile % gn;
  const bool la = mask_a[tile], lb = mask_b[tile];
  const bool live = mode == 0 ? (la && lb)
                  : mode == 1 ? la
                  : mode == 2 ? lb : true;
  const long long r0 = bi * bs, c0 = bj * bs;
  const int rows = (int)(m - r0 < bs ? m - r0 : bs);
  const int cols = (int)(n - c0 < bs ? n - c0 : bs);
  if constexpr (VEC) {
    using V = typename Vec16<T>::V;
    constexpr int W = Vec16<T>::W;
    const int cv = cols / W;  // the wrapper guarantees cols % W == 0
    const int total = rows * cv;
    for (int e = threadIdx.x; e < total; e += blockDim.x) {
      const int r = e / cv, c = (e - r * cv) * W;
      const long long off = (r0 + r) * n + c0 + c;
      V o;
      T* ol = reinterpret_cast<T*>(&o);
      if (live) {
        const V x = *reinterpret_cast<const V*>(a + off);
        const V y = *reinterpret_cast<const V*>(b + off);
        const T* xl = reinterpret_cast<const T*>(&x);
        const T* yl = reinterpret_cast<const T*>(&y);
#pragma unroll
        for (int k = 0; k < W; ++k) ol[k] = mrg(xl[k], yl[k]);
      } else {
#pragma unroll
        for (int k = 0; k < W; ++k) ol[k] = T(0);
      }
      *reinterpret_cast<V*>(out + off) = o;
    }
  } else {
    const int total = rows * cols;
    for (int e = threadIdx.x; e < total; e += blockDim.x) {
      const int r = e / cols, c = e - r * cols;
      const long long off = (r0 + r) * n + c0 + c;
      out[off] = live ? mrg(a[off], b[off]) : T(0);
    }
  }
}

template <typename T, typename P>
static cudaError_t merge_join_run(const void* a, const void* b, const void* ma,
                                  const void* mb, void* out, long long m,
                                  long long n, int bs, int mode, int vec,
                                  const P& merge, cudaStream_t stream) {
  const long long gm = (m + bs - 1) / bs, gn = (n + bs - 1) / bs;
  const int threads = 256;
  const long long tiles = gm * gn;
  if (vec)
    merge_join_kernel<T, true, P><<<(unsigned)tiles, threads, 0, stream>>>(
        (const T*)a, (const T*)b, (const bool*)ma, (const bool*)mb, (T*)out,
        m, n, bs, (int)gn, mode, merge);
  else
    merge_join_kernel<T, false, P><<<(unsigned)tiles, threads, 0, stream>>>(
        (const T*)a, (const T*)b, (const bool*)ma, (const bool*)mb, (T*)out,
        m, n, bs, (int)gn, mode, merge);
  return cudaGetLastError();
}

// value_code 0 float (merge parameter p32), 1 double (p64).
template <typename P32, typename P64>
static int merge_join_dispatch(int value_code, const void* a, const void* b,
                               const void* mask_a, const void* mask_b,
                               void* out, long long m, long long n, int bs,
                               int mode, int vec, const P32& p32,
                               const P64& p64, void* stream) {
  if (m <= 0 || n <= 0) return 0;
  if (bs <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (value_code == 0)
    return (int)merge_join_run<float>(a, b, mask_a, mask_b, out, m, n, bs,
                                      mode, vec, p32, s);
  if (value_code == 1)
    return (int)merge_join_run<double>(a, b, mask_a, mask_b, out, m, n, bs,
                                       mode, vec, p64, s);
  return (int)cudaErrorInvalidValue;
}
