// sddmm_agg: SUM of sp ∘ (W·H) over rows, columns or everything, on the
// live tiles only; the m x n product never exists in device memory.
//
// Replaces the TPU kernel sddmm_agg_pallas (src/repro/kernels/
// sddmm_agg.py, bodies _row_kernel, _col_kernel, _all_kernel). dim 0
// ("row") gives out[m], dim 1 ("col") out[n], dim 2 ("all") out[1]. A tile
// (i, j) of bs x bs contributes only where mask[i, j] is set, even where sp
// is nonzero under a dead entry (the Pallas semantics). float32 accumulates
// in float32, float64 in float64.
//
// Bound on the H100: device-memory bytes, the live tiles of sp (0.32 GB
// at 16384^2 with 30% of the 256^2 tiles live); W and H are small and stay
// in the 50 MB L2. The (2K + 2) operations per live element take about as
// long at the 67 TFLOP/s float32 rate when K = 32.
// Design: deterministic, in two launches and without atomics.
//   1. One CTA of 256 threads per bs x bs tile. A dead tile writes zero
//      partials and reads nothing. A live tile walks its 64 x 64 sub-tiles;
//      for each it stages W [64, 32] and H [32, 64] panels in shared memory
//      (K in chunks of 32, whole), forms the W·H sub-tile in registers
//      (4 x 4 per thread, FMA), multiplies it by the sp sub-tile read with
//      vector loads, and folds the products into register sums. The CTA
//      then writes one partial per row ([gn, m] buffer), per column
//      ([gm, n]) or per tile ([gm * gn]), reduced across threads by warp
//      shuffles and shared memory in a fixed order.
//   2. A second launch sums the partials over the tile axis in a fixed
//      order: one thread per output element, or one CTA for "all".
// The same input therefore gives bit-identical output on every run.
// Operands come with their strides (a transposed view is read in place).
#include <cstdint>

namespace {

constexpr int TILE = 64;      // sub-tile edge
constexpr int KC = 32;        // K chunk staged in shared memory
constexpr int THREADS = 256;  // 16 x 16 threads, 4 x 4 elements each
constexpr int PAD = 4;
constexpr int WARPS = THREADS / 32;
constexpr int SUM_THREADS = 1024;

__device__ __forceinline__ float fmadd(float a, float b, float c) {
  return fmaf(a, b, c);
}
__device__ __forceinline__ double fmadd(double a, double b, double c) {
  return fma(a, b, c);
}

__device__ __forceinline__ void load4(const float* p, float v[4]) {
  const float4 x = *reinterpret_cast<const float4*>(p);
  v[0] = x.x; v[1] = x.y; v[2] = x.z; v[3] = x.w;
}
__device__ __forceinline__ void load4(const double* p, double v[4]) {
  const double2 x = reinterpret_cast<const double2*>(p)[0];
  const double2 y = reinterpret_cast<const double2*>(p)[1];
  v[0] = x.x; v[1] = x.y; v[2] = y.x; v[3] = y.y;
}

template <typename T> struct Panels {
  T w[KC][TILE + PAD];  // W rows of the sub-tile, k-major
  T h[KC][TILE + PAD];  // H columns of the sub-tile, k-major
  T red[WARPS][TILE];   // cross-warp column / tile sums
};

// wh = (W·H) over rows [r0, r1) x columns [c0, c1) of one sub-tile, as a
// 4 x 4 register tile per thread (rows ty*4+i, columns tx*4+j); elements
// past r1 or c1 are zero. Every thread of the CTA calls it together.
template <typename T>
__device__ __forceinline__ void subtile_product(
    const T* __restrict__ w, const T* __restrict__ h, Panels<T>& s,
    long long r0, long long r1, long long c0, long long c1, long long k,
    long long sw0, long long sw1, long long sh0, long long sh1, T wh[4][4]) {
  const int t = threadIdx.x, ty = t / 16, tx = t % 16;
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) wh[i][j] = T(0);
  for (long long k0 = 0; k0 < k; k0 += KC) {
    for (int e = t; e < TILE * KC; e += THREADS) {
      const int row = e / KC, kk = e % KC;
      const long long gr = r0 + row, gk = k0 + kk;
      s.w[kk][row] = (gr < r1 && gk < k) ? w[gr * sw0 + gk * sw1] : T(0);
    }
    for (int e = t; e < TILE * KC; e += THREADS) {
      const int kk = e / TILE, col = e % TILE;
      const long long gk = k0 + kk, gc = c0 + col;
      s.h[kk][col] = (gk < k && gc < c1) ? h[gk * sh0 + gc * sh1] : T(0);
    }
    __syncthreads();
#pragma unroll 8
    for (int kk = 0; kk < KC; ++kk) {
      T x[4], y[4];
      load4(&s.w[kk][ty * 4], x);
      load4(&s.h[kk][tx * 4], y);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) wh[i][j] = fmadd(x[i], y[j], wh[i][j]);
    }
    __syncthreads();
  }
}

// sp ∘ wh over the sub-tile: p[i][j] = sp[r, c] * wh[i][j], 0 outside it.
template <typename T>
__device__ __forceinline__ void hadamard(const T* __restrict__ sp,
                                         long long ss0, long long ss1,
                                         long long r0, long long r1,
                                         long long c0, long long c1,
                                         int vec, T wh[4][4]) {
  const int t = threadIdx.x, ty = t / 16, tx = t % 16;
  const long long c = c0 + tx * 4;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const long long r = r0 + ty * 4 + i;
    T v[4] = {T(0), T(0), T(0), T(0)};
    if (r < r1) {
      if (vec && c + 3 < c1) {
        load4(sp + r * ss0 + c, v);
      } else {
        for (int j = 0; j < 4; ++j)
          if (c + j < c1) v[j] = sp[r * ss0 + (c + j) * ss1];
      }
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) wh[i][j] *= v[j];
  }
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
sddmm_partial_kernel(const T* __restrict__ sp, const T* __restrict__ w,
                     const T* __restrict__ h, const bool* __restrict__ mask,
                     T* __restrict__ part, long long m, long long n,
                     long long k, long long ss0, long long ss1,
                     long long sw0, long long sw1, long long sh0,
                     long long sh1, int bs, long long gn, int dim, int vec) {
  __shared__ __align__(16) Panels<T> s;
  const long long tile = blockIdx.x;
  const long long ti = tile / gn, tj = tile % gn;
  const long long R0 = ti * bs, C0 = tj * bs;
  const long long R1 = R0 + bs < m ? R0 + bs : m;
  const long long C1 = C0 + bs < n ? C0 + bs : n;
  const int t = threadIdx.x, ty = t / 16, tx = t % 16;
  const int lane = t % 32, warp = t / 32;

  if (!mask[tile]) {  // dead: zero partials, nothing read
    if (dim == 0)
      for (long long r = R0 + t; r < R1; r += THREADS) part[tj * m + r] = T(0);
    else if (dim == 1)
      for (long long c = C0 + t; c < C1; c += THREADS) part[ti * n + c] = T(0);
    else if (t == 0)
      part[tile] = T(0);
    return;
  }

  T p[4][4];
  if (dim == 0) {
    // rows: sub-tile rows outer, columns inner; sums across the 16 tx lanes
    for (long long r0 = R0; r0 < R1; r0 += TILE) {
      const long long r1 = r0 + TILE < R1 ? r0 + TILE : R1;
      T acc[4] = {T(0), T(0), T(0), T(0)};
      for (long long c0 = C0; c0 < C1; c0 += TILE) {
        const long long c1 = c0 + TILE < C1 ? c0 + TILE : C1;
        subtile_product(w, h, s, r0, r1, c0, c1, k, sw0, sw1, sh0, sh1, p);
        hadamard(sp, ss0, ss1, r0, r1, c0, c1, vec, p);
#pragma unroll
        for (int i = 0; i < 4; ++i)
          acc[i] += (p[i][0] + p[i][1]) + (p[i][2] + p[i][3]);
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        T v = acc[i];
        for (int off = 8; off > 0; off >>= 1)
          v += __shfl_xor_sync(0xffffffffu, v, off);
        const long long r = r0 + ty * 4 + i;
        if (tx == 0 && r < r1) part[tj * m + r] = v;
      }
    }
  } else if (dim == 1) {
    // columns: sub-tile columns outer, rows inner; sums across ty
    for (long long c0 = C0; c0 < C1; c0 += TILE) {
      const long long c1 = c0 + TILE < C1 ? c0 + TILE : C1;
      T acc[4] = {T(0), T(0), T(0), T(0)};
      for (long long r0 = R0; r0 < R1; r0 += TILE) {
        const long long r1 = r0 + TILE < R1 ? r0 + TILE : R1;
        subtile_product(w, h, s, r0, r1, c0, c1, k, sw0, sw1, sh0, sh1, p);
        hadamard(sp, ss0, ss1, r0, r1, c0, c1, vec, p);
#pragma unroll
        for (int j = 0; j < 4; ++j)
          acc[j] += (p[0][j] + p[1][j]) + (p[2][j] + p[3][j]);
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const T v = acc[j] + __shfl_xor_sync(0xffffffffu, acc[j], 16);
        if (lane < 16) s.red[warp][tx * 4 + j] = v;
      }
      __syncthreads();
      if (t < TILE && c0 + t < c1) {
        T v = T(0);
        for (int q = 0; q < WARPS; ++q) v += s.red[q][t];
        part[ti * n + c0 + t] = v;
      }
      __syncthreads();
    }
  } else {
    // everything: one register sum per thread, then one block reduction
    T acc = T(0);
    for (long long r0 = R0; r0 < R1; r0 += TILE) {
      const long long r1 = r0 + TILE < R1 ? r0 + TILE : R1;
      for (long long c0 = C0; c0 < C1; c0 += TILE) {
        const long long c1 = c0 + TILE < C1 ? c0 + TILE : C1;
        subtile_product(w, h, s, r0, r1, c0, c1, k, sw0, sw1, sh0, sh1, p);
        hadamard(sp, ss0, ss1, r0, r1, c0, c1, vec, p);
#pragma unroll
        for (int i = 0; i < 4; ++i)
          acc += (p[i][0] + p[i][1]) + (p[i][2] + p[i][3]);
      }
    }
    for (int off = 16; off > 0; off >>= 1)
      acc += __shfl_xor_sync(0xffffffffu, acc, off);
    if (lane == 0) s.red[warp][0] = acc;
    __syncthreads();
    if (t == 0) {
      T v = T(0);
      for (int q = 0; q < WARPS; ++q) v += s.red[q][0];
      part[tile] = v;
    }
  }
}

// out[l] = sum over r of part[r * len + l], r in order
template <typename T>
__global__ void sum_axis0_kernel(const T* __restrict__ part,
                                 T* __restrict__ out, long long rows,
                                 long long len) {
  const long long l = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (l >= len) return;
  T v = T(0);
  for (long long r = 0; r < rows; ++r) v += part[r * len + l];
  out[l] = v;
}

// out[0] = sum of part[0 .. count), in a fixed order: strided per-thread
// sums, then a shared-memory tree
template <typename T>
__global__ void __launch_bounds__(SUM_THREADS)
sum_all_kernel(const T* __restrict__ part, T* __restrict__ out,
               long long count) {
  __shared__ T red[SUM_THREADS];
  const int t = threadIdx.x;
  T v = T(0);
  for (long long i = t; i < count; i += SUM_THREADS) v += part[i];
  red[t] = v;
  __syncthreads();
  for (int half = SUM_THREADS / 2; half > 0; half >>= 1) {
    if (t < half) red[t] += red[t + half];
    __syncthreads();
  }
  if (t == 0) out[0] = red[0];
}

template <typename T>
cudaError_t launch(const void* sp, const void* w, const void* h,
                   const void* mask, void* part, void* out, long long m,
                   long long n, long long k, long long ss0, long long ss1,
                   long long sw0, long long sw1, long long sh0, long long sh1,
                   int bs, int dim, int vec, cudaStream_t stream) {
  const long long gm = (m + bs - 1) / bs, gn = (n + bs - 1) / bs;
  const long long tiles = gm * gn;
  if (tiles > 0x7fffffffLL) return cudaErrorInvalidValue;
  sddmm_partial_kernel<T><<<(unsigned)tiles, THREADS, 0, stream>>>(
      (const T*)sp, (const T*)w, (const T*)h, (const bool*)mask, (T*)part, m,
      n, k, ss0, ss1, sw0, sw1, sh0, sh1, bs, gn, dim, vec);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  if (dim == 2) {
    sum_all_kernel<T><<<1, SUM_THREADS, 0, stream>>>((const T*)part, (T*)out,
                                                     tiles);
  } else {
    const long long rows = dim == 0 ? gn : gm, len = dim == 0 ? m : n;
    const long long blocks = (len + 255) / 256;
    sum_axis0_kernel<T><<<(unsigned)blocks, 256, 0, stream>>>(
        (const T*)part, (T*)out, rows, len);
  }
  return cudaGetLastError();
}

}  // namespace

// value_code: 0 float32, 1 float64; dim: 0 row, 1 col, 2 all. `part` is
// scratch of gn * m (row), gm * n (col) or gm * gn (all) elements; `out`
// holds m, n or 1 elements.
extern "C" int sddmm_agg_launch(int value_code, const void* sp, const void* w,
                                const void* h, const void* mask, void* part,
                                void* out, long long m, long long n,
                                long long k, long long ss0, long long ss1,
                                long long sw0, long long sw1, long long sh0,
                                long long sh1, int bs, int dim, int vec,
                                void* stream) {
  if (m <= 0 || n <= 0) return 0;
  if (bs <= 0 || k < 0 || dim < 0 || dim > 2)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (value_code == 0)
    return (int)launch<float>(sp, w, h, mask, part, out, m, n, k, ss0, ss1,
                              sw0, sw1, sh0, sh1, bs, dim, vec, s);
  if (value_code == 1)
    return (int)launch<double>(sp, w, h, mask, part, out, m, n, k, ss0, ss1,
                               sw0, sw1, sh0, sh1, bs, dim, vec, s);
  return (int)cudaErrorInvalidValue;
}
