// masked_matmul: C = A x B on the live output tiles, zero on the dead ones.
//
// Replaces the TPU kernel masked_matmul_pallas (src/repro/kernels/
// masked_matmul.py, body _kernel): out[i, j] = (A x B)[i, j] where
// mask[i / bs, j / bs] is set, else 0. Products accumulate in float32 and
// are stored in A's dtype (float32 or bfloat16), as the Pallas body's
// promote_types(a.dtype, f32) followed by .astype(a.dtype). float32 runs
// as IEEE FFMA, never TF32.
//
// Bound on the H100: device-memory bytes on the PNMF path (K = 32). Every
// output element is written once (1 GiB at 16384^2 float32), while the
// live tiles need 2K operations per element, which the 67 TFLOP/s
// float32 rate covers about four times faster than the writes.
// Design: one CTA of 256 threads per 64 x 64 output sub-tile (a 1-D grid,
// so any tile count fits). The CTA first reads the mask entries its
// sub-tile overlaps. If none is live it stores zeros and reads no A or B
// panel. Otherwise it walks K in chunks of 32: an A panel [64, 32] and a
// B panel [32, 64] are staged in shared memory as float, and each thread
// accumulates a 4 x 4 register tile with FFMA. When bs is a multiple of 64
// (256 on the main path) a sub-tile lies under one mask entry; otherwise
// the store zeroes each element whose own mask entry is dead. Each thread
// stores four consecutive columns with one vector store when n % 4 == 0.
// A and B come with their strides (a transposed view is read in place);
// ragged M, N and K are bounds-checked here, so the wrapper pads nothing.
#include <cstdint>

#include <cuda_bf16.h>

namespace {

constexpr int TILE = 64;     // output sub-tile edge
constexpr int KC = 32;       // K chunk staged in shared memory
constexpr int THREADS = 256; // 16 x 16 threads, 4 x 4 outputs each
constexpr int PAD = 4;       // keeps float4 alignment of the panel rows

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) {
  return x;
}
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(
    float x) {
  return __float2bfloat16(x);
}

// four consecutive elements in one store (16 bytes for float, 8 for bf16)
__device__ __forceinline__ void store4(float* p, const float v[4]) {
  *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
}
__device__ __forceinline__ void store4(__nv_bfloat16* p, const float v[4]) {
  __nv_bfloat162 lo = __floats2bfloat162_rn(v[0], v[1]);
  __nv_bfloat162 hi = __floats2bfloat162_rn(v[2], v[3]);
  uint2 u;
  u.x = *reinterpret_cast<uint32_t*>(&lo);
  u.y = *reinterpret_cast<uint32_t*>(&hi);
  *reinterpret_cast<uint2*>(p) = u;
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
masked_matmul_kernel(const T* __restrict__ a, const T* __restrict__ b,
                     const bool* __restrict__ mask, T* __restrict__ out,
                     long long m, long long n, long long k, long long sa0,
                     long long sa1, long long sb0, long long sb1, int bs,
                     long long gn, long long tiles_n, int vec) {
  __shared__ __align__(16) float as[KC][TILE + PAD];  // A panel, k-major
  __shared__ __align__(16) float bsm[KC][TILE + PAD]; // B panel, k-major

  const long long tile = blockIdx.x;
  const long long r0 = (tile / tiles_n) * TILE, c0 = (tile % tiles_n) * TILE;
  const long long r1 = (r0 + TILE < m ? r0 + TILE : m) - 1;
  const long long c1 = (c0 + TILE < n ? c0 + TILE : n) - 1;
  const int t = threadIdx.x, ty = t / 16, tx = t % 16;

  // the gate: the mask entries under this sub-tile
  const long long mr0 = r0 / bs, mc0 = c0 / bs;
  const long long nr = r1 / bs - mr0 + 1, nc = c1 / bs - mc0 + 1;
  int seen = 0;
  for (long long e = t; e < nr * nc; e += THREADS)
    seen |= mask[(mr0 + e / nc) * gn + mc0 + e % nc];
  const bool live = __syncthreads_or(seen);
  const bool uniform = nr == 1 && nc == 1;

  float acc[4][4] = {};
  if (live) {
    for (long long k0 = 0; k0 < k; k0 += KC) {
      // A panel: rows r0.., columns k0..; consecutive threads walk k
      for (int e = t; e < TILE * KC; e += THREADS) {
        const int row = e / KC, kk = e % KC;
        const long long gr = r0 + row, gk = k0 + kk;
        as[kk][row] = (gr < m && gk < k) ? to_f(a[gr * sa0 + gk * sa1]) : 0.f;
      }
      // B panel: rows k0.., columns c0..; consecutive threads walk columns
      for (int e = t; e < TILE * KC; e += THREADS) {
        const int kk = e / TILE, col = e % TILE;
        const long long gk = k0 + kk, gc = c0 + col;
        bsm[kk][col] = (gk < k && gc < n) ? to_f(b[gk * sb0 + gc * sb1]) : 0.f;
      }
      __syncthreads();
#pragma unroll 8
      for (int kk = 0; kk < KC; ++kk) {
        const float4 x = *reinterpret_cast<const float4*>(&as[kk][ty * 4]);
        const float4 y = *reinterpret_cast<const float4*>(&bsm[kk][tx * 4]);
        const float xa[4] = {x.x, x.y, x.z, x.w};
        const float ya[4] = {y.x, y.y, y.z, y.w};
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(xa[i], ya[j], acc[i][j]);
      }
      __syncthreads();
    }
  }

  // store: every element of the sub-tile is written, zero where dead
  const long long c = c0 + tx * 4;
  for (int i = 0; i < 4; ++i) {
    const long long r = r0 + ty * 4 + i;
    if (r >= m) break;
    float v[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      bool keep = live;
      if (live && !uniform && c + j < n)
        keep = mask[(r / bs) * gn + (c + j) / bs];
      v[j] = keep ? acc[i][j] : 0.f;
    }
    T* o = out + r * n + c;
    if (vec && c + 3 < n) {
      store4(o, v);
    } else {
      for (int j = 0; j < 4 && c + j < n; ++j) o[j] = from_f<T>(v[j]);
    }
  }
}

template <typename T>
cudaError_t launch(const void* a, const void* b, const void* mask, void* out,
                   long long m, long long n, long long k, long long sa0,
                   long long sa1, long long sb0, long long sb1, int bs,
                   cudaStream_t stream) {
  const long long tiles_m = (m + TILE - 1) / TILE;
  const long long tiles_n = (n + TILE - 1) / TILE;
  const long long gn = (n + bs - 1) / bs;
  const long long tiles = tiles_m * tiles_n;
  if (tiles > 0x7fffffffLL) return cudaErrorInvalidValue;
  masked_matmul_kernel<T><<<(unsigned)tiles, THREADS, 0, stream>>>(
      (const T*)a, (const T*)b, (const bool*)mask, (T*)out, m, n, k, sa0, sa1,
      sb0, sb1, bs, gn, tiles_n, (int)(n % 4 == 0));
  return cudaGetLastError();
}

}  // namespace

// value_code: 0 float32, 1 bfloat16. The output is contiguous [m, n].
extern "C" int masked_matmul_launch(int value_code, const void* a,
                                    const void* b, const void* mask,
                                    void* out, long long m, long long n,
                                    long long k, long long sa0, long long sa1,
                                    long long sb0, long long sb1, int bs,
                                    void* stream) {
  if (m <= 0 || n <= 0) return 0;
  if (bs <= 0 || k < 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (value_code == 0)
    return (int)launch<float>(a, b, mask, out, m, n, k, sa0, sa1, sb0, sb1,
                              bs, s);
  if (value_code == 1)
    return (int)launch<__nv_bfloat16>(a, b, mask, out, m, n, k, sa0, sa1, sb0,
                                      sb1, bs, s);
  return (int)cudaErrorInvalidValue;
}
