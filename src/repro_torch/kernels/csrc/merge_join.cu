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
// A general merge (MERGE_PROGRAM) runs in the program instances
// (PROG = true): thread 0 copies the program from the kernel parameter
// into shared memory, and each element runs it through merge.cuh's
// interpreter, the lanes of a 16-byte vector one after another. The
// BILINEAR / SAFE_DIV instances (PROG = false) are unchanged. A program
// instance is bound by the interpreter's instructions, not by the bytes:
// PERF.md §6 gives its times beside the code instance's.
#include <cstdint>
#include <type_traits>

#include "merge.cuh"

template <typename T> struct Vec16;
template <> struct Vec16<float> { using V = float4; static constexpr int W = 4; };
template <> struct Vec16<double> { using V = double2; static constexpr int W = 2; };

template <typename T, bool VEC, bool PROG>
__global__ void merge_join_kernel(
    const T* __restrict__ a, const T* __restrict__ b,
    const bool* __restrict__ mask_a, const bool* __restrict__ mask_b,
    T* __restrict__ out, long long m, long long n, int bs, int gn, int mode,
    std::conditional_t<PROG, MergeProgram, MergeCode> merge) {
  const SharedProgram<T>* prog = nullptr;
  if constexpr (PROG) {
    __shared__ SharedProgram<T> s_prog;
    if (threadIdx.x == 0) s_prog.load(merge);
    __syncthreads();
    prog = &s_prog;
  }
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
        if constexpr (PROG) {
          // one interpreter loop for the W lanes, not W inlined copies
#pragma unroll 1
          for (int k = 0; k < W; ++k)
            lane_set<W>(ol, k, (*prog)(lane_get<W>(xl, k),
                                       lane_get<W>(yl, k)));
        } else {
#pragma unroll
          for (int k = 0; k < W; ++k)
            ol[k] = apply_merge<T>(merge, xl[k], yl[k]);
        }
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
      if constexpr (PROG)
        out[off] = live ? (*prog)(a[off], b[off]) : T(0);
      else
        out[off] = live ? apply_merge<T>(merge, a[off], b[off]) : T(0);
    }
  }
}

template <typename T, bool PROG, typename M>
static cudaError_t launch(const void* a, const void* b, const void* ma,
                          const void* mb, void* out, long long m, long long n,
                          int bs, int mode, int vec, const M& merge,
                          cudaStream_t stream) {
  const long long gm = (m + bs - 1) / bs, gn = (n + bs - 1) / bs;
  const int threads = 256;
  const long long tiles = gm * gn;
  if (vec)
    merge_join_kernel<T, true, PROG><<<(unsigned)tiles, threads, 0, stream>>>(
        (const T*)a, (const T*)b, (const bool*)ma, (const bool*)mb, (T*)out,
        m, n, bs, (int)gn, mode, merge);
  else
    merge_join_kernel<T, false, PROG><<<(unsigned)tiles, threads, 0, stream>>>(
        (const T*)a, (const T*)b, (const bool*)ma, (const bool*)mb, (T*)out,
        m, n, bs, (int)gn, mode, merge);
  return cudaGetLastError();
}

// op MERGE_PROGRAM takes the program at `prog` (copied into the launch's
// parameter) and ignores the coefficients; the other ops ignore `prog`.
extern "C" int merge_join_launch(int value_code, const void* a, const void* b,
                                 const void* mask_a, const void* mask_b,
                                 void* out, long long m, long long n, int bs,
                                 int mode, int vec, int op, double c0,
                                 double cx, double cy, double cxy,
                                 const MergeProgram* prog, void* stream) {
  if (m <= 0 || n <= 0) return 0;
  if (bs <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (op == MERGE_PROGRAM) {
    if (prog == nullptr || prog->n < 0 || prog->n > kProgCode)
      return (int)cudaErrorInvalidValue;
    const MergeProgram p = *prog;
    if (value_code == 0)
      return (int)launch<float, true>(a, b, mask_a, mask_b, out, m, n, bs,
                                      mode, vec, p, s);
    if (value_code == 1)
      return (int)launch<double, true>(a, b, mask_a, mask_b, out, m, n, bs,
                                       mode, vec, p, s);
    return (int)cudaErrorInvalidValue;
  }
  MergeCode merge{op, c0, cx, cy, cxy};
  if (value_code == 0)
    return (int)launch<float, false>(a, b, mask_a, mask_b, out, m, n, bs,
                                     mode, vec, merge, s);
  if (value_code == 1)
    return (int)launch<double, false>(a, b, mask_a, mask_b, out, m, n, bs,
                                      mode, vec, merge, s);
  return (int)cudaErrorInvalidValue;
}
