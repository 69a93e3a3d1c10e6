// merge_join: block-skip overlay join, B read as it lies (row-major, or a
// transposed view of a row-major matrix).
//
// Replaces the TPU kernel merge_join_pallas (src/repro/kernels/
// merge_join.py, body _kernel, gating rule mode_for): for each
// bs x bs tile (i, j), out = merge(A tile, B tile) where the tile is live,
// else 0. Live is ma & mb under MODE_BOTH (0), ma under MODE_X (1), mb under
// MODE_Y (2), always under MODE_ALL (3).
//
// Bound on the H100: device-memory bytes — 2 * sizeof(T) per live element
// read, sizeof(T) per element written; there is one merge per element.
//
// Design. The work is cut into units: a unit is one tile's band of `band`
// rows, and one CTA of kMjThreads threads takes one unit (the block
// scheduler balances live against dead units). A unit reads its tile's
// two mask bits and derives `live` from the mode; a dead unit only gets
// its zero stores, its inputs are never loaded. Units are
// numbered so that CTAs launched together read neighbouring memory: with B
// direct along a band of rows across the tile row (the same rows of the
// next tile), with B transposed down a tile's bands (the next pieces of the
// same rows of Bo).
//  - B direct (contiguous, like A and out: one offset serves all three):
//    thread (tx, ty) of a tx x ty layout owns one 16-byte column vector of
//    the band (one element on the scalar path) in rows ty, ty + ty_count,
//    ...: it starts `unroll` loads of A and `unroll` of B (read-only path,
//    ld.global.nc) before it merges any, and the addresses advance by the
//    row stride (no division in the loop). MjPlan sets unroll per merge.
//  - B transposed (b = Boᵀ, Bo row-major with rows ldb apart): a band of
//    kMjBandT rows takes its columns in slabs. B's part of a slab is one
//    row of Bo a column, kMjBandT elements each; the CTA reads them along
//    Bo's rows (coalesced) into shared memory, row stride kMjBandT + 1,
//    and reads them back transposed beside A's row-major reads. B is never
//    copied.
// The vector paths need 16-byte aligned pointers and n, bs (and, for a
// transposed B, m and ldb) multiples of the vector width (the wrapper
// checks); else the scalar paths run, whose accesses are one element a
// thread, neighbours on neighbouring elements. The ragged last row and
// column of tiles are masked here, so the wrapper pads nothing.
// The kernel is a template over its merge parameter P (merge.cuh): a
// MergeCode in the main library (merge_join.cu), a merge's generated
// functor in that merge's own library (kernels/build.py), where nvcc
// inlines it into the body like any other op. B's layout is a template
// parameter too: as a run-time branch, the transposed path's registers
// (shared-memory staging of both operands) lowered the direct instances'
// occupancy, and they ran slower on an H100.
#pragma once

#include <climits>
#include <cstdint>
#include <type_traits>

#include "merge.cuh"

template <typename T> struct Vec16;
template <> struct Vec16<float> { using V = float4; static constexpr int W = 4; };
template <> struct Vec16<double> { using V = double2; static constexpr int W = 2; };

// What one thread moves at a time: a 16-byte vector or one element.
template <typename T, bool VEC> struct MjLane {
  using V = T;
  static constexpr int W = 1;
};
template <typename T> struct MjLane<T, true> {
  using V = typename Vec16<T>::V;
  static constexpr int W = Vec16<T>::W;
};

constexpr int kMjThreads = 256;
constexpr int kMjBandT = 32;   // rows of a unit on the transposed paths

// How a merge's instances take their rows: `unroll` rows a thread in
// flight and `groups` such groups a unit (B direct), and `tr_vec` /
// `tr_scalar` lanes of each operand a thread holds a slab with B
// transposed. A streaming merge keeps four 16-byte loads of each operand
// in flight. A code merge holds two 16-byte lanes (four elements on the
// scalar path) a slab; a generated merge holds one: its slow paths are
// calls, and the lanes held across them made ptxas spill. A generated merge
// whose code carries a long slow path (a division or remainder, taken on
// every zero divisor of a sparse operand; a sine's argument reduction)
// says kSlowPaths: its instruction stream, not the loads in flight, bounds
// it, so it takes one row at a time, eight rows a unit, and its B-direct
// instances launch merge_join_slow_kernel, which asks ptxas for more
// resident CTAs (at most 40 registers a thread for float, 80 for double).
template <typename P, typename = void>
struct MjPlan {
  static constexpr bool slow = false;
  static constexpr int unroll = 4, groups = 1;
  static constexpr int tr_vec = std::is_same_v<P, MergeCode> ? 2 : 1;
  static constexpr int tr_scalar = std::is_same_v<P, MergeCode> ? 4 : 1;
};
template <typename P>
struct MjPlan<P, std::enable_if_t<P::kSlowPaths>> {
  static constexpr bool slow = true;
  static constexpr int unroll = 1, groups = 8;
  static constexpr int tr_vec = 1, tr_scalar = 1;
};

// The launch's shape, computed on the host (merge_join_shape).
struct MjShape {
  long long m, n, ldb;
  int bs, gn, mode;
  int band, bands, tx, ty;  // rows a unit, units a tile, thread layout
  int units;
};

template <typename F>
__device__ __forceinline__ float mj_merge(const F& f, float x, float y) {
  return f(x, y);
}
template <typename F>
__device__ __forceinline__ double mj_merge(const F& f, double x, double y) {
  return f(x, y);
}
template <typename F>
__device__ __forceinline__ float4 mj_merge(const F& f, float4 x, float4 y) {
  return make_float4(f(x.x, y.x), f(x.y, y.y), f(x.z, y.z), f(x.w, y.w));
}
template <typename F>
__device__ __forceinline__ double2 mj_merge(const F& f, double2 x,
                                            double2 y) {
  return make_double2(f(x.x, y.x), f(x.y, y.y));
}

template <typename V> __device__ __forceinline__ V mj_zero() { return V(0); }
template <> __device__ __forceinline__ float4 mj_zero<float4>() {
  return make_float4(0.f, 0.f, 0.f, 0.f);
}
template <> __device__ __forceinline__ double2 mj_zero<double2>() {
  return make_double2(0.0, 0.0);
}

// A lane of Bo into a slab's row: its W values at row[0 .. W).
__device__ __forceinline__ void mj_put(float* row, float v) { row[0] = v; }
__device__ __forceinline__ void mj_put(double* row, double v) { row[0] = v; }
__device__ __forceinline__ void mj_put(float* row, float4 v) {
  row[0] = v.x;
  row[1] = v.y;
  row[2] = v.z;
  row[3] = v.w;
}
__device__ __forceinline__ void mj_put(double* row, double2 v) {
  row[0] = v.x;
  row[1] = v.y;
}

// A lane of A merged with B's values down a slab's column: s[0], s[ld], ...
template <typename F>
__device__ __forceinline__ float mj_merge_col(const F& f, float x,
                                              const float* s, int) {
  return f(x, s[0]);
}
template <typename F>
__device__ __forceinline__ double mj_merge_col(const F& f, double x,
                                               const double* s, int) {
  return f(x, s[0]);
}
template <typename F>
__device__ __forceinline__ float4 mj_merge_col(const F& f, float4 x,
                                               const float* s, int ld) {
  return make_float4(f(x.x, s[0]), f(x.y, s[ld]), f(x.z, s[2 * ld]),
                     f(x.w, s[3 * ld]));
}
template <typename F>
__device__ __forceinline__ double2 mj_merge_col(const F& f, double2 x,
                                                const double* s, int ld) {
  return make_double2(f(x.x, s[0]), f(x.y, s[ld]));
}

// One unit with B direct (or a dead unit of either layout): rows r0 ..
// r0 + rows, columns c0 .. c0 + cols. A thread takes U rows ty_count
// apart in each group of rows.
template <typename T, bool VEC, int U, typename F>
__device__ __forceinline__ void mj_direct_unit(
    const T* __restrict__ a, const T* __restrict__ b, T* __restrict__ out,
    const F& mrg, bool live, const MjShape& g, int tx, int ty, long long r0,
    long long c0, int rows, int cols) {
  using L = MjLane<T, VEC>;
  using V = typename L::V;
  if (ty >= g.ty) return;
  const int cv = cols / L::W;  // the wrapper keeps cols % W == 0 for vectors
  const long long step = (long long)g.ty * g.n;  // elements between rows
  for (int rg = ty; rg < rows; rg += g.ty * U) {
    for (int c = tx; c < cv; c += g.tx) {
      const long long off = (r0 + rg) * g.n + c0 + (long long)c * L::W;
      if (!live) {
#pragma unroll
        for (int k = 0; k < U; ++k)
          if (rg + k * g.ty < rows)
            *reinterpret_cast<V*>(out + off + k * step) = mj_zero<V>();
        continue;
      }
      V x[U], y[U];
#pragma unroll
      for (int k = 0; k < U; ++k) {
        if (rg + k * g.ty < rows) {
          x[k] = __ldg(reinterpret_cast<const V*>(a + off + k * step));
          y[k] = __ldg(reinterpret_cast<const V*>(b + off + k * step));
        }
      }
#pragma unroll
      for (int k = 0; k < U; ++k)
        if (rg + k * g.ty < rows)
          *reinterpret_cast<V*>(out + off + k * step) =
              mj_merge(mrg, x[k], y[k]);
    }
  }
}

// One live unit with B transposed: rows r0 .. r0 + rows (rows <= kMjBandT)
// of out, columns c0 .. c0 + cols, B's values at bo[col * ldb + row]. A
// slab is kSlab columns; each thread moves kPer lanes of Bo and kPer of A
// a slab (MjPlan's tr_vec or tr_scalar), all loads before the first merge
// (at most two 16-byte lanes each: four kept 32 registers live, and ptxas
// spilled). Every thread of the CTA calls it (it synchronises).
template <typename T, bool VEC, int kPer, typename F>
__device__ __forceinline__ void mj_transposed_unit(
    const T* __restrict__ a, const T* __restrict__ bo, T* __restrict__ out,
    const F& mrg, const MjShape& g, long long r0, long long c0, int rows,
    int cols) {
  using L = MjLane<T, VEC>;
  using V = typename L::V;
  constexpr int W = L::W;
  constexpr int kSlab = kPer * kMjThreads * W / kMjBandT;  // columns
  constexpr int kSeg = kMjBandT / W;      // lanes in a Bo row's segment
  constexpr int kRow = kSlab / W;         // lanes in a slab's row of A
  static_assert(kSlab * kMjBandT == kPer * kMjThreads * W, "slab tiling");
  __shared__ T slab[kSlab][kMjBandT + 1];
  const int t = threadIdx.x;
  for (int cs = 0; cs < cols; cs += kSlab) {
    const int cn = cols - cs < kSlab ? cols - cs : kSlab;
    V bv[kPer], av[kPer];
#pragma unroll
    for (int i = 0; i < kPer; ++i) {
      const int e = t + kMjThreads * i, j = e / kSeg, q = (e % kSeg) * W;
      if (j < cn && q < rows)
        bv[i] = __ldg(reinterpret_cast<const V*>(
            bo + (c0 + cs + j) * g.ldb + r0 + q));
    }
#pragma unroll
    for (int i = 0; i < kPer; ++i) {
      const int e = t + kMjThreads * i, r = e / kRow, c = (e % kRow) * W;
      if (r < rows && c < cn)
        av[i] = __ldg(reinterpret_cast<const V*>(
            a + (r0 + r) * g.n + c0 + cs + c));
    }
#pragma unroll
    for (int i = 0; i < kPer; ++i) {
      const int e = t + kMjThreads * i, j = e / kSeg, q = (e % kSeg) * W;
      if (j < cn && q < rows) mj_put(&slab[j][q], bv[i]);
    }
    __syncthreads();
#pragma unroll
    for (int i = 0; i < kPer; ++i) {
      const int e = t + kMjThreads * i, r = e / kRow, c = (e % kRow) * W;
      if (r < rows && c < cn)
        *reinterpret_cast<V*>(out + (r0 + r) * g.n + c0 + cs + c) =
            mj_merge_col(mrg, av[i], &slab[c][r], kMjBandT + 1);
    }
    __syncthreads();  // the next slab overwrites this one
  }
}

template <typename T, bool VEC, bool TR, typename P>
__device__ __forceinline__ void mj_units(
    const T* __restrict__ a, const T* __restrict__ b,
    const bool* __restrict__ mask_a, const bool* __restrict__ mask_b,
    T* __restrict__ out, const MjShape& g, const P& merge) {
  const auto mrg = device_merge<T>(merge);
  const int tx = threadIdx.x % g.tx, ty = threadIdx.x / g.tx;
  // The grid is g.units CTAs (at most INT_MAX, so the unsigned step cannot
  // wrap) and the loop runs once a CTA. As straight-line code ptxas spilled
  // around the math library's slow-path calls in instances where, as this
  // loop, it does not.
  for (unsigned un = blockIdx.x; un < (unsigned)g.units; un += gridDim.x) {
    const int u = (int)un;
    int bi, bj, band;
    if constexpr (TR) {  // a tile's bands first
      const int tile = u / g.bands;
      band = u - tile * g.bands;
      bi = tile / g.gn;
      bj = tile - bi * g.gn;
    } else {             // a band across the tile row first
      const int rest = u / g.gn;
      bj = u - rest * g.gn;
      bi = rest / g.bands;
      band = rest - bi * g.bands;
    }
    const int tile = bi * g.gn + bj;
    const bool la = mask_a[tile], lb = mask_b[tile];
    const bool live = g.mode == 0 ? (la && lb)
                    : g.mode == 1 ? la
                    : g.mode == 2 ? lb : true;
    const long long t0 = (long long)bi * g.bs;
    const long long r0 = t0 + (long long)band * g.band;
    const long long tile_end = t0 + g.bs < g.m ? t0 + g.bs : g.m;
    if (r0 >= tile_end) continue;  // the ragged last band (CTA-uniform)
    const int rows = (int)(tile_end - r0 < g.band ? tile_end - r0 : g.band);
    const long long c0 = (long long)bj * g.bs;
    const int cols = (int)(g.n - c0 < g.bs ? g.n - c0 : g.bs);
    if constexpr (TR) {
      constexpr int per = VEC ? MjPlan<P>::tr_vec : MjPlan<P>::tr_scalar;
      if (live)
        mj_transposed_unit<T, VEC, per>(a, b, out, mrg, g, r0, c0, rows,
                                        cols);
      else
        mj_direct_unit<T, VEC, MjPlan<P>::unroll>(a, b, out, mrg, false, g,
                                                  tx, ty, r0, c0, rows, cols);
    } else {
      mj_direct_unit<T, VEC, MjPlan<P>::unroll>(a, b, out, mrg, live, g, tx,
                                                ty, r0, c0, rows, cols);
    }
  }
}

template <typename T, bool VEC, bool TR, typename P>
__global__ void __launch_bounds__(kMjThreads) merge_join_kernel(
    const T* __restrict__ a, const T* __restrict__ b,
    const bool* __restrict__ mask_a, const bool* __restrict__ mask_b,
    T* __restrict__ out, const MjShape g, P merge) {
  mj_units<T, VEC, TR, P>(a, b, mask_a, mask_b, out, g, merge);
}

template <typename T, bool VEC, bool TR, typename P>
__global__ void __launch_bounds__(kMjThreads, sizeof(T) == 4 ? 6 : 3)
    merge_join_slow_kernel(const T* __restrict__ a, const T* __restrict__ b,
                           const bool* __restrict__ mask_a,
                           const bool* __restrict__ mask_b,
                           T* __restrict__ out, const MjShape g, P merge) {
  static_assert(!TR, "a transposed B keeps merge_join_kernel");
  mj_units<T, VEC, TR, P>(a, b, mask_a, mask_b, out, g, merge);
}

// The kernel of one instance: the slow-path one for a B-direct instance of
// a kSlowPaths merge (only the one taken is instantiated).
template <typename T, bool VEC, bool TR, typename P>
static auto mj_kernel() {
  if constexpr (!TR && MjPlan<P>::slow)
    return merge_join_slow_kernel<T, VEC, TR, P>;
  else
    return merge_join_kernel<T, VEC, TR, P>;
}

// The unit layout of one launch: a tx x ty layout of threads over a
// tile's row of vectors, and the band: kMjBandT rows with B transposed,
// else MjPlan's groups of its unroll rows a thread.
template <typename T, typename P>
static cudaError_t merge_join_shape(MjShape* g, long long m, long long n,
                                    long long ldb, int bs, int mode, int vec,
                                    int transposed) {
  const long long gm = (m + bs - 1) / bs, gn = (n + bs - 1) / bs;
  const int w = vec ? Vec16<T>::W : 1;
  const int per_row = bs / w;  // vectors in a tile's row
  const int tx = per_row < kMjThreads ? per_row : kMjThreads;
  const int ty = kMjThreads / tx;
  const int band =
      transposed ? kMjBandT : ty * MjPlan<P>::unroll * MjPlan<P>::groups;
  const long long bands = (bs + band - 1) / band;
  // a CTA a unit: the grid's x dimension and the kernel's unit and tile
  // indices (ints) hold at most INT_MAX units
  if (gm * gn * bands > INT_MAX) return cudaErrorInvalidValue;
  *g = MjShape{m,    n,          ldb, bs, (int)gn, mode,
               band, (int)bands, tx,  ty, (int)(gm * gn * bands)};
  return cudaSuccess;
}

template <typename T, bool VEC, bool TR, typename P>
static cudaError_t merge_join_run_as(const void* a, const void* b,
                                     const void* ma, const void* mb,
                                     void* out, const MjShape& g,
                                     const P& merge, cudaStream_t stream) {
  const auto kernel = mj_kernel<T, VEC, TR, P>();
  kernel<<<(unsigned)g.units, kMjThreads, 0, stream>>>(
      (const T*)a, (const T*)b, (const bool*)ma, (const bool*)mb, (T*)out, g,
      merge);
  return cudaGetLastError();
}

template <typename T, typename P>
static cudaError_t merge_join_run(const void* a, const void* b, const void* ma,
                                  const void* mb, void* out, long long m,
                                  long long n, long long ldb, int bs,
                                  int mode, int vec, int transposed,
                                  const P& merge, cudaStream_t stream) {
  if (vec && bs % Vec16<T>::W != 0) return cudaErrorInvalidValue;
  MjShape g;
  const cudaError_t err =
      merge_join_shape<T, P>(&g, m, n, ldb, bs, mode, vec, transposed);
  if (err != cudaSuccess) return err;
  if (vec && transposed)
    return merge_join_run_as<T, true, true, P>(a, b, ma, mb, out, g,
                                               merge, stream);
  if (vec)
    return merge_join_run_as<T, true, false, P>(a, b, ma, mb, out, g,
                                                merge, stream);
  if (transposed)
    return merge_join_run_as<T, false, true, P>(a, b, ma, mb, out, g,
                                                merge, stream);
  return merge_join_run_as<T, false, false, P>(a, b, ma, mb, out, g,
                                               merge, stream);
}

// value_code 0 float (merge parameter p32), 1 double (p64). The arguments
// up to `transposed` are those of every merge_join launcher, main library
// and generated (kernels/build.py binds them in this order).
template <typename P32, typename P64>
static int merge_join_dispatch(int value_code, const void* a, const void* b,
                               const void* mask_a, const void* mask_b,
                               void* out, long long m, long long n,
                               long long ldb, int bs, int mode, int vec,
                               int transposed, const P32& p32,
                               const P64& p64, void* stream) {
  if (m <= 0 || n <= 0) return 0;
  if (bs <= 0 || ldb < 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (value_code == 0)
    return (int)merge_join_run<float>(a, b, mask_a, mask_b, out, m, n, ldb,
                                      bs, mode, vec, transposed, p32, s);
  if (value_code == 1)
    return (int)merge_join_run<double>(a, b, mask_a, mask_b, out, m, n, ldb,
                                       bs, mode, vec, transposed, p64, s);
  return (int)cudaErrorInvalidValue;
}
