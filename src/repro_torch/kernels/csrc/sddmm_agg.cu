// sddmm_agg: SUM of sp ∘ (W·H) over rows, columns or everything, on the
// live tiles only; the m x n product never exists in device memory.
//
// Replaces the TPU kernel sddmm_agg_pallas (src/repro/kernels/
// sddmm_agg.py, bodies _row_kernel, _col_kernel, _all_kernel). dim 0
// ("row") gives out[m], dim 1 ("col") out[n], dim 2 ("all") out[1]. A tile
// (i, j) of bs x bs contributes only where mask[i, j] is set, even where sp
// is nonzero under a dead entry (the Pallas semantics). float32
// accumulates in float32 (IEEE FFMA, never TF32), float64 in float64.
//
// Bound on the H100: device-memory bytes, the live tiles of sp. On the
// PNMF path (sp 16384^2, W 16384 x 32, H 32 x 16384, 1229 of 4096 256^2
// tiles live) that is 322 MB, 0.097 ms at 3.35 TB/s; W and H are 4 MB and
// stay in the 50 MB L2. The (2K + 2) operations per live element, 5.3
// GFLOP, take 0.079 ms at the 67 TFLOP/s float32 rate: the two ends are
// close, so the kernel nears its bound only if the sp stream runs under
// the products. The kernel this design replaced (one CTA per 256^2 tile,
// 64^2 sub-tiles with panels restaged for each, 4 x 4 register tiles, sp
// read after the products) ran at 3.4-3.6x the bound.
//
// Design, in three launches, deterministic and with no atomics:
//  1. A schedule: one CTA reads the mask entries under each 128 x 128
//     unit (one entry when bs % 128 == 0, 256 on the main path; the first
//     entries of a thread's units are loaded together) and lists the live
//     units in ascending order, with their count, on the device.
//  2. A persistent pool of SMs x CTAs-per-SM CTAs of 256 threads (the
//     occupancy query: two for float32) walks the list by a static stride:
//     CTA b takes list entries b, b + grid, ... Live units all cost the
//     same, so the stride shares them out evenly, without a counter or the
//     round trip of a draw; a dead unit is not in the list and costs
//     nothing, and no count goes back to the host.
//     A live unit stages W [128, K] and H [K, 128] in k-major panels, K in
//     chunks of 32, zero-filled past the edges. H goes by cp.async (16
//     bytes, .cg) when it is float32 with unit column stride and 16-byte
//     aligned rows; W is read into registers with 16-byte loads when it is
//     float32 with unit k stride and 16-byte aligned rows, and stored
//     transposed. Each of the 16 x 16 threads accumulates an 8 x 8
//     register tile in FMA: rows ty*4 + {0..3} and 64 + ty*4 + {0..3},
//     columns likewise in tx, so per k four LDS.128 (free of bank
//     conflicts) feed 64 FFMA.
//  3. The sp stream runs under the products. The unit's 128 x 128 sp tile
//     (64 KB in float32) is issued by cp.async, 16 bytes a thread, zero
//     past the edges, right after the first H panel and as a cp.async
//     group of its own; the CTA waits on it only after the products. The
//     sp tile and one set of panels take 97 KB, which keeps two CTAs on an
//     SM, so one CTA's products also run while the other waits. (One CTA
//     an SM with two buffers of each, the next unit's tile in flight into
//     shared memory, ran the PNMF shapes slower on the card: eight warps
//     an SM leave the FFMA loop short of warps.) On the card the FFMA
//     loop, not the bytes, sets this design's pace (PERF.md).
//     Every other operand (a transposed or misaligned view, float64) takes
//     a plain path of element loads that puts the same values in shared
//     memory, so the paths give bit-identical results.
//  4. The epilogue multiplies the accumulators by the sp tile from shared
//     memory and writes one partial per row ([units_n, m] buffer, sums
//     across the 16 tx lanes by shuffles), per column ([units_m, n], sums
//     across ty through shared memory in a fixed order) or per unit (at
//     the unit's place in the list). Where a unit spans several mask
//     entries (bs 16 or 64, ragged edges, bs not a multiple of 128) a live
//     unit is computed whole and each element whose own entry is dead is
//     dropped before the sums.
//  5. A last launch sums, for each output element, the partials of the
//     live units in ascending unit order: rows and columns read the mask
//     and take a unit's partial where the line's own entries under the
//     unit have one live (otherwise it is unwritten or exactly zero);
//     everything sums the list's partials in list order. So no buffer is
//     zeroed, and since every unit is computed whole by one CTA in a fixed
//     order, the output is bit-identical from launch to launch.
// Divisions by the units along n and by bs are a multiply and a shift
// (FastDiv). float64 runs the same code with one CTA an SM (its 8 x 8
// accumulators take 128 registers, its sp tile 128 KB); it is not on the
// main path. Times on the card, beside the bound and both ends, are
// printed by chip_smoke.py's sddmm_agg line and kept in PERF.md.
#include <climits>
#include <cstdint>
#include <mutex>
#include <type_traits>

namespace {

constexpr int UNIT = 128;        // unit edge
constexpr int HALF = UNIT / 2;   // a thread's two row (column) groups
constexpr int KC = 32;           // K chunk staged in shared memory
constexpr int THREADS = 256;     // 16 x 16 threads, 8 x 8 elements each
constexpr int WARPS = THREADS / 32;
constexpr int LD = UNIT + 4;     // panel row in elements
constexpr int PANEL = KC * LD;   // elements per panel
constexpr int TILE = UNIT * UNIT;
constexpr int SUM_THREADS = 1024;
constexpr int PER = 16;          // units a schedule thread reads a round
constexpr int LINES = 32;        // output elements per second-pass CTA
constexpr int GROUPS = 32;       // unit groups per second-pass CTA
constexpr int FETCH = 4;         // units a second-pass thread reads at once

// CTAs an SM: float64's accumulators take 128 registers
template <typename T> struct Traits;
template <> struct Traits<float> { static constexpr int min_ctas = 2; };
template <> struct Traits<double> { static constexpr int min_ctas = 1; };

// dynamic shared memory: the {W, H} panels, then the sp tile
template <typename T> constexpr int smem_bytes() {
  return (2 * PANEL + TILE) * (int)sizeof(T);
}

__device__ __forceinline__ float fmadd(float a, float b, float c) {
  return fmaf(a, b, c);
}
__device__ __forceinline__ double fmadd(double a, double b, double c) {
  return fma(a, b, c);
}

__device__ __forceinline__ void load4(const float* p, float* v) {
  const float4 x = *reinterpret_cast<const float4*>(p);
  v[0] = x.x; v[1] = x.y; v[2] = x.z; v[3] = x.w;
}
__device__ __forceinline__ void load4(const double* p, double* v) {
  const double2 x = reinterpret_cast<const double2*>(p)[0];
  const double2 y = reinterpret_cast<const double2*>(p)[1];
  v[0] = x.x; v[1] = x.y; v[2] = y.x; v[3] = y.y;
}

__device__ __forceinline__ void cp_async16(float* dst, const float* src,
                                           int bytes) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d),
               "l"(src), "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
// every group but the newest has landed
__device__ __forceinline__ void cp_async_wait_older() {
  asm volatile("cp.async.wait_group 1;\n" ::: "memory");
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// x / d for 0 <= x < 2^31 and a divisor d >= 1 fixed for the launch, by
// a multiply and a shift (Granlund and Montgomery's round-up method:
// l = ceil(log2 d), mul = floor(2^32 (2^l - d) / d) + 1).
struct FastDiv {
  unsigned mul;
  int shift;
};

FastDiv fast_div(int d) {
  FastDiv f;
  f.shift = 0;
  while ((1LL << f.shift) < d) ++f.shift;
  f.mul = (unsigned)((((1ULL << f.shift) - d) << 32) / d + 1);
  return f;
}

__device__ __forceinline__ int operator/(int x, const FastDiv& f) {
  return (int)((__umulhi(f.mul, (unsigned)x) + (unsigned)x) >> f.shift);
}

// Row and column indices are int (the launch refuses m, n or k near
// INT_MAX); element offsets are long long.
struct Shape {
  int m, n, k;
  long long ss0, ss1, sw0, sw1, sh0, sh1;
  int gn;                        // mask columns
  FastDiv by_bs, by_units_n;
  int one_entry;                 // bs % UNIT == 0: a unit has one entry
  int units_m, units_n, units;   // units down m, along n, in all
  int chunks;                    // K chunks (one zero-filled when k == 0)
  int dim;                       // 0 row, 1 col, 2 all
  int sp_async, w_vec, h_async;  // float32 load paths
};

__device__ __forceinline__ int imin(int x, int y) { return x < y ? x : y; }

// threadIdx.x, read where it is used: a volatile read keeps the compiler
// from hoisting every value derived from it into a register that lives
// across the accumulator loop
__device__ __forceinline__ int tid() {
  int t;
  asm volatile("mov.u32 %0, %%tid.x;" : "=r"(t));
  return t;
}

__device__ __forceinline__ int unit_row(const Shape& s, int unit) {
  return unit / s.by_units_n * UNIT;
}
__device__ __forceinline__ int unit_col(const Shape& s, int unit) {
  return (unit - unit / s.by_units_n * s.units_n) * UNIT;
}

// The mask entry of element (r, c).
__device__ __forceinline__ bool entry(const bool* __restrict__ mask,
                                      const Shape& s, int r, int c) {
  return mask[(long long)(r / s.by_bs) * s.gn + c / s.by_bs];
}

// Is any mask entry under the unit (clipped to the matrix) set?
__device__ __forceinline__ bool unit_live(const bool* __restrict__ mask,
                                          const Shape& s, int unit) {
  const int r0 = unit_row(s, unit), c0 = unit_col(s, unit);
  const int r1 = imin(r0 + UNIT, s.m) - 1, c1 = imin(c0 + UNIT, s.n) - 1;
  const int mc0 = c0 / s.by_bs, mc1 = c1 / s.by_bs;
  for (int mr = r0 / s.by_bs; mr <= r1 / s.by_bs; ++mr)
    for (int mc = mc0; mc <= mc1; ++mc)
      if (mask[(long long)mr * s.gn + mc]) return true;
  return false;
}

// list[0 .. count) = the live units in ascending order, list[units] =
// count. One CTA; a round reads SUM_THREADS * PER units, PER consecutive
// ones a thread.
__global__ void __launch_bounds__(SUM_THREADS)
schedule_kernel(const bool* __restrict__ mask, int* __restrict__ list,
                const Shape s) {
  __shared__ int warp_off[SUM_THREADS / 32 + 1];  // exclusive, then total
  const int t = threadIdx.x, lane = t % 32, warp = t / 32;
  int listed = 0;
  for (int base = 0; base < s.units; base += SUM_THREADS * PER) {
    const int u0 = base + t * PER;
    unsigned live = 0;  // bit j: unit u0 + j
#pragma unroll
    for (int j = 0; j < PER; ++j)  // the first entries, loaded together
      if (u0 + j < s.units &&
          entry(mask, s, unit_row(s, u0 + j), unit_col(s, u0 + j)))
        live |= 1u << j;
    if (!s.one_entry)
      for (int j = 0; j < PER && u0 + j < s.units; ++j)
        if (!(live >> j & 1) && unit_live(mask, s, u0 + j))
          live |= 1u << j;
    const int mine = __popc(live);
    int incl = mine;  // inclusive scan across the warp
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const int y = __shfl_up_sync(0xffffffffu, incl, off);
      if (lane >= off) incl += y;
    }
    if (lane == 31) warp_off[warp] = incl;
    __syncthreads();
    if (warp == 0) {  // the same scan across the 32 warps
      const int x = warp_off[lane];
      int xi = x;
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
        const int y = __shfl_up_sync(0xffffffffu, xi, off);
        if (lane >= off) xi += y;
      }
      warp_off[lane] = xi - x;
      if (lane == 31) warp_off[32] = xi;
    }
    __syncthreads();
    int at = listed + warp_off[warp] + incl - mine;
#pragma unroll
    for (int j = 0; j < PER; ++j)
      if (live >> j & 1) list[at++] = u0 + j;
    listed += warp_off[32];
    __syncthreads();
  }
  if (t == 0) list[s.units] = listed;
}

// Stage chunk `chunk` of `unit`: H rows k0.. x columns c0.. into the H
// panel (k-major, after the W panel `wp`), one cp.async group; with
// `tile` also the unit's sp tile, a second group; then W rows r0.. x k0..
// into the W panel, k-major, stored transposed through registers. All
// zero past the edges.
template <typename T>
__device__ __forceinline__ void load_step(const T* __restrict__ w,
                                          const T* __restrict__ h,
                                          const T* __restrict__ sp,
                                          const Shape& s, int unit,
                                          int chunk, T* wp, T* tile) {
  constexpr bool f32 = std::is_same<T, float>::value;
  T* hp = wp + PANEL;
  const int r0 = unit_row(s, unit), c0 = unit_col(s, unit);
  const int k0 = chunk * KC;
  // H: a warp copies one panel row of 128 columns, 16 bytes a thread;
  // thread t holds column c0 + 4 (t % 32) of rows k0 + t / 32 + 8 it
  bool done = false;
  if constexpr (f32) {
    if (s.h_async) {
      const int c = (tid() % 32) * 4, gc = c0 + c, kk = tid() / 32;
      const int bytes = gc < s.n ? 4 * imin(s.n - gc, 4) : 0;
      const float* src = h + (long long)(k0 + kk) * s.sh0 + gc;
      float* dst = hp + kk * LD + c;
#pragma unroll
      for (int it = 0; it < KC / 8; ++it) {
        const bool in = k0 + kk + 8 * it < s.k && bytes > 0;
        cp_async16(dst + 8 * it * LD, in ? src + 8 * it * s.sh0 : h,
                   in ? bytes : 0);
      }
      done = true;
    }
  }
  if (!done) {
    for (int e = tid(); e < KC * UNIT; e += THREADS) {
      const int kk = e / UNIT, c = e % UNIT;
      const int gk = k0 + kk, gc = c0 + c;
      hp[kk * LD + c] = (gk < s.k && gc < s.n) ? h[gk * s.sh0 + gc * s.sh1]
                                                : T(0);
    }
  }
  cp_async_commit();
  // sp: a warp copies one tile row of 128 columns, 16 bytes a thread
  if (tile != nullptr) {
    done = false;
    if constexpr (f32) {
      if (s.sp_async) {
        const int c = (tid() % 32) * 4, gc = c0 + c;
        const int bytes = gc < s.n ? 4 * imin(s.n - gc, 4) : 0;
#pragma unroll 4
        for (int rr = tid() / 32; rr < UNIT; rr += WARPS) {
          const int gr = r0 + rr;
          const bool in = gr < s.m && bytes > 0;
          cp_async16(tile + rr * UNIT + c, in ? sp + gr * s.ss0 + gc : sp,
                     in ? bytes : 0);
        }
        done = true;
      }
    }
    if (!done) {
      for (int e = tid(); e < TILE; e += THREADS) {
        const int gr = r0 + e / UNIT, gc = c0 + e % UNIT;
        tile[e] = (gr < s.m && gc < s.n) ? sp[gr * s.ss0 + gc * s.ss1]
                                         : T(0);
      }
    }
    cp_async_commit();
  }
  // W: lane l of warp q holds row 16q + l % 16 and, in step it, the four
  // k from 4 * (l / 16) + 8 * it; a warp's stores fall in 32 banks
  const int lane = tid() % 32;
  const int row = lane % 16 + 16 * (tid() / 32), gr = r0 + row;
  const int kq = 4 * (lane / 16);
  T* d = wp + kq * LD + row;
  done = false;
  if constexpr (f32) {
    if (s.w_vec && gr < s.m && k0 + KC <= s.k) {
      const float4* src = reinterpret_cast<const float4*>(
          w + gr * s.sw0 + k0 + kq);
      float4 x[KC / 8];
#pragma unroll
      for (int it = 0; it < KC / 8; ++it) x[it] = src[2 * it];
#pragma unroll
      for (int it = 0; it < KC / 8; ++it) {
        d[8 * it * LD] = x[it].x;
        d[(8 * it + 1) * LD] = x[it].y;
        d[(8 * it + 2) * LD] = x[it].z;
        d[(8 * it + 3) * LD] = x[it].w;
      }
      done = true;
    }
  }
  if (!done) {
    for (int it = 0; it < KC / 8; ++it)
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int gk = k0 + kq + 8 * it + q;
        d[(8 * it + q) * LD] =
            (gr < s.m && gk < s.k) ? w[gr * s.sw0 + gk * s.sw1] : T(0);
      }
  }
}

// acc[i][j] += W[row i] * H[column j] over one staged chunk; row i is
// ty*4 + i for i < 4 and HALF + ty*4 + i - 4 after, columns likewise.
template <typename T>
__device__ __forceinline__ void multiply(const T* __restrict__ wp,
                                         const T* __restrict__ hp,
                                         T acc[8][8]) {
  const int ty = tid() / 16, tx = tid() % 16;
  wp += ty * 4;
  hp += tx * 4;
#pragma unroll
  for (int kk = 0; kk < KC; ++kk) {
    T x[8], y[8];
    load4(wp + kk * LD, x);
    load4(wp + kk * LD + HALF, x + 4);
    load4(hp + kk * LD, y);
    load4(hp + kk * LD + HALF, y + 4);
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) acc[i][j] = fmadd(x[i], y[j], acc[i][j]);
  }
}

// acc := sp ∘ acc over the unit, with each element whose own mask entry is
// dead dropped; then the unit's partials: one per row, per column, or one
// at `slot` (the unit's place in the list). `red` is shared scratch of
// WARPS x UNIT elements.
template <typename T>
__device__ __forceinline__ void epilogue(const bool* __restrict__ mask,
                                         T* __restrict__ part,
                                         const Shape& s, int unit, int slot,
                                         const T* tile, T* red,
                                         T acc[8][8]) {
  const int ty = tid() / 16, tx = tid() % 16;
  const int r0 = unit_row(s, unit), c0 = unit_col(s, unit);
  const int r1 = imin(r0 + UNIT, s.m) - 1, c1 = imin(c0 + UNIT, s.n) - 1;
  // bit 8i + j: element (i, j) lies under a dead entry (units that span
  // several entries only)
  unsigned long long dead = 0;
  if (!s.one_entry &&
      (r0 / s.by_bs != r1 / s.by_bs || c0 / s.by_bs != c1 / s.by_bs)) {
#pragma unroll 1
    for (int e = 0; e < 64; ++e) {
      const int i = e / 8, j = e % 8;
      const int r = r0 + (i / 4) * HALF + ty * 4 + i % 4;
      const int c = c0 + (j / 4) * HALF + tx * 4 + j % 4;
      if (r < s.m && c < s.n && !entry(mask, s, r, c)) dead |= 1ull << e;
    }
  }
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int rr = (i / 4) * HALF + ty * 4 + i % 4;
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int cc = hh * HALF + tx * 4;
      T v[4];
      load4(tile + rr * UNIT + cc, v);
#pragma unroll
      for (int j = 0; j < 4; ++j)
        acc[i][hh * 4 + j] = dead >> (8 * i + hh * 4 + j) & 1
                                 ? T(0) : acc[i][hh * 4 + j] * v[j];
    }
  }
  if (s.dim == 0) {
    // rows: each thread's eight columns, then across the 16 tx lanes
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      T v = ((acc[i][0] + acc[i][1]) + (acc[i][2] + acc[i][3])) +
            ((acc[i][4] + acc[i][5]) + (acc[i][6] + acc[i][7]));
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        v += __shfl_xor_sync(0xffffffffu, v, off);
      const int r = r0 + (i / 4) * HALF + ty * 4 + i % 4;
      if (tx == 0 && r < s.m)
        part[(long long)(unit_col(s, unit) / UNIT) * s.m + r] = v;
    }
  } else if (s.dim == 1) {
    // columns: each thread's eight rows, the two ty of a warp, then the
    // eight warps through shared memory in order
    const int lane = tid() % 32, warp = tid() / 32;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      T v = ((acc[0][j] + acc[1][j]) + (acc[2][j] + acc[3][j])) +
            ((acc[4][j] + acc[5][j]) + (acc[6][j] + acc[7][j]));
      v += __shfl_xor_sync(0xffffffffu, v, 16);
      if (lane < 16) red[warp * UNIT + (j / 4) * HALF + tx * 4 + j % 4] = v;
    }
    __syncthreads();
    const int t = tid();
    if (t < UNIT && c0 + t < s.n) {
      T v = red[t];
      for (int q = 1; q < WARPS; ++q) v += red[q * UNIT + t];
      part[(long long)(r0 / UNIT) * s.n + c0 + t] = v;
    }
  } else {
    // everything: each thread's 64, the warp, then the eight warps
    T v = T(0);
#pragma unroll
    for (int i = 0; i < 8; ++i)
      v += ((acc[i][0] + acc[i][1]) + (acc[i][2] + acc[i][3])) +
           ((acc[i][4] + acc[i][5]) + (acc[i][6] + acc[i][7]));
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      v += __shfl_xor_sync(0xffffffffu, v, off);
    if (tid() % 32 == 0) red[tid() / 32] = v;
    __syncthreads();
    if (tid() == 0) {
      T x = red[0];
      for (int q = 1; q < WARPS; ++q) x += red[q];
      part[slot] = x;
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(THREADS, Traits<T>::min_ctas)
sddmm_partial_kernel(const T* __restrict__ sp, const T* __restrict__ w,
                     const T* __restrict__ h, const bool* __restrict__ mask,
                     const int* __restrict__ list, T* __restrict__ part,
                     const Shape s) {
  extern __shared__ __align__(16) unsigned char smem[];
  T* panels = reinterpret_cast<T*>(smem);  // [W, H][KC][LD]
  T* tile = panels + 2 * PANEL;            // sp [UNIT][UNIT]
  const int count = list[s.units];
  for (int i = blockIdx.x; i < count; i += gridDim.x) {
    const int unit = list[i];
    T acc[8][8];
#pragma unroll
    for (int a = 0; a < 8; ++a)
#pragma unroll
      for (int b = 0; b < 8; ++b) acc[a][b] = T(0);
    for (int c = 0; c < s.chunks; ++c) {
      if (c > 0) __syncthreads();  // every thread is done with the panels
      // chunk 0 issues the sp tile too, as the newest group: wait for the
      // panels only
      load_step(w, h, sp, s, unit, c, panels, c == 0 ? tile : (T*)nullptr);
      if (c == 0) cp_async_wait_older(); else cp_async_wait_all();
      __syncthreads();
      multiply(panels, panels + PANEL, acc);
    }
    cp_async_wait_all();
    __syncthreads();  // the sp tile has landed; the panels are free
    epilogue(mask, part, s, unit, i, tile, panels, acc);
    __syncthreads();  // the tile and the scratch are free for the next unit
  }
}

// Rows (dim 0) or columns (dim 1): out[l] = the sum over units u along the
// other axis, in ascending order, of part[u * len + l], where the line's
// own mask entries under unit u have one live (zero is added for the
// others). A CTA takes LINES lines; group g of its threads sums u = g,
// g + GROUPS, ..., and the groups' sums are added in order.
template <typename T>
__global__ void __launch_bounds__(LINES * GROUPS)
sum_lines_kernel(const T* __restrict__ part, const bool* __restrict__ mask,
                 T* __restrict__ out, const Shape s) {
  __shared__ T red[GROUPS][LINES];
  const int lane = threadIdx.x % LINES, g = threadIdx.x / LINES;
  const bool rows = s.dim == 0;
  const int len = rows ? s.m : s.n, across = rows ? s.n : s.m;
  const int count = rows ? s.units_n : s.units_m;
  const long long l = (long long)blockIdx.x * LINES + lane;
  T v = T(0);
  if (l < len) {
    const int e = (int)l / s.by_bs;
    const auto seen = [&](int q) {
      return rows ? mask[(long long)e * s.gn + q]
                  : mask[(long long)q * s.gn + e];
    };
    // FETCH units at a time, their loads in flight together
    for (int u0 = g; u0 < count; u0 += FETCH * GROUPS) {
      bool any[FETCH];
#pragma unroll
      for (int j = 0; j < FETCH; ++j) {
        const int u = u0 + j * GROUPS;
        any[j] = u < count && seen(u * UNIT / s.by_bs);
      }
#pragma unroll
      for (int j = 0; j < FETCH; ++j) {
        const int u = u0 + j * GROUPS;
        if (any[j] || s.one_entry || u >= count) continue;
        const int q1 = (imin(u * UNIT + UNIT, across) - 1) / s.by_bs;
        for (int q = u * UNIT / s.by_bs + 1; q <= q1 && !any[j]; ++q)
          any[j] = seen(q);
      }
      T p[FETCH];
#pragma unroll
      for (int j = 0; j < FETCH; ++j)
        p[j] = any[j] ? part[(long long)(u0 + j * GROUPS) * len + l] : T(0);
#pragma unroll
      for (int j = 0; j < FETCH; ++j) v += p[j];
    }
  }
  red[g][lane] = v;
  __syncthreads();
  if (g == 0 && l < len) {
    T x = red[0][lane];
    for (int q = 1; q < GROUPS; ++q) x += red[q][lane];
    out[l] = x;
  }
}

// Everything: out[0] = the sum of the listed units' partials, in a fixed
// order: strided per-thread sums, then a shared-memory tree.
template <typename T>
__global__ void __launch_bounds__(SUM_THREADS)
sum_all_kernel(const T* __restrict__ part, const int* __restrict__ list,
               T* __restrict__ out, const Shape s) {
  __shared__ T red[SUM_THREADS];
  const int t = threadIdx.x;
  const int count = list[s.units];
  T v = T(0);
  for (int i = t; i < count; i += SUM_THREADS) v += part[i];
  red[t] = v;
  __syncthreads();
  for (int half = SUM_THREADS / 2; half > 0; half >>= 1) {
    if (t < half) red[t] += red[t + half];
    __syncthreads();
  }
  if (t == 0) out[0] = red[0];
}

struct Pool {
  int sms = 0, per_sm = 0;
};

// The pool for the current device, queried once per device and value type.
template <typename T>
cudaError_t pool(Pool* p) {
  constexpr int MAX_DEVICES = 64;
  static std::mutex mu;
  static Pool cache[MAX_DEVICES];
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < 0 || dev >= MAX_DEVICES) return cudaErrorInvalidDevice;
  std::lock_guard<std::mutex> lock(mu);
  Pool& c = cache[dev];
  if (c.per_sm == 0) {
    err = cudaFuncSetAttribute(sddmm_partial_kernel<T>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               smem_bytes<T>());
    if (err == cudaSuccess)
      err = cudaDeviceGetAttribute(&c.sms, cudaDevAttrMultiProcessorCount,
                                   dev);
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &c.per_sm, sddmm_partial_kernel<T>, THREADS, smem_bytes<T>());
    if (err == cudaSuccess && c.per_sm < 1) err = cudaErrorInvalidConfiguration;
    if (err != cudaSuccess) {
      c = Pool();
      return err;
    }
  }
  *p = c;
  return cudaSuccess;
}

template <typename T>
cudaError_t launch(const void* sp, const void* w, const void* h,
                   const void* mask, void* list, void* part, void* out,
                   long long m, long long n, long long k, long long ss0,
                   long long ss1, long long sw0, long long sw1,
                   long long sh0, long long sh1, int bs, int dim,
                   cudaStream_t stream) {
  Pool p;
  cudaError_t err = pool<T>(&p);
  if (err != cudaSuccess) return err;
  // row, column and chunk indices run a unit or a chunk past the edges
  if (m > INT_MAX - 2 * UNIT || n > INT_MAX - 2 * UNIT ||
      k > INT_MAX - 2 * KC)
    return cudaErrorInvalidValue;
  const long long units_m = (m + UNIT - 1) / UNIT;
  const long long units_n = (n + UNIT - 1) / UNIT;
  const long long units = units_m * units_n;
  // the schedule's rounds run past the last unit
  if (units > INT_MAX - SUM_THREADS * PER) return cudaErrorInvalidValue;
  constexpr bool f32 = std::is_same<T, float>::value;
  const auto aligned = [](const void* q) {
    return reinterpret_cast<uintptr_t>(q) % 16 == 0;
  };
  Shape s;
  s.m = (int)m; s.n = (int)n; s.k = (int)k;
  s.ss0 = ss0; s.ss1 = ss1; s.sw0 = sw0; s.sw1 = sw1; s.sh0 = sh0;
  s.sh1 = sh1;
  s.gn = (int)((n + bs - 1) / bs);
  s.by_bs = fast_div(bs);
  s.by_units_n = fast_div((int)units_n);
  s.one_entry = bs % UNIT == 0;
  s.units_m = (int)units_m;
  s.units_n = (int)units_n;
  s.units = (int)units;
  s.chunks = k > 0 ? (int)((k + KC - 1) / KC) : 1;
  s.dim = dim;
  s.sp_async = f32 && ss1 == 1 && ss0 % 4 == 0 && aligned(sp);
  s.w_vec = f32 && sw1 == 1 && sw0 % 4 == 0 && aligned(w);
  s.h_async = f32 && sh1 == 1 && sh0 % 4 == 0 && aligned(h);
  schedule_kernel<<<1, SUM_THREADS, 0, stream>>>((const bool*)mask,
                                                 (int*)list, s);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const long long slots = (long long)p.sms * p.per_sm;
  const unsigned grid = (unsigned)(units < slots ? units : slots);
  sddmm_partial_kernel<T><<<grid, THREADS, smem_bytes<T>(), stream>>>(
      (const T*)sp, (const T*)w, (const T*)h, (const bool*)mask,
      (const int*)list, (T*)part, s);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  if (dim == 2) {
    sum_all_kernel<T><<<1, SUM_THREADS, 0, stream>>>(
        (const T*)part, (const int*)list, (T*)out, s);
  } else {
    const long long len = dim == 0 ? m : n;
    sum_lines_kernel<T><<<(unsigned)((len + LINES - 1) / LINES),
                          LINES * GROUPS, 0, stream>>>(
        (const T*)part, (const bool*)mask, (T*)out, s);
  }
  return cudaGetLastError();
}

}  // namespace

// value_code: 0 float32, 1 float64; dim: 0 row, 1 col, 2 all. With units
// of 128 x 128, units_m = ceil(m / 128) and units_n = ceil(n / 128):
// `list` is int32 scratch of units_m * units_n + 1 elements, `part`
// scratch of units_n * m (row), units_m * n (col) or units_m * units_n
// (all) elements; `out` holds m, n or 1 elements. Nothing needs zeroing.
extern "C" int sddmm_agg_launch(int value_code, const void* sp, const void* w,
                                const void* h, const void* mask, void* list,
                                void* part, void* out, long long m,
                                long long n, long long k, long long ss0,
                                long long ss1, long long sw0, long long sw1,
                                long long sh0, long long sh1, int bs, int dim,
                                void* stream) {
  if (m <= 0 || n <= 0) return 0;
  if (bs <= 0 || k < 0 || dim < 0 || dim > 2)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (value_code == 0)
    return (int)launch<float>(sp, w, h, mask, list, part, out, m, n, k, ss0,
                              ss1, sw0, sw1, sh0, sh1, bs, dim, s);
  if (value_code == 1)
    return (int)launch<double>(sp, w, h, mask, list, part, out, m, n, k, ss0,
                               ss1, sw0, sw1, sh0, sh1, bs, dim, s);
  return (int)cudaErrorInvalidValue;
}

// The persistent pool on the current device: SMs and CTAs per SM.
extern "C" int sddmm_agg_pool(int value_code, int* sms, int* ctas_per_sm) {
  Pool p;
  cudaError_t err = cudaErrorInvalidValue;
  if (value_code == 0) err = pool<float>(&p);
  if (value_code == 1) err = pool<double>(&p);
  if (err != cudaSuccess) return (int)err;
  *sms = p.sms;
  *ctas_per_sm = p.per_sm;
  return 0;
}
