// masked_matmul: C = A x B on the live output tiles, zero on the dead ones.
//
// Replaces the TPU kernel masked_matmul_pallas (src/repro/kernels/
// masked_matmul.py, body _kernel): out[i, j] = (A x B)[i, j] where
// mask[i / bs, j / bs] is set, else 0. Products accumulate in float32 and
// are stored in A's dtype (float32 or bfloat16), as the Pallas body's
// promote_types(a.dtype, f32) followed by .astype(a.dtype). float32 runs
// as IEEE FFMA, never TF32.
//
// Bound on the H100: device-memory bytes. On the PNMF path (W 16384 x 32,
// H 32 x 16384, 1229 of 4096 256^2 tiles live) every output element is
// written once, 1.07 GB: 0.32 ms at 3.35 TB/s, while the live tiles'
// 5.2 GFLOP take 0.08 ms at the 67 TFLOP/s float32 rate. The kernel this
// design replaced, one CTA per 64^2 sub-tile, was far from both ends of
// that: its zero stores ran at 1.92 TB/s with every tile dead, its 4 x 4
// register tiles at 10.8 TFLOP/s with every tile live.
//
// Design:
//  - A persistent pool of SMs x CTAs-per-SM CTAs (from the occupancy
//    query: two of 256 threads at <= 128 registers, one at kc 64 whose
//    panels take 135 KB). Each CTA takes
//    128 x 128 output units, in row-major order, from one atomic counter
//    that the wrapper zeroes for every call, until the units run out;
//    thread 0 draws one index ahead, so the atomic's round trip overlaps
//    a unit's work. A unit is written whole by one CTA in a fixed order,
//    so the output is bit-identical from launch to launch whoever takes
//    which unit.
//  - The gate: the CTA reads the mask entries its unit overlaps, one when
//    bs % 128 == 0 (256 on the main path). Where a unit spans several
//    entries (bs 16 or 64, ragged edges) a live unit is computed whole and
//    the store zeroes each element whose own entry is dead.
//  - A dead unit reads no A or B: each thread stores 16 bytes of zeros at
//    a time with evict-first stores, neighbours on neighbouring addresses
//    (4 KB per CTA-wide instruction), scalar where n is not a multiple of
//    16 bytes. Nothing but the counter stands between two dead units, so
//    the all-dead end is a stream of stores.
//  - A live unit walks K in chunks of kc, staged in shared memory as float
//    in k-major panels A [kc][128] and B [kc][128], two buffers of each
//    (66 KB dynamic at kc 32). kc is a launch parameter, the autotuner's
//    grid {16, 32, 64} (kernels/masked_matmul.py: GRID; default 32), each
//    an instance for float32 and bfloat16 with its own pool. Each of the
//    16 x 16 threads accumulates an 8 x 8
//    register tile: rows ty*4 + {0..3} and 64 + ty*4 + {0..3}, columns
//    likewise in tx, so per k four LDS.128 (free of bank conflicts) feed
//    64 FFMA, against two for 16 in a 4 x 4 tile. While one buffer is
//    multiplied, the other takes the next chunk or, after a unit's last
//    chunk, the first chunk of the CTA's next live unit. The second CTA on
//    the SM can compute while this one waits on the counter, its A loads
//    or its stores.
//    The 64 accumulators leave no register to spare: values derived from
//    threadIdx are recomputed where they are used (tid()), which keeps
//    ptxas at 127 registers and no spills.
//  - Two load paths. B (H [32, 16384], row-major on the main path) goes by
//    cp.async (16 bytes, .cg, zero-filled past the edges) into the other
//    buffer, when it is float32 with unit column stride and 16-byte
//    aligned rows. A (W [16384, 32]) must be transposed into its k-major
//    panel, which cp.async cannot do: it is read with 16-byte loads (four
//    consecutive k of one row; a warp reads 16 rows x 32 bytes, whole
//    sectors) and stored transposed through registers, conflict-free,
//    when it is float32 with unit k stride and 16-byte aligned rows. Every
//    other operand (bfloat16, a transposed or misaligned view) takes the
//    plain path: element loads converted to float. The main path takes
//    cp.async for B and the 16-byte loads for A. Both paths put the same
//    floats in shared memory, so they give bit-identical results.
//  - Accumulation is fmaf with k ascending, chunk after chunk (the order
//    of the one-CTA-per-64^2 kernel this replaces), whatever kc is: the
//    zero-filled k past the end add +0 to a sum that starts at +0 and so
//    is never -0, so every kc gives the same bits. Ragged M, N and K are
//    bounds-checked here (zero-filled panels), so the wrapper pads
//    nothing; A and B come with their strides.
// Its times on the card, beside the bound and both ends, are printed by
// chip_smoke.py's masked_matmul line and kept in PERF.md.
//
// float64 (masked_matmul_f64_kernel) accumulates in double, as the Pallas
// body does (out dtype promote_types(f64, f32) = f64, preferred_element_type
// f64). It is a plain tiled DFMA kernel, not the pool above: one CTA per
// 64 x 64 output tile, whose gate is the OR of the mask entries it
// overlaps (elements under a dead entry are stored as 0 where it spans
// several); 16 x 16 threads each hold a 4 x 4 register tile at rows
// ty + 16i and columns tx + 16j, so each shared-memory read of a k row is
// conflict-free; K goes in chunks of kc (the same grid, 16/32/64) staged
// in shared memory, A k-major and B as is, each element read by its own
// thread with the operands' strides (coalesced along k for A and along n
// for B when row-major). Accumulation is fma with k ascending from +0,
// zero-filled past the edges, so every kc gives the same bits. It is
// bound by the bytes of its output on the PNMF path, as the float32
// kernel; FP64 tensor-core MMA is later work.
#include <climits>
#include <cstdint>
#include <mutex>
#include <type_traits>

#include <cuda_bf16.h>

namespace {

constexpr int UNIT = 128;      // output unit edge
constexpr int HALF = UNIT / 2; // a thread's two row (column) groups
constexpr int THREADS = 256;   // 16 x 16 threads, 8 x 8 outputs each
constexpr int LD = UNIT + 4;   // panel row in floats, keeps float4 alignment
// The K chunk staged in shared memory is the template parameter KC
// (16, 32 or 64); a panel holds KC rows of LD floats.
__host__ __device__ constexpr int panel(int kc) { return kc * LD; }
__host__ __device__ constexpr int smem_bytes(int kc) {  // {A, B} x 2
  return 2 * 2 * panel(kc) * (int)sizeof(float);
}
// CTAs an SM that registers must allow: two (128 registers a thread at
// most) where two CTAs' panels fit in the SM's shared memory, else one
__host__ __device__ constexpr int min_ctas(int kc) {
  return 2 * smem_bytes(kc) <= 232448 ? 2 : 1;
}

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

// four consecutive elements in one evict-first store (16 bytes for float,
// 8 for bf16)
__device__ __forceinline__ void store4(float* p, const float v[4]) {
  __stcs(reinterpret_cast<float4*>(p), make_float4(v[0], v[1], v[2], v[3]));
}
__device__ __forceinline__ void store4(__nv_bfloat16* p, const float v[4]) {
  const __nv_bfloat162 lo = __floats2bfloat162_rn(v[0], v[1]);
  const __nv_bfloat162 hi = __floats2bfloat162_rn(v[2], v[3]);
  uint2 u;
  u.x = *reinterpret_cast<const uint32_t*>(&lo);
  u.y = *reinterpret_cast<const uint32_t*>(&hi);
  __stcs(reinterpret_cast<uint2*>(p), u);
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

// Row and column indices are int (the launch refuses m, n or k near
// INT_MAX); element offsets are long long.
struct Shape {
  int m, n, k;
  long long sa0, sa1, sb0, sb1;
  int gn;                 // mask columns
  int bs;
  int units_n, units;     // units along n, in all
  int chunks;             // K chunks (one zero-filled chunk when k == 0)
  int a_vec, b_async;     // float32 load paths (ignored for bf16)
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
  return unit / s.units_n * UNIT;
}
__device__ __forceinline__ int unit_col(const Shape& s, int unit) {
  return unit % s.units_n * UNIT;
}

// Take the next unit from the queue and read its gate. Every thread of the
// CTA calls it together, and all get the same unit and the same gate.
// Thread 0 hands out the index it drew at the last take and draws the
// following one now, so the atomic's round trip overlaps a unit's work.
// A CTA stops at the first index past the last unit; the one it drew
// after that is past the end too, so no unit is left untaken.
__device__ __forceinline__ int take(int* counter,
                                    const bool* __restrict__ mask,
                                    const Shape& s, int* slot, int* drawn,
                                    bool* live) {
  if (tid() == 0) {
    *slot = *drawn;
    *drawn = atomicAdd(counter, 1);
  }
  __syncthreads();
  const int unit = *slot;
  int seen = 0;
  if (unit < s.units) {
    const int r0 = unit_row(s, unit), c0 = unit_col(s, unit);
    const int r1 = imin(r0 + UNIT, s.m) - 1, c1 = imin(c0 + UNIT, s.n) - 1;
    const int mr0 = r0 / s.bs, mc0 = c0 / s.bs;
    const int nc = c1 / s.bs - mc0 + 1;
    const int entries = (r1 / s.bs - mr0 + 1) * nc;
    for (int e = tid(); e < entries; e += THREADS)
      seen |= mask[(long long)(mr0 + e / nc) * s.gn + mc0 + e % nc];
  }
  *live = __syncthreads_or(seen);
  return unit;
}

// Stage chunk `chunk` of `unit` in one buffer: A rows r0.. x k0.. into
// `as`, B rows k0.. x columns c0.. into the panel after it, both k-major,
// zero past the edges.
template <int KC, typename T>
__device__ __forceinline__ void load_panels(const T* __restrict__ a,
                                            const T* __restrict__ b,
                                            const Shape& s, int unit,
                                            int chunk, float* as) {
  float* bp = as + panel(KC);
  constexpr bool f32 = std::is_same<T, float>::value;
  const int t = tid();
  const int r0 = unit_row(s, unit), c0 = unit_col(s, unit);
  const int k0 = chunk * KC;
  // B: a warp copies one panel row of 128 columns, 16 bytes a thread;
  // thread t holds column c0 + 4 (t % 32) of rows k0 + t / 32 + 8 it
  if (f32 && s.b_async) {
    const int c = (t % 32) * 4, gc = c0 + c;
    const int bytes = gc < s.n ? 4 * imin(s.n - gc, 4) : 0;
    const float* bf = reinterpret_cast<const float*>(b);
    const float* src = bf + (long long)(k0 + t / 32) * s.sb0 + gc;
    float* dst = bp + (t / 32) * LD + c;
#pragma unroll
    for (int it = 0; it < KC / 8; ++it) {
      const bool in = k0 + t / 32 + 8 * it < s.k && bytes > 0;
      cp_async16(dst + 8 * it * LD, in ? src + 8 * it * s.sb0 : bf,
                 in ? bytes : 0);
    }
  } else {
    for (int e = t; e < KC * UNIT; e += THREADS) {
      const int kk = e / UNIT, c = e % UNIT;
      const int gk = k0 + kk, gc = c0 + c;
      bp[kk * LD + c] = (gk < s.k && gc < s.n)
                            ? to_f(b[gk * s.sb0 + gc * s.sb1]) : 0.f;
    }
  }
  // A: lane l of warp w holds row 16w + l % 16 and, in step it, the four
  // k from 4 * (l / 16) + 8 * it; stored transposed, 32 banks a warp
  const int lane = t % 32;
  const int row = lane % 16 + 16 * (t / 32), gr = r0 + row;
  const int kq = 4 * (lane / 16);
  if (f32 && s.a_vec && gr < s.m && k0 + KC <= s.k) {
    const float4* src = reinterpret_cast<const float4*>(
        reinterpret_cast<const float*>(a) + gr * s.sa0 + k0 + kq);
    float4 x[KC / 8];
#pragma unroll
    for (int it = 0; it < KC / 8; ++it) x[it] = src[2 * it];
#pragma unroll
    for (int it = 0; it < KC / 8; ++it) {
      float* d = as + (kq + 8 * it) * LD + row;
      d[0] = x[it].x; d[LD] = x[it].y; d[2 * LD] = x[it].z; d[3 * LD] = x[it].w;
    }
  } else {
    for (int it = 0; it < KC / 8; ++it) {
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int gk = k0 + kq + 8 * it + q;
        as[(kq + 8 * it + q) * LD + row] =
            (gr < s.m && gk < s.k) ? to_f(a[gr * s.sa0 + gk * s.sa1]) : 0.f;
      }
    }
  }
}

// acc[i][j] += A[row i] * B[column j] over one staged chunk; row i is
// ty*4 + i for i < 4 and HALF + ty*4 + i - 4 after, columns likewise.
template <int KC>
__device__ __forceinline__ void multiply(const float* __restrict__ as,
                                         const float* __restrict__ bp,
                                         float acc[8][8]) {
  const int ty = tid() / 16, tx = tid() % 16;
  as += ty * 4;
  bp += tx * 4;
#pragma unroll
  for (int kk = 0; kk < KC; ++kk) {
    const float4 a0 = *reinterpret_cast<const float4*>(as + kk * LD);
    const float4 a1 = *reinterpret_cast<const float4*>(as + kk * LD + HALF);
    const float4 b0 = *reinterpret_cast<const float4*>(bp + kk * LD);
    const float4 b1 = *reinterpret_cast<const float4*>(bp + kk * LD + HALF);
    const float x[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
    const float y[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(x[i], y[j], acc[i][j]);
  }
}

// Store a live unit: every element in the matrix. When the unit spans
// several mask entries, zero each element whose own entry is dead.
template <typename T>
__device__ __forceinline__ void store_live(T* __restrict__ out,
                                           const bool* __restrict__ mask,
                                           const Shape& s, int unit,
                                           const float acc[8][8]) {
  const int ty = tid() / 16, tx = tid() % 16;
  const int r0 = unit_row(s, unit), c0 = unit_col(s, unit);
  const int r1 = imin(r0 + UNIT, s.m) - 1, c1 = imin(c0 + UNIT, s.n) - 1;
  const bool uniform = r0 / s.bs == r1 / s.bs && c0 / s.bs == c1 / s.bs;
  const bool vec = s.n % 4 == 0;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int r = r0 + (i / 4) * HALF + ty * 4 + i % 4;
    if (r >= s.m) continue;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int c = c0 + h * HALF + tx * 4;
      if (c >= s.n) continue;
      float v[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) v[j] = acc[i][h * 4 + j];
      if (!uniform) {
        const bool* mrow = mask + (long long)(r / s.bs) * s.gn;
#pragma unroll
        for (int j = 0; j < 4; ++j)
          if (c + j < s.n && !mrow[(c + j) / s.bs]) v[j] = 0.f;
      }
      T* o = out + (long long)r * s.n + c;
      if (vec && c + 3 < s.n) {
        store4(o, v);
      } else {
        for (int j = 0; j < 4 && c + j < s.n; ++j) o[j] = from_f<T>(v[j]);
      }
    }
  }
}

// Store a dead unit: zeros, 16 bytes a thread, neighbours on neighbouring
// addresses.
template <typename T>
__device__ __forceinline__ void store_dead(T* __restrict__ out,
                                           const Shape& s, int unit) {
  constexpr int V = 16 / (int)sizeof(T);  // elements per store
  constexpr int PER_ROW = UNIT / V;       // threads per unit row
  constexpr int ROWS = THREADS / PER_ROW; // unit rows per instruction
  const int r0 = unit_row(s, unit);
  const int t = tid();
  const int c = unit_col(s, unit) + (t % PER_ROW) * V;
  if (c >= s.n) return;
  const bool vec = s.n % V == 0;
#pragma unroll 4
  for (int rr = t / PER_ROW; rr < UNIT; rr += ROWS) {
    const int r = r0 + rr;
    if (r >= s.m) break;
    T* o = out + (long long)r * s.n + c;
    if (vec) {
      __stcs(reinterpret_cast<uint4*>(o), make_uint4(0u, 0u, 0u, 0u));
    } else {
      for (int j = 0; j < V && c + j < s.n; ++j) o[j] = from_f<T>(0.f);
    }
  }
}

template <typename T, int KC>
__global__ void __launch_bounds__(THREADS, min_ctas(KC))
masked_matmul_kernel(const T* __restrict__ a, const T* __restrict__ b,
                     const bool* __restrict__ mask, T* __restrict__ out,
                     int* counter, const Shape s) {
  constexpr int PANEL = panel(KC);
  extern __shared__ __align__(16) float panels[];  // [buffer][A, B][KC][LD]
  __shared__ int slot;
  int drawn = tid() == 0 ? atomicAdd(counter, 1) : 0;  // thread 0's draw
  int buf = 0;
  bool live, staged = false;  // staged: the unit's first chunk is in `buf`
  int unit = take(counter, mask, s, &slot, &drawn, &live);
  while (unit < s.units) {
    if (!live) {
      store_dead(out, s, unit);
      unit = take(counter, mask, s, &slot, &drawn, &live);
      continue;
    }
    if (!staged) {
      load_panels<KC>(a, b, s, unit, 0, panels + buf * 2 * PANEL);
      cp_async_commit();
    }
    bool next_live;
    const int next = take(counter, mask, s, &slot, &drawn, &next_live);
    float acc[8][8];
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;
    for (int c = 0; c < s.chunks; ++c) {
      // the loads that follow chunk c: chunk c + 1 of this unit or, after
      // its last chunk, the first chunk of the next unit if that is live
      const bool more = c + 1 < s.chunks;
      if (more || next_live)
        load_panels<KC>(a, b, s, more ? unit : next, more ? c + 1 : 0,
                        panels + (buf ^ 1) * 2 * PANEL);
      cp_async_commit();
      cp_async_wait_older();
      __syncthreads();
      const float* cur = panels + buf * 2 * PANEL;
      multiply<KC>(cur, cur + PANEL, acc);
      __syncthreads();
      buf ^= 1;
    }
    store_live(out, mask, s, unit, acc);
    unit = next;
    live = staged = next_live;
  }
  cp_async_wait_all();
}

struct Pool {
  int sms = 0, per_sm = 0;
};

// The pool of one instance on the current device, queried once per
// device and instance (its shared-memory opt-in with it).
template <typename T, int KC>
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
    err = cudaFuncSetAttribute(masked_matmul_kernel<T, KC>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               smem_bytes(KC));
    if (err == cudaSuccess)
      err = cudaDeviceGetAttribute(&c.sms, cudaDevAttrMultiProcessorCount,
                                   dev);
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &c.per_sm, masked_matmul_kernel<T, KC>, THREADS, smem_bytes(KC));
    if (err == cudaSuccess && c.per_sm < 1) err = cudaErrorInvalidConfiguration;
    if (err != cudaSuccess) {
      c = Pool();
      return err;
    }
  }
  *p = c;
  return cudaSuccess;
}

template <typename T, int KC>
cudaError_t launch(const void* a, const void* b, const void* mask, void* out,
                   long long m, long long n, long long k, long long sa0,
                   long long sa1, long long sb0, long long sb1, int bs,
                   cudaStream_t stream, void* counter) {
  Pool p;
  cudaError_t err = pool<T, KC>(&p);
  if (err != cudaSuccess) return err;
  // row, column and chunk indices run a unit or a chunk past the edges
  if (m > INT_MAX - 2 * UNIT || n > INT_MAX - 2 * UNIT ||
      k > INT_MAX - 2 * KC)
    return cudaErrorInvalidValue;
  const long long units_n = (n + UNIT - 1) / UNIT;
  const long long units = (m + UNIT - 1) / UNIT * units_n;
  const long long slots = (long long)p.sms * p.per_sm;
  // every CTA draws two indices past the last unit before it stops
  if (units + 2 * slots > INT_MAX) return cudaErrorInvalidValue;
  constexpr bool f32 = std::is_same<T, float>::value;
  Shape s;
  s.m = (int)m; s.n = (int)n; s.k = (int)k;
  s.sa0 = sa0; s.sa1 = sa1; s.sb0 = sb0; s.sb1 = sb1;
  s.gn = (int)((n + bs - 1) / bs);
  s.bs = bs;
  s.units_n = (int)units_n;
  s.units = (int)units;
  s.chunks = k > 0 ? (int)((k + KC - 1) / KC) : 1;
  s.a_vec = f32 && sa1 == 1 && sa0 % 4 == 0 &&
            reinterpret_cast<uintptr_t>(a) % 16 == 0;
  s.b_async = f32 && sb1 == 1 && sb0 % 4 == 0 &&
              reinterpret_cast<uintptr_t>(b) % 16 == 0;
  const unsigned grid = (unsigned)(units < slots ? units : slots);
  masked_matmul_kernel<T, KC><<<grid, THREADS, smem_bytes(KC), stream>>>(
      (const T*)a, (const T*)b, (const bool*)mask, (T*)out, (int*)counter, s);
  return cudaGetLastError();
}

constexpr int D_TILE = 64;          // float64 output tile edge
constexpr int D_LD = D_TILE + 1;    // a staged row of doubles, padded
__host__ __device__ constexpr int d_smem_bytes(int kc) {  // {A, B}
  return 2 * kc * D_LD * (int)sizeof(double);
}

template <int KC>
__global__ void __launch_bounds__(THREADS)
masked_matmul_f64_kernel(const double* __restrict__ a,
                         const double* __restrict__ b,
                         const bool* __restrict__ mask,
                         double* __restrict__ out, const Shape s) {
  extern __shared__ __align__(16) double dpanels[];
  double* as = dpanels;             // [KC][D_LD]: as[k][row]
  double* bp = dpanels + KC * D_LD; // [KC][D_LD]: bp[k][column]
  const int tiles_n = (s.n + D_TILE - 1) / D_TILE;
  const int r0 = blockIdx.x / tiles_n * D_TILE;
  const int c0 = blockIdx.x % tiles_n * D_TILE;
  const int t = threadIdx.x, ty = t / 16, tx = t % 16;
  const int r1 = imin(r0 + D_TILE, s.m) - 1, c1 = imin(c0 + D_TILE, s.n) - 1;
  const int mr0 = r0 / s.bs, mc0 = c0 / s.bs;
  const int nc = c1 / s.bs - mc0 + 1;
  const int entries = (r1 / s.bs - mr0 + 1) * nc;
  int seen = 0;
  for (int e = t; e < entries; e += THREADS)
    seen |= mask[(long long)(mr0 + e / nc) * s.gn + mc0 + e % nc];
  const bool live = __syncthreads_or(seen);
  double acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.0;
  if (live) {
    for (int k0 = 0; k0 < s.k; k0 += KC) {
      for (int e = t; e < KC * D_TILE; e += THREADS) {
        const int kk = e % KC, rr = e / KC;           // A along k
        const int gr = r0 + rr, gk = k0 + kk;
        as[kk * D_LD + rr] = (gr < s.m && gk < s.k)
                                 ? a[gr * s.sa0 + gk * s.sa1] : 0.0;
        const int kb = e / D_TILE, cc = e % D_TILE;   // B along n
        const int gkb = k0 + kb, gc = c0 + cc;
        bp[kb * D_LD + cc] = (gkb < s.k && gc < s.n)
                                 ? b[gkb * s.sb0 + gc * s.sb1] : 0.0;
      }
      __syncthreads();
#pragma unroll 4
      for (int kk = 0; kk < KC; ++kk) {
        double x[4], y[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) x[i] = as[kk * D_LD + ty + 16 * i];
#pragma unroll
        for (int j = 0; j < 4; ++j) y[j] = bp[kk * D_LD + tx + 16 * j];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) acc[i][j] = fma(x[i], y[j], acc[i][j]);
      }
      __syncthreads();
    }
  }
  const bool uniform = r0 / s.bs == r1 / s.bs && c0 / s.bs == c1 / s.bs;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = r0 + ty + 16 * i;
    if (r >= s.m) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int c = c0 + tx + 16 * j;
      if (c >= s.n) continue;
      const bool keep =
          uniform || mask[(long long)(r / s.bs) * s.gn + c / s.bs];
      out[(long long)r * s.n + c] = keep ? acc[i][j] : 0.0;
    }
  }
}

// Lets the float64 kernel of kc take its shared memory (above 48 KB at kc
// 64), once a device and kc.
template <int KC>
cudaError_t f64_allow() {
  constexpr int MAX_DEVICES = 64;
  static std::mutex mu;
  static bool done[MAX_DEVICES];
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < 0 || dev >= MAX_DEVICES) return cudaErrorInvalidDevice;
  std::lock_guard<std::mutex> lock(mu);
  if (!done[dev]) {
    err = cudaFuncSetAttribute(masked_matmul_f64_kernel<KC>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               d_smem_bytes(KC));
    if (err != cudaSuccess) return err;
    done[dev] = true;
  }
  return cudaSuccess;
}

template <int KC>
cudaError_t launch_f64(const void* a, const void* b, const void* mask,
                       void* out, long long m, long long n, long long k,
                       long long sa0, long long sa1, long long sb0,
                       long long sb1, int bs, cudaStream_t stream) {
  if (m > INT_MAX - 2 * D_TILE || n > INT_MAX - 2 * D_TILE ||
      k > INT_MAX - 2 * KC)
    return cudaErrorInvalidValue;
  const long long tiles =
      (m + D_TILE - 1) / D_TILE * ((n + D_TILE - 1) / D_TILE);
  if (tiles > INT_MAX) return cudaErrorInvalidValue;
  cudaError_t err = f64_allow<KC>();
  if (err != cudaSuccess) return err;
  Shape s;
  s.m = (int)m; s.n = (int)n; s.k = (int)k;
  s.sa0 = sa0; s.sa1 = sa1; s.sb0 = sb0; s.sb1 = sb1;
  s.gn = (int)((n + bs - 1) / bs);
  s.bs = bs;
  s.units_n = s.units = s.chunks = s.a_vec = s.b_async = 0;  // unused
  masked_matmul_f64_kernel<KC><<<(unsigned)tiles, THREADS, d_smem_bytes(KC),
                                 stream>>>(
      (const double*)a, (const double*)b, (const bool*)mask, (double*)out, s);
  return cudaGetLastError();
}

// Calls f(T(), std::integral_constant<int, KC>()) for value_code 0 float32,
// 1 bfloat16 and kc 16, 32 or 64; cudaErrorInvalidValue for anything else.
template <typename F>
int by_instance(int value_code, int kc, F&& f) {
  auto with_kc = [&](auto t) -> int {
    if (kc == 16) return f(t, std::integral_constant<int, 16>());
    if (kc == 32) return f(t, std::integral_constant<int, 32>());
    if (kc == 64) return f(t, std::integral_constant<int, 64>());
    return (int)cudaErrorInvalidValue;
  };
  if (value_code == 0) return with_kc(float());
  if (value_code == 1) return with_kc(__nv_bfloat16());
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// value_code: 0 float32, 1 bfloat16, 2 float64; kc: the K chunk, 16, 32
// or 64. The output is contiguous [m, n]; counter is one int32 on the
// device, zero at launch (the work queue; float64 does not use it).
extern "C" int masked_matmul_launch(int value_code, int kc, const void* a,
                                    const void* b, const void* mask,
                                    void* out, long long m, long long n,
                                    long long k, long long sa0, long long sa1,
                                    long long sb0, long long sb1, int bs,
                                    void* stream, void* counter) {
  if (m <= 0 || n <= 0) return 0;
  if (bs <= 0 || k < 0 || counter == nullptr)
    return (int)cudaErrorInvalidValue;
  if (value_code == 2) {
    cudaStream_t st = (cudaStream_t)stream;
    if (kc == 16)
      return (int)launch_f64<16>(a, b, mask, out, m, n, k, sa0, sa1, sb0,
                                 sb1, bs, st);
    if (kc == 32)
      return (int)launch_f64<32>(a, b, mask, out, m, n, k, sa0, sa1, sb0,
                                 sb1, bs, st);
    if (kc == 64)
      return (int)launch_f64<64>(a, b, mask, out, m, n, k, sa0, sa1, sb0,
                                 sb1, bs, st);
    return (int)cudaErrorInvalidValue;
  }
  return by_instance(value_code, kc, [&](auto t, auto kc_c) {
    return (int)launch<decltype(t), decltype(kc_c)::value>(
        a, b, mask, out, m, n, k, sa0, sa1, sb0, sb1, bs,
        (cudaStream_t)stream, counter);
  });
}

// The persistent pool of an instance on the current device: SMs and CTAs
// per SM.
extern "C" int masked_matmul_pool(int value_code, int kc, int* sms,
                                  int* ctas_per_sm) {
  Pool p;
  const int err = by_instance(value_code, kc, [&](auto t, auto kc_c) {
    return (int)pool<decltype(t), decltype(kc_c)::value>(&p);
  });
  if (err != 0) return err;
  *sms = p.sms;
  *ctas_per_sm = p.per_sm;
  return 0;
}
