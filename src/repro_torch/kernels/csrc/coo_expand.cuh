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
// Bound on the H100: device-memory bytes, most of them the outputs: each
// slot writes (ca+cb) coords of 2 or 4 bytes and one value, while the
// side buffers are nnz-sized and read about once.
//
// Design: a load-balanced search over the merge path. The work is the
// merge of the segment ends with the slots 0..cap-1, an end e before a
// slot t when e <= t, so a slot's segment is the number of ends before
// it. Each CTA takes a fixed run of kThreads * vt items of that merge,
// whatever mix of slots and ends it holds: a run of empty segments costs
// what as many slots cost, never more. A CTA
//   1. finds where its run starts and ends: two warps, each a 128-way
//      search over `ends` (three round trips a CTA for Q4's 268 k
//      segments, the first from L1, in place of a 19-step binary search
//      a slot);
//   2. copies the ends and the metadata of its segments (delta, a_vals,
//      a_coords) into shared memory once, by cp.async, all in flight
//      together;
//   3. lets each thread find the start of its vt items by a search in
//      shared memory and walk them, noting each slot's segment;
//   4. runs a thread a slot, so neighbouring threads touch neighbouring
//      addresses: the partner gathers through the read-only path
//      (contiguous within a segment), all of a thread's issued before
//      any is used, then the merge, the value store, and the coords into
//      a shared tile;
//   5. writes the tile, which is the CTA's contiguous run of idx, with
//      16-byte stores, and scalar stores for its unaligned head and tail.
// Coordinates are templated on int16/int32 and values on float/double;
// the joins' coordinate counts (2 + 1 for D2D, 2 + 2 for V2V) are
// compiled as constants, any other count is taken at run time. Index
// arithmetic is 32-bit. Items a thread (vt) are a launch parameter, the
// autotuner's grid {4, 6, 8} (kernels/coo_join.py: GRID); the default, 8,
// takes 41 KB of shared memory a CTA. The fixed-width instances are
// compiled for each vt of the grid with float values, and for 8 alone
// with double (the wrapper refuses another vt there); the run-time-width
// instances take vt as an argument. Registers are bounded so that 5 CTAs
// fit on an SM; PERF.md §6 gives the times of each vt.
// The kernel is a template over its merge parameter P (merge.cuh): a
// MergeCode in the main library's instances (coo_expand.cu), a merge's
// generated functor in the run-time-width instances of that merge's own
// library (kernels/build.py), which take every width and every vt of the
// grid, in float32 and float64.
#pragma once

#include <cstdint>
#include <mutex>

#include "merge.cuh"

constexpr int kThreads = 256;
constexpr int kVt = 8;          // merge items a thread: the default, the most
constexpr int kProbes = 4;      // probes a lane in a round of the split search
constexpr int kMinBlocks = 5;   // CTAs an SM that registers must allow
// the same for a generated merge's run-time-width instances: at 5 (48
// registers) the run-time-width instance spills already with a code
// merge, and nearly every generated merge spills at 4 too; 3 (80
// registers) spills none of them
constexpr int kGeneratedMinBlocks = 3;
constexpr int kMaxSmem = 232448 - 64;  // the H100's 227 KB a block, less static

__host__ __device__ inline int up16(int x) { return (x + 15) & ~15; }

// Byte offsets of the dynamic shared memory. The idx tile sits at 0; the
// ends share its bytes, as they are read only before the tile is written.
struct Layout {
  int aval, delta, seg, acoord, bytes;
  __host__ __device__ Layout(int nv, int ca, int cb, int tsz, int csz) {
    const int tile = (nv * (ca + cb) + 16 / csz) * csz;  // + a 16-byte lead
    aval = up16(tile > nv * 4 ? tile : nv * 4);
    delta = aval + up16((nv + 1) * tsz);
    seg = delta + up16((nv + 1) * 4);
    acoord = seg + up16(nv * 2);
    bytes = acoord + up16((nv + 1) * ca * csz + 4);   // + a word's lead
  }
};

// Asynchronous copies (cp.async) of the bytes [src, src + n) into shared
// memory at dst, in 4-byte words: every load of the copy is in flight at
// once, and none passes through registers. src need only be aligned to
// its element; the word holding its first byte lands at dst, and the
// return value is where src's first byte landed. A word that holds a
// byte of an allocation lies wholly inside it.
__device__ __forceinline__ unsigned char* stage(unsigned char* dst,
                                                const void* src, int n) {
  const uintptr_t a = (uintptr_t)src & ~(uintptr_t)3;
  const int lead = (int)((uintptr_t)src - a);
  const int words = (lead + n + 3) >> 2;
  const unsigned base = (unsigned)__cvta_generic_to_shared(dst);
  for (int k = threadIdx.x; k < words; k += kThreads)
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(
                     base + 4 * k), "l"(a + 4 * k));
  return dst + lead;
}

// A slot's partner position, clamp(t + delta, 0, nb - 1), for t >= 0,
// without forming t + delta where it could overflow.
__device__ __forceinline__ int partner(int t, int delta, int nb) {
  return delta >= nb - 1 - t ? nb - 1 : (delta <= -t ? 0 : t + delta);
}

// The number of segment ends among the first d items of the merge: the
// first i in [lo, hi] with ends[i] + i >= d, where hi counts as true
// (ends[i] + i rises strictly with i). One warp probes 32 * kProbes
// places a round, all loads of a round issued together, so each round
// trip narrows the range that many times.
__device__ int merge_split(const int32_t* __restrict__ ends, int lo, int hi,
                           int d) {
  const int lane = threadIdx.x & 31;
  constexpr int kWay = 32 * kProbes;
  while (lo < hi) {
    const int step = (hi - lo + kWay - 1) / kWay;
    bool ok[kProbes];
#pragma unroll
    for (int r = 0; r < kProbes; ++r) {
      const int p = lo + (lane * kProbes + r) * step;
      ok[r] = p >= hi || __ldg(ends + p) >= d - p;
    }
    int first = kProbes;                      // this lane's first true probe
#pragma unroll
    for (int r = kProbes - 1; r >= 0; --r)
      if (ok[r]) first = r;
    const unsigned ball = __ballot_sync(0xffffffffu, first < kProbes);
    if (ball == 0u) {
      lo += (kWay - 1) * step + 1;
      continue;
    }
    const int f = __ffs(ball) - 1;
    const int k = f * kProbes + __shfl_sync(0xffffffffu, first, f);
    if (k == 0) return lo;                    // lo itself is true
    hi = min(hi, lo + k * step);
    lo += (k - 1) * step + 1;
  }
  return lo;
}

// Item, slot and segment counts fit int: the host checks cap + ns < 2^31.
// CA, CB > 0 fix the coordinate counts at compile time (the joins' 2 + 1
// and 2 + 2), and VT the items a thread; CA = CB = 0 takes the counts, and
// vt (at most VT), from the arguments. MINB is the CTAs an SM that
// registers must allow.
template <typename T, typename C, int CA, int CB, int VT, typename P,
          int MINB = kMinBlocks>
__global__ void __launch_bounds__(kThreads, MINB)
coo_expand_kernel(const int32_t* __restrict__ ends,
                  const int32_t* __restrict__ delta,
                  const T* __restrict__ a_vals, const C* __restrict__ a_coords,
                  const T* __restrict__ b_vals, const C* __restrict__ b_coords,
                  int ns, int nb, int ca_, int cb_, int cap, int vt_,
                  P merge,
                  C* __restrict__ idx_out, T* __restrict__ val_out) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ int split[2];
  const int ca = CA ? CA : ca_, cb = CB ? CB : cb_;
  const int vt = CA && CB ? VT : vt_;    // fixed widths always fit VT
  const int nv = kThreads * vt, w = ca + cb;
  const Layout lay(nv, ca, cb, sizeof(T), sizeof(C));
  C* s_idx = reinterpret_cast<C*>(smem);
  int32_t* s_ends = reinterpret_cast<int32_t*>(smem);
  const T* s_aval = reinterpret_cast<const T*>(smem + lay.aval);
  const int32_t* s_delta = reinterpret_cast<const int32_t*>(smem + lay.delta);
  int16_t* s_seg = reinterpret_cast<int16_t*>(smem + lay.seg);

  // 1. this CTA's run [d0, d1) of the merge, and the ends [i0, i1) in it
  const int d0 = blockIdx.x * nv;
  const int d1 = d0 + min(nv, cap + ns - d0);
  const int warp = threadIdx.x >> 5;
  if (warp < 2) {
    const int d = warp ? d1 : d0;
    const int i = merge_split(ends, max(0, d - cap), min(d, ns), d);
    if ((threadIdx.x & 31) == 0) split[warp] = i;
  }
  __syncthreads();
  const int i0 = split[0], i1 = split[1];
  const int t0 = d0 - i0;                       // the run's first slot
  const int ne = i1 - i0;
  const int nt = d1 - i1 - t0;                  // slots in the run
  if (nt == 0) return;                          // the same in every thread

  // 2. the ends, and segments sbase..sbase+nseg-1 (clamped to ns-1)
  const int sbase = min(i0, ns - 1);
  const int nseg = min(i1, ns - 1) - sbase + 1;
  stage(smem, ends + i0, ne * 4);
  stage(smem + lay.delta, delta + sbase, nseg * 4);
  stage(smem + lay.aval, a_vals + sbase, nseg * (int)sizeof(T));
  const C* s_acoord = reinterpret_cast<const C*>(
      stage(smem + lay.acoord, a_coords + (long long)sbase * ca,
            nseg * ca * (int)sizeof(C)));
  asm volatile("cp.async.wait_all;\n" ::);
  __syncthreads();

  // 3. the same split in shared memory for this thread's vt items, then
  //    the walk: an end moves to the next segment, a slot takes this one
  //    (s_seg holds the slot's segment less sbase, at most nv)
  {
    const int diag = min((int)threadIdx.x * vt, ne + nt);
    int lo = max(0, diag - nt), hi = min(diag, ne);
    while (lo < hi) {
      const int mid = (lo + hi) >> 1;
      if (s_ends[mid] >= t0 + diag - mid) hi = mid;
      else lo = mid + 1;
    }
    int i = lo, j = diag - lo;
    int seg = min(i0 + i, ns - 1) - sbase;
    const int stop = min(diag + vt, ne + nt);
    for (int k = diag; k < stop; ++k) {
      if (i < ne && (j >= nt || s_ends[i] <= t0 + j)) {
        ++i;
        seg = min(i0 + i, ns - 1) - sbase;
      } else {
        s_seg[j++] = seg;
      }
    }
  }
  __syncthreads();

  // 4. a thread a slot (at most VT each); coords go to the tile, placed
  //    so that its element 0 lies on a 16-byte boundary of idx_out. The
  //    partner loads of all of a thread's slots are issued before any of
  //    them is used, one round trip in place of VT.
  const long long e0 = (long long)t0 * w;
  const int lead = (int)(((uintptr_t)(idx_out + e0) & 15) / sizeof(C));
  const auto mrg = device_merge<T>(merge);
  T bval[VT];
  C bco[VT][2];                   // the first two partner coords
#pragma unroll
  for (int k = 0; k < VT; ++k) {
    const int j = threadIdx.x + k * kThreads;
    if (k < vt && j < nt) {
      const int sb = partner(t0 + j, s_delta[s_seg[j]], nb);
      bval[k] = __ldg(b_vals + sb);
#pragma unroll
      for (int c = 0; c < 2; ++c)
        if (c < cb) bco[k][c] = __ldg(b_coords + (long long)sb * cb + c);
    }
  }
#pragma unroll
  for (int k = 0; k < VT; ++k) {
    const int j = threadIdx.x + k * kThreads;
    if (k < vt && j < nt) {
      const int ls = s_seg[j];
      val_out[t0 + j] = mrg(s_aval[ls], bval[k]);
      C* o = s_idx + lead + j * w;
      for (int c = 0; c < ca; ++c) o[c] = s_acoord[ls * ca + c];
#pragma unroll
      for (int c = 0; c < 2; ++c)
        if (c < cb) o[ca + c] = bco[k][c];
      if (cb > 2) {                       // wider partner rows
        const long long sb = partner(t0 + j, s_delta[ls], nb);
        for (int c = 2; c < cb; ++c) o[ca + c] = __ldg(b_coords + sb * cb + c);
      }
    }
  }
  __syncthreads();

  // 5. the tile out: 16-byte stores, scalar ones where a chunk is cut
  constexpr int V = 16 / sizeof(C);
  C* base = idx_out + e0 - lead;
  const int end = lead + nt * w;
  for (int q = threadIdx.x * V; q < end; q += kThreads * V) {
    if (q >= lead && q + V <= end) {
      *reinterpret_cast<int4*>(base + q) =
          *reinterpret_cast<const int4*>(s_idx + q);
    } else {
      for (int p = max(q, lead); p < min(q + V, end); ++p) base[p] = s_idx[p];
    }
  }
}

// vt items a thread as asked, fewer only where wide coordinates would
// not fit, and the shared memory that takes.
struct Plan {
  int vt;
  Layout lay;
};

template <typename T, typename C>
static Plan plan(int ca, int cb, int vt) {
  Layout lay(kThreads * vt, ca, cb, sizeof(T), sizeof(C));
  while (lay.bytes > kMaxSmem && vt > 1) {
    vt >>= 1;
    lay = Layout(kThreads * vt, ca, cb, sizeof(T), sizeof(C));
  }
  return {vt, lay};
}

// Lets a kernel take all of an SM's shared memory on the current device
// (once a device and instance).
template <typename T, typename C, int CA, int CB, int VT, typename P, int MINB>
static cudaError_t allow_shared() {
  constexpr int MAX_DEVICES = 64;
  static std::mutex mu;
  static bool done[MAX_DEVICES];
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < 0 || dev >= MAX_DEVICES) return cudaErrorInvalidDevice;
  std::lock_guard<std::mutex> lock(mu);
  if (!done[dev]) {
    err = cudaFuncSetAttribute(coo_expand_kernel<T, C, CA, CB, VT, P, MINB>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               kMaxSmem);
    if (err != cudaSuccess) return err;
    done[dev] = true;
  }
  return cudaSuccess;
}

// Launches the instance <CA, CB, VT, MINB> for merge parameter P:
// cap slots, vt items a thread (fewer where wide coordinates would not
// fit shared memory).
template <typename T, typename C, int CA, int CB, int VT, typename P,
          int MINB = kMinBlocks>
static int coo_expand_run(const void* ends, const void* delta,
                          const void* a_vals, const void* a_coords,
                          const void* b_vals, const void* b_coords, int ns,
                          int nb, int ca, int cb, long long cap, int vt,
                          const P& merge, void* idx_out, void* val_out,
                          cudaStream_t stream) {
  const Plan p = plan<T, C>(ca, cb, vt);
  if (p.lay.bytes > kMaxSmem) return (int)cudaErrorInvalidValue;
  cudaError_t e = allow_shared<T, C, CA, CB, VT, P, MINB>();
  if (e != cudaSuccess) return (int)e;
  const long long nv = (long long)kThreads * p.vt;
  const unsigned blocks = (unsigned)((cap + ns + nv - 1) / nv);
  coo_expand_kernel<T, C, CA, CB, VT, P, MINB>
      <<<blocks, kThreads, p.lay.bytes, stream>>>(
          (const int32_t*)ends, (const int32_t*)delta, (const T*)a_vals,
          (const C*)a_coords, (const T*)b_vals, (const C*)b_coords, ns, nb,
          ca, cb, (int)cap, p.vt, merge, (C*)idx_out, (T*)val_out);
  return (int)cudaGetLastError();
}

// The arguments every instance takes: 0 for nothing to do, a CUDA error
// for arguments out of range, -1 to launch.
static inline int coo_expand_check(int ns, int nb, int ca, int cb,
                                   long long cap, int vt) {
  if (cap <= 0) return 0;
  if (ns <= 0 || nb <= 0 || ca < 0 || cb < 0 || ca + cb <= 0 ||
      cap + ns > 0x7fffffffLL || vt < 1 || vt > kVt)
    return (int)cudaErrorInvalidValue;
  return -1;
}

// Calls f(T(), C()) for value_code 0 float, 1 double and coord_code
// 0 int16, 1 int32.
template <typename F>
static int by_type(int value_code, int coord_code, F&& f) {
  if (value_code == 0 && coord_code == 0) return f(float(), int16_t());
  if (value_code == 0 && coord_code == 1) return f(float(), int32_t());
  if (value_code == 1 && coord_code == 0) return f(double(), int16_t());
  if (value_code == 1 && coord_code == 1) return f(double(), int32_t());
  return (int)cudaErrorInvalidValue;
}
