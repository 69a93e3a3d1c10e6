// bloom_probe: Bloom-filter membership probe of the V2V Bloom join.
//
// Replaces the TPU kernel bloom_probe_pallas (src/repro/kernels/
// bloom_probe.py, bodies _kernel and _hash): per value, key = the bit
// pattern of (float)value; for each of num_hashes multiply-shift hashes
// (the family of src/repro/core/bloom.py), test bit h % 32 of word h / 32
// and AND the tests. The bitset is the same LSB-first uint32 layout the
// host builds, so the result is bit-exact with the plain PyTorch version.
//
// Bound on the H100: device-memory bytes — n*4 bytes of values in, n
// bytes out and the bitset once (128 KiB at log2_bits = 20). What keeps
// a kernel from it is the bitset: one thread a value with its words
// gathered from L2 pulls a 32-byte sector for every 4-byte word.
//
// Design. Like the TPU kernel, which keeps the bitset in VMEM and streams
// value tiles past it, the shared path (bitset <= 128 KiB) holds the
// whole bitset in each CTA's shared memory:
//   * a persistent grid: one CTA an SM, no more CTAs than the values
//     need or the card has SMs (Q5's 268 296 values fill the 132 SMs).
//     The CTA's threads are a launch parameter, the autotuner's grid
//     {256, 512, 1024} (kernels/bloom_probe.py: GRID; default 512), each
//     an instance of the shared path;
//   * the bitset comes in by TMA 1-D bulk copies onto an mbarrier, the
//     copy issued by one thread. Clusters of 2, 4 and 8 CTAs with the
//     copies multicast across them were each slower on Q5 (PERF.md §6),
//     so every CTA fills its own copy;
//   * under the copy each thread loads four values (one 16-byte load; a
//     scalar head up to the first 16-byte boundary and a scalar tail) and
//     computes all their word and bit indices in uint32_t;
//   * after the mbarrier wait every shared-memory word load is issued
//     before any test is ANDed (no short-circuit), and the four results
//     leave as one 4-byte store.
// Larger bitsets (log2_bits >= 21) take the global path: a thread a group
// of four values, the words through the read-only cache, again all loads
// before any AND. Its CTA keeps 256 threads whatever the tile: the tile
// sizes the shared path's one CTA an SM, which the global path does not
// have. Hash counts 1..4 are compiled as constants; any other
// count runs a loop over the hashes with four loads in flight a step.
#include <algorithm>
#include <cstdint>
#include <mutex>

#include <cuda_runtime.h>

namespace {

constexpr int kGlobalThreads = 256;
constexpr int kMaxSharedBitset = 128 * 1024;    // bytes; log2_bits <= 20
constexpr int kSmemBytes = kMaxSharedBitset + 16;  // the most: + mbarrier
constexpr int kPieceBytes = 16 * 1024;          // one bulk copy at most
constexpr int kMaxDevices = 64;
constexpr int kMaxK = 4;                        // constant hash counts
constexpr int kPathShared = 1, kPathGlobal = 2;

__constant__ uint32_t kMultipliers[5] = {0x9E3779B1u, 0x85EBCA77u,
                                         0xC2B2AE3Du, 0x27D4EB2Fu,
                                         0x165667B1u};

__device__ __forceinline__ uint32_t bloom_hash(uint32_t key, int k,
                                               int log2_bits) {
  uint32_t h = key * kMultipliers[k % 5];
  h ^= h >> 15;
  h *= 0x2C1B3C6Du;
  h ^= h >> 12;
  return h >> (32 - log2_bits);
}

struct SharedWords {
  const uint32_t* p;
  __device__ __forceinline__ uint32_t operator()(uint32_t i) const {
    return p[i];
  }
};

struct GlobalWords {
  const uint32_t* __restrict__ p;
  __device__ __forceinline__ uint32_t operator()(uint32_t i) const {
    return __ldg(p + i);
  }
};

// Bit indices of four keys under K hashes (nothing to precompute for the
// run-time count, K = 0).
template <int K>
struct Hashes {
  uint32_t idx[4][K > 0 ? K : 1];

  __device__ __forceinline__ void compute(const uint32_t key[4],
                                          int log2_bits) {
    if constexpr (K > 0) {
#pragma unroll
      for (int k = 0; k < K; ++k)
#pragma unroll
        for (int j = 0; j < 4; ++j) idx[j][k] = bloom_hash(key[j], k, log2_bits);
    }
  }

  // The four results as bytes 0/1, LSB first: every word load of every
  // hash is issued before the first test is ANDed.
  template <typename Words>
  __device__ __forceinline__ uint32_t probe(const Words& words,
                                            const uint32_t key[4],
                                            int num_hashes,
                                            int log2_bits) const {
    uint32_t hit[4] = {1u, 1u, 1u, 1u};
    if constexpr (K > 0) {
      uint32_t w[4][K];
#pragma unroll
      for (int k = 0; k < K; ++k)
#pragma unroll
        for (int j = 0; j < 4; ++j) w[j][k] = words(idx[j][k] >> 5);
#pragma unroll
      for (int k = 0; k < K; ++k)
#pragma unroll
        for (int j = 0; j < 4; ++j) hit[j] &= w[j][k] >> (idx[j][k] & 31u);
    } else {
      for (int k = 0; k < num_hashes; ++k) {
        uint32_t i[4], w[4];
#pragma unroll
        for (int j = 0; j < 4; ++j) i[j] = bloom_hash(key[j], k, log2_bits);
#pragma unroll
        for (int j = 0; j < 4; ++j) w[j] = words(i[j] >> 5);
#pragma unroll
        for (int j = 0; j < 4; ++j) hit[j] &= w[j] >> (i[j] & 31u);
      }
    }
    return (hit[0] & 1u) | (hit[1] & 1u) << 8 | (hit[2] & 1u) << 16 |
           (hit[3] & 1u) << 24;
  }
};

// Values [head, head + 4 * groups) go in groups of four (16-byte loads);
// the head before the first 16-byte boundary and the tail after the last
// group are scalars.
struct Layout {
  long long n, groups;
  int head, tail, out_vec;
};

__device__ __forceinline__ float4 load4(const float* __restrict__ vals,
                                        const Layout& L, long long g) {
  return __ldg(reinterpret_cast<const float4*>(vals + L.head) + g);
}

__device__ __forceinline__ void keys4(float4 v, uint32_t key[4]) {
  key[0] = __float_as_uint(v.x);
  key[1] = __float_as_uint(v.y);
  key[2] = __float_as_uint(v.z);
  key[3] = __float_as_uint(v.w);
}

__device__ __forceinline__ void store4(uint8_t* __restrict__ out,
                                       const Layout& L, long long g,
                                       uint32_t r) {
  uint8_t* p = out + L.head + 4 * g;
  if (L.out_vec) {
    *reinterpret_cast<uint32_t*>(p) = r;
  } else {
#pragma unroll
    for (int j = 0; j < 4; ++j) p[j] = (uint8_t)(r >> (8 * j));
  }
}

// The scalar head and tail: the first head + tail threads of CTA 0.
template <int K, typename Words>
__device__ __forceinline__ void probe_scalars(const Words& words,
                                              const float* __restrict__ vals,
                                              const Layout& L, int num_hashes,
                                              int log2_bits,
                                              uint8_t* __restrict__ out) {
  const int t = threadIdx.x;
  if (blockIdx.x != 0 || t >= L.head + L.tail) return;
  const long long i = t < L.head ? t : L.head + 4 * L.groups + (t - L.head);
  const uint32_t k = __float_as_uint(vals[i]);
  const uint32_t key[4] = {k, k, k, k};
  Hashes<K> h;
  h.compute(key, log2_bits);
  out[i] = (uint8_t)(h.probe(words, key, num_hashes, log2_bits) & 1u);
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

template <int K, int THREADS>
__global__ void __launch_bounds__(THREADS, 1)
    bloom_probe_shared(const uint32_t* __restrict__ words,
                       const float* __restrict__ vals, Layout L,
                       int num_hashes, int log2_bits,
                       uint8_t* __restrict__ out, int n_bytes, int use_tma) {
  extern __shared__ __align__(16) uint8_t smem[];
  uint32_t* s_words = reinterpret_cast<uint32_t*>(smem);
  const uint32_t bar = smem_addr(smem + ((n_bytes + 15) & ~15));

  const long long stride = (long long)gridDim.x * THREADS;
  long long g = (long long)blockIdx.x * THREADS + threadIdx.x;
  float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
  if (use_tma) {
    if (threadIdx.x == 0) {
      asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(bar)
                   : "memory");
      // the initialisation is visible to the copy engine before any copy
      asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
      asm volatile(
          "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
              bar),
          "r"(n_bytes)
          : "memory");
      for (int off = 0; off < n_bytes; off += kPieceBytes) {
        const int len = min(kPieceBytes, n_bytes - off);
        asm volatile(
            "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::"
            "bytes [%0], [%1], %2, [%3];\n" ::"r"(smem_addr(smem + off)),
            "l"(reinterpret_cast<const uint8_t*>(words) + off), "r"(len),
            "r"(bar)
            : "memory");
      }
    }
  } else {
    // a bitset below 16 bytes, or one not 16-byte aligned: thread copies
    for (int i = threadIdx.x; i < n_bytes / 4; i += THREADS)
      s_words[i] = words[i];
  }
  // the mbarrier is initialised before any thread waits on it (or, without
  // TMA, the threads' copies are done)
  __syncthreads();

  // under the copy: the first group's values and hashes
  if (g < L.groups) v = load4(vals, L, g);
  uint32_t key[4];
  keys4(v, key);
  Hashes<K> h;
  h.compute(key, log2_bits);

  if (use_tma) {
    uint32_t done = 0;
    while (!done) {
      asm volatile(
          "{\n.reg .pred p;\n"
          "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
          "selp.u32 %0, 1, 0, p;\n}\n"
          : "=r"(done)
          : "r"(bar), "r"(0u)
          : "memory");
    }
  }

  const SharedWords sw{s_words};
  probe_scalars<K>(sw, vals, L, num_hashes, log2_bits, out);
  while (g < L.groups) {
    store4(out, L, g, h.probe(sw, key, num_hashes, log2_bits));
    g += stride;
    if (g < L.groups) {
      keys4(load4(vals, L, g), key);
      h.compute(key, log2_bits);
    }
  }
}

template <int K>
__global__ void __launch_bounds__(kGlobalThreads)
    bloom_probe_global(const uint32_t* __restrict__ words,
                       const float* __restrict__ vals, Layout L,
                       int num_hashes, int log2_bits,
                       uint8_t* __restrict__ out) {
  const GlobalWords gw{words};
  probe_scalars<K>(gw, vals, L, num_hashes, log2_bits, out);
  const long long g = (long long)blockIdx.x * kGlobalThreads + threadIdx.x;
  if (g >= L.groups) return;
  uint32_t key[4];
  keys4(load4(vals, L, g), key);
  Hashes<K> h;
  h.compute(key, log2_bits);
  store4(out, L, g, h.probe(gw, key, num_hashes, log2_bits));
}

using SharedKernel = void (*)(const uint32_t*, const float*, Layout, int, int,
                              uint8_t*, int, int);
using GlobalKernel = void (*)(const uint32_t*, const float*, Layout, int, int,
                              uint8_t*);

// The instance for a hash count, and its slot (0 = the run-time count).
static int k_slot(int num_hashes) {
  return num_hashes >= 1 && num_hashes <= kMaxK ? num_hashes : 0;
}

// The shared-path CTA sizes, and their index in the instance tables.
constexpr int kShapes = 3;
constexpr int kShapeThreads[kShapes] = {256, 512, 1024};
static int shape_of(int threads) {
  for (int i = 0; i < kShapes; ++i)
    if (kShapeThreads[i] == threads) return i;
  return -1;
}

template <int THREADS>
static SharedKernel shared_kernel_of(int slot) {
  switch (slot) {
    case 1: return bloom_probe_shared<1, THREADS>;
    case 2: return bloom_probe_shared<2, THREADS>;
    case 3: return bloom_probe_shared<3, THREADS>;
    case 4: return bloom_probe_shared<4, THREADS>;
    default: return bloom_probe_shared<0, THREADS>;
  }
}

static SharedKernel shared_kernel(int slot, int shape) {
  switch (shape) {
    case 0: return shared_kernel_of<256>(slot);
    case 2: return shared_kernel_of<1024>(slot);
    default: return shared_kernel_of<512>(slot);
  }
}

static GlobalKernel global_kernel(int slot) {
  switch (slot) {
    case 1: return bloom_probe_global<1>;
    case 2: return bloom_probe_global<2>;
    case 3: return bloom_probe_global<3>;
    case 4: return bloom_probe_global<4>;
    default: return bloom_probe_global<0>;
  }
}

// What a device needs once: its SM count and each shared instance's
// shared-memory opt-in (per device, as coo_expand.cu's allow_shared).
struct DeviceState {
  int sms = 0;
  bool smem_ok[kMaxK + 1][kShapes] = {};
};

static std::mutex g_mu;
static DeviceState g_dev[kMaxDevices];

// The current device's SM count, after the opt-in of instance (`slot`,
// `shape`).
static cudaError_t device_sms(int slot, int shape, int* sms) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < 0 || dev >= kMaxDevices) return cudaErrorInvalidDevice;
  std::lock_guard<std::mutex> lock(g_mu);
  DeviceState& d = g_dev[dev];
  if (d.sms == 0) {
    err = cudaDeviceGetAttribute(&d.sms, cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return err;
  }
  if (!d.smem_ok[slot][shape]) {
    err = cudaFuncSetAttribute(shared_kernel(slot, shape),
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               kSmemBytes);
    if (err != cudaSuccess) return err;
    d.smem_ok[slot][shape] = true;
  }
  *sms = d.sms;
  return cudaSuccess;
}

struct Plan {
  int path, grid, threads, smem, use_tma;
  Layout L;
};

// `threads`: the shared path's CTA, one of kShapeThreads.
static cudaError_t make_plan(const void* words, const void* vals,
                             const void* out, long long n, int num_hashes,
                             int log2_bits, int threads, Plan* p) {
  if (n < 0 || log2_bits < 5 || log2_bits > 31 || shape_of(threads) < 0)
    return cudaErrorInvalidValue;
  const uintptr_t v = (uintptr_t)vals;
  if (v & 3u) return cudaErrorMisalignedAddress;
  Layout& L = p->L;
  L.n = n;
  L.head = (int)std::min<long long>(((16u - (v & 15u)) & 15u) / 4u, n);
  L.groups = (n - L.head) / 4;
  L.tail = (int)(n - L.head - 4 * L.groups);
  L.out_vec = (((uintptr_t)out + (uintptr_t)L.head) & 3u) == 0;
  const long long n_bytes = 1LL << (log2_bits - 3);
  if (n_bytes > kMaxSharedBitset) {
    p->path = kPathGlobal;
    p->threads = kGlobalThreads;
    p->grid = (int)std::max<long long>(
        1, (L.groups + kGlobalThreads - 1) / kGlobalThreads);
    p->smem = 0;
    p->use_tma = 0;
    return cudaSuccess;
  }
  p->path = kPathShared;
  p->threads = threads;
  p->smem = (int)((n_bytes + 15) / 16 * 16) + 16;  // bitset + mbarrier
  p->use_tma = n_bytes >= 16 && ((uintptr_t)words & 15u) == 0;
  int sms = 0;
  cudaError_t err = device_sms(k_slot(num_hashes), shape_of(threads), &sms);
  if (err != cudaSuccess) return err;
  const long long need = (L.groups + threads - 1) / threads;
  p->grid = (int)std::max<long long>(1, std::min<long long>(need, sms));
  return cudaSuccess;
}

}  // namespace

// Probe n float32 values against the bitset; out is bool[n]. `threads`
// is the shared path's CTA (256, 512 or 1024).
extern "C" int bloom_probe_launch(const void* words, const void* vals,
                                  long long n, int num_hashes, int log2_bits,
                                  int threads, void* out, void* stream) {
  if (n <= 0) return n < 0 ? (int)cudaErrorInvalidValue : 0;
  Plan p;
  cudaError_t err =
      make_plan(words, vals, out, n, num_hashes, log2_bits, threads, &p);
  if (err != cudaSuccess) return (int)err;
  const int slot = k_slot(num_hashes);
  const cudaStream_t s = (cudaStream_t)stream;
  if (p.path == kPathGlobal) {
    global_kernel(slot)<<<p.grid, p.threads, 0, s>>>(
        (const uint32_t*)words, (const float*)vals, p.L, num_hashes,
        log2_bits, (uint8_t*)out);
  } else {
    shared_kernel(slot, shape_of(p.threads))<<<p.grid, p.threads, p.smem,
                                              s>>>(
        (const uint32_t*)words, (const float*)vals, p.L, num_hashes,
        log2_bits, (uint8_t*)out, (int)(1LL << (log2_bits - 3)), p.use_tma);
  }
  return (int)cudaGetLastError();
}

// The launch a call would make, for reports: info = {path (1 shared,
// 2 global), grid, threads a CTA, dynamic shared bytes, bitset by TMA
// (0/1)}.
extern "C" int bloom_probe_plan(const void* words, const void* vals,
                                long long n, int num_hashes, int log2_bits,
                                int threads, int* info) {
  Plan p;
  cudaError_t err = make_plan(words, vals, vals, n, num_hashes, log2_bits,
                              threads, &p);
  if (err != cudaSuccess) return (int)err;
  info[0] = p.path;
  info[1] = p.grid;
  info[2] = p.threads;
  info[3] = p.smem;
  info[4] = p.use_tma;
  return 0;
}
