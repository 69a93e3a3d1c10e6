// bloom_probe: Bloom-filter membership probe of the V2V Bloom join.
//
// Replaces the TPU kernel bloom_probe_pallas (src/repro/kernels/
// bloom_probe.py, bodies _kernel and _hash): per value, key = the bit
// pattern of (float)value; for each of num_hashes multiply-shift hashes
// (the family of src/repro/core/bloom.py), test bit h % 32 of word h / 32
// and AND the tests. The bitset is the same uint32 layout the host builds,
// so the result is bit-exact with the plain PyTorch version.
//
// Bound on the H100: device-memory bytes — n*4 bytes of values in, n
// bytes out, plus the bitset (128 KiB at log2_bits = 20), which after its
// first touches lives in L2. Design: one thread per value with native
// uint32_t arithmetic; bitset words through the read-only cache (__ldg);
// a bounds check on n replaces the TPU kernel's NaN padding. Staging the
// bitset in shared memory is left for a later change.
#include <cstdint>

#include <cuda_runtime.h>

__constant__ uint32_t kMultipliers[5] = {0x9E3779B1u, 0x85EBCA77u,
                                         0xC2B2AE3Du, 0x27D4EB2Fu,
                                         0x165667B1u};

__global__ void bloom_probe_kernel(const uint32_t* __restrict__ words,
                                   const float* __restrict__ vals,
                                   long long n, int num_hashes,
                                   int log2_bits, bool* __restrict__ out) {
  long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  uint32_t key = __float_as_uint(vals[i]);
  bool hit = true;
  for (int k = 0; k < num_hashes; ++k) {
    uint32_t h = key * kMultipliers[k % 5];
    h ^= h >> 15;
    h *= 0x2C1B3C6Du;
    h ^= h >> 12;
    uint32_t idx = h >> (32 - log2_bits);
    uint32_t w = __ldg(words + (idx >> 5));
    hit = hit && ((w >> (idx & 31u)) & 1u);
  }
  out[i] = hit;
}

extern "C" int bloom_probe_launch(const void* words, const void* vals,
                                  long long n, int num_hashes, int log2_bits,
                                  void* out, void* stream) {
  if (n <= 0) return 0;
  if (log2_bits < 5 || log2_bits > 31) return (int)cudaErrorInvalidValue;
  const int threads = 256;
  long long blocks = (n + threads - 1) / threads;
  bloom_probe_kernel<<<(unsigned)blocks, threads, 0, (cudaStream_t)stream>>>(
      (const uint32_t*)words, (const float*)vals, n, num_hashes, log2_bits,
      (bool*)out);
  return (int)cudaGetLastError();
}
