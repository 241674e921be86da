// Pointwise Montgomery product a⊙b mod p over (np, N) residues.
//
// Replaces: src/repro/kernels/modmul/modmul.py, pointwise_mont_pallas
//           (body _modmul_kernel).
// Bound on the H100: bytes. Each word is read twice (a, b) and written
//           once, with two REDCs of native 32×32→64 multiplies in between
//           (6 multiplies per word), far below the integer rate.
// Design:   one thread per 4 consecutive words of a row, moved as uint4
//           (16-byte loads and stores, neighbouring threads on
//           neighbouring addresses); blockIdx.y is the prime, so p, p′ and
//           β² mod p are loaded once per thread with no division.
#include "common.cuh"

namespace {

// REDC: (hi·2^32 + lo)·2^-32 mod p for a value < p·2^32; pp = -p⁻¹ mod 2^32.
__device__ __forceinline__ uint32_t mont_redc(uint32_t hi, uint32_t lo,
                                              uint32_t p, uint32_t pp) {
  const uint32_t m = lo * pp;
  const uint32_t t = hi + __umulhi(m, p) + (lo != 0u);  // < 2p
  return t >= p ? t - p : t;
}

__device__ __forceinline__ uint32_t mont_mul(uint32_t a, uint32_t b,
                                             uint32_t p, uint32_t pp,
                                             uint32_t r2) {
  const uint64_t t = static_cast<uint64_t>(a) * b;
  const uint32_t u = mont_redc(static_cast<uint32_t>(t >> 32),
                               static_cast<uint32_t>(t), p, pp);
  const uint64_t v = static_cast<uint64_t>(u) * r2;
  return mont_redc(static_cast<uint32_t>(v >> 32), static_cast<uint32_t>(v),
                   p, pp);
}

__global__ void modmul_kernel(const uint4* __restrict__ a,
                              const uint4* __restrict__ b,
                              const uint32_t* __restrict__ primes,
                              const uint32_t* __restrict__ pprime,
                              const uint32_t* __restrict__ r2,
                              uint4* __restrict__ out, int n4) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n4) return;
  const int j = blockIdx.y;
  const size_t idx = static_cast<size_t>(j) * n4 + i;
  const uint32_t p = primes[j], pp = pprime[j], rr = r2[j];
  const uint4 x = a[idx], y = b[idx];
  uint4 z;
  z.x = mont_mul(x.x, y.x, p, pp, rr);
  z.y = mont_mul(x.y, y.y, p, pp, rr);
  z.z = mont_mul(x.z, y.z, p, pp, rr);
  z.w = mont_mul(x.w, y.w, p, pp, rr);
  out[idx] = z;
}

}  // namespace

// a, b, out: (np, n) with n % 4 == 0, 16-byte aligned; primes, pprime,
// r2: (np,). Returns the launch's cudaError_t.
extern "C" int modmul_launch(const uint32_t* a, const uint32_t* b,
                             const uint32_t* primes, const uint32_t* pprime,
                             const uint32_t* r2, uint32_t* out, int np, int n,
                             void* stream) {
  const int n4 = n / 4;
  const int threads = 256;
  const dim3 grid((n4 + threads - 1) / threads, np);
  modmul_kernel<<<grid, threads, 0, static_cast<cudaStream_t>(stream)>>>(
      reinterpret_cast<const uint4*>(a), reinterpret_cast<const uint4*>(b),
      primes, pprime, r2, reinterpret_cast<uint4*>(out), n4);
  return static_cast<int>(cudaGetLastError());
}
