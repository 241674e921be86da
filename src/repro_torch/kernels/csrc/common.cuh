// Word arithmetic shared by the HE Mul kernels (β = 2^32, primes < 2^30).
//
// Hopper has a native 32×32→64 multiply (IMAD.WIDE, __umulhi), so the
// 16-bit-split mulhi that the JAX package synthesises for the TPU is not
// needed: every product here is one hardware multiply. All results are
// canonical residues in [0, p), equal bit for bit to the plain versions.
#pragma once

#include <cstdint>
#include <cuda_runtime.h>

// mod(x·y, p) with y_sh = floor(y·2^32 / p) (Shoup, paper Algo 2); p < 2^30.
__device__ __forceinline__ uint32_t shoup_mul(uint32_t x, uint32_t y,
                                              uint32_t y_sh, uint32_t p) {
  const uint32_t q = __umulhi(x, y_sh);
  const uint32_t r = x * y - q * p;  // wraps mod 2^32; true value < 2p
  return r >= p ? r - p : r;
}

__device__ __forceinline__ uint32_t mod_add(uint32_t a, uint32_t b,
                                            uint32_t p) {
  const uint32_t s = a + b;
  return s >= p ? s - p : s;
}

__device__ __forceinline__ uint32_t mod_sub(uint32_t a, uint32_t b,
                                            uint32_t p) {
  const uint32_t d = a + p - b;
  return d >= p ? d - p : d;
}

// Dynamic shared memory of every kernel in this library.
extern __shared__ __align__(16) uint32_t dyn_smem[];

// Lets `kernel` use `bytes` of dynamic shared memory (needed above 48 KB).
template <typename K>
inline cudaError_t allow_smem(K kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}
