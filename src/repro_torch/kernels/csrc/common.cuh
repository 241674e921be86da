// Word arithmetic shared by the HE Mul kernels (β = 2^32, primes < 2^30).
//
// Hopper has a native 32×32→64 multiply (IMAD.WIDE, __umulhi), so the
// 16-bit-split mulhi that the JAX package synthesises for the TPU is not
// needed: every product here is one hardware multiply. The one exception
// is shoup_mul_modified, the paper's modified Shoup (§V-B), kept so that
// its cost can be measured against the exact quotient. All results are
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

// The high word of a·b from three 16×16 products, dropping lo·lo (it only
// feeds a carry): at most 2 below the exact __umulhi(a, b). No partial sum
// wraps. The JAX package's mulhi_approx3.
__device__ __forceinline__ uint32_t mulhi_approx3(uint32_t a, uint32_t b) {
  const uint32_t al = a & 0xFFFFu, ah = a >> 16;
  const uint32_t bl = b & 0xFFFFu, bh = b >> 16;
  const uint32_t lh = al * bh;
  const uint32_t mid2 = ah * bl + (lh & 0xFFFFu);
  return ah * bh + (lh >> 16) + (mid2 >> 16);
}

// Modified Shoup (paper §V-B): the approximate quotient leaves r in
// [0, 4p), brought into [0, p) by two conditional subtractions; p < 2^30.
__device__ __forceinline__ uint32_t shoup_mul_modified(uint32_t x, uint32_t y,
                                                       uint32_t y_sh,
                                                       uint32_t p) {
  const uint32_t q = mulhi_approx3(x, y_sh);
  uint32_t r = x * y - q * p;        // wraps mod 2^32; true value < 4p
  if (r >= 2 * p) r -= 2 * p;
  return r >= p ? r - p : r;
}

// shoup_mul or shoup_mul_modified, chosen at compile time.
template <bool Modified>
__device__ __forceinline__ uint32_t shoup_mul_t(uint32_t x, uint32_t y,
                                                uint32_t y_sh, uint32_t p) {
  return Modified ? shoup_mul_modified(x, y, y_sh, p)
                  : shoup_mul(x, y, y_sh, p);
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
