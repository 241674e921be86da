// CRT: (N, K) BigInt limbs -> (np, N) residues,
//      out[j, n] = Σ_k x[n, k]·(β^k mod p_j) mod p_j.
//
// Replaces: src/repro/kernels/crt/crt.py, crt_pallas with strategy "acc3"
//           (body _crt_kernel_acc3) and with strategy "mod2"/"mod4" (body
//           _crt_kernel_modx, every = 2 or 4).
// Bound on the H100: integer multiplies. The work is N·np·K 32×32→64
//           multiply-adds (3·10^8 for HE Mul's region 2 at the paper's
//           parameters, K = 38, np = 122) on 42 MB of traffic.
// Design:   a block owns 128 coefficients and a slice of the primes, one
//           thread per coefficient. The (128, K) input tile is row-major in
//           device memory, so threads that walk n would read it with stride
//           K; the block loads it once, coalesced, into shared memory with
//           an odd row pitch (K | 1, no bank conflicts) — the paper's
//           "transposing matrices". Each product (< 2^62) is added into a
//           3-word accumulator (u64 low, u32 high): K ≤ 76 products stay
//           below 2^69, and one Shoup fold by {1, β, β²} mod p at the end
//           replaces the per-term modulo (paper Table VIII, GPU-C). The
//           table rows are read warp-uniform from L1.
// Mod-x:    the delayed-modulo ladder of Table VIII (GPU-Mod2/Mod4), a
//           template instance of the same kernel with the same staging.
//           Its accumulator has two words (a u64): at most `Every` ≤ 4
//           products of < 2^62 stay below 2^64. Every `Every` terms, and
//           after the last, it is folded into the running residue by
//           Shoup products by {1, β} mod p (three residues < p, then two
//           conditional subtractions), as _crt_kernel_modx does. More
//           folds, fewer carries: the ladder exists to be measured
//           against acc3.
#include "common.cuh"

namespace {

constexpr int kCoeffs = 128;   // coefficients (threads) per block

// Every = 0: acc3 (3-word accumulator, one fold); 2 or 4: Mod-x.
template <int Every>
__global__ void crt_kernel(const uint32_t* __restrict__ x,
                           const uint32_t* __restrict__ tb,
                           const uint32_t* __restrict__ tb_sh,
                           const uint32_t* __restrict__ primes,
                           uint32_t* __restrict__ out, int n, int K, int np,
                           int tb_cols, int primes_per_block) {
  uint32_t* xs = dyn_smem;
  const int nb = blockDim.x;
  const int pitch = K | 1;
  const int n0 = blockIdx.x * nb;
  const uint32_t* src = x + static_cast<size_t>(n0) * K;
  for (int e = threadIdx.x; e < nb * K; e += nb) {
    const int r = e / K;
    xs[r * pitch + (e - r * K)] = src[e];
  }
  __syncthreads();
  const uint32_t* xr = xs + threadIdx.x * pitch;
  const int j0 = blockIdx.y * primes_per_block;
  const int j1 = min(np, j0 + primes_per_block);
  for (int j = j0; j < j1; ++j) {
    const uint32_t* t = tb + static_cast<size_t>(j) * tb_cols;
    const uint32_t* tsh = tb_sh + static_cast<size_t>(j) * tb_cols;
    const uint32_t p = primes[j];
    uint32_t r;
    if constexpr (Every == 0) {
      uint64_t lo = 0;
      uint32_t hi = 0;
      for (int k = 0; k < K; ++k) {
        const uint64_t prod = static_cast<uint64_t>(xr[k]) * t[k];
        lo += prod;
        hi += lo < prod;
      }
      r = shoup_mul(static_cast<uint32_t>(lo), t[0], tsh[0], p) +
          shoup_mul(static_cast<uint32_t>(lo >> 32), t[1], tsh[1], p) +
          shoup_mul(hi, t[2], tsh[2], p);  // < 3p
      if (r >= 2 * p) r -= 2 * p;
      if (r >= p) r -= p;
    } else {
      r = 0;
      for (int k0 = 0; k0 < K; k0 += Every) {
        uint64_t acc = 0;                  // ≤ Every products < 2^62
#pragma unroll
        for (int e = 0; e < Every; ++e)
          if (k0 + e < K) acc += static_cast<uint64_t>(xr[k0 + e]) * t[k0 + e];
        r += shoup_mul(static_cast<uint32_t>(acc), t[0], tsh[0], p) +
             shoup_mul(static_cast<uint32_t>(acc >> 32), t[1], tsh[1], p);
        if (r >= 2 * p) r -= 2 * p;      // r < 3p before
        if (r >= p) r -= p;
      }
    }
    out[static_cast<size_t>(j) * n + n0 + threadIdx.x] = r;
  }
}

template <int Every>
int crt_run(const uint32_t* x, const uint32_t* tb, const uint32_t* tb_sh,
            const uint32_t* primes, uint32_t* out, int n, int K, int np,
            int tb_cols, cudaStream_t stream) {
  const int nb = n < kCoeffs ? n : kCoeffs;
  const int blocks = n / nb;
  // split the primes over gridDim.y until there are ≥ 4 blocks per SM
  int split = (4 * 132 + blocks - 1) / blocks;
  split = split < 1 ? 1 : (split > np ? np : split);
  const int per_block = (np + split - 1) / split;
  const dim3 grid(blocks, (np + per_block - 1) / per_block);
  const size_t smem = sizeof(uint32_t) * nb * (K | 1);
  cudaError_t err = allow_smem(crt_kernel<Every>, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  crt_kernel<Every><<<grid, nb, smem, stream>>>(x, tb, tb_sh, primes, out, n,
                                                K, np, tb_cols, per_block);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// x: (n, K); tb, tb_sh: (np, tb_cols) with tb_cols ≥ max(K, 3); primes:
// (np,); out: (np, n). n is a multiple of 128, or at most 128 (one block).
// every: 0 for acc3, 2 or 4 for Mod-2 / Mod-4.
extern "C" int crt_launch(const uint32_t* x, const uint32_t* tb,
                          const uint32_t* tb_sh, const uint32_t* primes,
                          uint32_t* out, int n, int K, int np, int tb_cols,
                          int every, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (every) {
    case 0: return crt_run<0>(x, tb, tb_sh, primes, out, n, K, np, tb_cols,
                              st);
    case 2: return crt_run<2>(x, tb, tb_sh, primes, out, n, K, np, tb_cols,
                              st);
    case 4: return crt_run<4>(x, tb, tb_sh, primes, out, n, K, np, tb_cols,
                              st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
