// Negacyclic NTT / iNTT over (np, N) residues, multi-pass.
//
// Replaces: src/repro/kernels/ntt/ntt.py, ntt_pallas (body _ntt_kernel)
//           and intt_pallas (body _intt_kernel), modified=False.
// Bound on the H100: bytes. Each call must read x, ψ and ψ_shoup and write
//           the result (16 bytes per word); the butterflies need only
//           3 multiplies each.
// Design:   the TPU kernel keeps a whole row in VMEM for all log2 N stages.
//           A row at N = 2^16 is 256 KiB, above a block's 227 KB of shared
//           memory, so the stages are split (paper §V-C, Table IX):
//             - stages whose butterflies span more than a tile of
//               T = 2^12 words run in registers, up to 4 stages (radix 16)
//               per pass over device memory, 16 words per thread;
//             - the last log2 T stages of the forward transform (the first
//               of the inverse) run in shared memory on one tile per block.
//           At N = 2^16 each transform is 2 passes over device memory.
//           Conventions are the JAX kernel's: forward is merged-ψ
//           Cooley–Tukey, natural order in, bit-reversed out, twiddle
//           ψ_rev[m + i]; the inverse is Gentleman–Sande with ψ⁻¹_rev[h + i]
//           and ends with ·N⁻¹ (Shoup), fused into its last pass.
#include "common.cuh"

namespace {

constexpr int kLogTile = 12;     // shared-memory tile: 2^12 words = 16 KB
constexpr int kTileThreads = 512;
constexpr int kRadixThreads = 256;

// Forward stages s0 .. s0+R-1 (stage s: m = 2^s, distance t = N >> (s+1)),
// 2^R words per thread in registers. in may equal out.
template <int R>
__global__ void ntt_fwd_radix(const uint32_t* in, uint32_t* out,
                              const uint32_t* __restrict__ psi,
                              const uint32_t* __restrict__ psi_sh,
                              const uint32_t* __restrict__ primes, int logn,
                              int s0) {
  const int tid = blockIdx.x * blockDim.x + threadIdx.x;
  if (tid >= (1 << (logn - R))) return;
  const int row = blockIdx.y;
  const size_t roff = static_cast<size_t>(row) << logn;
  const uint32_t p = primes[row];
  const int lts = logn - s0 - R;  // log2 of the smallest distance here
  const int base = ((tid >> lts) << (lts + R)) | (tid & ((1 << lts) - 1));
  uint32_t v[1 << R];
#pragma unroll
  for (int q = 0; q < (1 << R); ++q) v[q] = in[roff + base + (q << lts)];
#pragma unroll
  for (int l = 0; l < R; ++l) {
    const int s = s0 + l;
    const int d = 1 << (R - 1 - l);
    const int log_t = logn - s - 1;
#pragma unroll
    for (int q = 0; q < (1 << R); ++q) {
      if (q & d) continue;
      const int i = (base + (q << lts)) >> (log_t + 1);
      const size_t w = roff + (1 << s) + i;
      const uint32_t u = v[q];
      const uint32_t x = shoup_mul(v[q + d], psi[w], psi_sh[w], p);
      v[q] = mod_add(u, x, p);
      v[q + d] = mod_sub(u, x, p);
    }
  }
#pragma unroll
  for (int q = 0; q < (1 << R); ++q) out[roff + base + (q << lts)] = v[q];
}

// Forward stages logn-logT .. logn-1 on one tile of 2^logT words per block.
__global__ void ntt_fwd_tile(const uint32_t* in, uint32_t* out,
                             const uint32_t* __restrict__ psi,
                             const uint32_t* __restrict__ psi_sh,
                             const uint32_t* __restrict__ primes, int logn,
                             int logT) {
  uint32_t* sm = dyn_smem;
  const int T = 1 << logT;
  const int row = blockIdx.y;
  const size_t roff = static_cast<size_t>(row) << logn;
  const int base = blockIdx.x << logT;
  const uint32_t p = primes[row];
  for (int k = threadIdx.x; k < T; k += blockDim.x)
    sm[k] = in[roff + base + k];
  __syncthreads();
  for (int s = logn - logT; s < logn; ++s) {
    const int log_t = logn - s - 1;
    const int t = 1 << log_t;
    for (int b = threadIdx.x; b < T / 2; b += blockDim.x) {
      const int lo = ((b >> log_t) << (log_t + 1)) | (b & (t - 1));
      const size_t w = roff + (1 << s) + ((base + lo) >> (log_t + 1));
      const uint32_t u = sm[lo];
      const uint32_t x = shoup_mul(sm[lo + t], psi[w], psi_sh[w], p);
      sm[lo] = mod_add(u, x, p);
      sm[lo + t] = mod_sub(u, x, p);
    }
    __syncthreads();
  }
  for (int k = threadIdx.x; k < T; k += blockDim.x)
    out[roff + base + k] = sm[k];
}

// Inverse stages with distance t = 1 .. 2^(logT-1) on one tile per block;
// scales by N⁻¹ when no radix pass follows (N ≤ T).
__global__ void intt_tile(const uint32_t* in, uint32_t* out,
                          const uint32_t* __restrict__ ipsi,
                          const uint32_t* __restrict__ ipsi_sh,
                          const uint32_t* __restrict__ n_inv,
                          const uint32_t* __restrict__ n_inv_sh,
                          const uint32_t* __restrict__ primes, int logn,
                          int logT, int scale) {
  uint32_t* sm = dyn_smem;
  const int T = 1 << logT;
  const int row = blockIdx.y;
  const size_t roff = static_cast<size_t>(row) << logn;
  const int base = blockIdx.x << logT;
  const uint32_t p = primes[row];
  for (int k = threadIdx.x; k < T; k += blockDim.x)
    sm[k] = in[roff + base + k];
  __syncthreads();
  for (int log_t = 0; log_t < logT; ++log_t) {
    const int t = 1 << log_t;
    const int h = 1 << (logn - log_t - 1);
    for (int b = threadIdx.x; b < T / 2; b += blockDim.x) {
      const int lo = ((b >> log_t) << (log_t + 1)) | (b & (t - 1));
      const size_t w = roff + h + ((base + lo) >> (log_t + 1));
      const uint32_t u = sm[lo], x = sm[lo + t];
      sm[lo] = mod_add(u, x, p);
      sm[lo + t] = shoup_mul(mod_sub(u, x, p), ipsi[w], ipsi_sh[w], p);
    }
    __syncthreads();
  }
  const uint32_t ni = n_inv[row], ni_sh = n_inv_sh[row];
  for (int k = threadIdx.x; k < T; k += blockDim.x)
    out[roff + base + k] = scale ? shoup_mul(sm[k], ni, ni_sh, p) : sm[k];
}

// Inverse stages with distance 2^lt0 .. 2^(lt0+R-1), 2^R words per thread;
// the last pass scales by N⁻¹. In place.
template <int R>
__global__ void intt_radix(uint32_t* x, const uint32_t* __restrict__ ipsi,
                           const uint32_t* __restrict__ ipsi_sh,
                           const uint32_t* __restrict__ n_inv,
                           const uint32_t* __restrict__ n_inv_sh,
                           const uint32_t* __restrict__ primes, int logn,
                           int lt0, int scale) {
  const int tid = blockIdx.x * blockDim.x + threadIdx.x;
  if (tid >= (1 << (logn - R))) return;
  const int row = blockIdx.y;
  const size_t roff = static_cast<size_t>(row) << logn;
  const uint32_t p = primes[row];
  const int base = ((tid >> lt0) << (lt0 + R)) | (tid & ((1 << lt0) - 1));
  uint32_t v[1 << R];
#pragma unroll
  for (int q = 0; q < (1 << R); ++q) v[q] = x[roff + base + (q << lt0)];
#pragma unroll
  for (int l = 0; l < R; ++l) {
    const int d = 1 << l;
    const int log_t = lt0 + l;
    const int h = 1 << (logn - log_t - 1);
#pragma unroll
    for (int q = 0; q < (1 << R); ++q) {
      if (q & d) continue;
      const size_t w = roff + h + ((base + (q << lt0)) >> (log_t + 1));
      const uint32_t u = v[q], y = v[q + d];
      v[q] = mod_add(u, y, p);
      v[q + d] = shoup_mul(mod_sub(u, y, p), ipsi[w], ipsi_sh[w], p);
    }
  }
  if (scale) {
    const uint32_t ni = n_inv[row], ni_sh = n_inv_sh[row];
#pragma unroll
    for (int q = 0; q < (1 << R); ++q) v[q] = shoup_mul(v[q], ni, ni_sh, p);
  }
#pragma unroll
  for (int q = 0; q < (1 << R); ++q) x[roff + base + (q << lt0)] = v[q];
}

dim3 radix_grid(int logn, int R, int np) {
  const int threads = 1 << (logn - R);
  return dim3((threads + kRadixThreads - 1) / kRadixThreads, np);
}

int tile_threads(int logT) {
  const int half = 1 << (logT - 1);
  return half < kTileThreads ? half : kTileThreads;
}

}  // namespace

// x, psi, psi_sh, out: (np, 2^logn); primes: (np,); logn ≥ 1.
extern "C" int ntt_forward_launch(const uint32_t* x, const uint32_t* psi,
                                  const uint32_t* psi_sh,
                                  const uint32_t* primes, uint32_t* out,
                                  int np, int logn, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int logT = logn < kLogTile ? logn : kLogTile;
  const uint32_t* src = x;
  for (int s0 = 0; s0 < logn - logT;) {
    const int R = (logn - logT - s0) >= 4 ? 4 : (logn - logT - s0);
    const dim3 grid = radix_grid(logn, R, np);
    switch (R) {
      case 4: ntt_fwd_radix<4><<<grid, kRadixThreads, 0, st>>>(
                  src, out, psi, psi_sh, primes, logn, s0); break;
      case 3: ntt_fwd_radix<3><<<grid, kRadixThreads, 0, st>>>(
                  src, out, psi, psi_sh, primes, logn, s0); break;
      case 2: ntt_fwd_radix<2><<<grid, kRadixThreads, 0, st>>>(
                  src, out, psi, psi_sh, primes, logn, s0); break;
      default: ntt_fwd_radix<1><<<grid, kRadixThreads, 0, st>>>(
                  src, out, psi, psi_sh, primes, logn, s0); break;
    }
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
    src = out;
    s0 += R;
  }
  const dim3 grid(1 << (logn - logT), np);
  ntt_fwd_tile<<<grid, tile_threads(logT), sizeof(uint32_t) << logT, st>>>(
      src, out, psi, psi_sh, primes, logn, logT);
  return static_cast<int>(cudaGetLastError());
}

// x, ipsi, ipsi_sh, out: (np, 2^logn); n_inv, n_inv_sh, primes: (np,).
extern "C" int ntt_inverse_launch(const uint32_t* x, const uint32_t* ipsi,
                                  const uint32_t* ipsi_sh,
                                  const uint32_t* n_inv,
                                  const uint32_t* n_inv_sh,
                                  const uint32_t* primes, uint32_t* out,
                                  int np, int logn, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int logT = logn < kLogTile ? logn : kLogTile;
  const dim3 tgrid(1 << (logn - logT), np);
  intt_tile<<<tgrid, tile_threads(logT), sizeof(uint32_t) << logT, st>>>(
      x, out, ipsi, ipsi_sh, n_inv, n_inv_sh, primes, logn, logT,
      logn == logT);
  cudaError_t err = cudaGetLastError();
  for (int lt0 = logT; lt0 < logn && err == cudaSuccess;) {
    const int R = (logn - lt0) >= 4 ? 4 : (logn - lt0);
    const int last = lt0 + R == logn;
    const dim3 grid = radix_grid(logn, R, np);
    switch (R) {
      case 4: intt_radix<4><<<grid, kRadixThreads, 0, st>>>(
                  out, ipsi, ipsi_sh, n_inv, n_inv_sh, primes, logn, lt0,
                  last); break;
      case 3: intt_radix<3><<<grid, kRadixThreads, 0, st>>>(
                  out, ipsi, ipsi_sh, n_inv, n_inv_sh, primes, logn, lt0,
                  last); break;
      case 2: intt_radix<2><<<grid, kRadixThreads, 0, st>>>(
                  out, ipsi, ipsi_sh, n_inv, n_inv_sh, primes, logn, lt0,
                  last); break;
      default: intt_radix<1><<<grid, kRadixThreads, 0, st>>>(
                  out, ipsi, ipsi_sh, n_inv, n_inv_sh, primes, logn, lt0,
                  last); break;
    }
    err = cudaGetLastError();
    lt0 += R;
  }
  return static_cast<int>(err);
}
