// The previous design of csrc/ntt.cu, kept to be timed beside it
// (kernels/ntt/variants.py, variant "radix_tile"); nothing else builds it.
//
// Negacyclic NTT / iNTT over (rows, N) residues, multi-pass.
//
// Replaces: src/repro/kernels/ntt/ntt.py, ntt_pallas (body _ntt_kernel)
//           and intt_pallas (body _intt_kernel), modified=False and
//           modified=True.
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
//           Row r of the data takes twiddle row r mod np, so a batch of
//           B·np rows (B ciphertexts, np primes each) runs in one launch
//           without copying the (np, N) twiddle tables B times.
// Modified: every kernel is a template on `Modified`. With it, each Shoup
//           product (the butterflies and the ·N⁻¹) takes its quotient from
//           the paper's 3-half-multiply approximate mulhi (§V-B,
//           shoup_mul_modified in common.cuh) and corrects r ∈ [0, 4p) with
//           two conditional subtractions. Both variants are exact, so they
//           give the same words. The paper's variant saves a multiply on
//           hardware without a widening multiply; Hopper has one, and the
//           exact quotient is a single __umulhi, so the modified variant
//           is expected to be slower here (PERF.md has the measurement).
#include "common.cuh"

namespace {

constexpr int kLogTile = 12;     // shared-memory tile: 2^12 words = 16 KB
constexpr int kTileThreads = 512;
constexpr int kRadixThreads = 256;

// Forward stages s0 .. s0+R-1 (stage s: m = 2^s, distance t = N >> (s+1)),
// 2^R words per thread in registers. in may equal out.
template <int R, bool Modified>
__global__ void ntt_fwd_radix(const uint32_t* in, uint32_t* out,
                              const uint32_t* __restrict__ psi,
                              const uint32_t* __restrict__ psi_sh,
                              const uint32_t* __restrict__ primes, int np,
                              int logn, int s0) {
  const int tid = blockIdx.x * blockDim.x + threadIdx.x;
  if (tid >= (1 << (logn - R))) return;
  const int row = blockIdx.y;
  const int trow = row % np;
  const size_t roff = static_cast<size_t>(row) << logn;
  const size_t toff = static_cast<size_t>(trow) << logn;
  const uint32_t p = primes[trow];
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
      const size_t w = toff + (1 << s) + i;
      const uint32_t u = v[q];
      const uint32_t x = shoup_mul_t<Modified>(v[q + d], psi[w], psi_sh[w], p);
      v[q] = mod_add(u, x, p);
      v[q + d] = mod_sub(u, x, p);
    }
  }
#pragma unroll
  for (int q = 0; q < (1 << R); ++q) out[roff + base + (q << lts)] = v[q];
}

// Forward stages logn-logT .. logn-1 on one tile of 2^logT words per block.
template <bool Modified>
__global__ void ntt_fwd_tile(const uint32_t* in, uint32_t* out,
                             const uint32_t* __restrict__ psi,
                             const uint32_t* __restrict__ psi_sh,
                             const uint32_t* __restrict__ primes, int np,
                             int logn, int logT) {
  uint32_t* sm = dyn_smem;
  const int T = 1 << logT;
  const int row = blockIdx.y;
  const int trow = row % np;
  const size_t roff = static_cast<size_t>(row) << logn;
  const size_t toff = static_cast<size_t>(trow) << logn;
  const int base = blockIdx.x << logT;
  const uint32_t p = primes[trow];
  for (int k = threadIdx.x; k < T; k += blockDim.x)
    sm[k] = in[roff + base + k];
  __syncthreads();
  for (int s = logn - logT; s < logn; ++s) {
    const int log_t = logn - s - 1;
    const int t = 1 << log_t;
    for (int b = threadIdx.x; b < T / 2; b += blockDim.x) {
      const int lo = ((b >> log_t) << (log_t + 1)) | (b & (t - 1));
      const size_t w = toff + (1 << s) + ((base + lo) >> (log_t + 1));
      const uint32_t u = sm[lo];
      const uint32_t x = shoup_mul_t<Modified>(sm[lo + t], psi[w], psi_sh[w],
                                               p);
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
template <bool Modified>
__global__ void intt_tile(const uint32_t* in, uint32_t* out,
                          const uint32_t* __restrict__ ipsi,
                          const uint32_t* __restrict__ ipsi_sh,
                          const uint32_t* __restrict__ n_inv,
                          const uint32_t* __restrict__ n_inv_sh,
                          const uint32_t* __restrict__ primes, int np,
                          int logn, int logT, int scale) {
  uint32_t* sm = dyn_smem;
  const int T = 1 << logT;
  const int row = blockIdx.y;
  const int trow = row % np;
  const size_t roff = static_cast<size_t>(row) << logn;
  const size_t toff = static_cast<size_t>(trow) << logn;
  const int base = blockIdx.x << logT;
  const uint32_t p = primes[trow];
  for (int k = threadIdx.x; k < T; k += blockDim.x)
    sm[k] = in[roff + base + k];
  __syncthreads();
  for (int log_t = 0; log_t < logT; ++log_t) {
    const int t = 1 << log_t;
    const int h = 1 << (logn - log_t - 1);
    for (int b = threadIdx.x; b < T / 2; b += blockDim.x) {
      const int lo = ((b >> log_t) << (log_t + 1)) | (b & (t - 1));
      const size_t w = toff + h + ((base + lo) >> (log_t + 1));
      const uint32_t u = sm[lo], x = sm[lo + t];
      sm[lo] = mod_add(u, x, p);
      sm[lo + t] = shoup_mul_t<Modified>(mod_sub(u, x, p), ipsi[w],
                                         ipsi_sh[w], p);
    }
    __syncthreads();
  }
  const uint32_t ni = n_inv[trow], ni_sh = n_inv_sh[trow];
  for (int k = threadIdx.x; k < T; k += blockDim.x)
    out[roff + base + k] =
        scale ? shoup_mul_t<Modified>(sm[k], ni, ni_sh, p) : sm[k];
}

// Inverse stages with distance 2^lt0 .. 2^(lt0+R-1), 2^R words per thread;
// the last pass scales by N⁻¹. In place.
template <int R, bool Modified>
__global__ void intt_radix(uint32_t* x, const uint32_t* __restrict__ ipsi,
                           const uint32_t* __restrict__ ipsi_sh,
                           const uint32_t* __restrict__ n_inv,
                           const uint32_t* __restrict__ n_inv_sh,
                           const uint32_t* __restrict__ primes, int np,
                           int logn, int lt0, int scale) {
  const int tid = blockIdx.x * blockDim.x + threadIdx.x;
  if (tid >= (1 << (logn - R))) return;
  const int row = blockIdx.y;
  const int trow = row % np;
  const size_t roff = static_cast<size_t>(row) << logn;
  const size_t toff = static_cast<size_t>(trow) << logn;
  const uint32_t p = primes[trow];
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
      const size_t w = toff + h + ((base + (q << lt0)) >> (log_t + 1));
      const uint32_t u = v[q], y = v[q + d];
      v[q] = mod_add(u, y, p);
      v[q + d] = shoup_mul_t<Modified>(mod_sub(u, y, p), ipsi[w], ipsi_sh[w],
                                       p);
    }
  }
  if (scale) {
    const uint32_t ni = n_inv[trow], ni_sh = n_inv_sh[trow];
#pragma unroll
    for (int q = 0; q < (1 << R); ++q)
      v[q] = shoup_mul_t<Modified>(v[q], ni, ni_sh, p);
  }
#pragma unroll
  for (int q = 0; q < (1 << R); ++q) x[roff + base + (q << lt0)] = v[q];
}

dim3 radix_grid(int logn, int R, int rows) {
  const int threads = 1 << (logn - R);
  return dim3((threads + kRadixThreads - 1) / kRadixThreads, rows);
}

int tile_threads(int logT) {
  const int half = 1 << (logT - 1);
  return half < kTileThreads ? half : kTileThreads;
}

template <bool M>
int ntt_forward(const uint32_t* x, const uint32_t* psi, const uint32_t* psi_sh,
                const uint32_t* primes, uint32_t* out, int rows, int np,
                int logn, cudaStream_t st) {
  const int logT = logn < kLogTile ? logn : kLogTile;
  const uint32_t* src = x;
  for (int s0 = 0; s0 < logn - logT;) {
    const int R = (logn - logT - s0) >= 4 ? 4 : (logn - logT - s0);
    const dim3 grid = radix_grid(logn, R, rows);
    switch (R) {
      case 4: ntt_fwd_radix<4, M><<<grid, kRadixThreads, 0, st>>>(
                  src, out, psi, psi_sh, primes, np, logn, s0); break;
      case 3: ntt_fwd_radix<3, M><<<grid, kRadixThreads, 0, st>>>(
                  src, out, psi, psi_sh, primes, np, logn, s0); break;
      case 2: ntt_fwd_radix<2, M><<<grid, kRadixThreads, 0, st>>>(
                  src, out, psi, psi_sh, primes, np, logn, s0); break;
      default: ntt_fwd_radix<1, M><<<grid, kRadixThreads, 0, st>>>(
                  src, out, psi, psi_sh, primes, np, logn, s0); break;
    }
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
    src = out;
    s0 += R;
  }
  const dim3 grid(1 << (logn - logT), rows);
  ntt_fwd_tile<M><<<grid, tile_threads(logT), sizeof(uint32_t) << logT, st>>>(
      src, out, psi, psi_sh, primes, np, logn, logT);
  return static_cast<int>(cudaGetLastError());
}

template <bool M>
int ntt_inverse(const uint32_t* x, const uint32_t* ipsi,
                const uint32_t* ipsi_sh, const uint32_t* n_inv,
                const uint32_t* n_inv_sh, const uint32_t* primes,
                uint32_t* out, int rows, int np, int logn, cudaStream_t st) {
  const int logT = logn < kLogTile ? logn : kLogTile;
  const dim3 tgrid(1 << (logn - logT), rows);
  intt_tile<M><<<tgrid, tile_threads(logT), sizeof(uint32_t) << logT, st>>>(
      x, out, ipsi, ipsi_sh, n_inv, n_inv_sh, primes, np, logn, logT,
      logn == logT);
  cudaError_t err = cudaGetLastError();
  for (int lt0 = logT; lt0 < logn && err == cudaSuccess;) {
    const int R = (logn - lt0) >= 4 ? 4 : (logn - lt0);
    const int last = lt0 + R == logn;
    const dim3 grid = radix_grid(logn, R, rows);
    switch (R) {
      case 4: intt_radix<4, M><<<grid, kRadixThreads, 0, st>>>(
                  out, ipsi, ipsi_sh, n_inv, n_inv_sh, primes, np, logn, lt0,
                  last); break;
      case 3: intt_radix<3, M><<<grid, kRadixThreads, 0, st>>>(
                  out, ipsi, ipsi_sh, n_inv, n_inv_sh, primes, np, logn, lt0,
                  last); break;
      case 2: intt_radix<2, M><<<grid, kRadixThreads, 0, st>>>(
                  out, ipsi, ipsi_sh, n_inv, n_inv_sh, primes, np, logn, lt0,
                  last); break;
      default: intt_radix<1, M><<<grid, kRadixThreads, 0, st>>>(
                  out, ipsi, ipsi_sh, n_inv, n_inv_sh, primes, np, logn, lt0,
                  last); break;
    }
    err = cudaGetLastError();
    lt0 += R;
  }
  return static_cast<int>(err);
}

}  // namespace

// x, out: (rows, 2^logn); psi, psi_sh: (np, 2^logn); primes: (np,);
// rows a multiple of np (row r takes twiddle row r mod np); logn ≥ 1.
extern "C" int ntt_forward_launch(const uint32_t* x, const uint32_t* psi,
                                  const uint32_t* psi_sh,
                                  const uint32_t* primes, uint32_t* out,
                                  int rows, int np, int logn, int modified,
                                  void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  return modified
             ? ntt_forward<true>(x, psi, psi_sh, primes, out, rows, np, logn,
                                 st)
             : ntt_forward<false>(x, psi, psi_sh, primes, out, rows, np, logn,
                                  st);
}

// x, out: (rows, 2^logn); ipsi, ipsi_sh: (np, 2^logn); n_inv, n_inv_sh,
// primes: (np,); rows a multiple of np.
extern "C" int ntt_inverse_launch(const uint32_t* x, const uint32_t* ipsi,
                                  const uint32_t* ipsi_sh,
                                  const uint32_t* n_inv,
                                  const uint32_t* n_inv_sh,
                                  const uint32_t* primes, uint32_t* out,
                                  int rows, int np, int logn, int modified,
                                  void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  return modified
             ? ntt_inverse<true>(x, ipsi, ipsi_sh, n_inv, n_inv_sh, primes,
                                 out, rows, np, logn, st)
             : ntt_inverse<false>(x, ipsi, ipsi_sh, n_inv, n_inv_sh, primes,
                                  out, rows, np, logn, st);
}
