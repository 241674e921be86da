// iCRT: (np, N) residues -> (N, out_limbs) centered two's-complement limbs.
//
// Replaces: src/repro/kernels/icrt/icrt.py, icrt_accum_pallas (body
//           _icrt_kernel), together with its JAX tail
//           src/repro/core/crt.py finalize_accum (−s·P, the ±1 ladder and
//           the center-lift), folded in here.
// Bound on the H100: integer multiplies. The loop-reordered Algo 6 sum is
//           N·np·PL 32×32→64 multiply-adds (9·10^8 at np = 122), on
//           52 MB of traffic.
// Design:   one thread per coefficient n, 64 per block.
//           1. Hadamard temp_j = r_j·(P/p_j)⁻¹ mod p_j (Shoup) into shared
//              memory, and the quotient s = ⌊Σ_j temp_j/p_j⌋ in f64 as the
//              JAX package's f64 path does; its error is at most ±1.
//           2. The limbs of accum = Σ_j temp_j·(P/p_j) are formed column by
//              column with a running carry: column k is Σ_j temp_j·pdivp[j,k]
//              (< 2^69, a u64 plus a u32), so each thread holds O(1)
//              registers, not PL three-word accumulators. In the same loop
//              v = accum − s·P streams into a (A, N) scratch (coalesced),
//              with the borrow of v − P, which decides the ±1 correction.
//           3. A second sweep forms x = v ± P and the borrow of x − ⌊P/2⌋,
//              which decides the center-lift.
//           4. A third sweep writes y = v + m·P (m ∈ {−2..1}) through a
//              shared-memory tile, 32 limbs at a time, so that the row-major
//              (N, out_limbs) output is stored coalesced.
//           pdivp (≤ 55 KB at np = 122) is read warp-uniform from L1. The
//           output is the exact center-lifted CRT value, so it equals the
//           plain version bit for bit whatever s was.
#include "common.cuh"

namespace {

constexpr int kCoeffs = 64;    // coefficients (threads) per block
constexpr int kChunk = 32;     // output limbs staged per tile

__global__ void icrt_kernel(const uint32_t* __restrict__ r,
                            const uint32_t* __restrict__ inv_p,
                            const uint32_t* __restrict__ inv_p_sh,
                            const uint32_t* __restrict__ primes,
                            const double* __restrict__ p_inv,
                            const uint32_t* __restrict__ pdivp,
                            const uint32_t* __restrict__ P,
                            const uint32_t* __restrict__ P_half,
                            uint32_t* __restrict__ scratch,
                            uint32_t* __restrict__ out, int n, int np,
                            int PL, int A, int out_limbs) {
  const int nb = blockDim.x;
  const int t = threadIdx.x;
  const int n0 = blockIdx.x * nb;
  const int c = n0 + t;
  uint32_t* temp = dyn_smem;                  // (np, nb)
  uint32_t* tile = dyn_smem + np * nb;        // (nb, kChunk + 1)

  // 1. Hadamard and the f64 quotient
  double sf = 0.0;
  for (int j = 0; j < np; ++j) {
    const uint32_t v = shoup_mul(r[static_cast<size_t>(j) * n + c], inv_p[j],
                                 inv_p_sh[j], primes[j]);
    temp[j * nb + t] = v;
    sf += static_cast<double>(v) * p_inv[j];
  }
  const int64_t s = static_cast<int64_t>(floor(sf));

  // 2. accum column by column; v = accum − s·P; borrow of v − P
  uint64_t acc_carry = 0;
  int64_t v_carry = 0, ge_borrow = 0;
  for (int k = 0; k < A; ++k) {
    uint64_t lo = acc_carry;
    uint32_t hi = 0;
    if (k < PL) {
      for (int j = 0; j < np; ++j) {
        const uint64_t prod =
            static_cast<uint64_t>(temp[j * nb + t]) * pdivp[j * PL + k];
        lo += prod;
        hi += lo < prod;
      }
    }
    acc_carry = (lo >> 32) | (static_cast<uint64_t>(hi) << 32);
    const int64_t vk = static_cast<int64_t>(lo & 0xFFFFFFFFu) -
                       s * static_cast<int64_t>(P[k]) + v_carry;
    v_carry = vk >> 32;
    const uint32_t vw = static_cast<uint32_t>(vk);
    ge_borrow = (static_cast<int64_t>(vw) - P[k] + ge_borrow) >> 32;
    scratch[static_cast<size_t>(k) * n + c] = vw;
  }
  // v = x + d·P with d ∈ {−1, 0, 1}: negative ⇒ add P; v ≥ P ⇒ subtract P
  const bool negative = (scratch[static_cast<size_t>(A - 1) * n + c] >> 31);
  const int64_t dp = negative ? 1 : (ge_borrow == 0 ? -1 : 0);

  // 3. x = v + dp·P; center-lift iff x ≥ ⌊P/2⌋
  int64_t x_carry = 0, half_borrow = 0;
  for (int k = 0; k < A; ++k) {
    const int64_t xk = static_cast<int64_t>(scratch[static_cast<size_t>(k) *
                                                    n + c]) +
                       dp * P[k] + x_carry;
    x_carry = xk >> 32;
    half_borrow = (static_cast<int64_t>(static_cast<uint32_t>(xk)) -
                   P_half[k] + half_borrow) >> 32;
  }
  const int64_t m = dp - (half_borrow == 0 ? 1 : 0);

  // 4. y = v + m·P, staged through shared memory for coalesced stores
  int64_t y_carry = 0;
  uint32_t fill = 0;
  for (int k0 = 0; k0 < out_limbs; k0 += kChunk) {
    const int w = min(kChunk, out_limbs - k0);
    for (int kk = 0; kk < w; ++kk) {
      const int k = k0 + kk;
      uint32_t y = fill;
      if (k < A) {
        const int64_t yk =
            static_cast<int64_t>(scratch[static_cast<size_t>(k) * n + c]) +
            m * P[k] + y_carry;
        y_carry = yk >> 32;
        y = static_cast<uint32_t>(yk);
        if (k == A - 1) fill = (y >> 31) ? 0xFFFFFFFFu : 0u;
      }
      tile[t * (kChunk + 1) + kk] = y;
    }
    __syncthreads();
    for (int e = t; e < nb * w; e += nb) {
      const int row = e / w;
      const int col = e - row * w;
      out[static_cast<size_t>(n0 + row) * out_limbs + k0 + col] =
          tile[row * (kChunk + 1) + col];
    }
    __syncthreads();
  }
}

}  // namespace

// r: (np, n); inv_p, inv_p_sh, primes: (np,); p_inv: (np,) f64;
// pdivp: (np, PL); P, P_half: (A,); scratch: (A, n); out: (n, out_limbs).
extern "C" int icrt_launch(const uint32_t* r, const uint32_t* inv_p,
                           const uint32_t* inv_p_sh, const uint32_t* primes,
                           const double* p_inv, const uint32_t* pdivp,
                           const uint32_t* P, const uint32_t* P_half,
                           uint32_t* scratch, uint32_t* out, int n, int np,
                           int PL, int A, int out_limbs, void* stream) {
  const int nb = n < kCoeffs ? n : kCoeffs;
  const size_t smem = sizeof(uint32_t) * nb * (np + kChunk + 1);
  cudaError_t err = allow_smem(icrt_kernel, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  icrt_kernel<<<n / nb, nb, smem, static_cast<cudaStream_t>(stream)>>>(
      r, inv_p, inv_p_sh, primes, p_inv, pdivp, P, P_half, scratch, out, n,
      np, PL, A, out_limbs);
  return static_cast<int>(cudaGetLastError());
}
