// iCRT: (np, N) residues -> (N, out_limbs) centered two's-complement limbs.
//
// Replaces: src/repro/kernels/icrt/icrt.py, icrt_accum_pallas (body
//           _icrt_kernel), together with its JAX tail
//           src/repro/core/crt.py finalize_accum (−s·P, the ±1 ladder and
//           the center-lift), folded in here.
// Bound on the H100: 32-bit integer multiplies, N·np·(PL + 3) of them (the
//           Shoup Hadamard step and the loop-reordered Algo 6 product
//           Σ_j temp_j·(P/p_j), np·PL 32×32→64 multiply-adds a
//           coefficient): 3.6·10^9 at np = 122, N = 4·2^16, on 208 MB of
//           traffic. A 32×32→64 product takes the multiplier twice (lo and
//           hi word), which that bound does not count.
// Design:   a block owns kBM = 64 coefficients, 128 threads. Against a
//           column-by-column kernel (one serial carry chain per thread, two
//           loads per multiply-add, 64-thread blocks, v through an (A, N)
//           HBM scratch), every one of those costs is gone.
//           1. The (np, 64) residue tile arrives by cp.async (coalesced
//              along N, every load in flight at once) and becomes
//              temp_j = r_j·(P/p_j)⁻¹ mod p_j (Shoup) in place. One thread
//              per coefficient forms s = ⌊Σ_j temp_j/p_j⌋ in f64, in the
//              JAX package's f64 order; its error is at most ±1.
//           2. The column sums Σ_j temp_j·pdivp[j, k] are a (64 × np) ·
//              (np × PL) integer product, 32 columns at a time, on the
//              CUDA cores. The chunk of pdivp is staged in shared memory;
//              each thread owns a 4 × 4 tile of independent three-word
//              accumulators (16 chains, not one) and, per 4 primes, loads
//              4 temp and 4 pdivp words of each prime (two 16-byte loads a
//              prime, one load per 8 multiply-adds) for 16 sums of 4
//              products: 4 widening multiply-adds (IMAD.WIDE, 4 products
//              < 2^64) and one 3-word add with carry. A warp whose 8
//              columns are all past PL skips the product.
//           3. The chunk's (64, 32) three-word sums go to shared memory,
//              where the pdivp chunk was; one thread per coefficient walks
//              the 32 columns in order, carrying the running carry, the
//              carry of v = accum − s·P, the borrow of v − P (the ±1
//              ladder) and the borrows of v + d·P − ⌊P/2⌋, d ∈ {−1, 0, 1}
//              (the center-lift of each rung of the ladder) in registers
//              across chunks; the chunk's limbs of P and ⌊P/2⌋ come staged
//              with the pdivp chunk. The low min(out_limbs, A) limbs of v
//              stay in a shared tile; v never goes to HBM.
//           4. y = v + m·P (m ∈ {−2..1}) in place in that tile, then the
//              row-major (N, out_limbs) output leaves it coalesced, with
//              the sign fill past A.
//           The output is the exact center-lifted CRT value, so it equals
//           the plain version bit for bit whatever s was.
// Budget:   shared memory 4·(np4·64 + max(np4·32, 3·32·64) + L·65 + 64)
//           bytes, np4 = np rounded up to 4, L = min(out_limbs, A): 76,336 B
//           at np 122 and 56,216 B at np 81. kBM = 64 is the largest block
//           for which three fit an SM at np 122 (12 warps); ptxas gives the
//           kernel 152 registers and no spills, which also allows three.
#include <algorithm>

#include "common.cuh"

namespace {

constexpr int kBM = 64;                            // coefficients a block
constexpr int kBN = 32;                            // columns a chunk
constexpr int kTM = 4;                             // coefficients a thread
constexpr int kTN = 4;                             // columns a thread
constexpr int kThreads = (kBM / kTM) * (kBN / kTN);  // 128
constexpr int kPitch = kBM + 1;                    // of the v tile

// a 4-byte cp.async into shared memory; zero-fills when !valid
__device__ __forceinline__ void cp_async4(uint32_t* dst, const uint32_t* src,
                                          bool valid) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d),
               "l"(src), "r"(valid ? 4 : 0));
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// a += x0·y0 + x1·y1 + x2·y2 + x3·y3 on a three-word accumulator: the four
// products (each < 2^62) sum below 2^64 in widening multiply-adds, then
// one add with carry into the three words.
__device__ __forceinline__ void mac4(uint32_t (&a)[3], uint32_t x0,
                                     uint32_t y0, uint32_t x1, uint32_t y1,
                                     uint32_t x2, uint32_t y2, uint32_t x3,
                                     uint32_t y3) {
  uint64_t s = static_cast<uint64_t>(x0) * y0;
  s += static_cast<uint64_t>(x1) * y1;
  s += static_cast<uint64_t>(x2) * y2;
  s += static_cast<uint64_t>(x3) * y3;
  asm("add.cc.u32 %0, %0, %3;\n\t"
      "addc.cc.u32 %1, %1, %4;\n\t"
      "addc.u32 %2, %2, 0;"
      : "+r"(a[0]), "+r"(a[1]), "+r"(a[2])
      : "r"(static_cast<uint32_t>(s)), "r"(static_cast<uint32_t>(s >> 32)));
}

__device__ __forceinline__ uint32_t lane(const uint4& v, int i) {
  return i == 0 ? v.x : i == 1 ? v.y : i == 2 ? v.z : v.w;
}

// State of one coefficient's walk over the columns (step 3).
struct Sweep {
  uint64_t carry = 0;      // of accum's limbs
  int64_t v_carry = 0;     // of v = accum − s·P
  int64_t ge = 0;          // borrow of v − P
  int64_t cz[3] = {0, 0, 0};  // borrow of v + d·P − ⌊P/2⌋, d = −1, 0, 1
  uint32_t top = 0;        // limb A − 1 of v
};

__global__ void __launch_bounds__(kThreads)
icrt_kernel(const uint32_t* __restrict__ r, const uint32_t* __restrict__ inv_p,
            const uint32_t* __restrict__ inv_p_sh,
            const uint32_t* __restrict__ primes,
            const double* __restrict__ p_inv,
            const uint32_t* __restrict__ pdivp,
            const uint32_t* __restrict__ P,
            const uint32_t* __restrict__ P_half, uint32_t* __restrict__ out,
            int n, int np, int PL, int A, int out_limbs) {
  const int t = threadIdx.x;
  const int n0 = blockIdx.x * kBM;
  const int nb = min(kBM, n - n0);            // coefficients of this block
  const int np4 = (np + 3) & ~3;
  const int L = min(out_limbs, A);            // limbs of v kept
  uint32_t* temp = dyn_smem;                  // (np4, kBM)
  uint32_t* buf = temp + np4 * kBM;           // (np4, kBN) | (3, kBN, kBM)
  uint32_t* vt = buf + max(np4 * kBN, 3 * kBN * kBM);  // (L, kPitch)
  uint32_t* pc = vt + L * kPitch;             // P, ⌊P/2⌋ of the chunk

  // 1. residues in, Hadamard in place (rows past np and columns past nb
  //    are zero), and the f64 quotient
  const int m = t % kBM;
  for (int j = t / kBM; j < np4; j += kThreads / kBM) {
    const bool ok = j < np && m < nb;
    cp_async4(&temp[j * kBM + m], ok ? &r[static_cast<size_t>(j) * n + n0 + m]
                                     : r, ok);
  }
  cp_async_wait_all();
#pragma unroll 4
  for (int j = t / kBM; j < np; j += kThreads / kBM)
    temp[j * kBM + m] =
        shoup_mul(temp[j * kBM + m], inv_p[j], inv_p_sh[j], primes[j]);
  __syncthreads();
  uint32_t s = 0;  // < np
  if (t < kBM) {
    double sf = 0.0;
#pragma unroll 8
    for (int j = 0; j < np; ++j)
      sf += static_cast<double>(temp[j * kBM + t]) * p_inv[j];
    s = static_cast<uint32_t>(floor(sf));
  }

  // thread (ty, tx) of the product owns coefficients 4ty..4ty+3 and the
  // chunk's columns 4tx..4tx+3; warp w holds columns 8w..8w+7
  const int ty = t & 15, tx = t >> 4;
  Sweep sw;
  for (int k0 = 0; k0 < A; k0 += kBN) {
    // 2. stage pdivp[:, k0 : k0 + kBN] (zero past PL and np), multiply
    for (int e = t; e < np4 * kBN; e += kThreads) {
      const int j = e / kBN, c = k0 + e % kBN;
      const bool ok = j < np && c < PL;
      cp_async4(&buf[e], ok ? &pdivp[j * PL + c] : pdivp, ok);
    }
    if (t < 2 * kBN) {
      const int k = k0 + t % kBN;
      const uint32_t* src = t < kBN ? P : P_half;
      cp_async4(&pc[t], k < A ? &src[k] : src, k < A);
    }
    cp_async_wait_all();
    __syncthreads();
    uint32_t acc[kTM][kTN][3] = {};
    if (k0 + (t >> 5) * 8 < PL) {
      for (int j = 0; j < np4; j += 4) {
        uint4 x[4], y[4];
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          x[q] = *reinterpret_cast<const uint4*>(&temp[(j + q) * kBM +
                                                       ty * kTM]);
          y[q] = *reinterpret_cast<const uint4*>(&buf[(j + q) * kBN +
                                                      tx * kTN]);
        }
#pragma unroll
        for (int i = 0; i < kTM; ++i)
#pragma unroll
          for (int c = 0; c < kTN; ++c)
            mac4(acc[i][c], lane(x[0], i), lane(y[0], c), lane(x[1], i),
                 lane(y[1], c), lane(x[2], i), lane(y[2], c), lane(x[3], i),
                 lane(y[3], c));
      }
    }
    __syncthreads();  // the chunk of pdivp is read: buf takes the sums
#pragma unroll
    for (int w = 0; w < 3; ++w)
#pragma unroll
      for (int c = 0; c < kTN; ++c)
        *reinterpret_cast<uint4*>(
            &buf[(w * kBN + tx * kTN + c) * kBM + ty * kTM]) =
            make_uint4(acc[0][c][w], acc[1][c][w], acc[2][c][w],
                       acc[3][c][w]);
    __syncthreads();

    // 3. carry sweep of the chunk, one thread per coefficient, every
    // operand from shared memory (unrolled, and the loads are not
    // conditional, so that they are issued ahead of the carry chains)
    if (t < kBM) {
#pragma unroll
      for (int kk = 0; kk < kBN; ++kk) {
        const int k = k0 + kk;
        const uint32_t w0 = buf[kk * kBM + t];
        const uint32_t w1 = buf[(kBN + kk) * kBM + t];
        const uint32_t w2 = buf[(2 * kBN + kk) * kBM + t];
        const int64_t pk = pc[kk], hk = pc[kBN + kk];
        if (k >= A) continue;
        const uint64_t lo =
            static_cast<uint64_t>(w0) + (sw.carry & 0xFFFFFFFFu);
        sw.carry = (lo >> 32) + (sw.carry >> 32) + w1 +
                   (static_cast<uint64_t>(w2) << 32);
        const int64_t vk = static_cast<int64_t>(static_cast<uint32_t>(lo)) -
                           static_cast<int64_t>(s * static_cast<uint64_t>(pk))
                           + sw.v_carry;
        sw.v_carry = vk >> 32;
        const int64_t vw = static_cast<uint32_t>(vk);
        sw.ge = (vw - pk + sw.ge) >> 32;
        sw.cz[0] = (vw - pk - hk + sw.cz[0]) >> 32;
        sw.cz[1] = (vw - hk + sw.cz[1]) >> 32;
        sw.cz[2] = (vw + pk - hk + sw.cz[2]) >> 32;
        if (k < L) vt[k * kPitch + t] = static_cast<uint32_t>(vw);
        sw.top = static_cast<uint32_t>(vw);
      }
    }
    __syncthreads();  // the sums are read: buf takes the next chunk
  }

  // 4. v = x + d·P with d ∈ {−1, 0, 1}: negative ⇒ add P; v ≥ P ⇒ subtract
  //    P. Then center-lift iff x ≥ ⌊P/2⌋. With V the A limbs of v read as
  //    unsigned, V + d·P − ⌊P/2⌋ = x − ⌊P/2⌋ + [v < 0]·2^(32A), so its
  //    final borrow is [v < 0] exactly when x ≥ ⌊P/2⌋. P's low L limbs
  //    go to buf first, behind the fill of each row.
  for (int k = t; k < L; k += kThreads) buf[kBM + k] = P[k];
  __syncthreads();
  if (t < kBM) {
    const bool negative = sw.top >> 31;
    const int d = negative ? 1 : (sw.ge == 0 ? -1 : 0);
    const int64_t cz = d == 1 ? sw.cz[2] : d == 0 ? sw.cz[1] : sw.cz[0];
    const bool high = cz == (negative ? 1 : 0);
    const int64_t mp = d - (high ? 1 : 0);
    int64_t y_carry = 0;
    for (int k = 0; k < L; ++k) {
      const int64_t yk = static_cast<int64_t>(vt[k * kPitch + t]) +
                         mp * static_cast<int64_t>(buf[kBM + k]) + y_carry;
      y_carry = yk >> 32;
      vt[k * kPitch + t] = static_cast<uint32_t>(yk);
    }
    buf[t] = high ? 0xFFFFFFFFu : 0u;  // sign of y: the fill past A
  }
  __syncthreads();
  for (int row = t >> 5; row < nb; row += kThreads / 32) {
    uint32_t* dst = out + static_cast<size_t>(n0 + row) * out_limbs;
    for (int k = t & 31; k < out_limbs; k += 32)
      dst[k] = k < L ? vt[k * kPitch + row] : buf[row];
  }
}

}  // namespace

// r: (np, n); inv_p, inv_p_sh, primes: (np,); p_inv: (np,) f64;
// pdivp: (np, PL); P, P_half: (A,); out: (n, out_limbs). blocks, threads
// and smem are kernels/icrt/ops.py's icrt_geometry; the launcher refuses
// a geometry that does not cover n or does not hold its shared tiles.
extern "C" int icrt_launch(const uint32_t* r, const uint32_t* inv_p,
                           const uint32_t* inv_p_sh, const uint32_t* primes,
                           const double* p_inv, const uint32_t* pdivp,
                           const uint32_t* P, const uint32_t* P_half,
                           uint32_t* out, int n, int np, int PL, int A,
                           int out_limbs, int blocks, int threads, int smem,
                           void* stream) {
  const int np4 = (np + 3) & ~3;
  const int words = np4 * kBM + std::max(np4 * kBN, 3 * kBN * kBM) +
                    std::min(out_limbs, A) * kPitch + 2 * kBN;
  if (threads != kThreads || static_cast<int64_t>(blocks) * kBM < n ||
      (n > kBM && n % kBM) || smem < 4 * words)
    return static_cast<int>(cudaErrorInvalidConfiguration);
  cudaError_t err = allow_smem(icrt_kernel, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  icrt_kernel<<<blocks, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      r, inv_p, inv_p_sh, primes, p_inv, pdivp, P, P_half, out, n, np, PL, A,
      out_limbs);
  return static_cast<int>(cudaGetLastError());
}
