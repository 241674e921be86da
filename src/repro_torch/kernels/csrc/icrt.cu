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
//           for which three fit an SM at np 122 (12 warps). ptxas gives the
//           kernel 128 registers and no spills (sm_90a): 16,384 a
//           block of 4 warps, so the register file holds four blocks, and
//           shared memory holds four at np 81 (4 × (56,216 + 1,024
//           reserved) B ≤ 228 KiB) and three at np 122.
//
// Split at the cross-prime sum, for the primes spread over ranks
// (repro_torch.dist: each rank holds a shard of P's primes, and the
// column sums and the quotient are summed across ranks before the tail):
//   icrt_partial_launch: a shard's residues -> (lo, hi, qsum), steps 1-2
//           of the kernel as they are; the three-word column sums leave as
//           the canonical pair lo = w0, hi = w1 + w2·2^32 (int64), and
//           qsum = Σ_j temp_j·p_inv_j in f64, in order, every product and
//           sum rounded (no fused multiply-add), so that it equals
//           core/crt.py icrt_partial bit for bit. Bound: N·np·(PL + 3)
//           int32 multiplies against 4·np·N + 16·N·PL + 8·N bytes.
//   icrt_finish_launch: the summed (lo, hi, qsum) -> (N, out_limbs), steps
//           3-4 of the kernel (the same device functions), with the column
//           sums read from HBM chunk by chunk. Bound: (16·PL + 8 +
//           4·out_limbs)·N bytes.
//           Both are simple and right first: the partial kernel stores
//           its sums through shared memory row by row (coalesced), the
//           finish kernel stages 32 columns of lo and hi per chunk.
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

// Step 1 for a block: the (np, kBM) residue tile arrives by cp.async and
// becomes temp_j = r_j·(P/p_j)⁻¹ mod p_j in place (rows past np and
// columns past nb are zero).
__device__ __forceinline__ void stage_temp(
    const uint32_t* __restrict__ r, const uint32_t* __restrict__ inv_p,
    const uint32_t* __restrict__ inv_p_sh,
    const uint32_t* __restrict__ primes, uint32_t* temp, int n, int np,
    int np4, int n0, int nb) {
  const int t = threadIdx.x;
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
}

// Step 2's staging: pdivp[:, k0 : k0 + kBN] into buf (zero past PL and
// np), by cp.async; the caller waits.
__device__ __forceinline__ void stage_pdivp(const uint32_t* __restrict__ pdivp,
                                            uint32_t* buf, int np, int np4,
                                            int PL, int k0) {
  const int t = threadIdx.x;
  for (int e = t; e < np4 * kBN; e += kThreads) {
    const int j = e / kBN, c = k0 + e % kBN;
    const bool ok = j < np && c < PL;
    cp_async4(&buf[e], ok ? &pdivp[j * PL + c] : pdivp, ok);
  }
}

// Step 2's product for the chunk staged in buf: thread (ty, tx) owns
// coefficients 4ty..4ty+3 and the chunk's columns 4tx..4tx+3 (warp w holds
// columns 8w..8w+7, and skips the product when all are past PL).
__device__ __forceinline__ void chunk_product(const uint32_t* temp,
                                              const uint32_t* buf, int np4,
                                              int PL, int k0,
                                              uint32_t (&acc)[kTM][kTN][3]) {
  const int t = threadIdx.x;
  const int ty = t & 15, tx = t >> 4;
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
}

// Step 3 for column k of one coefficient: the column's sum c_lo + c_hi·2^32
// joins the running carry (limb k of accum is the low word), then
// v = accum − s·P and the borrows of the ladder and of the center-lift
// advance by one limb. Returns limb k of v.
__device__ __forceinline__ uint32_t sweep_column(Sweep& sw, uint64_t c_lo,
                                                 uint64_t c_hi, uint32_t s,
                                                 int64_t pk, int64_t hk) {
  const uint64_t lo = (c_lo & 0xFFFFFFFFu) + (sw.carry & 0xFFFFFFFFu);
  sw.carry = (lo >> 32) + (sw.carry >> 32) + (c_lo >> 32) + c_hi;
  const int64_t vk = static_cast<int64_t>(static_cast<uint32_t>(lo)) -
                     static_cast<int64_t>(s * static_cast<uint64_t>(pk)) +
                     sw.v_carry;
  sw.v_carry = vk >> 32;
  const int64_t vw = static_cast<uint32_t>(vk);
  sw.ge = (vw - pk + sw.ge) >> 32;
  sw.cz[0] = (vw - pk - hk + sw.cz[0]) >> 32;
  sw.cz[1] = (vw - hk + sw.cz[1]) >> 32;
  sw.cz[2] = (vw + pk - hk + sw.cz[2]) >> 32;
  sw.top = static_cast<uint32_t>(vw);
  return static_cast<uint32_t>(vw);
}

// Step 4 for a block, after every column's sweep:
//    v = x + d·P with d ∈ {−1, 0, 1}: negative ⇒ add P; v ≥ P ⇒ subtract
//    P. Then center-lift iff x ≥ ⌊P/2⌋. With V the A limbs of v read as
//    unsigned, V + d·P − ⌊P/2⌋ = x − ⌊P/2⌋ + [v < 0]·2^(32A), so its
//    final borrow is [v < 0] exactly when x ≥ ⌊P/2⌋. y = v + m·P
//    (m ∈ {−2..1}) in place in the v tile vt, then the row-major
//    (N, out_limbs) output leaves it coalesced, with the sign fill past A.
//    P's low L limbs go to scratch[kBM:] first, behind the fill of each
//    row in scratch[:kBM].
__device__ __forceinline__ void finish_block(const Sweep& sw, uint32_t* vt,
                                             uint32_t* scratch,
                                             const uint32_t* __restrict__ P,
                                             uint32_t* __restrict__ out,
                                             int n0, int nb, int L,
                                             int out_limbs) {
  const int t = threadIdx.x;
  for (int k = t; k < L; k += kThreads) scratch[kBM + k] = P[k];
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
                         mp * static_cast<int64_t>(scratch[kBM + k]) +
                         y_carry;
      y_carry = yk >> 32;
      vt[k * kPitch + t] = static_cast<uint32_t>(yk);
    }
    scratch[t] = high ? 0xFFFFFFFFu : 0u;  // sign of y: the fill past A
  }
  __syncthreads();
  for (int row = t >> 5; row < nb; row += kThreads / 32) {
    uint32_t* dst = out + static_cast<size_t>(n0 + row) * out_limbs;
    for (int k = t & 31; k < out_limbs; k += 32)
      dst[k] = k < L ? vt[k * kPitch + row] : scratch[row];
  }
}

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

  // 1. residues in, Hadamard in place, and the f64 quotient
  stage_temp(r, inv_p, inv_p_sh, primes, temp, n, np, np4, n0, nb);
  __syncthreads();
  uint32_t s = 0;  // < np
  if (t < kBM) {
    double sf = 0.0;
#pragma unroll 8
    for (int j = 0; j < np; ++j)
      sf += static_cast<double>(temp[j * kBM + t]) * p_inv[j];
    s = static_cast<uint32_t>(floor(sf));
  }

  const int ty = t & 15, tx = t >> 4;
  Sweep sw;
  for (int k0 = 0; k0 < A; k0 += kBN) {
    // 2. stage pdivp[:, k0 : k0 + kBN] and the chunk's P, ⌊P/2⌋; multiply
    stage_pdivp(pdivp, buf, np, np4, PL, k0);
    if (t < 2 * kBN) {
      const int k = k0 + t % kBN;
      const uint32_t* src = t < kBN ? P : P_half;
      cp_async4(&pc[t], k < A ? &src[k] : src, k < A);
    }
    cp_async_wait_all();
    __syncthreads();
    uint32_t acc[kTM][kTN][3] = {};
    chunk_product(temp, buf, np4, PL, k0, acc);
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
        const uint32_t vw = sweep_column(
            sw, w0, w1 + (static_cast<uint64_t>(w2) << 32), s, pk, hk);
        if (k < L) vt[k * kPitch + t] = vw;
      }
    }
    __syncthreads();  // the sums are read: buf takes the next chunk
  }

  // 4. the ladder, the center-lift and the output
  finish_block(sw, vt, buf, P, out, n0, nb, L, out_limbs);
}

// Pitch of a row of the partial kernel's staged sums.
constexpr int kSumPitch = kBN + 1;

__global__ void __launch_bounds__(kThreads)
icrt_partial_kernel(const uint32_t* __restrict__ r,
                    const uint32_t* __restrict__ inv_p,
                    const uint32_t* __restrict__ inv_p_sh,
                    const uint32_t* __restrict__ primes,
                    const double* __restrict__ p_inv,
                    const uint32_t* __restrict__ pdivp,
                    uint64_t* __restrict__ lo, uint64_t* __restrict__ hi,
                    double* __restrict__ qsum, int n, int np, int PL) {
  const int t = threadIdx.x;
  const int n0 = blockIdx.x * kBM;
  const int nb = min(kBM, n - n0);
  const int np4 = (np + 3) & ~3;
  uint32_t* temp = dyn_smem;                  // (np4, kBM)
  uint32_t* buf = temp + np4 * kBM;  // (np4, kBN) | (3, kBM, kSumPitch)

  // 1. residues in, Hadamard in place; the quotient sum in the JAX
  //    package's order of j, each product and sum rounded on its own
  stage_temp(r, inv_p, inv_p_sh, primes, temp, n, np, np4, n0, nb);
  __syncthreads();
  if (t < nb) {
    double sf = 0.0;
    for (int j = 0; j < np; ++j)
      sf = __dadd_rn(sf, __dmul_rn(static_cast<double>(temp[j * kBM + t]),
                                   p_inv[j]));
    qsum[n0 + t] = sf;
  }

  const int ty = t & 15, tx = t >> 4;
  for (int k0 = 0; k0 < PL; k0 += kBN) {
    // 2. the chunk's column sums, as in icrt_kernel
    stage_pdivp(pdivp, buf, np, np4, PL, k0);
    cp_async_wait_all();
    __syncthreads();
    uint32_t acc[kTM][kTN][3] = {};
    chunk_product(temp, buf, np4, PL, k0, acc);
    __syncthreads();  // the chunk of pdivp is read: buf takes the sums
    // the three words of each sum, row by row. A sum of np ≤ 122 products
    // below 2^63 (temp < 2^30, a pdivp word < 2^32) is below 2^70, so w2
    // < 2^6 (far below 2^31) and hi = w1 + w2·2^32 < 2^38 fits int64.
#pragma unroll
    for (int w = 0; w < 3; ++w)
#pragma unroll
      for (int i = 0; i < kTM; ++i)
#pragma unroll
        for (int c = 0; c < kTN; ++c)
          buf[(w * kBM + ty * kTM + i) * kSumPitch + tx * kTN + c] =
              acc[i][c][w];
    __syncthreads();
    // out by rows: a warp stores 32 neighbouring columns of one row
    for (int e = t; e < kBM * kBN; e += kThreads) {
      const int row = e / kBN, c = e % kBN, k = k0 + c;
      if (row < nb && k < PL) {
        const size_t at = static_cast<size_t>(n0 + row) * PL + k;
        lo[at] = buf[row * kSumPitch + c];
        hi[at] = buf[(kBM + row) * kSumPitch + c] +
                 (static_cast<uint64_t>(buf[(2 * kBM + row) * kSumPitch + c])
                  << 32);
      }
    }
    __syncthreads();  // the sums are stored: buf takes the next chunk
  }
}

__global__ void __launch_bounds__(kThreads)
icrt_finish_kernel(const uint64_t* __restrict__ lo,
                   const uint64_t* __restrict__ hi,
                   const double* __restrict__ qsum,
                   const uint32_t* __restrict__ P,
                   const uint32_t* __restrict__ P_half,
                   uint32_t* __restrict__ out, int n, int PL, int A,
                   int out_limbs) {
  const int t = threadIdx.x;
  const int n0 = blockIdx.x * kBM;
  const int nb = min(kBM, n - n0);
  const int L = min(out_limbs, A);
  // the chunk's column sums, one column of kBM coefficients a row
  uint64_t* cl = reinterpret_cast<uint64_t*>(dyn_smem);  // (kBN, kPitch)
  uint64_t* ch = cl + kBN * kPitch;                      // (kBN, kPitch)
  uint32_t* vt = reinterpret_cast<uint32_t*>(ch + kBN * kPitch);  // (L, kPitch)
  uint32_t* pc = vt + L * kPitch;             // P, ⌊P/2⌋ of the chunk
  uint32_t* scratch = pc + 2 * kBN;           // kBM + L words (step 4)

  // the quotient: the sum over every shard is below np, so s < np
  const uint32_t s = t < nb ? static_cast<uint32_t>(floor(qsum[n0 + t])) : 0;
  Sweep sw;
  for (int k0 = 0; k0 < A; k0 += kBN) {
    // lo and hi of 32 columns (zero past PL and past nb); a warp reads
    // 32 neighbouring columns of one row
    for (int e = t; e < kBM * kBN; e += kThreads) {
      const int row = e / kBN, c = e % kBN, k = k0 + c;
      const bool ok = row < nb && k < PL;
      const size_t at = static_cast<size_t>(n0 + row) * PL + k;
      cl[c * kPitch + row] = ok ? lo[at] : 0;
      ch[c * kPitch + row] = ok ? hi[at] : 0;
    }
    if (t < 2 * kBN) {
      const int k = k0 + t % kBN;
      const uint32_t* src = t < kBN ? P : P_half;
      pc[t] = k < A ? src[k] : 0;
    }
    __syncthreads();
    // 3. the sweep of icrt_kernel on the summed columns
    if (t < kBM)
      for (int kk = 0; kk < kBN && k0 + kk < A; ++kk) {
        const uint32_t vw = sweep_column(sw, cl[kk * kPitch + t],
                                         ch[kk * kPitch + t], s, pc[kk],
                                         pc[kBN + kk]);
        if (k0 + kk < L) vt[(k0 + kk) * kPitch + t] = vw;
      }
    __syncthreads();  // the chunk is read: cl, ch take the next
  }
  // 4. as icrt_kernel
  finish_block(sw, vt, scratch, P, out, n0, nb, L, out_limbs);
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

// A shard's np ≥ 1 primes: r: (np, n); inv_p, inv_p_sh, primes: (np,);
// p_inv: (np,) f64; pdivp: (np, PL); lo, hi: (n, PL) int64; qsum: (n,)
// f64. blocks, threads and smem are kernels/icrt/ops.py's
// icrt_partial_geometry; the launcher refuses np < 1 and a geometry that
// does not cover n or hold its tiles.
extern "C" int icrt_partial_launch(const uint32_t* r, const uint32_t* inv_p,
                                   const uint32_t* inv_p_sh,
                                   const uint32_t* primes,
                                   const double* p_inv,
                                   const uint32_t* pdivp, uint64_t* lo,
                                   uint64_t* hi, double* qsum, int n, int np,
                                   int PL, int blocks, int threads, int smem,
                                   void* stream) {
  const int np4 = (np + 3) & ~3;
  const int words = np4 * kBM + std::max(np4 * kBN, 3 * kBM * kSumPitch);
  if (np < 1 || threads != kThreads ||
      static_cast<int64_t>(blocks) * kBM < n || (n > kBM && n % kBM) ||
      smem < 4 * words)
    return static_cast<int>(cudaErrorInvalidConfiguration);
  cudaError_t err = allow_smem(icrt_partial_kernel, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  icrt_partial_kernel<<<blocks, kThreads, smem,
                        static_cast<cudaStream_t>(stream)>>>(
      r, inv_p, inv_p_sh, primes, p_inv, pdivp, lo, hi, qsum, n, np, PL);
  return static_cast<int>(cudaGetLastError());
}

// lo, hi: (n, PL) int64 and qsum: (n,) f64, summed over every shard of
// P's primes; P, P_half: (A,), A ≥ PL + 1; out: (n, out_limbs). blocks,
// threads and smem are kernels/icrt/ops.py's icrt_finish_geometry.
extern "C" int icrt_finish_launch(const uint64_t* lo, const uint64_t* hi,
                                  const double* qsum, const uint32_t* P,
                                  const uint32_t* P_half, uint32_t* out,
                                  int n, int PL, int A, int out_limbs,
                                  int blocks, int threads, int smem,
                                  void* stream) {
  const int bytes = 2 * 8 * kBN * kPitch +
                    4 * (std::min(out_limbs, A) * kPitch + 2 * kBN + kBM +
                         std::min(out_limbs, A));
  if (A < PL + 1 || threads != kThreads ||
      static_cast<int64_t>(blocks) * kBM < n || (n > kBM && n % kBM) ||
      smem < bytes)
    return static_cast<int>(cudaErrorInvalidConfiguration);
  cudaError_t err = allow_smem(icrt_finish_kernel, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  icrt_finish_kernel<<<blocks, kThreads, smem,
                       static_cast<cudaStream_t>(stream)>>>(
      lo, hi, qsum, P, P_half, out, n, PL, A, out_limbs);
  return static_cast<int>(cudaGetLastError());
}
