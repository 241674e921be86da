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
//   icrt_partial_launch: a shard's residues -> (lo, hi, qsum): steps 1-2,
//           the column sums leaving as the canonical pair lo = low word,
//           hi = the rest (int64), and qsum = Σ_j temp_j·p_inv_j in f64,
//           in order, every product and sum rounded (no fused
//           multiply-add), so that it equals core/crt.py icrt_partial bit
//           for bit. Bound: 4·np·N + 16·N·PL + 8·N bytes, 87-93 % of them
//           the stores.
//   Design:  a persistent block loops over tiles of kRows = 32
//           coefficients. Its stores are the bound, so the tile's sums go
//           out as two bulk asynchronous stores (cp.async.bulk, the TMA's
//           1-D copy): rows n0..n0+31 of lo, and of hi, are one contiguous
//           span of HBM each (16-byte aligned, n0 even), staged row-major
//           in shared memory and sent by one thread while the block goes
//           on to the next tile. The product must then hide under the
//           stores: N·np·PL 32×32→64 multiply-adds on the CUDA cores
//           (IMAD.WIDE) took as long as the stores themselves (PERF.md
//           §6), so it runs on the FP64 tensor cores instead:
//           with pdivp split into 16-bit halves, Σ_j temp_j·half is an
//           integer below 2^53, exact in f64 (tile_product). The whole
//           (np4, W) pdivp (W = PL rounded up to 4) is staged once; a
//           tile's residues become temp (Shoup) as f64, and the next
//           tile's arrive by cp.async while this one is multiplied; the
//           last warp, which has the fewest n8 tiles, sums qsum. Warp w
//           keeps 4 n8 × 2 m16 tiles of accumulators in registers over
//           every prime (no column chunks); lo, hi = S_lo + S_hi·2^16
//           split at bit 32.
//   Budget:  16·kRows·PL + 8·37·np4 + 4·np4·(W + 35) bytes: 70,960 B at
//           np 41 / PL 75 (3 blocks an SM), 115,456 B at np 61 / PL 113
//           (2), 169,456 B at np 122 (1). A warp per 16 of W: 160 threads
//           at PL 75, 256 at PL 113; the launch bounds cap the registers
//           at 128.
//   icrt_finish_launch: the summed (lo, hi, qsum) -> (N, out_limbs), steps
//           3-4 of the fused kernel (the same device functions). Bound:
//           (16·PL + 8 + 4·out_limbs)·N bytes; the carry sweep is a few
//           dozen integer operations a column.
//   Design:  a block of one warp takes kFinRows = 16 coefficients, one
//           a lane. Its rows of lo, and of hi, are one contiguous span
//           each, so one thread asks the TMA for each with one bulk load
//           (cp.async.bulk into shared memory, counted by an mbarrier): no
//           other thread spends an instruction on the loads, and HBM sees
//           long sequential reads. Each lane then sweeps its row (an odd
//           PL: the half-warp's 8-byte reads of one column hit 16
//           distinct bank pairs); step 4 is the fused kernel's
//           finish_block, within the warp. The sweep is a chain of
//           dependent operations per row, so what it needs is many warps
//           in flight, and shared memory bounds the rows resident on an
//           SM: 16-row blocks put twice the warps of 32-row blocks on the
//           same rows (9 an SM at PL 75, 6 at PL 113), and while some
//           sweep, the others' loads are in flight.
//   Budget:  16·kFinRows·PL + 8 + 4·(2A + 17L + 16 + L) bytes, L =
//           min(out_limbs, A): 22,632 B at PL 75 / out 38 and 35,408 B at
//           PL 113 / out 76.
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

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// waits until at most N of this thread's cp.async groups are pending
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// One bulk asynchronous store (the TMA's 1-D copy) of `bytes` (a multiple
// of 16; both addresses 16-byte aligned) from shared to global memory.
__device__ __forceinline__ void bulk_store(void* dst, const void* src,
                                           uint32_t bytes) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(src));
  asm volatile(
      "cp.async.bulk.global.shared::cta.bulk_group [%0], [%1], %2;\n" ::"l"(
          dst),
      "r"(s), "r"(bytes)
      : "memory");
}

__device__ __forceinline__ void bulk_commit() {
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}

// until this thread's bulk stores have read their shared memory
__device__ __forceinline__ void bulk_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
}

// until this thread's bulk stores are complete
__device__ __forceinline__ void bulk_wait() {
  asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
}

// orders this thread's shared-memory writes before later bulk stores
__device__ __forceinline__ void fence_async_shared() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, unsigned count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   smem_addr(bar)),
               "r"(count)
               : "memory");
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

// One bulk asynchronous load (the TMA's 1-D copy) of `bytes` (a multiple
// of 16; both addresses 16-byte aligned) into shared memory, which
// counts its bytes against mbarrier `bar`.
__device__ __forceinline__ void bulk_load(void* dst, const void* src,
                                          uint32_t bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(smem_addr(dst)),
      "l"(src), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}

// this thread's arrival on `bar`, which then also waits for `bytes`
__device__ __forceinline__ void mbar_expect(uint64_t* bar, uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
          smem_addr(bar)),
      "r"(bytes)
      : "memory");
}

// until phase `parity` of `bar` has completed
__device__ __forceinline__ void mbar_wait(uint64_t* bar, unsigned parity) {
  asm volatile(
      "{\n\t.reg .pred p;\n"
      "WAIT:\n\t"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%0], %1;\n\t"
      "@!p bra WAIT;\n}\n" ::"r"(smem_addr(bar)),
      "r"(parity)
      : "memory");
}

// D += A·B on one 16 × 8 f64 tile of the FP64 tensor cores, g = lane / 4
// and t = lane % 4: a lane holds D[g][2t + {0, 1}] and D[g + 8][2t + {0,
// 1}]; for m16n8k4 A[g][t] and A[g + 8][t], and B[t][g]; for m16n8k16
// A[g + 8·(i % 2)][t + 4·(i / 2)] (i < 8) and B[t + 4i][g] (i < 4).
__device__ __forceinline__ void dmma(double (&d)[4], double a0, double a1,
                                     double b) {
  asm("mma.sync.aligned.m16n8k4.row.col.f64.f64.f64.f64 {%0, %1, %2, %3}, "
      "{%4, %5}, {%6}, {%0, %1, %2, %3};\n"
      : "+d"(d[0]), "+d"(d[1]), "+d"(d[2]), "+d"(d[3])
      : "d"(a0), "d"(a1), "d"(b));
}

__device__ __forceinline__ void dmma16(double (&d)[4], const double (&a)[8],
                                       const double (&b)[4]) {
  asm("mma.sync.aligned.m16n8k16.row.col.f64.f64.f64.f64 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7, %8, %9, %10, %11}, {%12, %13, %14, %15}, "
      "{%0, %1, %2, %3};\n"
      : "+d"(d[0]), "+d"(d[1]), "+d"(d[2]), "+d"(d[3])
      : "d"(a[0]), "d"(a[1]), "d"(a[2]), "d"(a[3]), "d"(a[4]), "d"(a[5]),
        "d"(a[6]), "d"(a[7]), "d"(b[0]), "d"(b[1]), "d"(b[2]), "d"(b[3]));
}

// v < 2^32 exactly as a double: 2^52 + v from its bits, less 2^52
__device__ __forceinline__ double exact_f64(uint32_t v) {
  return __hiloint2double(0x43300000, static_cast<int>(v)) -
         4503599627370496.0;
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
  const uint64_t lo = c_lo + sw.carry;  // < 2^64: c_lo < g·2^32 and the
                                        // carry < g·2^40 after g shards
  sw.carry = (lo >> 32) + c_hi;
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
//    P's low L limbs go to scratch[BM:] first, behind the fill of each
//    row in scratch[:BM]. BM coefficients and Threads threads (t the
//    thread's index among them): a block, or one warp when Warp.
template <int BM, int Threads, bool Warp>
__device__ __forceinline__ void finish_block(const Sweep& sw, uint32_t* vt,
                                             uint32_t* scratch,
                                             const uint32_t* __restrict__ P,
                                             uint32_t* __restrict__ out,
                                             int n0, int nb, int L,
                                             int out_limbs, int t) {
  for (int k = t; k < L; k += Threads) scratch[BM + k] = P[k];
  Warp ? __syncwarp() : __syncthreads();
  if (t < BM) {
    const bool negative = sw.top >> 31;
    const int d = negative ? 1 : (sw.ge == 0 ? -1 : 0);
    const int64_t cz = d == 1 ? sw.cz[2] : d == 0 ? sw.cz[1] : sw.cz[0];
    const bool high = cz == (negative ? 1 : 0);
    const int64_t mp = d - (high ? 1 : 0);
    int64_t y_carry = 0;
    for (int k = 0; k < L; ++k) {
      const int64_t yk = static_cast<int64_t>(vt[k * (BM + 1) + t]) +
                         mp * static_cast<int64_t>(scratch[BM + k]) +
                         y_carry;
      y_carry = yk >> 32;
      vt[k * (BM + 1) + t] = static_cast<uint32_t>(yk);
    }
    scratch[t] = high ? 0xFFFFFFFFu : 0u;  // sign of y: the fill past A
  }
  Warp ? __syncwarp() : __syncthreads();
  for (int row = t >> 5; row < nb; row += Threads / 32) {
    uint32_t* dst = out + static_cast<size_t>(n0 + row) * out_limbs;
    for (int k = t & 31; k < out_limbs; k += 32)
      dst[k] = k < L ? vt[k * (BM + 1) + row] : scratch[row];
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
  finish_block<kBM, kThreads, false>(sw, vt, buf, P, out, n0, nb, L,
                                     out_limbs, t);
}

constexpr int kRows = 32;             // coefficients a tile of the partial
constexpr int kTempPitch = kRows + 4; // of its f64 temp rows
constexpr int kPartialThreads = 256;  // the most threads a partial block has
constexpr int kFinRows = 16;          // coefficients a finish block (a warp)

// Residues of the tile of coefficients n0..n0+nb−1 into raw (np4, kRows)
// by cp.async, zero past np and nb; the caller commits and waits.
__device__ __forceinline__ void stage_residues(const uint32_t* __restrict__ r,
                                               uint32_t* raw, int n, int np,
                                               int np4, int n0, int nb) {
  for (int e = threadIdx.x; e < np4 * kRows; e += blockDim.x) {
    const int j = e / kRows, m = e % kRows;
    const bool ok = m < nb && j < np;
    cp_async4(&raw[e], ok ? &r[static_cast<size_t>(j) * n + n0 + m] : r,
              ok);
  }
}

// Half h of pdivp word `at` as a double; sel is 0x4410 for the low half
// and 0x4432 for the high (a byte permute).
__device__ __forceinline__ double pdivp_half(const uint32_t* pd, int at,
                                             unsigned sel) {
  return exact_f64(__byte_perm(pd[at], 0, sel));
}

// The partial's product on the FP64 tensor cores: the (kRows, 2W) sums
// S[m, 2c + h] = Σ_j temp_j[m]·half_h(pdivp[j, c]), h = 0 the low and 1
// the high 16 bits. Warp w takes the n8 tiles nt = w + q·(warps), q < 4,
// both m16 tiles, 16 primes a step (m16n8k16), the last < 16 by 4
// (m16n8k4). A product of temp_j < 2^30 and a half < 2^16 is an integer
// below 2^46, and np ≤ 122 of them sum below 2^53: exact in f64 in any
// order.
__device__ __forceinline__ void tile_product(const double* tempd,
                                             const uint32_t* pd, int np4,
                                             int W, double (&acc)[4][2][4]) {
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  const int nw = blockDim.x >> 5, G = W / 4;
  const int kq = lane & 3, r8 = lane >> 2;
  const double* ap = tempd + kq * kTempPitch + r8;
  const uint32_t* bp = pd + kq * W + (r8 >> 1);
  const unsigned sel = r8 & 1 ? 0x4432u : 0x4410u;
  int j = 0;
#pragma unroll 1
  for (; j + 16 <= np4; j += 16) {
    double a[2][8];
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
#pragma unroll
      for (int i = 0; i < 8; ++i)
        a[mt][i] = ap[(j + 4 * (i >> 1)) * kTempPitch + 16 * mt + 8 * (i & 1)];
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int nt = w + q * nw;
      if (nt < G) {
        double b[4];
#pragma unroll
        for (int i = 0; i < 4; ++i)
          b[i] = pdivp_half(bp, (j + 4 * i) * W + 4 * nt, sel);
        dmma16(acc[q][0], a[0], b);
        dmma16(acc[q][1], a[1], b);
      }
    }
  }
#pragma unroll 1
  for (; j < np4; j += 4) {
    double a[4];                              // rows g, g + 8, 16 + g, 24 + g
#pragma unroll
    for (int i = 0; i < 4; ++i) a[i] = ap[j * kTempPitch + 8 * i];
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int nt = w + q * nw;
      if (nt < G) {
        const double b = pdivp_half(bp, j * W + 4 * nt, sel);
        dmma(acc[q][0], a[0], a[1], b);
        dmma(acc[q][1], a[2], a[3], b);
      }
    }
  }
}

__global__ void __launch_bounds__(kPartialThreads, 2)
icrt_partial_kernel(const uint32_t* __restrict__ r,
                    const uint32_t* __restrict__ inv_p,
                    const uint32_t* __restrict__ inv_p_sh,
                    const uint32_t* __restrict__ primes,
                    const double* __restrict__ p_inv,
                    const uint32_t* __restrict__ pdivp,
                    uint64_t* __restrict__ lo, uint64_t* __restrict__ hi,
                    double* __restrict__ qsum, int n, int np, int PL,
                    int tiles) {
  const int t = threadIdx.x, bx = blockIdx.x, gx = gridDim.x;
  const int np4 = (np + 3) & ~3;
  const int W = (PL + 3) & ~3;                // columns of the staged pdivp
  const int span = kRows * PL;                // words of a tile of lo
  uint64_t* out = reinterpret_cast<uint64_t*>(dyn_smem);  // lo, hi tiles
  double* tempd = reinterpret_cast<double*>(out + 2 * span);
  double* pinv = tempd + np4 * kTempPitch;    // (np4,)
  uint32_t* pd = reinterpret_cast<uint32_t*>(pinv + np4);  // (np4, W)
  uint32_t* raw = pd + np4 * W;               // (np4, kRows) residues
  uint32_t* tab = raw + np4 * kRows;          // inv_p, inv_p_sh, primes

  for (int e = t; e < np4 * W; e += blockDim.x) {
    const int j = e / W, c = e % W;
    pd[e] = j < np && c < PL ? pdivp[j * PL + c] : 0u;
  }
  for (int e = np * kTempPitch + t; e < np4 * kTempPitch; e += blockDim.x)
    tempd[e] = 0.0;                           // primes past np
  for (int j = t; j < np; j += blockDim.x) {
    pinv[j] = p_inv[j];
    tab[j] = inv_p[j];
    tab[np4 + j] = inv_p_sh[j];
    tab[2 * np4 + j] = primes[j];
  }
  if (bx < tiles)
    stage_residues(r, raw, n, np, np4, bx * kRows,
                   min(kRows, n - bx * kRows));
  cp_async_commit();

  const int lane = t & 31, w = t >> 5, nw = blockDim.x >> 5;
  for (int tile = bx; tile < tiles; tile += gx) {
    const int n0 = tile * kRows, nb = min(kRows, n - n0);
    cp_async_wait<0>();
    if (t == 0) bulk_wait_read();  // the last tile's stores have left `out`
    __syncthreads();
    // 1. Hadamard, as f64; the quotient sum in the JAX package's order
    //    of j, each product and sum rounded on its own
    for (int e = t; e < np * kRows; e += blockDim.x) {
      const int j = e / kRows;
      tempd[j * kTempPitch + e % kRows] = exact_f64(
          shoup_mul(raw[e], tab[j], tab[np4 + j], tab[2 * np4 + j]));
    }
    __syncthreads();
    // the next tile's residues arrive while this one is multiplied
    const int next = tile + gx;
    if (next < tiles)
      stage_residues(r, raw, n, np, np4, next * kRows,
                     min(kRows, n - next * kRows));
    cp_async_commit();
    if (w == nw - 1 && lane < nb) {           // the warp with the fewest
      double sf = 0.0;                        // n8 tiles
      for (int j = 0; j < np; ++j)
        sf = __dadd_rn(sf, __dmul_rn(tempd[j * kTempPitch + lane], pinv[j]));
      qsum[n0 + lane] = sf;
    }
    // 2. the column sums of the tile, every prime at once; each sum
    //    Σ_j temp_j·pdivp[j, c] = S_lo + S_hi·2^16 (below 2^69) goes to the
    //    row-major lo and hi tiles as the canonical pair: lo its low word,
    //    hi = its value >> 32 < 2^37
    double acc[4][2][4] = {};
    tile_product(tempd, pd, np4, W, acc);
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int c = 4 * (w + q * nw) + (lane & 3);
      if (c < PL) {
#pragma unroll
        for (int i = 0; i < 4; ++i) {       // rows g, g + 8, 16 + g, 24 + g
          const double* d = &acc[q][i >> 1][2 * (i & 1)];
          const uint64_t s0 = __double2ull_rz(d[0]);
          const uint64_t s1 = __double2ull_rz(d[1]);
          const uint64_t x = s0 + ((s1 & 0xFFFFu) << 16);
          const int at = (8 * i + (lane >> 2)) * PL + c;
          out[at] = static_cast<uint32_t>(x);
          out[span + at] = (x >> 32) + (s1 >> 16);
        }
      }
    }
    fence_async_shared();
    __syncthreads();
    if (t == 0) {
      // rows n0..n0+nb−1: one span of lo and one of hi, sent whole but
      // for an odd last word
      const int words = nb * PL, bulk = words & ~1;
      const size_t at = static_cast<size_t>(n0) * PL;
      if (bulk) {
        bulk_store(lo + at, out, 8u * bulk);
        bulk_store(hi + at, out + span, 8u * bulk);
        bulk_commit();
      }
      if (words & 1) {
        lo[at + bulk] = out[bulk];
        hi[at + bulk] = out[span + bulk];
      }
    }
  }
  if (t == 0) bulk_wait();
}

__global__ void __launch_bounds__(32)
icrt_finish_kernel(const uint64_t* __restrict__ lo,
                   const uint64_t* __restrict__ hi,
                   const double* __restrict__ qsum,
                   const uint32_t* __restrict__ P,
                   const uint32_t* __restrict__ P_half,
                   uint32_t* __restrict__ out, int n, int PL, int A,
                   int out_limbs) {
  const int t = threadIdx.x;
  const int n0 = blockIdx.x * kFinRows, nb = min(kFinRows, n - n0);
  const int L = min(out_limbs, A);
  const int span = kFinRows * PL;             // words of the tile of lo
  uint64_t* cl = reinterpret_cast<uint64_t*>(dyn_smem);  // (kFinRows, PL)
  uint64_t* ch = cl + span;                   // (kFinRows, PL)
  uint64_t* bar = ch + span;                  // the loads' mbarrier
  uint32_t* pp = reinterpret_cast<uint32_t*>(bar + 1);  // P, ⌊P/2⌋
  uint32_t* vt = pp + 2 * A;                  // (L, kFinRows + 1)
  uint32_t* scratch = vt + L * (kFinRows + 1);  // kFinRows + L words

  // rows n0..n0+nb−1 of lo and of hi: one span each, asked of the TMA
  // whole but for an odd last word
  const int words = nb * PL, bulk = words & ~1;
  const size_t at = static_cast<size_t>(n0) * PL;
  if (t == 0) {
    mbar_init(bar, 1);
    mbar_expect(bar, 16u * bulk);
    if (bulk) {
      bulk_load(cl, lo + at, 8u * bulk, bar);
      bulk_load(ch, hi + at, 8u * bulk, bar);
    }
    if (words & 1) {
      cl[bulk] = lo[at + bulk];
      ch[bulk] = hi[at + bulk];
    }
  }
  for (int k = t; k < A; k += 32) {
    pp[k] = P[k];
    pp[A + k] = P_half[k];
  }
  // the quotient: the sum over every shard is below np, so s < np
  const uint32_t s = t < nb ? static_cast<uint32_t>(floor(qsum[n0 + t])) : 0;
  __syncwarp();
  mbar_wait(bar, 0);

  // 3. the sweep of icrt_kernel on the summed columns, lane t on row t
  //    (an odd pitch: the half-warp's reads of a column hit 16 bank pairs)
  Sweep sw;
  if (t < kFinRows) {
    const uint64_t* rl = cl + t * PL;
    const uint64_t* rh = ch + t * PL;
#pragma unroll 4
    for (int k = 0; k < A; ++k) {
      const bool in = k < PL;
      const uint32_t vw = sweep_column(sw, in ? rl[k] : 0, in ? rh[k] : 0,
                                       s, pp[k], pp[A + k]);
      if (k < L) vt[k * (kFinRows + 1) + t] = vw;
    }
  }
  // 4. as icrt_kernel, in this warp
  finish_block<kFinRows, 32, true>(sw, vt, scratch, P, out, n0, nb, L,
                                   out_limbs, t);
}

// The blocks of a persistent launch: one round of what fits the card at
// once, and no more than there are tiles.
template <typename K>
int resident_blocks(K kernel, int threads, int smem, int tiles) {
  int dev = 0, sms = 0, per_sm = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, threads,
                                                smem);
  return std::max(1, std::min(tiles, per_sm * sms));
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
// f64. blocks (the tiles of kRows coefficients), threads and smem are
// kernels/icrt/ops.py's icrt_partial_geometry; the launcher refuses np < 1
// and a geometry that does not cover n or hold its tiles, and runs
// min(blocks, what fits the card) blocks, each looping over tiles.
extern "C" int icrt_partial_launch(const uint32_t* r, const uint32_t* inv_p,
                                   const uint32_t* inv_p_sh,
                                   const uint32_t* primes,
                                   const double* p_inv,
                                   const uint32_t* pdivp, uint64_t* lo,
                                   uint64_t* hi, double* qsum, int n, int np,
                                   int PL, int blocks, int threads, int smem,
                                   void* stream) {
  const int np4 = (np + 3) & ~3, W = (PL + 3) & ~3;
  const int64_t bytes = 16LL * kRows * PL + 8LL * np4 * (kTempPitch + 1) +
                        4LL * np4 * (W + kRows + 3);
  if (np < 1 || PL < 1 || n < 1 || threads != (2 * W + 31) / 32 * 32 ||
      threads > kPartialThreads ||
      static_cast<int64_t>(blocks) * kRows < n || smem < bytes)
    return static_cast<int>(cudaErrorInvalidConfiguration);
  cudaError_t err = allow_smem(icrt_partial_kernel, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int tiles = (n + kRows - 1) / kRows;
  icrt_partial_kernel<<<resident_blocks(icrt_partial_kernel, threads, smem,
                                        tiles),
                        threads, smem, static_cast<cudaStream_t>(stream)>>>(
      r, inv_p, inv_p_sh, primes, p_inv, pdivp, lo, hi, qsum, n, np, PL,
      tiles);
  return static_cast<int>(cudaGetLastError());
}

// lo, hi: (n, PL) int64 and qsum: (n,) f64, summed over every shard of
// P's primes; P, P_half: (A,), A ≥ PL + 1; out: (n, out_limbs). blocks
// (one a tile of kFinRows coefficients), threads (a warp) and smem are
// kernels/icrt/ops.py's icrt_finish_geometry.
extern "C" int icrt_finish_launch(const uint64_t* lo, const uint64_t* hi,
                                  const double* qsum, const uint32_t* P,
                                  const uint32_t* P_half, uint32_t* out,
                                  int n, int PL, int A, int out_limbs,
                                  int blocks, int threads, int smem,
                                  void* stream) {
  const int L = std::min(out_limbs, A);
  const int64_t bytes = 16LL * kFinRows * PL + 8 +
                        4LL * (2 * A + L * (kFinRows + 1) + kFinRows + L);
  if (A < PL + 1 || n < 1 || threads != 32 ||
      static_cast<int64_t>(blocks) * kFinRows < n || smem < bytes)
    return static_cast<int>(cudaErrorInvalidConfiguration);
  cudaError_t err = allow_smem(icrt_finish_kernel, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  icrt_finish_kernel<<<(n + kFinRows - 1) / kFinRows, 32, smem,
                       static_cast<cudaStream_t>(stream)>>>(
      lo, hi, qsum, P, P_half, out, n, PL, A, out_limbs);
  return static_cast<int>(cudaGetLastError());
}
