// CRT: (N, K) BigInt limbs -> (np, N) residues,
//      out[j, n] = Σ_k x[n, k]·(β^k mod p_j) mod p_j.
//
// Replaces: src/repro/kernels/crt/crt.py, crt_pallas with strategy "acc3"
//           (body _crt_kernel_acc3) and with strategy "mod2"/"mod4" (body
//           _crt_kernel_modx, every = 2 or 4).
// Bound on the H100: 32-bit integer multiplies, N·np·(K + 9) of them (the
//           product and acc3's fold of three Shoup products): 1.5·10^9 at
//           np = 122, K = 38, N = 4·2^16, on 168 MB of traffic. A 32×32→64
//           product takes the multiplier twice (lo and hi word), which that
//           bound does not count.
// Design:   an (N × K)·(K × np) integer product on the CUDA cores, register
//           tiled as the iCRT kernel's column sums are. A block owns kBM =
//           256 coefficients and walks all np primes, 256 threads.
//           1. The block's (256, K) limb tile (contiguous in HBM) and all
//              np rows of the table arrive by cp.async, once, into rows of
//              K padded with zeros to Kp (a multiple of 4) at a pitch of
//              Kp | 4 words: an odd number of 16-byte units, so that the
//              16-byte loads of 8 consecutive rows hit 8 different bank
//              groups. Beside them, each prime's fold constants tb[j, 0..2],
//              tb_sh[j, 0..2] and p_j, 8 words a prime. np is padded with
//              zero rows to a multiple of 8.
//           2. A warp owns 64 coefficients and takes 8 primes at a time;
//              the block's 2 warp columns walk the groups of 8 primes in
//              turn, so a warp stops where the primes end and no group
//              past np is computed. Lane (ty, tx) = (lane & 15, lane >> 4)
//              owns coefficients ty + 16i (i < 4) of its warp's 64 and
//              primes 4tx..4tx+3 of the group: per 4 limbs it loads one
//              16-byte word of limbs for each coefficient (a quarter-warp
//              reads 8 consecutive rows, no conflict) and one of table
//              entries for each prime (a quarter-warp reads one row, a
//              broadcast), 8 loads for 64 products. Each of its 16 outputs
//              sums 4 products (each < 2^62) below 2^64 in widening
//              multiply-adds (IMAD.WIDE); acc3 adds that sum into three
//              words with one add with carry. The zero limbs of the
//              padding are multiplied too (ending K = 38 on a group of 2
//              products is variant "tail2", no faster).
//           3. acc3 folds the three words once, by Shoup products by
//              {1, β, β²} mod p (paper Table VIII, GPU-C). The Mod-x
//              ladder (Table VIII Mod-2/Mod-4) is a template instance of
//              the same kernel whose accumulator is the two-word sum of
//              `Every` products: after each such sum it is folded into a
//              running residue by Shoup products by {1, β} mod p (three
//              residues < p, then two conditional subtractions), as
//              _crt_kernel_modx does, ceil(K / Every) folds in all.
//           4. Each output goes straight from its register to HBM: for one
//              prime and one i, 16 lanes store 16 consecutive coefficients
//              (64 bytes).
// Budget:   shared memory 4·(pitch·(256 + np8) + 8·np8) bytes, np8 = np
//           rounded up to 8: 71,680 B at K = 38 and np = 122. Two blocks
//           fit an SM (ptxas: at most 128 registers, the launch bound).
//           The tile constants were chosen on the card
//           (kernels/crt/variants.py): 256 coefficients a block stage the
//           table half as often a coefficient as 128 do, and were 0–4 %
//           faster at the paper's four shapes.
#include "common.cuh"

namespace {

constexpr int kWarpsM = 4;                        // warps along N
constexpr int kWarpsN = 2;                        // warps along the primes
constexpr int kBM = 64 * kWarpsM;                 // coefficients a block
constexpr int kThreads = 32 * kWarpsM * kWarpsN;  // 256

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

// Σ x_q·y_q over lanes From .. From + Terms − 1 of a and b; each product
// < 2^62, so four sum below 2^64.
template <int Terms, int From = 0>
__device__ __forceinline__ uint64_t dot(const uint4& a, const uint4& b) {
  const uint32_t x[4] = {a.x, a.y, a.z, a.w}, y[4] = {b.x, b.y, b.z, b.w};
  uint64_t s = static_cast<uint64_t>(x[From]) * y[From];
#pragma unroll
  for (int q = From + 1; q < From + Terms; ++q)
    s += static_cast<uint64_t>(x[q]) * y[q];
  return s;
}

// a += s on a three-word accumulator, with carry.
__device__ __forceinline__ void add3(uint32_t (&a)[3], uint64_t s) {
  asm("add.cc.u32 %0, %0, %3;\n\t"
      "addc.cc.u32 %1, %1, %4;\n\t"
      "addc.u32 %2, %2, 0;"
      : "+r"(a[0]), "+r"(a[1]), "+r"(a[2])
      : "r"(static_cast<uint32_t>(s)), "r"(static_cast<uint32_t>(s >> 32)));
}

// Fold constants of one prime: f0 = (tb[0], tb[1], tb[2], tb_sh[0]),
// f1 = (tb_sh[1], tb_sh[2], p, 0).
struct Fold {
  uint4 f0, f1;
};

// r + (s mod p) for r < p, by Shoup products of s's words by {1, β}.
__device__ __forceinline__ uint32_t fold2(uint32_t r, uint64_t s,
                                          const Fold& f) {
  const uint32_t p = f.f1.z;
  r += shoup_mul(static_cast<uint32_t>(s), f.f0.x, f.f0.w, p) +
       shoup_mul(static_cast<uint32_t>(s >> 32), f.f0.y, f.f1.x, p);
  if (r >= 2 * p) r -= 2 * p;  // r < 3p before
  return r >= p ? r - p : r;
}

// a mod p for a three-word accumulator, by Shoup products of its words by
// {1, β, β²}.
__device__ __forceinline__ uint32_t fold3(const uint32_t (&a)[3],
                                          const Fold& f) {
  const uint32_t p = f.f1.z;
  uint32_t r = shoup_mul(a[0], f.f0.x, f.f0.w, p) +
               shoup_mul(a[1], f.f0.y, f.f1.x, p) +
               shoup_mul(a[2], f.f0.z, f.f1.y, p);  // < 3p
  if (r >= 2 * p) r -= 2 * p;
  return r >= p ? r - p : r;
}

// Every = 0: acc3 (3-word accumulator, one fold); 2 or 4: Mod-x.
template <int Every>
__global__ void __launch_bounds__(kThreads, 2)
crt_kernel(const uint32_t* __restrict__ x, const uint32_t* __restrict__ tb,
           const uint32_t* __restrict__ tb_sh,
           const uint32_t* __restrict__ primes, uint32_t* __restrict__ out,
           int n, int K, int np, int tb_cols) {
  const int t = threadIdx.x;
  const int n0 = blockIdx.x * kBM;
  const int nb = min(kBM, n - n0);            // coefficients of this block
  const int Kp = (K + 3) & ~3;
  const int pitch = Kp | 4;
  const int np8 = (np + 7) & ~7;
  uint32_t* xs = dyn_smem;                    // (kBM, pitch)
  uint32_t* ts = xs + kBM * pitch;            // (np8, pitch)
  uint32_t* fc = ts + np8 * pitch;            // (np8, 8)

  // 1. the limb tile (nb·K contiguous words), the table and the fold
  //    constants in; zeros past K, nb and np
  {
    const uint32_t* src = x + static_cast<size_t>(n0) * K;
    const int dr = kThreads / K, dk = kThreads % K;
    for (int e = t, r = t / K, k = t % K; e < nb * K; e += kThreads) {
      cp_async4(&xs[r * pitch + k], src + e, true);
      r += dr;
      k += dk;
      if (k >= K) k -= K, ++r;
    }
  }
  for (int r = t; r < kBM; r += kThreads)
    for (int k = r < nb ? K : 0; k < Kp; ++k) xs[r * pitch + k] = 0;
  {
    const int dr = kThreads / Kp, dk = kThreads % Kp;
    for (int e = t, j = t / Kp, k = t % Kp; e < np8 * Kp; e += kThreads) {
      const bool ok = j < np && k < K;
      cp_async4(&ts[j * pitch + k], ok ? &tb[j * tb_cols + k] : tb, ok);
      j += dr;
      k += dk;
      if (k >= Kp) k -= Kp, ++j;
    }
  }
  for (int e = t; e < np8 * 8; e += kThreads) {
    const int j = e >> 3, w = e & 7;
    const bool ok = j < np && w < 7;
    const uint32_t* src = w < 3   ? &tb[j * tb_cols + w]
                          : w < 6 ? &tb_sh[j * tb_cols + w - 3]
                                  : &primes[j];
    cp_async4(&fc[e], ok ? src : primes, ok);
  }
  cp_async_wait_all();
  __syncthreads();

  // 2.-4. groups of 8 primes, per warp column
  const int lane = t & 31, w = t >> 5;
  const int ty = lane & 15, tx = lane >> 4;
  const int row0 = (w / kWarpsN) * 64 + ty;   // rows row0 + 16i
  const uint32_t* xr = xs + row0 * pitch;
  for (int g = w % kWarpsN; g < np8 / 8; g += kWarpsN) {
    const int j0 = g * 8 + tx * 4;            // primes j0..j0+3
    const uint32_t* tr = ts + j0 * pitch;
    // Mod-x folds in the loop; acc3 loads its constants after it, where
    // the 32 registers they take are free
    Fold f[4];
    const auto load_fold = [&] {
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        f[c].f0 = *reinterpret_cast<const uint4*>(&fc[(j0 + c) * 8]);
        f[c].f1 = *reinterpret_cast<const uint4*>(&fc[(j0 + c) * 8 + 4]);
      }
    };
    if constexpr (Every != 0) load_fold();
    uint32_t acc[4][4][3] = {};               // acc3: three words
    uint32_t r[4][4] = {};                    // Mod-x: running residue
#pragma unroll 2
    for (int k = 0; k < Kp; k += 4) {
      uint4 xv[4], yv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        xv[i] = *reinterpret_cast<const uint4*>(&xr[16 * i * pitch + k]);
#pragma unroll
      for (int c = 0; c < 4; ++c)
        yv[c] = *reinterpret_cast<const uint4*>(&tr[c * pitch + k]);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          if constexpr (Every == 0) {
            add3(acc[i][c], dot<4>(xv[i], yv[c]));
          } else if constexpr (Every == 4) {
            r[i][c] = fold2(r[i][c], dot<4>(xv[i], yv[c]), f[c]);
          } else {
            r[i][c] = fold2(r[i][c], dot<2>(xv[i], yv[c]), f[c]);
            if (k + 2 < K)  // ceil(K / 2) folds, none of padding alone
              r[i][c] = fold2(r[i][c], dot<2, 2>(xv[i], yv[c]), f[c]);
          }
        }
    }
    if constexpr (Every == 0) load_fold();
#pragma unroll
    for (int c = 0; c < 4; ++c) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        uint32_t v = r[i][c];
        if constexpr (Every == 0) v = fold3(acc[i][c], f[c]);
        if (j0 + c < np && row0 + 16 * i < nb)
          out[static_cast<size_t>(j0 + c) * n + n0 + row0 + 16 * i] = v;
      }
    }
  }
}

template <int Every>
int crt_run(const uint32_t* x, const uint32_t* tb, const uint32_t* tb_sh,
            const uint32_t* primes, uint32_t* out, int n, int K, int np,
            int tb_cols, int blocks, int smem, cudaStream_t stream) {
  cudaError_t err = allow_smem(crt_kernel<Every>, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  crt_kernel<Every><<<blocks, kThreads, smem, stream>>>(x, tb, tb_sh, primes,
                                                        out, n, K, np,
                                                        tb_cols);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// x: (n, K); tb, tb_sh: (np, tb_cols) with tb_cols ≥ max(K, 3); primes:
// (np,); out: (np, n). every: 0 for acc3, 2 or 4 for Mod-2 / Mod-4.
// blocks, threads and smem are kernels/crt/ops.py's crt_geometry; the
// launcher refuses a geometry that does not cover n or does not hold its
// shared tiles.
extern "C" int crt_launch(const uint32_t* x, const uint32_t* tb,
                          const uint32_t* tb_sh, const uint32_t* primes,
                          uint32_t* out, int n, int K, int np, int tb_cols,
                          int every, int blocks, int threads, int smem,
                          void* stream) {
  const int pitch = ((K + 3) & ~3) | 4, np8 = (np + 7) & ~7;
  if (threads != kThreads || static_cast<int64_t>(blocks) * kBM < n ||
      (n > kBM && n % kBM) || K < 1 || tb_cols < (K > 3 ? K : 3) ||
      smem < 4 * (pitch * (kBM + np8) + 8 * np8))
    return static_cast<int>(cudaErrorInvalidConfiguration);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (every) {
    case 0: return crt_run<0>(x, tb, tb_sh, primes, out, n, K, np, tb_cols,
                              blocks, smem, st);
    case 2: return crt_run<2>(x, tb, tb_sh, primes, out, n, K, np, tb_cols,
                              blocks, smem, st);
    case 4: return crt_run<4>(x, tb, tb_sh, primes, out, n, K, np, tb_cols,
                              blocks, smem, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
