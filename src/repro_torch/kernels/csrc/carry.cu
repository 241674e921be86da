// Carry chains over the limb axis of β = 2^32 BigInt rows: the key
// switch's ÷Q rounding shift and the combine's add-and-mask of HE Mul.
//
// Replaces: no Pallas kernel. The JAX package leaves these chains to XLA
//           (src/repro/core/bigint.py shift_right_round, add, mask_bits
//           under jit). The port ran them as bigint._chain, a Python loop
//           over the limb axis of about six PyTorch launches a limb on
//           strided int64 columns: 1,376 launches and 49.2 ms of device
//           time in a B 16 step of the paper's parameters, 38 % of the
//           step, on the H100 (bench/tools/stage_split.py). This family was
//           added for that.
// Bound on the H100: bytes. Each input limb the result depends on is read
//           once and each output limb written once; a few adds and shifts
//           a limb are far below the integer rate.
//           carry_shift_kernel: limbs c0..L−1 of each row (c0 = the limb
//             of the rounding bit 2^(s−1): the limbs below it neither
//             change the result nor carry into it) and out_limbs written.
//             ÷Q at logq 1200 (L 76, s 1200, out 38): 39 + 38 words a
//             coefficient, 323 MB at B·N = 2^20, 0.0964 ms at 3.35 TB/s;
//             reading whole rows (76 words) it would be 478 MB, 0.143 ms.
//           carry_add_kernel: the limbs of a and b below the mask (C =
//             ⌈bits/32⌉ of L) and L written (zeros past C): 3·38 words a
//             coefficient at logq 1200, 478 MB, 0.143 ms. It adds only:
//             no step routes a subtraction through it.
// Design:   the chain is serial within a coefficient and independent
//           across coefficients, so one thread carries one coefficient's
//           limbs in a register and a block of kRows = 128 threads owns
//           128 coefficients:
//           1. the block stages the needed columns of its 128 rows into
//              shared memory by 4-byte cp.async, consecutive threads on
//              consecutive words of the (rows, L) array (coalesced; the
//              rows need not be 16-byte aligned: L is 75 or 37 at the
//              lower levels), every load of the tile in flight at once;
//              the tile's pitch is odd, so that the 32 lanes of a warp,
//              each walking its own row, hit 32 distinct banks;
//           2. each thread walks its row with the carry in a register,
//              writing the sums in place; the shift then writes its
//              shifted words in place too (word j lands on sum j, which no
//              later step reads), so a block holds one tile, 20 KB at the
//              cells' shapes, and ten blocks an SM keep ≈ 200 KB of loads
//              in flight (a second output tile held five);
//           3. the output tile leaves as whole contiguous rows, coalesced.
//           Rows past n (the last block's ragged tail) are neither loaded
//           nor stored. A warp-level carry-lookahead (limbs across lanes,
//           generate/propagate masks by ballot) was not taken: it would
//           shorten phase 2 only, which other blocks' traffic hides (on
//           the H100 at 2^20 coefficients the shift took 0.148 ms, and
//           0.146 ms in a trial build with the walk removed), and leave 57
//           of 96 lanes idle on ÷Q's 39 limbs. What bounds the shift is
//           its reads of half rows (limbs 37–75 of 304-byte rows): it ran
//           at 1.53× the 39-limb bound, about the time of reading the rows
//           whole; the add, on whole rows, at 1.17× its bound.
// Budget:   shared memory 4·128·P bytes for the shift, P = max(C, out) | 1
//           (19,968 B at the cells' shapes, ten blocks an SM), and
//           4·128·2·(C | 1) for the add's two input tiles (39,936 B, five
//           blocks an SM, as many bytes in flight).
#include "common.cuh"

namespace {

constexpr int kRows = 128;  // coefficients (rows) a block, one a thread

__device__ __forceinline__ void stage4(uint32_t* dst, const uint32_t* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d),
               "l"(src));
}

__device__ __forceinline__ void stage_wait() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// Columns c0..c0+cols−1 of `rows` rows (from row0) of a (·, L) array into
// a shared tile at pitch P; the block's threads take consecutive words.
__device__ __forceinline__ void load_tile(uint32_t* tile,
                                          const uint32_t* __restrict__ src,
                                          size_t row0, int rows, int L,
                                          int c0, int cols, int P) {
  if (cols <= 0) return;
  const int total = rows * cols;
  const int step = blockDim.x;
  const int dr = step / cols, dc = step % cols;
  int r = threadIdx.x / cols, c = threadIdx.x % cols;
  for (int e = threadIdx.x; e < total; e += step) {
    stage4(&tile[r * P + c], &src[(row0 + r) * L + c0 + c]);
    r += dr;
    c += dc;
    if (c >= cols) {
      c -= cols;
      ++r;
    }
  }
}

// `rows` whole rows (from row0) of a (·, cols) array from a shared tile at
// pitch P; columns at or past `valid` are written as zeros.
__device__ __forceinline__ void store_tile(uint32_t* __restrict__ dst,
                                           const uint32_t* tile, size_t row0,
                                           int rows, int cols, int valid,
                                           int P) {
  const int total = rows * cols;
  const int step = blockDim.x;
  const int dr = step / cols, dc = step % cols;
  int r = threadIdx.x / cols, c = threadIdx.x % cols;
  uint32_t* out = dst + row0 * cols;
  for (int e = threadIdx.x; e < total; e += step) {
    out[e] = c < valid ? tile[r * P + c] : 0u;
    r += dr;
    c += dc;
    if (c >= cols) {
      c -= cols;
      ++r;
    }
  }
}

// round(x / 2^s) of each (L)-limb two's-complement row, as out_limbs limbs:
// y = x + hbit·2^(32·hw) (hw < 0: no rounding term), then limbs w.. of y
// shifted right by r bits, with y's sign filled in past limb L − 1.
// The tile holds limbs c0..L−1, c0 ≤ min(hw, w) (hw when hw is a limb),
// then the result, in place.
__global__ void __launch_bounds__(kRows)
    carry_shift_kernel(const uint32_t* __restrict__ x,
                       uint32_t* __restrict__ out, int n, int L, int c0,
                       int hw, uint32_t hbit, int w, int r, int out_limbs) {
  const int C = L - c0, P = max(C, out_limbs) | 1;
  uint32_t* tile = dyn_smem;
  const size_t row0 = static_cast<size_t>(blockIdx.x) * kRows;
  const int rows = min(kRows, static_cast<int>(n - row0));
  load_tile(tile, x, row0, rows, L, c0, C, P);
  stage_wait();
  __syncthreads();
  if (static_cast<int>(threadIdx.x) < rows) {
    uint32_t* y = tile + threadIdx.x * P;     // y[k − c0]
    uint32_t carry = 0;
    for (int k = 0; k < C; ++k) {
      const uint64_t s = static_cast<uint64_t>(y[k]) + carry +
                         (k + c0 == hw ? hbit : 0u);
      y[k] = static_cast<uint32_t>(s);
      carry = static_cast<uint32_t>(s >> 32);
    }
    const uint32_t fill =
        static_cast<int32_t>(y[C - 1]) < 0 ? 0xFFFFFFFFu : 0u;
    // o[j] overwrites y[j]: every later read is of y[k − c0] with
    // k − c0 > j, since k ≥ w + j and w ≥ c0
    uint32_t* o = y;
    int k = w;                                // limb of y under o[j]
    uint32_t lo = k < L ? y[k - c0] : fill;
    if (r) {
      for (int j = 0; j < out_limbs; ++j, ++k) {
        const uint32_t hi = k + 1 < L ? y[k + 1 - c0] : fill;
        o[j] = (lo >> r) | (hi << (32 - r));
        lo = hi;
      }
    } else {
      for (int j = 0; j < out_limbs; ++j, ++k)
        o[j] = k < L ? y[k - c0] : fill;
    }
  }
  __syncthreads();
  store_tile(out, tile, row0, rows, out_limbs, out_limbs, P);
}

// (a + b) mod 2^(32·L) of each row, then mod 2^bits: the low C limbs
// carried, limb C − 1 and'ed with top_mask, the limbs past C zero.
__global__ void __launch_bounds__(kRows)
    carry_add_kernel(const uint32_t* __restrict__ a,
                     const uint32_t* __restrict__ b,
                     uint32_t* __restrict__ out, int n, int L, int C,
                     uint32_t top_mask) {
  const int P = C | 1;
  uint32_t* ta = dyn_smem;
  uint32_t* tb = dyn_smem + kRows * P;
  const size_t row0 = static_cast<size_t>(blockIdx.x) * kRows;
  const int rows = min(kRows, static_cast<int>(n - row0));
  load_tile(ta, a, row0, rows, L, 0, C, P);
  load_tile(tb, b, row0, rows, L, 0, C, P);
  stage_wait();
  __syncthreads();
  if (static_cast<int>(threadIdx.x) < rows && C > 0) {
    uint32_t* ya = ta + threadIdx.x * P;
    const uint32_t* yb = tb + threadIdx.x * P;
    uint32_t carry = 0;
    for (int k = 0; k < C; ++k) {
      const uint64_t s = static_cast<uint64_t>(ya[k]) + yb[k] + carry;
      ya[k] = static_cast<uint32_t>(s);
      carry = static_cast<uint32_t>(s >> 32);
    }
    ya[C - 1] &= top_mask;
  }
  __syncthreads();
  store_tile(out, ta, row0, rows, L, C, P);
}

cudaError_t launch_geometry(const void* kernel, int n, size_t smem,
                            dim3* grid) {
  if (n <= 0 || smem > 232448) return cudaErrorInvalidValue;
  const cudaError_t err =
      smem > 48 * 1024
          ? cudaFuncSetAttribute(kernel,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 static_cast<int>(smem))
          : cudaSuccess;
  *grid = dim3((n + kRows - 1) / kRows);
  return err;
}

}  // namespace

// x: (n, L) int32 limb rows, out: (n, out_limbs); both contiguous.
// out = bigint.shift_right_round(x, s, arithmetic=True, out_limbs=...).
// Returns the launch's cudaError_t.
extern "C" int carry_shift_round_launch(const uint32_t* x, uint32_t* out,
                                        int n, int L, int s, int out_limbs,
                                        void* stream) {
  if (L <= 0 || s < 0 || out_limbs <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const int w = s / 32, r = s % 32;
  int hw = -1, c0 = 0;
  uint32_t hbit = 0;
  if (s > 0) {
    hw = (s - 1) / 32;
    hbit = 1u << ((s - 1) % 32);
    if (hw >= L) hw = -1;                     // 2^(s−1) is past the width
    c0 = min((s - 1) / 32, L - 1);
  }
  const int C = L - c0;
  const size_t smem = 4ull * kRows * (max(C, out_limbs) | 1);
  dim3 grid;
  cudaError_t err = launch_geometry(
      reinterpret_cast<const void*>(carry_shift_kernel), n, smem, &grid);
  if (err != cudaSuccess) return static_cast<int>(err);
  carry_shift_kernel<<<grid, kRows, smem, static_cast<cudaStream_t>(stream)>>>(
      x, out, n, L, c0, hw, hbit, w, r, out_limbs);
  return static_cast<int>(cudaGetLastError());
}

// a, b, out: (n, L) int32 limb rows, contiguous; bits ≥ 0.
// out = bigint.mask_bits(bigint.add(a, b), bits).
// Returns the launch's cudaError_t.
extern "C" int carry_add_mask_launch(const uint32_t* a, const uint32_t* b,
                                     uint32_t* out, int n, int L, int bits,
                                     void* stream) {
  if (L <= 0 || bits < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const int w = bits / 32, r = bits % 32;
  int C = L;
  uint32_t top_mask = 0xFFFFFFFFu;
  if (w < L) {
    C = w + (r > 0);
    if (r) top_mask = (1u << r) - 1u;
  }
  const size_t smem = 4ull * kRows * 2 * (C | 1);
  dim3 grid;
  cudaError_t err = launch_geometry(
      reinterpret_cast<const void*>(carry_add_kernel), n, smem, &grid);
  if (err != cudaSuccess) return static_cast<int>(err);
  carry_add_kernel<<<grid, kRows, smem, static_cast<cudaStream_t>(stream)>>>(
      a, b, out, n, L, C, top_mask);
  return static_cast<int>(cudaGetLastError());
}
