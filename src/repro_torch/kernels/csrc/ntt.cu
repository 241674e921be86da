// Negacyclic NTT / iNTT over (rows, N) residues: passes of up to 8 stages,
// each a set of 2^L-point sub-transforms held in a warp's registers.
//
// Replaces: src/repro/kernels/ntt/ntt.py, ntt_pallas (body _ntt_kernel)
//           and intt_pallas (body _intt_kernel), modified=False and
//           modified=True.
// Bound on the H100: bytes. Each call must read x, ψ and ψ_shoup and write
//           the result (16 bytes per word); the butterflies need only
//           3 multiplies each. A design of two passes over device memory
//           moves the data twice (24 bytes per word): its floor.
// Design:   the TPU kernel keeps a whole row in VMEM for all log2 N stages.
//           A row at N = 2^16 is 256 KiB, above a block's 227 KB of shared
//           memory, so the stages are split into passes over device memory
//           (paper §V-C, Table IX; Jung et al., TCHES 2021): the last
//           min(log2 N, 8) forward stages run on contiguous chunks of
//           2^L words ("chunk" pass), the stages before them 8 at a time on
//           columns of words 2^lt apart ("column" pass, lt ≥ 8). At
//           N = 2^16 a row is 256 × 256, element n = c + 256·k, and each
//           transform is two passes: stages 0–7 on the 256 columns, stages
//           8–15 on the 256 chunks; the inverse runs the mirror image.
//             - A warp owns 512 words (two 256-point sub-transforms), 16 a
//               lane, and runs the stages in registers, four bits of the
//               sub-transform's index at a time; between the two groups it
//               exchanges its words through shared memory with one
//               __syncwarp. A word's place in its 32-word row of shared
//               memory is XORed with a function of the row (`col_pos`,
//               `chunk_pos`), so that the tile's loads and stores hit 32
//               distinct banks, and the exchange's layouts too at 8 words
//               a lane; at 16 some layouts meet 2-way conflicts, which the
//               exchange saved more than pays for (PERF.md, variant w8).
//             - A column pass stages a tile of 32 columns (32 KB) through
//               registers, in 16-byte vectors, coalesced; a chunk pass
//               loads its words straight into registers in a coalesced
//               layout and stores them from one (16-byte vectors on one
//               side).
//             - Each sub-transform's 2^L − 1 twiddle pairs (ψ, ψ_shoup) are
//               staged once by cp.async: each table word is read once per
//               row. A chunk pass's block takes several rows that share a
//               twiddle row (row r = b·np + j takes row j), and all blocks
//               run in one flat grid, the rows that share twiddles next to
//               each other, so the tables are read from device memory
//               about once, and B·np is not capped by gridDim.y.
//             - The passes, their tiles, blocks and shared memory are given
//               by kernels/ntt/ops.py ntt_geometry; the launcher refuses a
//               geometry its kernels cannot run.
//             - The passes of 8 stages (ntt_pass8: every pass at N = 2^16)
//               know every index at compile time and use Harvey's lazy
//               butterflies (words in [0, 4p) between stages, brought to
//               [0, p) before the store); the others (ntt_pass: small N,
//               the split of other sizes) compute exactly, at run time.
//           Conventions are the JAX kernel's: forward is merged-ψ
//           Cooley–Tukey, natural order in, bit-reversed out, twiddle
//           ψ_rev[m + i]; the inverse is Gentleman–Sande with ψ⁻¹_rev[h + i]
//           and ends with ·N⁻¹ (Shoup), fused into its last pass's store.
// Modified: every kernel is a template on `Modified`. With it, each Shoup
//           product (the butterflies and the ·N⁻¹) takes its quotient from
//           the paper's 3-half-multiply approximate mulhi (§V-B,
//           shoup_mul_modified in common.cuh) and corrects r ∈ [0, 4p) with
//           two conditional subtractions (one, to [0, 2p), in the lazy
//           butterflies). Both variants are exact, so they
//           give the same words. Hopper has a widening multiply, so the
//           exact quotient is one __umulhi and the modified variant is
//           slower here (PERF.md has the measurement).
#include "common.cuh"

namespace {

constexpr int kLogW = 4;                    // words a lane
constexpr int kW = 1 << kLogW;
constexpr int kLogP = 5 + kLogW;            // words a warp owns: 512
constexpr int kWarps = 8;
constexpr int kThreads = 32 * kWarps;
constexpr int kLogChunkTile = kLogP + 3;    // a chunk pass's tile: 4096
constexpr int kStages = 8;                  // stages a pass, at most

// One pass: stages s0 .. s0 + L − 1 on sub-transforms of 2^L words whose
// neighbours are 2^lt apart (lt = log2 N − s0 − L).
struct Pass {
  int logn, s0, L, lt;
  int logT;      // words a tile (a block)
  int tiles;     // tiles a row
  int np, nb;    // twiddle rows; rows per twiddle row (B)
  int rpb;       // rows of one twiddle row a block takes (1 but for the
                 // chunk passes of ntt_pass8)
  int scale;     // multiply by N⁻¹ before the store (last inverse pass)
};

// Block → (tile, twiddle row j, rows b0 .. b1 − 1) of the flat grid: row
// b·np + j takes twiddle row j; the ⌈B / rpb⌉ blocks of the rows that share
// it run next to each other (b fastest), then the tiles, then j.
struct Where {
  int ti, j, b0, b1;
  __device__ size_t row(const Pass& ps, int b) const {
    return static_cast<size_t>(b) * ps.np + j;
  }
};

__device__ __forceinline__ Where where(const Pass& ps) {
  const int bid = blockIdx.x, groups = (ps.nb + ps.rpb - 1) / ps.rpb;
  const int g = bid % groups, rest = bid / groups;
  const int ti = rest % ps.tiles, j = rest / ps.tiles;
  const int b0 = g * ps.rpb;
  return {ti, j, b0, b0 + ps.rpb < ps.nb ? b0 + ps.rpb : ps.nb};
}

// a 4-byte cp.async into shared memory
__device__ __forceinline__ void cp_async4(uint32_t* dst, const uint32_t* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d),
               "l"(src));
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// h ↦ h ^ (h << 2) on 3 bits: injective both in bits 0–2 and in bits 2–4.
__device__ __forceinline__ int swizzle(int h) { return (h ^ (h << 2)) & 31; }

// Shared-memory positions, in rows of 32 words whose column is XORed with
// a function of the row. A column pass's tile is 2^L rows of its 32
// columns: word k of column c sits at col_pos(k) ^ c. A chunk pass's
// words sit in the order of device memory: word s at chunk_pos(s). The
// 256 words σ of a sub-transform (σ = k, or the word's offset) then sit at
// banks σ[0:5] ^ swizzle(σ[5:8]) (^ c); at 8 words a lane, lanes that vary
// any 5 of the 8 bits a layout gives them differ in bank. Both maps are
// linear over GF(2), so the position of slot lane_part ^ (q << b) is that
// of lane_part XOR a constant.
__device__ __forceinline__ int col_pos(int k) {
  return (k << 5) ^ (k & 31) ^ swizzle((k >> 5) & 7);
}

__device__ __forceinline__ int chunk_pos(int s) {
  return s ^ swizzle((s >> 5) & 7);
}

// Shared-memory position of slot J of the tile: sub-transform J >> L,
// element J & (2^L − 1).
template <bool Col>
__device__ __forceinline__ int slot_pos(int J, int L) {
  return Col ? col_pos(J & ((1 << L) - 1)) ^ (J >> L) : chunk_pos(J);
}

// Lane bits of a slot in the layout whose register index q holds slot
// bits b .. b + kLogW − 1: slot = lane_part | q << b.
__device__ __forceinline__ int lane_part(int lane, int b) {
  return (lane & ((1 << b) - 1)) | ((lane >> b) << (b + kLogW));
}

// The twiddle pairs of the block: set (sub-transform) s, local stage l,
// group i: smem[(s << L) + 2^l + i]; g, g_sh are the tables in device
// memory (the global_twiddles variant of kernels/ntt/variants.py reads
// them in every butterfly).
struct Twiddles {
  const uint2* smem;
  const uint32_t* g;
  const uint32_t* g_sh;
  size_t toff;   // the twiddle row
  int top;       // 2^s0 + a − 1 of the block's first sub-transform
};

// The butterflies of sub-transform bits lo .. hi − 1 (forward: high to
// low; inverse: low to high) on the words of one layout.
template <bool Fwd, bool Col, bool M>
__device__ __forceinline__ void butterflies(uint32_t (&v)[kW],
                                            const Twiddles& tws, int J0,
                                            int b, int lo, int hi, int L,
                                            uint32_t p) {
#pragma unroll
  for (int i = 0; i < kLogW; ++i) {
    const int qb = Fwd ? kLogW - 1 - i : i;
    const int e = b + qb;
    if (e < lo || e >= hi) continue;
    const int d = 1 << qb;
    const int l = L - 1 - e;
#pragma unroll
    for (int q = 0; q < kW; ++q) {
      if (q & d) continue;
      const int J = J0 + (q << b);
      const int k = J & ((1 << L) - 1);
      const int set = Col ? 0 : J >> L;
      const uint2 w = tws.smem[(set << L) + (1 << l) + (k >> (e + 1))];
      if (Fwd) {
        const uint32_t x = shoup_mul_t<M>(v[q + d], w.x, w.y, p);
        v[q + d] = mod_sub(v[q], x, p);
        v[q] = mod_add(v[q], x, p);
      } else {
        const uint32_t u = v[q], y = v[q + d];
        v[q] = mod_add(u, y, p);
        v[q + d] = shoup_mul_t<M>(mod_sub(u, y, p), w.x, w.y, p);
      }
    }
  }
}

// Any pass, at run time: a block stages its tile and its twiddles in shared
// memory; a warp takes 1 << kLogP slots of the tile at a time (slots past
// the tile, at small N, are skipped).
template <bool Fwd, bool Col, bool M>
__global__ void __launch_bounds__(kThreads)
    ntt_pass(const Pass ps, const uint32_t* in, uint32_t* out,
             const uint32_t* __restrict__ tw,
             const uint32_t* __restrict__ tw_sh,
             const uint32_t* __restrict__ n_inv,
             const uint32_t* __restrict__ n_inv_sh,
             const uint32_t* __restrict__ primes) {
  const int L = ps.L, T = 1 << ps.logT;
  const Where at = where(ps);
  const size_t row = at.row(ps, at.b0);
  const int ti = at.ti, j = at.j;
  const uint32_t* src = in + (row << ps.logn);
  uint32_t* dst = out + (row << ps.logn);
  const uint32_t p = primes[j];
  // the tile's first sub-transform a0 and first word; word (r, c) of the
  // tile is base + (r << rshift) + c
  const int a0 = Col ? ti >> (ps.lt - 5) : ti << (ps.logT - L);
  const int base =
      Col ? (a0 << (ps.logn - ps.s0)) + ((ti & ((1 << (ps.lt - 5)) - 1)) << 5)
          : ti << ps.logT;
  const int rshift = Col ? ps.lt : 5;

  uint32_t* sm = dyn_smem;
  uint32_t* stw = dyn_smem + T;
  for (int i = threadIdx.x; i < T; i += kThreads) {
    const int r = i >> 5, c = i & 31;
    cp_async4(&sm[Col ? col_pos(r) ^ c : chunk_pos(i)],
              src + base + (r << rshift) + c);
  }
  const Twiddles tws = {reinterpret_cast<const uint2*>(stw), tw, tw_sh,
                        static_cast<size_t>(j) << ps.logn,
                        (1 << ps.s0) + a0 - 1};
  const int nsets = Col ? 1 : T >> L;
  for (int i = threadIdx.x; i < (nsets << L); i += kThreads) {
    const int m = i & ((1 << L) - 1);
    if (m == 0) continue;
    const int l = 31 - __clz(m);
    const size_t g = tws.toff +
                     (static_cast<size_t>(tws.top + (i >> L)) << l) + m;
    cp_async4(&stw[2 * i], tw + g);
    cp_async4(&stw[2 * i + 1], tw_sh + g);
  }
  cp_async_wait_all();
  __syncthreads();

  const int lane = threadIdx.x & 31;
  for (int jb = (threadIdx.x >> 5) << kLogP; jb < T; jb += kWarps << kLogP) {
    uint32_t v[kW];
    int sb = Fwd ? max(L - kLogW, 0) : 0;
    int J0 = jb + lane_part(lane, sb);
#pragma unroll
    for (int q = 0; q < kW; ++q) {
      const int J = J0 + (q << sb);
      v[q] = J < T ? sm[slot_pos<Col>(J, L)] : 0;
    }
    int lo = Fwd ? sb : 0, hi = Fwd ? L : min(kLogW, L);
    for (;;) {
      butterflies<Fwd, Col, M>(v, tws, J0, sb, lo, hi, L, p);
      if (Fwd ? lo == 0 : hi == L) break;
#pragma unroll
      for (int q = 0; q < kW; ++q) {
        const int J = J0 + (q << sb);
        if (J < T) sm[slot_pos<Col>(J, L)] = v[q];
      }
      sb = Fwd ? max(lo - kLogW, 0) : min(hi, max(L - kLogW, 0));
      J0 = jb + lane_part(lane, sb);
      __syncwarp();
#pragma unroll
      for (int q = 0; q < kW; ++q) {
        const int J = J0 + (q << sb);
        if (J < T) v[q] = sm[slot_pos<Col>(J, L)];
      }
      if (Fwd) {
        hi = lo;
        lo = sb;
      } else {
        lo = hi;
        hi = min(sb + kLogW, L);
      }
    }
    if (ps.scale) {
      const uint32_t ni = n_inv[j], ni_sh = n_inv_sh[j];
#pragma unroll
      for (int q = 0; q < kW; ++q) v[q] = shoup_mul_t<M>(v[q], ni, ni_sh, p);
    }
#pragma unroll
    for (int q = 0; q < kW; ++q) {
      const int J = J0 + (q << sb);
      if (J < T) sm[slot_pos<Col>(J, L)] = v[q];
    }
  }
  __syncthreads();
  for (int i = threadIdx.x; i < T; i += kThreads) {
    const int r = i >> 5, c = i & 31;
    dst[base + (r << rshift) + c] = sm[Col ? col_pos(r) ^ c : chunk_pos(i)];
  }
}

// ---- The passes of 8 stages (every pass at N = 2^16): the same
// sub-transforms with every index known at compile time. ----

constexpr int kLogS = 8;                           // stages of such a pass
constexpr int kSubs = 1 << (kLogP - kLogS);        // sub-transforms a warp
constexpr int kWin = (kLogS + kLogW - 1) / kLogW;  // register layouts

// Slot bits b .. b + kLogW − 1 of layout i sit in the register index.
__host__ __device__ constexpr int win_base(bool fwd, int i) {
  return fwd ? (kLogS - (i + 1) * kLogW > 0 ? kLogS - (i + 1) * kLogW : 0)
             : (i * kLogW < kLogS - kLogW ? i * kLogW : kLogS - kLogW);
}

// x·y mod p up to a multiple of p: the Shoup product without its last
// correction, in [0, 2p) for any x < 2^32 (modified: the approximate
// quotient leaves [0, 4p), brought back to [0, 2p)); p < 2^30.
template <bool M>
__device__ __forceinline__ uint32_t shoup_lazy(uint32_t x, uint32_t y,
                                               uint32_t y_sh, uint32_t p) {
  const uint32_t q = M ? mulhi_approx3(x, y_sh) : __umulhi(x, y_sh);
  const uint32_t r = x * y - q * p;
  return M ? min(r, r - 2 * p) : r;
}

// The butterflies of bits lo .. hi − 1 in the layout of base b, twiddle
// set `set`, lpk the lane's part of the sub-transform index. Harvey's lazy
// butterflies: a forward word stays in [0, 4p), an inverse one in [0, 2p)
// (4p < 2^32), and the pass brings them to [0, p) before its store, so
// the words are those of the exact transform.
template <bool Fwd, bool M>
__device__ __forceinline__ void butterflies8(uint32_t (&v)[kW],
                                             const Twiddles& tws, int set,
                                             int lpk, int b, int lo, int hi,
                                             uint32_t p) {
#pragma unroll
  for (int i = 0; i < kLogW; ++i) {
    const int qb = Fwd ? kLogW - 1 - i : i;
    const int e = b + qb;
    if (e < lo || e >= hi) continue;
    const int d = 1 << qb;
    const int l = kLogS - 1 - e;
    const int t0 = (set << kLogS) + (1 << l) + (lpk >> (e + 1));
#pragma unroll
    for (int q = 0; q < kW; ++q) {
      if (q & d) continue;
      const int cq = (q << b) >> (e + 1);
      const uint2 w = tws.smem[t0 + cq];
      if (Fwd) {
        const uint32_t x = min(v[q], v[q] - 2 * p);
        const uint32_t t = shoup_lazy<M>(v[q + d], w.x, w.y, p);
        v[q] = x + t;
        v[q + d] = x - t + 2 * p;
      } else {
        const uint32_t u = v[q], y = v[q + d];
        v[q] = min(u + y, u + y - 2 * p);
        v[q + d] = shoup_lazy<M>(u - y + 2 * p, w.x, w.y, p);
      }
    }
  }
}

// Position in the group's exchange space of slot lane_part(lane, b) ^
// (q << b), without the q term: a column pass's group is kSubs adjacent
// columns of the tile from col0, a chunk pass's the warp's slice.
template <bool Col>
__device__ __forceinline__ int group_pos(int lp, int col0) {
  return Col ? col_pos(lp & 255) ^ (col0 + (lp >> kLogS)) : chunk_pos(lp);
}

template <bool Col>
__device__ __forceinline__ int slot_term(int q, int b) {
  return Col ? col_pos(q << b) : chunk_pos(q << b);
}

// One pass of 8 stages. A column pass stages a tile of 32 columns in
// 16-byte vectors and each warp takes kSubs columns at a time from it. A chunk
// pass's block takes rows of one twiddle row (ps.rpb of them), whose
// twiddles it stages once; its warps load their kSubs chunks of a row
// straight into registers (coalesced in the forward layout, 16-byte
// vectors in the inverse), the next row's while they transform this one,
// and store them so, exchanging through a slice of their own.
template <bool Fwd, bool Col, bool M>
__global__ void __launch_bounds__(kThreads)
    ntt_pass8(const Pass ps, const uint32_t* in, uint32_t* out,
              const uint32_t* __restrict__ tw,
              const uint32_t* __restrict__ tw_sh,
              const uint32_t* __restrict__ n_inv,
              const uint32_t* __restrict__ n_inv_sh,
              const uint32_t* __restrict__ primes) {
  constexpr int kData = Col ? 32 << kLogS : kWarps << kLogP;
  constexpr int kSets = Col ? 1 : kWarps * kSubs;
  constexpr int kB0 = win_base(Fwd, 0), kBn = win_base(Fwd, kWin - 1);
  const Where at = where(ps);
  const uint32_t p = primes[at.j];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  // word (k, c) of a column tile is base + (k << lt) + c; word s of a
  // chunk tile is base + s; rows b·np + j are np rows apart
  const int a0 = Col ? at.ti >> (ps.lt - 5) : at.ti << (ps.logT - kLogS);
  const int base =
      Col ? (a0 << (ps.logn - ps.s0)) + ((at.ti & ((1 << (ps.lt - 5)) - 1))
                                         << 5)
          : at.ti << ps.logT;
  const size_t first = at.row(ps, at.b0) << ps.logn;
  const size_t stride = static_cast<size_t>(ps.np) << ps.logn;

  uint32_t* sm = dyn_smem;
  uint2* stw = reinterpret_cast<uint2*>(dyn_smem + kData);
  const Twiddles tws = {stw, tw, tw_sh, static_cast<size_t>(at.j) << ps.logn,
                        (1 << ps.s0) + a0 - 1};
  for (int i = threadIdx.x; i < (kSets << kLogS); i += kThreads) {
    const int m = i & ((1 << kLogS) - 1);
    if (m == 0) continue;
    const int l = 31 - __clz(m);
    const size_t g = tws.toff +
                     (static_cast<size_t>(tws.top + (i >> kLogS)) << l) + m;
    cp_async4(reinterpret_cast<uint32_t*>(stw + i), tw + g);
    cp_async4(reinterpret_cast<uint32_t*>(stw + i) + 1, tw_sh + g);
  }
  // a chunk pass's words of row b, in the first layout
  const auto load = [&](uint32_t (&v)[kW], int b) {
    const uint32_t* chunk =
        in + first + (b - at.b0) * stride + base + (warp << kLogP);
    if (Fwd) {
      const int lp = lane_part(lane, kB0);
#pragma unroll
      for (int q = 0; q < kW; ++q) v[q] = __ldcs(chunk + lp + (q << kB0));
    } else {
      const uint4* c4 =
          reinterpret_cast<const uint4*>(chunk + (lane << kLogW));
#pragma unroll
      for (int i = 0; i < kW / 4; ++i) {
        const uint4 t = __ldcs(c4 + i);
        v[4 * i] = t.x;
        v[4 * i + 1] = t.y;
        v[4 * i + 2] = t.z;
        v[4 * i + 3] = t.w;
      }
    }
  };
  uint32_t v[kW], next[kW];
  if (Col) {
    const uint32_t* src = in + first + base;
const int c4 = (threadIdx.x & 7) << 2;
    uint4 t[(1 << kLogS) / (kThreads / 8)];
#pragma unroll
    for (int i = 0; i < (1 << kLogS) / (kThreads / 8); ++i)
      t[i] = __ldcs(reinterpret_cast<const uint4*>(
          src + (((threadIdx.x >> 3) + i * (kThreads / 8)) << ps.lt) + c4));
#pragma unroll
    for (int i = 0; i < (1 << kLogS) / (kThreads / 8); ++i) {
      const int pr = col_pos((threadIdx.x >> 3) + i * (kThreads / 8));
      sm[pr ^ c4] = t[i].x;
      sm[pr ^ (c4 + 1)] = t[i].y;
      sm[pr ^ (c4 + 2)] = t[i].z;
      sm[pr ^ (c4 + 3)] = t[i].w;
    }
  } else {
    load(v, at.b0);
  }
  cp_async_wait_all();
  __syncthreads();

  uint32_t* xs = Col ? sm : sm + (warp << kLogP);
  for (int rb = at.b0; rb < at.b1; ++rb) {
    if (!Col && rb + 1 < at.b1) load(next, rb + 1);
    for (int g = warp; g < (Col ? 32 / kSubs : kWarps); g += kWarps) {
      const int col0 = g * kSubs;
      if (Col) {
        const int pb = group_pos<Col>(lane_part(lane, kB0), col0);
#pragma unroll
        for (int q = 0; q < kW; ++q) v[q] = xs[pb ^ slot_term<Col>(q, kB0)];
      }
#pragma unroll
      for (int i = 0; i < kWin; ++i) {
        const int b = win_base(Fwd, i);
        const int lp = lane_part(lane, b);
        if (i > 0) {
          const int bp = win_base(Fwd, i - 1);
          const int pp = group_pos<Col>(lane_part(lane, bp), col0);
          __syncwarp();
#pragma unroll
          for (int q = 0; q < kW; ++q) xs[pp ^ slot_term<Col>(q, bp)] = v[q];
          __syncwarp();
          const int pb = group_pos<Col>(lp, col0);
#pragma unroll
          for (int q = 0; q < kW; ++q) v[q] = xs[pb ^ slot_term<Col>(q, b)];
        }
        const int lo = Fwd ? b : i * kLogW;
        const int hi = Fwd ? kLogS - i * kLogW
                           : ((i + 1) * kLogW < kLogS ? (i + 1) * kLogW
                                                      : kLogS);
        butterflies8<Fwd, M>(v, tws, Col ? 0 : col0 + (lp >> kLogS),
                             lp & ((1 << kLogS) - 1), b, lo, hi, p);
      }
      if (ps.scale) {
        const uint32_t ni = n_inv[at.j], ni_sh = n_inv_sh[at.j];
#pragma unroll
        for (int q = 0; q < kW; ++q)
          v[q] = shoup_mul_t<M>(v[q], ni, ni_sh, p);
      } else {
#pragma unroll
        for (int q = 0; q < kW; ++q) {
          if (Fwd) v[q] = min(v[q], v[q] - 2 * p);
          v[q] = min(v[q], v[q] - p);
        }
      }
      if (Col) {
        const int pb = group_pos<Col>(lane_part(lane, kBn), col0);
#pragma unroll
        for (int q = 0; q < kW; ++q) xs[pb ^ slot_term<Col>(q, kBn)] = v[q];
      }
    }
    uint32_t* dst = out + first + (rb - at.b0) * stride + base;
    if (Col) {
      __syncthreads();
const int c4 = (threadIdx.x & 7) << 2;
#pragma unroll 8
      for (int r = threadIdx.x >> 3; r < (1 << kLogS); r += kThreads / 8) {
        const int pr = col_pos(r);
        __stcs(reinterpret_cast<uint4*>(dst + (r << ps.lt) + c4),
               make_uint4(sm[pr ^ c4], sm[pr ^ (c4 + 1)], sm[pr ^ (c4 + 2)],
                          sm[pr ^ (c4 + 3)]));
      }
    } else if (Fwd) {
      uint4* c4 =
          reinterpret_cast<uint4*>(dst + (warp << kLogP) + (lane << kLogW));
#pragma unroll
      for (int i = 0; i < kW / 4; ++i)
        __stcs(c4 + i, make_uint4(v[4 * i], v[4 * i + 1], v[4 * i + 2],
                                  v[4 * i + 3]));
    } else {
      const int lp = lane_part(lane, kBn);
      uint32_t* c = dst + (warp << kLogP);
#pragma unroll
      for (int q = 0; q < kW; ++q) __stcs(c + lp + (q << kBn), v[q]);
    }
    if (!Col) {
#pragma unroll
      for (int q = 0; q < kW; ++q) v[q] = next[q];
    }
  }
}

// One pass of the geometry that kernels/ntt/ops.py ntt_geometry gives (its
// one source), in forward order: stages, log2 of the words a tile, rows a
// block, blocks, threads, dynamic shared-memory bytes.
constexpr int kGeom = 6;
constexpr int kMaxPasses = 4;   // ⌈30 / 8⌉

// The passes of `geom` as the kernels take them, and which of them
// ntt_pass8 runs. False where a kernel cannot run one: stages that do not
// add up to logn or exceed 8 a pass, a column pass's tile other than 32
// columns of 2^L words, a chunk pass's tile outside [2^L, N], several rows
// a block where only ntt_pass8's chunk pass takes them, other than
// kThreads threads, blocks that do not cover the rows exactly as where()
// decodes them, or shared memory that does not hold the tile and its
// twiddles.
bool passes(const int* geom, int npasses, int rows, int np, int logn,
            Pass (&ps)[kMaxPasses], bool (&eight)[kMaxPasses]) {
  if (logn < 1 || logn > 30 || np < 1 || rows < np || rows % np ||
      npasses < 1 || npasses > kMaxPasses)
    return false;
  int s0 = 0;
  for (int w = 0; w < npasses; ++w) {
    const int* g = geom + kGeom * w;
    const bool col = w != npasses - 1;
    Pass& p = ps[w];
    p = {logn, s0, g[0], logn - s0 - g[0], g[1], 0, np, rows / np, g[2], 0};
    s0 += p.L;
    if (p.L < 1 || p.L > kStages || p.rpb < 1 || g[4] != kThreads ||
        (col ? p.logT != p.L + 5 || p.lt < 5
             : p.lt != 0 || p.logT < p.L || p.logT > logn))
      return false;
    p.tiles = 1 << (logn - p.logT);
    eight[w] = p.L == kLogS && (col || p.logT == kLogChunkTile);
    if (p.rpb > 1 && (col || !eight[w])) return false;
    const int sets =
        col ? 1 : (p.logT > kLogP ? 1 << p.logT : 1 << kLogP) >> p.L;
    const long long smem = (4LL << p.logT) + (8LL * sets << p.L);
    const long long blocks = static_cast<long long>(np) * p.tiles *
                             ((p.nb + p.rpb - 1) / p.rpb);
    if (g[3] != blocks || g[5] < smem) return false;
  }
  return s0 == logn;
}

template <bool Fwd, bool Col, bool M>
cudaError_t launch_pass(const Pass& ps, bool eight, const int* g,
                        const uint32_t* in, uint32_t* out, const uint32_t* tw,
                        const uint32_t* tw_sh, const uint32_t* n_inv,
                        const uint32_t* n_inv_sh, const uint32_t* primes,
                        cudaStream_t st) {
  const auto kernel = eight ? ntt_pass8<Fwd, Col, M> : ntt_pass<Fwd, Col, M>;
  cudaError_t err = allow_smem(kernel, g[5]);
  if (err != cudaSuccess) return err;
  kernel<<<g[3], kThreads, g[5], st>>>(ps, in, out, tw, tw_sh, n_inv,
                                       n_inv_sh, primes);
  return cudaGetLastError();
}

template <bool Fwd, bool M>
int transform(const uint32_t* x, const uint32_t* tw, const uint32_t* tw_sh,
              const uint32_t* n_inv, const uint32_t* n_inv_sh,
              const uint32_t* primes, uint32_t* out, int rows, int np,
              int logn, int npasses, const int* geom, cudaStream_t st) {
  Pass ps[kMaxPasses];
  bool eight[kMaxPasses];
  if (!passes(geom, npasses, rows, np, logn, ps, eight))
    return static_cast<int>(cudaErrorInvalidConfiguration);
  cudaError_t err = cudaSuccess;
  for (int i = 0; i < npasses && err == cudaSuccess; ++i) {
    const int w = Fwd ? i : npasses - 1 - i;
    ps[w].scale = !Fwd && i == npasses - 1;
    const uint32_t* src = i == 0 ? x : out;
    err = w != npasses - 1
              ? launch_pass<Fwd, true, M>(ps[w], eight[w], geom + kGeom * w,
                                          src, out, tw, tw_sh, n_inv,
                                          n_inv_sh, primes, st)
              : launch_pass<Fwd, false, M>(ps[w], eight[w], geom + kGeom * w,
                                           src, out, tw, tw_sh, n_inv,
                                           n_inv_sh, primes, st);
  }
  return static_cast<int>(err);
}

}  // namespace

// x, out: (rows, 2^logn); psi, psi_sh: (np, 2^logn); primes: (np,);
// rows a multiple of np (row r takes twiddle row r mod np); 1 ≤ logn ≤ 30;
// geom: npasses × kGeom ints from ntt_geometry.
extern "C" int ntt_forward_launch(const uint32_t* x, const uint32_t* psi,
                                  const uint32_t* psi_sh,
                                  const uint32_t* primes, uint32_t* out,
                                  int rows, int np, int logn, int modified,
                                  int npasses, const int* geom,
                                  void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  return modified
             ? transform<true, true>(x, psi, psi_sh, nullptr, nullptr, primes,
                                     out, rows, np, logn, npasses, geom, st)
             : transform<true, false>(x, psi, psi_sh, nullptr, nullptr,
                                      primes, out, rows, np, logn, npasses,
                                      geom, st);
}

// x, out: (rows, 2^logn); ipsi, ipsi_sh: (np, 2^logn); n_inv, n_inv_sh,
// primes: (np,); rows a multiple of np; geom as for the forward transform
// (the inverse runs its passes in reverse).
extern "C" int ntt_inverse_launch(const uint32_t* x, const uint32_t* ipsi,
                                  const uint32_t* ipsi_sh,
                                  const uint32_t* n_inv,
                                  const uint32_t* n_inv_sh,
                                  const uint32_t* primes, uint32_t* out,
                                  int rows, int np, int logn, int modified,
                                  int npasses, const int* geom,
                                  void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  return modified
             ? transform<false, true>(x, ipsi, ipsi_sh, n_inv, n_inv_sh,
                                      primes, out, rows, np, logn, npasses,
                                      geom, st)
             : transform<false, false>(x, ipsi, ipsi_sh, n_inv, n_inv_sh,
                                       primes, out, rows, np, logn, npasses,
                                       geom, st);
}
