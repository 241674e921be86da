"""Plain reference of HEAAN's HE Mul and slot rotation, for the benchmark.

It works the exact integer results out again from the benchmark's own
inputs: ciphertexts (ax, bx) mod q = 2^logq and key-switching keys
(ax, bx) mod Q² = 2^(2·logQ), all given as little-endian words of β bits
(int32 or int64 bit patterns). It imports nothing of the measured program
and shares none of its tables: its primes, transforms and reconstruction
are its own.

The semantics (HEAAN, with q and Q powers of two):

  he_mul:  d0 = b1·b2,  d1 = a1·b2 + a2·b1,  d2 = a1·a2 mod q
           ks_x = round(d2 · evk_x / Q)                    (x = ax, bx)
           out = (d1 + ks_ax mod q,  d0 + ks_bx mod q)
  rotate:  σ_k: coefficient i goes to i·k mod 2N, negated past N
           ks_x = round(σ_k(a) · rk_x / Q)
           out = (ks_ax mod q,  σ_k(b) + ks_bx mod q)

with every product negacyclic in Z[X]/(X^N + 1) over the integers and
round(x / Q) = floor((x + Q/2) / Q).

Method: each product is taken exactly at enough 31-bit NTT primes
(p ≡ 1 mod 2N, their product above twice the largest |coefficient|),
shifted by a power-of-two offset so that it is non-negative, brought
back by Garner's mixed-radix conversion, and summed into 16-bit digits by
a float64 matrix product whose every partial sum is an integer below
2^53 (so exact), then carried. Plain torch on any device; items are
processed in chunks so that the peak stays a few GB at N = 2^16.

`short` (Ring's argument) takes that many primes off every product: the
control of the benchmark's check, an RNS one word short of the bound.
"""

from __future__ import annotations

import math

import torch

DIGIT_BITS = 16
_MR_BASES = (2, 3, 5, 7, 11, 13, 17, 19, 23, 29, 31, 37)


def _is_prime(n: int) -> bool:
    """Deterministic Miller–Rabin (exact below 3.3·10^24)."""
    if n < 2:
        return False
    for b in _MR_BASES:
        if n % b == 0:
            return n == b
    d, s = n - 1, 0
    while d % 2 == 0:
        d //= 2
        s += 1
    for b in _MR_BASES:
        x = pow(b, d, n)
        if x in (1, n - 1):
            continue
        for _ in range(s - 1):
            x = x * x % n
            if x == n - 1:
                break
        else:
            return False
    return True


def _prime_factors(n: int) -> list:
    out, f = [], 2
    while f * f <= n:
        if n % f == 0:
            out.append(f)
            while n % f == 0:
                n //= f
        f += 1
    if n > 1:
        out.append(n)
    return out


def ntt_primes(N: int, count: int) -> list:
    """The `count` largest primes p < 2^31 with p ≡ 1 mod 2N."""
    step = 2 * N
    p = ((1 << 31) - 1) // step * step + 1
    out = []
    while len(out) < count:
        if p < (1 << 30):
            raise ValueError(f"fewer than {count} NTT primes in (2^30, 2^31)")
        if _is_prime(p):
            out.append(p)
        p -= step
    return out


def _root_2n(p: int, N: int) -> int:
    """A primitive 2N-th root of unity mod p."""
    fs = _prime_factors(p - 1)
    g = 2
    while any(pow(g, (p - 1) // f, p) == 1 for f in fs):
        g += 1
    return pow(g, (p - 1) // (2 * N), p)


def _powers(base: list, count: int, p: torch.Tensor) -> torch.Tensor:
    """(n, count) int64: base_i^k mod p_i for k < count, by doubling."""
    n = len(base)
    out = torch.ones((n, count), dtype=torch.int64, device=p.device)
    span, b = 1, list(base)
    while span < count:
        mult = torch.tensor(b, dtype=torch.int64, device=p.device)[:, None]
        w = min(span, count - span)
        out[:, span:span + w] = out[:, :w] * mult % p
        b = [x * x % int(q) for x, q in zip(b, p[:, 0].tolist())]
        span *= 2
    return out


# --------------------------------------------------------------------------
# words <-> 16-bit digits
# --------------------------------------------------------------------------

def digits(words: torch.Tensor, bits: int) -> torch.Tensor:
    """(..., N, K) words of β = 32 (int32) or 64 (int64) bits ->
    (..., N, ceil(bits/16)) int64 digits of the value mod 2^bits."""
    w = words.to(torch.int64)
    if words.dtype == torch.int32:
        w = w & 0xFFFFFFFF
        parts = [w & 0xFFFF, w >> 16]
    elif words.dtype == torch.int64:
        parts = [(w >> (16 * i)) & 0xFFFF for i in range(4)]
    else:
        raise TypeError(f"words must be int32 or int64, got {words.dtype}")
    d = torch.stack(parts, -1).reshape(*w.shape[:-1], -1)
    return mask(_fit(d, -(-bits // DIGIT_BITS)), bits)


def _fit(d: torch.Tensor, D: int) -> torch.Tensor:
    """`d` cut or zero-padded to D digits."""
    if d.shape[-1] >= D:
        return d[..., :D].contiguous()
    pad = d.new_zeros(*d.shape[:-1], D - d.shape[-1])
    return torch.cat([d, pad], -1)


def mask(d: torch.Tensor, bits: int) -> torch.Tensor:
    """Digits of the value mod 2^bits (same number of digits)."""
    full, r = divmod(bits, DIGIT_BITS)
    out = d.clone()
    if r:
        out[..., full] &= (1 << r) - 1
        full += 1
    out[..., full:] = 0
    return out


def words_of(d: torch.Tensor, beta: int, K: int) -> torch.Tensor:
    """(..., N, D) digits -> (..., N, K) words of β bits as int32/int64."""
    per = beta // DIGIT_BITS
    d = _fit(d, K * per).reshape(*d.shape[:-1], K, per)
    acc = torch.zeros(d.shape[:-1], dtype=torch.int64, device=d.device)
    for i in range(per):
        acc |= d[..., i] << (16 * i)
    if beta == 32:
        return torch.where(acc >= 1 << 31, acc - (1 << 32), acc).to(
            torch.int32)
    return acc


def carry(acc: torch.Tensor) -> torch.Tensor:
    """Non-negative int64 digit sums (..., D) -> 16-bit digits of their
    value mod 2^(16·D)."""
    cols = acc.movedim(-1, 0).contiguous()
    c = torch.zeros_like(cols[0])
    for i in range(cols.shape[0]):
        cols[i] += c
        c = cols[i] >> 16
        cols[i] &= 0xFFFF
    return cols.movedim(0, -1).contiguous()


def const_digits(value: int, D: int, device) -> torch.Tensor:
    """A Python int mod 2^(16·D) as D int64 digits."""
    value %= 1 << (DIGIT_BITS * D)
    return torch.tensor([(value >> (16 * i)) & 0xFFFF for i in range(D)],
                        dtype=torch.int64, device=device)


def add_mod(a: torch.Tensor, b: torch.Tensor, bits: int) -> torch.Tensor:
    """(a + b) mod 2^bits on digit arrays of equal width."""
    return mask(carry(a + b), bits)


def neg_mod(a: torch.Tensor, bits: int) -> torch.Tensor:
    """(−a) mod 2^bits on digits."""
    one = const_digits(1, a.shape[-1], a.device)
    return mask(carry((0xFFFF - a) + one), bits)


def shift_right(d: torch.Tensor, s: int) -> torch.Tensor:
    """floor(value / 2^s) on digits (the top digits fill with zeros)."""
    q, r = divmod(s, DIGIT_BITS)
    hi = torch.cat([d[..., q:], d.new_zeros(*d.shape[:-1], q)], -1)
    if not r:
        return hi
    nxt = torch.cat([hi[..., 1:], hi.new_zeros(*hi.shape[:-1], 1)], -1)
    return (hi >> r) | ((nxt << (DIGIT_BITS - r)) & 0xFFFF)


# --------------------------------------------------------------------------
# the ring
# --------------------------------------------------------------------------

class Ring:
    """Exact negacyclic products in Z[X]/(X^N + 1) on `device`.

    `max_bits`: the largest product bound (bits) the ring must cover.
    `short`: primes taken off every product (the control)."""

    def __init__(self, N: int, device, max_bits: int, short: int = 0):
        self.N = N
        self.logN = N.bit_length() - 1
        self.device = torch.device(device)
        self.short = short
        count = max_bits // 30 + 2
        primes = ntt_primes(N, count)
        self.primes = primes
        self._log_prefix = [0.0]
        for p in primes:
            self._log_prefix.append(self._log_prefix[-1] + math.log2(p))
        dev = self.device
        self.p = torch.tensor(primes, dtype=torch.int64, device=dev)[:, None]
        psi = [_root_2n(p, N) for p in primes]
        ipsi = [pow(x, -1, p) for x, p in zip(psi, primes)]
        self.psi_pow = _powers(psi, N, self.p)
        n_inv = torch.tensor([pow(N, -1, p) for p in primes],
                             dtype=torch.int64, device=dev)[:, None]
        self.ipsi_ninv = _powers(ipsi, N, self.p) * n_inv % self.p
        omega = [x * x % p for x, p in zip(psi, primes)]
        iomega = [x * x % p for x, p in zip(ipsi, primes)]
        self.w = _powers(omega, N // 2, self.p)
        self.winv = _powers(iomega, N // 2, self.p)
        self._garner = {}
        self._crt = {}

    def count(self, bits: float) -> int:
        """Primes whose product exceeds 2^bits, less `short`."""
        for n, lg in enumerate(self._log_prefix):
            if lg > bits:
                return n - self.short
        raise ValueError(f"the ring covers {self._log_prefix[-1]:.0f} bits,"
                         f" not {bits}")

    # ---- limbs -> residues -> eval domain --------------------------------

    def _crt_consts(self, D: int, n: int):
        key = (D, n)
        if key not in self._crt:
            c = [[pow(2, 16 * d, p) for p in self.primes[:n]]
                 for d in range(D)]
            t = torch.tensor(c, dtype=torch.int64)
            self._crt[key] = ((t & 0xFFFF).double().to(self.device),
                              (t >> 16).double().to(self.device))
        return self._crt[key]

    def residues(self, d: torch.Tensor, n: int) -> torch.Tensor:
        """Digits (..., N, D) -> residues (..., n, N) of the value."""
        lo, hi = self._crt_consts(d.shape[-1], n)
        x = d.double()
        p = self.p[:n, 0]
        s_lo = (x @ lo).long()
        s_hi = (x @ hi).long() % p
        return ((s_lo + s_hi * 65536) % p).movedim(-1, -2).contiguous()

    def ntt(self, x: torch.Tensor) -> torch.Tensor:
        """Negacyclic forward transform of residues (..., n, N); the output
        is in bit-reversed order (Gentleman–Sande)."""
        n, N = x.shape[-2], self.N
        p = self.p[:n, :, None]
        lead = x.shape[:-2]
        x = x * self.psi_pow[:n] % self.p[:n]
        m = N
        while m >= 2:
            h = m // 2
            v = x.reshape(*lead, n, N // m, 2, h)
            a, b = v[..., 0, :], v[..., 1, :]
            w = self.w[:n, ::N // m][:, None, :h]
            x = torch.stack(((a + b) % p, (a - b) % p * w % p), -2).reshape(
                *lead, n, N)
            m = h
        return x

    def intt(self, x: torch.Tensor) -> torch.Tensor:
        """Inverse of :meth:`ntt` (bit-reversed in, natural out)."""
        n, N = x.shape[-2], self.N
        p = self.p[:n, :, None]
        lead = x.shape[:-2]
        m = 2
        while m <= N:
            h = m // 2
            v = x.reshape(*lead, n, N // m, 2, h)
            w = self.winv[:n, ::N // m][:, None, :h]
            a, b = v[..., 0, :], v[..., 1, :] * w % p
            x = torch.stack(((a + b) % p, (a - b) % p), -2).reshape(
                *lead, n, N)
            m *= 2
        return x * self.ipsi_ninv[:n] % self.p[:n]

    # ---- residues -> digits ----------------------------------------------

    def _garner_consts(self, n: int, D: int):
        key = (n, D)
        if key not in self._garner:
            P = self.primes[:n]
            inv = torch.zeros((n, n), dtype=torch.int64)
            for j in range(n):
                for i in range(j + 1, n):
                    inv[j, i] = pow(P[j], -1, P[i])
            rows, prod, top = [], 1, 1 << (DIGIT_BITS * D)
            for j in range(n):
                for scale in (1, 1 << 16):
                    v = prod * scale % top
                    rows.append([(v >> (16 * d)) & 0xFFFF for d in range(D)])
                prod *= P[j]
            W = torch.tensor(rows, dtype=torch.float64)
            self._garner[key] = (inv.to(self.device), W.to(self.device))
        return self._garner[key]

    def reconstruct(self, ev: torch.Tensor, offset_bits: int, D: int,
                    add: int = 0) -> torch.Tensor:
        """Eval-domain product (..., n, N) of a signed integer polynomial
        x with |x| < 2^offset_bits -> digits (..., N, D) of (x + add)
        mod 2^(16·D). The primes' product must exceed 2^(offset_bits+1)."""
        n = ev.shape[-2]
        p = self.p[:n]
        inv, W = self._garner_consts(n, D)
        r = self.intt(ev)
        off = torch.tensor([pow(2, offset_bits, q) for q in self.primes[:n]],
                           dtype=torch.int64, device=self.device)[:, None]
        r = (r + off) % p                             # y = x + O >= 0
        lead = r.shape[:-2]
        r = r.reshape(-1, n, self.N).movedim(1, 0).reshape(n, -1)
        for j in range(n - 1):                        # mixed-radix digits
            rest = r[j + 1:]
            rest.sub_(r[j]).remainder_(p[j + 1:]).mul_(
                inv[j, j + 1:, None]).remainder_(p[j + 1:])
        v = torch.stack((r & 0xFFFF, r >> 16), 1).reshape(2 * n, -1)
        acc = (v.t().double() @ W).long()            # exact: sums < 2^53
        acc = acc + const_digits(add - (1 << offset_bits), D, self.device)
        out = carry(acc)
        return out.reshape(*lead, self.N, D)

    def mul_ev(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        return a * b % self.p[:a.shape[-2]]


# --------------------------------------------------------------------------
# the HE operations
# --------------------------------------------------------------------------

def automorphism(d: torch.Tensor, k: int, bits: int) -> torch.Tensor:
    """σ_k on digit polynomials (..., N, D) mod 2^bits."""
    N = d.shape[-2]
    idx = torch.arange(N, device=d.device) * k % (2 * N)
    neg = (idx >= N)[:, None]
    out = torch.empty_like(d)
    out[..., idx % N, :] = torch.where(neg, neg_mod(d, bits), d)
    return out


class HERef:
    """HE Mul and rotation at (N, logQ) for ciphertext words of β bits."""

    def __init__(self, N: int, logQ: int, beta: int, device,
                 short: int = 0, chunk: int = 4):
        self.N, self.logQ, self.beta = N, logQ, beta
        logN = N.bit_length() - 1
        self.ring = Ring(N, device, logN + 3 * logQ + 2, short=short)
        self.chunk = chunk
        self._keys = {}

    def _key_ev(self, key, n2: int):
        """A key's two polynomials in the eval domain at n2 primes (made
        once a key, at the most primes asked so far, and sliced)."""
        ident = (key[0].data_ptr(), key[1].data_ptr())
        have = self._keys.get(ident)
        if have is None or have[0] < n2:
            evs = tuple(self.ring.ntt(self.ring.residues(
                digits(k.to(self.ring.device), 2 * self.logQ), n2))
                for k in key)
            have = (n2, evs)
            self._keys[ident] = have
        return [e[:n2] for e in have[1]]

    def _keyswitch(self, d, key, logq: int):
        """round(d · key / Q) mod q for d (items, N, Dq) digits mod q."""
        ring, logQ = self.ring, self.logQ
        off = ring.logN + logq + 2 * logQ
        n2 = ring.count(off + 1)
        k_ax, k_bx = self._key_ev(key, n2)
        e = ring.ntt(ring.residues(d, n2))
        D2 = -(-(logQ + logq) // DIGIT_BITS)
        out = []
        for k in (k_ax, k_bx):
            full = ring.reconstruct(ring.mul_ev(e, k), off, D2,
                                    add=1 << (logQ - 1))
            out.append(mask(_fit(shift_right(full, logQ), d.shape[-1]),
                            logq))
        return out

    def _chunks(self, *xs):
        n = xs[0].shape[0]
        for s in range(0, n, self.chunk):
            yield [x[s:s + self.chunk].to(self.ring.device) for x in xs]

    def he_mul(self, ax1, bx1, ax2, bx2, evk, logq: int):
        """Word batches (B, N, K) at modulus 2^logq and an evk of
        coefficient words (N, K2) mod Q² -> (ax3, bx3) words (B, N, K)."""
        ring, K = self.ring, ax1.shape[-1]
        off = ring.logN + 2 * logq + 1
        n1 = ring.count(off + 1)
        Dq = -(-logq // DIGIT_BITS)
        outs = []
        for a1, b1, a2, b2 in self._chunks(ax1, bx1, ax2, bx2):
            A1, B1, A2, B2 = (ring.ntt(ring.residues(digits(t, logq), n1))
                              for t in (a1, b1, a2, b2))
            d0 = mask(ring.reconstruct(ring.mul_ev(B1, B2), off, Dq), logq)
            d1 = mask(ring.reconstruct(
                (ring.mul_ev(A1, B2) + ring.mul_ev(A2, B1)) % ring.p[:n1],
                off, Dq), logq)
            d2 = mask(ring.reconstruct(ring.mul_ev(A1, A2), off, Dq), logq)
            del A1, B1, A2, B2
            ks_ax, ks_bx = self._keyswitch(d2, evk, logq)
            outs.append((words_of(add_mod(d1, ks_ax, logq), self.beta, K),
                         words_of(add_mod(d0, ks_bx, logq), self.beta, K)))
        return (torch.cat([o[0] for o in outs]),
                torch.cat([o[1] for o in outs]))

    def rotate(self, ax, bx, k: int, rk, logq: int):
        """σ_k then the key switch against rk (coefficient words mod Q²)."""
        K = ax.shape[-1]
        outs = []
        for a, b in self._chunks(ax, bx):
            ar = automorphism(digits(a, logq), k, logq)
            br = automorphism(digits(b, logq), k, logq)
            ks_ax, ks_bx = self._keyswitch(ar, rk, logq)
            outs.append((words_of(ks_ax, self.beta, K),
                         words_of(add_mod(br, ks_bx, logq), self.beta, K)))
        return (torch.cat([o[0] for o in outs]),
                torch.cat([o[1] for o in outs]))
