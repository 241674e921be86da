"""Stages 2 & 4: CoeffToSlot / SlotToCoeff as BSGS linear transforms.

Both stages are the same object: a dense n×n complex matrix applied
homomorphically to the slot vector, built from rotate + mul_plain + add
(one multiplicative level). The matrices come straight from the
encoding (`core.encoding.emb` / `emb_inv`, HEAAN's rot-group special
FFT), evaluated on unit vectors — so the homomorphic transform and the
client-side codec can never disagree about slot layout:

  - a FULL-slot ciphertext (n = N/2, gap = 1) decodes to
    w = emb(u) where u_i = (t_i + i·t_{N/2+i}) / Δ pairs up ALL N
    polynomial coefficients as n complex values;
  - CoeffToSlot is therefore emb⁻¹ as a matrix (slots become u — the
    raw coefficients), and SlotToCoeff is emb (u back to slot view).

Full slots are REQUIRED: with n < N/2 the gap coefficients are
invisible to decode but NOT to ring multiplication, so the q·I(X) junk
mod-raise leaves there would poison every post-bootstrap mul. The
pipeline rejects sparse ciphertexts up front.

The baby-step/giant-step split evaluates M·w = Σ_j rot_{j·g}(Σ_i
rot_{-j·g}(diag_{j·g+i}) ⊙ rot_i(w)) with g ≈ √n babies — O(√n)
rotations instead of n, all through resident rotation keys, and every
pre-rotated diagonal is a plain operand that lands in the server's
(hash, level) cache: repeat bootstraps ship the whole DFT hash-only.

The matrices are the JAX package's element for element (the same numpy
`emb`/`emb_inv`), so every diagonal's `message_hash` — the plaintext
cache's key — is the reference's too.
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np

from repro_torch.core.encoding import emb, emb_inv

__all__ = ["coeff_to_slot_matrix", "slot_to_coeff_matrix", "bsgs_matvec",
           "default_giant_step"]


@lru_cache(maxsize=8)
def slot_to_coeff_matrix(n: int, N: int) -> np.ndarray:
    """emb as an n×n matrix (decode direction): w = E·u."""
    E = np.empty((n, n), dtype=np.complex128)
    for j in range(n):
        e = np.zeros(n, dtype=np.complex128)
        e[j] = 1.0
        E[:, j] = emb(e, 2 * N)
    return E


@lru_cache(maxsize=8)
def coeff_to_slot_matrix(n: int, N: int) -> np.ndarray:
    """emb⁻¹ as an n×n matrix (encode direction): u = E⁻¹·w."""
    Ei = np.empty((n, n), dtype=np.complex128)
    for j in range(n):
        e = np.zeros(n, dtype=np.complex128)
        e[j] = 1.0
        Ei[:, j] = emb_inv(e, 2 * N)
    return Ei


def default_giant_step(n: int) -> int:
    """Baby-step count g ≈ √n, rounded to a power of two so the giant
    rotations j·g stay few and key-shareable across stages."""
    g = 1
    while g * g < n:
        g <<= 1
    return g


def bsgs_matvec(x, M: np.ndarray, *, giant_step: int = 0,
                tol: float = 1e-12):
    """Apply a dense complex matrix to a traced slot vector.

    x: `repro_torch.client.handles.CipherHandle` with n slots.
    M: (n, n) complex matrix.
    giant_step: baby-step count g (0 → :func:`default_giant_step`).
    tol: diagonals with max |entry| below this are skipped.

    Costs one multiplicative level (every term is one mul_plain, auto-
    rescaled by the compile pass) and {1..g−1} ∪ {g, 2g, ...} rotation
    keys. Returns the traced result handle.
    """
    M = np.asarray(M, dtype=np.complex128)
    n = M.shape[0]
    if M.shape != (n, n) or n != x.n_slots:
        raise ValueError(f"matrix {M.shape} does not match the "
                         f"handle's {x.n_slots} slots")
    g = giant_step or default_giant_step(n)
    idx = np.arange(n)
    babies = {0: x}
    out = None
    for j in range((n + g - 1) // g):
        inner = None
        for i in range(g):
            k = j * g + i
            if k >= n:
                break
            d = M[idx, (idx + k) % n]            # k-th diagonal
            if not np.any(np.abs(d) > tol):
                continue
            if i not in babies:
                babies[i] = x.rotate(i)
            # pre-rotate the diagonal by the giant step so one rotation
            # of the inner sum restores alignment: rot_{-jg}(d)
            term = babies[i] * np.roll(d, j * g)
            inner = term if inner is None else inner + term
        if inner is None:
            continue
        if j:
            inner = inner.rotate(j * g)
        out = inner if out is None else out + inner
    if out is None:
        raise ValueError("matrix is numerically zero")
    return out
