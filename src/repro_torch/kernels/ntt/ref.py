"""Plain torch versions of the NTT/iNTT kernels.

Delegates to the core transforms, as the JAX package's ref.py does; a
batch of rows (a multiple of the twiddle tables' np) is one batch
dimension of the core transform.
"""

from __future__ import annotations

from repro_torch.core.ntt import intt, ntt

__all__ = ["ntt_ref", "intt_ref"]


def ntt_ref(x, psi_rev, psi_rev_shoup, primes, *, modified: bool = False):
    npn, N = psi_rev.shape
    return ntt(x.reshape(-1, npn, N), psi_rev, psi_rev_shoup, primes,
               modified=modified).reshape(x.shape)


def intt_ref(x, ipsi_rev, ipsi_rev_shoup, n_inv, n_inv_shoup, primes, *,
             modified: bool = False):
    npn, N = ipsi_rev.shape
    return intt(x.reshape(-1, npn, N), ipsi_rev, ipsi_rev_shoup, n_inv,
                n_inv_shoup, primes, modified=modified).reshape(x.shape)
