"""Python-int ↔ limb-array conversions (exact oracles for tests & I/O).

BigInts are stored little-endian as fixed-width limb arrays. These helpers
are host-side (numpy) and exact; the torch code paths are validated against
them. The conversions go through ``int.to_bytes``/``int.from_bytes``, so a
(65536, 38) array converts in a fraction of a second.
"""

from __future__ import annotations

from typing import Iterable, List, Sequence

import numpy as np


def _dtype_for_beta(beta_bits: int):
    if beta_bits == 32:
        return np.dtype("<u4")
    if beta_bits == 64:
        return np.dtype("<u8")
    raise ValueError(f"unsupported beta_bits={beta_bits}")


def int_to_limbs(x: int, n_limbs: int, beta_bits: int) -> np.ndarray:
    """Non-negative python int -> little-endian limb vector (n_limbs,)."""
    assert x >= 0, "use centered/two's-complement encoding upstream"
    dt = _dtype_for_beta(beta_bits)
    try:
        raw = x.to_bytes(n_limbs * dt.itemsize, "little")
    except OverflowError:
        raise OverflowError("value does not fit in n_limbs") from None
    return np.frombuffer(raw, dtype=dt).copy()


def limbs_to_int(limbs: Sequence[int] | np.ndarray, beta_bits: int) -> int:
    """Little-endian limb vector -> python int."""
    dt = _dtype_for_beta(beta_bits)
    return int.from_bytes(np.asarray(limbs, dtype=dt).tobytes(), "little")


def ints_to_limb_array(
    xs: Iterable[int], n_limbs: int, beta_bits: int
) -> np.ndarray:
    """List of non-negative ints -> (len(xs), n_limbs) limb matrix."""
    xs = list(xs)
    out = np.zeros((len(xs), n_limbs), dtype=_dtype_for_beta(beta_bits))
    for i, x in enumerate(xs):
        out[i] = int_to_limbs(x, n_limbs, beta_bits)
    return out


def limb_array_to_ints(arr: np.ndarray, beta_bits: int) -> List[int]:
    """(M, n_limbs) limb matrix -> list of python ints."""
    return [limbs_to_int(row, beta_bits) for row in np.asarray(arr)]


def signed_to_mod_q(x: int, q: int) -> int:
    """Center-lift inverse: signed int -> representative in [0, q)."""
    return x % q


def mod_q_to_signed(x: int, q: int) -> int:
    """Representative in [0, q) -> centered signed value in [-q/2, q/2)."""
    return x - q if x >= q // 2 else x
