"""Number-theory substrate: primes, roots of unity, python-int oracles."""

from repro_torch.nt.primes import (
    is_prime,
    find_ntt_primes,
    primitive_2nth_root,
    bit_reverse_indices,
)
from repro_torch.nt.residue import (
    int_to_limbs,
    limbs_to_int,
    ints_to_limb_array,
    limb_array_to_ints,
)

__all__ = [
    "is_prime",
    "find_ntt_primes",
    "primitive_2nth_root",
    "bit_reverse_indices",
    "int_to_limbs",
    "limbs_to_int",
    "ints_to_limb_array",
    "limb_array_to_ints",
]
