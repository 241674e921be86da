"""Hand-written CUDA kernels (sm_90a) for the HE Mul hot spots.

One package per kernel of the JAX package's Pallas set, each with ops.py
(the wrapper: checks, allocation, launch, launch count) and ref.py (the
plain torch version). The CUDA sources live in csrc/, one per kernel
family; kernels/common.py builds them into one library at first use.

  modmul/  pointwise Montgomery products (csrc/modmul.cu)
  ntt/     forward and inverse negacyclic NTT (csrc/ntt.cu)
  crt/     limbs -> residues with 3-word accumulation (csrc/crt.cu)
  icrt/    residues -> centered limbs, loop-reordered Algo 6 with the
           quotient correction and center-lift folded in (csrc/icrt.cu)
  carry/   the BigInt carry chains over the limb axis: the ÷Q rounding
           shift and the combine's add and mask (csrc/carry.cu; no Pallas
           kernel of the JAX package computes them)

A wrapper given CPU tensors runs the plain version; given CUDA tensors it
launches the kernel or raises.
"""
