"""PyTorch + CUDA port of the HEAAN Demystified HE Mul pipeline.

Beside the JAX package ``repro`` (the reference), ``repro_torch`` runs the
paper's Fig. 2 HE Mul at β = 2^32 on an NVIDIA H100 through hand-written
CUDA kernels (:mod:`repro_torch.kernels`). Its modules sit at their
counterparts' paths. Entry points take ``device=`` (default ``"cuda"``) and
raise when CUDA is absent; the tests pass ``device="cpu"``, which runs the
plain torch versions of the kernels.
"""
