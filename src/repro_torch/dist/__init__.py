"""The batched HE Mul, on one device or across the ranks of a grid.

  - he_pipeline: the paper's Fig. 2 two-region HE Mul over a batch of
                 ciphertext pairs as one step, bitwise identical to
                 core.heaan.he_mul item by item; its batched stages are
                 factored as make_stage_fns / make_keyswitch_step, and
                 route through the CUDA kernels with use_kernels=True,
                 across the paper's optimization ladder (CRT strategies,
                 modified Shoup). With ``grid=`` (a
                 ``launch.mesh.HostGrid`` of model size > 1) a step is one
                 rank's part: its batch rows, its prime rows, and iCRT's
                 partial sums all-reduced over the model group.
  - sharding:    the HE placement rules on a grid (data_axes,
                 he_limb_sharding, he_eval_sharding: the GSPMD split of
                 the primes) and he_expected_collectives, the reference's
                 prediction of a served op's collective schedule.
  - comm:        the collectives of the HE path, each recorded (kind,
                 bytes, ring wire bytes, seconds) in the grid's "step" or
                 "feed" log.
  - record:      ``python -m repro_torch.dist --record``: the measured
                 schedule of every served op in SHARD_MANIFEST.json's
                 schema.
"""

from repro_torch.dist import comm, he_pipeline, sharding  # noqa: F401

__all__ = ["comm", "he_pipeline", "sharding"]
