from nmpc_tpu_torch.parallel.batch import batch_ocp, batched_solve, random_starts  # noqa: F401
