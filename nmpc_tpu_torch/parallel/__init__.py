from nmpc_tpu_torch.parallel.batch import batch_ocp, random_starts  # noqa: F401
