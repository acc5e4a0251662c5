from nmpc_tpu_torch.scenarios.registry import REGISTRY, Scenario, get  # noqa: F401
