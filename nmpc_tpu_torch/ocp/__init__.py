from nmpc_tpu_torch.ocp.problem import (  # noqa: F401
    OCP,
    default_weights,
    num_pairs,
    stage_cost,
    stage_constraints,
    pairwise_sq_distances,
    al_penalty,
    rollout,
    ocp_from_numpy,
)
