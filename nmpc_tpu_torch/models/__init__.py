from nmpc_tpu_torch.models.unicycle import (  # noqa: F401
    unicycle_rhs,
    stacked_unicycle_rhs,
    euler_step,
    rk4_step,
    discrete_dynamics,
    euler_jacobians,
)
