from nmpc_tpu_torch.mpc.driver import (  # noqa: F401
    MPCConfig,
    MPCResult,
    shift_warm,
    steady_warm,
    closed_loop,
    rt_closed_loop,
    closed_loop_waypoints,
    closed_loop_tracking,
    plan_then_replay,
)
from nmpc_tpu_torch.mpc.lidar import closed_loop_lidar  # noqa: F401
