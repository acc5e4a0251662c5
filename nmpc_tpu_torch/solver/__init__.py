from nmpc_tpu_torch.solver.alilqr import (  # noqa: F401
    ALILQRConfig,
    SolveResult,
    WarmStart,
    cold_start,
    solve,
    warm_from_numpy,
)
from nmpc_tpu_torch.solver.alilqr_batched import solve_batched, solve_one  # noqa: F401
from nmpc_tpu_torch.solver.gn import GNConfig  # noqa: F401
from nmpc_tpu_torch.solver.gn import solve as gn_solve  # noqa: F401
from nmpc_tpu_torch.solver.gn import solve_batched as gn_solve_batched  # noqa: F401
