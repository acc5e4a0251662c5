from nmpc_tpu_torch.ops.megasolve import (  # noqa: F401
    al_update_lanes,
    al_update_plain,
    cuda_unsupported,
    inner_solve_fused,
    inner_solve_plain,
    mega_fits,
)
