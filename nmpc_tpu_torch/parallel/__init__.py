from nmpc_tpu_torch.parallel.batch import batch_ocp, batched_solve, random_starts  # noqa: F401
from nmpc_tpu_torch.parallel.decentralized import (  # noqa: F401
    decentralized_closed_loop,
    decentralized_step,
    robot_template,
)
from nmpc_tpu_torch.parallel.consensus import consensus_closed_loop, consensus_solve  # noqa: F401
