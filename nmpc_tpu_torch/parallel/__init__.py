from nmpc_tpu_torch.parallel.mesh import (  # noqa: F401
    batch_sharding,
    data_mesh,
    gather_rows,
    init_world,
    replicated,
    shard_rows,
)
from nmpc_tpu_torch.parallel.batch import (  # noqa: F401
    batch_ocp,
    batched_solve,
    random_starts,
    shard_ocp_batch,
)
from nmpc_tpu_torch.parallel.decentralized import (  # noqa: F401
    decentralized_closed_loop,
    decentralized_step,
    decentralized_step_sharded,
    robot_template,
)
from nmpc_tpu_torch.parallel.consensus import (  # noqa: F401
    consensus_closed_loop,
    consensus_solve,
    consensus_solve_sharded,
)
