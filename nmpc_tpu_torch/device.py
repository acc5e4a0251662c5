"""The port's one default device.

Every builder of the package (`Scenario.make`, `make_ocp`, `make_generic_ocp`,
`build_ltv_mpc_qp`, `load_warm`, `default_weights`, `ocp_from_numpy`,
`warm_from_numpy`) puts its tensors on `DEVICE` unless the
caller passes another one, so a problem built without a `device=` argument
runs the hand-written CUDA kernels. Nothing probes for a card: without one,
such a call fails with torch's own error. The CPU (where the kernel wrappers
run their plain PyTorch versions) is taken only when asked for, as the CPU
tests do with `device="cpu"`.
"""

import torch

DEVICE = torch.device("cuda")
