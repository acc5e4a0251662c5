from nmpc_tpu_torch.sim.plant import PlantConfig, plant_from_numpy, plant_step  # noqa: F401
from nmpc_tpu_torch.sim.frames import se2_local_to_global, se2_global_to_local, yaw_from_quat_z  # noqa: F401
