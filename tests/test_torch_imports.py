"""Import hygiene of the port: no module of nmpc_tpu_torch loads JAX or the
JAX package, and importing builds nothing (no kernel library, no native
runtime) and starts no torch.distributed world."""

import pkgutil
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def test_port_modules_import_without_jax():
    import nmpc_tpu_torch

    names = sorted(m.name for m in pkgutil.walk_packages(
        nmpc_tpu_torch.__path__, prefix="nmpc_tpu_torch."))
    assert "nmpc_tpu_torch.ops.megasolve" in names and len(names) >= 15
    assert {"nmpc_tpu_torch.tools.roofline", "nmpc_tpu_torch.tools.exp_mega_phases",
            "nmpc_tpu_torch.tools.exp_blocked_expansions", "nmpc_tpu_torch.tools.k1_launch",
            "nmpc_tpu_torch.tools.k1_phases",
            "nmpc_tpu_torch.utils.timing",
            "nmpc_tpu_torch.solver.alilqr", "nmpc_tpu_torch.parallel.batch",
            "nmpc_tpu_torch.parallel.decentralized", "nmpc_tpu_torch.parallel.consensus",
            "nmpc_tpu_torch.parallel.mesh", "nmpc_tpu_torch.parallel.dryrun",
            "nmpc_tpu_torch.sim.plant", "nmpc_tpu_torch.sim.frames", "nmpc_tpu_torch.sim.lidar",
            "nmpc_tpu_torch.mpc.driver", "nmpc_tpu_torch.tools.fleet_loop",
            "nmpc_tpu_torch.device", "nmpc_tpu_torch.solver.gn", "nmpc_tpu_torch.mpc.lidar",
            "nmpc_tpu_torch.ops.assoc_lqr", "nmpc_tpu_torch.tools.lidar_fleet",
            "nmpc_tpu_torch.solver.admm", "nmpc_tpu_torch.utils.runlog",
            "nmpc_tpu_torch.io", "nmpc_tpu_torch.io.bridge", "nmpc_tpu_torch.io.robot",
            "nmpc_tpu_torch.__main__", "nmpc_tpu_torch.bench",
            "nmpc_tpu_torch.tools.loop_suite", "nmpc_tpu_torch.tools.cl_parity",
            "nmpc_tpu_torch.tools.loop_diff"} <= set(names)
    code = (
        "import importlib, sys\n"
        f"for name in {['nmpc_tpu_torch', *names]!r}:\n"
        "    importlib.import_module(name)\n"
        "bad = sorted(m for m in sys.modules if m == 'jax' or m.startswith('jax.')\n"
        "             or m == 'nmpc_tpu' or m.startswith('nmpc_tpu.'))\n"
        "assert not bad, bad\n"
        "from nmpc_tpu_torch.ops import cuda_build\n"
        "assert not cuda_build.build_info and not cuda_build.k3_shape_build_info\n"
        "from nmpc_tpu_torch.io import bridge\n"
        "assert bridge._lib is None\n"
        "import torch.distributed as dist\n"
        "assert not dist.is_initialized()\n"
    )
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr


def test_precision_pins():
    import torch

    import nmpc_tpu_torch  # noqa: F401

    assert torch.backends.cuda.matmul.allow_tf32 is False
    assert torch.backends.cudnn.allow_tf32 is False
    assert torch.get_float32_matmul_precision() == "highest"
