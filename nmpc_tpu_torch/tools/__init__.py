"""The port's roofline tools, counterparts of the JAX package's tools/roofline.py,
tools/exp_mega_phases.py and tools/exp_blocked_expansions.py, each with its
hand-written CUDA kernel (csrc/tools.cu) and the kernel's plain PyTorch
version:

    roofline                the FMA-peak probe (K7), the work model of every
                            kernel and the bench shape's achieved rate
    exp_mega_phases         K1 with one phase ablated at a fixed count (K8)
    exp_blocked_expansions  K1 with the structured or the dense expansion
                            layout at a fixed count (K9)

and the closed-loop fleet (`fleet_loop`, the port of
tools/bench_fleet_loop.py: a B-wide warm MPC loop through K1 and K2), the
lidar_v4 fleet and tour (`lidar_fleet`, the port of tools/bench_lidar.py:
the condensed GN engine at B, and the LiDAR closed loop at B=1), the
reference's user models on the generic-dynamics hook (`user_models`: the
Van der Pol and first-order process fleets through K3 at their stage
shapes) and the ADMM fleet (`admm_fleet`, the port of tools/bench_admm.py).
The reference's other measurement tools: `latency` (tools/gen_latency.py:
per-step latency, the MPC chunk as one CUDA graph), `ten_robot`
(bench_ten_robot.py), `gate_check`, `parity` (gen_parity.py, against the
f64 oracle), `sweep` (bench_sweep.py), `decentralized`
(bench_decentralized.py), `ls_ab` (bench_ls.py), `iteration_levers`
(exp_iteration_levers.py), `profile_solve`, `roofline_gn` and
`rt_drift_experiment` (the CPU by default, as the reference's). Each runs
on the card as `python -m nmpc_tpu_torch.tools.<name>` and refuses to
measure without one; the reference's tools also take `--device cpu`.
Beside them, `sass_diff` compares the solver kernels' machine code with
another checkout's (it needs the CUDA toolkit, not a card).
"""
