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
the condensed GN engine at B, and the LiDAR closed loop at B=1). Each
runs on the card as `python -m nmpc_tpu_torch.tools.<name>` and refuses to
measure without one. Beside them, `sass_diff` compares the solver kernels'
machine code with another checkout's (it needs the CUDA toolkit, not a
card).
"""
