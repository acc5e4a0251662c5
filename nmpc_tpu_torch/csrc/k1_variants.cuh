// What K1 (megasolve.cu) and the roofline tools' variants of it (tools.cu:
// the phase ablation K8 and the expansion-layout A/B K9) share: which
// phases a variant runs, and K1's launch geometry, so that the variants of
// K1's warp design launch at K1's exact geometry.
#pragma once

namespace nmpc {

// Which phases of the inner solve run. K1 is `full` with the early exit;
// the other values are the phase ablations of csrc/tools.cu (K8, port of
// tools/exp_mega_phases.py), which run a fixed iteration count:
//   inv_solve   gains through the explicit L^-1, alpha = 1
//   no_ls       no candidate rollouts: alpha = 1
//   no_solve    diagonal gains -Qu / (Quu_ii + reg), alpha = 1
//   no_expcon   LQR-only expansions (no constraint rows, box rows included),
//               alpha = 1
//   sweep_only  no merit, no rollouts: X and U never change
// Every mode but `full` and `sweep_only` keeps the initial merit as its
// cost (the reference ablation's semantics: only `full` line-searches);
// sweep_only's cost is 0. Both designs take the flag: the first
// (megasolve.cuh::inner_solve_thread) and the warp design
// (inner_warp.cuh::inner_solve_warp).
enum class Phase : int { full = 0, inv_solve, no_ls, no_solve, no_expcon, sweep_only };

constexpr int kMaxWarps = 4;   // K1: scenarios (warps) per block, at most
// K1's register cap, as the blocks of kMaxWarps warps per SM that the
// registers must allow (65,536 / (128 x this) registers a thread): more
// resident warps hide more of a scenario's serial latency, until the spills
// cost more. Picked per m by `python -m nmpc_tpu_torch.tools.k1_launch`
// (PERF.md: the fastest at K1_WARPS = 2 warps a block; where two caps tie,
// as at m = 9 and 11, the one that leaves more warps resident);
// -DNMPC_K1_MIN_BLOCKS=<c> overrides it for that sweep only.
#ifdef NMPC_K1_MIN_BLOCKS
template <int NR>
constexpr int kK1MinBlocks = NMPC_K1_MIN_BLOCKS;
#else
template <int NR>
constexpr int kK1MinBlocks =
    NR <= 2 ? 8 : NR == 3 ? 6 : NR <= 7 ? 5 : NR <= 9 || NR == 11 || NR == 13 ? 4 : 1;
#endif

}  // namespace nmpc
