// CUDA kernels K1 (fused inner iLQR solve) and K2 (AL multiplier update) of
// the batched AL-iLQR main path, with a plain C interface for ctypes.
//
// Built once per robot count by nmpc_tpu_torch/ops/cuda_build.py:
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC -DNMPC_NR=<m> -o libnmpc_m<m>.so megasolve.cu
// No --use_fast_math: headings are unbounded (theta_bound 1e9) and the fast
// sine and cosine lose accuracy away from 0.
//
// Replaces nmpc_tpu/ops/megasolve_pallas.py::inner_solve_fused (K1) and
// ::al_update_lanes (K2). The TPU megakernel keeps a 128-scenario tile's
// whole solve in VMEM; here one warp runs one scenario, with the stage-local
// blocks in a per-warp slot of shared memory and the N-proportional arrays
// in device memory in the standard layout [B, N, ...] (csrc/inner_warp.cuh,
// whose note says what bounds the design and what it does about it). The
// first design, one thread per scenario on the lane-major layout
// (csrc/megasolve.cuh::inner_solve_thread), is built only by the roofline
// tools (csrc/tools.cu), as K1's A/B baseline.
//
// Each kernel has two instantiations: pair and box rows only (kObs false,
// the main path's), and the obstacle variant (kObs true: static- and
// moving-obstacle rows too), launched when n_obs + n_mov > 0.
//
// At m <= 2 the library also holds K1's team design (csrc/inner_team.cuh: a
// team of T lanes per scenario, the line-search candidates side by side),
// launched by nmpc_inner_solve_team; the solver runs it at those m, and the
// warp design stays reachable through nmpc_inner_solve for the A/B. Builds
// for m >= 3 do not include it.

#include <cuda_runtime.h>

#include "inner_warp.cuh"
#if NMPC_NR <= 2
#include "inner_team.cuh"
#endif

#ifndef NMPC_NR
#error "compile with -DNMPC_NR=<robot count>"
#endif

namespace nmpc {

constexpr int kAlWarps = 8;    // K2: scenarios (warps) per block
// kMaxWarps and K1's register cap kK1MinBlocks: csrc/k1_variants.cuh

// dynamic shared memory: one slot a warp, then the parameter block (any
// number of alphas). The slots keep the address they had when the parameter
// block was a static array of at most 32 alphas: with the block in front of
// them K1 ran slower on an H100 (timed in turns)
// (the obstacle variant's obstacle entries sit between the pair parameters
// and the alphas, as in the parameter block)
template <int NR, bool kObs>
__global__ void __launch_bounds__(kMaxWarps * kWarp, kK1MinBlocks<NR>) inner_solve_kernel(WarpArgs a) {
  extern __shared__ float4 k1_smem[];  // 16-byte aligned: the slots' vector loads
  float* slots = reinterpret_cast<float*>(k1_smem);
  float* sp = slots + (blockDim.x / kWarp) * a.slot_floats;
  const int n_prm = Dims<NR>::alphas + (kObs ? 3 * a.n_obs : 0) + a.n_alphas;
  for (int i = threadIdx.x; i < n_prm; i += blockDim.x) sp[i] = a.prm[i];
  __syncthreads();
  const int warp = threadIdx.x / kWarp;
  const int b = blockIdx.x * (blockDim.x / kWarp) + warp;
  if (b < a.B)
    inner_solve_warp<NR, kObs>(a, sp, slots + warp * a.slot_floats, b, threadIdx.x % kWarp);
}

// the pair parameters in static shared memory; the obstacle variant's block
// (with its 3 n_obs obstacle entries) in dynamic shared memory
template <int NR, bool kObs>
__global__ void __launch_bounds__(kAlWarps * kWarp) al_update_kernel(ALArgs a) {
  if constexpr (kObs) {
    extern __shared__ float k2_smem[];
    for (int i = threadIdx.x; i < Dims<NR>::alphas + 3 * a.n_obs; i += blockDim.x)
      k2_smem[i] = a.prm[i];
    __syncthreads();
    const int b = blockIdx.x * kAlWarps + threadIdx.x / kWarp;
    if (b < a.B) al_update_warp<NR, true>(a, k2_smem, b, threadIdx.x % kWarp);
  } else {
    __shared__ float sp[Dims<NR>::alphas];
    for (int i = threadIdx.x; i < Dims<NR>::alphas; i += blockDim.x) sp[i] = a.prm[i];
    __syncthreads();
    const int b = blockIdx.x * kAlWarps + threadIdx.x / kWarp;
    if (b < a.B) al_update_warp<NR, false>(a, sp, b, threadIdx.x % kWarp);
  }
}

// K1's launch: dynamic shared memory of `warps` slots and the parameter
// block, opted in above 48 KB. Returns the CUDA error of the launch.
template <bool kObs>
int launch_inner(const WarpArgs& a, int warps, void* stream) {
  const int smem = warps * 4 * a.slot_floats
      + 4 * (Dims<NMPC_NR>::alphas + 3 * a.n_obs + a.n_alphas);
  if (smem > 48 * 1024) {  // above 48 KB only by opting in
    const cudaError_t err = cudaFuncSetAttribute(
        inner_solve_kernel<NMPC_NR, kObs>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const int grid = (a.B + warps - 1) / warps;
  inner_solve_kernel<NMPC_NR, kObs><<<grid, warps * kWarp, smem,
                                      static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}

#if NMPC_NR <= 2
// The team design's register cap, as the blocks of kMaxWarps warps per SM
// that the registers must allow; picked with tools/k1_launch.py (PERF.md),
// -DNMPC_K1_TEAM_MIN_BLOCKS=<c> overrides it for that sweep only.
#ifndef NMPC_K1_TEAM_MIN_BLOCKS
#define NMPC_K1_TEAM_MIN_BLOCKS 4
#endif
constexpr int kTeamMinBlocks = NMPC_K1_TEAM_MIN_BLOCKS;

// K1's team design: 32 / kTeam teams a warp, each team's ring of stage
// slots (a.slot_floats floats apart) in dynamic shared memory, then the
// parameter block.
template <int NR, bool kObs>
__global__ void __launch_bounds__(kMaxWarps * kWarp, kTeamMinBlocks) inner_team_kernel(WarpArgs a) {
  extern __shared__ float4 k1_smem[];
  float* rings = reinterpret_cast<float*>(k1_smem);
  const int teams = blockDim.x / kTeam;
  float* sp = rings + teams * a.slot_floats;
  const int n_prm = Dims<NR>::alphas + (kObs ? 3 * a.n_obs : 0) + a.n_alphas;
  for (int i = threadIdx.x; i < n_prm; i += blockDim.x) sp[i] = a.prm[i];
  __syncthreads();
  const int team = threadIdx.x / kTeam, tl = threadIdx.x % kTeam;
  const int b = blockIdx.x * teams + team;
  const unsigned lanes = kTeam == 32 ? 0xffffffffu : (1u << (kTeam % 32)) - 1u;
  const unsigned mask = lanes << (threadIdx.x % kWarp / kTeam * kTeam);
  if (b < a.B) inner_solve_team<NR, kObs>(a, sp, rings + team * a.slot_floats, b, tl, mask);
}

// the team design's launch: `warps` warps a block, dynamic shared memory of
// the teams' rings and the parameter block. Returns the CUDA error.
template <bool kObs>
int launch_team(const WarpArgs& a, int warps, void* stream) {
  const int teams = warps * kWarp / kTeam;
  const int smem = teams * 4 * a.slot_floats
      + 4 * (Dims<NMPC_NR>::alphas + 3 * a.n_obs + a.n_alphas);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        inner_team_kernel<NMPC_NR, kObs>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const int grid = (a.B + teams - 1) / teams;
  inner_team_kernel<NMPC_NR, kObs><<<grid, warps * kWarp, smem,
                                     static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}
#endif

}  // namespace nmpc

extern "C" {

int nmpc_robots() { return NMPC_NR; }

const char* nmpc_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// Shared bytes of K1's per-warp slot with `rows` = m (n_obs + n_mov)
// obstacle rows (the stage-local blocks and the stage's duals; it does not
// grow with N).
int nmpc_k1_slot_bytes(int rows) {
  return rows < 0 ? -1 : 4 * nmpc::Slot<NMPC_NR>::floats_obs(rows);
}

// K1 with `warps` scenarios per block: dynamic shared memory of a slot of
// nmpc_k1_slot_bytes(m (n_obs + n_mov)) a warp and the parameter block;
// the obstacle variant when n_obs + n_mov > 0 (mov: the schedule, read
// with mov_stride floats between scenarios). Returns the CUDA error of the
// launch (0 = launched; a refused shared-memory opt-in too).
int nmpc_inner_solve(const float* prm, const float* x0, const float* xref,
                     const float* lam, const float* mu, const float* Uin,
                     float* Xs, float* U, float* cost, int* iters, float* kff,
                     float* Kfb, float* Xw, float* Uw, int B, int N, int n_inner, int adaptive,
                     int n_alphas, int ls_rounds, int pairs, int warps, float reg,
                     float armijo, float tol_cost, float ls_beta, float ls_grow,
                     float ls_trial_min, const float* mov, int n_obs, int n_mov, int mov_stride,
                     void* stream) {
  using S = nmpc::Slot<NMPC_NR>;
  if (B <= 0 || N <= 0 || n_alphas < 0 || warps < 1 || warps > nmpc::kMaxWarps || n_obs < 0 ||
      n_mov < 0 || mov_stride < 0 || (n_mov > 0 && mov == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  const int rows = NMPC_NR * (n_obs + n_mov);
  nmpc::WarpArgs a{prm, x0, xref, lam, mu, Uin, Xs, U, cost, iters, kff, Kfb, Xw, Uw,
                   B, N, n_inner, adaptive, n_alphas, ls_rounds, pairs, S::floats_obs(rows),
                   reg, armijo, tol_cost, ls_beta, ls_grow, ls_trial_min,
                   mov, n_obs, n_mov, mov_stride};
  return rows > 0 ? nmpc::launch_inner<true>(a, warps, stream)
                  : nmpc::launch_inner<false>(a, warps, stream);
}

// K2, the obstacle variant when n_obs + n_mov > 0. Returns
// cudaGetLastError() after the launch (0 = launched).
int nmpc_al_update(const float* prm, const float* Xs, const float* U,
                   const float* lam, const float* mu, float* lam_out,
                   float* viol, int B, int N, int pairs, float lam_max,
                   const float* mov, int n_obs, int n_mov, int mov_stride, void* stream) {
  if (B <= 0 || N <= 0 || n_obs < 0 || n_mov < 0 || mov_stride < 0 ||
      (n_mov > 0 && mov == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  nmpc::ALArgs a{prm, Xs, U, lam, mu, lam_out, viol, B, N, pairs, lam_max,
                 mov, n_obs, n_mov, mov_stride};
  const int grid = (B + nmpc::kAlWarps - 1) / nmpc::kAlWarps;
  if (n_obs + n_mov > 0) {
    const int smem = 4 * (nmpc::Dims<NMPC_NR>::alphas + 3 * n_obs);
    if (smem > 48 * 1024) {
      const cudaError_t err = cudaFuncSetAttribute(
          nmpc::al_update_kernel<NMPC_NR, true>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
      if (err != cudaSuccess) return static_cast<int>(err);
    }
    nmpc::al_update_kernel<NMPC_NR, true><<<grid, nmpc::kAlWarps * nmpc::kWarp, smem,
                                            static_cast<cudaStream_t>(stream)>>>(a);
  } else {
    nmpc::al_update_kernel<NMPC_NR, false><<<grid, nmpc::kAlWarps * nmpc::kWarp, 0,
                                             static_cast<cudaStream_t>(stream)>>>(a);
  }
  return static_cast<int>(cudaGetLastError());
}

#if NMPC_NR <= 2
// The team design's compile-time settings: {T, ring depth, register cap in
// blocks of kMaxWarps warps}.
void nmpc_k1_team_geometry(int* out) {
  out[0] = nmpc::kTeam;
  out[1] = nmpc::kRing;
  out[2] = nmpc::kTeamMinBlocks;
}

// Shared bytes of a team's ring with `rows` = m (n_obs + n_mov) obstacle
// rows, n_mov of them moving, and pair rows on or off.
int nmpc_k1_team_ring_bytes(int rows, int n_mov, int pairs) {
  if (rows < 0 || n_mov < 0) return -1;
  using D = nmpc::Dims<NMPC_NR>;
  const int nc = (pairs ? D::np : 0) + 2 * D::nu + 2 * D::n + rows;  // n_rows + rows
  return 4 * nmpc::TeamSlot<NMPC_NR>::ring_floats(nc, n_mov);
}

// K1's team design, with nmpc_inner_solve's arguments: `warps` warps a
// block (32 / T scenarios a warp); Xw, Uw are one scratch trajectory
// [B, N, ...]; Kfb is read as [B, N, nu, n]. Returns the CUDA error of the
// launch.
int nmpc_inner_solve_team(const float* prm, const float* x0, const float* xref,
                          const float* lam, const float* mu, const float* Uin,
                          float* Xs, float* U, float* cost, int* iters, float* kff,
                          float* Kfb, float* Xw, float* Uw, int B, int N, int n_inner,
                          int adaptive, int n_alphas, int ls_rounds, int pairs, int warps,
                          float reg, float armijo, float tol_cost, float ls_beta, float ls_grow,
                          float ls_trial_min, const float* mov, int n_obs, int n_mov,
                          int mov_stride, void* stream) {
  if (B <= 0 || N <= 0 || n_alphas < 0 || ls_rounds < 0 || warps < 1 ||
      warps > nmpc::kMaxWarps || n_obs < 0 || n_mov < 0 || mov_stride < 0 ||
      (n_mov > 0 && mov == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  const int rows = NMPC_NR * (n_obs + n_mov);
  const int ring = nmpc_k1_team_ring_bytes(rows, n_mov, pairs) / 4;
  nmpc::WarpArgs a{prm, x0, xref, lam, mu, Uin, Xs, U, cost, iters, kff, Kfb, Xw, Uw,
                   B, N, n_inner, adaptive, n_alphas, ls_rounds, pairs, ring,
                   reg, armijo, tol_cost, ls_beta, ls_grow, ls_trial_min,
                   mov, n_obs, n_mov, mov_stride};
  return rows > 0 ? nmpc::launch_team<true>(a, warps, stream)
                  : nmpc::launch_team<false>(a, warps, stream);
}
#endif

#ifdef NMPC_K1_PROBES
// K1's phase counters (inner_warp.cuh, tools/k1_phases.py): reset = 1 zeroes
// them, else the 16 sums are copied to `out`. Returns the CUDA error (0 = ok).
int nmpc_phases(unsigned long long* out, int reset) {
  if (reset) {
    const unsigned long long zero[16] = {};
    return static_cast<int>(cudaMemcpyToSymbol(nmpc::g_phase, zero, sizeof zero));
  }
  return static_cast<int>(cudaMemcpyFromSymbol(out, nmpc::g_phase, sizeof(nmpc::g_phase)));
}
#endif

}  // extern "C"
