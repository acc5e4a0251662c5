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

#include <cuda_runtime.h>

#include "inner_warp.cuh"

#ifndef NMPC_NR
#error "compile with -DNMPC_NR=<robot count>"
#endif

namespace nmpc {

constexpr int kMaxWarps = 4;   // K1: scenarios (warps) per block, at most
constexpr int kAlWarps = 8;    // K2: scenarios (warps) per block
// K1's register cap, as the blocks of kMaxWarps warps per SM that the
// registers must allow (65,536 / (128 x this) registers a thread): more
// resident warps hide more of a scenario's serial latency, until the spills
// cost more. Picked per m by `python -m nmpc_tpu_torch.tools.k1_launch`
// (PERF.md); -DNMPC_K1_MIN_BLOCKS=<c> overrides it for that sweep only.
#ifdef NMPC_K1_MIN_BLOCKS
template <int NR>
constexpr int kK1MinBlocks = NMPC_K1_MIN_BLOCKS;
#else
template <int NR>
constexpr int kK1MinBlocks = NR <= 2 ? 8 : NR == 3 ? 6 : NR <= 6 ? 5 : NR == 8 ? 4 : 1;
#endif

// dynamic shared memory: one slot a warp, then the parameter block (any
// number of alphas). The slots keep the address they had when the parameter
// block was a static array of at most 32 alphas: with the block in front of
// them K1 ran slower on an H100 (timed in turns)
template <int NR>
__global__ void __launch_bounds__(kMaxWarps * kWarp, kK1MinBlocks<NR>) inner_solve_kernel(WarpArgs a) {
  extern __shared__ float4 k1_smem[];  // 16-byte aligned: the slots' vector loads
  float* slots = reinterpret_cast<float*>(k1_smem);
  float* sp = slots + (blockDim.x / kWarp) * a.slot_floats;
  for (int i = threadIdx.x; i < Dims<NR>::alphas + a.n_alphas; i += blockDim.x) sp[i] = a.prm[i];
  __syncthreads();
  const int warp = threadIdx.x / kWarp;
  const int b = blockIdx.x * (blockDim.x / kWarp) + warp;
  if (b < a.B) inner_solve_warp<NR>(a, sp, slots + warp * a.slot_floats, b, threadIdx.x % kWarp);
}

template <int NR>
__global__ void __launch_bounds__(kAlWarps * kWarp) al_update_kernel(ALArgs a) {
  __shared__ float sp[Dims<NR>::alphas];
  for (int i = threadIdx.x; i < Dims<NR>::alphas; i += blockDim.x) sp[i] = a.prm[i];
  __syncthreads();
  const int b = blockIdx.x * kAlWarps + threadIdx.x / kWarp;
  if (b < a.B) al_update_warp<NR>(a, sp, b, threadIdx.x % kWarp);
}

}  // namespace nmpc

extern "C" {

int nmpc_robots() { return NMPC_NR; }

const char* nmpc_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// Shared bytes of K1's per-warp slot (the stage-local blocks; it does not
// grow with N).
int nmpc_k1_slot_bytes() { return nmpc::Slot<NMPC_NR>::bytes; }

// K1 with `warps` scenarios per block: dynamic shared memory of a slot of
// nmpc_k1_slot_bytes() a warp and the parameter block. Returns the
// CUDA error of the launch (0 = launched; a refused shared-memory opt-in
// too).
int nmpc_inner_solve(const float* prm, const float* x0, const float* xref,
                     const float* lam, const float* mu, const float* Uin,
                     float* Xs, float* U, float* cost, int* iters, float* kff,
                     float* Kfb, float* Xw, float* Uw, int B, int N, int n_inner, int adaptive,
                     int n_alphas, int ls_rounds, int pairs, int warps, float reg,
                     float armijo, float tol_cost, float ls_beta, float ls_grow,
                     float ls_trial_min, void* stream) {
  using S = nmpc::Slot<NMPC_NR>;
  if (B <= 0 || N <= 0 || n_alphas < 0 || warps < 1 || warps > nmpc::kMaxWarps)
    return static_cast<int>(cudaErrorInvalidValue);
  nmpc::WarpArgs a{prm, x0, xref, lam, mu, Uin, Xs, U, cost, iters, kff, Kfb, Xw, Uw,
                   B, N, n_inner, adaptive, n_alphas, ls_rounds, pairs, S::floats,
                   reg, armijo, tol_cost, ls_beta, ls_grow, ls_trial_min};
  const int smem = warps * S::bytes + 4 * (nmpc::Dims<NMPC_NR>::alphas + n_alphas);
  if (smem > 48 * 1024) {  // above 48 KB only by opting in
    const cudaError_t err = cudaFuncSetAttribute(
        nmpc::inner_solve_kernel<NMPC_NR>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const int grid = (B + warps - 1) / warps;
  nmpc::inner_solve_kernel<NMPC_NR><<<grid, warps * nmpc::kWarp, smem,
                                      static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}

// K2. Returns cudaGetLastError() after the launch (0 = launched).
int nmpc_al_update(const float* prm, const float* Xs, const float* U,
                   const float* lam, const float* mu, float* lam_out,
                   float* viol, int B, int N, int pairs, float lam_max,
                   void* stream) {
  if (B <= 0 || N <= 0) return static_cast<int>(cudaErrorInvalidValue);
  nmpc::ALArgs a{prm, Xs, U, lam, mu, lam_out, viol, B, N, pairs, lam_max};
  const int grid = (B + nmpc::kAlWarps - 1) / nmpc::kAlWarps;
  nmpc::al_update_kernel<NMPC_NR><<<grid, nmpc::kAlWarps * nmpc::kWarp, 0,
                                    static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}

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
