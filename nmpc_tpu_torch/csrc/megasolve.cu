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
// whole solve in VMEM and does the small-matrix algebra as lane-vector ops;
// here one thread runs one scenario's solve and the grid covers the batch.
// What bounds it on an H100: the per-stage Q-blocks (Vxx is n^2 = 324 floats
// at six robots) exceed the register file, so they live in thread-local
// memory (L1/L2-backed), and each line-search candidate re-reads the stage's
// gains (nu * n floats) from global memory. The lane-major layout keeps every
// global access coalesced; local arrays are interleaved per thread by the
// hardware, so those accesses are coalesced too. A warp lasts as long as its
// slowest scenario: a launch costs the per-warp maximum of the inner
// iteration counts, not their mean (measured on an H100 80GB HBM3 at
// B=32768: ~55 ms per launch whether the mean is 12 or 3.6 iterations).

#include <cuda_runtime.h>

#include "megasolve.cuh"

#ifndef NMPC_NR
#error "compile with -DNMPC_NR=<robot count>"
#endif

namespace nmpc {

constexpr int kThreads = 128;

template <int NR>
__global__ void __launch_bounds__(kThreads) inner_solve_kernel(InnerArgs a) {
  __shared__ float sp[Dims<NR>::alphas + kMaxAlphas];
  for (int i = threadIdx.x; i < Dims<NR>::alphas + a.n_alphas; i += blockDim.x) sp[i] = a.prm[i];
  __syncthreads();
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b < a.B) inner_solve_thread<NR>(a, sp, b);
}

template <int NR>
__global__ void __launch_bounds__(kThreads) al_update_kernel(ALUpdateArgs a) {
  __shared__ float sp[Dims<NR>::alphas];
  for (int i = threadIdx.x; i < Dims<NR>::alphas; i += blockDim.x) sp[i] = a.prm[i];
  __syncthreads();
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b < a.B) al_update_thread<NR>(a, sp, b);
}

}  // namespace nmpc

extern "C" {

int nmpc_robots() { return NMPC_NR; }

const char* nmpc_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// K1. Returns cudaGetLastError() after the launch (0 = launched).
int nmpc_inner_solve(const float* prm, const float* x0, const float* xref,
                     const float* lam, const float* mu, const float* Uin,
                     float* Xs, float* U, float* cost, int* iters, float* kff,
                     float* Kfb, int B, int N, int n_inner, int adaptive,
                     int n_alphas, int ls_rounds, int pairs, float reg,
                     float armijo, float tol_cost, float ls_beta,
                     float ls_grow, float ls_trial_min, void* stream) {
  if (B <= 0 || N <= 0 || n_alphas < 0 || n_alphas > nmpc::kMaxAlphas)
    return static_cast<int>(cudaErrorInvalidValue);
  nmpc::InnerArgs a{prm, x0, xref, lam, mu, Uin, Xs, U, cost, iters, kff, Kfb,
                    B, N, n_inner, adaptive, n_alphas, ls_rounds, pairs,
                    reg, armijo, tol_cost, ls_beta, ls_grow, ls_trial_min};
  const int grid = (B + nmpc::kThreads - 1) / nmpc::kThreads;
  nmpc::inner_solve_kernel<NMPC_NR><<<grid, nmpc::kThreads, 0,
                                      static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}

// K2. Returns cudaGetLastError() after the launch (0 = launched).
int nmpc_al_update(const float* prm, const float* Xs, const float* U,
                   const float* lam, const float* mu, float* lam_out,
                   float* viol, int B, int N, int pairs, float lam_max,
                   void* stream) {
  if (B <= 0 || N <= 0) return static_cast<int>(cudaErrorInvalidValue);
  nmpc::ALUpdateArgs a{prm, Xs, U, lam, mu, lam_out, viol, B, N, pairs, lam_max};
  const int grid = (B + nmpc::kThreads - 1) / nmpc::kThreads;
  nmpc::al_update_kernel<NMPC_NR><<<grid, nmpc::kThreads, 0,
                                    static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
