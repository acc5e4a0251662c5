// The first designs of K3 (Riccati sweep) and K5 (line-search merits), one
// thread per scenario (csrc/staged.cuh::riccati_thread and
// linesearch_cost_thread), with a plain C interface for ctypes. They are the
// A/B baselines of the tile design that the solver runs (csrc/staged_tiles.cuh)
// and are reached only from nmpc_tpu_torch/tools/staged_launch.py. Built by
// ops/cuda_build.py::load_first into a library of its own per robot count:
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -Xcompiler -fPIC
//        -DNMPC_NR=<m> -c staged_first.cu

#include <cuda_runtime.h>

#include "staged.cuh"

#ifndef NMPC_NR
#error "compile with -DNMPC_NR=<robot count>"
#endif

namespace nmpc {

constexpr int kFirstThreads = 128;

template <int NR>
__global__ void __launch_bounds__(kFirstThreads) riccati_first_kernel(RiccatiArgs a) {
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b < a.B) riccati_thread<NR>(a, b);
}

template <int NR>
__global__ void __launch_bounds__(kFirstThreads) linesearch_costs_first_kernel(CostArgs a,
                                                                             int prm_size) {
  extern __shared__ float sp[];
  for (int i = threadIdx.x; i < prm_size; i += blockDim.x) sp[i] = a.prm[i];
  __syncthreads();
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b < a.B) linesearch_cost_thread<NR>(a, sp, blockIdx.y, b);
}

inline int first_grid(int B) { return (B + kFirstThreads - 1) / kFirstThreads; }

}  // namespace nmpc

extern "C" {

int nmpc_robots() { return NMPC_NR; }

const char* nmpc_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// K3's first design; the arguments of nmpc_riccati without the scratch.
// Returns cudaGetLastError() after the launch (0 = launched).
int nmpc_riccati_first(const float* A, const float* Bm, const float* lx, const float* lu,
                       const float* lxx, const float* luu, const float* lux, float* kff,
                       float* Kfb, float* dV1, int B, int N, float reg, void* stream) {
  if (B <= 0 || N <= 0) return static_cast<int>(cudaErrorInvalidValue);
  nmpc::RiccatiArgs a{A, Bm, lx, lu, lxx, luu, lux, kff, Kfb, dV1, B, N, reg};
  nmpc::riccati_first_kernel<NMPC_NR><<<nmpc::first_grid(B), nmpc::kFirstThreads, 0,
                                        static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}

// K5's first design: grid (B / 128, n_alphas); the arguments of
// nmpc_linesearch_costs. Returns cudaGetLastError() after the launch.
int nmpc_linesearch_costs_first(const float* prm, int prm_size, const float* x0,
                                const float* Xs, const float* U, const float* kff,
                                const float* Kfb, const float* xref, const float* lam,
                                const float* mu, const float* mov, float* costs, int B,
                                int N, int n_alphas, int pairs, int n_obs, int n_mov,
                                void* stream) {
  if (B <= 0 || N <= 0 || n_alphas <= 0 || n_alphas > 65535 || n_obs < 0 || n_mov < 0 ||
      (n_mov > 0 && mov == nullptr) || prm_size > 12288)
    return static_cast<int>(cudaErrorInvalidValue);
  nmpc::CostArgs a{prm, x0, Xs, U, kff, Kfb, xref, lam, mu, mov, costs,
                   B, N, n_alphas, pairs, n_obs, n_mov};
  const dim3 grid(nmpc::first_grid(B), n_alphas);
  nmpc::linesearch_costs_first_kernel<NMPC_NR>
      <<<grid, nmpc::kFirstThreads, prm_size * sizeof(float),
         static_cast<cudaStream_t>(stream)>>>(a, prm_size);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
