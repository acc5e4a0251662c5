// CUDA kernels K3-K6 of the staged AL-iLQR path, with a plain C interface
// for ctypes. Linked with megasolve.cu into one library per robot count by
// nmpc_tpu_torch/ops/cuda_build.py (each source compiled by its own nvcc
// -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -DNMPC_NR=<m>).
//
// Replaces nmpc_tpu/ops/expansions_pallas.py::expansions_fused (K4),
// riccati_pallas.py::riccati_lanes (K3), rollout_pallas.py::
// linesearch_costs_lanes (K5) and ::rollout_alpha_lanes (K6). The TPU
// kernels work on 128-scenario lane tiles in VMEM, chunking the horizon so
// it fits; here the grid covers the batch (and, for K4, the stages: they are
// independent; for K5, the line-search candidates) and there is no chunking.
// What bounds them on an H100: K4 writes the dense stage blocks (at six
// robots ~1,250 floats per stage and scenario, ~1.6 GB at N=10, B=32768) and
// K3 reads them back, so the pair is bound by device-memory bytes; K3's
// per-thread dense O(n^3) products run out of thread-local memory. The
// lane-major layout keeps every global access of a warp coalesced. Keeping
// the blocks out of device memory altogether is what K1 (the megakernel)
// does.

#include <cuda_runtime.h>

#include "staged.cuh"

#ifndef NMPC_NR
#error "compile with -DNMPC_NR=<robot count>"
#endif

namespace nmpc {

constexpr int kStagedThreads = 128;

// the parameter block, copied once per block into dynamic shared memory
__device__ __forceinline__ void load_params(const float* prm, int size, float* sp) {
  for (int i = threadIdx.x; i < size; i += blockDim.x) sp[i] = prm[i];
  __syncthreads();
}

template <int NR>
__global__ void __launch_bounds__(kStagedThreads) expansions_kernel(ExpArgs a, int prm_size) {
  extern __shared__ float sp[];
  load_params(a.prm, prm_size, sp);
  const long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (t < (long long)a.N * a.B) expansion_thread<NR>(a, sp, (int)(t / a.B), (int)(t % a.B));
}

template <int NR>
__global__ void __launch_bounds__(kStagedThreads) riccati_kernel(RiccatiArgs a) {
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b < a.B) riccati_thread<NR>(a, b);
}

template <int NR>
__global__ void __launch_bounds__(kStagedThreads) linesearch_costs_kernel(CostArgs a, int prm_size) {
  extern __shared__ float sp[];
  load_params(a.prm, prm_size, sp);
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b < a.B) linesearch_cost_thread<NR>(a, sp, blockIdx.y, b);
}

template <int NR>
__global__ void __launch_bounds__(kStagedThreads) rollout_alpha_kernel(RolloutArgs a) {
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b < a.B) rollout_thread<NR>(a, a.prm[Dims<NR>::dt], b);
}

inline int grid_for(long long threads) {
  return (int)((threads + kStagedThreads - 1) / kStagedThreads);
}

}  // namespace nmpc

extern "C" {

// K4. Returns cudaGetLastError() after the launch (0 = launched).
int nmpc_expansions(const float* prm, int prm_size, const float* Xs, const float* U,
                    const float* xref, const float* lam, const float* mu,
                    const float* mov, float* A, float* Bm, float* lx, float* lu,
                    float* lxx, float* luu, float* lux, int B, int N, int pairs,
                    int n_obs, int n_mov, void* stream) {
  if (B <= 0 || N <= 0 || n_obs < 0 || n_mov < 0 || (n_mov > 0 && mov == nullptr) ||
      prm_size > 12288 || (long long)N * B > 0x7fffffffLL * nmpc::kStagedThreads)
    return static_cast<int>(cudaErrorInvalidValue);
  nmpc::ExpArgs a{prm, Xs, U, xref, lam, mu, mov, A, Bm, lx, lu, lxx, luu, lux,
                  B, N, pairs, n_obs, n_mov};
  nmpc::expansions_kernel<NMPC_NR>
      <<<nmpc::grid_for((long long)N * B), nmpc::kStagedThreads, prm_size * sizeof(float),
         static_cast<cudaStream_t>(stream)>>>(a, prm_size);
  return static_cast<int>(cudaGetLastError());
}

// K3. Returns cudaGetLastError() after the launch (0 = launched).
int nmpc_riccati(const float* A, const float* Bm, const float* lx, const float* lu,
                 const float* lxx, const float* luu, const float* lux, float* kff,
                 float* Kfb, float* dV1, int B, int N, float reg, void* stream) {
  if (B <= 0 || N <= 0) return static_cast<int>(cudaErrorInvalidValue);
  nmpc::RiccatiArgs a{A, Bm, lx, lu, lxx, luu, lux, kff, Kfb, dV1, B, N, reg};
  nmpc::riccati_kernel<NMPC_NR><<<nmpc::grid_for(B), nmpc::kStagedThreads, 0,
                                  static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}

// K5: one row of costs per alpha of the parameter block. Returns
// cudaGetLastError() after the launch (0 = launched).
int nmpc_linesearch_costs(const float* prm, int prm_size, const float* x0,
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
  const dim3 grid(nmpc::grid_for(B), n_alphas);
  nmpc::linesearch_costs_kernel<NMPC_NR>
      <<<grid, nmpc::kStagedThreads, prm_size * sizeof(float),
         static_cast<cudaStream_t>(stream)>>>(a, prm_size);
  return static_cast<int>(cudaGetLastError());
}

// K6. Returns cudaGetLastError() after the launch (0 = launched).
int nmpc_rollout_alpha(const float* prm, const float* x0, const float* Xs,
                       const float* U, const float* kff, const float* Kfb,
                       const float* alpha, float* Xout, float* Uout, int B, int N,
                       void* stream) {
  if (B <= 0 || N <= 0) return static_cast<int>(cudaErrorInvalidValue);
  nmpc::RolloutArgs a{prm, x0, Xs, U, kff, Kfb, alpha, Xout, Uout, B, N};
  nmpc::rollout_alpha_kernel<NMPC_NR><<<nmpc::grid_for(B), nmpc::kStagedThreads, 0,
                                        static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
