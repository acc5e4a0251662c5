// CUDA kernels K3-K6 of the staged AL-iLQR path, with a plain C interface
// for ctypes. Linked with megasolve.cu into one library per robot count by
// nmpc_tpu_torch/ops/cuda_build.py (each source compiled by its own nvcc
// -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -DNMPC_NR=<m>, and
// here also K3's and K5's launch geometry, -DNMPC_K3_S=... from
// ops/staged_tiles.py).
//
// Replaces nmpc_tpu/ops/expansions_pallas.py::expansions_fused (K4),
// riccati_pallas.py::riccati_lanes (K3), rollout_pallas.py::
// linesearch_costs_lanes (K5) and ::rollout_alpha_lanes (K6). The TPU
// kernels work on 128-scenario lane tiles in VMEM, chunking the horizon so
// it fits; here K4's grid covers the stages and the batch and K6's the
// batch, one thread per (stage and) scenario, while K3 and K5 run a tile of
// S scenarios per block and stream the horizon through a ring of stage
// tiles in shared memory (csrc/staged_tiles.cuh, whose note says why).
// What bounds them on an H100: K4 writes the dense stage blocks (at six
// robots ~1,250 floats per stage and scenario, ~1.6 GB at N=10, B=32768) and
// K3 reads them back, so the pair is bound by device-memory bytes. The
// lane-major layout keeps every global access of a warp coalesced. Keeping
// the blocks out of device memory altogether is what K1 (the megakernel)
// does. K3's and K5's first designs (one thread per scenario) are built by
// csrc/staged_first.cu, as their A/B baselines.

#include <cuda_runtime.h>

#include <initializer_list>

#include "staged_tiles.cuh"

#ifndef NMPC_NR
#error "compile with -DNMPC_NR=<robot count>"
#endif
#if !defined(NMPC_K3_S) || !defined(NMPC_K3_D) || !defined(NMPC_K3_T) || \
    !defined(NMPC_K3_P) || !defined(NMPC_K3_SPILL) || !defined(NMPC_K5_S) || !defined(NMPC_K5_D)
#error "compile with K3's and K5's geometry, -DNMPC_K3_S=... (ops/staged_tiles.py)"
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

using K3G = K3Geom<NMPC_NR, NMPC_K3_S, NMPC_K3_D, NMPC_K3_T, NMPC_K3_P, NMPC_K3_SPILL != 0>;
using K5G = K5Geom<NMPC_NR, NMPC_K5_S, NMPC_K5_D>;

template <int NR>
__global__ void __launch_bounds__(K3G::threads) riccati_kernel(RiccatiArgs a, float* scratch, int vec) {
  extern __shared__ float4 k3_smem[];  // 16-byte aligned: the ring's vector copies
  riccati_tiles<NR, K3G>(a, reinterpret_cast<float*>(k3_smem), scratch, blockIdx.x, vec != 0,
                         threadIdx.x);
}

template <int NR>
__global__ void __launch_bounds__(K5G::kThreads) linesearch_costs_kernel(CostArgs a, int prm_size,
                                                                       int vec) {
  extern __shared__ float4 k5_smem[];
  float* sp = reinterpret_cast<float*>(k5_smem);
  load_params(a.prm, prm_size, sp);
  linesearch_tiles<NR, K5G>(a, sp, sp + al4(prm_size), blockIdx.x, vec != 0, threadIdx.x,
                            blockDim.x);
}

// whether every row segment of these lane-major arrays may be copied as
// 16-byte chunks: 16-byte aligned bases and B % 4 == 0
inline bool rows_aligned(int B, std::initializer_list<const float*> ptrs) {
  if (B % 4) return false;
  for (const float* p : ptrs)
    if (reinterpret_cast<uintptr_t>(p) % 16) return false;
  return true;
}

// opt in to dynamic shared memory above 48 KB
template <class K>
cudaError_t allow_smem(K kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
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

#ifdef NMPC_STAGED_ALONE
// built without megasolve.cu (cuda_build.load_staged_variant), which
// otherwise provides these two
int nmpc_robots() { return NMPC_NR; }

const char* nmpc_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
#endif

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

// K3's geometry: {S, D, T, P, spill, threads, shared bytes a block, scratch
// floats a block (spill)}; ops/staged_tiles.py computes the same.
void nmpc_k3_geometry(int* out) {
  using G = nmpc::K3G;
  const int g[8] = {G::S, G::D, G::T, G::P, G::kSpill, G::threads,
                    static_cast<int>(G::smem_floats * sizeof(float)), G::scratch_floats};
  for (int i = 0; i < 8; ++i) out[i] = g[i];
}

// K5's geometry: {S, D, largest number of alphas a block takes, shared bytes
// a block for `rows` stage rows and a parameter block of prm_size floats}.
void nmpc_k5_geometry(int rows, int prm_size, int* out) {
  using G = nmpc::K5G;
  out[0] = G::S;
  out[1] = G::D;
  out[2] = G::max_alphas;
  out[3] = static_cast<int>(G::smem_floats(rows, prm_size) * sizeof(float));
}

// K3: one block per tile of S scenarios; scratch: K3's device-memory
// scratch, grid x scratch floats (null unless it spills). Returns the CUDA
// error of the launch (0 = launched; a refused shared-memory opt-in too).
int nmpc_riccati(const float* A, const float* Bm, const float* lx, const float* lu,
                 const float* lxx, const float* luu, const float* lux, float* kff,
                 float* Kfb, float* dV1, float* scratch, int B, int N, float reg, void* stream) {
  using G = nmpc::K3G;
  if (B <= 0 || N <= 0 || (G::kSpill && scratch == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  nmpc::RiccatiArgs a{A, Bm, lx, lu, lxx, luu, lux, kff, Kfb, dV1, B, N, reg};
  const size_t smem = G::smem_floats * sizeof(float);
  const cudaError_t err = nmpc::allow_smem(nmpc::riccati_kernel<NMPC_NR>, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int vec = nmpc::rows_aligned(B, {A, Bm, lx, lu, lxx, luu, lux});
  nmpc::riccati_kernel<NMPC_NR><<<(B + G::S - 1) / G::S, G::threads, smem,
                                  static_cast<cudaStream_t>(stream)>>>(a, scratch, vec);
  return static_cast<int>(cudaGetLastError());
}

// K5: one row of costs per alpha of the parameter block; one block of
// n_alphas x S threads per tile of S scenarios. Returns the CUDA error of the
// launch (0 = launched).
int nmpc_linesearch_costs(const float* prm, int prm_size, const float* x0,
                          const float* Xs, const float* U, const float* kff,
                          const float* Kfb, const float* xref, const float* lam,
                          const float* mu, const float* mov, float* costs, int B,
                          int N, int n_alphas, int pairs, int n_obs, int n_mov,
                          void* stream) {
  using G = nmpc::K5G;
  if (B <= 0 || N <= 0 || n_alphas <= 0 || n_alphas > G::max_alphas || n_obs < 0 ||
      n_mov < 0 || (n_mov > 0 && mov == nullptr) || prm_size > 12288)
    return static_cast<int>(cudaErrorInvalidValue);
  nmpc::CostArgs a{prm, x0, Xs, U, kff, Kfb, xref, lam, mu, mov, costs,
                   B, N, n_alphas, pairs, n_obs, n_mov};
  const nmpc::K5Rows<NMPC_NR> rows(pairs != 0, n_obs, n_mov);
  const size_t smem = G::smem_floats(rows.rows, prm_size) * sizeof(float);
  const cudaError_t err = nmpc::allow_smem(nmpc::linesearch_costs_kernel<NMPC_NR>, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int vec = nmpc::rows_aligned(B, {Xs, U, kff, Kfb, xref, lam, n_mov ? mov : Xs});
  nmpc::linesearch_costs_kernel<NMPC_NR>
      <<<(B + G::S - 1) / G::S, n_alphas * G::S, smem, static_cast<cudaStream_t>(stream)>>>(
          a, prm_size, vec);
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
