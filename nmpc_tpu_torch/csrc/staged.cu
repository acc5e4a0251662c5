// CUDA kernels K3-K6 of the staged AL-iLQR path, with a plain C interface
// for ctypes. Linked with megasolve.cu into one library per robot count by
// nmpc_tpu_torch/ops/cuda_build.py (each source compiled by its own nvcc
// -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -DNMPC_NR=<m>, and
// here also the four kernels' launch geometry, -DNMPC_K3_S=... from
// ops/staged_tiles.py).
//
// Replaces nmpc_tpu/ops/expansions_pallas.py::expansions_fused (K4),
// riccati_pallas.py::riccati_lanes (K3), rollout_pallas.py::
// linesearch_costs_lanes (K5) and ::rollout_alpha_lanes (K6). The TPU
// kernels work on 128-scenario lane tiles in VMEM, chunking the horizon so
// it fits; here each kernel's block owns a tile of S consecutive scenarios
// with its rows in shared memory: K4 one stage of it, K3, K5 and K6 the
// whole horizon, streamed through a ring of stage tiles (csrc/
// staged_tiles.cuh for K3 and K5, csrc/expansions_rollout_tiles.cuh for K4
// and K6, whose notes say why). Beside the tile forms every library holds
// K4's and K5's device-memory forms (K4Device, K5Device), which keep nothing
// in shared memory, for the problems whose rows overflow the tiles: the
// wrapper picks one by ops/staged_tiles.py's k4_form and k5_form. A library
// whose K4 tile cannot fit even one scenario (-DNMPC_K4_S=0, m >= 109) holds
// K4's device-memory form alone, and where K5's geometry is its
// device-memory form (-DNMPC_K5_D=0, m >= 64) K5's tile entry launches that.
// What bounds them on an H100: K4 writes the
// dense stage blocks (at six robots ~1,250 floats per stage and scenario,
// ~1.6 GB at N=10, B=32768) and K3 reads them back, so the pair is bound by
// device-memory bytes. The lane-major layout keeps every global access of a
// warp coalesced. Keeping the blocks out of device memory altogether is
// what K1 (the megakernel) does. The first designs (one thread per (stage
// and) scenario) are built by csrc/staged_first.cu, as the A/B baselines.

#include <cuda_runtime.h>

#include "expansions_rollout_tiles.cuh"

#ifndef NMPC_NR
#error "compile with -DNMPC_NR=<robot count>"
#endif
// K3's register-tile design (ops/staged_tiles.py passes -DNMPC_K3_RTILE=1 where it picks it)
#ifndef NMPC_K3_RTILE
#define NMPC_K3_RTILE 0
#endif
#if !defined(NMPC_K3_S) || !defined(NMPC_K3_D) || !defined(NMPC_K3_T) || \
    !defined(NMPC_K3_P) || !defined(NMPC_K3_SPILL) || !defined(NMPC_K5_S) || \
    !defined(NMPC_K5_D) || !defined(NMPC_K4_S) || !defined(NMPC_K4_W) || !defined(NMPC_K6_S) || \
    !defined(NMPC_K6_D) || !defined(NMPC_K6_T)
#error "compile with the kernels' geometry, -DNMPC_K3_S=... (ops/staged_tiles.py)"
#endif

namespace nmpc {

// the parameter block, copied once per block into dynamic shared memory
__device__ __forceinline__ void load_params(const float* prm, int size, float* sp) {
  for (int i = threadIdx.x; i < size; i += blockDim.x) sp[i] = prm[i];
  __syncthreads();
}

using K3G = K3Geom<3 * NMPC_NR, 2 * NMPC_NR, NMPC_K3_S, NMPC_K3_D, NMPC_K3_T, NMPC_K3_P,
                   NMPC_K3_SPILL != 0, NMPC_K3_RTILE != 0>;
using K5G = K5Geom<NMPC_NR, NMPC_K5_S, NMPC_K5_D>;
using K6G = K6Geom<NMPC_NR, NMPC_K6_S, NMPC_K6_D, NMPC_K6_T>;
using K4DM = K4Device<NMPC_NR>;
using K5DM = K5Device<NMPC_NR>;
static_assert(NMPC_K5_D != 0 || (NMPC_K5_S == K5DM::S),
              "K5's geometry without a ring is its device-memory form");

#if NMPC_K4_S > 0
using K4G = K4Geom<NMPC_NR, NMPC_K4_S, NMPC_K4_W>;

// K4: block (tile, stage)
template <int NR>
__global__ void __launch_bounds__(K4G::threads) expansions_kernel(ExpArgs a, int prm_size,
                                                                 int vec) {
  extern __shared__ float4 k4_smem[];
  float* sp = reinterpret_cast<float*>(k4_smem);
  load_params(a.prm, prm_size, sp);
  expansion_tiles<NR, K4G>(a, sp, sp + al4(prm_size), blockIdx.x, blockIdx.y, vec != 0,
                           threadIdx.x);
}
#endif

// K4's device-memory form: block i owns slot i of the scratch (block_floats
// each) and takes the work items (tile, stage) i, i + grid, ...
template <int NR>
__global__ void __launch_bounds__(K4DM::threads) expansions_device_kernel(ExpArgs a,
                                                                          float* scratch,
                                                                          int block_floats,
                                                                          int vec) {
  const int tiles = (a.B + K4DM::S - 1) / K4DM::S;
  float* slot = scratch + (size_t)blockIdx.x * block_floats;
  for (long long w = blockIdx.x; w < (long long)tiles * a.N; w += gridDim.x) {
    expansion_tiles<NR, K4DM, true>(a, a.prm, slot, static_cast<int>(w % tiles),
                                    static_cast<int>(w / tiles), vec != 0, threadIdx.x);
    __syncthreads();   // the next work item rewrites the slot
  }
}

template <int NR>
__global__ void __launch_bounds__(K3G::threads) riccati_kernel(RiccatiArgs a, float* scratch, int vec) {
  extern __shared__ float4 k3_smem[];  // 16-byte aligned: the ring's vector copies
  riccati_tiles<K3G>(a, reinterpret_cast<float*>(k3_smem), scratch, blockIdx.x, vec != 0,
                         threadIdx.x);
}

#if NMPC_K5_D > 0
template <int NR>
__global__ void __launch_bounds__(K5G::kThreads) linesearch_costs_kernel(CostArgs a, int prm_size,
                                                                       int vec) {
  extern __shared__ float4 k5_smem[];
  float* sp = reinterpret_cast<float*>(k5_smem);
  load_params(a.prm, prm_size, sp);
  linesearch_tiles<NR, K5G>(a, sp, sp + al4(prm_size), blockIdx.x, vec != 0, threadIdx.x,
                            blockDim.x);
}
#endif

// K5's device-memory form: the parameter block and every stage row read
// from device memory, no shared memory
template <int NR>
__global__ void __launch_bounds__(K5DM::kThreads) linesearch_costs_device_kernel(CostArgs a) {
  linesearch_tiles<NR, K5DM>(a, a.prm, nullptr, blockIdx.x, false, threadIdx.x, blockDim.x);
}

template <int NR>
__global__ void __launch_bounds__(K6G::threads) rollout_alpha_kernel(RolloutArgs a, int vec) {
  extern __shared__ float4 k6_smem[];
  rollout_tiles<NR, K6G>(a, a.prm[Dims<NR>::dt], reinterpret_cast<float*>(k6_smem), blockIdx.x,
                         vec != 0, threadIdx.x);
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

// K4: one block per (tile of S scenarios, stage). Returns the CUDA error of
// the launch (0 = launched; a refused shared-memory opt-in too; invalid
// value where the library holds no K4 tile form).
int nmpc_expansions(const float* prm, int prm_size, const float* Xs, const float* U,
                    const float* xref, const float* lam, const float* mu,
                    const float* mov, float* A, float* Bm, float* lx, float* lu,
                    float* lxx, float* luu, float* lux, int B, int N, int pairs,
                    int n_obs, int n_mov, void* stream) {
#if NMPC_K4_S > 0
  using G = nmpc::K4G;
  if (B <= 0 || N <= 0 || N > 65535 || n_obs < 0 || n_mov < 0 ||
      (n_mov > 0 && mov == nullptr) || prm_size > 12288)
    return static_cast<int>(cudaErrorInvalidValue);
  nmpc::ExpArgs a{prm, Xs, U, xref, lam, mu, mov, A, Bm, lx, lu, lxx, luu, lux,
                  B, N, pairs, n_obs, n_mov};
  const nmpc::K4Rows<NMPC_NR> rows(pairs != 0, n_obs, n_mov);
  const size_t smem = G::smem_floats(rows.in, prm_size) * sizeof(float);
  const cudaError_t err = nmpc::allow_smem(nmpc::expansions_kernel<NMPC_NR>, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int vec = nmpc::rows_aligned(
      B, {Xs, U, xref, lam, mu, n_mov ? mov : Xs, A, Bm, lx, lu, lxx, luu, lux});
  const dim3 grid((B + G::S - 1) / G::S, N);
  nmpc::expansions_kernel<NMPC_NR>
      <<<grid, G::threads, smem, static_cast<cudaStream_t>(stream)>>>(a, prm_size, vec);
  return static_cast<int>(cudaGetLastError());
#else
  return static_cast<int>(cudaErrorInvalidValue);
#endif
}

// K4's device-memory form: `slots` blocks, block i with slot i of `scratch`
// (slots x nmpc_k4_device_geometry's floats), taking the (tile, stage) work
// items in turn. Returns the CUDA error of the launch.
int nmpc_expansions_device(const float* prm, const float* Xs, const float* U,
                           const float* xref, const float* lam, const float* mu,
                           const float* mov, float* A, float* Bm, float* lx, float* lu,
                           float* lxx, float* luu, float* lux, float* scratch, int slots, int B,
                           int N, int pairs, int n_obs, int n_mov, void* stream) {
  using G = nmpc::K4DM;
  if (B <= 0 || N <= 0 || slots <= 0 || scratch == nullptr || n_obs < 0 || n_mov < 0 ||
      (n_mov > 0 && mov == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  nmpc::ExpArgs a{prm, Xs, U, xref, lam, mu, mov, A, Bm, lx, lu, lxx, luu, lux,
                  B, N, pairs, n_obs, n_mov};
  const nmpc::K4Rows<NMPC_NR> rows(pairs != 0, n_obs, n_mov);
  const int vec = nmpc::rows_aligned(
      B, {Xs, U, xref, lam, mu, n_mov ? mov : Xs, A, Bm, lx, lu, lxx, luu, lux, scratch});
  nmpc::expansions_device_kernel<NMPC_NR>
      <<<slots, G::threads, 0, static_cast<cudaStream_t>(stream)>>>(
          a, scratch, G::scratch_floats(rows.in), vec);
  return static_cast<int>(cudaGetLastError());
}

// K4's geometry: {S, W, threads, shared bytes a block for `rows` input rows
// and a parameter block of prm_size floats} (zeros where the library holds
// no K4 tile form); ops/staged_tiles.py computes the same.
void nmpc_k4_geometry(int rows, int prm_size, int* out) {
#if NMPC_K4_S > 0
  using G = nmpc::K4G;
  out[0] = G::S;
  out[1] = G::W;
  out[2] = G::threads;
  out[3] = static_cast<int>(G::smem_floats(rows, prm_size) * sizeof(float));
#else
  for (int i = 0; i < 4; ++i) out[i] = 0;
#endif
}

// K4's device-memory form: {S, W, threads, floats of a block's slot of the
// scratch for `rows` input rows}
void nmpc_k4_device_geometry(int rows, int* out) {
  using G = nmpc::K4DM;
  out[0] = G::S;
  out[1] = G::W;
  out[2] = G::threads;
  out[3] = G::scratch_floats(rows);
}

// K6's geometry: {S, D, T, threads, shared bytes a block}
void nmpc_k6_geometry(int* out) {
  using G = nmpc::K6G;
  const int g[5] = {G::S, G::D, G::T, G::threads,
                    static_cast<int>(G::smem_floats * sizeof(float))};
  for (int i = 0; i < 5; ++i) out[i] = g[i];
}

// K3's geometry: {S, D, T, P, spill, threads, shared bytes a block, scratch
// floats a block (spill)}; ops/staged_tiles.py computes the same.
void nmpc_k3_geometry(int* out) {
  using G = nmpc::K3G;
  const int g[8] = {G::S, G::D, G::T, G::P, G::kSpill, G::threads,
                    static_cast<int>(G::smem_floats * sizeof(float)), G::scratch_floats};
  for (int i = 0; i < 8; ++i) out[i] = g[i];
}

// whether K3 is built in its register-tile design (staged_tiles.cuh::riccati_rtile)
int nmpc_k3_rtile() { return nmpc::K3G::kRtile; }

// K5's geometry: {S, D, largest number of alphas a block takes, shared bytes
// a block for `rows` stage rows and a parameter block of prm_size floats}.
void nmpc_k5_geometry(int rows, int prm_size, int* out) {
  using G = nmpc::K5G;
  out[0] = G::S;
  out[1] = G::D;
  out[2] = G::max_alphas;
  out[3] = static_cast<int>(G::smem_floats(rows, prm_size) * sizeof(float));
}

// K5's device-memory form: {S, D, largest number of alphas a block takes,
// shared bytes a block (none)}
void nmpc_k5_device_geometry(int* out) {
  using G = nmpc::K5DM;
  out[0] = G::S;
  out[1] = G::D;
  out[2] = G::max_alphas;
  out[3] = static_cast<int>(G::smem_floats(0, 0) * sizeof(float));
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

// K5's device-memory form: one row of costs per alpha of the parameter block
// (in device memory); one block of n_alphas x S threads per tile of S
// scenarios, no shared memory. Returns the CUDA error of the launch.
int nmpc_linesearch_costs_device(const float* prm, int prm_size, const float* x0,
                                 const float* Xs, const float* U, const float* kff,
                                 const float* Kfb, const float* xref, const float* lam,
                                 const float* mu, const float* mov, float* costs, int B, int N,
                                 int n_alphas, int pairs, int n_obs, int n_mov, void* stream) {
  using G = nmpc::K5DM;
  if (B <= 0 || N <= 0 || n_alphas <= 0 || n_alphas > G::max_alphas || n_obs < 0 ||
      n_mov < 0 || (n_mov > 0 && mov == nullptr) ||
      prm_size != nmpc::Dims<NMPC_NR>::alphas + 3 * n_obs + n_alphas)
    return static_cast<int>(cudaErrorInvalidValue);
  nmpc::CostArgs a{prm, x0, Xs, U, kff, Kfb, xref, lam, mu, mov, costs,
                   B, N, n_alphas, pairs, n_obs, n_mov};
  nmpc::linesearch_costs_device_kernel<NMPC_NR>
      <<<(B + G::S - 1) / G::S, n_alphas * G::S, 0, static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}

// K5: one row of costs per alpha of the parameter block; one block of
// n_alphas x S threads per tile of S scenarios (with -DNMPC_K5_D=0 the
// device-memory form). Returns the CUDA error of the launch (0 = launched).
int nmpc_linesearch_costs(const float* prm, int prm_size, const float* x0,
                          const float* Xs, const float* U, const float* kff,
                          const float* Kfb, const float* xref, const float* lam,
                          const float* mu, const float* mov, float* costs, int B,
                          int N, int n_alphas, int pairs, int n_obs, int n_mov,
                          void* stream) {
#if NMPC_K5_D == 0
  return nmpc_linesearch_costs_device(prm, prm_size, x0, Xs, U, kff, Kfb, xref, lam, mu, mov,
                                      costs, B, N, n_alphas, pairs, n_obs, n_mov, stream);
#else
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
#endif
}

// K6: one block per tile of S scenarios. Returns the CUDA error of the
// launch (0 = launched; a refused shared-memory opt-in too).
int nmpc_rollout_alpha(const float* prm, const float* x0, const float* Xs,
                       const float* U, const float* kff, const float* Kfb,
                       const float* alpha, float* Xout, float* Uout, int B, int N,
                       void* stream) {
  using G = nmpc::K6G;
  if (B <= 0 || N <= 0) return static_cast<int>(cudaErrorInvalidValue);
  nmpc::RolloutArgs a{prm, x0, Xs, U, kff, Kfb, alpha, Xout, Uout, B, N};
  const size_t smem = G::smem_floats * sizeof(float);
  const cudaError_t err = nmpc::allow_smem(nmpc::rollout_alpha_kernel<NMPC_NR>, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int vec = nmpc::rows_aligned(B, {Xs, U, kff, Kfb});
  nmpc::rollout_alpha_kernel<NMPC_NR><<<(B + G::S - 1) / G::S, G::threads, smem,
                                        static_cast<cudaStream_t>(stream)>>>(a, vec);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
