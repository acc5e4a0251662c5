// K3 (the staged path's backward Riccati sweep) at a stage shape other than
// the robot stacks' n = 3m, nu = 2m (any), with a plain C
// interface for ctypes: the ray-augmented stage of one robot with R LiDAR
// rays (n = 3 + R, nu = 2) and the user models' stages, which the hybrid
// route of solve_batched sends through K3 as the reference sends them
// through riccati_pallas.py::riccati_lanes at the problem's own shape.
// Built by nmpc_tpu_torch/ops/cuda_build.py (load_k3_shape) as a library of
// its own per shape:
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3
//        -DNMPC_K3_N=<n> -DNMPC_K3_NU=<nu> -DNMPC_K3_S=... (ops/staged_tiles.py)
// The device code is staged_tiles.cuh::riccati_tiles, the same that the
// solver libraries instantiate at (3m, 2m); the entry points have
// staged.cu's names and arguments, so ops/riccati.py launches either.

#include <cuda_runtime.h>

#include "staged_tiles.cuh"

#if !defined(NMPC_K3_N) || !defined(NMPC_K3_NU) || !defined(NMPC_K3_S) || \
    !defined(NMPC_K3_D) || !defined(NMPC_K3_T) || !defined(NMPC_K3_P) || !defined(NMPC_K3_SPILL)
#error "compile with the stage shape and K3's geometry, -DNMPC_K3_N=... (ops/staged_tiles.py)"
#endif
// K3's register-tile design (ops/staged_tiles.py passes -DNMPC_K3_RTILE=1 where it picks it)
#ifndef NMPC_K3_RTILE
#define NMPC_K3_RTILE 0
#endif

namespace nmpc {

using K3X = K3Geom<NMPC_K3_N, NMPC_K3_NU, NMPC_K3_S, NMPC_K3_D, NMPC_K3_T, NMPC_K3_P,
                   NMPC_K3_SPILL != 0, NMPC_K3_RTILE != 0>;

template <int n, int nu>
__global__ void __launch_bounds__(K3X::threads)
    riccati_shape_kernel(RiccatiArgs a, float* scratch, int vec) {
  extern __shared__ float4 k3x_smem[];  // 16-byte aligned: the ring's vector copies
  riccati_tiles<K3X>(a, reinterpret_cast<float*>(k3x_smem), scratch, blockIdx.x, vec != 0,
                     threadIdx.x);
}

}  // namespace nmpc

extern "C" {

// the stage shape this library was built for: {n, nu}
void nmpc_k3_shape(int* out) {
  out[0] = NMPC_K3_N;
  out[1] = NMPC_K3_NU;
}

const char* nmpc_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// K3's geometry: {S, D, T, P, spill, threads, shared bytes a block, scratch
// floats a block (spill)}, as staged.cu's nmpc_k3_geometry
void nmpc_k3_geometry(int* out) {
  using G = nmpc::K3X;
  const int g[8] = {G::S, G::D, G::T, G::P, G::kSpill, G::threads,
                    static_cast<int>(G::smem_floats * sizeof(float)), G::scratch_floats};
  for (int i = 0; i < 8; ++i) out[i] = g[i];
}

// whether K3 is built in its register-tile design (staged_tiles.cuh::riccati_rtile)
int nmpc_k3_rtile() { return nmpc::K3X::kRtile; }

// K3: one block per tile of S scenarios; the arguments of staged.cu's nmpc_riccati, on stage blocks of
// this library's (n, nu). Returns the CUDA error of the launch (0 =
// launched; a refused shared-memory opt-in too).
int nmpc_riccati(const float* A, const float* Bm, const float* lx, const float* lu,
                 const float* lxx, const float* luu, const float* lux, float* kff,
                 float* Kfb, float* dV1, float* scratch, int B, int N, float reg, void* stream) {
  using G = nmpc::K3X;
  if (B <= 0 || N <= 0 || (G::kSpill && scratch == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  nmpc::RiccatiArgs a{A, Bm, lx, lu, lxx, luu, lux, kff, Kfb, dV1, B, N, reg};
  const size_t smem = G::smem_floats * sizeof(float);
  auto kernel = nmpc::riccati_shape_kernel<NMPC_K3_N, NMPC_K3_NU>;
  const cudaError_t err = nmpc::allow_smem(kernel, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int vec = nmpc::rows_aligned(B, {A, Bm, lx, lu, lxx, luu, lux});
  kernel<<<(B + G::S - 1) / G::S, G::threads, smem, static_cast<cudaStream_t>(stream)>>>(
      a, scratch, vec);
  return static_cast<int>(cudaGetLastError());
}

#ifdef NMPC_K3_PROBES
// the phase probes' cycle sums (staged_tiles.cuh::g_k3_phase, 8 counters):
// reset = 1 zeroes them, else out receives them; returns the CUDA error
int nmpc_k3_phases(unsigned long long* out, int reset) {
  if (reset) {
    const unsigned long long zero[8] = {};
    return static_cast<int>(cudaMemcpyToSymbol(nmpc::g_k3_phase, zero, sizeof zero));
  }
  return static_cast<int>(cudaMemcpyFromSymbol(out, nmpc::g_k3_phase, sizeof(nmpc::g_k3_phase)));
}
#endif

}  // extern "C"
