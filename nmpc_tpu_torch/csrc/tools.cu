// CUDA kernels of the port's roofline tools, K7 (FMA peak probe), K8 (phase
// ablation of K1) and K9 (expansion-layout A/B of K1), with a plain C
// interface for ctypes. Built by nmpc_tpu_torch/ops/cuda_build.py::load_tools
// into a library of its own, apart from the solver's libnmpc_m<m>, one
// nvcc process per part, all started together and linked:
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -Xcompiler -fPIC
//        -DNMPC_NR=<m> -DNMPC_TOOLS_PART=<0..8> -c tools.cu
// Part 0 holds K7 and the C interface; parts 1-8 one K1 variant each (each
// variant is a K1-sized kernel, so each gets its own compiler process).
//
// K7 replaces tools/roofline.py::measure_vpu_peak. What bounds it: FMA issue
// alone (2 FLOPs per FFMA, 128 FP32 lanes per SM), if every warp scheduler
// finds an independent FMA each cycle; C chains per thread hide the FMA
// latency, and the r-loop is unrolled so loop control is a small share of
// the issue slots. Its bytes (one read and one write per chain) are
// negligible.
// K8 replaces tools/exp_mega_phases.py::run_mode and K9
// tools/exp_blocked_expansions.py::run. Both are K1 (megasolve.cu), built
// from the same device functions with other template flags, one thread per
// scenario; what bounds them is what bounds K1: the thread-local Q-blocks
// (and, for the dense layout, 468 more thread-local floats at six robots)
// and the serial per-scenario solve, far from both the FMA and the
// device-memory roof.

#include <cuda_runtime.h>

#include "tools.cuh"

#ifndef NMPC_NR
#error "compile with -DNMPC_NR=<robot count>"
#endif
#ifndef NMPC_TOOLS_PART
#error "compile with -DNMPC_TOOLS_PART=<0..8>"
#endif

namespace nmpc {

constexpr int kVariantThreads = 128;  // K1's block
constexpr int kFmaThreads = 256;

// The K1 variants, one per part: (part, expansion layout, phase, early exit)
//   1 Expansion full       early exit   K8 `full` with the early exit (= K1)
//   2 Expansion full       fixed count  K8 `full`; K9 structured
//   3 Expansion inv_solve  fixed        4 no_ls   5 no_solve
//   6 no_expcon            7 sweep_only 8 DenseExpansion full, fixed: K9 dense
int variant_1(const InnerArgs& a, cudaStream_t s);
int variant_2(const InnerArgs& a, cudaStream_t s);
int variant_3(const InnerArgs& a, cudaStream_t s);
int variant_4(const InnerArgs& a, cudaStream_t s);
int variant_5(const InnerArgs& a, cudaStream_t s);
int variant_6(const InnerArgs& a, cudaStream_t s);
int variant_7(const InnerArgs& a, cudaStream_t s);
int variant_8(const InnerArgs& a, cudaStream_t s);

#if NMPC_TOOLS_PART > 0

// the body of megasolve.cu::inner_solve_kernel with the variant's flags
template <int NR, class Exp, Phase kPhase, bool kEarlyExit>
__global__ void __launch_bounds__(kVariantThreads) variant_kernel(InnerArgs a) {
  __shared__ float sp[Dims<NR>::alphas + kMaxAlphas];
  for (int i = threadIdx.x; i < Dims<NR>::alphas + a.n_alphas; i += blockDim.x) sp[i] = a.prm[i];
  __syncthreads();
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b < a.B) inner_solve_thread<NR, Exp, kPhase, kEarlyExit>(a, sp, b);
}

#define NMPC_VARIANT(k, EXP, PHASE, EARLY)                                          \
  int variant_##k(const InnerArgs& a, cudaStream_t s) {                             \
    const int grid = (a.B + kVariantThreads - 1) / kVariantThreads;                 \
    variant_kernel<NMPC_NR, EXP<NMPC_NR>, PHASE, EARLY><<<grid, kVariantThreads, 0, s>>>(a); \
    return static_cast<int>(cudaGetLastError());                                    \
  }

#if NMPC_TOOLS_PART == 1
NMPC_VARIANT(1, Expansion, Phase::full, true)
#elif NMPC_TOOLS_PART == 2
NMPC_VARIANT(2, Expansion, Phase::full, false)
#elif NMPC_TOOLS_PART == 3
NMPC_VARIANT(3, Expansion, Phase::inv_solve, false)
#elif NMPC_TOOLS_PART == 4
NMPC_VARIANT(4, Expansion, Phase::no_ls, false)
#elif NMPC_TOOLS_PART == 5
NMPC_VARIANT(5, Expansion, Phase::no_solve, false)
#elif NMPC_TOOLS_PART == 6
NMPC_VARIANT(6, Expansion, Phase::no_expcon, false)
#elif NMPC_TOOLS_PART == 7
NMPC_VARIANT(7, Expansion, Phase::sweep_only, false)
#elif NMPC_TOOLS_PART == 8
NMPC_VARIANT(8, DenseExpansion, Phase::full, false)
#else
#error "NMPC_TOOLS_PART must be 0..8"
#endif

#else  // part 0: K7 and the C interface

// K7: thread t carries chains c = 0..C-1, chain c at x0[c T + t] (a warp
// reads 32 neighbouring floats), and stores them at out[c T + t].
template <int C>
__global__ void __launch_bounds__(kFmaThreads) fma_peak_kernel(const float* x0, float* out,
                                                               float a, float b, int R,
                                                               long long T) {
  const long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= T) return;
  float x[C];
#pragma unroll
  for (int c = 0; c < C; ++c) x[c] = x0[c * T + t];
  fma_chain<C>(x, a, b, R);
#pragma unroll
  for (int c = 0; c < C; ++c) out[c * T + t] = x[c];
}

template <int C>
int launch_fma(const float* x0, float* out, float a, float b, int R, long long T,
               cudaStream_t s) {
  const long long grid = (T + kFmaThreads - 1) / kFmaThreads;
  fma_peak_kernel<C><<<(unsigned)grid, kFmaThreads, 0, s>>>(x0, out, a, b, R, T);
  return static_cast<int>(cudaGetLastError());
}

inline InnerArgs inner_args(const float* prm, const float* x0, const float* xref,
                            const float* lam, const float* mu, const float* Uin,
                            float* Xs, float* U, float* cost, int* iters, float* kff,
                            float* Kfb, int B, int N, int n_inner, int adaptive,
                            int n_alphas, int ls_rounds, int pairs, float reg,
                            float armijo, float tol_cost, float ls_beta, float ls_grow,
                            float ls_trial_min) {
  return InnerArgs{prm, x0, xref, lam, mu, Uin, Xs, U, cost, iters, kff, Kfb,
                   B, N, n_inner, adaptive, n_alphas, ls_rounds, pairs,
                   reg, armijo, tol_cost, ls_beta, ls_grow, ls_trial_min};
}

#endif

}  // namespace nmpc

#if NMPC_TOOLS_PART == 0

extern "C" {

int nmpc_robots() { return NMPC_NR; }

const char* nmpc_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// K7 with C in {4, 8, 16, 32} chains per thread over T threads. Returns
// cudaGetLastError() after the launch (0 = launched).
int nmpc_fma_peak(const float* x0, float* out, float a, float b, int R, int C,
                  long long T, void* stream) {
  if (R < 0 || T <= 0 || (T + nmpc::kFmaThreads - 1) / nmpc::kFmaThreads > 0x7fffffffLL)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (C) {
    case 4: return nmpc::launch_fma<4>(x0, out, a, b, R, T, s);
    case 8: return nmpc::launch_fma<8>(x0, out, a, b, R, T, s);
    case 16: return nmpc::launch_fma<16>(x0, out, a, b, R, T, s);
    case 32: return nmpc::launch_fma<32>(x0, out, a, b, R, T, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

#define NMPC_INNER_PARAMS                                                            \
  const float *prm, const float *x0, const float *xref, const float *lam,            \
      const float *mu, const float *Uin, float *Xs, float *U, float *cost, int *iters, \
      float *kff, float *Kfb, int B, int N, int n_inner, int adaptive, int n_alphas,  \
      int ls_rounds, int pairs, float reg, float armijo, float tol_cost,             \
      float ls_beta, float ls_grow, float ls_trial_min, void *stream
#define NMPC_INNER_ARGS                                                              \
  nmpc::inner_args(prm, x0, xref, lam, mu, Uin, Xs, U, cost, iters, kff, Kfb, B, N,    \
                   n_inner, adaptive, n_alphas, ls_rounds, pairs, reg, armijo,         \
                   tol_cost, ls_beta, ls_grow, ls_trial_min)

// K8: mode = nmpc::Phase (0 full, 1 inv_solve, 2 no_ls, 3 no_solve,
// 4 no_expcon, 5 sweep_only) with K1's arguments; early_exit = 1 (only with
// mode 0) is K1 itself. Returns cudaGetLastError() after the launch.
int nmpc_phase_ablation(int mode, int early_exit, NMPC_INNER_PARAMS) {
  if (B <= 0 || N <= 0 || n_alphas < 0 || n_alphas > nmpc::kMaxAlphas ||
      (early_exit && mode != 0))
    return static_cast<int>(cudaErrorInvalidValue);
  const nmpc::InnerArgs a = NMPC_INNER_ARGS;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (mode) {
    case 0: return early_exit ? nmpc::variant_1(a, s) : nmpc::variant_2(a, s);
    case 1: return nmpc::variant_3(a, s);
    case 2: return nmpc::variant_4(a, s);
    case 3: return nmpc::variant_5(a, s);
    case 4: return nmpc::variant_6(a, s);
    case 5: return nmpc::variant_7(a, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// K9: K1 at a fixed iteration count with the structured (dense = 0) or the
// dense (dense = 1) expansion layout. Returns cudaGetLastError().
int nmpc_expansion_ab(int dense, NMPC_INNER_PARAMS) {
  if (B <= 0 || N <= 0 || n_alphas < 0 || n_alphas > nmpc::kMaxAlphas)
    return static_cast<int>(cudaErrorInvalidValue);
  const nmpc::InnerArgs a = NMPC_INNER_ARGS;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return dense ? nmpc::variant_8(a, s) : nmpc::variant_2(a, s);
}

}  // extern "C"

#endif
