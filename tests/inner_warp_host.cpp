// Host rehearsal of csrc/inner_warp.cuh (K1 and K2, one warp per scenario),
// for tests/test_torch_inner_warp_host.py. Compiled by g++:
//   g++ -std=c++20 -O1 -shared -fPIC -pthread -ffp-contract=off
//       -fno-strict-aliasing -DNMPC_NR=<m> -I<csrc> inner_warp_host.cpp
// A scenario's warp runs as 32 std::threads with a std::barrier for
// __syncwarp; a shuffle is a store to an exchange array between two
// barriers. Each scenario gets its own slot, filled with NaN first, so a
// read of an entry the kernel did not write shows in the result. The
// parameter block is copied as the kernels copy it into shared memory.
#define NMPC_DEV inline
#define NMPC_HOST_WARP

#include <barrier>
#include <cmath>
#include <limits>
#include <thread>
#include <vector>

struct float2 {
  float x, y;
};
struct alignas(16) float4 {
  float x, y, z, w;
};
inline float2 make_float2(float a, float b) { return {a, b}; }
inline float4 make_float4(float a, float b, float c, float d) { return {a, b, c, d}; }

namespace nmpc {
thread_local std::barrier<>* g_warp = nullptr;
thread_local float* g_exch = nullptr;
thread_local int g_lane = 0;
inline void warp_sync() { g_warp->arrive_and_wait(); }
inline float shfl(float v, int src) {
  g_exch[g_lane] = v;
  warp_sync();
  const float out = g_exch[src];
  warp_sync();
  return out;
}
inline float shfl_xor(float v, int m) { return shfl(v, g_lane ^ m); }
}  // namespace nmpc

#include "inner_warp.cuh"

namespace {

// run body(lane) on the 32 lanes of one warp
template <class F>
void run_warp(F body) {
  std::barrier<> bar(nmpc::kWarp);
  float exch[nmpc::kWarp];
  std::vector<std::thread> pool;
  for (int lane = 0; lane < nmpc::kWarp; ++lane)
    pool.emplace_back([&, lane] {
      nmpc::g_warp = &bar;
      nmpc::g_exch = exch;
      nmpc::g_lane = lane;
      body(lane);
    });
  for (auto& t : pool) t.join();
}

template <bool kObs>
void k1(const nmpc::WarpArgs& a) {
  const int n_prm = nmpc::Dims<NMPC_NR>::alphas + 3 * a.n_obs + a.n_alphas;
  std::vector<float4> sp4((n_prm + 3) / 4);
  float* sp = reinterpret_cast<float*>(sp4.data());
  for (int i = 0; i < n_prm; ++i) sp[i] = a.prm[i];
  std::vector<float4> slot4(a.slot_floats / 4);
  float* slot = reinterpret_cast<float*>(slot4.data());
  for (int b = 0; b < a.B; ++b) {
    for (int i = 0; i < a.slot_floats; ++i) slot[i] = std::numeric_limits<float>::quiet_NaN();
    run_warp([&](int lane) { nmpc::inner_solve_warp<NMPC_NR, kObs>(a, sp, slot, b, lane); });
  }
}

template <bool kObs>
void k2(const nmpc::ALArgs& a) {
  const int n_prm = nmpc::Dims<NMPC_NR>::alphas + 3 * a.n_obs;
  std::vector<float> sp(a.prm, a.prm + n_prm);
  for (int b = 0; b < a.B; ++b)
    run_warp([&](int lane) { nmpc::al_update_warp<NMPC_NR, kObs>(a, sp.data(), b, lane); });
}

}  // namespace

extern "C" {

int host_robots() { return NMPC_NR; }

int host_k1_slot_bytes(int rows) { return 4 * nmpc::Slot<NMPC_NR>::floats_obs(rows); }

// K1 with the arguments of megasolve.cu::nmpc_inner_solve (no warps, no stream)
void host_inner_solve(const float* prm, const float* x0, const float* xref, const float* lam,
                      const float* mu, const float* Uin, float* Xs, float* U, float* cost,
                      int* iters, float* kff, float* Kfb, float* Xw, float* Uw, int B, int N,
                      int n_inner, int adaptive, int n_alphas, int ls_rounds, int pairs,
                      float reg, float armijo, float tol_cost, float ls_beta, float ls_grow,
                      float ls_trial_min, const float* mov, int n_obs, int n_mov,
                      int mov_stride) {
  const int rows = NMPC_NR * (n_obs + n_mov);
  const nmpc::WarpArgs a{prm, x0, xref, lam, mu, Uin, Xs, U, cost, iters, kff, Kfb, Xw, Uw,
                         B, N, n_inner, adaptive, n_alphas, ls_rounds, pairs,
                         nmpc::Slot<NMPC_NR>::floats_obs(rows), reg, armijo, tol_cost,
                         ls_beta, ls_grow, ls_trial_min, mov, n_obs, n_mov, mov_stride};
  if (rows > 0)
    k1<true>(a);
  else
    k1<false>(a);
}

// K2 with the arguments of megasolve.cu::nmpc_al_update (no stream)
void host_al_update(const float* prm, const float* Xs, const float* U, const float* lam,
                    const float* mu, float* lam_out, float* viol, int B, int N, int pairs,
                    float lam_max, const float* mov, int n_obs, int n_mov, int mov_stride) {
  const nmpc::ALArgs a{prm, Xs, U, lam, mu, lam_out, viol, B, N, pairs, lam_max,
                       mov, n_obs, n_mov, mov_stride};
  if (n_obs + n_mov > 0)
    k2<true>(a);
  else
    k2<false>(a);
}

}  // extern "C"
