// Host rehearsal of csrc/inner_team.cuh (K1 at m <= 2, a team of T lanes per
// scenario), for tests/test_torch_inner_team_host.py. Compiled by g++:
//   g++ -std=c++20 -O1 -shared -fPIC -pthread -ffp-contract=off
//       -fno-strict-aliasing -DNMPC_NR=<m> [-DNMPC_K1_TEAM=<T> ...]
//       -I<csrc> inner_team_host.cpp
// A scenario's team runs as T lanes (tests/host_lanes.h: coroutines in the
// calling thread) with a barrier for __syncwarp; a width-T shuffle is a
// store to an exchange array between two barriers; a ring copy (cp.async on
// the card) is a plain copy, its commit and wait no-ops. Each scenario's
// ring is filled with NaN first, so a read of an entry no fetch wrote shows
// in the result. The parameter block is copied as the kernel copies it into
// shared memory.
#define NMPC_DEV inline
#define NMPC_HOST_WARP

#include <cmath>
#include <limits>
#include <vector>

#include "host_lanes.h"

struct float2 {
  float x, y;
};
struct alignas(16) float4 {
  float x, y, z, w;
};
inline float2 make_float2(float a, float b) { return {a, b}; }
inline float4 make_float4(float a, float b, float c, float d) { return {a, b, c, d}; }

namespace nmpc {
thread_local host_lanes::Barrier* g_team = nullptr;
thread_local float* g_exch = nullptr;
inline void warp_sync() { host_lanes::wait(*g_team); }
inline float shfl(float v, int src) {
  g_exch[host_lanes::lane()] = v;
  warp_sync();
  const float out = g_exch[src];
  warp_sync();
  return out;
}
inline float shfl_xor(float v, int m) { return shfl(v, host_lanes::lane() ^ m); }
inline void team_sync(unsigned) { warp_sync(); }
inline float team_shfl(float v, int src, unsigned) { return shfl(v, src); }
inline float team_shfl_xor(float v, int m, unsigned) { return shfl_xor(v, m); }
inline void ring_copy(float* dst, const float* src) { *dst = *src; }
inline void ring_commit() {}
template <int P>
inline void ring_wait() {}
inline float add_rn(float a, float b) { return a + b; }
inline float sub_rn(float a, float b) { return a - b; }
}  // namespace nmpc

#include "inner_team.cuh"

namespace {

template <bool kObs>
void k1(const nmpc::WarpArgs& a) {
  const int n_prm = nmpc::Dims<NMPC_NR>::alphas + 3 * a.n_obs + a.n_alphas;
  std::vector<float> sp(a.prm, a.prm + n_prm);
  std::vector<float> ring(a.slot_floats);
  for (int b = 0; b < a.B; ++b) {
    for (auto& v : ring) v = std::numeric_limits<float>::quiet_NaN();
    host_lanes::Barrier bar(nmpc::kTeam);
    float exch[nmpc::kTeam];
    nmpc::g_team = &bar;
    nmpc::g_exch = exch;
    host_lanes::run(nmpc::kTeam, [&](int tl) {
      nmpc::inner_solve_team<NMPC_NR, kObs>(a, sp.data(), ring.data(), b, tl, ~0u);
    });
  }
}

}  // namespace

extern "C" {

int host_robots() { return NMPC_NR; }

// as megasolve.cu::nmpc_k1_team_geometry
void host_k1_team_geometry(int* out) {
  out[0] = nmpc::kTeam;
  out[1] = nmpc::kRing;
  out[2] = 0;
}

int host_k1_team_ring_bytes(int rows, int n_mov, int pairs) {
  const int nc = nmpc::n_rows<NMPC_NR>(pairs != 0) + rows;
  return 4 * nmpc::TeamSlot<NMPC_NR>::ring_floats(nc, n_mov);
}

// K1's team design with the arguments of megasolve.cu::nmpc_inner_solve_team
// (no warps, no stream)
void host_inner_solve_team(const float* prm, const float* x0, const float* xref, const float* lam,
                           const float* mu, const float* Uin, float* Xs, float* U, float* cost,
                           int* iters, float* kff, float* Kfb, float* Xw, float* Uw, int B, int N,
                           int n_inner, int adaptive, int n_alphas, int ls_rounds, int pairs,
                           float reg, float armijo, float tol_cost, float ls_beta, float ls_grow,
                           float ls_trial_min, const float* mov, int n_obs, int n_mov,
                           int mov_stride) {
  const int rows = NMPC_NR * (n_obs + n_mov);
  const nmpc::WarpArgs a{prm, x0, xref, lam, mu, Uin, Xs, U, cost, iters, kff, Kfb, Xw, Uw,
                         B, N, n_inner, adaptive, n_alphas, ls_rounds, pairs,
                         host_k1_team_ring_bytes(rows, n_mov, pairs) / 4, reg, armijo, tol_cost,
                         ls_beta, ls_grow, ls_trial_min, mov, n_obs, n_mov, mov_stride};
  if (rows > 0)
    k1<true>(a);
  else
    k1<false>(a);
}

}  // extern "C"
