// Host rehearsal of csrc/staged_tiles.cuh (K3 and K5) and
// csrc/expansions_rollout_tiles.cuh (K4 and K6), the tile designs, and of the
// first designs in csrc/staged.cuh, for tests/test_torch_staged_tiles.py.
// Compiled by g++ with the library's geometry flags (ops/staged_tiles.py):
//   g++ -std=c++20 -O1 -shared -fPIC -pthread -ffp-contract=off
//       -DNMPC_NR=<m> -DNMPC_K3_S=... -I<csrc> staged_tiles_host.cpp
// With -DNMPC_K3_N=<n> -DNMPC_K3_NU=<nu> (and K3's geometry at that shape,
// staged_tiles.k3_shape_flags) K3 runs at that stage shape instead;
// -DNMPC_K3_RTILE=1 builds K3's register-tile design (S scenarios a block,
// a ring of D tiles of their A | B; spilled, the slot and A | B in
// `scratch` and the products' staging buffers in `smem`).
// K4's and K5's device-memory forms (K4Device, K5Device: nothing in shared
// memory) run with `tiles` = 2.
// A block runs as S T (K3, K6), A S (K5) or 32 W (K4) lanes (tests/
// host_lanes.h: coroutines in the calling thread) with a barrier for
// __syncthreads; the copies are plain loads (the header's NMPC_HOST_BLOCK shim), so every stage
// is complete when it is read.
#define NMPC_DEV inline
#define NMPC_HOST_BLOCK

#include <cstdint>
#include <vector>

#include "host_lanes.h"

namespace nmpc {
thread_local host_lanes::Barrier* g_block = nullptr;
inline void block_sync() { host_lanes::wait(*g_block); }
}  // namespace nmpc

#include "expansions_rollout_tiles.cuh"

namespace {

#ifdef NMPC_K3_N
// K3 at another stage shape than the robot stacks' (riccati_shape.cu's):
// the first design (3m, 2m only) is not built
constexpr int kK3n = NMPC_K3_N, kK3nu = NMPC_K3_NU;
constexpr bool kK3First = false;
#else
constexpr int kK3n = 3 * NMPC_NR, kK3nu = 2 * NMPC_NR;
constexpr bool kK3First = true;
#endif
#ifndef NMPC_K3_RTILE
#define NMPC_K3_RTILE 0
#endif
using K3G = nmpc::K3Geom<kK3n, kK3nu, NMPC_K3_S, NMPC_K3_D, NMPC_K3_T, NMPC_K3_P,
                         NMPC_K3_SPILL != 0, NMPC_K3_RTILE != 0>;
using K5G = nmpc::K5Geom<NMPC_NR, NMPC_K5_S, NMPC_K5_D>;
using K4G = nmpc::K4Geom<NMPC_NR, NMPC_K4_S, NMPC_K4_W>;
using K6G = nmpc::K6Geom<NMPC_NR, NMPC_K6_S, NMPC_K6_D, NMPC_K6_T>;
using K4DM = nmpc::K4Device<NMPC_NR>;
using K5DM = nmpc::K5Device<NMPC_NR>;
// the device-memory form of K4 runs on this many slots of its scratch (fewer
// than its work items where N > 1 or B > 16, so that blocks take turns)
constexpr int kK4Slots = 3;

bool aligned(int B, std::initializer_list<const float*> ptrs) {
  if (B % 4) return false;
  for (const float* p : ptrs)
    if (reinterpret_cast<uintptr_t>(p) % 16) return false;
  return true;
}

// run body(tid) on `threads` lanes sharing one barrier
template <class F>
void run_block(int threads, F body) {
  host_lanes::Barrier bar(threads);
  nmpc::g_block = &bar;
  host_lanes::run(threads, body);
}

}  // namespace

extern "C" {

void host_k3_geometry(int* out) {
  const int g[8] = {K3G::S, K3G::D, K3G::T, K3G::P, K3G::kSpill, K3G::threads,
                    static_cast<int>(K3G::smem_floats * sizeof(float)), K3G::scratch_floats};
  for (int i = 0; i < 8; ++i) out[i] = g[i];
}

int host_k3_rtile() { return K3G::kRtile; }

void host_k5_geometry(int rows, int prm_size, int* out) {
  out[0] = K5G::S;
  out[1] = K5G::D;
  out[2] = K5G::max_alphas;
  out[3] = static_cast<int>(K5G::smem_floats(rows, prm_size) * sizeof(float));
}

int host_k5_rows(int pairs, int n_obs, int n_mov) {
  return nmpc::K5Rows<NMPC_NR>(pairs != 0, n_obs, n_mov).rows;
}

void host_k4_geometry(int rows, int prm_size, int* out) {
  out[0] = K4G::S;
  out[1] = K4G::W;
  out[2] = K4G::threads;
  out[3] = static_cast<int>(K4G::smem_floats(rows, prm_size) * sizeof(float));
}

int host_k4_rows(int pairs, int n_obs, int n_mov) {
  return nmpc::K4Rows<NMPC_NR>(pairs != 0, n_obs, n_mov).in;
}

void host_k4_device_geometry(int rows, int* out) {
  out[0] = K4DM::S;
  out[1] = K4DM::W;
  out[2] = K4DM::threads;
  out[3] = K4DM::scratch_floats(rows);
}

void host_k5_device_geometry(int* out) {
  out[0] = K5DM::S;
  out[1] = K5DM::D;
  out[2] = K5DM::max_alphas;
  out[3] = static_cast<int>(K5DM::smem_floats(0, 0) * sizeof(float));
}

void host_k6_geometry(int* out) {
  const int g[5] = {K6G::S, K6G::D, K6G::T, K6G::threads,
                    static_cast<int>(K6G::smem_floats * sizeof(float))};
  for (int i = 0; i < 5; ++i) out[i] = g[i];
}

// K4, tile design (tiles = 1), device-memory form (tiles = 2) or first
// design (tiles = 0)
void host_expansions(const float* prm, int prm_size, const float* Xs, const float* U,
                     const float* xref, const float* lam, const float* mu, const float* mov,
                     float* A, float* Bm, float* lx, float* lu, float* lxx, float* luu,
                     float* lux, int B, int N, int pairs, int n_obs, int n_mov, int tiles) {
  const nmpc::ExpArgs a{prm, Xs, U, xref, lam, mu, mov, A, Bm, lx, lu, lxx, luu, lux,
                        B, N, pairs, n_obs, n_mov};
  if (!tiles) {
    for (int k = 0; k < N; ++k)
      for (int b = 0; b < B; ++b) nmpc::expansion_thread<NMPC_NR>(a, prm, k, b);
    return;
  }
  const nmpc::K4Rows<NMPC_NR> rows(pairs != 0, n_obs, n_mov);
  const bool vec = aligned(B, {Xs, U, xref, lam, mu, n_mov ? mov : Xs, A, Bm, lx, lu, lxx, luu,
                               lux});
  if (tiles == 2) {
    // expansions_device_kernel: block i takes work items i, i + slots, ...
    // in its slot of the scratch; the blocks run one after another
    const int n_tiles = (B + K4DM::S - 1) / K4DM::S, work = n_tiles * N;
    const int slots = work < kK4Slots ? work : kK4Slots, bf = K4DM::scratch_floats(rows.in);
    std::vector<float> scratch((size_t)slots * bf + 4);
    float* base = scratch.data() + (4 - reinterpret_cast<uintptr_t>(scratch.data()) / 4 % 4) % 4;
    for (int blk = 0; blk < slots; ++blk)
      for (int w = blk; w < work; w += slots)
        run_block(K4DM::threads, [&](int tid) {
          nmpc::expansion_tiles<NMPC_NR, K4DM, true>(a, prm, base + (size_t)blk * bf,
                                                     w % n_tiles, w / n_tiles, vec, tid);
        });
    return;
  }
  std::vector<float> smem(K4G::smem_floats(rows.in, prm_size));
  const int nt = K4G::threads;
  for (int k = 0; k < N; ++k)
    for (int blk = 0; blk < (B + K4G::S - 1) / K4G::S; ++blk)
      run_block(nt, [&](int tid) {
        float* sp = smem.data();
        for (int i = tid; i < prm_size; i += nt) sp[i] = prm[i];
        nmpc::block_sync();
        nmpc::expansion_tiles<NMPC_NR, K4G>(a, sp, sp + nmpc::al4(prm_size), blk, k, vec, tid);
      });
}

// K6, tile design (tiles = 1) or first design (tiles = 0)
void host_rollout_alpha(const float* prm, const float* x0, const float* Xs, const float* U,
                        const float* kff, const float* Kfb, const float* alpha, float* Xout,
                        float* Uout, int B, int N, int tiles) {
  const nmpc::RolloutArgs a{prm, x0, Xs, U, kff, Kfb, alpha, Xout, Uout, B, N};
  const float dt = prm[nmpc::Dims<NMPC_NR>::dt];
  if (!tiles) {
    for (int b = 0; b < B; ++b) nmpc::rollout_thread<NMPC_NR>(a, dt, b);
    return;
  }
  const bool vec = aligned(B, {Xs, U, kff, Kfb});
  std::vector<float> smem(K6G::smem_floats);
  for (int blk = 0; blk < (B + K6G::S - 1) / K6G::S; ++blk)
    run_block(K6G::threads, [&](int tid) {
      nmpc::rollout_tiles<NMPC_NR, K6G>(a, dt, smem.data(), blk, vec, tid);
    });
}

// K3, tile design (tiles = 1) or first design (tiles = 0)
void host_riccati(const float* A, const float* Bm, const float* lx, const float* lu,
                  const float* lxx, const float* luu, const float* lux, float* kff, float* Kfb,
                  float* dV1, int B, int N, float reg, int tiles) {
  const nmpc::RiccatiArgs a{A, Bm, lx, lu, lxx, luu, lux, kff, Kfb, dV1, B, N, reg};
  if (!tiles) {
    if constexpr (kK3First)
      for (int b = 0; b < B; ++b) nmpc::riccati_thread<NMPC_NR>(a, b);
    return;
  }
  const int grid = (B + K3G::S - 1) / K3G::S;
  const bool vec = aligned(B, {A, Bm, lx, lu, lxx, luu, lux});
  std::vector<float> smem(K3G::smem_floats), scratch((size_t)grid * K3G::scratch_floats + 1);
  for (int blk = 0; blk < grid; ++blk)
    run_block(K3G::threads, [&](int tid) {
      nmpc::riccati_tiles<K3G>(a, smem.data(), scratch.data(), blk, vec, tid);
    });
}

// K5, tile design (tiles = 1), device-memory form (tiles = 2) or first
// design (tiles = 0)
void host_linesearch_costs(const float* prm, int prm_size, const float* x0, const float* Xs,
                           const float* U, const float* kff, const float* Kfb, const float* xref,
                           const float* lam, const float* mu, const float* mov, float* costs,
                           int B, int N, int n_alphas, int pairs, int n_obs, int n_mov,
                           int tiles) {
  const nmpc::CostArgs a{prm, x0, Xs, U, kff, Kfb, xref, lam, mu, mov, costs,
                         B, N, n_alphas, pairs, n_obs, n_mov};
  if (!tiles) {
    for (int ai = 0; ai < n_alphas; ++ai)
      for (int b = 0; b < B; ++b) nmpc::linesearch_cost_thread<NMPC_NR>(a, prm, ai, b);
    return;
  }
  if (tiles == 2 || K5G::D == 0) {   // a library whose K5 geometry is D = 0 launches this
    const int nt = n_alphas * K5DM::S;
    for (int blk = 0; blk < (B + K5DM::S - 1) / K5DM::S; ++blk)
      run_block(nt, [&](int tid) {
        nmpc::linesearch_tiles<NMPC_NR, K5DM>(a, prm, nullptr, blk, false, tid, nt);
      });
    return;
  }
  const int rows = nmpc::K5Rows<NMPC_NR>(pairs != 0, n_obs, n_mov).rows;
  const bool vec = aligned(B, {Xs, U, kff, Kfb, xref, lam, n_mov ? mov : Xs});
  std::vector<float> smem(K5G::smem_floats(rows, prm_size));
  const int nt = n_alphas * K5G::S;
  for (int blk = 0; blk < (B + K5G::S - 1) / K5G::S; ++blk)
    run_block(nt, [&](int tid) {
      float* sp = smem.data();
      for (int i = tid; i < prm_size; i += nt) sp[i] = prm[i];
      nmpc::block_sync();
      nmpc::linesearch_tiles<NMPC_NR, K5G>(a, sp, sp + nmpc::al4(prm_size), blk, vec, tid, nt);
    });
}

}  // extern "C"
