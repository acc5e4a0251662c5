// Host rehearsal of csrc/staged_tiles.cuh (K3 and K5, the tile design) and
// of the first designs in csrc/staged.cuh, for tests/test_torch_staged_tiles.py.
// Compiled by g++ with the library's geometry flags (ops/staged_tiles.py):
//   g++ -std=c++20 -O1 -shared -fPIC -pthread -ffp-contract=off
//       -DNMPC_NR=<m> -DNMPC_K3_S=... -I<csrc> staged_tiles_host.cpp
// A block runs as S T (K3) or A S (K5) std::threads with a std::barrier for
// __syncthreads; the ring's copies are plain loads (the header's
// NMPC_HOST_BLOCK shim), so every stage is complete when it is read.
#define NMPC_DEV inline
#define NMPC_HOST_BLOCK

#include <barrier>
#include <cstdint>
#include <thread>
#include <vector>

namespace nmpc {
thread_local std::barrier<>* g_block = nullptr;
inline void block_sync() { g_block->arrive_and_wait(); }
}  // namespace nmpc

#include "staged_tiles.cuh"

namespace {

using K3G = nmpc::K3Geom<NMPC_NR, NMPC_K3_S, NMPC_K3_D, NMPC_K3_T, NMPC_K3_P,
                         NMPC_K3_SPILL != 0>;
using K5G = nmpc::K5Geom<NMPC_NR, NMPC_K5_S, NMPC_K5_D>;

bool aligned(int B, std::initializer_list<const float*> ptrs) {
  if (B % 4) return false;
  for (const float* p : ptrs)
    if (reinterpret_cast<uintptr_t>(p) % 16) return false;
  return true;
}

// run body(tid) on `threads` threads sharing one barrier
template <class F>
void run_block(int threads, F body) {
  std::barrier<> bar(threads);
  std::vector<std::thread> pool;
  for (int tid = 0; tid < threads; ++tid)
    pool.emplace_back([&, tid] {
      nmpc::g_block = &bar;
      body(tid);
    });
  for (auto& t : pool) t.join();
}

}  // namespace

extern "C" {

void host_k3_geometry(int* out) {
  const int g[8] = {K3G::S, K3G::D, K3G::T, K3G::P, K3G::kSpill, K3G::threads,
                    static_cast<int>(K3G::smem_floats * sizeof(float)), K3G::scratch_floats};
  for (int i = 0; i < 8; ++i) out[i] = g[i];
}

void host_k5_geometry(int rows, int prm_size, int* out) {
  out[0] = K5G::S;
  out[1] = K5G::D;
  out[2] = K5G::max_alphas;
  out[3] = static_cast<int>(K5G::smem_floats(rows, prm_size) * sizeof(float));
}

int host_k5_rows(int pairs, int n_obs, int n_mov) {
  return nmpc::K5Rows<NMPC_NR>(pairs != 0, n_obs, n_mov).rows;
}

// K3, tile design (tiles = 1) or first design (tiles = 0)
void host_riccati(const float* A, const float* Bm, const float* lx, const float* lu,
                  const float* lxx, const float* luu, const float* lux, float* kff, float* Kfb,
                  float* dV1, int B, int N, float reg, int tiles) {
  const nmpc::RiccatiArgs a{A, Bm, lx, lu, lxx, luu, lux, kff, Kfb, dV1, B, N, reg};
  if (!tiles) {
    for (int b = 0; b < B; ++b) nmpc::riccati_thread<NMPC_NR>(a, b);
    return;
  }
  const int grid = (B + K3G::S - 1) / K3G::S;
  const bool vec = aligned(B, {A, Bm, lx, lu, lxx, luu, lux});
  std::vector<float> smem(K3G::smem_floats), scratch((size_t)grid * K3G::scratch_floats + 1);
  for (int blk = 0; blk < grid; ++blk)
    run_block(K3G::threads, [&](int tid) {
      nmpc::riccati_tiles<NMPC_NR, K3G>(a, smem.data(), scratch.data(), blk, vec, tid);
    });
}

// K5, tile design (tiles = 1) or first design (tiles = 0)
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
