// K3 (Riccati sweep) and K5 (line-search merits) of the staged AL-iLQR path,
// redesigned for Hopper: a block owns a tile of S consecutive scenarios and
// streams the horizon through a ring of stage tiles in shared memory.
//
// Replaces the first designs of csrc/staged.cuh, riccati_thread and
// linesearch_cost_thread (one thread per scenario reading device memory
// directly; still built, by csrc/staged_first.cu, as the A/B baselines of
// tools/staged_launch.py), which in turn replace nmpc_tpu/ops/
// riccati_pallas.py::riccati_lanes and rollout_pallas.py::
// linesearch_costs_lanes. What held them back on an H100:
//  * K3: one thread per scenario is 1,024 warps at B=32768, ~8 per SM;
//    every load of a stage went to device memory in a dependent chain
//    (~15 round trips a stage), nothing of the next stage was requested
//    early, and from m=3 up Vxx, Vxx A, W and Quu lived on the thread's
//    stack (4,384 B at m=6). It was bound by latency, not bytes.
//  * K5: each of the A alpha rows of the grid re-read the whole trajectory
//    of stage data (A times the bytes of its bound), one dependent round
//    trip a stage.
//
// This design:
//  * Inputs stay lane-major ([N, rows, B], batch innermost, as K4 writes
//    them). A stage tile is the stage's rows for the block's S scenarios,
//    [rows, P] with P >= S, cut from the 2-D view [N rows, B] of each input,
//    so its copies read whole 32-byte sectors (S is a power of two >= 8).
//  * The ring (stream_stages): D >= 2 stage tiles. While stage k computes,
//    stages k+1..k+D-1 (K5; K3 walks backwards: k-1..k-D+1) are being
//    copied by cp.async; a slot is refilled only after a __syncthreads that
//    follows its last read. Rows that are 16-byte aligned (B % 4 == 0,
//    aligned base, a whole tile, P = S) go as 16-byte copies, the rest as
//    4-byte copies with the ragged tile's missing scenarios zero-filled;
//    outputs of a ragged tile are masked.
//  * K3: each scenario of the tile is run by a team of T lanes (T = 1 for
//    m <= 2: every block in registers, loops fully unrolled, no stack; T > 1
//    from m = 3: Vxx, (Vxx A)', (Vxx B)' (later Kfb'), Qux and Quu in a
//    per-team slot of shared memory, the blocks that a lane produces by
//    column stored transposed so that every inner loop reads a row as float4
//    broadcasts). Lanes compute whole output entries, each entry's sum over l
//    in the first design's order, so K3's outputs are the first design's
//    bit for bit: no sum is reordered. The nu x nu Cholesky stays serial
//    (the team's lane 0, unrolled); the 1 + n substitutions go one per lane.
//    kff and Kfb leave through an output tile, so their stores are
//    coalesced. A team's lanes read down a tile column: the pitch P = S + 1
//    (odd) avoids bank conflicts at the price of 4-byte copies, P = S keeps
//    16-byte copies; the sweep picks per m. At m=10 two stage tiles fill the
//    shared memory, and the slots and the output tile go to a per-block
//    device-memory scratch (kSpill).
//  * K5: one block runs all A candidates of its S scenarios (A S threads,
//    thread (ai, s) at ai S + s); each stage tile is fetched from device
//    memory once and read by all A candidates (a broadcast), so device
//    traffic falls to what the bound counts. Each thread runs feedback_u,
//    stage_merit and euler_rows of rollout.cuh unchanged, on the tile with
//    stride P: each merit is summed in the first design's order, bit for
//    bit.
// What bounds them now (measured on an H100 80GB HBM3 at 700 W, PERF.md):
// K3 at m=1 reaches 75% of its bytes bound; from m=5 one block of eight
// teams fills an SM's shared memory, and the serial Cholesky and the
// dependent dot chains between block barriers hold K3 near 18% of its
// bound at m=6. K5 at 15-30%: its merit code's instructions and two block
// barriers a stage.
// S, D, T, P and the spill per m are compile-time constants, picked by
// `python -m nmpc_tpu_torch.tools.staged_launch` and passed by
// ops/cuda_build.py from ops/staged_tiles.py (-DNMPC_K3_S, ...).
//
// Host rehearsal: with NMPC_HOST_BLOCK defined, the harness provides
// block_sync() (a barrier of the block's threads), and the copies are plain
// loads; the bodies take the thread index and count as arguments.
#pragma once

#include <stdint.h>

#include "riccati.cuh"
#include "staged.cuh"

// what both the host side of a launch and the device code compute
#ifndef NMPC_HOST_BLOCK
#define NMPC_HD __host__ __device__
#else
#define NMPC_HD
#endif

namespace nmpc {

#ifndef NMPC_HOST_BLOCK
NMPC_DEV void block_sync() { __syncthreads(); }

// 4 bytes from global to shared; src_size 0 fills zeros (valid = false)
NMPC_DEV void cp_async4(float* dst, const float* src, bool valid) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d), "l"(src),
               "r"(valid ? 4 : 0)
               : "memory");
}

// 16 bytes, both addresses 16-byte aligned
NMPC_DEV void cp_async16(float* dst, const float* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d), "l"(src) : "memory");
}

NMPC_DEV void cp_commit() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }

// wait until at most N of this thread's committed groups are in flight
template <int N>
NMPC_DEV void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}
#else
inline void cp_async4(float* dst, const float* src, bool valid) { *dst = valid ? *src : 0.f; }
inline void cp_async16(float* dst, const float* src) {
  for (int i = 0; i < 4; ++i) dst[i] = src[i];
}
inline void cp_commit() {}
template <int N>
inline void cp_wait() {}
#endif

// The block's view of one stage of the batch: its first scenario b0, how
// many of its S columns are real (the last tile may be ragged), and whether
// every row segment may go as 16-byte copies.
struct TileSpan {
  int b0, width;
  bool vec;
};

// Copy rows row0..row0+R-1 of a lane-major [*, B] array, columns b0.., into
// the tile rows dst[r P + j]. Threads tid, tid + nt, ... share the work:
// 16-byte chunks where the rows are aligned and the tile whole (P = S),
// else single floats, zero-filled past a ragged tile's edge.
template <int S, int P>
NMPC_DEV void copy_rows(float* dst, const float* src, size_t row0, int R, size_t B,
                        const TileSpan& t, int tid, int nt) {
  if (P == S && t.vec && t.width == S) {
    constexpr int Q = S / 4;  // 16-byte chunks per row
    for (int c = tid; c < R * Q; c += nt) {
      const int r = c / Q, q = c % Q;
      cp_async16(dst + r * P + 4 * q, src + (row0 + r) * B + t.b0 + 4 * q);
    }
  } else {
    for (int e = tid; e < R * S; e += nt) {
      const int r = e / S, j = e % S;
      const bool ok = j < t.width;
      cp_async4(dst + r * P + j, src + (row0 + r) * B + t.b0 + (ok ? j : 0), ok);
    }
  }
}

// The ring: D tiles of `tile` floats each. issue(k, slot) starts the copies
// of stage k into a slot; body(k, slot) computes stage k from it. Stages run
// forward (K5) or backward (K3); every thread of the block calls this with
// the same N, so the barriers are uniform.
template <int D, class Issue, class Body>
NMPC_DEV void stream_stages(int N, bool backward, float* ring, int tile, Issue&& issue,
                            Body&& body) {
  static_assert(D >= 2, "a ring of at least two stage tiles");
  auto stage = [&](int i) { return backward ? N - 1 - i : i; };
  for (int i = 0; i < D - 1; ++i) {
    if (i < N) issue(stage(i), ring + (i % D) * tile);
    cp_commit();
  }
  for (int i = 0; i < N; ++i) {
    const int j = i + D - 1;  // refills slot (i - 1) % D: read before the last barrier
    if (j < N) issue(stage(j), ring + (j % D) * tile);
    cp_commit();
    cp_wait<D - 1>();  // this thread's copies of stage i have landed
    block_sync();      // and everyone's
    body(stage(i), ring + (i % D) * tile);
    block_sync();      // slot i % D is free for iteration i + 1
  }
}

// Store rows row0..row0+R-1 of a lane-major [*, B] output, columns b0..,
// from the tile rows src[r P + j]; the ragged tile's missing columns are
// skipped. Consecutive threads store consecutive scenarios.
template <int S, int P>
NMPC_DEV void store_rows(float* dst, size_t row0, int R, size_t B, const TileSpan& t,
                         const float* src, int tid, int nt) {
  for (int e = tid; e < R * S; e += nt) {
    const int r = e / S, j = e % S;
    if (j < t.width) dst[(row0 + r) * B + t.b0 + j] = src[r * P + j];
  }
}

NMPC_HD constexpr int al4(int v) { return (v + 3) / 4 * 4; }

// M consecutive floats from a 16-byte aligned address as float4 loads (the
// last chunk may read up to three floats past M, within the padded block)
template <int M>
NMPC_DEV void load4(const float* src, float* dst) {
#pragma unroll
  for (int q = 0; q < al4(M) / 4; ++q) {
#ifdef NMPC_HOST_BLOCK
    const float v[4] = {src[4 * q], src[4 * q + 1], src[4 * q + 2], src[4 * q + 3]};
#else
    const float4 f = reinterpret_cast<const float4*>(src)[q];
    const float v[4] = {f.x, f.y, f.z, f.w};
#endif
#pragma unroll
    for (int i = 0; i < 4; ++i)
      if (4 * q + i < M) dst[4 * q + i] = v[i];
  }
}

// ---------------------------------------------------------------------------
// K3: the backward Riccati sweep
// ---------------------------------------------------------------------------

// Rows of K3's stage tile (inputs) and of its output tile.
template <int NR>
struct K3Rows {
  static constexpr int n = 3 * NR, nu = 2 * NR;
  static constexpr int A = 0;                // (l, j) at row A + l n + j
  static constexpr int Bm = A + n * n;       // (l, c) at row Bm + l nu + c
  static constexpr int lx = Bm + n * nu;
  static constexpr int lu = lx + n;
  static constexpr int lxx = lu + nu;
  static constexpr int luu = lxx + n * n;
  static constexpr int lux = luu + nu * nu;
  static constexpr int rows = lux + nu * n;  // 3,450 at m=10
  static constexpr int kff = 0;              // output tile: kff [nu], Kfb [nu, n]
  static constexpr int Kfb = nu;
  static constexpr int out = nu + nu * n;
};

// One team's slot (T > 1), in floats. The blocks that phases 2 and 5 read
// by rows are kept transposed where a lane produces a column, so every
// inner loop reads a row of 16-byte aligned floats as float4 broadcasts;
// rows are padded to ld (n) or ldu (nu).
template <int NR>
struct K3Slot {
  static constexpr int n = 3 * NR, nu = 2 * NR, ld = al4(n), ldu = al4(nu);
  static constexpr int V = 0;                      // Vxx [n, ld]; Qxx from phase 2 on
  static constexpr int VAT = al4(V + n * ld);      // (Vxx A)' [n, ld]
  static constexpr int WT = al4(VAT + n * ld);     // (Vxx B)' [nu, ld]; then Kfb' [n, ldu]
  static constexpr int Qux = al4(WT + (nu * ld > n * ldu ? nu * ld : n * ldu));  // [nu, n]
  static constexpr int Quu = al4(Qux + nu * n);    // [nu, nu], then its factor
  static constexpr int Vx = al4(Quu + nu * nu);    // [ld]
  static constexpr int Qx = al4(Vx + ld);
  static constexpr int Qu = al4(Qx + n);
  static constexpr int kf = al4(Qu + nu);          // [ldu]
  static constexpr int inv = al4(kf + ldu);
  static constexpr int floats = al4(inv + nu);
};

// K3's launch geometry: S scenarios a block, D stage tiles in the ring, T
// lanes a scenario, tile pitch P (S, or S + 1 where lanes read down a
// column), kSpill: the output tile and the slots in a device-memory scratch
// of the wrapper's (per block, so L2 holds the resident blocks') where they
// do not fit beside the ring.
template <int NR, int S_, int D_, int T_, int P_, bool kSpill_>
struct K3Geom {
  static constexpr int S = S_, D = D_, T = T_, P = P_, threads = S * T;
  static constexpr bool kSpill = kSpill_;
  static_assert(S >= 8 && (S & (S - 1)) == 0, "S: a power of two >= 8");
  static_assert(T == 1 || (T <= 32 && 32 % T == 0), "a team within one warp");
  static_assert(P == S || P == S + 1, "pitch");
  static constexpr int tile = al4(K3Rows<NR>::rows * P);
  static constexpr int out = al4(K3Rows<NR>::out * P);
  static constexpr int priv = out + (T > 1 ? S * K3Slot<NR>::floats : 0);
  static constexpr int smem_floats = D * tile + (kSpill ? 0 : priv);
  static constexpr int scratch_floats = kSpill ? priv : 0;  // per block
};

// Unrolled copies of riccati.cuh's chol, chol_solve and mtm_add: the same
// arithmetic in the same order, with every index known to the compiler
// (register arrays stay in registers; loads from shared memory are issued
// ahead of the dependent chain).
template <int M>
NMPC_DEV void chol_unrolled(float* A, float reg, float* inv) {
#pragma unroll
  for (int i = 0; i < M; ++i) {
#pragma unroll
    for (int j = i; j < M; ++j) {
      float v = A[j * M + i];
#pragma unroll
      for (int k = 0; k < i; ++k) v = v - A[j * M + k] * A[i * M + k];
      A[j * M + i] = v;
    }
    const float d = sqrtf(A[i * M + i] + reg);
    const float iv = 1.f / d;
    inv[i] = iv;
    A[i * M + i] = d;
#pragma unroll
    for (int j = i + 1; j < M; ++j) A[j * M + i] = A[j * M + i] * iv;
  }
}

template <int M>
NMPC_DEV void chol_solve_unrolled(const float* L, const float* inv, float* y) {
#pragma unroll
  for (int i = 0; i < M; ++i) {
    float s = y[i];
#pragma unroll
    for (int k = 0; k < i; ++k) s = s - L[i * M + k] * y[k];
    y[i] = s * inv[i];
  }
#pragma unroll
  for (int i = M - 1; i >= 0; --i) {
    float s = y[i];
#pragma unroll
    for (int k = i + 1; k < M; ++k) s = s - L[k * M + i] * y[k];
    y[i] = s * inv[i];
  }
}

template <int R, int A, int C>
NMPC_DEV void mtm_add_unrolled(const float* X, const float* Y, float* out) {
#pragma unroll
  for (int a = 0; a < A; ++a) {
#pragma unroll
    for (int c = 0; c < C; ++c) {
      float acc = X[a] * Y[c];
#pragma unroll
      for (int k = 1; k < R; ++k) acc = acc + X[k * A + a] * Y[k * C + c];
      out[a * C + c] = out[a * C + c] + acc;
    }
  }
}

// T = 1: one thread's scenario with every block in registers. riccati_thread
// (staged.cuh) with its loops unrolled and its inputs read from the tile
// (t: the thread's column of the stage tile, rows P apart); kff and Kfb go
// to the thread's column o of the output tile.
template <int NR, int P>
struct RiccatiRegs {
  static constexpr int n = 3 * NR, nu = 2 * NR;
  using R = K3Rows<NR>;
  float Vx[n], Vxx[n * n], dV1;

  NMPC_DEV void init() {
#pragma unroll
    for (int i = 0; i < n; ++i) Vx[i] = 0.f;
#pragma unroll
    for (int i = 0; i < n * n; ++i) Vxx[i] = 0.f;
    dV1 = 0.f;
  }

  NMPC_DEV void stage(const float* t, float* o, float reg) {
    float VA[n * n], W[n * nu], Quu[nu * nu], Qx[n], Qu[nu], kf[nu], inv[nu], col[nu];
    const float* A = t + R::A * P;  // (l, j) at [(l n + j) P]
    const float* Bm = t + R::Bm * P;
#pragma unroll
    for (int j = 0; j < n; ++j) {
      float aj[n];
#pragma unroll
      for (int l = 0; l < n; ++l) aj[l] = A[(l * n + j) * P];
      float acc = aj[0] * Vx[0];
#pragma unroll
      for (int l = 1; l < n; ++l) acc = acc + aj[l] * Vx[l];
      Qx[j] = t[(R::lx + j) * P] + acc;
#pragma unroll
      for (int i = 0; i < n; ++i) {
        float s = Vxx[i * n] * aj[0];
#pragma unroll
        for (int l = 1; l < n; ++l) s = s + Vxx[i * n + l] * aj[l];
        VA[i * n + j] = s;
      }
    }
#pragma unroll
    for (int c = 0; c < nu; ++c) {
      float bcol[n];
#pragma unroll
      for (int l = 0; l < n; ++l) bcol[l] = Bm[(l * nu + c) * P];
      float acc = bcol[0] * Vx[0];
#pragma unroll
      for (int l = 1; l < n; ++l) acc = acc + bcol[l] * Vx[l];
      Qu[c] = t[(R::lu + c) * P] + acc;
#pragma unroll
      for (int i = 0; i < n; ++i) {
        float s = Vxx[i * n] * bcol[0];
#pragma unroll
        for (int l = 1; l < n; ++l) s = s + Vxx[i * n + l] * bcol[l];
        W[i * nu + c] = s;
      }
    }
#pragma unroll
    for (int r = 0; r < nu; ++r) {
#pragma unroll
      for (int c = 0; c < nu; ++c) {
        float s = Bm[r * P] * W[c];
#pragma unroll
        for (int l = 1; l < n; ++l) s = s + Bm[(l * nu + r) * P] * W[l * nu + c];
        Quu[r * nu + c] = t[(R::luu + r * nu + c) * P] + s;
      }
    }
#pragma unroll
    for (int i = 0; i < n; ++i) {
#pragma unroll
      for (int j = 0; j < n; ++j) {
        float s = A[i * P] * VA[j];
#pragma unroll
        for (int l = 1; l < n; ++l) s = s + A[(l * n + i) * P] * VA[l * n + j];
        Vxx[i * n + j] = t[(R::lxx + i * n + j) * P] + s;
      }
    }
#pragma unroll
    for (int r = 0; r < nu; ++r) {
#pragma unroll
      for (int j = 0; j < n; ++j) {
        float s = Bm[r * P] * VA[j];
#pragma unroll
        for (int l = 1; l < n; ++l) s = s + Bm[(l * nu + r) * P] * VA[l * n + j];
        W[r * n + j] = t[(R::lux + r * n + j) * P] + s;
      }
    }
    chol_unrolled<nu>(Quu, reg, inv);
#pragma unroll
    for (int i = 0; i < nu; ++i) kf[i] = Qu[i];
    chol_solve_unrolled<nu>(Quu, inv, kf);
#pragma unroll
    for (int i = 0; i < nu; ++i) {
      kf[i] = -kf[i];
      o[(R::kff + i) * P] = kf[i];
    }
#pragma unroll
    for (int c = 0; c < n; ++c) {
#pragma unroll
      for (int i = 0; i < nu; ++i) col[i] = W[i * n + c];
      chol_solve_unrolled<nu>(Quu, inv, col);
#pragma unroll
      for (int i = 0; i < nu; ++i) {
        VA[i * n + c] = -col[i];
        o[(R::Kfb + i * n + c) * P] = -col[i];
      }
    }
    float s = 0.f;
#pragma unroll
    for (int i = 0; i < nu; ++i) s += kf[i] * Qu[i];
    dV1 = dV1 + s;
#pragma unroll
    for (int j = 0; j < n; ++j) Vx[j] = Qx[j];
    mtm_add_unrolled<nu, n, 1>(W, kf, Vx);
    mtm_add_unrolled<nu, n, n>(W, VA, Vxx);
  }
};


// T > 1: one stage of a team's scenario. t: the scenario's column of the
// stage tile (rows P apart); o: its column of the output tile; sl: its slot.
// Lanes take whole output entries, each summed over l in riccati_thread's
// order, so K3's outputs are the first design's bit for bit; the phases are
// separated by block barriers (every team of the block runs the same stage).
template <int NR, int T, int P>
NMPC_DEV void riccati_team_stage(const float* t, float* o, float* sl, int lane, float reg,
                                 float& dV1) {
  using R = K3Rows<NR>;
  using L = K3Slot<NR>;
  constexpr int n = L::n, nu = L::nu, ld = L::ld, ldu = L::ldu;
  // 1: a column of A or of B per lane: Qx = lx + A'Vx or Qu = lu + B'Vx,
  //    and that column of Vxx A or Vxx B, stored as a row of (Vxx A)' or
  //    (Vxx B)' (the rows of Vxx read as float4 broadcasts)
  for (int c = lane; c < n + nu; c += T) {
    const bool isA = c < n;
    const int j = isA ? c : c - n, w = isA ? n : nu;
    const float* src = t + ((isA ? R::A : R::Bm) + j) * P;  // (l, j) at src[l w P]
    float col[n], vx[n];
#pragma unroll
    for (int l = 0; l < n; ++l) col[l] = src[l * w * P];
    load4<n>(sl + L::Vx, vx);
    float acc = col[0] * vx[0];
#pragma unroll
    for (int l = 1; l < n; ++l) acc = acc + col[l] * vx[l];
    sl[(isA ? L::Qx : L::Qu) + j] = t[((isA ? R::lx : R::lu) + j) * P] + acc;
    float* dst = sl + (isA ? L::VAT : L::WT) + j * ld;
#pragma unroll 2
    for (int i = 0; i < n; ++i) {
      float row[n];
      load4<n>(sl + L::V + i * ld, row);
      float s = row[0] * col[0];
#pragma unroll
      for (int l = 1; l < n; ++l) s = s + row[l] * col[l];
      dst[i] = s;
    }
  }
  block_sync();
  // 2: a row per lane. Row i of A' (a column of A): Qxx row i = lxx + A(:, i)'
  //    (Vxx A), into Vxx; row r of B': Qux row r = lux + B(:, r)'(Vxx A) and
  //    Quu row r = luu + B(:, r)'(Vxx B). One loop over a lane's dots, each
  //    against a row of (Vxx A)' or (Vxx B)', so the two kinds of lane do not
  //    diverge.
  for (int c = lane; c < n + nu; c += T) {
    const bool isA = c < n;
    const int i = isA ? c : c - n, w = isA ? n : nu;
    const float* src = t + ((isA ? R::A : R::Bm) + i) * P;  // (l, i) at src[l w P]
    float col[n];
#pragma unroll
    for (int l = 0; l < n; ++l) col[l] = src[l * w * P];
    const int dots = isA ? n : n + nu;
#pragma unroll 2
    for (int q = 0; q < dots; ++q) {
      const bool vq = q < n;                       // against (Vxx A)' row q, else (Vxx B)'
      float row[n];
      load4<n>(sl + (vq ? L::VAT + q * ld : L::WT + (q - n) * ld), row);
      float s = col[0] * row[0];
#pragma unroll
      for (int l = 1; l < n; ++l) s = s + col[l] * row[l];
      const int e = isA ? R::lxx + i * n + q : vq ? R::lux + i * n + q : R::luu + i * nu + q - n;
      const int at = isA ? L::V + i * ld + q : vq ? L::Qux + i * n + q : L::Quu + i * nu + q - n;
      sl[at] = t[e * P] + s;
    }
  }
  block_sync();
  // 3: the Cholesky factor of Quu + reg I, serial
  if (lane == 0) chol_unrolled<nu>(sl + L::Quu, reg, sl + L::inv);
  block_sync();
  // 4: the 1 + n substitutions, one right-hand side per lane: kff from Qu,
  //    column c of Kfb from column c of Qux, stored as row c of Kfb'
  for (int c = lane; c <= n; c += T) {
    float y[nu];
#pragma unroll
    for (int i = 0; i < nu; ++i) y[i] = c == 0 ? sl[L::Qu + i] : sl[L::Qux + i * n + c - 1];
    chol_solve_unrolled<nu>(sl + L::Quu, sl + L::inv, y);
    if (c == 0) {
#pragma unroll
      for (int i = 0; i < nu; ++i) {
        y[i] = -y[i];
        sl[L::kf + i] = y[i];
        o[(R::kff + i) * P] = y[i];
      }
    } else {
#pragma unroll
      for (int i = 0; i < nu; ++i) {
        sl[L::WT + (c - 1) * ldu + i] = -y[i];
        o[(R::Kfb + i * n + c - 1) * P] = -y[i];
      }
    }
  }
  block_sync();
  // 5: a row a of Vxx per lane: Vxx(a, c) = Qxx(a, c) + Qux(:, a)' Kfb(:, c)
  //    against the rows of Kfb', then Vx(a) = Qx(a) + Qux(:, a)' kff; lane 0
  //    also dV1 += kff . Qu
  for (int a = lane; a < n; a += T) {
    float qa[nu];
#pragma unroll
    for (int k = 0; k < nu; ++k) qa[k] = sl[L::Qux + k * n + a];
#pragma unroll 2
    for (int c = 0; c <= n; ++c) {
      float kr[nu];
      load4<nu>(sl + (c < n ? L::WT + c * ldu : L::kf), kr);
      float acc = qa[0] * kr[0];
#pragma unroll
      for (int k = 1; k < nu; ++k) acc = acc + qa[k] * kr[k];
      const int at = c < n ? L::V + a * ld + c : L::Vx + a;
      sl[at] = sl[c < n ? at : L::Qx + a] + acc;
    }
  }
  if (lane == 0) {
    float s = 0.f;
#pragma unroll
    for (int i = 0; i < nu; ++i) s += sl[L::kf + i] * sl[L::Qu + i];
    dV1 = dV1 + s;
  }
}

// K3 for the block of tile `blk`: S scenarios, S T threads (thread tid is
// lane tid % T of scenario tid / T). smem: G::smem_floats of dynamic shared
// memory; scratch: G::scratch_floats per block of device memory (kSpill).
template <int NR, class G>
NMPC_DEV void riccati_tiles(const RiccatiArgs& a, float* smem, float* scratch, int blk,
                            bool vec, int tid) {
  using R = K3Rows<NR>;
  using L = K3Slot<NR>;
  constexpr int n = R::n, nu = R::nu, S = G::S, T = G::T, P = G::P, nt = G::threads;
  const size_t B = a.B;
  const TileSpan span{blk * S, a.B - blk * S < S ? a.B - blk * S : S, vec};
  float* priv = G::kSpill ? scratch + (size_t)blk * G::scratch_floats : smem + G::D * G::tile;
  float* out = priv;
  const int s = tid / T, lane = tid % T;
  auto issue = [&](int k, float* t) {
    copy_rows<S, P>(t + R::A * P, a.A, (size_t)k * n * n, n * n, B, span, tid, nt);
    copy_rows<S, P>(t + R::Bm * P, a.Bm, (size_t)k * n * nu, n * nu, B, span, tid, nt);
    copy_rows<S, P>(t + R::lx * P, a.lx, (size_t)k * n, n, B, span, tid, nt);
    copy_rows<S, P>(t + R::lu * P, a.lu, (size_t)k * nu, nu, B, span, tid, nt);
    copy_rows<S, P>(t + R::lxx * P, a.lxx, (size_t)k * n * n, n * n, B, span, tid, nt);
    copy_rows<S, P>(t + R::luu * P, a.luu, (size_t)k * nu * nu, nu * nu, B, span, tid, nt);
    copy_rows<S, P>(t + R::lux * P, a.lux, (size_t)k * nu * n, nu * n, B, span, tid, nt);
  };
  auto store = [&](int k) {
    store_rows<S, P>(a.kff, (size_t)k * nu, nu, B, span, out + R::kff * P, tid, nt);
    store_rows<S, P>(a.Kfb, (size_t)k * nu * n, nu * n, B, span, out + R::Kfb * P, tid, nt);
  };
  float dV1 = 0.f;
  if constexpr (T == 1) {
    RiccatiRegs<NR, P> st;
    st.init();
    stream_stages<G::D>(a.N, true, smem, G::tile, issue, [&](int k, const float* t) {
      st.stage(t + s, out + s, a.reg);
      block_sync();
      store(k);
    });
    dV1 = st.dV1;
  } else {
    float* sl = priv + G::out + s * L::floats;
    for (int i = lane; i < n * L::ld; i += T) sl[L::V + i] = 0.f;
    for (int i = lane; i < L::ld; i += T) sl[L::Vx + i] = 0.f;
    stream_stages<G::D>(a.N, true, smem, G::tile, issue, [&](int k, const float* t) {
      riccati_team_stage<NR, T, P>(t + s, out + s, sl, lane, a.reg, dV1);
      store(k);
    });
  }
  if (lane == 0 && s < span.width) a.dV1[span.b0 + s] = dV1;
}

// ---------------------------------------------------------------------------
// K5: the line-search merits
// ---------------------------------------------------------------------------

// Rows of K5's stage tile: Xs [n], U [nu], kff [nu], Kfb [nu, n], xref [n],
// lam [nc], mov [2 n_mov] (nc and n_mov are the launch's).
template <int NR>
struct K5Rows {
  static constexpr int n = 3 * NR, nu = 2 * NR;
  static constexpr int Xs = 0, U = n, kff = n + nu, Kfb = n + 2 * nu, xref = Kfb + nu * n,
                       lam = xref + n;
  int nc, mov, rows;
  // nc: staged_rows (staged.cuh), the c >= 0 rows of one stage
  NMPC_HD K5Rows(bool pairs, int n_obs, int n_mov)
      : nc((pairs ? NR * (NR - 1) / 2 : 0) + 2 * nu + 2 * n + NR * (n_obs + n_mov)),
        mov(lam + nc),
        rows(lam + nc + 2 * n_mov) {}
};

// K5's launch geometry: S scenarios a block (its rows are read by whole
// warps of consecutive scenarios, so P = S), D stage tiles in the ring; a
// block of A S threads, at most kThreads.
template <int NR, int S_, int D_>
struct K5Geom {
  static constexpr int S = S_, D = D_, kThreads = 512;
  static_assert(S >= 8 && (S & (S - 1)) == 0, "S: a power of two >= 8");
  static_assert(D >= 2, "a ring of at least two stage tiles");
  static constexpr int max_alphas = kThreads / S;
  // floats of dynamic shared memory: the parameter block, then the ring
  NMPC_HD static int smem_floats(int rows, int prm_size) {
    return al4(prm_size) + D * al4(rows * S);
  }
};

// K5 for the block of tile `blk`: thread tid is candidate tid / S of
// scenario tid % S; sp: the parameter block in shared memory, ring after it.
// Each thread runs linesearch_cost_thread's loop on the tile (stride S).
template <int NR, class G>
NMPC_DEV void linesearch_tiles(const CostArgs& a, const float* sp, float* ring, int blk,
                               bool vec, int tid, int nt) {
  using Dm = Dims<NR>;
  constexpr int n = Dm::n, nu = Dm::nu, S = G::S, P = G::S;
  const size_t B = a.B;
  const TileSpan span{blk * S, a.B - blk * S < S ? a.B - blk * S : S, vec};
  const bool pairs = a.pairs != 0;
  const K5Rows<NR> R(pairs, a.n_obs, a.n_mov);
  const int nc = R.nc;
  const int tile = al4(R.rows * S);
  const int ai = tid / S, s = tid % S;
  const bool live = s < span.width;
  const size_t b = span.b0 + (live ? s : 0);
  const float dt = sp[Dm::dt];
  const float alpha = sp[Dm::alphas + 3 * a.n_obs + ai];
  const float mu = a.mu[b];
  ObsRows ob;
  ob.n_obs = a.n_obs;
  ob.n_mov = a.n_mov;
  ob.obs = sp + Dm::alphas;
  float x[n], xb[n], ub[nu], kf[nu], u[nu];
#pragma unroll
  for (int i = 0; i < n; ++i) x[i] = a.x0[(size_t)i * B + b];
  float cost = 0.f;
  auto issue = [&](int k, float* t) {
    copy_rows<S, P>(t + R.Xs * P, a.Xs, (size_t)k * n, n, B, span, tid, nt);
    copy_rows<S, P>(t + R.U * P, a.U, (size_t)k * nu, nu, B, span, tid, nt);
    copy_rows<S, P>(t + R.kff * P, a.kff, (size_t)k * nu, nu, B, span, tid, nt);
    copy_rows<S, P>(t + R.Kfb * P, a.Kfb, (size_t)k * nu * n, nu * n, B, span, tid, nt);
    copy_rows<S, P>(t + R.xref * P, a.xref, (size_t)k * n, n, B, span, tid, nt);
    copy_rows<S, P>(t + R.lam * P, a.lam, (size_t)k * nc, nc, B, span, tid, nt);
    if (a.n_mov)
      copy_rows<S, P>(t + R.mov * P, a.mov, (size_t)k * 2 * a.n_mov, 2 * a.n_mov, B, span, tid,
                      nt);
  };
  stream_stages<G::D>(a.N, false, ring, tile, issue, [&](int k, const float* t) {
    const float* ts = t + s;
#pragma unroll
    for (int i = 0; i < n; ++i) xb[i] = ts[(R.Xs + i) * P];
#pragma unroll
    for (int i = 0; i < nu; ++i) {
      ub[i] = ts[(R.U + i) * P];
      kf[i] = ts[(R.kff + i) * P];
    }
    feedback_u<NR>(x, xb, ub, kf, ts + R.Kfb * P, P, alpha, u);
    if (a.n_mov) ob.mov = ts + R.mov * P;
    cost = cost + stage_merit<NR, true>(sp, k > 0, pairs, x, u, ts + R.xref * P,
                                        ts + R.lam * P, P, mu, ob);
    euler_rows<NR>(x, u, dt, x);
  });
  if (live) a.costs[(size_t)ai * B + b] = cost;
}

}  // namespace nmpc
