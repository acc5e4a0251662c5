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
//  * K3 past (30, 20) (m >= 11, and the wider ray and user-model stages):
//    the block design, S = 1. Eight scenarios' stage tiles no longer fit a
//    block (at m=16 a ring of two alone would take 549 KB), so one block of
//    W warps runs one scenario: a ring of two of its stage tiles (4-byte
//    copies of its column of each lane-major row) and its K3BlockSlot (the
//    Riccati blocks) in shared memory, 103 KB at m=16, 157 KB at (64, 32).
//    Every product's entries are spread over the block's threads,
//    consecutive threads on consecutive columns, each summed over l in
//    riccati_thread's order (as the team design), so the outputs are the
//    first design's; the Cholesky runs in warp 0, lane j on row j (the
//    column's rows side by side, chol_unrolled's sums), and the 1 + n
//    substitutions one a thread, rolled in place in the slot: no block of
//    the scenario lives in registers, so nothing spills. kff and Kfb go
//    straight to device memory. The largest shape a block holds at a ring
//    of two is (80, 32) (nu <= 32: one warp's Cholesky).
//  * K3 past the block design's shapes (nu > 32, every m >= 17, or a ring
//    of two stage tiles beside the slot over 227 KB): the wide design,
//    riccati_wide. At m = 32 the slot alone is 140 KB and a stage tile 140
//    KB, and nu = 64 is past one warp. The same block of threads a
//    scenario, with three changes: the Cholesky runs across the block, a
//    column at a time (the rows of the column side by side, two block
//    barriers a column, chol_unrolled's sums); the ring holds only a
//    stage's A and B (the operands read n times a stage), D = 2 or 1 of
//    them, or none (D = 0, read from device memory where used), while lx,
//    lu, lxx, luu and lux, each read once a stage, come from device memory
//    where they are used; and the slot goes to a device-memory scratch of
//    the wrapper's (kSpill) where it does not fit beside the ring. Every sum
//    keeps riccati_thread's order (the host rehearsal holds it bit for bit
//    to the first design at m = 17 and 24), so K3 takes any stage shape.
//  * K5: one block runs all A candidates of its S scenarios (A S threads,
//    thread (ai, s) at ai S + s); each stage tile is fetched from device
//    memory once and read by all A candidates (a broadcast), so device
//    traffic falls to what the bound counts. Each thread runs feedback_u,
//    stage_merit and euler_rows of rollout.cuh unchanged, on the tile with
//    stride P: each merit is summed in the first design's order, bit for
//    bit. Past sixteen robots its tile shrinks to what fits (8 down to 1
//    scenario), and past m = 63 it reads its stage rows from device memory
//    (D = 0), the same sums. That form, with the parameter block read from
//    device memory too, is K5's device-memory form (K5Device) at every m:
//    it takes the problems whose rows overflow the tile (many obstacle
//    rows), with no shared memory at all.
// What bounds them now (measured on an H100 80GB HBM3 at 700 W, PERF.md):
// K3 at m=1 reaches 75% of its bytes bound; from m=5 one block of eight
// teams fills an SM's shared memory, and the serial Cholesky and the
// dependent dot chains between block barriers hold K3 near 18% of its
// bound at m=6; the block design reaches ~5% at m = 12 and 16, held by the
// Cholesky's and the substitutions' dependent chains a stage (one warp,
// one thread a right-hand side); the wide design the same chains, 2 nu
// block barriers a stage and uncoalesced 4-byte reads of one scenario's
// column of the cost blocks (PERF.md, PR 19). K5 at 15-30%: its merit code's
// instructions and two block barriers a stage; past ten robots (kThreads
// 256, its per-stage rows read from the tile where they are used) ~20-26%.
// S, D, T, P and the spill per m are compile-time constants, picked by
// `python -m nmpc_tpu_torch.tools.staged_launch` and passed by
// ops/cuda_build.py from ops/staged_tiles.py (-DNMPC_K3_S, ...).
//
// Host rehearsal: with NMPC_HOST_BLOCK defined, the harness provides
// block_sync() (a barrier of the block's threads), and the copies are plain
// loads; the bodies take the thread index and count as arguments.
#pragma once

#include <stdint.h>

#include <initializer_list>

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

// Host side of a launch. Whether every row segment of these lane-major
// arrays may be copied as 16-byte chunks: 16-byte aligned bases and B % 4 == 0.
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
// 16-byte chunks where the rows are aligned and the tile whole (P = S, S a
// multiple of 4), else single floats, zero-filled past a ragged tile's edge.
template <int S, int P>
NMPC_DEV void copy_rows(float* dst, const float* src, size_t row0, int R, size_t B,
                        const TileSpan& t, int tid, int nt) {
  if (S % 4 == 0 && P == S && t.vec && t.width == S) {
    constexpr int Q = S >= 4 ? S / 4 : 1;  // 16-byte chunks per row
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

// copy_rows into a tile in device memory (the device-memory forms'
// scratch), as plain loads and stores, zero-filled past a ragged tile's
// edge; the block's barrier after it makes the tile visible to its threads.
template <int S>
NMPC_DEV void copy_rows_plain(float* dst, const float* src, size_t row0, int R, size_t B,
                              const TileSpan& t, int tid, int nt) {
  for (int e = tid; e < R * S; e += nt) {
    const int r = e / S, j = e % S;
    dst[r * S + j] = j < t.width ? src[(row0 + r) * B + t.b0 + j] : 0.f;
  }
}

// The ring: D tiles of `tile` floats each. issue(k, slot) starts the copies
// of stage k into a slot; body(k, slot) computes stage k from it. Stages run
// forward (K5) or backward (K3); every thread of the block calls this with
// the same N, so the barriers are uniform. D = 1 (K3's wide design where two
// tiles do not fit) copies each stage after the previous one is done.
template <int D, class Issue, class Body>
NMPC_DEV void stream_stages(int N, bool backward, float* ring, int tile, Issue&& issue,
                            Body&& body) {
  static_assert(D >= 1, "a ring of at least one stage tile");
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

// Rows of K3's stage tile (inputs) and of its output tile, for stages of n
// states and nu controls: n = 3m, nu = 2m for m stacked unicycles, n = 3 + R,
// nu = 2 for one robot with R LiDAR rays.
template <int n_, int nu_>
struct K3Rows {
  static constexpr int n = n_, nu = nu_;
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
template <int n_, int nu_>
struct K3Slot {
  static constexpr int n = n_, nu = nu_, ld = al4(n), ldu = al4(nu);
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

// The block design's slot (one scenario, all of a block's threads), in
// floats: Vxx [n, n] (Qxx from phase 2 on), Vxx A [n, n], Vxx B [n, nu]
// (then Kfb [nu, n]), Qux [nu, n], Quu [nu, nu] (then its factor), Vx, Qx
// [n], Qu, kff and the factor's reciprocal diagonal [nu]. The blocks are kept
// as they are produced, row-major: a warp's consecutive threads take
// consecutive columns, so every product reads one operand as a broadcast
// and the other along a row.
template <int n_, int nu_>
struct K3BlockSlot {
  static constexpr int n = n_, nu = nu_;
  static constexpr int V = 0;
  static constexpr int VA = V + al4(n * n);
  static constexpr int W = VA + al4(n * n);
  static constexpr int Qux = W + al4(n * nu);
  static constexpr int Quu = Qux + al4(nu * n);
  static constexpr int Vx = Quu + al4(nu * nu);
  static constexpr int Qx = Vx + al4(n);
  static constexpr int Qu = Qx + al4(n);
  static constexpr int kf = Qu + al4(nu);
  static constexpr int inv = kf + al4(nu);
  static constexpr int floats = inv + al4(nu);  // 54,144 B at (64, 32)
};

// K3's launch geometry: S scenarios a block, D stage tiles in the ring, T
// lanes a scenario, tile pitch P (S, or S + 1 where lanes read down a
// column), kSpill: the output tile and the slots in a device-memory scratch
// of the wrapper's (per block, so L2 holds the resident blocks') where they
// do not fit beside the ring.
//
// S = 1 is the block design (stage shapes past (30, 20)): one block of T =
// 32 W threads for one scenario, P = 1, the scenario's K3BlockSlot beside
// the ring, kff and Kfb stored straight from the substitutions (no output
// tile). kWide (S = 1 too) is the wide design past the block design's
// shapes (nu > 32, or a ring of two full stage tiles beside the slot over
// the block's shared memory): its tile holds a stage's A and B alone, D of
// them (0: A and B read straight from device memory), and kSpill puts its
// K3BlockSlot in the scratch.
template <int n_, int nu_, int S_, int D_, int T_, int P_, bool kSpill_, bool kWide_ = false>
struct K3Geom {
  static constexpr int n = n_, nu = nu_;
  static constexpr int S = S_, D = D_, T = T_, P = P_, threads = S * T;
  static constexpr bool kSpill = kSpill_, kWide = kWide_, kBlock = S == 1 && !kWide_;
  static_assert(kBlock || kWide || (S >= 8 && (S & (S - 1)) == 0), "S: a power of two >= 8, or 1");
  static_assert(kBlock || kWide || T == 1 || (T <= 32 && 32 % T == 0), "a team within one warp");
  static_assert(!kBlock || (T % 32 == 0 && T <= 1024 && P == 1 && !kSpill && nu <= 32),
                "the block design: whole warps, pitch 1, nu <= 32 (its Cholesky is one warp's)");
  static_assert(!kWide || (S == 1 && T % 32 == 0 && T <= 1024 && P == 1 && D >= 0 && D <= 2),
                "the wide design: one scenario, whole warps, pitch 1, a ring of 0 to 2 tiles");
  static_assert(kBlock || kWide || P == S || P == S + 1, "pitch");
  static constexpr int tile = kWide ? al4(n * (n + nu)) : al4(K3Rows<n, nu>::rows * P);
  static constexpr int out = kBlock || kWide ? 0 : al4(K3Rows<n, nu>::out * P);
  static constexpr int priv = kBlock || kWide ? K3BlockSlot<n, nu>::floats
                                              : out + (T > 1 ? S * K3Slot<n, nu>::floats : 0);
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
template <int n_, int nu_, int P>
struct RiccatiRegs {
  static constexpr int n = n_, nu = nu_;
  using R = K3Rows<n, nu>;
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
template <int n_, int nu_, int T, int P>
NMPC_DEV void riccati_team_stage(const float* t, float* o, float* sl, int lane, float reg,
                                 float& dV1) {
  using R = K3Rows<n_, nu_>;
  using L = K3Slot<n_, nu_>;
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

// The block design's warp barrier: its Cholesky runs in warp 0 alone (the
// host rehearsal provides warp0_sync, a barrier of that warp's threads).
#ifndef NMPC_HOST_BLOCK
NMPC_DEV void warp0_sync() { __syncwarp(); }
#endif

// The block design, one stage of the block's scenario: t, its stage tile
// (P = 1); sl, its slot; tid of nt threads. Every entry is summed over l in
// riccati_thread's order (as the team design's), each phase's entries
// spread over the block's threads with consecutive threads on consecutive
// columns; block barriers between the phases. kff and Kfb go straight to
// device memory (b: the scenario, k: the stage). Thread 0 carries dV1.
template <int n_, int nu_>
NMPC_DEV void riccati_block_stage(const RiccatiArgs& a, const float* t, float* sl, int k,
                                  size_t b, int tid, int nt, float& dV1) {
  using R = K3Rows<n_, nu_>;
  using L = K3BlockSlot<n_, nu_>;
  constexpr int n = L::n, nu = L::nu;
  const size_t B = a.B;
  // 1: Vxx A [n, n], Vxx B [n, nu], Qx = lx + A'Vx, Qu = lu + B'Vx
  for (int e = tid; e < (n + nu) * n + n + nu; e += nt) {
    const float* v;    // a row of Vxx, or Vx (stride 1)
    const float* col;  // a column of A or B (stride w)
    int w;
    float* dst;
    float base = 0.f;
    bool lin = false;
    if (e < n * n) {
      v = sl + L::V + (e / n) * n, col = t + R::A + e % n, w = n, dst = sl + L::VA + e;
    } else if (e < (n + nu) * n) {
      const int f = e - n * n;
      v = sl + L::V + (f / nu) * n, col = t + R::Bm + f % nu, w = nu, dst = sl + L::W + f;
    } else if (e < (n + nu) * n + n) {
      const int j = e - (n + nu) * n;
      v = sl + L::Vx, col = t + R::A + j, w = n, dst = sl + L::Qx + j;
      base = t[R::lx + j], lin = true;
    } else {
      const int c = e - (n + nu) * n - n;
      v = sl + L::Vx, col = t + R::Bm + c, w = nu, dst = sl + L::Qu + c;
      base = t[R::lu + c], lin = true;
    }
    float s = v[0] * col[0];
    for (int l = 1; l < n; ++l) s = s + v[l] * col[l * w];
    *dst = lin ? base + s : s;
  }
  block_sync();
  // 2: Qxx = lxx + A'(Vxx A) into Vxx, Qux = lux + B'(Vxx A), Quu = luu +
  //    B'(Vxx B)
  for (int e = tid; e < n * n + nu * n + nu * nu; e += nt) {
    const float* col;  // a column of A or B (stride w)
    const float* m;    // a column of Vxx A or Vxx B (stride ldm)
    int w, ldm, at, in;
    if (e < n * n) {
      col = t + R::A + e / n, w = n, m = sl + L::VA + e % n, ldm = n;
      at = L::V + e, in = R::lxx + e;
    } else if (e < n * n + nu * n) {
      const int f = e - n * n;
      col = t + R::Bm + f / n, w = nu, m = sl + L::VA + f % n, ldm = n;
      at = L::Qux + f, in = R::lux + f;
    } else {
      const int f = e - n * n - nu * n;
      col = t + R::Bm + f / nu, w = nu, m = sl + L::W + f % nu, ldm = nu;
      at = L::Quu + f, in = R::luu + f;
    }
    float s = col[0] * m[0];
    for (int l = 1; l < n; ++l) s = s + col[l * w] * m[l * ldm];
    sl[at] = t[in] + s;
  }
  block_sync();
  // 3: the Cholesky factor of Quu + reg I in warp 0, lane j on row j:
  //    chol_unrolled's sums, the column's rows side by side
  if (tid < 32) {
    float* Q = sl + L::Quu;
    const int j = tid;
#pragma unroll 1
    for (int i = 0; i < nu; ++i) {
      float v = 0.f;
      if (j >= i && j < nu) {
        v = Q[j * nu + i];
        for (int q = 0; q < i; ++q) v = v - Q[j * nu + q] * Q[i * nu + q];
        if (j == i) {
          const float d = sqrtf(v + a.reg);
          sl[L::inv + i] = 1.f / d;
          Q[i * nu + i] = d;
        }
      }
      warp0_sync();
      if (j > i && j < nu) Q[j * nu + i] = v * sl[L::inv + i];
      warp0_sync();
    }
  }
  block_sync();
  // 4: the 1 + n substitutions, one right-hand side a thread, each in place
  //    in the slot (chol_solve_unrolled's sums, rolled, so that no thread
  //    holds a column in registers): kff over a copy of Qu, column c of Kfb
  //    [nu, n] (over Vxx B) over a copy of column c of Qux
  for (int c = tid; c <= n; c += nt) {
    const int ys = c == 0 ? 1 : n;  // the column's stride
    float* y = c == 0 ? sl + L::kf : sl + L::W + c - 1;
    const float* rhs = c == 0 ? sl + L::Qu : sl + L::Qux + c - 1;
    const float* F = sl + L::Quu;
    const float* inv = sl + L::inv;
    for (int i = 0; i < nu; ++i) y[i * ys] = rhs[i * ys];
    for (int i = 0; i < nu; ++i) {
      float s = y[i * ys];
      for (int q = 0; q < i; ++q) s = s - F[i * nu + q] * y[q * ys];
      y[i * ys] = s * inv[i];
    }
    for (int i = nu - 1; i >= 0; --i) {
      float s = y[i * ys];
      for (int q = i + 1; q < nu; ++q) s = s - F[q * nu + i] * y[q * ys];
      y[i * ys] = s * inv[i];
    }
    for (int i = 0; i < nu; ++i) {
      const float g = -y[i * ys];
      y[i * ys] = g;
      if (c == 0)
        a.kff[((size_t)k * nu + i) * B + b] = g;
      else
        a.Kfb[(((size_t)k * nu + i) * n + c - 1) * B + b] = g;
    }
  }
  block_sync();
  // 5: Vxx(a, c) = Qxx(a, c) + Qux(:, a)' Kfb(:, c), Vx(a) = Qx(a) + Qux(:,
  //    a)' kff; thread 0 also dV1 += kff . Qu
  for (int e = tid; e < n * n + n; e += nt) {
    const int r = e < n * n ? e / n : e - n * n;
    const float* kr = e < n * n ? sl + L::W + e % n : sl + L::kf;  // stride n or 1
    const int ks = e < n * n ? n : 1;
    float acc = sl[L::Qux + r] * kr[0];
    for (int q = 1; q < nu; ++q) acc = acc + sl[L::Qux + q * n + r] * kr[q * ks];
    const int at = e < n * n ? L::V + e : L::Vx + r;
    sl[at] = sl[e < n * n ? at : L::Qx + r] + acc;
  }
  if (tid == 0) {
    float s = 0.f;
#pragma unroll
    for (int i = 0; i < nu; ++i) s += sl[L::kf + i] * sl[L::Qu + i];
    dV1 = dV1 + s;
  }
}

// K3's block design for the scenario of block `blk`: its stage tile copied
// by the block's threads as 4-byte copies (one scenario's column of each
// lane-major row), through stream_stages' ring of G::D tiles.
template <class G>
NMPC_DEV void riccati_block(const RiccatiArgs& a, float* smem, int blk, int tid) {
  using R = K3Rows<G::n, G::nu>;
  using L = K3BlockSlot<G::n, G::nu>;
  constexpr int n = R::n, nu = R::nu, nt = G::threads;
  const size_t B = a.B, b = blk;
  float* sl = smem + G::D * G::tile;
  auto col = [&](float* dst, const float* src, size_t row0, int rows) {
    for (int e = tid; e < rows; e += nt) cp_async4(dst + e, src + (row0 + e) * B + b, true);
  };
  auto issue = [&](int k, float* t) {
    col(t + R::A, a.A, (size_t)k * n * n, n * n);
    col(t + R::Bm, a.Bm, (size_t)k * n * nu, n * nu);
    col(t + R::lx, a.lx, (size_t)k * n, n);
    col(t + R::lu, a.lu, (size_t)k * nu, nu);
    col(t + R::lxx, a.lxx, (size_t)k * n * n, n * n);
    col(t + R::luu, a.luu, (size_t)k * nu * nu, nu * nu);
    col(t + R::lux, a.lux, (size_t)k * nu * n, nu * n);
  };
  for (int i = tid; i < n * n; i += nt) sl[L::V + i] = 0.f;
  for (int i = tid; i < n; i += nt) sl[L::Vx + i] = 0.f;
  float dV1 = 0.f;
  stream_stages<G::D>(a.N, true, smem, G::tile, issue, [&](int k, const float* t) {
    riccati_block_stage<n, nu>(a, t, sl, k, b, tid, nt, dV1);
  });
  if (tid == 0) a.dV1[b] = dV1;
}

// K3's team design for the block of tile `blk` at the stage shape of G (n,
// nu): S scenarios, S T threads (thread tid is
// lane tid % T of scenario tid / T). smem: G::smem_floats of dynamic shared
// memory; scratch: G::scratch_floats per block of device memory (kSpill).
template <class G>
NMPC_DEV void riccati_team_tiles(const RiccatiArgs& a, float* smem, float* scratch, int blk,
                            bool vec, int tid) {
  using R = K3Rows<G::n, G::nu>;
  using L = K3Slot<G::n, G::nu>;
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
    RiccatiRegs<n, nu, P> st;
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
      riccati_team_stage<n, nu, T, P>(t + s, out + s, sl, lane, a.reg, dV1);
      store(k);
    });
  }
  if (lane == 0 && s < span.width) a.dV1[span.b0 + s] = dV1;
}

// The wide design, one stage of the block's scenario b: Ak, Bk, the stage's
// A [n, n] and B [n, nu] from the ring's tile (ld 1) or straight from the
// lane-major arrays (kDirect: ld B); lx, lu, lxx, luu and lux read straight
// from device memory where they are used, once each; sl, the slot (shared
// memory, or the block's scratch with kSpill). Phases 1, 2, 4 and 5 are the
// block design's, every entry summed over l in riccati_thread's order; the
// Cholesky runs across the block, a column at a time: the rows j >= i of
// column i side by side (chol_unrolled's sums, each row's in its order),
// then the pivot's reciprocal, then the column scaled, a block barrier
// after each, so that nu is bounded by nothing but the slot.
template <int n_, int nu_, bool kDirect>
NMPC_DEV void riccati_wide_stage(const RiccatiArgs& a, const float* Ak, const float* Bk,
                                 float* sl, int k, size_t b, int tid, int nt, float& dV1) {
  using L = K3BlockSlot<n_, nu_>;
  constexpr int n = L::n, nu = L::nu;
  const size_t B = a.B, ld = kDirect ? B : 1;
  // entry r of stage k's block of a lane-major input X [N, R, B]
  auto in = [&](const float* X, int R, int r) { return X[((size_t)k * R + r) * B + b]; };
  // 1: Vxx A [n, n], Vxx B [n, nu], Qx = lx + A'Vx, Qu = lu + B'Vx
  for (int e = tid; e < (n + nu) * n + n + nu; e += nt) {
    const float* v;    // a row of Vxx, or Vx (stride 1)
    const float* col;  // a column of A or B (stride cs)
    size_t cs;
    float* dst;
    float base = 0.f;
    bool lin = false;
    if (e < n * n) {
      v = sl + L::V + (e / n) * n, col = Ak + (e % n) * ld, cs = n * ld, dst = sl + L::VA + e;
    } else if (e < (n + nu) * n) {
      const int f = e - n * n;
      v = sl + L::V + (f / nu) * n, col = Bk + (f % nu) * ld, cs = nu * ld, dst = sl + L::W + f;
    } else if (e < (n + nu) * n + n) {
      const int j = e - (n + nu) * n;
      v = sl + L::Vx, col = Ak + j * ld, cs = n * ld, dst = sl + L::Qx + j;
      base = in(a.lx, n, j), lin = true;
    } else {
      const int c = e - (n + nu) * n - n;
      v = sl + L::Vx, col = Bk + c * ld, cs = nu * ld, dst = sl + L::Qu + c;
      base = in(a.lu, nu, c), lin = true;
    }
    float s = v[0] * col[0];
    for (int l = 1; l < n; ++l) s = s + v[l] * col[l * cs];
    *dst = lin ? base + s : s;
  }
  block_sync();
  // 2: Qxx = lxx + A'(Vxx A) into Vxx, Qux = lux + B'(Vxx A), Quu = luu +
  //    B'(Vxx B)
  for (int e = tid; e < n * n + nu * n + nu * nu; e += nt) {
    const float* col;  // a column of A or B (stride cs)
    const float* m;    // a column of Vxx A or Vxx B (stride ldm)
    size_t cs;
    int ldm, at;
    float base;
    if (e < n * n) {
      col = Ak + (e / n) * ld, cs = n * ld, m = sl + L::VA + e % n, ldm = n;
      at = L::V + e, base = in(a.lxx, n * n, e);
    } else if (e < n * n + nu * n) {
      const int f = e - n * n;
      col = Bk + (f / n) * ld, cs = nu * ld, m = sl + L::VA + f % n, ldm = n;
      at = L::Qux + f, base = in(a.lux, nu * n, f);
    } else {
      const int f = e - n * n - nu * n;
      col = Bk + (f / nu) * ld, cs = nu * ld, m = sl + L::W + f % nu, ldm = nu;
      at = L::Quu + f, base = in(a.luu, nu * nu, f);
    }
    float s = col[0] * m[0];
    for (int l = 1; l < n; ++l) s = s + col[l * cs] * m[l * ldm];
    sl[at] = base + s;
  }
  block_sync();
  // 3: the Cholesky factor of Quu + reg I across the block
  float* Q = sl + L::Quu;
  for (int i = 0; i < nu; ++i) {
    for (int j = i + tid; j < nu; j += nt) {
      float v = Q[j * nu + i];
      for (int q = 0; q < i; ++q) v = v - Q[j * nu + q] * Q[i * nu + q];
      if (j == i) {
        const float d = sqrtf(v + a.reg);
        sl[L::inv + i] = 1.f / d;
        Q[i * nu + i] = d;
      } else {
        Q[j * nu + i] = v;
      }
    }
    block_sync();
    for (int j = i + 1 + tid; j < nu; j += nt) Q[j * nu + i] = Q[j * nu + i] * sl[L::inv + i];
    block_sync();
  }
  // 4: the 1 + n substitutions, one right-hand side a thread, in place in
  //    the slot (the block design's)
  for (int c = tid; c <= n; c += nt) {
    const int ys = c == 0 ? 1 : n;  // the column's stride
    float* y = c == 0 ? sl + L::kf : sl + L::W + c - 1;
    const float* rhs = c == 0 ? sl + L::Qu : sl + L::Qux + c - 1;
    const float* inv = sl + L::inv;
    for (int i = 0; i < nu; ++i) y[i * ys] = rhs[i * ys];
    for (int i = 0; i < nu; ++i) {
      float s = y[i * ys];
      for (int q = 0; q < i; ++q) s = s - Q[i * nu + q] * y[q * ys];
      y[i * ys] = s * inv[i];
    }
    for (int i = nu - 1; i >= 0; --i) {
      float s = y[i * ys];
      for (int q = i + 1; q < nu; ++q) s = s - Q[q * nu + i] * y[q * ys];
      y[i * ys] = s * inv[i];
    }
    for (int i = 0; i < nu; ++i) {
      const float g = -y[i * ys];
      y[i * ys] = g;
      if (c == 0)
        a.kff[((size_t)k * nu + i) * B + b] = g;
      else
        a.Kfb[(((size_t)k * nu + i) * n + c - 1) * B + b] = g;
    }
  }
  block_sync();
  // 5: Vxx(a, c) = Qxx(a, c) + Qux(:, a)' Kfb(:, c), Vx(a) = Qx(a) + Qux(:,
  //    a)' kff; thread 0 also dV1 += kff . Qu
  for (int e = tid; e < n * n + n; e += nt) {
    const int r = e < n * n ? e / n : e - n * n;
    const float* kr = e < n * n ? sl + L::W + e % n : sl + L::kf;  // stride n or 1
    const int ks = e < n * n ? n : 1;
    float acc = sl[L::Qux + r] * kr[0];
    for (int q = 1; q < nu; ++q) acc = acc + sl[L::Qux + q * n + r] * kr[q * ks];
    const int at = e < n * n ? L::V + e : L::Vx + r;
    sl[at] = sl[e < n * n ? at : L::Qx + r] + acc;
  }
  if (tid == 0) {
    float s = 0.f;
    for (int i = 0; i < nu; ++i) s += sl[L::kf + i] * sl[L::Qu + i];
    dV1 = dV1 + s;
  }
}

// K3's wide design for the scenario of block `blk`: A and B of each stage
// through stream_stages' ring of G::D tiles (4-byte copies of the
// scenario's column of each lane-major row), or with G::D = 0 read where
// they are used; the slot in shared memory after the ring, or in the
// block's G::scratch_floats of device memory (kSpill).
template <class G>
NMPC_DEV void riccati_wide(const RiccatiArgs& a, float* smem, float* scratch, int blk, int tid) {
  using L = K3BlockSlot<G::n, G::nu>;
  constexpr int n = G::n, nu = G::nu, nt = G::threads;
  const size_t B = a.B, b = blk;
  float* sl = G::kSpill ? scratch + (size_t)blk * G::scratch_floats : smem + G::D * G::tile;
  for (int i = tid; i < n * n; i += nt) sl[L::V + i] = 0.f;
  for (int i = tid; i < n; i += nt) sl[L::Vx + i] = 0.f;
  float dV1 = 0.f;
  if constexpr (G::D == 0) {
    block_sync();
    for (int k = a.N - 1; k >= 0; --k) {
      riccati_wide_stage<n, nu, true>(a, a.A + (size_t)k * n * n * B + b,
                                      a.Bm + (size_t)k * n * nu * B + b, sl, k, b, tid, nt, dV1);
      block_sync();
    }
  } else {
    auto issue = [&](int k, float* t) {
      for (int e = tid; e < n * n; e += nt)
        cp_async4(t + e, a.A + ((size_t)k * n * n + e) * B + b, true);
      for (int e = tid; e < n * nu; e += nt)
        cp_async4(t + n * n + e, a.Bm + ((size_t)k * n * nu + e) * B + b, true);
    };
    stream_stages<G::D>(a.N, true, smem, G::tile, issue, [&](int k, const float* t) {
      riccati_wide_stage<n, nu, false>(a, t, t + n * n, sl, k, b, tid, nt, dV1);
    });
  }
  if (tid == 0) a.dV1[b] = dV1;
}

// K3 for block `blk`: the wide design past the block design's shapes, the
// block design past (30, 20) (S = 1), else the team design.
template <class G>
NMPC_DEV void riccati_tiles(const RiccatiArgs& a, float* smem, float* scratch, int blk,
                            bool vec, int tid) {
  if constexpr (G::kWide)
    riccati_wide<G>(a, smem, scratch, blk, tid);
  else if constexpr (G::kBlock)
    riccati_block<G>(a, smem, blk, tid);
  else
    riccati_team_tiles<G>(a, smem, scratch, blk, vec, tid);
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
// block of A S threads, at most kThreads: 512, and 256 past ten robots,
// where a thread's state, deviation and controls take ~130 registers. D = 0
// is the device-memory form (K5Device): every stage row and the parameter
// block read straight from device memory, no shared memory, at any m and
// any number of obstacle rows (the form of m >= 64, where a ring of two
// one-scenario tiles overflows the block, and of any problem whose rows
// overflow the tile).
template <int NR, int S_, int D_>
struct K5Geom {
  static constexpr int S = S_, D = D_, kThreads = NR > 10 ? 256 : 512;
  static_assert(S >= 1 && (S & (S - 1)) == 0, "S: a power of two");
  static_assert(D >= 2 || D == 0, "a ring of at least two stage tiles, or none");
  static constexpr int max_alphas = kThreads / S;
  // floats of dynamic shared memory: the parameter block, then the ring
  NMPC_HD static int smem_floats(int rows, int prm_size) {
    return D ? al4(prm_size) + D * al4(rows * S) : 0;
  }
};

// K5's device-memory form, which every library holds beside its tile form
// (ops/staged_tiles.py::K5_DEVICE)
template <int NR>
using K5Device = K5Geom<NR, 8, 0>;

// K5 for the block of tile `blk`: thread tid is candidate tid / S of
// scenario tid % S; sp: the parameter block (in shared memory, or with D =
// 0 in device memory), ring after it (D > 0). Each thread runs
// linesearch_cost_thread's loop on the tile (stride S).
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
  if constexpr (G::D == 0) {
    // the stage rows straight from the lane-major arrays (stride B): the
    // NR > 10 body below with its reads moved from the tile (at NR <= 10
    // feedback_u's sums in its order, as the same body)
    for (int k = 0; k < a.N; ++k) {
      const float* Xs = a.Xs + (size_t)k * n * B + b;
      const float* U = a.U + (size_t)k * nu * B + b;
      const float* kff = a.kff + (size_t)k * nu * B + b;
      const float* K = a.Kfb + (size_t)k * nu * n * B + b;
      float dx[n];
#pragma unroll
      for (int j = 0; j < n; ++j) dx[j] = x[j] - Xs[(size_t)j * B];
#pragma unroll 1
      for (int i = 0; i < nu; ++i) {
        float acc = U[(size_t)i * B] + alpha * kff[(size_t)i * B];
#pragma unroll
        for (int j = 0; j < n; ++j) acc = acc + K[(size_t)(i * n + j) * B] * dx[j];
        u[i] = acc;
      }
      if (a.n_mov) ob.mov = a.mov + (size_t)k * 2 * a.n_mov * B + b;
      cost = cost + stage_merit<NR, true>(sp, k > 0, pairs, x, u, a.xref + (size_t)k * n * B + b,
                                          a.lam + (size_t)k * nc * B + b, B, mu, ob);
      euler_rows<NR>(x, u, dt, x);
    }
  } else {
    stream_stages<G::D>(a.N, false, ring, tile, issue, [&](int k, const float* t) {
      const float* ts = t + s;
      if constexpr (NR > 10) {
        // feedback_u's sums with xbar, ubar and kff read from the tile where
        // they are used, not held in registers
        float dx[n];
#pragma unroll
        for (int j = 0; j < n; ++j) dx[j] = x[j] - ts[(R.Xs + j) * P];
        const float* K = ts + R.Kfb * P;
#pragma unroll 1
        for (int i = 0; i < nu; ++i) {
          float acc = ts[(R.U + i) * P] + alpha * ts[(R.kff + i) * P];
#pragma unroll
          for (int j = 0; j < n; ++j) acc = acc + K[(i * n + j) * P] * dx[j];
          u[i] = acc;
        }
      } else {
#pragma unroll
        for (int i = 0; i < n; ++i) xb[i] = ts[(R.Xs + i) * P];
#pragma unroll
        for (int i = 0; i < nu; ++i) {
          ub[i] = ts[(R.U + i) * P];
          kf[i] = ts[(R.kff + i) * P];
        }
        feedback_u<NR>(x, xb, ub, kf, ts + R.Kfb * P, P, alpha, u);
      }
      if (a.n_mov) ob.mov = ts + R.mov * P;
      cost = cost + stage_merit<NR, true>(sp, k > 0, pairs, x, u, ts + R.xref * P,
                                          ts + R.lam * P, P, mu, ob);
      euler_rows<NR>(x, u, dt, x);
    });
  }
  if (live) a.costs[(size_t)ai * B + b] = cost;
}

}  // namespace nmpc
