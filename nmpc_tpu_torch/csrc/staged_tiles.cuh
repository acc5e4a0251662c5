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
//  * K3 past (30, 20) (m >= 11, the wider ray and user-model stages, any
//    shape): the register-tile design, riccati_rtile. It replaces the block
//    design (a block of eight warps a scenario) and the wide design (the
//    same with the Cholesky across the block), which reached
//    2-6% of the bound (0.13% at (336, 224)): each thread summed one entry
//    as a chain of n dependent FMAs with two shared loads each (~1/8 of the
//    FMA rate), the Cholesky ran in one warp with two warp barriers a column
//    (2 nu block barriers past nu = 32), the 1 + n substitutions one thread
//    a right-hand side over ~nu^2 shared loads, the stage rows came as 4-byte
//    reads of one scenario's column (4 useful bytes a 32-byte sector), one
//    scenario a block of 256 threads, and the spilled shapes ran their dot
//    loops over device memory. What this design does:
//    - A block owns S consecutive scenarios (1-8; K3_GEOMETRY per m, k3_rule
//      elsewhere), every phase spread over all its threads with the
//      scenario fastest, so a warp's reads of a lane-major row and its stores
//      of kff and Kfb are runs of consecutive floats.
//    - The three products (phase 1: [Vxx; Vx'] [A | B], phase 2: [A | B]'
//      [Vxx A | Vxx B], phase 5: Qux' [kff | Kfb]; nearly all of a stage's
//      FLOPs) are X'Y over a common row index l with X and Y kept row-major
//      in the slot (Vxx transposed, Quu transposed), so a thread takes a
//      4 x 4 tile of outputs from two float4 loads a step (16 FMAs), each
//      entry still riccati_thread's chain: the first product, then the rest
//      in order of l, the base added last. f32 FMAs, no tensor cores.
//    - The Cholesky and the forward substitution are one right-looking
//      elimination of T = [Quu' | Qu | Qux] over the whole block, one block
//      barrier a column: each entry takes its terms in order of k, as the
//      left-looking chol and chol_solve take them.
//    - The 1 + n backward substitutions keep chol_solve's left-looking order,
//      one right-hand side a thread (up to nu = 32 in registers, unrolled),
//      S (n + 1) threads at once.
//    - A | B of the stage, read twice, goes through a ring of D tiles (one
//      wherever k3_rule picks; 4-byte cp.async); lx, lu, lxx, luu and lux,
//      read once each, come from device memory where used.
//    - Where even one scenario's slot and tile overflow the block ((120, 40),
//      (150, 100), (336, 224)), the slot and A | B live in the wrapper's
//      device-memory scratch and the products stream 16-row slices of their
//      operands under a 64 x 64 macro tile through two shared buffers
//      (16-byte cp.async, the next slice in flight), so no product's dot
//      loop reads device memory; the elimination and the backward
//      substitutions there still work on the scratch (through L2).
//    Every sum keeps riccati_thread's order: the host rehearsal holds the
//    design bit for bit to the first design (m = 12, 16, 17, 24) and to the
//    team design at (13, 2).
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
// bound at m=6; the register-tile design past (30, 20) by its FMAs, nu
// block barriers and dependent backward substitutions a stage (PERF.md).
// K5 at 15-30%: its merit code's
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
// the same N, so the barriers are uniform. D = 1 (K3's register-tile design
// where two tiles do not fit) copies each stage after the previous one is
// done.
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

// The register-tile design's slot of one scenario (stage shapes past (30,
// 20)), in floats; every offset and leading dimension a multiple of 4, so
// that every row starts on 16 bytes:
//   V [n, ldv]: V(l, i) = Vxx(i, l) for i < n (Vxx transposed, as phase 1
//     reads it), V(l, n) = Vx(l); from phase 2 Qxx transposed (its column n
//     free), from phase 5 the next stage's Vxx and Vx, in place
//   W [n, ldw]: phase 1's product, W(i, j) = (Vxx A)(i, j), (Vxx B)(i, j - n);
//     from the copy after phase 2 its head holds Qux [nu, ldq]
//   Wn [ldw]: phase 1's last row, Qx | Qu (past the Qux copy)
//   T [nu, ldt]: the elimination's rows, Quu transposed in columns 0..nu-1
//     (its lower triangle as T's upper), then from column r0 Qu and Qux [nu,
//     n]: the right-hand sides; after it the factor's rows (T(i, j) = L(j,
//     i) for j > i) and the gains [kff | Kfb]
//   inv [nu]: the factor's reciprocal diagonal
// pitch and tile_pitch (the stage's A | B, [n, ldab]) are the strides
// between the scenarios of a block: = 4 mod 32 floats, so that the same
// float4 of consecutive scenarios falls on other banks.
NMPC_HD constexpr int rt_pitch(int v) { return v + (36 - v % 32) % 32; }

template <int n_, int nu_>
struct K3RtSlot {
  static constexpr int n = n_, nu = nu_;
  static constexpr int ldv = al4(n + 1), ldw = al4(n + nu), ldq = al4(n), ldab = al4(n + nu);
  static constexpr int r0 = al4(nu), ldt = r0 + al4(n + 1);
  static constexpr int V = 0;
  static constexpr int W = V + n * ldv;
  static constexpr int Wn = W + al4(n * ldw > nu * ldq ? n * ldw : nu * ldq);
  static constexpr int T = Wn + ldw;
  static constexpr int inv = T + nu * ldt;
  static constexpr int floats = inv + al4(nu);  // 20,232 at m=16 (48, 32)
  static constexpr int tile = n * ldab;         // the stage's A | B
  static constexpr int pitch = rt_pitch(floats), tile_pitch = rt_pitch(tile);
};

// the spilled register-tile design's products: macro tiles of kRtMP x kRtMQ
// outputs (256 threads, a 4 x 4 tile each), operands staged kRtLS rows at a
// time, two buffers of both operands' rows in shared memory
constexpr int kRtMP = 64, kRtMQ = 64, kRtLS = 16;
constexpr int kRtStage = 2 * kRtLS * (kRtMP + kRtMQ);

// K3's launch geometry. The team design (stage shapes up to (30, 20)): S
// scenarios a block, D stage tiles in the ring, T lanes a scenario, tile
// pitch P (S, or S + 1 where lanes read down a column), kSpill: the output
// tile and the slots in a device-memory scratch of the wrapper's (per block,
// so L2 holds the resident blocks') where they do not fit beside the ring.
//
// kRtile: the register-tile design (past (30, 20)): S consecutive scenarios
// a block of T threads (P = 1); a ring of D = 1 or 2 tiles of their stages'
// A | B beside their slots (K3RtSlot) in shared memory, or, with kSpill (S =
// 1, D = 0, 256 threads), the slot and the stage's A | B in the scratch and
// the products' staging buffers in shared memory.
template <int n_, int nu_, int S_, int D_, int T_, int P_, bool kSpill_, bool kRtile_ = false>
struct K3Geom {
  static constexpr int n = n_, nu = nu_;
  static constexpr int S = S_, D = D_, T = T_, P = P_, threads = kRtile_ ? T : S * T;
  static constexpr bool kSpill = kSpill_, kRtile = kRtile_;
  static_assert(kRtile || (S >= 8 && (S & (S - 1)) == 0), "S: a power of two >= 8");
  static_assert(kRtile || T == 1 || (T <= 32 && 32 % T == 0), "a team within one warp");
  static_assert(kRtile || P == S || P == S + 1, "pitch");
  static_assert(!kRtile || (S >= 1 && T % 32 == 0 && T >= 64 && T <= 1024 && P == 1 &&
                            (kSpill ? S == 1 && D == 0 && T == 256 : D == 1 || D == 2)),
                "the register-tile design: whole warps, pitch 1, a ring of 1 or 2 tiles, or "
                "spilled: one scenario, 256 threads, no ring");
  using Rt = K3RtSlot<n, nu>;
  static constexpr int tile = kRtile ? S * Rt::tile_pitch : al4(K3Rows<n, nu>::rows * P);
  static constexpr int out = kRtile ? 0 : al4(K3Rows<n, nu>::out * P);
  static constexpr int priv = kRtile ? (kSpill ? Rt::floats + Rt::tile : S * Rt::pitch)
                                     : out + (T > 1 ? S * K3Slot<n, nu>::floats : 0);
  static constexpr int smem_floats = kRtile && kSpill ? kRtStage : D * tile + (kSpill ? 0 : priv);
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

// ---------------------------------------------------------------------------
// K3 past (30, 20): the register-tile design
// ---------------------------------------------------------------------------

// Four consecutive floats to a 16-byte aligned address (shared or device
// memory); load4<4> reads them.
NMPC_DEV void st4(float* p, const float (&v)[4]) {
#ifdef NMPC_HOST_BLOCK
  for (int i = 0; i < 4; ++i) p[i] = v[i];
#else
  *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
#endif
}

// The register-tile design's roundings, written out so that the compiler
// contracts nothing on its own: on the card each is one instruction (mul,
// add, fused multiply-add), as riccati_thread's unrolled chains come out of
// nvcc's contraction (a chain x0 y0 + x1 y1 + ... as fma(x0, y0, x1 y1),
// then fma(x_l, y_l, acc): the first product fused, the second rounded; a
// lone `v - x y` as fma(-x, y, v)). The host rehearsal (g++
// -ffp-contract=off) rounds each multiply and add apart, as riccati_thread
// does there, so each form holds the first design bit for bit on its own
// platform.
#ifdef NMPC_HOST_BLOCK
inline float rt_mul(float a, float b) { return a * b; }
inline float rt_add(float a, float b) { return a + b; }
inline float rt_fma(float a, float b, float c) { return a * b + c; }
#else
NMPC_DEV float rt_mul(float a, float b) { return __fmul_rn(a, b); }
NMPC_DEV float rt_add(float a, float b) { return __fadd_rn(a, b); }
NMPC_DEV float rt_fma(float a, float b, float c) { return fmaf(a, b, c); }
#endif

// A 4 x 4 tile of a product X'Y in riccati_thread's order: acc(i, j) =
// x(0, i) y(0, j) + x(1, i) y(1, j) (the first product fused, rt_fma), then
// + x(l, i) y(l, j) for l = 2..L-1 (x, y: 16-byte aligned rows ldx and ldy
// floats apart; two float4 loads a step for 16 FMAs).
template <int L, int ldx, int ldy>
NMPC_DEV void rt_tile(const float* x, const float* y, float (&acc)[4][4]) {
  float a[4], c[4];
  load4<4>(x, a);
  load4<4>(y, c);
  if constexpr (L == 1) {
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] = rt_mul(a[i], c[j]);
  } else {
    float a1[4], c1[4];
    load4<4>(x + ldx, a1);
    load4<4>(y + ldy, c1);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] = rt_fma(a[i], c[j], rt_mul(a1[i], c1[j]));
  }
#pragma unroll 4
  for (int l = 2; l < L; ++l) {
    load4<4>(x + l * ldx, a);
    load4<4>(y + l * ldy, c);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] = rt_fma(a[i], c[j], acc[i][j]);
  }
}

// C = X'Y, C(p, q) for p < P, q < Q, of the block's scenarios s < width
// with X and Y in shared memory (scenario s's at X + s xs, Y + s ys): items
// (s, 4 x 4 tile) over the block's threads, the scenario fastest, so that a
// warp's consecutive threads take one tile of consecutive scenarios and
// their reads of a lane-major input are consecutive floats; then the tiles
// kRtGP rows of tiles at a time, row fastest, so that a warp's float4 loads
// of X and of Y each fall on a few rows (a shared wavefront or two). A tile
// with skip(p0, q0, 4, 4) is left out. Each entry's base(s, p, q) is read
// before its tile's sums (a base in device memory arrives under them), and
// emit(s, p, q, base, c) takes the entry.
constexpr int kRtGP = 4;

template <int L, int P, int Q, int ldx, int ldy, int S, class Skip, class Base, class Emit>
NMPC_DEV void rt_product(const float* X, int xs, const float* Y, int ys, int width, int tid,
                         int nt, Skip&& skip, Base&& base, Emit&& emit) {
  constexpr int TP = (P + 3) / 4, TQ = (Q + 3) / 4, RB = (TP + kRtGP - 1) / kRtGP;
  constexpr int items = S * RB * kRtGP * TQ;
  for (int e = tid; e < items; e += nt) {
    const int s = e % S, t = e / S, r = t % (kRtGP * TQ);
    const int tp = (t / (kRtGP * TQ)) * kRtGP + r % kRtGP, p0 = 4 * tp, q0 = 4 * (r / kRtGP);
    if (s >= width || tp >= TP || skip(p0, q0, 4, 4)) continue;
    float acc[4][4], bv[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j)
        bv[i][j] = p0 + i < P && q0 + j < Q ? base(s, p0 + i, q0 + j) : 0.f;
    rt_tile<L, ldx, ldy>(X + s * xs + p0, Y + s * ys + q0, acc);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j)
        if (p0 + i < P && q0 + j < Q) emit(s, p0 + i, q0 + j, bv[i][j], acc[i][j]);
  }
}

// The same product for one scenario whose X and Y are in device memory (the
// spilled slot): macro tiles of kRtMP x kRtMQ entries in turn, thread tid
// the 4 x 4 tile (tid / 16, tid % 16) of each (256 threads); the rows of X
// and Y under a macro tile streamed kRtLS at a time through two buffers of
// `stage` (shared memory) by 16-byte cp.async, the next rows in flight while
// the block reads the last; each entry summed in the same order as above.
template <int L, int P, int Q, int ldx, int ldy, class Skip, class Base, class Emit>
NMPC_DEV void rt_product_staged(const float* X, const float* Y, float* stage, int tid,
                                Skip&& skip, Base&& base, Emit&& emit) {
  constexpr int NP = (P + kRtMP - 1) / kRtMP, NQ = (Q + kRtMQ - 1) / kRtMQ;
  constexpr int NS = (L + kRtLS - 1) / kRtLS, W = kRtMP + kRtMQ, buf = kRtLS * W;
  const int tp = 4 * (tid / (kRtMQ / 4)), tq = 4 * (tid % (kRtMQ / 4));
  for (int mt = 0; mt < NP * NQ; ++mt) {
    const int mp = kRtMP * (mt / NQ), mq = kRtMQ * (mt % NQ);
    if (skip(mp, mq, kRtMP, kRtMQ)) continue;  // the same for every thread
    auto issue = [&](int sl, float* b) {
      for (int c = tid; c < kRtLS * W / 4; c += 256) {
        const int r = c / (W / 4), f = 4 * (c % (W / 4)), l = sl * kRtLS + r;
        const bool isx = f < kRtMP;
        const int col = isx ? mp + f : mq + f - kRtMP;
        // rows past L are not read, columns past the operand's feed entries
        // that are not emitted: both are left as they are
        if (l < L && col < (isx ? al4(P) : al4(Q)))
          cp_async16(b + r * W + f, isx ? X + (size_t)l * ldx + col : Y + (size_t)l * ldy + col);
      }
    };
    float acc[4][4], bv[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j)
        bv[i][j] = mp + tp + i < P && mq + tq + j < Q ? base(0, mp + tp + i, mq + tq + j) : 0.f;
    issue(0, stage);
    cp_commit();
    for (int sl = 0; sl < NS; ++sl) {
      if (sl + 1 < NS) {
        issue(sl + 1, stage + ((sl + 1) & 1) * buf);
        cp_commit();
        cp_wait<1>();
      } else {
        cp_wait<0>();
      }
      block_sync();
      const float* b = stage + (sl & 1) * buf;
      const int rows = L - sl * kRtLS < kRtLS ? L - sl * kRtLS : kRtLS;
      float a[4], c[4];
      int r = 0;
      if (sl == 0) {  // rows 0 and 1 as rt_tile takes them
        load4<4>(b + tp, a);
        load4<4>(b + kRtMP + tq, c);
        if constexpr (L == 1) {
#pragma unroll
          for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int j = 0; j < 4; ++j) acc[i][j] = rt_mul(a[i], c[j]);
        } else {
          float a1[4], c1[4];
          load4<4>(b + W + tp, a1);
          load4<4>(b + W + kRtMP + tq, c1);
#pragma unroll
          for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int j = 0; j < 4; ++j) acc[i][j] = rt_fma(a[i], c[j], rt_mul(a1[i], c1[j]));
        }
        r = 2;
      }
      for (; r < rows; ++r) {
        load4<4>(b + r * W + tp, a);
        load4<4>(b + r * W + kRtMP + tq, c);
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) acc[i][j] = rt_fma(a[i], c[j], acc[i][j]);
      }
      block_sync();  // the buffer is refilled in the next step
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j)
        if (mp + tp + i < P && mq + tq + j < Q)
          emit(0, mp + tp + i, mq + tq + j, bv[i][j], acc[i][j]);
  }
}

// K3's phase probes past (30, 20), compiled in only with -DNMPC_K3_PROBES on
// the card (the builds of tools/k3_ab.py --phases): thread 0 of each block reads
// clock64 at every NMPC_K3_PROBE(i) of a stage and adds the cycles since the
// stage's start or its previous probe to g_k3_phase[i]. Without the flag they
// are empty, and K3's code is the same as without them.
#if defined(NMPC_K3_PROBES) && !defined(NMPC_HOST_BLOCK)
__device__ unsigned long long g_k3_phase[8];
#define NMPC_K3_PROBE_START() unsigned long long k3_probe_t0 = clock64()
#define NMPC_K3_PROBE(i)                                   \
  do {                                                     \
    if (threadIdx.x == 0) {                                \
      const unsigned long long k3_probe_t1 = clock64();    \
      atomicAdd(&g_k3_phase[i], k3_probe_t1 - k3_probe_t0); \
      k3_probe_t0 = k3_probe_t1;                           \
    }                                                      \
  } while (0)
#else
#define NMPC_K3_PROBE_START() ((void)0)
#define NMPC_K3_PROBE(i) ((void)0)
#endif

// The register-tile design's products: from shared memory (the slots of S
// scenarios), or staged from the spilled slot in device memory.
template <class G, int L, int P, int Q, int ldx, int ldy, class Skip, class Base, class Emit>
NMPC_DEV void rt_prod(const float* X, int xs, const float* Y, int ys, float* stage, int width,
                      int tid, Skip&& skip, Base&& base, Emit&& emit) {
  if constexpr (G::kSpill)
    rt_product_staged<L, P, Q, ldx, ldy>(X, Y, stage, tid, skip, base, emit);
  else
    rt_product<L, P, Q, ldx, ldy, G::S>(X, xs, Y, ys, width, tid, G::threads, skip, base, emit);
}

// The Cholesky factor of Quu + reg I and the forward substitution of its 1
// + n right-hand sides, as one right-looking elimination of the rows of T
// (scenario s's at T + s pitch, its inv at inv + s pitch): at step k, with
// d_k = sqrtf(T(k, k) + reg) and iv = 1 / d_k, every row i > k takes away
// (T(k, i) iv) (T(k, j) iv) from T(i, j); row k - 1 is scaled by its iv then
// (row k - 1 is read at step k - 1 alone). Each entry (i, j) so takes its
// terms in order of k, as riccati_thread's left-looking chol and chol_solve
// take them: the factor's (j, i) and the forward substitution's (i, c) bit
// for bit. A thread owns a chunk of four columns of one scenario's rows
// and every RS-th row (its index arithmetic outside the steps; row k's
// chunk, scaled, read once a step); one block barrier a step. The entries
// left of a row's diagonal and the rows' padding take garbage and are never
// read.
template <int nu, int ldt, int S, int NT>
NMPC_DEV void rt_eliminate(float* T, float* inv, int pitch, int width, float reg, int tid) {
  constexpr int C = ldt / 4, PAIRS = S * C, RS = NT >= PAIRS ? NT / PAIRS : 1;
  for (int k = 0; k < nu; ++k) {
    for (int w = tid; w < PAIRS * RS; w += NT) {
      const int s = w % PAIRS % S, c = w % PAIRS / S, r = w / PAIRS;
      if (s >= width) continue;
      float* Ts = T + s * pitch;
      if (4 * c + 3 > k) {  // the chunk holds a column past k
        const float iv = 1.f / sqrtf(rt_add(Ts[k * ldt + k], reg));
        float u[4];
        load4<4>(Ts + k * ldt + 4 * c, u);
#pragma unroll
        for (int q = 0; q < 4; ++q) u[q] = rt_mul(u[q], iv);  // U(k, j), y_k
        for (int i = k + 1 + r; i < nu; i += RS) {
          const float ui = rt_mul(Ts[k * ldt + i], iv);
          float t[4];
          load4<4>(Ts + i * ldt + 4 * c, t);
#pragma unroll
          for (int q = 0; q < 4; ++q) t[q] = rt_fma(-ui, u[q], t[q]);
          st4(Ts + i * ldt + 4 * c, t);
        }
      }
      if (k > 0 && r == 0 && 4 * c + 3 >= k) {  // row k - 1's chunks from column k - 1
        float* row = Ts + (k - 1) * ldt + 4 * c;
        const float iv = inv[s * pitch + k - 1];
        float t[4];
        load4<4>(row, t);
#pragma unroll
        for (int q = 0; q < 4; ++q) t[q] = rt_mul(t[q], iv);
        st4(row, t);
      }
    }
    if (tid < width) inv[tid * pitch + k] = 1.f / sqrtf(rt_add(T[tid * pitch + k * ldt + k], reg));
    block_sync();
  }
  for (int w = tid; w < PAIRS; w += NT) {  // row nu - 1
    const int s = w % S, c = w / S;
    if (s >= width || 4 * c + 3 < nu - 1) continue;
    float* row = T + s * pitch + (nu - 1) * ldt + 4 * c;
    const float iv = inv[s * pitch + nu - 1];
    float t[4];
    load4<4>(row, t);
#pragma unroll
    for (int q = 0; q < 4; ++q) t[q] = rt_mul(t[q], iv);
    st4(row, t);
  }
  block_sync();
}

// The backward substitution of right-hand side y (column of T, ldt floats
// apart) over the factor's rows U = T (U(i, k) = L(k, i)): chol_solve's
// left-looking order, y(i) = (y(i) - sum over k > i of U(i, k) y(k) in order
// of k) inv(i), then the gains' sign; out(i, g) takes each. Up to nu = 32
// the column in registers, fully unrolled.
template <int nu, int ldt, class Out>
NMPC_DEV void rt_backward(const float* U, const float* inv, float* y, Out&& out) {
  if constexpr (nu <= 32) {
    float v[nu];
#pragma unroll
    for (int i = 0; i < nu; ++i) v[i] = y[i * ldt];
#pragma unroll
    for (int i = nu - 1; i >= 0; --i) {
      float s = v[i];
#pragma unroll
      for (int k = i + 1; k < nu; ++k) s = rt_fma(-U[i * ldt + k], v[k], s);
      v[i] = rt_mul(s, inv[i]);
    }
#pragma unroll
    for (int i = 0; i < nu; ++i) {
      const float g = -v[i];
      y[i * ldt] = g;
      out(i, g);
    }
  } else {
    for (int i = nu - 1; i >= 0; --i) {
      float s = y[i * ldt];
#pragma unroll 4
      for (int k = i + 1; k < nu; ++k) s = rt_fma(-U[i * ldt + k], y[k * ldt], s);
      y[i * ldt] = rt_mul(s, inv[i]);
    }
    for (int i = 0; i < nu; ++i) {
      const float g = -y[i * ldt];
      y[i * ldt] = g;
      out(i, g);
    }
  }
}

// K3's register-tile design for block `blk`: its S consecutive scenarios
// b0.. (the last block's may be fewer, `width`), their stages backwards,
// each stage in five phases between block barriers:
//  1. W = [Vxx; Vx'] [A | B] (a product over l of V and the stage's A | B),
//     its last row + lx, lu: Qx | Qu;
//  2. [A | B]' [Vxx A | Vxx B] + lxx, lux, luu: Qxx into V (transposed),
//     Qux and Quu (transposed) into T, the block A'(Vxx B) left out;
//     then Qux copied to W's head and Qu to T's first right-hand side;
//  3. the elimination of T: the factor and the forward substitution;
//  4. the 1 + n backward substitutions, one right-hand side a thread, and
//     the gains stored to kff and Kfb (consecutive threads, consecutive
//     scenarios);
//  5. [Vx' ; Vxx'] = Qux' [kff | Kfb] + [Qx; Qxx] into V, dV1 += kff . Qu.
// The ring (stream_stages, D tiles of the S scenarios' A | B, 4-byte
// copies of the lane-major rows, consecutive threads on consecutive
// scenarios) or, spilled, the stage's A | B copied into the scratch beside
// the slot. lx, lu, lxx, luu and lux are read from device memory where they
// are used, once each, consecutive threads on consecutive scenarios.
template <class G>
NMPC_DEV void riccati_rtile(const RiccatiArgs& a, float* smem, float* scratch, int blk, int tid) {
  using L = K3RtSlot<G::n, G::nu>;
  constexpr int n = G::n, nu = G::nu, S = G::S, nt = G::threads;
  constexpr int ldv = L::ldv, ldw = L::ldw, ldq = L::ldq, ldt = L::ldt, ldab = L::ldab;
  constexpr int r0 = L::r0, pitch = L::pitch;
  const size_t B = a.B, b0 = (size_t)blk * S;
  const int width = B - b0 < (size_t)S ? static_cast<int>(B - b0) : S;
  float* slot = G::kSpill ? scratch + (size_t)blk * G::scratch_floats : smem + G::D * G::tile;
  for (int e = tid; e < S * n * ldv; e += nt) slot[(e / (n * ldv)) * pitch + e % (n * ldv)] = 0.f;
  float dV1 = 0.f;  // thread s < width: scenario s's
  auto body = [&](int k, const float* ab) {
    NMPC_K3_PROBE_START();
    // entry r of stage k's block of a lane-major input X [N, R, B], scenario s
    auto in = [&](const float* X, int R, int r, int s) {
      return X[((size_t)k * R + r) * B + b0 + s];
    };
    auto none = [](int, int, int, int) { return false; };
    rt_prod<G, n, n + 1, n + nu, ldv, ldab>(
        slot + L::V, pitch, ab, L::tile_pitch, smem, width, tid, none,
        [&](int s, int i, int j) {
          return i < n ? 0.f : j < n ? in(a.lx, n, j, s) : in(a.lu, nu, j - n, s);
        },
        [&](int s, int i, int j, float base, float v) {
          float* o = slot + s * pitch;
          if (i < n)
            o[L::W + i * ldw + j] = v;
          else
            o[L::Wn + j] = rt_add(base, v);
        });
    block_sync();
    NMPC_K3_PROBE(1);
    rt_prod<G, n, n + nu, n + nu, ldab, ldw>(
        ab, L::tile_pitch, slot + L::W, pitch, smem, width, tid,
        [](int p0, int q0, int np, int) { return p0 + np <= G::n && q0 >= G::n; },
        [&](int s, int p, int q) {
          return p < n ? (q < n ? in(a.lxx, n * n, p * n + q, s) : 0.f)
                       : q < n ? in(a.lux, nu * n, (p - n) * n + q, s)
                               : in(a.luu, nu * nu, (p - n) * nu + q - n, s);
        },
        [&](int s, int p, int q, float base, float v) {
          float* o = slot + s * pitch;
          const float e = rt_add(base, v);
          if (p < n) {
            if (q < n) o[L::V + q * ldv + p] = e;
          } else if (q < n) {
            o[L::T + (p - n) * ldt + r0 + 1 + q] = e;
          } else {
            o[L::T + (q - n) * ldt + p - n] = e;
          }
        });
    block_sync();
    NMPC_K3_PROBE(2);
    for (int e = tid; e < S * nu * (n + 1); e += nt) {  // Qux to W's head, Qu to T
      const int s = e % S, r = e / S / (n + 1), q = e / S % (n + 1);
      if (s >= width) continue;
      float* o = slot + s * pitch;
      if (q == 0)
        o[L::T + r * ldt + r0] = o[L::Wn + n + r];
      else
        o[L::W + r * ldq + q - 1] = o[L::T + r * ldt + r0 + q];
    }
    block_sync();
    NMPC_K3_PROBE(3);
    rt_eliminate<nu, ldt, S, nt>(slot + L::T, slot + L::inv, pitch, width, a.reg, tid);
    NMPC_K3_PROBE(4);
    for (int e = tid; e < S * (n + 1); e += nt) {
      const int s = e % S, c = e / S;
      if (s >= width) continue;
      float* o = slot + s * pitch;
      const size_t b = b0 + s;
      rt_backward<nu, ldt>(o + L::T, o + L::inv, o + L::T + r0 + c, [&](int i, float g) {
        if (c == 0)
          a.kff[((size_t)k * nu + i) * B + b] = g;
        else
          a.Kfb[(((size_t)k * nu + i) * n + c - 1) * B + b] = g;
      });
    }
    block_sync();
    NMPC_K3_PROBE(5);
    rt_prod<G, nu, n, n + 1, ldq, ldt>(
        slot + L::W, pitch, slot + L::T + r0, pitch, smem, width, tid, none,
        [&](int s, int p, int c) {
          const float* o = slot + s * pitch;
          return c == 0 ? o[L::Wn + p] : o[L::V + (c - 1) * ldv + p];
        },
        [&](int s, int p, int c, float base, float v) {
          float* o = slot + s * pitch;
          o[c == 0 ? L::V + p * ldv + n : L::V + (c - 1) * ldv + p] = rt_add(base, v);
        });
    if (tid < width) {
      const float* o = slot + tid * pitch;
      float s = 0.f;
      for (int i = 0; i < nu; ++i) s = rt_fma(o[L::T + i * ldt + r0], o[L::Wn + n + i], s);
      dV1 = rt_add(dV1, s);
    }
    NMPC_K3_PROBE(6);
  };
  if constexpr (G::kSpill) {
    float* ab = slot + L::floats;
    for (int k = a.N - 1; k >= 0; --k) {
      block_sync();  // the last stage's reads of A | B (and the zeroed V) are done
      for (int e = tid; e < n * (n + nu); e += nt) {
        const int l = e / (n + nu), j = e % (n + nu);
        ab[l * ldab + j] = j < n ? a.A[(((size_t)k * n + l) * n + j) * B + b0]
                                 : a.Bm[(((size_t)k * n + l) * nu + j - n) * B + b0];
      }
      block_sync();
      body(k, ab);
    }
  } else {
    auto issue = [&](int k, float* t) {
      for (int e = tid; e < S * n * (n + nu); e += nt) {
        const int s = e % S, r = e / S, l = r / (n + nu), j = r % (n + nu);
        if (s >= width) continue;
        const float* src = j < n ? a.A + (((size_t)k * n + l) * n + j) * B
                                 : a.Bm + (((size_t)k * n + l) * nu + j - n) * B;
        cp_async4(t + s * L::tile_pitch + l * ldab + j, src + b0 + s, true);
      }
    };
    stream_stages<G::D>(a.N, true, smem, G::tile, issue,
                        [&](int k, const float* t) { body(k, t); });
  }
  if (tid < width) a.dV1[b0 + tid] = dV1;
}

// K3 for block `blk`: the register-tile design past (30, 20), else the
// team design (vec: whether its rows take 16-byte copies).
template <class G>
NMPC_DEV void riccati_tiles(const RiccatiArgs& a, float* smem, float* scratch, int blk, bool vec,
                            int tid) {
  if constexpr (G::kRtile)
    riccati_rtile<G>(a, smem, scratch, blk, tid);
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
