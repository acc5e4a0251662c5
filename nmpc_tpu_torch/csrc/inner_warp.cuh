// K1 and K2 of the megakernel route, designed for Hopper: one warp per
// scenario.
//
//   inner_solve_warp (K1): the whole inner AL-iLQR solve of one scenario.
//     Replaces the Pallas megakernel nmpc_tpu/ops/megasolve_pallas.py::
//     inner_solve_fused (_make_megakernel).
//   al_update_warp (K2): the AL multiplier update and the largest violation.
//     Replaces megasolve_pallas.py::al_update_lanes (_make_al_update_kernel).
//
// Problem class: NR stacked Euler unicycles with pair rows (optional), u/x
// box rows and, in the obstacle variant (kObs), static-obstacle rows
// (c = dist - keepout) and moving-obstacle rows (c = dx^2 + dy^2 - dmin^2
// against the stage's entry of the schedule); no LiDAR rays. Row order per
// stage: pairs, static obstacles (robot-major, obstacle-minor), moving
// obstacles (robot-major), u box, x box.
//
// What bounded the first design (megasolve.cuh::inner_solve_thread, one
// thread per scenario, kept as the roofline tools' baseline): each thread
// held its stage's value function and Q-blocks in thread-local arrays (Vxx
// alone is n^2 = 324 floats at six robots): 255 registers, a 4,880 B stack
// and spills at m=6, 160 MB of thread-local state over a batch of 32,768,
// so the Cholesky, its n + 1 substitutions and the nu x n x n value update
// ran out of L2 and device memory; and a warp of 32 scenarios ran as long as
// its slowest one.
//
// This design: the 32 lanes of a warp own one scenario.
//  * The stage-local blocks live in a per-warp slot of shared memory whose
//    size depends on m (and the obstacle variant's rows; Slot below; 6,608 B
//    at m=6, 16,976 B at m=10 without obstacle rows):
//    Vxx twice (ping-pong: Qxx is built in the other copy and becomes the
//    next Vxx), Qux, Quu and its factor, Vx, Qx, Qu, the structured
//    expansion with a dense table of the pair weights, and the stage's
//    state, control, reference and duals. The arrays that grow with N (X, U,
//    kff, Kfb, xref, lam) stay in device memory in the standard layout
//    [B, N, ...], so a warp reads one stage's rows as contiguous lines.
//  * Lanes split the work: the expansion's box rows by row, its pair rows by
//    pair, its dynamics by robot; Qux, Qxx and Quu by 3x3 block (r, q) of
//    Vxx; the Cholesky by row within each column; the substitutions one lane
//    per right-hand side (kff and the n columns of Qux), each in registers;
//    the value update by column of Vxx, from the lane's own column of K.
//  * Where a block has more rows than the warp has lanes, lane i owns rows
//    i, i + 32, ... (kOwn below): the state rows and the n + 1 right-hand
//    sides at m >= 11 (n = 3m > 31), the pair rows at m >= 12. Lane i takes
//    its first row where it always did and its further rows after it, in
//    blocks that compile only where a lane owns them (`if constexpr`), so
//    the code at m <= 10 is what it was (tools/sass_diff.py shows K1's and
//    K2's machine code unchanged at m = 6 and 10). Controls (nu = 2m <= 32)
//    and the Cholesky's rows stay one a lane, which caps the design at
//    m = 16.
//  * Rollouts: controls by row, the Euler step by robot, the merit by
//    constraint row, summed over the warp once per rollout; the accepted
//    step is the trajectory its candidate rollout stored (no third rollout).
//  * Only __syncwarp and shuffles order a scenario's work: a scenario that
//    stops leaves at once, and no scenario waits for another's iterations.
// What bounds it (measured on an H100 80GB HBM3 at 700 W, PERF.md): each
// warp's serial chain of small dependent steps and the instructions issued
// for them, not device memory. More resident warps help until the register
// cap forces spills (tools/k1_launch.py: at m=6, 20 warps per SM 20% faster
// than 14, 24 slower again), and tools/k1_phases.py puts the Cholesky's
// serial columns first (~20% of K1 at m=6), then the value update (~19%)
// and the Q blocks (~12%); the line search's rollouts take ~21%. So lanes
// take whole blocks where the work allows (Q blocks, pair rows), branches
// are warp-uniform, and the register cap is picked per m (megasolve.cu).
//
// Numerics kept from the first design: relu and min_nan keep a NaN, pair
// rows are rounded without FMA contraction, lam - mu c is one fmaf, the
// stage-0 state and pair rows are masked by selection (a NaN warm dual never
// reaches the gains), f32 throughout (no tensor cores: a reduced-precision
// Riccati recursion diverges). The merit is summed in another order (over
// lanes, then over the warp), so the results agree with the plain version
// at the tests' tolerances, not bit for bit.
//
// The obstacle variant (template flag kObs; the pair-only K1 and K2 are the
// kObs = false instantiations, their code as before): its R = NR (n_obs +
// n_mov) obstacle rows are state rows like the pair rows (masked by
// selection at stage 0), split over the lanes by row as the pair rows are;
// each row's Gauss-Newton weights and gradient terms go into a table [5, R]
// in the slot, and the lane of its robot adds them to the robot's xy
// gradient and 2x2 block. The stage's duals in the slot grow by R (Slot::
// floats_obs sizes the slot from R, not from m alone). The 3 n_obs obstacle
// entries sit in the parameter block in shared memory, after the pair
// parameters and before the alphas; the schedule of the moving obstacles is
// read from device memory in the standard layout [B, N, n_mov, 2] (or one
// shared [N, n_mov, 2]), a stage's 2 n_mov floats as a stage's duals are.
// Static rows take dist = sqrt(max(d2, 1e-12)) (obs_c<true>), the guard of
// the plain dense formulation (ocp/problem.py::stage_constraints).
//
// The roofline tools' variants (template flags of the pair-only
// instantiation; their defaults compile to K1, whose code stays as it was):
// kPhase (k1_variants.cuh), the phase ablation of K8
// (tools/exp_mega_phases.py), kEarlyExit = false, a fixed iteration count,
// and kDense, K9's dense expansion layout (tools/exp_blocked_expansions.py):
// lxx [n, n] and luu [nu, nu] materialized in the slot after K1's blocks
// (Slot::floats_dense), each lane filling its own 3x3 block (r, q) of lxx
// and 2x2 block of luu (two pairs that share a robot add into the same
// diagonal entries, so the pair lanes never scatter into it), the Q blocks
// reading them back. The modes without a line search roll alpha = 1 out
// once an iteration, into the candidate buffer, with no merit; inv_solve
// forms L^-1 in the slot (lane j its column j; row-major over the factor,
// transposed over its transpose) and each substitution lane takes two
// triangular matrix-vector products; no_solve divides by Quu's diagonal on
// the substitution lanes and skips the Cholesky.
#pragma once

#include "k1_variants.cuh"
#include "rollout.cuh"

namespace nmpc {

constexpr int kWarp = 32;

// The rows of a block of M rows that one lane owns (lane i: rows i, i + 32,
// ...): 1 up to M = 32.
template <int M>
constexpr int kOwn = (M + kWarp - 1) / kWarp;

// The most robots K1 and K2 take: a control row and a row of Quu's factor a
// lane (nu = 2m <= 32).
constexpr int kMaxRobots = 16;

// The pair rows a lane owns: two up to m = 11 (np <= 64), as the design had
// them before lanes owned more rows.
template <int NR>
constexpr int kPairRows = NR * (NR - 1) / 2 <= 2 * kWarp ? 2 : kOwn<NR * (NR - 1) / 2>;

#ifndef NMPC_HOST_WARP
// the warp primitives; a host rehearsal of this header defines its own
NMPC_DEV void warp_sync() { __syncwarp(); }
NMPC_DEV float shfl_xor(float v, int m) { return __shfl_xor_sync(0xffffffffu, v, m); }
NMPC_DEV float shfl(float v, int src) { return __shfl_sync(0xffffffffu, v, src); }
#endif

// K1's phase probes, compiled in only with -DNMPC_K1_PROBES (the build of
// tools/k1_phases.py): each lane reads clock64 at every NMPC_PROBE(i) and adds
// the cycles since the previous mark to its counter i; lane 0 of each warp
// adds its counters to g_phase when its scenario ends. Without the flag they
// are empty, and K1's code is the same as without them.
#ifdef NMPC_K1_PROBES
__device__ unsigned long long g_phase[16];
#define NMPC_PROBE_COUNTERS(w)          \
  unsigned long long probe_counters[16] = {}; \
  (w).clk = probe_counters
#define NMPC_PROBE_START(counters)              \
  unsigned long long* const probe_clk = (counters); \
  unsigned long long probe_t0 = clock64()
#define NMPC_PROBE_RESTART() probe_t0 = clock64()
#define NMPC_PROBE(i)                                 \
  do {                                                \
    const unsigned long long probe_t1 = clock64();    \
    probe_clk[i] += probe_t1 - probe_t0;              \
    probe_t0 = probe_t1;                              \
  } while (0)
#define NMPC_PROBE_FLUSH() \
  for (int i = 0; i < 16; ++i) atomicAdd(&g_phase[i], probe_clk[i])
#else
#define NMPC_PROBE_COUNTERS(w) ((void)0)
#define NMPC_PROBE_START(counters) ((void)0)
#define NMPC_PROBE_RESTART() ((void)0)
#define NMPC_PROBE(i) ((void)0)
#define NMPC_PROBE_FLUSH() ((void)0)
#endif

// Butterfly sum: every lane ends with the same bits, as both partners of a
// step add the same two operands.
NMPC_DEV float warp_sum(float v) {
#pragma unroll
  for (int m = kWarp / 2; m > 0; m >>= 1) v = v + shfl_xor(v, m);
  return v;
}

// min_nan over the warp: a NaN on any lane wins.
NMPC_DEV float warp_min_nan(float v) {
#pragma unroll
  for (int m = kWarp / 2; m > 0; m >>= 1) v = min_nan(v, shfl_xor(v, m));
  return v;
}

// robots (i, j), i < j, of pair row p, in the order d12, d13, ..., d(m-1)m
template <int NR>
NMPC_DEV void pair_robots(int p, int& i, int& j) {
  i = 0;
  while (p >= NR - 1 - i) {
    p -= NR - 1 - i;
    ++i;
  }
  j = i + 1 + p;
}

// One warp's slot of shared memory, in floats; every block starts on a
// 16-byte boundary, so rows of nu floats load as float4 (float2 for odd m).
// megasolve.cu sizes each launch's dynamic shared memory from `floats_obs`.
#ifdef __CUDACC__
#define NMPC_HD __host__ __device__
#else
#define NMPC_HD
#endif

template <int NR>
struct Slot {
  static constexpr int n = 3 * NR, nu = 2 * NR, np = NR * (NR - 1) / 2;
  NMPC_HD static constexpr int al(int v) { return (v + 3) / 4 * 4; }
  static constexpr int V0 = 0;                     // Vxx of stage k + 1 [n, n]
  static constexpr int V1 = al(V0 + n * n);        // Qxx, then Vxx of stage k
  static constexpr int QuxT = al(V1 + n * n);      // Qux transposed [n, nu]
  static constexpr int L = al(QuxT + n * nu);      // Quu, then its factor [nu, nu]
  static constexpr int LT = al(L + nu * nu);       // the factor transposed
  static constexpr int inv = al(LT + nu * nu);     // reciprocals of its diagonal
  static constexpr int Vx = al(inv + nu);          // [n]
  static constexpr int Qx = al(Vx + n);            // [n]
  static constexpr int Qu = al(Qx + n);            // [nu]
  static constexpr int lx = al(Qu + nu);           // [n]
  static constexpr int lu = al(lx + n);            // [nu]
  static constexpr int lxx = al(lu + nu);          // diagonal of lxx [n]
  static constexpr int luu = al(lxx + n);          // diagonal of luu [nu]
  static constexpr int E = al(luu + nu);           // e1, e2, bc, bs [4, NR]
  static constexpr int Dg = al(E + 4 * NR);        // Dxx, Dyy, Dxy [3, NR]
  // per pair of robots (r, j), symmetric, 0 at r = j: wxx, wyy, wxy, and
  // the gradient terms -+ gx act, -+ gy act with robot r's sign [5, NR, NR]
  static constexpr int PW = al(Dg + 3 * NR);
  static constexpr int x = al(PW + 5 * NR * NR);   // stage or rollout state [n]
  static constexpr int u = al(x + n);              // [nu]
  static constexpr int dx = al(u + nu);            // rollout: x - xbar [n]
  static constexpr int xr = al(dx + n);            // stage reference [n]
  static constexpr int lam = al(xr + n);           // stage duals [np + 2 nu + 2 n]
  static constexpr int floats = al(lam + np + 2 * nu + 2 * n);
  static constexpr int bytes = 4 * floats;
  // the obstacle variant with R obstacle rows: the duals grow by R
  // [np + R + 2 nu + 2 n], and the rows' table [5, R] (wxx, wyy, wxy and the
  // x and y gradient terms) follows them
  NMPC_HD static constexpr int ow(int R) { return al(lam + np + R + 2 * nu + 2 * n); }
  NMPC_HD static constexpr int floats_obs(int R) { return R == 0 ? floats : al(ow(R) + 5 * R); }
  // K9's dense layout (kDense, the pair-only slot): lxx [n, n] and luu
  // [nu, nu] after the rest
  static constexpr int Hxx = floats;
  static constexpr int Huu = al(Hxx + n * n);
  static constexpr int floats_dense = al(Huu + nu * nu);
};

// Loads and stores of V consecutive floats, V = 4, 2 or 1, as one vector
// access (the address aligned to 4 V bytes).
template <int V>
NMPC_DEV void load_chunk(const float* src, float* dst) {
  if constexpr (V == 4) {
    const float4 v = *reinterpret_cast<const float4*>(src);
    dst[0] = v.x;
    dst[1] = v.y;
    dst[2] = v.z;
    dst[3] = v.w;
  } else if constexpr (V == 2) {
    const float2 v = *reinterpret_cast<const float2*>(src);
    dst[0] = v.x;
    dst[1] = v.y;
  } else {
    dst[0] = src[0];
  }
}

template <int V>
NMPC_DEV void store_chunk(float* dst, const float* src) {
  if constexpr (V == 4) {
    *reinterpret_cast<float4*>(dst) = make_float4(src[0], src[1], src[2], src[3]);
  } else if constexpr (V == 2) {
    *reinterpret_cast<float2*>(dst) = make_float2(src[0], src[1]);
  } else {
    dst[0] = src[0];
  }
}

// the widest vector access that M consecutive floats split into
template <int M>
constexpr int kVec = M % 4 == 0 ? 4 : M % 2 == 0 ? 2 : 1;

template <int M>
NMPC_DEV void load_vec(const float* src, float* dst) {
#pragma unroll
  for (int i = 0; i < M; i += kVec<M>) load_chunk<kVec<M>>(src + i, dst + i);
}

template <int M>
NMPC_DEV void store_vec(float* dst, const float* src) {
#pragma unroll
  for (int i = 0; i < M; i += kVec<M>) store_chunk<kVec<M>>(dst + i, src + i);
}

struct WarpArgs {
  const float* prm;   // parameter block (ops/rollout.py::_pack_params)
  const float* x0;    // [B, n]
  const float* xref;  // [B, N, n]
  const float* lam;   // [B, N, nc]
  const float* mu;    // [B]
  const float* Uin;   // [B, N, nu] warm controls
  float* Xs;          // [B, N, n] out: stage states 0..N-1
  float* U;           // [B, N, nu] out: controls
  float* cost;        // [B] out: AL merit of the returned iterate
  int* iters;         // [B] out: counted inner iterations
  float* kff;         // [B, N, nu] scratch: feedforward gains
  float* Kfb;         // [B, N, n, nu] scratch: feedback gains, transposed
  float* Xw;          // [2, B, N, n] scratch: candidate trajectories
  float* Uw;          // [2, B, N, nu]
  int B, N, n_inner, adaptive, n_alphas, ls_rounds, pairs, slot_floats;
  float reg, armijo, tol_cost, ls_beta, ls_grow, ls_trial_min;
  // the obstacle variant only: the moving obstacles' schedule ([B, N, n_mov,
  // 2], or [N, n_mov, 2] shared: mov_stride floats between scenarios, 0)
  const float* mov;
  int n_obs, n_mov, mov_stride;
};

struct ALArgs {
  const float* prm;   // parameter block
  const float* Xs;    // [B, N, n] stage states 0..N-1
  const float* U;     // [B, N, nu]
  const float* lam;   // [B, N, nc]
  const float* mu;    // [B]
  float* lam_out;     // [B, N, nc]
  float* viol;        // [B]
  int B, N, pairs;
  float lam_max;
  const float* mov;   // the obstacle variant only, as WarpArgs
  int n_obs, n_mov, mov_stride;
};

// One scenario as its warp sees it: the parameter block and the warp's slot
// in shared memory, this lane, and the scenario's rows of the global arrays.
// Three trajectory buffers (X [N, n], U [N, nu]) rotate: the current
// iterate (c), the best candidate of the line search so far (b) and the
// candidate being rolled out (t); accepting a step swaps pointers.
template <int NR>
struct Lanes {
  const float* sp;
  float* s;
  int lane, N, nc;
  bool pairs;
  float mu;
  const float *x0, *xref, *lam, *Uin;
  float *kff, *Kfb;
  float *Xc, *Uc, *Xb, *Ub, *Xt, *Ut;
  int pa[kPairRows<NR>], pb[kPairRows<NR>];  // robots of this lane's pair rows lane, lane + 32, ...
  // the obstacle variant only: obstacle rows R, their counts, the obstacle
  // entries of the parameter block, the scenario's schedule [N, n_mov, 2]
  // and the slot's table of the rows' terms
  int R, n_obs, n_mov;
  const float *obs, *mov;
  float* ow;
#ifdef NMPC_K1_PROBES
  unsigned long long* clk;  // the phase probes' counters
#endif
};

template <class T>
NMPC_DEV void swap_ptr(T*& a, T*& b) {
  T* t = a;
  a = b;
  b = t;
}

// Obstacle row e of a stage at the state x (robot-major: static rows r n_obs
// + o, then moving rows NR n_obs + r n_mov + o; mov_k: the stage's schedule
// [n_mov, 2]): returns c and sets the row's robot r and dc/dpx, dc/dpy.
template <int NR>
NMPC_DEV float obstacle_row(const float* x, const float* obs, const float* mov_k, float dmin2,
                            int n_obs, int n_mov, int e, int& r, float& gx, float& gy) {
  const int ns = NR * n_obs;
  if (e < ns) {
    r = e / n_obs;
    const int o = e - r * n_obs;
    const float dx = x[3 * r] - obs[3 * o], dy = x[3 * r + 1] - obs[3 * o + 1];
    float dist;
    const float c = obs_c<true>(dx, dy, obs[3 * o + 2], &dist);
    gx = dx / dist;
    gy = dy / dist;
    return c;
  }
  e -= ns;
  r = e / n_mov;
  const int o = e - r * n_mov;
  const float dx = x[3 * r] - mov_k[2 * o], dy = x[3 * r + 1] - mov_k[2 * o + 1];
  gx = 2.f * dx;
  gy = 2.f * dy;
  return pair_c(dx, dy, dmin2);
}

// One stage of a rollout as lane i needs it (fetched when the stage starts:
// a stage ahead measured no faster, and costs registers): the nominal state
// row xb and control row ub with its gains (kff, row i of K),
// and for the merit the reference row and the duals of the lane's rows.
template <int NR, bool kWide = (kOwn<3 * NR> > 1)>
struct StageRows {
  float xb, ub, kf, xr, K[3 * NR];
  float lx[2], lu[2], lp[2];  // duals: x_lo, x_hi of row i; u_lo, u_hi; pairs i, i + 32
};

// ... and where a lane owns kX > 1 state rows (m >= 11), its further rows
// i + 32 q (q = 1 .. kX - 1) in xb2, xr2, lx2, and pairs i, i + 32, ...
template <int NR>
struct StageRows<NR, true> {
  static constexpr int kX = kOwn<3 * NR>;
  float xb, ub, kf, xr, K[3 * NR];
  float lx[2], lu[2], lp[kPairRows<NR>];
  float xb2[kX - 1], xr2[kX - 1], lx2[kX - 1][2];
};

// Stage k's rows of the nominal (Xn, Un) and, with `feedback`, of the gains
// (else ub is the warm control Uin's row).
template <int NR, bool kObs>
NMPC_DEV void fetch_stage(const Lanes<NR>& w, const float* Xn, const float* Un, bool feedback,
                          int k, StageRows<NR>& f) {
  using D = Dims<NR>;
  constexpr int n = D::n, nu = D::nu, np = D::np;
  const int i = w.lane;
  const float* lam = w.lam + (size_t)k * w.nc;
  const int row_u = (w.pairs ? np : 0) + (kObs ? w.R : 0), row_x = row_u + 2 * nu;
  if (i < n) {
    f.xb = feedback ? Xn[(size_t)k * n + i] : 0.f;
    f.xr = w.xref[(size_t)k * n + i];
    f.lx[0] = lam[row_x + i];
    f.lx[1] = lam[row_x + n + i];
  }
  if constexpr (kOwn<n> > 1) {
#pragma unroll
    for (int q = 1; q < kOwn<n>; ++q) {
      const int r = i + q * kWarp;
      if (r < n) {
        f.xb2[q - 1] = feedback ? Xn[(size_t)k * n + r] : 0.f;
        f.xr2[q - 1] = w.xref[(size_t)k * n + r];
        f.lx2[q - 1][0] = lam[row_x + r];
        f.lx2[q - 1][1] = lam[row_x + n + r];
      }
    }
  }
  if (i < nu) {
    const size_t at = (size_t)k * nu + i;
    f.ub = Un[at];
    f.lu[0] = lam[row_u + i];
    f.lu[1] = lam[row_u + nu + i];
    if (feedback) {
      f.kf = w.kff[at];
      const float* KT = w.Kfb + (size_t)k * n * nu + i;  // K[i, j] at KT[j nu]
#pragma unroll
      for (int j = 0; j < n; ++j) f.K[j] = KT[(size_t)j * nu];
    }
  }
  if (np > 0 && w.pairs) {
#pragma unroll
    for (int q = 0; q < kPairRows<NR>; ++q)
      if (i + q * kWarp < np) f.lp[q] = lam[i + q * kWarp];
  }
}

// This lane's share of stage k's AL merit at the slot's (x, u): tracking
// terms into `track`, squared PHR activations into `pen`. Lane i takes state
// row i (tracking, x_lo, x_hi; then its further state rows i + 32, ...),
// control row i (tracking, u_lo, u_hi) and the pair rows i, i + 32, ... (and
// the obstacle rows i, i + 32, ...), in that order. At stage 0
// the state, pair and obstacle rows are masked by selection: a non-finite
// activation there must not leak into the merit.
template <int NR, bool kObs>
NMPC_DEV void merit_terms(const Lanes<NR>& w, int k, const StageRows<NR>& f, float& track,
                          float& pen) {
  using D = Dims<NR>;
  using S = Slot<NR>;
  constexpr int n = D::n, nu = D::nu, np = D::np;
  const float* sp = w.sp;
  const float* x = w.s + S::x;
  const float* u = w.s + S::u;
  const bool gate = k > 0;
  const int i = w.lane;
  if (i < n) {
    const float xi = x[i];
    const float d = xi - f.xr;
    track += sp[D::q + i] * d * d;
    float lo = relu(al_step(f.lx[0], w.mu, xi - sp[D::x_lo + i]));
    float hi = relu(al_step(f.lx[1], w.mu, sp[D::x_hi + i] - xi));
    lo = gate ? lo : 0.f;
    hi = gate ? hi : 0.f;
    pen += lo * lo;
    pen += hi * hi;
  }
  if constexpr (kOwn<n> > 1) {
#pragma unroll
    for (int q = 1; q < kOwn<n>; ++q) {
      const int r = i + q * kWarp;
      if (r < n) {
        const float xi = x[r];
        const float d = xi - f.xr2[q - 1];
        track += sp[D::q + r] * d * d;
        float lo = relu(al_step(f.lx2[q - 1][0], w.mu, xi - sp[D::x_lo + r]));
        float hi = relu(al_step(f.lx2[q - 1][1], w.mu, sp[D::x_hi + r] - xi));
        lo = gate ? lo : 0.f;
        hi = gate ? hi : 0.f;
        pen += lo * lo;
        pen += hi * hi;
      }
    }
  }
  if (i < nu) {
    const float ui = u[i];
    track += sp[D::r + i] * ui * ui;
    const float lo = relu(al_step(f.lu[0], w.mu, ui - sp[D::u_lo + i]));
    const float hi = relu(al_step(f.lu[1], w.mu, sp[D::u_hi + i] - ui));
    pen += lo * lo;
    pen += hi * hi;
  }
  if (np > 0 && w.pairs) {
#pragma unroll
    for (int q = 0; q < kPairRows<NR>; ++q) {
      if (i + q * kWarp >= np) break;
      const int a = w.pa[q], b = w.pb[q];
      const float c = pair_c(x[3 * a] - x[3 * b], x[3 * a + 1] - x[3 * b + 1], sp[D::dmin2]);
      float act = relu(al_step(f.lp[q], w.mu, c));
      act = gate ? act : 0.f;
      pen += act * act;
    }
  }
  if constexpr (kObs) {
    const float* lam = w.lam + (size_t)k * w.nc + (w.pairs ? np : 0);
    const float* mov_k = w.mov + (size_t)k * 2 * w.n_mov;
    for (int e = i; e < w.R; e += kWarp) {
      int r;
      float gx, gy;
      const float c = obstacle_row<NR>(x, w.obs, mov_k, sp[D::dmin2], w.n_obs, w.n_mov, e, r,
                                       gx, gy);
      float act = relu(al_step(lam[e], w.mu, c));
      act = gate ? act : 0.f;
      pen += act * act;
    }
  }
}

// x <- x + dt f(x, u) on the slot's state; robot r on lane r.
template <int NR>
NMPC_DEV void euler_step(const Lanes<NR>& w) {
  using S = Slot<NR>;
  float* x = w.s + S::x;
  const float* u = w.s + S::u;
  const float dt = w.sp[Dims<NR>::dt];
  const int r = w.lane;
  float xn0 = 0.f, xn1 = 0.f, xn2 = 0.f;
  if (r < NR) {
    float sn, cs;
    const float th = x[3 * r + 2];
    sincosf(th, &sn, &cs);
    const float v = u[2 * r], om = u[2 * r + 1];
    xn0 = x[3 * r] + dt * v * cs;
    xn1 = x[3 * r + 1] + dt * v * sn;
    xn2 = th + dt * om;
  }
  warp_sync();
  if (r < NR) {
    x[3 * r] = xn0;
    x[3 * r + 1] = xn1;
    x[3 * r + 2] = xn2;
  }
  warp_sync();
}

// Rollout from x0 that stores its stage states and controls in (Xo, Uo) and
// returns its AL merit (kMerit = false: no merit, returns 0; the phase
// ablation's alpha = 1 steps and sweep_only's initial rollout).
// feedback = true: the closed loop u = ubar + alpha kff + K (x - xbar)
// around the nominal (Xn, Un) under the gains in w.kff / w.Kfb;
// feedback = false: the warm controls Un (= w.Uin).
template <int NR, bool kObs, bool kMerit = true>
NMPC_DEV float rollout_warp(const Lanes<NR>& w, const float* Xn, const float* Un, float alpha,
                            bool feedback, float* Xo, float* Uo) {
  using S = Slot<NR>;
  constexpr int n = Dims<NR>::n, nu = Dims<NR>::nu;
  float* x = w.s + S::x;
  float* u = w.s + S::u;
  float* dx = w.s + S::dx;
  const int i = w.lane;
  StageRows<NR> cur{};
  if (i < n) x[i] = w.x0[i];
  if constexpr (kOwn<n> > 1) {
#pragma unroll
    for (int q = 1; q < kOwn<n>; ++q)
      if (i + q * kWarp < n) x[i + q * kWarp] = w.x0[i + q * kWarp];
  }
  warp_sync();
  float track = 0.f, pen = 0.f;
  for (int k = 0; k < w.N; ++k) {
    fetch_stage<NR, kObs>(w, Xn, Un, feedback, k, cur);
    if (i < n) {
      const float xi = x[i];
      dx[i] = xi - cur.xb;
      Xo[(size_t)k * n + i] = xi;
    }
    if constexpr (kOwn<n> > 1) {
#pragma unroll
      for (int q = 1; q < kOwn<n>; ++q) {
        const int r = i + q * kWarp;
        if (r < n) {
          const float xi = x[r];
          dx[r] = xi - cur.xb2[q - 1];
          Xo[(size_t)k * n + r] = xi;
        }
      }
    }
    warp_sync();
    if (i < nu) {
      float acc = cur.ub;
      if (feedback) {
        float d[n];
        load_vec<n>(dx, d);
        acc = acc + alpha * cur.kf;
#pragma unroll
        for (int j = 0; j < n; ++j) acc = acc + cur.K[j] * d[j];
      }
      u[i] = acc;
      Uo[(size_t)k * nu + i] = acc;
    }
    warp_sync();
    if constexpr (kMerit) merit_terms<NR, kObs>(w, k, cur, track, pen);
    euler_step<NR>(w);
  }
  if constexpr (kMerit) {
    return warp_sum(track) + warp_sum(pen) / (2.f * w.mu);
  } else {
    return 0.f;
  }
}

// Backward Riccati sweep over the current iterate (w.Xc, w.Uc) with the
// structured Gauss-Newton expansions computed on the fly; writes the gains
// to w.kff / w.Kfb and returns dV1 = sum_k kff_k . Qu_k on every lane.
//   Qx = lx + A^T Vx, Qu = lu + B^T Vx, Quu = luu + B^T Vxx B,
//   Qux = B^T Vxx A, Qxx = lxx + A^T Vxx A,
//   [kff | K] = -(Quu + reg I)^-1 [Qu | Qux],
//   Vx' = Qx + Qux^T kff, Vxx' = Qxx + Qux^T K
// with A = I + E (E[3r, 3r+2] = e1[r], E[3r+1, 3r+2] = e2[r]) and B[3r, 2r]
// = bc[r], B[3r+1, 2r] = bs[r], B[3r+2, 2r+1] = dt. Each sum is taken in the
// first design's order. Stage k - 1's rows are fetched into registers while
// stage k is computed (the obstacle variant copies its stage's duals into
// the slot when the stage starts). The obstacle rows add to their robot's
// lx, lxx as the pair rows do. kPhase and kDense: the roofline tools'
// variants (head note; Phase::full and the structured layout are K1's).
template <int NR, bool kObs, Phase kPhase = Phase::full, bool kDense = false>
NMPC_DEV float backward_sweep_warp(const Lanes<NR>& w, float reg) {
  using D = Dims<NR>;
  using S = Slot<NR>;
  constexpr int n = D::n, nu = D::nu, np = D::np;
  constexpr bool kCon = kPhase != Phase::no_expcon;  // the expansion's constraint rows
  static_assert(!kObs || (kPhase == Phase::full && !kDense), "the variants are pair-only");
  static_assert(!kDense || kPhase == Phase::full, "K9's layouts run the full iteration");
  constexpr int C = kVec<nu>;                       // chunk of a factor row
  constexpr int kLam = (np + 2 * nu + 2 * n + kWarp - 1) / kWarp;  // duals per lane
  constexpr int kX = kOwn<n>;         // state rows a lane owns
  constexpr int kRhs = kOwn<n + 1>;   // right-hand sides a lane owns (kff, K's n columns)
  const float* sp = w.sp;
  float* s = w.s;
  const int lane = w.lane;
  const float dt = sp[D::dt];
  const float mu = w.mu;
  const bool pairs = w.pairs;
  const int nc = w.nc;
  const int row_o = pairs ? np : 0, row_u = row_o + (kObs ? w.R : 0), row_x = row_u + 2 * nu;
  const float* x = s + S::x;
  const float* u = s + S::u;
  const float* lam = s + S::lam;
  const float* E = s + S::E;  // e1 [0, NR), e2 [NR, 2 NR), bc, bs
  float* Lm = s + S::L;
  float* LT = s + S::LT;
  float* inv = s + S::inv;
  float* QuxT = s + S::QuxT;
  float* V = s + S::V0;
  float* Q = s + S::V1;

  // this lane's rows of stage k: state and reference row, control row, duals
  float fx = 0.f, fxr = 0.f, fu = 0.f, fl[kLam];
  auto fetch = [&](int k) {
    if (lane < n) {
      fx = w.Xc[(size_t)k * n + lane];
      fxr = w.xref[(size_t)k * n + lane];
    }
    if (lane < nu) fu = w.Uc[(size_t)k * nu + lane];
    if constexpr (!kObs) {
#pragma unroll
      for (int q = 0; q < kLam; ++q) {
        const int e = lane + q * kWarp;
        fl[q] = e < nc ? w.lam[(size_t)k * nc + e] : 0.f;
      }
    }
  };
  fetch(w.N - 1);
  for (int e = lane; e < n * n; e += kWarp) V[e] = 0.f;
  if (lane < n) s[S::Vx + lane] = 0.f;
  if constexpr (kX > 1) {
#pragma unroll
    for (int q = 1; q < kX; ++q)
      if (lane + q * kWarp < n) s[S::Vx + lane + q * kWarp] = 0.f;
  }
  float dV1 = 0.f;  // lane 0's
  NMPC_PROBE_START(w.clk);
  for (int k = w.N - 1; k >= 0; --k) {
    const bool gate = k > 0;
    // ---- stage k's iterate, reference and duals into the slot
    if (lane < n) {
      s[S::x + lane] = fx;
      s[S::xr + lane] = fxr;
    }
    if constexpr (kX > 1) {   // a lane's further rows, read when the stage starts
#pragma unroll
      for (int q = 1; q < kX; ++q) {
        const int r = lane + q * kWarp;
        if (r < n) {
          s[S::x + r] = w.Xc[(size_t)k * n + r];
          s[S::xr + r] = w.xref[(size_t)k * n + r];
        }
      }
    }
    if (lane < nu) s[S::u + lane] = fu;
    if constexpr (kObs) {
      for (int e = lane; e < nc; e += kWarp) s[S::lam + e] = w.lam[(size_t)k * nc + e];
    } else {
#pragma unroll
      for (int q = 0; q < kLam; ++q) {
        if (lane + q * kWarp < nc) s[S::lam + lane + q * kWarp] = fl[q];
      }
    }
    if (k > 0) fetch(k - 1);
    warp_sync();

    NMPC_PROBE(0);
    // ---- expansion, box rows: lane i takes state row i (and its further
    // rows i + 32, ... where it owns them) and control row i
    // (Phase::no_expcon: the tracking terms and 2Q, 2R alone)
    if (lane < n) {
      const int i = lane;
      const float xi = x[i];
      const float g = 2.f * sp[D::q + i] * (xi - s[S::xr + i]);
      if constexpr (kCon) {
        float alo = relu(al_step(lam[row_x + i], mu, xi - sp[D::x_lo + i]));
        float ahi = relu(al_step(lam[row_x + n + i], mu, sp[D::x_hi + i] - xi));
        alo = gate ? alo : 0.f;
        ahi = gate ? ahi : 0.f;
        s[S::lx + i] = g - alo + ahi;
        s[S::lxx + i] = 2.f * sp[D::q + i] + mu * ((alo > 0.f ? 1.f : 0.f) + (ahi > 0.f ? 1.f : 0.f));
      } else {
        s[S::lx + i] = g;
        s[S::lxx + i] = 2.f * sp[D::q + i];
      }
    }
    if constexpr (kX > 1) {
      static_assert(kCon, "the tools' variants take m <= 10");
#pragma unroll
      for (int q = 1; q < kX; ++q) {
        const int i = lane + q * kWarp;
        if (i >= n) break;
        const float xi = x[i];
        const float g = 2.f * sp[D::q + i] * (xi - s[S::xr + i]);
        float alo = relu(al_step(lam[row_x + i], mu, xi - sp[D::x_lo + i]));
        float ahi = relu(al_step(lam[row_x + n + i], mu, sp[D::x_hi + i] - xi));
        alo = gate ? alo : 0.f;
        ahi = gate ? ahi : 0.f;
        s[S::lx + i] = g - alo + ahi;
        s[S::lxx + i] = 2.f * sp[D::q + i] + mu * ((alo > 0.f ? 1.f : 0.f) + (ahi > 0.f ? 1.f : 0.f));
      }
    }
    if (lane < nu) {
      const int i = lane;
      const float ui = u[i];
      const float g = 2.f * sp[D::r + i] * ui;
      if constexpr (kCon) {
        const float alo = relu(al_step(lam[row_u + i], mu, ui - sp[D::u_lo + i]));
        const float ahi = relu(al_step(lam[row_u + nu + i], mu, sp[D::u_hi + i] - ui));
        s[S::lu + i] = g - alo + ahi;
        s[S::luu + i] = 2.f * sp[D::r + i] + mu * ((alo > 0.f ? 1.f : 0.f) + (ahi > 0.f ? 1.f : 0.f));
      } else {
        s[S::lu + i] = g;
        s[S::luu + i] = 2.f * sp[D::r + i];
      }
    }
    warp_sync();

    NMPC_PROBE(1);
    // ---- expansion, pair rows: pair p (robots a < b) on lane p (and p + 32,
    // ...): its Gauss-Newton weights and gradient terms into both entries
    // (a, b) and (b, a) of the slot's pair table (Phase::no_expcon: none, the
    // table stays 0)
    if (kCon && np > 0 && pairs) {
#pragma unroll
      for (int q = 0; q < kPairRows<NR>; ++q) {
        const int p = lane + q * kWarp;
        if (p >= np) break;
        const int a = w.pa[q], b = w.pb[q];
        const float ddx = x[3 * a] - x[3 * b];
        const float ddy = x[3 * a + 1] - x[3 * b + 1];
        float act = relu(al_step(lam[p], mu, pair_c(ddx, ddy, sp[D::dmin2])));
        act = gate ? act : 0.f;
        const float wt = act > 0.f ? mu : 0.f;
        const float gx = 2.f * ddx, gy = 2.f * ddy;
        const float val[5] = {wt * gx * gx, wt * gy * gy, wt * gx * gy, gx * act, gy * act};
#pragma unroll
        for (int t = 0; t < 5; ++t) {
          float* tab = s + S::PW + t * NR * NR;
          tab[a * NR + b] = t < 3 ? val[t] : -val[t];
          tab[b * NR + a] = val[t];
        }
      }
      warp_sync();
    }
    // ---- expansion, obstacle rows: row e on lane e (and e + 32, ...): its
    // Gauss-Newton weights and gradient terms into the slot's table
    if constexpr (kObs) {
      const float* mov_k = w.mov + (size_t)k * 2 * w.n_mov;
      for (int e = lane; e < w.R; e += kWarp) {
        int r;
        float gx, gy;
        const float c = obstacle_row<NR>(x, w.obs, mov_k, sp[D::dmin2], w.n_obs, w.n_mov, e, r,
                                         gx, gy);
        float act = relu(al_step(lam[row_o + e], mu, c));
        act = gate ? act : 0.f;
        const float wt = act > 0.f ? mu : 0.f;
        w.ow[e] = wt * gx * gx;
        w.ow[w.R + e] = wt * gy * gy;
        w.ow[2 * w.R + e] = wt * gx * gy;
        w.ow[3 * w.R + e] = -(gx * act);
        w.ow[4 * w.R + e] = -(gy * act);
      }
      warp_sync();
    }

    // ---- expansion, dynamics of robot r on lane r, and the sums over its
    // pairs (in the order of the other robot; the table's 0 at j = r adds
    // nothing); then Qx and Qu of its rows
    if (lane < NR) {
      const int r = lane;
      float sn, cs;
      sincosf(x[3 * r + 2], &sn, &cs);
      const float v = u[2 * r];
      const float e1 = -dt * v * sn, e2 = dt * v * cs, bc = dt * cs, bs = dt * sn;
      s[S::E + r] = e1;
      s[S::E + NR + r] = e2;
      s[S::E + 2 * NR + r] = bc;
      s[S::E + 3 * NR + r] = bs;
      float lx0 = s[S::lx + 3 * r], lx1 = s[S::lx + 3 * r + 1];
      float dxx = 0.f, dyy = 0.f, dxy = 0.f;
      if (kCon && pairs) {
        float t[5][NR];
#pragma unroll
        for (int k = 0; k < 5; ++k) load_vec<NR>(s + S::PW + (k * NR + r) * NR, t[k]);
#pragma unroll
        for (int j = 0; j < NR; ++j) {
          dxx = dxx + t[0][j];
          dyy = dyy + t[1][j];
          dxy = dxy + t[2][j];
          lx0 = lx0 + t[3][j];
          lx1 = lx1 + t[4][j];
        }
      }
      if constexpr (kObs) {
        // robot r's rows: static r n_obs + o, then moving NR n_obs + r n_mov + o
        for (int t = 0; t < w.n_obs + w.n_mov; ++t) {
          const int e = t < w.n_obs ? r * w.n_obs + t : NR * w.n_obs + r * w.n_mov + t - w.n_obs;
          dxx = dxx + w.ow[e];
          dyy = dyy + w.ow[w.R + e];
          dxy = dxy + w.ow[2 * w.R + e];
          lx0 = lx0 + w.ow[3 * w.R + e];
          lx1 = lx1 + w.ow[4 * w.R + e];
        }
      }
      s[S::Dg + r] = dxx;
      s[S::Dg + NR + r] = dyy;
      s[S::Dg + 2 * NR + r] = dxy;
      const float* Vx = s + S::Vx;
      const float v0 = Vx[3 * r], v1 = Vx[3 * r + 1], v2 = Vx[3 * r + 2];
      s[S::Qx + 3 * r] = lx0 + v0;
      s[S::Qx + 3 * r + 1] = lx1 + v1;
      s[S::Qx + 3 * r + 2] = s[S::lx + 3 * r + 2] + v2 + e1 * v0 + e2 * v1;
      s[S::Qu + 2 * r] = s[S::lu + 2 * r] + (bc * v0 + bs * v1);
      s[S::Qu + 2 * r + 1] = s[S::lu + 2 * r + 1] + dt * v2;
    }
    warp_sync();

    // ---- K9's dense layout: lane bq fills its 3x3 block (r, q) of lxx (the
    // box rows' diagonal where r = q, the pair weights on (x, y) as the
    // structured form adds them) and 2x2 block of luu in the slot
    if constexpr (kDense) {
      for (int bq = lane; bq < NR * NR; bq += kWarp) {
        const int r = bq / NR, q = bq - r * NR;
        float pw[3] = {0.f, 0.f, 0.f};
        if (pairs) {
#pragma unroll
          for (int k = 0; k < 3; ++k)
            pw[k] = r == q ? s[S::Dg + k * NR + r] : -s[S::PW + (k * NR + r) * NR + q];
        }
#pragma unroll
        for (int t = 0; t < 3; ++t) {
#pragma unroll
          for (int c = 0; c < 3; ++c) {
            float l = (r == q && t == c) ? s[S::lxx + 3 * q + c] : 0.f;
            if (pairs && t < 2 && c < 2) l = l + pw[t == c ? t : 2];
            s[S::Hxx + (3 * r + t) * n + 3 * q + c] = l;
          }
        }
#pragma unroll
        for (int a = 0; a < 2; ++a) {
#pragma unroll
          for (int c = 0; c < 2; ++c)
            s[S::Huu + (2 * r + a) * nu + 2 * q + c] = (r == q && a == c) ? s[S::luu + 2 * q + c] : 0.f;
        }
      }
      warp_sync();
    }

    NMPC_PROBE(2);
    // ---- Qux = B^T (Vxx A), Qxx = lxx + A^T (Vxx A) and Quu = luu + B^T
    // Vxx B from the 3x3 block of Vxx of robots (r, q), one block per lane:
    // Qxx's block into the other copy of Vxx, Qux's 2x3 block transposed,
    // and for r >= q Quu's 2x2 block (its lower triangle)
    for (int bq = lane; bq < NR * NR; bq += kWarp) {
      const int r = bq / NR, q = bq - r * NR;
      float v[3][3];
#pragma unroll
      for (int t = 0; t < 3; ++t) {
#pragma unroll
        for (int c = 0; c < 3; ++c) v[t][c] = V[(3 * r + t) * n + 3 * q + c];
      }
      const float e1r = E[r], e2r = E[NR + r], bcr = E[2 * NR + r], bsr = E[3 * NR + r];
      const float e1q = E[q], e2q = E[NR + q], bcq = E[2 * NR + q], bsq = E[3 * NR + q];
      // Vxx A: A's column 3q + 2 carries e1, e2
      float va[3][3];
#pragma unroll
      for (int t = 0; t < 3; ++t) {
        va[t][0] = v[t][0];
        va[t][1] = v[t][1];
        va[t][2] = v[t][2] + v[t][0] * e1q + v[t][1] * e2q;
      }
#pragma unroll
      for (int c = 0; c < 3; ++c) {
        const float qu[2] = {bcr * va[0][c] + bsr * va[1][c], dt * va[2][c]};
        store_chunk<2>(QuxT + (3 * q + c) * nu + 2 * r, qu);
      }
      // lxx's block: its diagonal (r = q) and the pair (and obstacle) weights
      // on (x, y); without pair rows the table off the diagonal holds zeros
      // (kDense: read back from the slot's dense lxx)
      float pw[3] = {0.f, 0.f, 0.f};
      if (!kDense && kCon && (pairs || kObs)) {
#pragma unroll
        for (int k = 0; k < 3; ++k)
          pw[k] = r == q ? s[S::Dg + k * NR + r] : -s[S::PW + (k * NR + r) * NR + q];
      }
#pragma unroll
      for (int t = 0; t < 3; ++t) {
#pragma unroll
        for (int c = 0; c < 3; ++c) {
          float l;
          if constexpr (kDense) {
            l = s[S::Hxx + (3 * r + t) * n + 3 * q + c];
          } else {
            l = (r == q && t == c) ? s[S::lxx + 3 * q + c] : 0.f;
            if (kCon && (pairs || kObs) && t < 2 && c < 2) l = l + pw[t == c ? t : 2];
          }
          float val = l + va[t][c];
          if (t == 2) val = val + e1r * va[0][c] + e2r * va[1][c];
          Q[(3 * r + t) * n + 3 * q + c] = val;
        }
      }
      if (r >= q) {
        // (Vxx B)[3r + t, 2q + c] and the lower triangle of B^T (Vxx B)
        float vb[3][2];
#pragma unroll
        for (int t = 0; t < 3; ++t) {
          vb[t][0] = bcq * v[t][0] + bsq * v[t][1];
          vb[t][1] = dt * v[t][2];
        }
#pragma unroll
        for (int a = 0; a < 2; ++a) {
#pragma unroll
          for (int c = 0; c < 2; ++c) {
            const int j = 2 * r + a, i = 2 * q + c;
            if (j < i) continue;
            const float val = a == 0 ? bcr * vb[0][c] + bsr * vb[1][c] : dt * vb[2][c];
            if constexpr (kDense) {
              Lm[j * nu + i] = s[S::Huu + j * nu + i] + val;
            } else {
              Lm[j * nu + i] = (i == j ? s[S::luu + i] : 0.f) + val;
            }
          }
        }
      }
    }
    warp_sync();

    NMPC_PROBE(3);
    // ---- Cholesky of Quu + reg I, column by column, row j on lane j (in
    // registers; published row-major and transposed); reg inside the square
    // root, as riccati.cuh::chol (Phase::no_solve: none)
    if constexpr (kPhase != Phase::no_solve) {
      float row[nu];
#pragma unroll
      for (int i = 0; i < nu; ++i) row[i] = 0.f;
      if (lane < nu) load_vec<nu>(Lm + lane * nu, row);
#pragma unroll
      for (int i = 0; i < nu; ++i) {
        float v = row[i];
#pragma unroll
        for (int k0 = 0; k0 < i; k0 += C) {
          float c[C];
          load_chunk<C>(Lm + i * nu + k0, c);
#pragma unroll
          for (int t = 0; t < C; ++t)
            if (k0 + t < i) v = v - row[k0 + t] * c[t];
        }
        // every lane takes the same path (row[i] of the lanes <= i is never
        // read again), so the column costs no divergent branch
        const float iv = 1.f / sqrtf(shfl(v, i) + reg);
        const float l = v * iv;
        row[i] = l;
        if (lane == i) inv[i] = iv;
        if (lane > i && lane < nu) {
          Lm[lane * nu + i] = l;
          LT[i * nu + lane] = l;
        }
        warp_sync();
      }
    }
    // ---- Phase::inv_solve: the factor's inverse, column j on lane j in
    // registers (riccati.cuh::chol_inverse's sums, each from 0, the entries
    // above the column 0), then published row-major over the factor and
    // transposed over its transpose
    if constexpr (kPhase == Phase::inv_solve) {
      float col[nu];
      if (lane < nu) {
        float iv[nu];
        load_vec<nu>(inv, iv);
#pragma unroll
        for (int i = 0; i < nu; ++i) {
          float acc = 0.f;
#pragma unroll
          for (int k0 = 0; k0 < i; k0 += C) {
            float c[C];
            load_chunk<C>(Lm + i * nu + k0, c);
#pragma unroll
            for (int t = 0; t < C; ++t)
              if (k0 + t < i) acc = acc + c[t] * col[k0 + t];
          }
          col[i] = i < lane ? 0.f : i == lane ? iv[i] : -iv[i] * acc;
        }
      }
      warp_sync();
      if (lane < nu) {
#pragma unroll
        for (int i = 0; i < nu; ++i)
          if (i >= lane) Lm[i * nu + lane] = col[i];
        store_vec<nu>(LT + lane * nu, col);
      }
      warp_sync();
    }

    NMPC_PROBE(4);
    // ---- substitutions, one right-hand side per lane: lane 0 solves for
    // kff (rhs Qu), lane c + 1 for column c of K (rhs column c of Qux)
    // (Phase::no_solve: -rhs_i / (Quu_ii + reg); Phase::inv_solve:
    // -L^-T (L^-1 rhs), L^-1 row-major in Lm and transposed in LT)
    float y[nu];
#pragma unroll
    for (int i = 0; i < nu; ++i) y[i] = 0.f;
    if (lane <= n) {
      float iv[nu];
      if constexpr (kPhase == Phase::no_solve) {
#pragma unroll
        for (int i = 0; i < nu; ++i) iv[i] = 1.f / (Lm[i * nu + i] + reg);
      } else {
        load_vec<nu>(inv, iv);
      }
      load_vec<nu>(lane == 0 ? s + S::Qu : QuxT + (lane - 1) * nu, y);
      if constexpr (kPhase == Phase::no_solve) {
#pragma unroll
        for (int i = 0; i < nu; ++i) y[i] = iv[i] * y[i];
      } else if constexpr (kPhase == Phase::inv_solve) {
        float z[nu];
#pragma unroll
        for (int i = 0; i < nu; ++i) {   // z = L^-1 rhs
          float acc = 0.f;
#pragma unroll
          for (int k0 = 0; k0 <= i; k0 += C) {
            float c[C];
            load_chunk<C>(Lm + i * nu + k0, c);
#pragma unroll
            for (int t = 0; t < C; ++t)
              if (k0 + t <= i) acc = acc + c[t] * y[k0 + t];
          }
          z[i] = acc;
        }
#pragma unroll
        for (int i = 0; i < nu; ++i) {   // y = L^-T z
          float acc = 0.f;
#pragma unroll
          for (int k0 = i / C * C; k0 < nu; k0 += C) {
            float c[C];
            load_chunk<C>(LT + i * nu + k0, c);
#pragma unroll
            for (int t = 0; t < C; ++t)
              if (k0 + t >= i) acc = acc + c[t] * z[k0 + t];
          }
          y[i] = acc;
        }
      } else {
#pragma unroll
        for (int i = 0; i < nu; ++i) {
          float acc = y[i];
#pragma unroll
          for (int k0 = 0; k0 < i; k0 += C) {
            float c[C];
            load_chunk<C>(Lm + i * nu + k0, c);
#pragma unroll
            for (int t = 0; t < C; ++t)
              if (k0 + t < i) acc = acc - c[t] * y[k0 + t];
          }
          y[i] = acc * iv[i];
        }
#pragma unroll
        for (int i = nu - 1; i >= 0; --i) {
          float acc = y[i];
#pragma unroll
          for (int k0 = (i + 1) / C * C; k0 < nu; k0 += C) {
            float c[C];
            load_chunk<C>(LT + i * nu + k0, c);
#pragma unroll
            for (int t = 0; t < C; ++t)
              if (k0 + t > i) acc = acc - c[t] * y[k0 + t];
          }
          y[i] = acc * iv[i];
        }
      }
#pragma unroll
      for (int i = 0; i < nu; ++i) y[i] = -y[i];
    }

    NMPC_PROBE(5);
    // ---- gains out (K transposed: lane c + 1 stores its column as a row),
    // and the value function of stage k, row a at a time on lanes 0..n:
    // lane 0 Vx[a] = Qx[a] + Qux[:, a] . kff, lane c + 1 Vxx[a, c] = Qxx[a, c]
    // + Qux[:, a] . K[:, c] (in place over Qxx); lane 0 also sums dV1
    if (lane == 0) {
      store_vec<nu>(w.kff + (size_t)k * nu, y);
      float sum = 0.f;
#pragma unroll
      for (int i = 0; i < nu; ++i) sum += y[i] * s[S::Qu + i];
      dV1 = dV1 + sum;
    } else if (lane <= n) {
      store_vec<nu>(w.Kfb + ((size_t)k * n + lane - 1) * nu, y);
    }
    NMPC_PROBE(6);
    float* dst = lane == 0 ? s + S::Vx : Q + lane - 1;   // row a at dst[a * step]
    const float* src = lane == 0 ? s + S::Qx : Q + lane - 1;
    const int step = lane == 0 ? 1 : n;
#pragma unroll 1
    for (int a = 0; a < n; ++a) {
      float q[nu];
      load_vec<nu>(QuxT + a * nu, q);
      float acc = q[0] * y[0];
#pragma unroll
      for (int i = 1; i < nu; ++i) acc = acc + q[i] * y[i];
      if (lane <= n) dst[a * step] = src[a * step] + acc;
    }
    // ---- a lane's further right-hand sides lane + 32 q (q >= 1, m >= 11):
    // the substitutions, gains and value update above, column rhs - 1 of K
    if constexpr (kRhs > 1) {
      static_assert(kPhase == Phase::full, "the tools' variants take m <= 10");
#pragma unroll
      for (int h = 1; h < kRhs; ++h) {
        const int rhs = lane + h * kWarp;
        if (rhs > n) break;
        float iv[nu], y2[nu];
        load_vec<nu>(inv, iv);
        load_vec<nu>(QuxT + (rhs - 1) * nu, y2);
#pragma unroll
        for (int i = 0; i < nu; ++i) {
          float acc = y2[i];
#pragma unroll
          for (int k0 = 0; k0 < i; k0 += C) {
            float c[C];
            load_chunk<C>(Lm + i * nu + k0, c);
#pragma unroll
            for (int t = 0; t < C; ++t)
              if (k0 + t < i) acc = acc - c[t] * y2[k0 + t];
          }
          y2[i] = acc * iv[i];
        }
#pragma unroll
        for (int i = nu - 1; i >= 0; --i) {
          float acc = y2[i];
#pragma unroll
          for (int k0 = (i + 1) / C * C; k0 < nu; k0 += C) {
            float c[C];
            load_chunk<C>(LT + i * nu + k0, c);
#pragma unroll
            for (int t = 0; t < C; ++t)
              if (k0 + t > i) acc = acc - c[t] * y2[k0 + t];
          }
          y2[i] = acc * iv[i];
        }
#pragma unroll
        for (int i = 0; i < nu; ++i) y2[i] = -y2[i];
        store_vec<nu>(w.Kfb + ((size_t)k * n + rhs - 1) * nu, y2);
#pragma unroll 1
        for (int a = 0; a < n; ++a) {
          float q[nu];
          load_vec<nu>(QuxT + a * nu, q);
          float acc = q[0] * y2[0];
#pragma unroll
          for (int i = 1; i < nu; ++i) acc = acc + q[i] * y2[i];
          Q[a * n + rhs - 1] = Q[a * n + rhs - 1] + acc;
        }
      }
    }
    NMPC_PROBE(7);
    warp_sync();
    float* t = V;
    V = Q;
    Q = t;
  }
  return shfl(dV1, 0);
}

// K1: the inner iLQR solve of scenario b (n_inner iterations at most), with
// the semantics of megasolve.cuh::inner_solve_thread (the first design):
//  * initial rollout of the warm controls and its merit;
//  * each iteration: backward sweep, line search, accepted step (here the
//    trajectory its candidate rollout stored: the first design rolls the
//    accepted alpha out again, to the same bits);
//  * cascade line search: every alpha in turn, accept when Armijo holds and
//    the merit beats the best so far;
//  * adaptive line search: the trial step restarts at 1 on every launch; up
//    to ls_rounds first-accept rounds, shrinking by ls_beta on rejection; an
//    accepted step grows by ls_grow (capped at 1) for the next iteration; a
//    scenario that fails keeps iterating and gives up once its trial is
//    <= ls_trial_min;
//  * an iteration counts only if the scenario is still not done after it;
//    a done scenario leaves (its further iterations would be no-ops).
// Every lane holds the same scalars (merits come from warp_sum), so every
// branch below is taken by the whole warp.
// The roofline tools' variants (pair-only; the defaults are K1): kPhase, the
// phase ablation (k1_variants.cuh; every mode but `full` runs the sweep and
// then, but for sweep_only, one alpha = 1 rollout without a merit that
// becomes the iterate); kEarlyExit = false, the stop rule off: n_inner
// iterations, each counted; kDense, K9's dense expansion layout (the slot
// then holds Slot::floats_dense).
template <int NR, bool kObs, Phase kPhase = Phase::full, bool kEarlyExit = true,
          bool kDense = false>
NMPC_DEV void inner_solve_warp(const WarpArgs& a, const float* sp, float* slot, int b,
                               int lane) {
  static_assert(!kObs || (kPhase == Phase::full && kEarlyExit && !kDense),
                "the variants are pair-only");
  static_assert(NR <= kMaxRobots, "a control row and a factor row a lane: m <= 16");
  using D = Dims<NR>;
  constexpr int n = D::n, nu = D::nu;
  const size_t N = a.N;
  Lanes<NR> w;
  w.sp = sp;
  w.s = slot;
  w.lane = lane;
  w.N = a.N;
  w.pairs = a.pairs != 0;
  w.nc = n_rows<NR>(w.pairs);
  if constexpr (kObs) {
    w.n_obs = a.n_obs;
    w.n_mov = a.n_mov;
    w.R = NR * (a.n_obs + a.n_mov);
    w.nc += w.R;
    w.obs = sp + D::alphas;
    w.mov = a.mov + (size_t)b * a.mov_stride;
    w.ow = slot + Slot<NR>::ow(w.R);
  }
  w.mu = a.mu[b];
  w.x0 = a.x0 + (size_t)b * n;
  w.xref = a.xref + (size_t)b * N * n;
  w.lam = a.lam + (size_t)b * N * w.nc;
  w.Uin = a.Uin + (size_t)b * N * nu;
  float* const Xout = a.Xs + (size_t)b * N * n;
  float* const Uout = a.U + (size_t)b * N * nu;
  w.Xc = Xout;
  w.Uc = Uout;
  w.Xb = a.Xw + (size_t)b * N * n;
  w.Ub = a.Uw + (size_t)b * N * nu;
  w.Xt = a.Xw + (size_t)(a.B + b) * N * n;
  w.Ut = a.Uw + (size_t)(a.B + b) * N * nu;
  w.kff = a.kff + (size_t)b * N * nu;
  w.Kfb = a.Kfb + (size_t)b * N * n * nu;
#pragma unroll
  for (int q = 0; q < kPairRows<NR>; ++q) {
    w.pa[q] = w.pb[q] = 0;
    if (lane + q * kWarp < D::np) pair_robots<NR>(lane + q * kWarp, w.pa[q], w.pb[q]);
  }
  // the pair table's diagonal stays 0 (the sweep writes the rest)
  for (int e = lane; e < 5 * NR * NR; e += kWarp) slot[Slot<NR>::PW + e] = 0.f;

  NMPC_PROBE_COUNTERS(w);
  NMPC_PROBE_START(w.clk);
  float cost = rollout_warp<NR, kObs, kPhase != Phase::sweep_only>(w, nullptr, w.Uin, 0.f,
                                                                     false, w.Xc, w.Uc);
  NMPC_PROBE(10);
  int iters = 0;
  float trial = 1.f;
  for (int it = 0; it < a.n_inner; ++it) {
    NMPC_PROBE_RESTART();
    const float slope = relu(-backward_sweep_warp<NR, kObs, kPhase, kDense>(w, a.reg));
    NMPC_PROBE(11);
    if constexpr (kPhase == Phase::sweep_only) {
      ++iters;
      continue;
    } else if constexpr (kPhase != Phase::full) {
      rollout_warp<NR, kObs, false>(w, w.Xc, w.Uc, 1.f, true, w.Xt, w.Ut);
      swap_ptr(w.Xc, w.Xt);
      swap_ptr(w.Uc, w.Ut);
      ++iters;
      continue;
    }
    float best_cost = cost, best_alpha = 0.f;
    if (a.adaptive) {
      for (int rr = 0; rr < a.ls_rounds; ++rr) {
        const float al = trial;
        const float ca = rollout_warp<NR, kObs>(w, w.Xc, w.Uc, al, true, w.Xt, w.Ut);
        const float expected = a.armijo * al * slope;
        if ((cost - ca) >= expected && ca < cost) {
          best_cost = ca;
          best_alpha = al;
          swap_ptr(w.Xb, w.Xt);
          swap_ptr(w.Ub, w.Ut);
          break;
        }
        trial = trial * a.ls_beta;
      }
      if (best_alpha > 0.f) trial = fminf(1.f, best_alpha * a.ls_grow);
    } else {
      for (int ai = 0; ai < a.n_alphas; ++ai) {
        const float al = sp[D::alphas + (kObs ? 3 * a.n_obs : 0) + ai];
        const float ca = rollout_warp<NR, kObs>(w, w.Xc, w.Uc, al, true, w.Xt, w.Ut);
        const float expected = a.armijo * al * slope;
        if ((cost - ca) >= expected && ca < best_cost) {
          best_cost = ca;
          best_alpha = al;
          swap_ptr(w.Xb, w.Xt);
          swap_ptr(w.Ub, w.Ut);
        }
      }
    }
    NMPC_PROBE(12);
    const bool improved = best_alpha > 0.f;
    if (improved) {
      swap_ptr(w.Xc, w.Xb);
      swap_ptr(w.Uc, w.Ub);
    }
    const float cost_new = improved ? best_cost : cost;
    const float rel = (cost - cost_new) / (1.f + fabsf(cost));
    const bool stop = a.adaptive
        ? ((improved && rel < a.tol_cost) || (!improved && trial <= a.ls_trial_min))
        : (!improved || rel < a.tol_cost);
    cost = cost_new;
    if (kEarlyExit && stop) break;
    ++iters;
  }
  if (w.Xc != Xout) {  // the iterate ended in a scratch buffer
    for (int e = lane; e < a.N * n; e += kWarp) Xout[e] = w.Xc[e];
    for (int e = lane; e < a.N * nu; e += kWarp) Uout[e] = w.Uc[e];
  }
  if (lane == 0) {
    a.cost[b] = cost;
    NMPC_PROBE_FLUSH();
    a.iters[b] = iters;
  }
}

// K2 for scenario b: lam <- min(max(0, lam - mu c), lam_max) over every
// c >= 0 row, with the state-dependent rows of stage 0 set to BIG
// (constraint_mask), and viol = max(0, -min c). The scenario's N nc rows are
// one contiguous run in lam and lam_out; lane e takes rows e, e + 32, ...
// The obstacle variant (kObs) has the R obstacle rows after the pair rows,
// its obstacle entries in sp after the pair parameters.
template <int NR, bool kObs>
NMPC_DEV void al_update_warp(const ALArgs& a, const float* sp, int b, int lane) {
  using D = Dims<NR>;
  constexpr int n = D::n, nu = D::nu, np = D::np;
  const bool pairs = a.pairs != 0;
  const int R = kObs ? NR * (a.n_obs + a.n_mov) : 0;
  const int nc = n_rows<NR>(pairs) + R, npr = pairs ? np : 0;
  const size_t N = a.N;
  const float mu = a.mu[b];
  const float* X = a.Xs + (size_t)b * N * n;
  const float* U = a.U + (size_t)b * N * nu;
  const float* lam = a.lam + (size_t)b * N * nc;
  float* out = a.lam_out + (size_t)b * N * nc;
  float cmin = kBig;
  const int total = a.N * nc;
  for (int e = lane; e < total; e += kWarp) {
    const int k = e / nc;
    int t = e - k * nc;
    const float* x = X + (size_t)k * n;
    const float* u = U + (size_t)k * nu;
    const bool first = k == 0;
    float c;
    if (t < npr) {
      int i, j;
      pair_robots<NR>(t, i, j);
      c = first ? kBig : pair_c(x[3 * i] - x[3 * j], x[3 * i + 1] - x[3 * j + 1], sp[D::dmin2]);
    } else if (kObs && t < npr + R) {
      int r;
      float gx, gy;
      const float* mov_k = a.mov + (size_t)b * a.mov_stride + (size_t)k * 2 * a.n_mov;
      const float co = obstacle_row<NR>(x, sp + D::alphas, mov_k, sp[D::dmin2], a.n_obs, a.n_mov,
                                        t - npr, r, gx, gy);
      c = first ? kBig : co;
    } else if ((t -= npr + R) < nu) {
      c = u[t] - sp[D::u_lo + t];
    } else if ((t -= nu) < nu) {
      c = sp[D::u_hi + t] - u[t];
    } else if ((t -= nu) < n) {
      c = first ? kBig : x[t] - sp[D::x_lo + t];
    } else {
      t -= n;
      c = first ? kBig : sp[D::x_hi + t] - x[t];
    }
    out[e] = min_nan(relu(al_step(lam[e], mu, c)), a.lam_max);
    cmin = min_nan(cmin, c);
  }
  cmin = warp_min_nan(cmin);
  if (lane == 0) a.viol[b] = relu(-cmin);
}

}  // namespace nmpc
