// K1 for one and two robots, designed for Hopper: a team of T lanes per
// scenario, 32 / T scenarios a warp.
//
//   inner_solve_team (K1 at m <= 2): the whole inner AL-iLQR solve of one
//     scenario, the function of inner_warp.cuh::inner_solve_warp (and of
//     ops/megasolve.py::inner_solve_plain) on the same standard-layout
//     inputs and outputs. Replaces the Pallas megakernel
//     nmpc_tpu/ops/megasolve_pallas.py::inner_solve_fused (_make_megakernel)
//     with its obstacle rows, for the problems of one and two robots.
//
// What bounded the warp design at m <= 2 (inner_warp.cuh, one warp per
// scenario; measured on an H100 80GB HBM3 at 700 W, PERF.md): a chain of
// dependent stage steps, not arithmetic or bytes. At m = 1 the state has 3
// rows and the control 2, so every phase kept at most a handful of the 32
// lanes busy; the line search rolled its candidates out one after another,
// 8 of every 9 stage steps of an iteration; each candidate fetched its
// stage rows from device memory again; and every stage step ended in
// __syncwarp and shared-memory round trips.
//
// This design (the team size T, the ring depth D and the register cap are
// compile-time settings, picked with tools/k1_launch.py and recorded in
// PERF.md):
//  * T lanes (a team) own a scenario. Team-local work uses width-T shuffles
//    and __syncwarp on the team's own lane mask only, so a scenario that
//    stops leaves its team idle and never stalls the other teams of its
//    warp.
//  * The backward sweep keeps the whole stage in every lane's registers (n
//    <= 6, nu <= 4: Vxx is 9 or 36 floats) and computes it on every lane
//    alike, so no lane waits for another's block. Only the obstacle rows
//    (up to 47 a stage) are split over the team, robot r's obstacle o on
//    lane o mod T;
//    their Gauss-Newton terms are summed into each robot's xy block by a
//    butterfly of team shuffles, which leaves the same bits on every lane.
//  * The line search rolls its candidates out side by side, one a lane:
//    cascade alpha a on lane a mod T (a grid of more than T alphas in passes
//    of T, in the grid's order), adaptive round r (trial beta^r) on lane r.
//    Each lane keeps its state and controls in registers, evaluates every
//    row of its own candidate and sums its merit in registers; the pick is
//    one team reduction a pass that keeps the serial rules (cascade: the
//    lowest merit among the candidates that pass Armijo and beat the best
//    so far, the first in grid order on a tie; adaptive: the first round
//    accepted).
//  * Stage rows are read once a stage, not once a candidate: the team
//    copies a stage's nominal row, gains, reference, duals and schedule
//    into its ring of D stage slots in shared memory by cp.async, D - 1
//    stages ahead, and every lane reads them there (plain loads into the
//    ring measured slower, PERF.md). Team rings start T floats apart modulo 32 banks, so
//    the teams of a warp read the same entry from different banks.
//  * The accepted step: the accepted alpha is rolled out again with the
//    same arithmetic (the first design's way, bit for bit the candidate's)
//    into the one scratch buffer beside the outputs. Storing every
//    candidate's trajectory instead measured slower (PERF.md).
//  * Picked (tools/k1_launch.py team, PERF.md): T = 8 at m = 1 (4 a warp:
//    at small batches the shorter chain of one pass of 8 alphas wins, at
//    path (b)'s B = 32768 it ties with T = 4) and T = 4 at m = 2 (the
//    adaptive search's 2 rounds idle fewer lanes), D = 3, the register cap
//    of 4 blocks of 128 threads an SM.
//
// Numerics kept from the warp design: relu and min_nan keep a NaN, pair
// rows are rounded without FMA contraction (pair_c), lam - mu c is one fmaf
// (al_step), the stage-0 state, pair and obstacle rows are masked by
// selection, static rows take dist = sqrt(max(d2, 1e-12)) (obs_c<true>),
// f32 throughout. Products that the plain version adds are written as
// explicit fmaf so that the device and the host rehearsal
// (tests/inner_team_host.cpp) compute the same. The merit: each stage's
// terms are summed in the row order of ocp/problem.py::stage_constraints
// (tracking rows, then every c >= 0 row, one fmaf each), and the stage sums
// are added over the horizon with Neumaier's compensated sum (tracking and
// penalty apart); ops/megasolve.py::al_merit_team_order is its plain
// mirror.
#pragma once

#include "inner_warp.cuh"

#ifndef NMPC_K1_TEAM
#define NMPC_K1_TEAM (NMPC_NR == 1 ? 8 : 4)
#endif
#ifndef NMPC_K1_TEAM_RING
#define NMPC_K1_TEAM_RING 3
#endif

namespace nmpc {

constexpr int kTeam = NMPC_K1_TEAM;               // lanes a scenario
constexpr int kRing = NMPC_K1_TEAM_RING;          // stage slots in a team's ring
static_assert(kTeam == 4 || kTeam == 8 || kTeam == 16 || kTeam == 32, "T divides a warp");
static_assert(kRing >= 2 && kRing <= 4, "ring depth");

#ifndef NMPC_HOST_WARP
// the team primitives; a host rehearsal of this header defines its own
NMPC_DEV void team_sync(unsigned mask) { __syncwarp(mask); }
NMPC_DEV float team_shfl(float v, int src, unsigned mask) {
  return __shfl_sync(mask, v, src, kTeam);
}
NMPC_DEV float team_shfl_xor(float v, int m, unsigned mask) {
  return __shfl_xor_sync(mask, v, m, kTeam);
}
// one float of a stage row into the ring
NMPC_DEV void ring_copy(float* dst, const float* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s), "l"(src) : "memory");
}
NMPC_DEV void ring_commit() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }
// wait until at most P of this lane's copy groups are in flight
template <int P>
NMPC_DEV void ring_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(P) : "memory");
}
NMPC_DEV float add_rn(float a, float b) { return __fadd_rn(a, b); }
NMPC_DEV float sub_rn(float a, float b) { return __fsub_rn(a, b); }
#endif

// Layout of one stage slot of the ring, in floats: the nominal state row,
// the nominal (or warm) control row, kff, K (row-major [nu, n]), the
// reference row, the stage's nc duals and the schedule's 2 n_mov floats.
template <int NR>
struct TeamSlot {
  static constexpr int n = 3 * NR, nu = 2 * NR;
  static constexpr int xb = 0, ub = n, kf = n + nu, K = n + 2 * nu, xr = K + nu * n,
                       lam = xr + n;
  NMPC_HD static constexpr int floats(int nc, int n_mov) { return lam + nc + 2 * n_mov; }
  // a team's ring: kRing slots, padded so that consecutive teams start kTeam
  // floats apart modulo the 32 banks
  NMPC_HD static constexpr int ring_floats(int nc, int n_mov) {
    return (kRing * floats(nc, n_mov) + 31) / 32 * 32 + (kTeam % 32);
  }
};

// What a stage fetch reads: the warm controls (initial rollout), the
// iterate (sweep) or the iterate and its gains (candidate rollouts).
enum class Fetch { kWarm, kSweep, kRoll };

// One scenario as its team sees it.
template <int NR>
struct Team {
  const float* sp;   // parameter block (shared memory)
  float* ring;       // the team's ring (shared memory)
  int slot;          // floats a stage slot
  int tl;            // this lane's index in the team
  unsigned mask;     // the team's lanes in the warp
  int N, nc, R, n_obs, n_mov;
  bool pairs;
  float mu;
  const float *x0, *xref, *lam, *Uin, *obs, *mov;
  float *kff, *K;    // the gains [N, nu], [N, nu, n]
  // the two trajectory buffers (X [N, n], U [N, nu]): 0 the outputs, 1 the
  // scratch
  float *X0, *U0, *Xw, *Uw;
#ifdef NMPC_K1_PROBES
  unsigned long long* clk;
#endif
  NMPC_DEV float* X(int i) const { return i == 0 ? X0 : Xw; }
  NMPC_DEV float* U(int i) const { return i == 0 ? U0 : Uw; }
};

// butterfly sum over the team: every lane ends with the same bits
NMPC_DEV float team_sum(float v, unsigned mask) {
#pragma unroll
  for (int m = kTeam / 2; m > 0; m >>= 1) v = v + team_shfl_xor(v, m, mask);
  return v;
}

// The lane whose candidate wins, or kTeam if none is ok: the lowest v among
// the ok lanes, the lowest lane on a tie (a strict order, so the butterfly
// leaves the same winner on every lane).
NMPC_DEV int team_pick(bool ok, float v, unsigned mask, int tl) {
  int i = ok ? tl : kTeam;
#pragma unroll
  for (int m = kTeam / 2; m > 0; m >>= 1) {
    const float ov = team_shfl_xor(v, m, mask);
    const int oi = static_cast<int>(team_shfl_xor(static_cast<float>(i), m, mask));
    if (oi < kTeam && (i == kTeam || ov < v || (ov == v && oi < i))) {
      v = ov;
      i = oi;
    }
  }
  return i;
}

// Neumaier's compensated sum: s + c carries the sum of the terms added
NMPC_DEV void neumaier(float& s, float& c, float v) {
  const float t = add_rn(s, v);
  c = add_rn(c, fabsf(s) >= fabsf(v) ? add_rn(sub_rn(s, t), v) : add_rn(sub_rn(v, t), s));
  s = t;
}

// Copy stage k's rows into ring slot `at`, kTeam lanes striding each row,
// and commit them as one copy group.
template <int NR, bool kObs>
NMPC_DEV void fetch_stage(const Team<NR>& w, Fetch what, const float* Xn, const float* Un, int k,
                          float* s) {
  using L = TeamSlot<NR>;
  constexpr int n = L::n, nu = L::nu;
  const int tl = w.tl;
  if (what != Fetch::kWarm) {
    for (int i = tl; i < n; i += kTeam) ring_copy(s + L::xb + i, Xn + (size_t)k * n + i);
  }
  const float* ub = (what == Fetch::kWarm ? w.Uin : Un) + (size_t)k * nu;
  for (int i = tl; i < nu; i += kTeam) ring_copy(s + L::ub + i, ub + i);
  if (what == Fetch::kRoll) {
    for (int i = tl; i < nu; i += kTeam) ring_copy(s + L::kf + i, w.kff + (size_t)k * nu + i);
    for (int i = tl; i < nu * n; i += kTeam) ring_copy(s + L::K + i, w.K + (size_t)k * nu * n + i);
  }
  for (int i = tl; i < n; i += kTeam) ring_copy(s + L::xr + i, w.xref + (size_t)k * n + i);
  const float* lam = w.lam + (size_t)k * w.nc;
  for (int i = tl; i < w.nc; i += kTeam) ring_copy(s + L::lam + i, lam + i);
  if constexpr (kObs) {
    const float* mov = w.mov + (size_t)k * 2 * w.n_mov;
    float* dst = s + L::lam + w.nc;
    for (int i = tl; i < 2 * w.n_mov; i += kTeam) ring_copy(dst + i, mov + i);
  }
  ring_commit();
}

// The ring's pipeline over the N stages, in order (forward) or from the last
// (backward): `ring_begin` before the stage loop, `ring_next(t)` at the top of
// step t returns the slot of step t's stage, whose rows every lane sees.
template <int NR, bool kObs>
NMPC_DEV void ring_begin(const Team<NR>& w, Fetch what, const float* Xn, const float* Un,
                         bool backward) {
  team_sync(w.mask);  // every lane is done reading the ring's last phase
#pragma unroll
  for (int t = 0; t < kRing - 1; ++t) {
    if (t < w.N)
      fetch_stage<NR, kObs>(w, what, Xn, Un, backward ? w.N - 1 - t : t, w.ring + t * w.slot);
    else
      ring_commit();
  }
}

template <int NR, bool kObs>
NMPC_DEV const float* ring_next(const Team<NR>& w, Fetch what, const float* Xn, const float* Un,
                                bool backward, int t) {
  ring_wait<kRing - 2>();
  team_sync(w.mask);  // step t's rows are in; step t - 1's reads are done
  const int ahead = t + kRing - 1;
  if (ahead < w.N)
    fetch_stage<NR, kObs>(w, what, Xn, Un, backward ? w.N - 1 - ahead : ahead,
                          w.ring + (ahead % kRing) * w.slot);
  else
    ring_commit();
  return w.ring + (t % kRing) * w.slot;
}

// Stage k's AL merit terms at (x, u) from slot s, in the row order of
// stage_constraints: the tracking sum (state rows, then control rows) and
// the sum of squared PHR activations (pairs, static obstacles, moving
// obstacles, u_lo, u_hi, x_lo, x_hi), one fmaf a row. At stage 0 the state,
// pair and obstacle rows are masked by selection.
template <int NR, bool kObs>
NMPC_DEV void stage_terms(const Team<NR>& w, int k, const float* s, const float* x,
                          const float* u, float& track, float& pen) {
  using D = Dims<NR>;
  using L = TeamSlot<NR>;
  constexpr int n = D::n, nu = D::nu, np = D::np;
  const float* sp = w.sp;
  const float* lam = s + L::lam;
  const float mu = w.mu;
  const bool gate = k > 0;
  float tr = 0.f;
#pragma unroll
  for (int i = 0; i < n; ++i) {
    const float d = x[i] - s[L::xr + i];
    tr = fmaf(sp[D::q + i] * d, d, tr);
  }
#pragma unroll
  for (int i = 0; i < nu; ++i) tr = fmaf(sp[D::r + i] * u[i], u[i], tr);
  float pe = 0.f;
  int row = 0;
  if (np > 0 && w.pairs) {
#pragma unroll
    for (int p = 0; p < np; ++p) {
      int a, b;
      pair_robots<NR>(p, a, b);
      const float c = pair_c(x[3 * a] - x[3 * b], x[3 * a + 1] - x[3 * b + 1], sp[D::dmin2]);
      float act = relu(al_step(lam[p], mu, c));
      act = gate ? act : 0.f;
      pe = fmaf(act, act, pe);
    }
    row = np;
  }
  if constexpr (kObs) {
    // rows robot-major: static r n_obs + o, then moving NR n_obs + r n_mov +
    // o (inner_warp.cuh::obstacle_row's order and arithmetic, unrolled)
    const float* mov_k = lam + w.nc;
    const float* lo = lam + row;
#pragma unroll
    for (int r = 0; r < NR; ++r) {
#pragma unroll 2
      for (int o = 0; o < w.n_obs; ++o) {
        const float* ob = w.obs + 3 * o;
        float dist;
        const float c = obs_c<true>(x[3 * r] - ob[0], x[3 * r + 1] - ob[1], ob[2], &dist);
        float act = relu(al_step(lo[r * w.n_obs + o], mu, c));
        act = gate ? act : 0.f;
        pe = fmaf(act, act, pe);
      }
    }
    lo += NR * w.n_obs;
#pragma unroll
    for (int r = 0; r < NR; ++r) {
#pragma unroll 4
      for (int o = 0; o < w.n_mov; ++o) {
        const float c = pair_c(x[3 * r] - mov_k[2 * o], x[3 * r + 1] - mov_k[2 * o + 1],
                               sp[D::dmin2]);
        float act = relu(al_step(lo[r * w.n_mov + o], mu, c));
        act = gate ? act : 0.f;
        pe = fmaf(act, act, pe);
      }
    }
    row += w.R;
  }
#pragma unroll
  for (int i = 0; i < nu; ++i) {
    const float act = relu(al_step(lam[row + i], mu, u[i] - sp[D::u_lo + i]));
    pe = fmaf(act, act, pe);
  }
#pragma unroll
  for (int i = 0; i < nu; ++i) {
    const float act = relu(al_step(lam[row + nu + i], mu, sp[D::u_hi + i] - u[i]));
    pe = fmaf(act, act, pe);
  }
#pragma unroll
  for (int i = 0; i < n; ++i) {
    float act = relu(al_step(lam[row + 2 * nu + i], mu, x[i] - sp[D::x_lo + i]));
    act = gate ? act : 0.f;
    pe = fmaf(act, act, pe);
  }
#pragma unroll
  for (int i = 0; i < n; ++i) {
    float act = relu(al_step(lam[row + 2 * nu + n + i], mu, sp[D::x_hi + i] - x[i]));
    act = gate ? act : 0.f;
    pe = fmaf(act, act, pe);
  }
  track = tr;
  pen = pe;
}

// One lane's rollout from x0, its AL merit returned. Fetch::kRoll: the
// closed loop u = ubar + alpha kff + K (x - xbar) around the iterate (Xn,
// Un) under the gains; Fetch::kWarm: the warm controls. With `store` the
// lane writes its stage states and controls to (Xo, Uo).
template <int NR, bool kObs>
NMPC_DEV float rollout_team(const Team<NR>& w, Fetch what, const float* Xn, const float* Un,
                            float alpha, float* Xo, float* Uo, bool store) {
  using D = Dims<NR>;
  using L = TeamSlot<NR>;
  constexpr int n = D::n, nu = D::nu;
  const float dt = w.sp[D::dt];
  float x[n];
#pragma unroll
  for (int i = 0; i < n; ++i) x[i] = w.x0[i];
  float ts = 0.f, tc = 0.f, ps = 0.f, pc = 0.f;
  NMPC_PROBE_START(w.clk);
  ring_begin<NR, kObs>(w, what, Xn, Un, false);
  for (int k = 0; k < w.N; ++k) {
    const float* s = ring_next<NR, kObs>(w, what, Xn, Un, false, k);
    NMPC_PROBE(5);
    float u[nu];
#pragma unroll
    for (int i = 0; i < nu; ++i) {
      float acc = s[L::ub + i];
      if (what == Fetch::kRoll) {
        acc = fmaf(alpha, s[L::kf + i], acc);
#pragma unroll
        for (int j = 0; j < n; ++j) acc = fmaf(s[L::K + i * n + j], x[j] - s[L::xb + j], acc);
      }
      u[i] = acc;
    }
    if (store) {
#pragma unroll
      for (int i = 0; i < n; ++i) Xo[(size_t)k * n + i] = x[i];
#pragma unroll
      for (int i = 0; i < nu; ++i) Uo[(size_t)k * nu + i] = u[i];
    }
    float tr, pe;
    stage_terms<NR, kObs>(w, k, s, x, u, tr, pe);
    neumaier(ts, tc, tr);
    neumaier(ps, pc, pe);
    // x <- x + dt f(x, u)
#pragma unroll
    for (int r = 0; r < NR; ++r) {
      float sn, cs;
      const float th = x[3 * r + 2];
      sincosf(th, &sn, &cs);
      const float dv = dt * u[2 * r];
      x[3 * r] = fmaf(dv, cs, x[3 * r]);
      x[3 * r + 1] = fmaf(dv, sn, x[3 * r + 1]);
      x[3 * r + 2] = fmaf(dt, u[2 * r + 1], th);
    }
    NMPC_PROBE(6);
  }
  return add_rn(ts, tc) + add_rn(ps, pc) / (2.f * w.mu);
}

// y <- -(L L^T)^-1 y in registers, L the lower factor of chol below (its
// diagonal as the reciprocals iv)
template <int M>
NMPC_DEV void chol_solve_neg(const float (&L)[M][M], const float (&iv)[M], float (&y)[M]) {
#pragma unroll
  for (int i = 0; i < M; ++i) {
    float acc = y[i];
#pragma unroll
    for (int c = 0; c < i; ++c) acc = acc - L[i][c] * y[c];
    y[i] = acc * iv[i];
  }
#pragma unroll
  for (int i = M - 1; i >= 0; --i) {
    float acc = y[i];
#pragma unroll
    for (int c = i + 1; c < M; ++c) acc = acc - L[c][i] * y[c];
    y[i] = acc * iv[i];
  }
#pragma unroll
  for (int i = 0; i < M; ++i) y[i] = -y[i];
}

// Backward Riccati sweep over the iterate (Xc, Uc) with the structured
// Gauss-Newton expansions computed on the fly, every lane holding the whole
// stage in registers; writes the gains to w.kff / w.K (each lane a share of
// the entries) and returns dV1 = sum_k kff_k . Qu_k (the same on every lane).
//   Qx = lx + A^T Vx, Qu = lu + B^T Vx, Quu = luu + B^T Vxx B,
//   Qux = B^T Vxx A, Qxx = lxx + A^T Vxx A,
//   [kff | K] = -(Quu + reg I)^-1 [Qu | Qux],
//   Vx' = Qx + Qux^T kff, Vxx' = Qxx + Qux^T K (its lower triangle, mirrored)
// with A = I + E (E[3r, 3r+2] = e1[r], E[3r+1, 3r+2] = e2[r]) and B[3r, 2r]
// = bc[r], B[3r+1, 2r] = bs[r], B[3r+2, 2r+1] = dt.
template <int NR, bool kObs>
NMPC_DEV float sweep_team(const Team<NR>& w, const float* Xc, const float* Uc, float reg) {
  using D = Dims<NR>;
  using L = TeamSlot<NR>;
  constexpr int n = D::n, nu = D::nu, np = D::np;
  const float* sp = w.sp;
  const float dt = sp[D::dt];
  const float mu = w.mu;
  const int tl = w.tl;
  float V[n][n], Vx[n];
#pragma unroll
  for (int i = 0; i < n; ++i) {
    Vx[i] = 0.f;
#pragma unroll
    for (int j = 0; j < n; ++j) V[i][j] = 0.f;
  }
  float dV1 = 0.f;
  NMPC_PROBE_START(w.clk);
  ring_begin<NR, kObs>(w, Fetch::kSweep, Xc, Uc, true);
  for (int t = 0; t < w.N; ++t) {
    const int k = w.N - 1 - t;
    const float* s = ring_next<NR, kObs>(w, Fetch::kSweep, Xc, Uc, true, t);
    NMPC_PROBE(0);
    const bool gate = k > 0;
    const float* lam = s + L::lam;
    const int row_o = w.pairs ? np : 0, row_u = row_o + (kObs ? w.R : 0), row_x = row_u + 2 * nu;
    float x[n], u[nu];
#pragma unroll
    for (int i = 0; i < n; ++i) x[i] = s[L::xb + i];
#pragma unroll
    for (int i = 0; i < nu; ++i) u[i] = s[L::ub + i];

    // ---- expansion: box rows (every lane)
    float lx[n], lxx[n], lu[nu], luu[nu];
#pragma unroll
    for (int i = 0; i < n; ++i) {
      const float xi = x[i];
      const float g = 2.f * sp[D::q + i] * (xi - s[L::xr + i]);
      float alo = relu(al_step(lam[row_x + i], mu, xi - sp[D::x_lo + i]));
      float ahi = relu(al_step(lam[row_x + n + i], mu, sp[D::x_hi + i] - xi));
      alo = gate ? alo : 0.f;
      ahi = gate ? ahi : 0.f;
      lx[i] = g - alo + ahi;
      lxx[i] = 2.f * sp[D::q + i] + mu * ((alo > 0.f ? 1.f : 0.f) + (ahi > 0.f ? 1.f : 0.f));
    }
#pragma unroll
    for (int i = 0; i < nu; ++i) {
      const float ui = u[i];
      const float g = 2.f * sp[D::r + i] * ui;
      const float alo = relu(al_step(lam[row_u + i], mu, ui - sp[D::u_lo + i]));
      const float ahi = relu(al_step(lam[row_u + nu + i], mu, sp[D::u_hi + i] - ui));
      lu[i] = g - alo + ahi;
      luu[i] = 2.f * sp[D::r + i] + mu * ((alo > 0.f ? 1.f : 0.f) + (ahi > 0.f ? 1.f : 0.f));
    }
    // ---- the xy blocks of the pair and obstacle rows: H[r][q] = (xx, yy,
    // xy) of robots (r, q), and the gradient terms G[r] of robot r
    float H[NR][NR][3], G[NR][2];
#pragma unroll
    for (int r = 0; r < NR; ++r) {
      G[r][0] = G[r][1] = 0.f;
#pragma unroll
      for (int q = 0; q < NR; ++q) H[r][q][0] = H[r][q][1] = H[r][q][2] = 0.f;
    }
    if (np > 0 && w.pairs) {  // np <= 1 here: every lane takes the pair rows
#pragma unroll
      for (int p = 0; p < np; ++p) {
        int a, b;
        pair_robots<NR>(p, a, b);
        const float ddx = x[3 * a] - x[3 * b], ddy = x[3 * a + 1] - x[3 * b + 1];
        float act = relu(al_step(lam[p], mu, pair_c(ddx, ddy, sp[D::dmin2])));
        act = gate ? act : 0.f;
        const float wt = act > 0.f ? mu : 0.f;
        const float gx = 2.f * ddx, gy = 2.f * ddy;
        const float val[3] = {wt * gx * gx, wt * gy * gy, wt * gx * gy};
#pragma unroll
        for (int c = 0; c < 3; ++c) {
          H[a][a][c] += val[c];
          H[b][b][c] += val[c];
          H[a][b][c] -= val[c];
          H[b][a][c] -= val[c];
        }
        G[a][0] -= gx * act;
        G[a][1] -= gy * act;
        G[b][0] += gx * act;
        G[b][1] += gy * act;
      }
    }
    if constexpr (kObs) {
      // robot r's obstacle o on lane o mod T, then summed over the team per
      // robot
      float O[NR][5];
      const float* mov_k = lam + w.nc;
      const float* lo = lam + row_o;
#pragma unroll
      for (int r = 0; r < NR; ++r) {
#pragma unroll
        for (int c = 0; c < 5; ++c) O[r][c] = 0.f;
        auto add = [&](float c, float gx, float gy, float l) {
          float act = relu(al_step(l, mu, c));
          act = gate ? act : 0.f;
          const float wt = act > 0.f ? mu : 0.f;
          O[r][0] += wt * gx * gx;
          O[r][1] += wt * gy * gy;
          O[r][2] += wt * gx * gy;
          O[r][3] += -(gx * act);
          O[r][4] += -(gy * act);
        };
        for (int o = tl; o < w.n_obs; o += kTeam) {
          const float* ob = w.obs + 3 * o;
          const float dx = x[3 * r] - ob[0], dy = x[3 * r + 1] - ob[1];
          float dist;
          const float c = obs_c<true>(dx, dy, ob[2], &dist);
          add(c, dx / dist, dy / dist, lo[r * w.n_obs + o]);
        }
        for (int o = tl; o < w.n_mov; o += kTeam) {
          const float dx = x[3 * r] - mov_k[2 * o], dy = x[3 * r + 1] - mov_k[2 * o + 1];
          add(pair_c(dx, dy, sp[D::dmin2]), 2.f * dx, 2.f * dy,
              lo[NR * w.n_obs + r * w.n_mov + o]);
        }
      }
#pragma unroll
      for (int r = 0; r < NR; ++r) {
#pragma unroll
        for (int c = 0; c < 5; ++c) O[r][c] = team_sum(O[r][c], w.mask);
#pragma unroll
        for (int c = 0; c < 3; ++c) H[r][r][c] += O[r][c];
        G[r][0] += O[r][3];
        G[r][1] += O[r][4];
      }
    }
#pragma unroll
    for (int r = 0; r < NR; ++r) {
      lx[3 * r] += G[r][0];
      lx[3 * r + 1] += G[r][1];
    }
    // lxx(i, j): its diagonal and the xy blocks
    auto lxx_at = [&](int i, int j) -> float {
      const int ri = i / 3, ci = i % 3, rj = j / 3, cj = j % 3;
      float l = i == j ? lxx[i] : 0.f;
      if (ci < 2 && cj < 2) l += H[ri][rj][ci == cj ? ci : 2];
      return l;
    };
    // ---- dynamics
    float e1[NR], e2[NR], bc[NR], bs[NR];
#pragma unroll
    for (int r = 0; r < NR; ++r) {
      float sn, cs;
      sincosf(x[3 * r + 2], &sn, &cs);
      const float v = u[2 * r];
      e1[r] = -dt * v * sn;
      e2[r] = dt * v * cs;
      bc[r] = dt * cs;
      bs[r] = dt * sn;
    }
    NMPC_PROBE(1);

    // ---- Q blocks
    float VA[n][n];  // Vxx A
#pragma unroll
    for (int i = 0; i < n; ++i) {
#pragma unroll
      for (int j = 0; j < n; ++j) {
        VA[i][j] = V[i][j];
        if (j % 3 == 2) VA[i][j] = V[i][j] + V[i][j - 2] * e1[j / 3] + V[i][j - 1] * e2[j / 3];
      }
    }
    float Qxx[n][n], Qux[nu][n], Quu[nu][nu], Qx[n], Qu[nu];
#pragma unroll
    for (int i = 0; i < n; ++i) {
#pragma unroll
      for (int j = 0; j <= i; ++j) {
        float v = lxx_at(i, j) + VA[i][j];
        if (i % 3 == 2) v = v + (e1[i / 3] * VA[i - 2][j] + e2[i / 3] * VA[i - 1][j]);
        Qxx[i][j] = v;
      }
    }
#pragma unroll
    for (int r = 0; r < NR; ++r) {
#pragma unroll
      for (int j = 0; j < n; ++j) {
        Qux[2 * r][j] = bc[r] * VA[3 * r][j] + bs[r] * VA[3 * r + 1][j];
        Qux[2 * r + 1][j] = dt * VA[3 * r + 2][j];
      }
    }
    float VB[n][nu];  // Vxx B
#pragma unroll
    for (int i = 0; i < n; ++i) {
#pragma unroll
      for (int q = 0; q < NR; ++q) {
        VB[i][2 * q] = bc[q] * V[i][3 * q] + bs[q] * V[i][3 * q + 1];
        VB[i][2 * q + 1] = dt * V[i][3 * q + 2];
      }
    }
#pragma unroll
    for (int a = 0; a < nu; ++a) {
#pragma unroll
      for (int c = 0; c <= a; ++c) {
        const int r = a / 2;
        const float v = a % 2 == 0 ? bc[r] * VB[3 * r][c] + bs[r] * VB[3 * r + 1][c]
                                   : dt * VB[3 * r + 2][c];
        Quu[a][c] = (a == c ? luu[a] : 0.f) + v;
      }
    }
#pragma unroll
    for (int j = 0; j < n; ++j) {
      Qx[j] = lx[j] + Vx[j];
      if (j % 3 == 2) Qx[j] = Qx[j] + (e1[j / 3] * Vx[j - 2] + e2[j / 3] * Vx[j - 1]);
    }
#pragma unroll
    for (int r = 0; r < NR; ++r) {
      Qu[2 * r] = lu[2 * r] + (bc[r] * Vx[3 * r] + bs[r] * Vx[3 * r + 1]);
      Qu[2 * r + 1] = lu[2 * r + 1] + dt * Vx[3 * r + 2];
    }
    NMPC_PROBE(2);

    // ---- Cholesky of Quu + reg I (reg inside the square root, as
    // riccati.cuh::chol), then the substitutions for kff and K
    float Lf[nu][nu], iv[nu];
#pragma unroll
    for (int i = 0; i < nu; ++i) {
      float d = Quu[i][i];
#pragma unroll
      for (int c = 0; c < i; ++c) d = d - Lf[i][c] * Lf[i][c];
      iv[i] = 1.f / sqrtf(d + reg);  // the diagonal is used as its reciprocal only
#pragma unroll
      for (int j = i + 1; j < nu; ++j) {
        float v = Quu[j][i];
#pragma unroll
        for (int c = 0; c < i; ++c) v = v - Lf[j][c] * Lf[i][c];
        Lf[j][i] = v * iv[i];
      }
    }
    float kf[nu], Kc[n][nu];  // K by column
#pragma unroll
    for (int i = 0; i < nu; ++i) kf[i] = Qu[i];
    chol_solve_neg<nu>(Lf, iv, kf);
#pragma unroll
    for (int j = 0; j < n; ++j) {
#pragma unroll
      for (int i = 0; i < nu; ++i) Kc[j][i] = Qux[i][j];
      chol_solve_neg<nu>(Lf, iv, Kc[j]);
    }
    NMPC_PROBE(3);

    // ---- gains out (entry e on lane e mod T), dV1, the value function
    {
      float* kg = w.kff + (size_t)k * nu;
      float* Kg = w.K + (size_t)k * nu * n;
#pragma unroll
      for (int e = 0; e < nu + nu * n; ++e) {
        if (e % kTeam == tl) {
          if (e < nu)
            kg[e] = kf[e];
          else
            Kg[e - nu] = Kc[(e - nu) % n][(e - nu) / n];
        }
      }
    }
    float sum = 0.f;
#pragma unroll
    for (int i = 0; i < nu; ++i) sum += kf[i] * Qu[i];
    dV1 = dV1 + sum;
#pragma unroll
    for (int j = 0; j < n; ++j) {
      float acc = Qx[j];
#pragma unroll
      for (int i = 0; i < nu; ++i) acc = acc + Qux[i][j] * kf[i];
      Vx[j] = acc;
    }
#pragma unroll
    for (int a = 0; a < n; ++a) {
#pragma unroll
      for (int c = 0; c <= a; ++c) {
        float acc = Qxx[a][c];
#pragma unroll
        for (int i = 0; i < nu; ++i) acc = acc + Qux[i][a] * Kc[c][i];
        V[a][c] = acc;
        V[c][a] = acc;
      }
    }
    NMPC_PROBE(4);
  }
  return dV1;
}

// K1 at m <= 2: the inner iLQR solve of scenario b (n_inner iterations at
// most) with the semantics of inner_warp.cuh::inner_solve_warp; this lane is
// lane tl of the team whose lanes are `mask`, `ring` the team's ring.
// Every lane of the team holds the same scalars (the sweep is computed alike
// on every lane, merits are shuffled from the winning lane), so every branch
// below is taken by the whole team.
template <int NR, bool kObs>
NMPC_DEV void inner_solve_team(const WarpArgs& a, const float* sp, float* ring, int b, int tl,
                               unsigned mask) {
  using D = Dims<NR>;
  constexpr int n = D::n, nu = D::nu;
  const size_t N = a.N;
  Team<NR> w;
  w.sp = sp;
  w.ring = ring;
  w.tl = tl;
  w.mask = mask;
  w.N = a.N;
  w.pairs = a.pairs != 0;
  w.nc = n_rows<NR>(w.pairs);
  w.R = w.n_obs = w.n_mov = 0;
  w.obs = w.mov = nullptr;
  if constexpr (kObs) {
    w.n_obs = a.n_obs;
    w.n_mov = a.n_mov;
    w.R = NR * (a.n_obs + a.n_mov);
    w.nc += w.R;
    w.obs = sp + D::alphas;
    w.mov = a.mov + (size_t)b * a.mov_stride;
  }
  w.slot = TeamSlot<NR>::floats(w.nc, w.n_mov);
  w.mu = a.mu[b];
  w.x0 = a.x0 + (size_t)b * n;
  w.xref = a.xref + (size_t)b * N * n;
  w.lam = a.lam + (size_t)b * N * w.nc;
  w.Uin = a.Uin + (size_t)b * N * nu;
  w.kff = a.kff + (size_t)b * N * nu;
  w.K = a.Kfb + (size_t)b * N * n * nu;
  w.X0 = a.Xs + (size_t)b * N * n;
  w.U0 = a.U + (size_t)b * N * nu;
  w.Xw = a.Xw + (size_t)b * N * n;
  w.Uw = a.Uw + (size_t)b * N * nu;
  const float* alphas = sp + D::alphas + (kObs ? 3 * a.n_obs : 0);

  NMPC_PROBE_COUNTERS(w);
  NMPC_PROBE_START(w.clk);
  int cur = 0;  // the iterate's buffer; the accepted step goes to the other
  float cost = rollout_team<NR, kObs>(w, Fetch::kWarm, nullptr, nullptr, 0.f, w.X(0), w.U(0),
                                      tl == 0);
  NMPC_PROBE(10);
  int iters = 0;
  float trial = 1.f;
  for (int it = 0; it < a.n_inner; ++it) {
    NMPC_PROBE_RESTART();
    const float* Xc = w.X(cur);
    const float* Uc = w.U(cur);
    const float slope = relu(-sweep_team<NR, kObs>(w, Xc, Uc, a.reg));
    NMPC_PROBE(11);
    float best_cost = cost, best_alpha = 0.f;
    // the winner of a pass becomes the best so far
    auto take = [&](int win, float ca, float al) {
      best_cost = team_shfl(ca, win, mask);
      best_alpha = team_shfl(al, win, mask);
    };
    if (a.adaptive) {
      // rounds r = p T + tl of pass p at trial beta^r, the first accepted wins
      for (int p = 0; p * kTeam < a.ls_rounds; ++p) {
        const bool valid = p * kTeam + tl < a.ls_rounds;
        float al = trial;
        for (int j = 0; j < tl; ++j) al = al * a.ls_beta;
        const float ca = rollout_team<NR, kObs>(w, Fetch::kRoll, Xc, Uc, al, nullptr, nullptr,
                                                false);
        const float expected = a.armijo * al * slope;
        const bool ok = valid && (cost - ca) >= expected && ca < cost;
        const int win = team_pick(ok, 0.f, mask, tl);
        if (win < kTeam) {
          take(win, ca, al);
          break;
        }
        const int rounds = a.ls_rounds - p * kTeam < kTeam ? a.ls_rounds - p * kTeam : kTeam;
        for (int j = 0; j < rounds; ++j) trial = trial * a.ls_beta;
      }
      if (best_alpha > 0.f) trial = fminf(1.f, best_alpha * a.ls_grow);
    } else {
      // alpha i = p T + tl of pass p; the lowest merit that passes Armijo and
      // beats the best so far, the first in grid order on a tie
      for (int p = 0; p * kTeam < a.n_alphas; ++p) {
        const int i = p * kTeam + tl;
        const bool valid = i < a.n_alphas;
        const float al = valid ? alphas[i] : 0.f;
        const float ca = rollout_team<NR, kObs>(w, Fetch::kRoll, Xc, Uc, al, nullptr, nullptr,
                                                false);
        const float expected = a.armijo * al * slope;
        const bool ok = valid && (cost - ca) >= expected && ca < best_cost;
        const int win = team_pick(ok, ca, mask, tl);
        if (win < kTeam) take(win, ca, al);
      }
    }
    NMPC_PROBE(12);
    const bool improved = best_alpha > 0.f;
    if (improved) {
      // the accepted alpha rolled out again: the candidate's bits
      const int next = 1 - cur;
      rollout_team<NR, kObs>(w, Fetch::kRoll, Xc, Uc, best_alpha, w.X(next), w.U(next), tl == 0);
      cur = next;
    }
    NMPC_PROBE(13);
    const float cost_new = improved ? best_cost : cost;
    const float rel = (cost - cost_new) / (1.f + fabsf(cost));
    const bool stop = a.adaptive
        ? ((improved && rel < a.tol_cost) || (!improved && trial <= a.ls_trial_min))
        : (!improved || rel < a.tol_cost);
    cost = cost_new;
    if (stop) break;
    ++iters;
  }
  team_sync(mask);  // the last step's stores are seen by every lane
  if (cur != 0) {   // the iterate ended in a scratch buffer
    const float* Xc = w.X(cur);
    const float* Uc = w.U(cur);
    for (int e = tl; e < a.N * n; e += kTeam) w.X0[e] = Xc[e];
    for (int e = tl; e < a.N * nu; e += kTeam) w.U0[e] = Uc[e];
  }
  if (tl == 0) {
    a.cost[b] = cost;
    NMPC_PROBE_FLUSH();
    a.iters[b] = iters;
  }
}

}  // namespace nmpc
