// K1's first design: the whole inner iLQR solve of one scenario on one
// thread (inner_solve_thread), replacing the Pallas megakernel
// nmpc_tpu/ops/megasolve_pallas.py (_make_megakernel, wrapper
// inner_solve_fused). The solver library runs K1's second design
// (csrc/inner_warp.cuh, one warp per scenario); this one is built only by the
// roofline tools (csrc/tools.cu), where K8 `full` with the early exit is this
// body unchanged: K1's A/B baseline, and the code the phase ablation (K8) and
// the expansion-layout A/B (K9) vary under template flags.
//
// Problem class: NR stacked Euler unicycles with pair rows (optional) and
// u/x box rows; no static or moving obstacles, no LiDAR rays.
//
// One thread owns one scenario. Per-scenario arrays whose size grows with N
// (stage states, controls, gains, xref, lam) stay in global memory in the
// lane-major layout [N, rows, B], so a warp's 32 threads read 32
// neighbouring floats; the value function and the Q-blocks of one stage
// (Vx, Vxx, Qux, Quu, gains) live in thread-local arrays sized by NR.
#pragma once

#include "riccati.cuh"
#include "rollout.cuh"

namespace nmpc {

struct InnerArgs {
  const float* prm;   // parameter block (ops/rollout.py::_pack_params)
  const float* x0;    // [n, B]
  const float* xref;  // [N, n, B]
  const float* lam;   // [N, nc, B]
  const float* mu;    // [B]
  const float* Uin;   // [N, nu, B] warm controls
  float* Xs;          // [N, n, B] out: stage states 0..N-1
  float* U;           // [N, nu, B] out: controls
  float* cost;        // [B] out: AL merit of the returned iterate
  int* iters;         // [B] out: counted inner iterations
  float* kff;         // [N, nu, B] scratch: feedforward gains
  float* Kfb;         // [N, nu, n, B] scratch: feedback gains
  int B, N, n_inner, adaptive, n_alphas, ls_rounds, pairs;
  float reg, armijo, tol_cost, ls_beta, ls_grow, ls_trial_min;
};

// row of pair (i, j), i < j, in the order d12, d13, ..., d(m-1)m
template <int NR>
NMPC_DEV int pair_row(int i, int j) {
  return i * (2 * NR - i - 1) / 2 + (j - i - 1);
}

// Which phases of the inner solve run. K1 is `full` with the early exit;
// the other values are the phase ablations of csrc/tools.cu (K8, port of
// tools/exp_mega_phases.py), which run a fixed iteration count:
//   inv_solve   gains through the explicit L^-1 (chol_inverse), alpha = 1
//   no_ls       no candidate rollouts: alpha = 1
//   no_solve    diagonal gains -Qu / (Quu_ii + reg), alpha = 1
//   no_expcon   LQR-only expansions (no constraint rows, box rows included),
//               alpha = 1
//   sweep_only  no merit, no rollouts: X and U never change
// Every mode but `full` keeps the initial merit as its cost (the reference
// ablation's semantics: only `full` line-searches).
enum class Phase : int { full = 0, inv_solve, no_ls, no_solve, no_expcon, sweep_only };

// Gauss-Newton expansion of one stage's AL merit, kept in structured form:
// A = I + E with E[3r, 3r+2] = e1[r], E[3r+1, 3r+2] = e2[r]; B has
// B[3r, 2r] = bc[r], B[3r+1, 2r] = bs[r], B[3r+2, 2r+1] = dt; lxx is its
// diagonal plus the pair blocks on the (x, y) coordinates; luu and lux are
// diagonal and zero.
template <int NR>
struct Expansion {
  static constexpr int NP = Dims<NR>::np > 0 ? Dims<NR>::np : 1;
  float e1[NR], e2[NR], bc[NR], bs[NR];
  float lx[3 * NR], lu[2 * NR], lxx_d[3 * NR], luu_d[2 * NR];
  float Dxx[NR], Dyy[NR], Dxy[NR];     // diagonal-block pair Hessian sums
  float wxx[NP], wyy[NP], wxy[NP];     // per-pair Hessian weights

  // entry (i, c) of lxx
  NMPC_DEV float lxx(bool pairs, int i, int c) const {
    float v = (i == c) ? lxx_d[i] : 0.f;
    const int a = i / 3, p = i % 3, b = c / 3, q = c % 3;
    if (pairs && p < 2 && q < 2) {
      if (a == b) {
        v = v + ((p == 0 && q == 0) ? Dxx[a] : (p == 1 && q == 1) ? Dyy[a] : Dxy[a]);
      } else {
        const int pr = a < b ? pair_row<NR>(a, b) : pair_row<NR>(b, a);
        v = v + -((p == 0 && q == 0) ? wxx[pr] : (p == 1 && q == 1) ? wyy[pr] : wxy[pr]);
      }
    }
    return v;
  }

  // entry (i, j) of luu
  NMPC_DEV float luu(int i, int j) const { return (i == j) ? luu_d[i] : 0.f; }

  // this stage's expansion (stage_expansion below); kCon = false: without
  // any constraint row (Phase::no_expcon)
  template <bool kCon>
  NMPC_DEV void fill(const float* sp, bool gate, bool pairs, const float* x,
                     const float* u, const float* xr, const float* lam, size_t B,
                     float mu);
};

// nmpc_tpu/ops/megasolve_pallas.py::_expansion_regs (both of its TPU layouts
// compute this). xr and lam are the thread's views of stage k.
template <int NR, bool kCon = true>
NMPC_DEV void stage_expansion(const float* sp, bool gate, bool pairs,
                              const float* x, const float* u, const float* xr,
                              const float* lam, size_t B, float mu,
                              Expansion<NR>& e) {
  using D = Dims<NR>;
  const float dt = sp[D::dt];
#pragma unroll
  for (int r = 0; r < NR; ++r) {
    float s, c;
    sincosf(x[3 * r + 2], &s, &c);
    const float v = u[2 * r];
    e.e1[r] = -dt * v * s;
    e.e2[r] = dt * v * c;
    e.bc[r] = dt * c;
    e.bs[r] = dt * s;
  }
#pragma unroll
  for (int i = 0; i < D::n; ++i) e.lx[i] = 2.f * sp[D::q + i] * (x[i] - xr[(size_t)i * B]);
#pragma unroll
  for (int i = 0; i < D::nu; ++i) e.lu[i] = 2.f * sp[D::r + i] * u[i];
  if constexpr (!kCon) {
    // LQR-only: the quadratic cost's curvature and nothing else
#pragma unroll
    for (int i = 0; i < D::nu; ++i) e.luu_d[i] = 2.f * sp[D::r + i];
#pragma unroll
    for (int i = 0; i < D::n; ++i) e.lxx_d[i] = 2.f * sp[D::q + i];
#pragma unroll
    for (int r = 0; r < NR; ++r) e.Dxx[r] = e.Dyy[r] = e.Dxy[r] = 0.f;
    return;
  }

  int row = pairs ? D::np : 0;
  // u-box rows (never gated)
#pragma unroll
  for (int i = 0; i < D::nu; ++i) {
    const float alo = relu(al_step(lam[(size_t)(row + i) * B], mu, u[i] - sp[D::u_lo + i]));
    const float ahi = relu(al_step(lam[(size_t)(row + D::nu + i) * B], mu, sp[D::u_hi + i] - u[i]));
    e.lu[i] = e.lu[i] - alo + ahi;
    e.luu_d[i] = 2.f * sp[D::r + i] + mu * ((alo > 0.f ? 1.f : 0.f) + (ahi > 0.f ? 1.f : 0.f));
  }
  row += 2 * D::nu;
  // x-box rows, masked hard at stage 0
#pragma unroll
  for (int i = 0; i < D::n; ++i) {
    float alo = relu(al_step(lam[(size_t)(row + i) * B], mu, x[i] - sp[D::x_lo + i]));
    float ahi = relu(al_step(lam[(size_t)(row + D::n + i) * B], mu, sp[D::x_hi + i] - x[i]));
    alo = gate ? alo : 0.f;
    ahi = gate ? ahi : 0.f;
    e.lx[i] = e.lx[i] - alo + ahi;
    e.lxx_d[i] = 2.f * sp[D::q + i] + mu * ((alo > 0.f ? 1.f : 0.f) + (ahi > 0.f ? 1.f : 0.f));
  }
  // pair rows, masked hard at stage 0: gradient 2(p_i - p_j) act into both
  // robots' rows, Gauss-Newton Hessian mu 1[active] g g^T
#pragma unroll
  for (int r = 0; r < NR; ++r) e.Dxx[r] = e.Dyy[r] = e.Dxy[r] = 0.f;
  if (pairs) {
    int p = 0;
#pragma unroll
    for (int i = 0; i < NR; ++i) {
#pragma unroll
      for (int j = i + 1; j < NR; ++j) {
        const float dx = x[3 * i] - x[3 * j];
        const float dy = x[3 * i + 1] - x[3 * j + 1];
        const float c = pair_c(dx, dy, sp[D::dmin2]);
        float act = relu(al_step(lam[(size_t)p * B], mu, c));
        act = gate ? act : 0.f;
        const float w = act > 0.f ? mu : 0.f;
        const float gx = 2.f * dx, gy = 2.f * dy;
        const float gxa = gx * act, gya = gy * act;
        e.lx[3 * i] -= gxa;
        e.lx[3 * i + 1] -= gya;
        e.lx[3 * j] += gxa;
        e.lx[3 * j + 1] += gya;
        const float wxx = w * gx * gx, wyy = w * gy * gy, wxy = w * gx * gy;
        e.wxx[p] = wxx;
        e.wyy[p] = wyy;
        e.wxy[p] = wxy;
        e.Dxx[i] += wxx; e.Dxx[j] += wxx;
        e.Dyy[i] += wyy; e.Dyy[j] += wyy;
        e.Dxy[i] += wxy; e.Dxy[j] += wxy;
        ++p;
      }
    }
  }
}

template <int NR>
template <bool kCon>
NMPC_DEV void Expansion<NR>::fill(const float* sp, bool gate, bool pairs, const float* x,
                                  const float* u, const float* xr, const float* lam,
                                  size_t B, float mu) {
  stage_expansion<NR, kCon>(sp, gate, pairs, x, u, xr, lam, B, mu, *this);
}

// Backward Riccati sweep over the stages of the current iterate (a.Xs, a.U)
// with expansions computed on the fly; writes the gains to a.kff / a.Kfb and
// returns the expected-decrease term dV1 = sum_k kff_k . Qu_k.
//   Vx' = Qx + Qux^T kff,  Vxx' = Qxx + Qux^T Kfb
// (Qux^T Kfb = -Qux^T Quu^-1 Qux is symmetric by construction.)
// Exp is the expansion's layout (K1: the structured Expansion; the layout
// A/B of csrc/tools.cu also runs a dense one); kPhase selects the phase
// ablation's expansions and gains (Phase::full is K1's).
template <int NR, class Exp = Expansion<NR>, Phase kPhase = Phase::full>
NMPC_DEV float backward_sweep(const InnerArgs& a, const float* sp, int b,
                              float mu, int nc) {
  using D = Dims<NR>;
  constexpr int n = D::n, nu = D::nu;
  const size_t B = a.B;
  const float dt = sp[D::dt];
  const bool pairs = kPhase != Phase::no_expcon && a.pairs != 0;
  const float* Xs = a.Xs + b;
  const float* U = a.U + b;
  const float* xref = a.xref + b;
  const float* lam = a.lam + b;
  float* kff = a.kff + b;
  float* Kfb = a.Kfb + b;

  float Vx[n], Vxx[n * n];
#pragma unroll
  for (int i = 0; i < n; ++i) Vx[i] = 0.f;
  for (int i = 0; i < n * n; ++i) Vxx[i] = 0.f;
  float dV1 = 0.f;

  Exp e;
  float x[n], u[nu], Qx[n], Qu[nu], Quu[nu * nu], Qux[nu * n], K[nu * n];
  float kf[nu], inv[nu], col[nu];
#pragma unroll 1
  for (int k = a.N - 1; k >= 0; --k) {
#pragma unroll
    for (int i = 0; i < n; ++i) x[i] = Xs[(size_t)(k * n + i) * B];
#pragma unroll
    for (int i = 0; i < nu; ++i) u[i] = U[(size_t)(k * nu + i) * B];
    e.template fill<kPhase != Phase::no_expcon>(sp, k > 0, pairs, x, u, xref + (size_t)k * n * B,
                                                lam + (size_t)k * nc * B, B, mu);

    // Qx = lx + A^T Vx: rows 3r+2 pick up the E corrections
#pragma unroll
    for (int i = 0; i < n; ++i) Qx[i] = e.lx[i] + Vx[i];
#pragma unroll
    for (int r = 0; r < NR; ++r)
      Qx[3 * r + 2] = Qx[3 * r + 2] + e.e1[r] * Vx[3 * r] + e.e2[r] * Vx[3 * r + 1];
    // Qu = lu + B^T Vx
#pragma unroll
    for (int r = 0; r < NR; ++r) {
      Qu[2 * r] = e.lu[2 * r] + (e.bc[r] * Vx[3 * r] + e.bs[r] * Vx[3 * r + 1]);
      Qu[2 * r + 1] = e.lu[2 * r + 1] + dt * Vx[3 * r + 2];
    }
    // Quu = luu + B^T (Vxx B), lower triangle; VB = Vxx B column by column
#pragma unroll 1
    for (int j = 0; j < nu; ++j) {
      const int r = j / 2;
      for (int i = 0; i <= j; ++i) {
        const int s = i / 2;
        float vb[3];
        for (int t = 0; t < 3; ++t) {
          const float* row = Vxx + (3 * r + t) * n;
          vb[t] = (i % 2 == 0) ? e.bc[s] * row[3 * s] + e.bs[s] * row[3 * s + 1]
                               : dt * row[3 * s + 2];
        }
        const float v = (j % 2 == 0) ? e.bc[r] * vb[0] + e.bs[r] * vb[1] : dt * vb[2];
        Quu[j * nu + i] = e.luu(j, i) + v;
      }
    }
    // per robot block r: VA = Vxx A rows 3r..3r+2, then Qux = B^T VA rows
    // 2r, 2r+1 and Qxx = lxx + A^T VA rows 3r..3r+2, written over Vxx (VA
    // row i needs only Vxx row i, so the other blocks are not disturbed)
#pragma unroll 1
    for (int r = 0; r < NR; ++r) {
      float va[3][n];
      for (int t = 0; t < 3; ++t) {
        const float* row = Vxx + (3 * r + t) * n;
#pragma unroll
        for (int c = 0; c < n; ++c) va[t][c] = row[c];
#pragma unroll
        for (int s = 0; s < NR; ++s)
          va[t][3 * s + 2] = va[t][3 * s + 2] + row[3 * s] * e.e1[s] + row[3 * s + 1] * e.e2[s];
      }
#pragma unroll
      for (int c = 0; c < n; ++c) {
        Qux[(2 * r) * n + c] = e.bc[r] * va[0][c] + e.bs[r] * va[1][c];
        Qux[(2 * r + 1) * n + c] = dt * va[2][c];
      }
      for (int c = 0; c < n; ++c) {
        Vxx[(3 * r) * n + c] = e.lxx(pairs, 3 * r, c) + va[0][c];
        Vxx[(3 * r + 1) * n + c] = e.lxx(pairs, 3 * r + 1, c) + va[1][c];
        Vxx[(3 * r + 2) * n + c] = e.lxx(pairs, 3 * r + 2, c) + va[2][c]
                                   + e.e1[r] * va[0][c] + e.e2[r] * va[1][c];
      }
    }

    // gains: [kff | Kfb] = -(Quu + reg I)^-1 [Qu | Qux]
    if constexpr (kPhase == Phase::no_solve) {
      // diagonal gains: the factorization and substitutions ablated
      for (int i = 0; i < nu; ++i) {
        inv[i] = 1.f / (Quu[i * nu + i] + a.reg);
        kf[i] = -(inv[i] * Qu[i]);
        kff[(size_t)(k * nu + i) * B] = kf[i];
      }
#pragma unroll 1
      for (int c = 0; c < n; ++c) {
        for (int i = 0; i < nu; ++i) {
          K[i * n + c] = -(inv[i] * Qux[i * n + c]);
          Kfb[(size_t)((k * nu + i) * n + c) * B] = K[i * n + c];
        }
      }
    } else if constexpr (kPhase == Phase::inv_solve) {
      // substitutions through the explicit inverse of the factor
      float Linv[nu * nu];
      chol<nu>(Quu, a.reg, inv);
      chol_inverse<nu>(Quu, inv, Linv);
      for (int i = 0; i < nu; ++i) kf[i] = Qu[i];
      inv_solve<nu>(Linv, kf);
      for (int i = 0; i < nu; ++i) {
        kf[i] = -kf[i];
        kff[(size_t)(k * nu + i) * B] = kf[i];
      }
#pragma unroll 1
      for (int c = 0; c < n; ++c) {
        for (int i = 0; i < nu; ++i) col[i] = Qux[i * n + c];
        inv_solve<nu>(Linv, col);
        for (int i = 0; i < nu; ++i) {
          K[i * n + c] = -col[i];
          Kfb[(size_t)((k * nu + i) * n + c) * B] = -col[i];
        }
      }
    } else {  // K1's gains
      chol<nu>(Quu, a.reg, inv);
#pragma unroll
      for (int i = 0; i < nu; ++i) kf[i] = Qu[i];
      chol_solve<nu>(Quu, inv, kf);
#pragma unroll
      for (int i = 0; i < nu; ++i) {
        kf[i] = -kf[i];
        kff[(size_t)(k * nu + i) * B] = kf[i];
      }
#pragma unroll 1
      for (int c = 0; c < n; ++c) {
#pragma unroll
        for (int i = 0; i < nu; ++i) col[i] = Qux[i * n + c];
        chol_solve<nu>(Quu, inv, col);
#pragma unroll
        for (int i = 0; i < nu; ++i) {
          K[i * n + c] = -col[i];
          Kfb[(size_t)((k * nu + i) * n + c) * B] = -col[i];
        }
      }
    }

    // value function of stage k (Vxx holds Qxx)
#pragma unroll
    for (int j = 0; j < n; ++j) Vx[j] = Qx[j];
    mtm_add<nu, n, 1>(Qux, kf, Vx);
    mtm_add<nu, n, n>(Qux, K, Vxx);
    float s = 0.f;
#pragma unroll
    for (int i = 0; i < nu; ++i) s += kf[i] * Qu[i];
    dV1 = dV1 + s;
  }
  return dV1;
}

// Closed-loop rollout from x0 under the current gains with step alpha.
// write = false: return the summed AL merit (a line-search candidate).
// write = true: store the new stage states and controls over a.Xs / a.U
// (the accepted step) and return 0.
template <int NR>
NMPC_DEV float closed_loop_rollout(const InnerArgs& a, const float* sp, int b,
                                   float mu, int nc, float alpha, bool write) {
  using D = Dims<NR>;
  constexpr int n = D::n, nu = D::nu;
  const size_t B = a.B;
  const float dt = sp[D::dt];
  const bool pairs = a.pairs != 0;
  float* Xs = a.Xs + b;
  float* U = a.U + b;
  const float* kff = a.kff + b;
  const float* Kfb = a.Kfb + b;
  float x[n], xb[n], ub[nu], kf[nu], u[nu];
#pragma unroll
  for (int i = 0; i < n; ++i) x[i] = a.x0[(size_t)i * B + b];
  float cost = 0.f;
#pragma unroll 1
  for (int k = 0; k < a.N; ++k) {
#pragma unroll
    for (int i = 0; i < n; ++i) xb[i] = Xs[(size_t)(k * n + i) * B];
#pragma unroll
    for (int i = 0; i < nu; ++i) {
      ub[i] = U[(size_t)(k * nu + i) * B];
      kf[i] = kff[(size_t)(k * nu + i) * B];
    }
    feedback_u<NR>(x, xb, ub, kf, Kfb + (size_t)k * nu * n * B, B, alpha, u);
    if (write) {
#pragma unroll
      for (int i = 0; i < n; ++i) Xs[(size_t)(k * n + i) * B] = x[i];
#pragma unroll
      for (int i = 0; i < nu; ++i) U[(size_t)(k * nu + i) * B] = u[i];
    } else {
      cost += stage_merit<NR>(sp, k > 0, pairs, x, u, a.xref + b + (size_t)k * n * B,
                              a.lam + b + (size_t)k * nc * B, B, mu);
    }
    euler_rows<NR>(x, u, dt, x);
  }
  return cost;
}

// K1: the inner iLQR solve of scenario b (n_inner iterations at most).
//
// Semantics of the megakernel, per scenario:
//  * initial rollout of the warm controls and its merit;
//  * each iteration: backward sweep, line search, accepted rollout;
//  * cascade line search: every alpha in turn, accept when Armijo holds and
//    the merit beats the best so far;
//  * adaptive line search: the trial step restarts at 1 on every call; up to
//    ls_rounds first-accept rounds, shrinking by ls_beta on rejection; an
//    accepted step grows by ls_grow (capped at 1) for the next iteration; a
//    scenario that fails keeps iterating (fail-continue) and gives up only
//    once its trial is <= ls_trial_min;
//  * an iteration counts only if the scenario is still not done after it.
// A done scenario leaves the loop: its further iterations would be no-ops
// (alpha = 0 reproduces the nominal exactly), which is also why an
// unimproved step skips the accepted rollout.
//
// The defaults of Exp, kPhase and kEarlyExit are K1. The phase ablation and
// the layout A/B of csrc/tools.cu instantiate the same body with another
// expansion layout or Phase, and with kEarlyExit = false: every scenario then
// runs n_inner iterations and counts each, as the reference's ablations do.
template <int NR, class Exp = Expansion<NR>, Phase kPhase = Phase::full, bool kEarlyExit = true>
NMPC_DEV void inner_solve_thread(const InnerArgs& a, const float* sp, int b) {
  using D = Dims<NR>;
  constexpr int n = D::n, nu = D::nu;
  const size_t B = a.B;
  const float mu = a.mu[b];
  const float dt = sp[D::dt];
  const bool pairs = a.pairs != 0;
  const int nc = n_rows<NR>(pairs);

  // initial rollout of the warm controls + merit
  float x[n], u[nu];
#pragma unroll
  for (int i = 0; i < n; ++i) x[i] = a.x0[(size_t)i * B + b];
  float cost = 0.f;
#pragma unroll 1
  for (int k = 0; k < a.N; ++k) {
#pragma unroll
    for (int i = 0; i < nu; ++i) {
      u[i] = a.Uin[(size_t)(k * nu + i) * B + b];
      a.U[(size_t)(k * nu + i) * B + b] = u[i];
    }
#pragma unroll
    for (int i = 0; i < n; ++i) a.Xs[(size_t)(k * n + i) * B + b] = x[i];
    if constexpr (kPhase != Phase::sweep_only)
      cost += stage_merit<NR>(sp, k > 0, pairs, x, u, a.xref + b + (size_t)k * n * B,
                              a.lam + b + (size_t)k * nc * B, B, mu);
    euler_rows<NR>(x, u, dt, x);
  }

  int iters = 0;
  float trial = 1.f;
#pragma unroll 1
  for (int it = 0; it < a.n_inner; ++it) {
    const float dV1 = backward_sweep<NR, Exp, kPhase>(a, sp, b, mu, nc);
    const float slope = relu(-dV1);
    if constexpr (kPhase == Phase::sweep_only) {
      ++iters;
      continue;
    } else if constexpr (kPhase != Phase::full) {
      closed_loop_rollout<NR>(a, sp, b, mu, nc, 1.f, true);
      ++iters;
      continue;
    }

    float best_cost = cost, best_alpha = 0.f;
    if (a.adaptive) {
#pragma unroll 1
      for (int rr = 0; rr < a.ls_rounds; ++rr) {
        const float al = trial;
        const float ca = closed_loop_rollout<NR>(a, sp, b, mu, nc, al, false);
        const float expected = a.armijo * al * slope;
        if ((cost - ca) >= expected && ca < cost) {
          best_cost = ca;
          best_alpha = al;
          break;
        }
        trial = trial * a.ls_beta;
      }
      if (best_alpha > 0.f) trial = fminf(1.f, best_alpha * a.ls_grow);
    } else {
#pragma unroll 1
      for (int ai = 0; ai < a.n_alphas; ++ai) {
        const float al = sp[D::alphas + ai];
        const float ca = closed_loop_rollout<NR>(a, sp, b, mu, nc, al, false);
        const float expected = a.armijo * al * slope;
        if ((cost - ca) >= expected && ca < best_cost) {
          best_cost = ca;
          best_alpha = al;
        }
      }
    }

    const bool improved = best_alpha > 0.f;
    if (improved) closed_loop_rollout<NR>(a, sp, b, mu, nc, best_alpha, true);
    const float cost_new = improved ? best_cost : cost;
    if constexpr (kEarlyExit) {
      const float rel = (cost - cost_new) / (1.f + fabsf(cost));
      const bool stop = a.adaptive
          ? ((improved && rel < a.tol_cost) || (!improved && trial <= a.ls_trial_min))
          : (!improved || rel < a.tol_cost);
      cost = cost_new;
      if (stop) break;
    } else {
      cost = cost_new;
    }
    ++iters;
  }
  a.cost[b] = cost;
  a.iters[b] = iters;
}

}  // namespace nmpc
