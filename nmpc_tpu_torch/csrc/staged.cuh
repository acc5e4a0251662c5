// Per-thread bodies of the four kernels of the staged AL-iLQR path
// (nmpc_tpu_torch/solver/alilqr_batched.py::_solve_lanes):
//
//   K4 expansion_thread: one stage's dynamics Jacobians and AL-merit
//      gradients / Gauss-Newton Hessians, replacing
//      nmpc_tpu/ops/expansions_pallas.py (_make_expansion_kernel,
//      wrapper expansions_fused).
//   K3 riccati_thread: the backward Riccati sweep of one scenario, replacing
//      nmpc_tpu/ops/riccati_pallas.py (_make_kernel, riccati_lanes).
//   K5 linesearch_cost_thread: the AL merit of one closed-loop candidate
//      rollout, replacing nmpc_tpu/ops/rollout_pallas.py (_make_cost_kernel,
//      linesearch_costs_lanes).
//   K6 rollout_thread: the accepted rollout, replacing _make_rollout_kernel
//      / rollout_alpha_lanes of the same file.
//
// Problem class: NR stacked Euler unicycles with pair rows (optional),
// static-obstacle and moving-obstacle rows and u/x box rows. Every global
// array is lane-major, [N, rows, B] with the batch innermost, and stays so
// from one kernel to the next: K4 writes what K3 reads, with no transposes.
#pragma once

#include "riccati.cuh"
#include "rollout.cuh"

namespace nmpc {

// c >= 0 rows of one stage: pairs, obstacles, moving obstacles, u box, x box
template <int NR>
NMPC_DEV int staged_rows(bool pairs, int n_obs, int n_mov) {
  return n_rows<NR>(pairs) + NR * (n_obs + n_mov);
}

struct ExpArgs {
  const float* prm;   // parameter block with n_obs obstacle rows, no alphas
  const float* Xs;    // [N, n, B] stage states 0..N-1
  const float* U;     // [N, nu, B]
  const float* xref;  // [N, n, B]
  const float* lam;   // [N, nc, B]
  const float* mu;    // [B]
  const float* mov;   // [N, 2 n_mov, B], or null when n_mov = 0
  float* A;           // [N, n, n, B] out
  float* Bm;          // [N, n, nu, B] out
  float* lx;          // [N, n, B] out
  float* lu;          // [N, nu, B] out
  float* lxx;         // [N, n, n, B] out
  float* luu;         // [N, nu, nu, B] out
  float* lux;         // [N, nu, n, B] out (zeros)
  int B, N, pairs, n_obs, n_mov;
};

struct RiccatiArgs {
  const float *A, *Bm, *lx, *lu, *lxx, *luu, *lux;  // K4's layout
  float* kff;  // [N, nu, B] out
  float* Kfb;  // [N, nu, n, B] out
  float* dV1;  // [B] out: sum_k kff_k . Qu_k
  int B, N;
  float reg;
};

struct CostArgs {
  const float* prm;   // parameter block: obstacle rows, then the alphas
  const float* x0;    // [n, B]
  const float* Xs;    // [N, n, B] nominal stage states
  const float* U;     // [N, nu, B] nominal controls
  const float* kff;   // [N, nu, B]
  const float* Kfb;   // [N, nu, n, B]
  const float* xref;  // [N, n, B]
  const float* lam;   // [N, nc, B]
  const float* mu;    // [B]
  const float* mov;   // [N, 2 n_mov, B], or null
  float* costs;       // [n_alphas, B] out
  int B, N, n_alphas, pairs, n_obs, n_mov;
};

struct RolloutArgs {
  const float* prm;   // parameter block (only dt is read)
  const float* x0;    // [n, B]
  const float* Xs;    // [N, n, B] nominal stage states
  const float* U;     // [N, nu, B] nominal controls
  const float* kff;   // [N, nu, B]
  const float* Kfb;   // [N, nu, n, B]
  const float* alpha; // [B]
  float* Xout;        // [N, n, B] out: states 1..N
  float* Uout;        // [N, nu, B] out
  int B, N;
};

// K4 for stage k of scenario b. Semantics of the Pallas kernel, row by row:
// pair rows add 2(p_i - p_j) act to the gradient and mu 1[act > 0] g g^T to
// lxx; obstacle rows the unit vector (p_i - o) / dist; moving-obstacle rows
// 2(p_i - mov) on the robot side only; box rows touch the diagonals. Every
// state-dependent row is masked hard at stage 0 (global stage index).
template <int NR>
NMPC_DEV void expansion_thread(const ExpArgs& a, const float* sp, int k, int b) {
  using D = Dims<NR>;
  constexpr int n = D::n, nu = D::nu;
  const size_t B = a.B;
  const bool pairs = a.pairs != 0;
  const int nc = staged_rows<NR>(pairs, a.n_obs, a.n_mov);
  const float dt = sp[D::dt];
  const float mu = a.mu[b];
  const bool gate = k > 0;
  const float* Xk = a.Xs + b + (size_t)k * n * B;
  const float* Uk = a.U + b + (size_t)k * nu * B;
  const float* xr = a.xref + b + (size_t)k * n * B;
  const float* lam = a.lam + b + (size_t)k * nc * B;
  float x[n], u[nu];
#pragma unroll
  for (int i = 0; i < n; ++i) x[i] = Xk[(size_t)i * B];
#pragma unroll
  for (int i = 0; i < nu; ++i) u[i] = Uk[(size_t)i * B];

  // dynamics Jacobians (Euler unicycle, closed form)
  float e1[NR], e2[NR], bc[NR], bs[NR];
#pragma unroll
  for (int r = 0; r < NR; ++r) {
    float s, c;
    sincosf(x[3 * r + 2], &s, &c);
    const float v = u[2 * r];
    e1[r] = -dt * v * s;
    e2[r] = dt * v * c;
    bc[r] = dt * c;
    bs[r] = dt * s;
  }
  float* Ak = a.A + b + (size_t)k * n * n * B;
#pragma unroll 1
  for (int i = 0; i < n; ++i) {
    const int r = i / 3, p = i % 3;
    for (int j = 0; j < n; ++j) {
      float v = i == j ? 1.f : 0.f;
      if (j == 3 * r + 2 && p < 2) v = p == 0 ? e1[r] : e2[r];
      Ak[(size_t)(i * n + j) * B] = v;
    }
  }
  float* Bk = a.Bm + b + (size_t)k * n * nu * B;
#pragma unroll 1
  for (int i = 0; i < n; ++i) {
    const int r = i / 3, p = i % 3;
    for (int j = 0; j < nu; ++j) {
      float v = 0.f;
      if (p < 2 && j == 2 * r) v = p == 0 ? bc[r] : bs[r];
      if (p == 2 && j == 2 * r + 1) v = dt;
      Bk[(size_t)(i * nu + j) * B] = v;
    }
  }

  // gradients; the x-box activations first, since their Hessian diagonal
  // is the base the pair and obstacle terms add to (their gradient terms
  // come last, as in the Pallas kernel)
  float lx[n], lu[nu], H[n * n];
#pragma unroll
  for (int i = 0; i < n; ++i) lx[i] = 2.f * sp[D::q + i] * (x[i] - xr[(size_t)i * B]);
#pragma unroll
  for (int i = 0; i < nu; ++i) lu[i] = 2.f * sp[D::r + i] * u[i];
  const int row_u = nc - 2 * nu - 2 * n, row_x = nc - 2 * n;
  float xlo[n], xhi[n];
  for (int i = 0; i < n; ++i) {
    xlo[i] = relu(al_step(lam[(size_t)(row_x + i) * B], mu, x[i] - sp[D::x_lo + i]));
    xhi[i] = relu(al_step(lam[(size_t)(row_x + n + i) * B], mu, sp[D::x_hi + i] - x[i]));
    xlo[i] = gate ? xlo[i] : 0.f;
    xhi[i] = gate ? xhi[i] : 0.f;
  }
#pragma unroll 1
  for (int i = 0; i < n * n; ++i) H[i] = 0.f;
#pragma unroll 1
  for (int i = 0; i < n; ++i)
    H[i * n + i] = 2.f * sp[D::q + i] + mu * ((xlo[i] > 0.f ? 1.f : 0.f) + (xhi[i] > 0.f ? 1.f : 0.f));

  int row = 0;
  if (pairs) {
#pragma unroll 1
    for (int i = 0; i < NR; ++i) {
#pragma unroll 1
      for (int j = i + 1; j < NR; ++j) {
        const float dx = x[3 * i] - x[3 * j];
        const float dy = x[3 * i + 1] - x[3 * j + 1];
        float act = relu(al_step(lam[(size_t)row * B], mu, pair_c(dx, dy, sp[D::dmin2])));
        act = gate ? act : 0.f;
        const float w = act > 0.f ? mu : 0.f;
        const float gx = 2.f * dx, gy = 2.f * dy;
        lx[3 * i] = lx[3 * i] - gx * act;
        lx[3 * i + 1] = lx[3 * i + 1] - gy * act;
        lx[3 * j] = lx[3 * j] + gx * act;
        lx[3 * j + 1] = lx[3 * j + 1] + gy * act;
        const float wxx = w * gx * gx, wyy = w * gy * gy, wxy = w * gx * gy;
        const int xi = 3 * i, yi = 3 * i + 1, xj = 3 * j, yj = 3 * j + 1;
        H[xi * n + xi] += wxx; H[yi * n + yi] += wyy;
        H[xj * n + xj] += wxx; H[yj * n + yj] += wyy;
        H[xi * n + yi] += wxy; H[yi * n + xi] += wxy;
        H[xj * n + yj] += wxy; H[yj * n + xj] += wxy;
        H[xi * n + xj] += -wxx; H[xj * n + xi] += -wxx;
        H[yi * n + yj] += -wyy; H[yj * n + yi] += -wyy;
        H[xi * n + yj] += -wxy; H[yj * n + xi] += -wxy;
        H[yi * n + xj] += -wxy; H[xj * n + yi] += -wxy;
        ++row;
      }
    }
  }
  const float* obs = sp + D::alphas;
#pragma unroll 1
  for (int i = 0; i < NR; ++i) {
    for (int o = 0; o < a.n_obs; ++o) {
      const float dx = x[3 * i] - obs[3 * o];
      const float dy = x[3 * i + 1] - obs[3 * o + 1];
      float dist;
      const float c = obs_c(dx, dy, obs[3 * o + 2], &dist);
      float act = relu(al_step(lam[(size_t)row * B], mu, c));
      act = gate ? act : 0.f;
      const float w = act > 0.f ? mu : 0.f;
      const float ux = dx / dist, uy = dy / dist;
      lx[3 * i] = lx[3 * i] - ux * act;
      lx[3 * i + 1] = lx[3 * i + 1] - uy * act;
      const int xi = 3 * i, yi = 3 * i + 1;
      H[xi * n + xi] += w * ux * ux;
      H[yi * n + yi] += w * uy * uy;
      H[xi * n + yi] += w * ux * uy;
      H[yi * n + xi] += w * ux * uy;
      ++row;
    }
  }
  if (a.n_mov) {
    const float* mov = a.mov + b + (size_t)k * 2 * a.n_mov * B;
#pragma unroll 1
    for (int i = 0; i < NR; ++i) {
      for (int o = 0; o < a.n_mov; ++o) {
        const float dx = x[3 * i] - mov[(size_t)(2 * o) * B];
        const float dy = x[3 * i + 1] - mov[(size_t)(2 * o + 1) * B];
        float act = relu(al_step(lam[(size_t)row * B], mu, pair_c(dx, dy, sp[D::dmin2])));
        act = gate ? act : 0.f;
        const float w = act > 0.f ? mu : 0.f;
        const float gx = 2.f * dx, gy = 2.f * dy;
        lx[3 * i] = lx[3 * i] - gx * act;
        lx[3 * i + 1] = lx[3 * i + 1] - gy * act;
        const int xi = 3 * i, yi = 3 * i + 1;
        H[xi * n + xi] += w * gx * gx;
        H[yi * n + yi] += w * gy * gy;
        H[xi * n + yi] += w * gx * gy;
        H[yi * n + xi] += w * gx * gy;
        ++row;
      }
    }
  }

  float* luu = a.luu + b + (size_t)k * nu * nu * B;
#pragma unroll 1
  for (int i = 0; i < nu; ++i) {
    const float alo = relu(al_step(lam[(size_t)(row_u + i) * B], mu, u[i] - sp[D::u_lo + i]));
    const float ahi = relu(al_step(lam[(size_t)(row_u + nu + i) * B], mu, sp[D::u_hi + i] - u[i]));
    lu[i] = lu[i] - alo + ahi;
    const float d = 2.f * sp[D::r + i] + mu * ((alo > 0.f ? 1.f : 0.f) + (ahi > 0.f ? 1.f : 0.f));
    for (int j = 0; j < nu; ++j) luu[(size_t)(i * nu + j) * B] = i == j ? d : 0.f;
  }
  for (int i = 0; i < n; ++i) lx[i] = lx[i] - xlo[i] + xhi[i];

  float* lxo = a.lx + b + (size_t)k * n * B;
  float* luo = a.lu + b + (size_t)k * nu * B;
  float* lxx = a.lxx + b + (size_t)k * n * n * B;
  float* lux = a.lux + b + (size_t)k * nu * n * B;
  for (int i = 0; i < n; ++i) lxo[(size_t)i * B] = lx[i];
  for (int i = 0; i < nu; ++i) luo[(size_t)i * B] = lu[i];
#pragma unroll 1
  for (int i = 0; i < n * n; ++i) lxx[(size_t)i * B] = H[i];
#pragma unroll 1
  for (int i = 0; i < nu * n; ++i) lux[(size_t)i * B] = 0.f;
}

// K3 for scenario b: the backward sweep over dense stage blocks (general A,
// B and lux, as riccati_fused takes them), from a zero terminal value.
//   Q-blocks: Qx = lx + A'Vx, Qu = lu + B'Vx, Qxx = lxx + A'(Vxx A),
//             Qux = lux + B'(Vxx A), Quu = luu + B'(Vxx B)
//   gains:    [kff | Kfb] = -(Quu + reg I)^-1 [Qu | Qux]
//   value:    Vx' = Qx + Qux' kff, Vxx' = Qxx + Qux' Kfb (no symmetrisation)
// Thread-local: Vxx, Vxx A (later the gains Kfb), Vxx B (later Qux), Quu.
template <int NR>
NMPC_DEV void riccati_thread(const RiccatiArgs& a, int b) {
  constexpr int n = 3 * NR, nu = 2 * NR;
  const size_t B = a.B;
  float Vx[n], Vxx[n * n], VA[n * n], W[n * nu], Quu[nu * nu];
  float Qx[n], Qu[nu], kf[nu], inv[nu], col[nu];
  for (int i = 0; i < n; ++i) Vx[i] = 0.f;
  for (int i = 0; i < n * n; ++i) Vxx[i] = 0.f;
  float dV1 = 0.f;
#pragma unroll 1
  for (int k = a.N - 1; k >= 0; --k) {
    const float* A = a.A + b + (size_t)k * n * n * B;      // (l, j) at [(l n + j) B]
    const float* Bm = a.Bm + b + (size_t)k * n * nu * B;   // (l, c) at [(l nu + c) B]
    const float* lx = a.lx + b + (size_t)k * n * B;
    const float* lu = a.lu + b + (size_t)k * nu * B;
    const float* lxx = a.lxx + b + (size_t)k * n * n * B;
    const float* luu = a.luu + b + (size_t)k * nu * nu * B;
    const float* lux = a.lux + b + (size_t)k * nu * n * B;

    // Vxx A and A'Vx, B'Vx
#pragma unroll 1
    for (int j = 0; j < n; ++j) {
      float aj[n];
      for (int l = 0; l < n; ++l) aj[l] = A[(size_t)(l * n + j) * B];
      float acc = aj[0] * Vx[0];
      for (int l = 1; l < n; ++l) acc = acc + aj[l] * Vx[l];
      Qx[j] = lx[(size_t)j * B] + acc;
#pragma unroll 1
      for (int i = 0; i < n; ++i) {
        float s = Vxx[i * n] * aj[0];
        for (int l = 1; l < n; ++l) s = s + Vxx[i * n + l] * aj[l];
        VA[i * n + j] = s;
      }
    }
#pragma unroll 1
    for (int c = 0; c < nu; ++c) {
      float bcol[n];
      for (int l = 0; l < n; ++l) bcol[l] = Bm[(size_t)(l * nu + c) * B];
      float acc = bcol[0] * Vx[0];
      for (int l = 1; l < n; ++l) acc = acc + bcol[l] * Vx[l];
      Qu[c] = lu[(size_t)c * B] + acc;
#pragma unroll 1
      for (int i = 0; i < n; ++i) {  // W = Vxx B, [n, nu]
        float s = Vxx[i * n] * bcol[0];
        for (int l = 1; l < n; ++l) s = s + Vxx[i * n + l] * bcol[l];
        W[i * nu + c] = s;
      }
    }
    // Quu = luu + B'(Vxx B)
#pragma unroll 1
    for (int r = 0; r < nu; ++r) {
      float br[n];
      for (int l = 0; l < n; ++l) br[l] = Bm[(size_t)(l * nu + r) * B];
#pragma unroll 1
      for (int c = 0; c < nu; ++c) {
        float s = br[0] * W[c];
        for (int l = 1; l < n; ++l) s = s + br[l] * W[l * nu + c];
        Quu[r * nu + c] = luu[(size_t)(r * nu + c) * B] + s;
      }
    }
    // Qxx = lxx + A'(Vxx A) over Vxx; Qux = lux + B'(Vxx A) over W ([nu, n])
#pragma unroll 1
    for (int i = 0; i < n; ++i) {
      float ai[n];
      for (int l = 0; l < n; ++l) ai[l] = A[(size_t)(l * n + i) * B];
#pragma unroll 1
      for (int j = 0; j < n; ++j) {
        float s = ai[0] * VA[j];
        for (int l = 1; l < n; ++l) s = s + ai[l] * VA[l * n + j];
        Vxx[i * n + j] = lxx[(size_t)(i * n + j) * B] + s;
      }
    }
#pragma unroll 1
    for (int r = 0; r < nu; ++r) {
      float br[n];
      for (int l = 0; l < n; ++l) br[l] = Bm[(size_t)(l * nu + r) * B];
#pragma unroll 1
      for (int j = 0; j < n; ++j) {
        float s = br[0] * VA[j];
        for (int l = 1; l < n; ++l) s = s + br[l] * VA[l * n + j];
        W[r * n + j] = lux[(size_t)(r * n + j) * B] + s;
      }
    }

    // gains: [kff | Kfb] = -(Quu + reg I)^-1 [Qu | Qux]; Kfb over VA
    chol<nu>(Quu, a.reg, inv);
    for (int i = 0; i < nu; ++i) kf[i] = Qu[i];
    chol_solve<nu>(Quu, inv, kf);
    float* kff = a.kff + b + (size_t)k * nu * B;
    for (int i = 0; i < nu; ++i) {
      kf[i] = -kf[i];
      kff[(size_t)i * B] = kf[i];
    }
    float* Kfb = a.Kfb + b + (size_t)k * nu * n * B;
#pragma unroll 1
    for (int c = 0; c < n; ++c) {
      for (int i = 0; i < nu; ++i) col[i] = W[i * n + c];
      chol_solve<nu>(Quu, inv, col);
      for (int i = 0; i < nu; ++i) {
        VA[i * n + c] = -col[i];
        Kfb[(size_t)(i * n + c) * B] = -col[i];
      }
    }
    float s = 0.f;
    for (int i = 0; i < nu; ++i) s += kf[i] * Qu[i];
    dV1 = dV1 + s;

    // value function of stage k (Vxx holds Qxx)
    for (int j = 0; j < n; ++j) Vx[j] = Qx[j];
    mtm_add<nu, n, 1>(W, kf, Vx);
    mtm_add<nu, n, n>(W, VA, Vxx);
  }
  a.dV1[b] = dV1;
}

// K5 for line-search candidate ai of scenario b: the closed-loop rollout
// u = U + alpha kff + Kfb (x - Xs) from x0 and its summed AL merit.
template <int NR>
NMPC_DEV void linesearch_cost_thread(const CostArgs& a, const float* sp, int ai, int b) {
  using D = Dims<NR>;
  constexpr int n = D::n, nu = D::nu;
  const size_t B = a.B;
  const bool pairs = a.pairs != 0;
  const int nc = staged_rows<NR>(pairs, a.n_obs, a.n_mov);
  const float dt = sp[D::dt];
  const float alpha = sp[D::alphas + 3 * a.n_obs + ai];
  const float mu = a.mu[b];
  ObsRows ob;
  ob.n_obs = a.n_obs;
  ob.n_mov = a.n_mov;
  ob.obs = sp + D::alphas;
  float x[n], xb[n], ub[nu], kf[nu], u[nu];
#pragma unroll
  for (int i = 0; i < n; ++i) x[i] = a.x0[(size_t)i * B + b];
  float cost = 0.f;
#pragma unroll 1
  for (int k = 0; k < a.N; ++k) {
#pragma unroll
    for (int i = 0; i < n; ++i) xb[i] = a.Xs[(size_t)(k * n + i) * B + b];
#pragma unroll
    for (int i = 0; i < nu; ++i) {
      ub[i] = a.U[(size_t)(k * nu + i) * B + b];
      kf[i] = a.kff[(size_t)(k * nu + i) * B + b];
    }
    feedback_u<NR>(x, xb, ub, kf, a.Kfb + b + (size_t)k * nu * n * B, B, alpha, u);
    if (a.n_mov) ob.mov = a.mov + b + (size_t)k * 2 * a.n_mov * B;
    cost = cost + stage_merit<NR, true>(sp, k > 0, pairs, x, u, a.xref + b + (size_t)k * n * B,
                                        a.lam + b + (size_t)k * nc * B, B, mu, ob);
    euler_rows<NR>(x, u, dt, x);
  }
  a.costs[(size_t)ai * B + b] = cost;
}

// K6 for scenario b: the rollout under the scenario's own alpha, writing
// the controls and the states 1..N.
template <int NR>
NMPC_DEV void rollout_thread(const RolloutArgs& a, float dt, int b) {
  constexpr int n = 3 * NR, nu = 2 * NR;
  const size_t B = a.B;
  const float alpha = a.alpha[b];
  float x[n], xb[n], ub[nu], kf[nu], u[nu];
#pragma unroll
  for (int i = 0; i < n; ++i) x[i] = a.x0[(size_t)i * B + b];
#pragma unroll 1
  for (int k = 0; k < a.N; ++k) {
#pragma unroll
    for (int i = 0; i < n; ++i) xb[i] = a.Xs[(size_t)(k * n + i) * B + b];
#pragma unroll
    for (int i = 0; i < nu; ++i) {
      ub[i] = a.U[(size_t)(k * nu + i) * B + b];
      kf[i] = a.kff[(size_t)(k * nu + i) * B + b];
    }
    feedback_u<NR>(x, xb, ub, kf, a.Kfb + b + (size_t)k * nu * n * B, B, alpha, u);
#pragma unroll
    for (int i = 0; i < nu; ++i) a.Uout[(size_t)(k * nu + i) * B + b] = u[i];
    euler_rows<NR>(x, u, dt, x);
#pragma unroll
    for (int i = 0; i < n; ++i) a.Xout[(size_t)(k * n + i) * B + b] = x[i];
  }
}

}  // namespace nmpc
