// Device helpers of the closed-loop rollout and the AL merit.
//
// Ported from nmpc_tpu/ops/rollout_pallas.py: the parameter-block layout
// (_P / _pack_params), _euler_rows, _feedback_u and _stage_merit. On the TPU
// these worked on [rows, 128-lane] blocks; here one thread owns one scenario
// and loops over rows.
//
// Lane-major global arrays: element (k, i) of a [N, R, B] array, seen from
// the thread of scenario b, is p[(k * R + i) * B] with p = base + b, so the
// 32 threads of a warp read 32 neighbouring floats.
#pragma once

#ifndef NMPC_DEV
#define NMPC_DEV __device__ __forceinline__
#endif

#include <math.h>
#include <stddef.h>

namespace nmpc {

// finite stand-in for +inf (nmpc_tpu/ocp/problem.py BIG)
constexpr float kBig = 1e9f;
constexpr int kMaxAlphas = 32;

template <int NR>
struct Dims {
  static constexpr int n = 3 * NR;               // state width
  static constexpr int nu = 2 * NR;              // control width
  static constexpr int np = NR * (NR - 1) / 2;   // pair rows
  // offsets into the parameter block (nmpc_tpu_torch/ops/rollout.py::_P,
  // n_obs = 0): q, r, u_lo, u_hi, x_lo, x_hi, dmin2, dt, alphas. With
  // n_obs > 0 (staged kernels only) the 3 n_obs obstacle entries start at
  // `alphas` and the alphas follow them.
  static constexpr int q = 0;
  static constexpr int r = q + n;
  static constexpr int u_lo = r + nu;
  static constexpr int u_hi = u_lo + nu;
  static constexpr int x_lo = u_hi + nu;
  static constexpr int x_hi = x_lo + n;
  static constexpr int dmin2 = x_hi + n;
  static constexpr int dt = dmin2 + 1;
  static constexpr int alphas = dt + 1;
};

// max(0, v) and min(a, b) that keep a NaN, as jnp.maximum / jnp.minimum do
// (fmaxf / fminf would drop it and let a diverged scenario look feasible)
NMPC_DEV float relu(float v) { return v > 0.f ? v : (v == v ? 0.f : v); }
NMPC_DEV float min_nan(float a, float b) {
  return (a != a) ? a : ((b != b) ? b : fminf(a, b));
}

// Pair row c = dx^2 + dy^2 - dmin2 with each operation rounded on its own
// (no contraction into an FMA), exactly as the plain PyTorch version
// computes it; an FMA would move c by an ulp, which mu multiplies.
NMPC_DEV float pair_c(float dx, float dy, float dmin2) {
#ifdef __CUDA_ARCH__
  return __fsub_rn(__fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)), dmin2);
#else
  return dx * dx + dy * dy - dmin2;
#endif
}

// Static-obstacle row c = dist - keepout, each operation rounded on its own
// as in the plain version (keepout = r_obs + r_rob + margin, folded into the
// parameter block). The guard inside dist follows the plain version of the
// kernel that calls it: dist = sqrt(dx^2 + dy^2 + 1e-12) for the staged
// kernels (K4-K6, ops/rollout.py::_obs_c), sqrt(max(dx^2 + dy^2, 1e-12)),
// a NaN kept, with kClamp for K1 and K2 (ocp/problem.py::stage_constraints).
// Returns dist through *dist.
template <bool kClamp = false>
NMPC_DEV float obs_c(float dx, float dy, float keepout, float* dist) {
#ifdef __CUDA_ARCH__
  const float d2 = __fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy));
#else
  const float d2 = dx * dx + dy * dy;
#endif
  if constexpr (kClamp) {
    *dist = sqrtf(d2 > 1e-12f ? d2 : (d2 == d2 ? 1e-12f : d2));
  } else {
#ifdef __CUDA_ARCH__
    *dist = sqrtf(__fadd_rn(d2, 1e-12f));
#else
    *dist = sqrtf(d2 + 1e-12f);
#endif
  }
  return *dist - keepout;
}

// lam - mu c, rounded once
NMPC_DEV float al_step(float lam, float mu, float c) { return fmaf(-mu, c, lam); }

// Static- and moving-obstacle rows of one stage as the staged kernels' first
// designs see them (K1 and K2 take theirs in csrc/inner_warp.cuh). obs: n_obs rows
// (ox, oy, keepout) of the parameter block; mov: the thread's view of stage
// k of the [N, 2 n_mov, B] schedule, slot o at rows 2o (x) and 2o+1 (y).
// Rows are robot-major, obstacle-minor, after the pair rows.
struct ObsRows {
  int n_obs = 0, n_mov = 0;
  const float* obs = nullptr;
  const float* mov = nullptr;
};

// Row order of the c >= 0 rows of one stage: pairs (when collision rows are
// on), u_lo, u_hi, x_lo, x_hi.
template <int NR>
NMPC_DEV int n_rows(bool pairs) {
  using D = Dims<NR>;
  return (pairs ? D::np : 0) + 2 * D::nu + 2 * D::n;
}

// x_{k+1} = x_k + dt f(x_k, u_k) for NR stacked unicycles. xn may alias x.
template <int NR>
NMPC_DEV void euler_rows(const float* x, const float* u, float dt, float* xn) {
#pragma unroll
  for (int r = 0; r < NR; ++r) {
    float s, c;
    sincosf(x[3 * r + 2], &s, &c);
    const float v = u[2 * r], w = u[2 * r + 1];
    const float th = x[3 * r + 2];
    xn[3 * r] = x[3 * r] + dt * v * c;
    xn[3 * r + 1] = x[3 * r + 1] + dt * v * s;
    xn[3 * r + 2] = th + dt * w;
  }
}

// u = ubar + alpha kff + K (x - xbar); K is the thread's view of one stage
// of the lane-major gain array, entry (i, j) at K[(i * n + j) * B].
template <int NR>
NMPC_DEV void feedback_u(const float* x, const float* xbar, const float* ubar,
                         const float* kff, const float* K, size_t B,
                         float alpha, float* u) {
  using D = Dims<NR>;
  float dx[D::n];
#pragma unroll
  for (int j = 0; j < D::n; ++j) dx[j] = x[j] - xbar[j];
#pragma unroll 1
  for (int i = 0; i < D::nu; ++i) {
    float acc = ubar[i] + alpha * kff[i];
#pragma unroll
    for (int j = 0; j < D::n; ++j) acc = acc + K[(size_t)(i * D::n + j) * B] * dx[j];
    u[i] = acc;
  }
}

// AL merit contribution of stage k: tracking cost plus the PHR penalty
// sum(max(0, lam - mu c)^2) / (2 mu). At stage 0 (gate false) the
// state-dependent rows are masked hard: a non-finite activation there (NaN
// warm-start duals) must not leak into the merit. xr and lam are the
// thread's views of stage k of xref and lam. kObs adds the rows of `ob`
// after the pair rows; K1's instantiation (kObs = false) compiles them out.
template <int NR, bool kObs = false>
NMPC_DEV float stage_merit(const float* sp, bool gate, bool pairs,
                           const float* x, const float* u, const float* xr,
                           const float* lam, size_t B, float mu,
                           const ObsRows& ob = ObsRows{}) {
  using D = Dims<NR>;
  float cq = 0.f, cr = 0.f;
#pragma unroll
  for (int i = 0; i < D::n; ++i) {
    const float d = x[i] - xr[(size_t)i * B];
    cq += sp[D::q + i] * d * d;
  }
#pragma unroll
  for (int i = 0; i < D::nu; ++i) cr += sp[D::r + i] * u[i] * u[i];
  const float cost = cq + cr;

  float pen = 0.f;
  int row = 0;
  if (pairs) {
    float s = 0.f;
#pragma unroll
    for (int i = 0; i < NR; ++i) {
#pragma unroll
      for (int j = i + 1; j < NR; ++j) {
        const float c = pair_c(x[3 * i] - x[3 * j], x[3 * i + 1] - x[3 * j + 1], sp[D::dmin2]);
        float act = relu(al_step(lam[(size_t)row * B], mu, c));
        act = gate ? act : 0.f;
        s += act * act;
        ++row;
      }
    }
    pen += s;
  }
  if constexpr (kObs) {
    float s = 0.f, dist;
    for (int i = 0; i < NR; ++i) {
      for (int o = 0; o < ob.n_obs; ++o) {
        const float c = obs_c(x[3 * i] - ob.obs[3 * o], x[3 * i + 1] - ob.obs[3 * o + 1],
                              ob.obs[3 * o + 2], &dist);
        float act = relu(al_step(lam[(size_t)row * B], mu, c));
        act = gate ? act : 0.f;
        s += act * act;
        ++row;
      }
    }
    pen += s;
    s = 0.f;
    for (int i = 0; i < NR; ++i) {
      for (int o = 0; o < ob.n_mov; ++o) {
        const float c = pair_c(x[3 * i] - ob.mov[(size_t)(2 * o) * B],
                               x[3 * i + 1] - ob.mov[(size_t)(2 * o + 1) * B], sp[D::dmin2]);
        float act = relu(al_step(lam[(size_t)row * B], mu, c));
        act = gate ? act : 0.f;
        s += act * act;
        ++row;
      }
    }
    pen += s;
  }
  {
    float s = 0.f;
#pragma unroll
    for (int i = 0; i < D::nu; ++i) {
      const float act = relu(al_step(lam[(size_t)(row + i) * B], mu, u[i] - sp[D::u_lo + i]));
      s += act * act;
    }
    pen += s;
    row += D::nu;
  }
  {
    float s = 0.f;
#pragma unroll
    for (int i = 0; i < D::nu; ++i) {
      const float act = relu(al_step(lam[(size_t)(row + i) * B], mu, sp[D::u_hi + i] - u[i]));
      s += act * act;
    }
    pen += s;
    row += D::nu;
  }
  {
    float s = 0.f;
#pragma unroll
    for (int i = 0; i < D::n; ++i) {
      float act = relu(al_step(lam[(size_t)(row + i) * B], mu, x[i] - sp[D::x_lo + i]));
      act = gate ? act : 0.f;
      s += act * act;
    }
    pen += s;
    row += D::n;
  }
  {
    float s = 0.f;
#pragma unroll
    for (int i = 0; i < D::n; ++i) {
      float act = relu(al_step(lam[(size_t)(row + i) * B], mu, sp[D::x_hi + i] - x[i]));
      act = gate ? act : 0.f;
      s += act * act;
    }
    pen += s;
  }
  return cost + pen / (2.f * mu);
}

}  // namespace nmpc
