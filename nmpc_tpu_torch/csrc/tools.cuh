// Device code of the port's roofline tools (csrc/tools.cu):
//
//   K7 fma_chain: C independent FMA chains x = x a + b per thread, the
//      card's attainable f32 FMA rate. Replaces the TPU's pure-FMA probe
//      tools/roofline.py::measure_vpu_peak.
//   K8 the phase ablation: K1 with one Phase ablated at a fixed iteration
//      count. Replaces tools/exp_mega_phases.py::run_mode.
//   K9 the expansion-layout A/B: K1's solve at a fixed iteration count with
//      the structured expansion (K1's own) or a dense one.
//      Replaces tools/exp_blocked_expansions.py::run.
//
// K8 and K9 run on K1's warp design by default: template flags of
// csrc/inner_warp.cuh::inner_solve_warp (kPhase, kEarlyExit, kDense), whose
// defaults compile to K1 itself (the part `K8 warp full, early exit`), so
// these variants cannot drift from the solver's kernel. K1's first design
// (csrc/megasolve.cuh::inner_solve_thread, one thread per scenario) keeps
// its own variants as the A/B baseline under the same Phase flag and the
// layout type below (DenseExpansion); `design="first"` of the Python
// wrappers reaches them.
#pragma once

#include "inner_warp.cuh"
#include "megasolve.cuh"

namespace nmpc {

// K7: R steps of `chains` independent x = fma(x, a, b) in registers. a and
// b are run-time values and every chain is stored, so the compiler can
// neither fold nor drop the work: 2 C R FLOPs per thread.
template <int C>
NMPC_DEV void fma_chain(float* x, float a, float b, int R) {
#pragma unroll 8
  for (int r = 0; r < R; ++r) {
#pragma unroll
    for (int c = 0; c < C; ++c) x[c] = fmaf(x[c], a, b);
  }
}

// The first design's dense expansion layout of the A/B (K9): the same stage
// expansion as Expansion<NR>, with lxx (n x n) and luu (nu x nu) materialized in
// thread-local memory and read back entry by entry in the backward sweep, as
// the reference's per-row dense(He, n, n) assembles them. At six robots that
// is 324 + 144 floats per thread beyond the structured form. Gradients are
// computed in Expansion's order, so the two layouts differ only in how the
// lxx sums are rounded.
template <int NR>
struct DenseExpansion {
  static constexpr int n = 3 * NR, nu = 2 * NR;
  float e1[NR], e2[NR], bc[NR], bs[NR];
  float lx[n], lu[nu];
  float H[n * n];     // lxx
  float Huu[nu * nu]; // luu

  NMPC_DEV float lxx(bool, int i, int c) const { return H[i * n + c]; }
  NMPC_DEV float luu(int i, int j) const { return Huu[i * nu + j]; }

  template <bool kCon>
  NMPC_DEV void fill(const float* sp, bool gate, bool pairs, const float* x,
                     const float* u, const float* xr, const float* lam, size_t B,
                     float mu) {
    static_assert(kCon, "the layout A/B runs the full expansions");
    using D = Dims<NR>;
    const float dt = sp[D::dt];
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
#pragma unroll
    for (int i = 0; i < n; ++i) lx[i] = 2.f * sp[D::q + i] * (x[i] - xr[(size_t)i * B]);
#pragma unroll
    for (int i = 0; i < nu; ++i) lu[i] = 2.f * sp[D::r + i] * u[i];
#pragma unroll 1
    for (int i = 0; i < nu * nu; ++i) Huu[i] = 0.f;
#pragma unroll 1
    for (int i = 0; i < n * n; ++i) H[i] = 0.f;

    int row = pairs ? D::np : 0;
    // u-box rows (never gated)
#pragma unroll
    for (int i = 0; i < nu; ++i) {
      const float alo = relu(al_step(lam[(size_t)(row + i) * B], mu, u[i] - sp[D::u_lo + i]));
      const float ahi = relu(al_step(lam[(size_t)(row + nu + i) * B], mu, sp[D::u_hi + i] - u[i]));
      lu[i] = lu[i] - alo + ahi;
      Huu[i * nu + i] = 2.f * sp[D::r + i] + mu * ((alo > 0.f ? 1.f : 0.f) + (ahi > 0.f ? 1.f : 0.f));
    }
    row += 2 * nu;
    // x-box rows, masked hard at stage 0
#pragma unroll
    for (int i = 0; i < n; ++i) {
      float alo = relu(al_step(lam[(size_t)(row + i) * B], mu, x[i] - sp[D::x_lo + i]));
      float ahi = relu(al_step(lam[(size_t)(row + n + i) * B], mu, sp[D::x_hi + i] - x[i]));
      alo = gate ? alo : 0.f;
      ahi = gate ? ahi : 0.f;
      lx[i] = lx[i] - alo + ahi;
      H[i * n + i] = 2.f * sp[D::q + i] + mu * ((alo > 0.f ? 1.f : 0.f) + (ahi > 0.f ? 1.f : 0.f));
    }
    // pair rows, masked hard at stage 0, scattered into the dense lxx
    if (pairs) {
      int p = 0;
#pragma unroll 1
      for (int i = 0; i < NR; ++i) {
#pragma unroll 1
        for (int j = i + 1; j < NR; ++j) {
          const float dx = x[3 * i] - x[3 * j];
          const float dy = x[3 * i + 1] - x[3 * j + 1];
          float act = relu(al_step(lam[(size_t)p * B], mu, pair_c(dx, dy, sp[D::dmin2])));
          act = gate ? act : 0.f;
          const float w = act > 0.f ? mu : 0.f;
          const float gx = 2.f * dx, gy = 2.f * dy;
          const float gxa = gx * act, gya = gy * act;
          lx[3 * i] -= gxa;
          lx[3 * i + 1] -= gya;
          lx[3 * j] += gxa;
          lx[3 * j + 1] += gya;
          const float wxx = w * gx * gx, wyy = w * gy * gy, wxy = w * gx * gy;
          const int xi = 3 * i, yi = 3 * i + 1, xj = 3 * j, yj = 3 * j + 1;
          H[xi * n + xi] += wxx; H[yi * n + yi] += wyy;
          H[xj * n + xj] += wxx; H[yj * n + yj] += wyy;
          H[xi * n + yi] += wxy; H[yi * n + xi] += wxy;
          H[xj * n + yj] += wxy; H[yj * n + xj] += wxy;
          H[xi * n + xj] -= wxx; H[xj * n + xi] -= wxx;
          H[yi * n + yj] -= wyy; H[yj * n + yi] -= wyy;
          H[xi * n + yj] -= wxy; H[yj * n + xi] -= wxy;
          H[yi * n + xj] -= wxy; H[xj * n + yi] -= wxy;
          ++p;
        }
      }
    }
  }
};

}  // namespace nmpc
