// K4 (stage expansions) and K6 (accepted rollout) of the staged AL-iLQR
// path, redesigned for Hopper on scenario tiles.
//
// Replaces the first designs of csrc/staged.cuh, expansion_thread and
// rollout_thread (one thread per (stage and) scenario reading and writing
// device memory directly; still built, by csrc/staged_first.cu, as the A/B
// baselines of tools/staged_launch.py), which in turn replace nmpc_tpu/ops/
// expansions_pallas.py::expansions_fused and rollout_pallas.py::
// rollout_alpha_lanes. What held them back on an H100:
//  * K4: each thread built the whole n x n Gauss-Newton Hessian H on its own
//    stack (1,296 of the 1,728 B of stack at m=6) in rolled loops with
//    dynamic indices: zeroed in local memory, summed there, read back to be
//    stored, ~2.6 KB of local traffic a thread beside 5.5 KB of useful
//    device bytes, with 327,680 threads at path (a) spilling past L1. Its
//    1,254 stores a (stage, scenario) went one scalar at a time through
//    64-bit addresses, ~75% of them fixed structure (A's identity, B's
//    entries, luu's diagonal, lux's zeros), and the stage's dual rows were
//    read one dependent row at a time.
//  * K6: one thread per scenario through N dependent stages, 1,024 warps at
//    B=32768 (~8 an SM); each stage's Xs, U, kff and Kfb went straight to
//    device memory and nothing of stage k+1 was requested early: bound by
//    latency, as K5's first design was.
//
// This design:
//  * K4: a block owns one stage of a tile of S consecutive scenarios (grid
//    tiles x N). It copies the stage's input rows (X, U, xref, lam, mov, mu)
//    into a tile [rows, S] with copy_rows (cp.async) and zero-fills a tile of
//    the Hessian's position block in shared memory: the (x, y) rows and
//    columns of every robot, (2m)^2 rows, the only entries of H that more
//    than one row type touches (a heading's diagonal entry is set once and
//    kept apart). Each scenario's thread then runs expansion_thread's
//    arithmetic on its column: the same terms in the same order per output
//    entry, adding into its column of the shared tile instead of a stack
//    array, so every output is expansion_thread's bit for bit; it leaves the
//    per-scenario scalars (A's and B's structure entries, lx, lu, luu's
//    diagonal, the headings' Hessian diagonal) in a small shared tile. After
//    one barrier all W warps of the block store every output row of the
//    tile (A, B, lx, lu, lxx, luu, lux) as 16-byte stores of 4 consecutive
//    scenarios, generating A's identity, B's dt, lxx's and luu's zeros and
//    lux from constants: no H on the stack, no scalar stores.
//  * K6: a block owns a tile of S scenarios and streams Xs, U, kff and Kfb
//    of each stage forward through stream_stages' ring (K5's
//    linesearch_tiles with one candidate, the scenario's own alpha). Each
//    scenario is run by a team of T threads (thread lane S + s): a lane
//    takes whole entries u_i of feedback_u, each summed over j in its order,
//    the team swaps them through a shared slot, and every lane then runs
//    euler_rows of rollout.cuh unchanged, so Xout and Uout are
//    rollout_thread's bit for bit. Consecutive threads store consecutive
//    scenarios of a row.
//  * Past sixteen robots the tiles shrink to what fits a block (S = 16 down
//    to 1; below 4 scenarios the rows go as 4-byte copies and stores), and
//    past m = 63, where even a ring of two one-scenario tiles overflows,
//    K6 (as K5) reads its stage rows from device memory (D = 0).
//  * K4's device-memory form (K4Device, expansion_tiles<..., kDevice>):
//    where a problem's rows overflow the tile (many obstacle rows; past m =
//    108 the output tile alone does), the same code runs with the input and
//    output tiles of 16 scenarios in a slot of a device-memory scratch of
//    the wrapper's (plain copies in, the column's sums and the 16-byte row
//    stores out of it; L1 and L2 hold the slot) and the parameter block read
//    from device memory, so its outputs are the tile form's bit for bit and
//    no robot or obstacle count is refused. A block takes (tile, stage) work
//    items in turn, so the scratch is the resident blocks' slots, not the
//    batch's.
// What bounds them now (measured on an H100 80GB HBM3 at 700 W, PERF.md):
// K4 its stores, 1,254 floats a (stage, scenario) at m=6, where it reaches
// 74-78% of its bytes bound; at m=1 (N=100, a launch of ~0.35 ms) 59-69%.
// K6 reaches 58-69% at m=6; at m=1 29-54%: N=100 dependent stages of a few
// dozen instructions on ~8 warps an SM, and a launch short enough for the
// wrapper's host work to show. From m=8 K4's compute threads take 254-255
// registers, which caps its blocks an SM; past m = 10 they keep lx and lu in
// the output tile and recompute the x-box activations where read
// (expansion_column_wide), and K6 runs teams of 16 (27-44% of the bounds at
// m = 12 and 16). S, W (K4) and S, D, T (K6)
// per m are compile-time constants, picked by `python -m
// nmpc_tpu_torch.tools.staged_launch` and passed by ops/cuda_build.py from
// ops/staged_tiles.py (-DNMPC_K4_S, ...).
//
// Host rehearsal: as staged_tiles.cuh (NMPC_HOST_BLOCK; the bodies take the
// thread index and count as arguments).
#pragma once

#include "staged_tiles.cuh"

namespace nmpc {

// a * b rounded on its own, never contracted into a neighbouring add: where
// expansion_thread reads a product back from its stack array (lx, lu), the
// sum it enters takes the rounded product, as here
NMPC_DEV float mul_rn(float a, float b) {
#ifdef __CUDA_ARCH__
  return __fmul_rn(a, b);
#else
  return a * b;
#endif
}

// The S values of one output row of a tile: a tile row (16-byte aligned), or
// the constant c where row is null.
struct RowSrc {
  const float* row;
  float c;
};

// 4 floats of a RowSrc at column j (a multiple of 4) to dst (16-byte aligned)
NMPC_DEV void store4(float* dst, const RowSrc& v, int j) {
#ifdef NMPC_HOST_BLOCK
  for (int i = 0; i < 4; ++i) dst[i] = v.row ? v.row[j + i] : v.c;
#else
  *reinterpret_cast<float4*>(dst) =
      v.row ? *reinterpret_cast<const float4*>(v.row + j) : make_float4(v.c, v.c, v.c, v.c);
#endif
}

// Store rows row0..row0+R-1 of a lane-major [*, B] output, columns b0..,
// row r from src(r): as 16-byte stores of 4 scenarios where the rows are
// aligned and the tile whole (S a multiple of 4), else single floats, a
// ragged tile's missing columns skipped. Consecutive threads store
// consecutive chunks of a row.
template <int S, class Src>
NMPC_DEV void emit_rows(float* dst, size_t row0, int R, size_t B, const TileSpan& t, Src&& src,
                        int tid, int nt) {
  if (S % 4 == 0 && t.vec && t.width == S) {
    constexpr int Q = S >= 4 ? S / 4 : 1;
    for (int c = tid; c < R * Q; c += nt) {
      const int r = c / Q, q = c % Q;
      store4(dst + (row0 + r) * B + t.b0 + 4 * q, src(r), 4 * q);
    }
  } else {
    for (int e = tid; e < R * S; e += nt) {
      const int r = e / S, j = e % S;
      if (j < t.width) {
        const RowSrc v = src(r);
        dst[(row0 + r) * B + t.b0 + j] = v.row ? v.row[j] : v.c;
      }
    }
  }
}

// ---------------------------------------------------------------------------
// K4: the stage expansions
// ---------------------------------------------------------------------------

// Rows of K4's input tile (X [n], U [nu], xref [n], lam [nc], mov [2 n_mov],
// mu [1]; nc and n_mov are the launch's) and of its output tile: the
// position block Hc of the Hessian ((x, y) of every robot, entry (p, q) at
// row Hc + p 2m + q for the position index p = 2 r + (0: x, 1: y) of robot
// r), A's and B's structure entries per robot, the headings' Hessian
// diagonal, lx, lu and luu's diagonal.
template <int NR>
struct K4Rows {
  static constexpr int n = 3 * NR, nu = 2 * NR, np = 2 * NR;
  static constexpr int X = 0, U = n, xref = n + nu, lam = 2 * n + nu;
  static constexpr int Hc = 0, e1 = np * np, e2 = e1 + NR, bc = e2 + NR, bs = bc + NR,
                       hth = bs + NR, lx = hth + NR, lu = lx + n, luu = lu + nu,
                       out = luu + nu;
  int nc, mov, mu, in;
  NMPC_HD K4Rows(bool pairs, int n_obs, int n_mov)
      : nc((pairs ? NR * (NR - 1) / 2 : 0) + 2 * nu + 2 * n + NR * (n_obs + n_mov)),
        mov(lam + nc),
        mu(lam + nc + 2 * n_mov),
        in(lam + nc + 2 * n_mov + 1) {}
  // the position index of state row i, or -1 for a heading
  static NMPC_HD constexpr int pos(int i) { return i % 3 < 2 ? 2 * (i / 3) + i % 3 : -1; }
};

// K4's launch geometry: S scenarios a block (tile pitch S), W warps a block
template <int NR, int S_, int W_>
struct K4Geom {
  static constexpr int S = S_, W = W_, threads = 32 * W_;
  static_assert(S >= 1 && (S & (S - 1)) == 0, "S: a power of two");
  static_assert(W >= 1 && W <= 32, "W: 1 to 32 warps");
  // floats of dynamic shared memory: the parameter block, the input tile of
  // `rows` rows, the output tile
  NMPC_HD static int smem_floats(int rows, int prm_size) {
    return al4(prm_size) + al4(rows * S) + al4(K4Rows<NR>::out * S);
  }
  // floats of a block's slot of the device-memory form's scratch: the input
  // tile and the output tile
  NMPC_HD static int scratch_floats(int rows) { return al4(rows * S) + al4(K4Rows<NR>::out * S); }
};

// K4's device-memory form, which every library holds beside its tile form
// (ops/staged_tiles.py::K4_DEVICE): the input and output tiles of 16
// scenarios in a slot of the wrapper's scratch, the parameter block read
// from device memory
template <int NR>
using K4Device = K4Geom<NR, 16, 4>;

// expansion_thread (staged.cuh) for the scenario of tile column t (input
// tile, rows P apart) into column o of the output tile: the same arithmetic
// in the same order, term by term.
template <int NR, int P>
NMPC_DEV void expansion_column(const ExpArgs& a, const K4Rows<NR>& R, const float* sp,
                               const float* t, float* o, int k) {
  using D = Dims<NR>;
  using Q = K4Rows<NR>;
  constexpr int n = D::n, nu = D::nu, np = Q::np;
  const bool pairs = a.pairs != 0;
  const int nc = R.nc;
  const float dt = sp[D::dt];
  const float mu = t[R.mu * P];
  const bool gate = k > 0;
  const float* lam = t + R.lam * P;
  float* Hc = o + Q::Hc * P;
  auto H = [&](int i, int j) -> float& { return Hc[(Q::pos(i) * np + Q::pos(j)) * P]; };
  float x[n], u[nu];
#pragma unroll
  for (int i = 0; i < n; ++i) x[i] = t[(Q::X + i) * P];
#pragma unroll
  for (int i = 0; i < nu; ++i) u[i] = t[(Q::U + i) * P];

  // dynamics Jacobians (Euler unicycle, closed form): A's and B's entries
#pragma unroll
  for (int r = 0; r < NR; ++r) {
    float s, c;
    sincosf(x[3 * r + 2], &s, &c);
    const float v = u[2 * r];
    o[(Q::e1 + r) * P] = -dt * v * s;
    o[(Q::e2 + r) * P] = dt * v * c;
    o[(Q::bc + r) * P] = dt * c;
    o[(Q::bs + r) * P] = dt * s;
  }

  float lx[n], lu[nu];
#pragma unroll
  for (int i = 0; i < n; ++i) lx[i] = mul_rn(2.f * sp[D::q + i], x[i] - t[(Q::xref + i) * P]);
#pragma unroll
  for (int i = 0; i < nu; ++i) lu[i] = mul_rn(2.f * sp[D::r + i], u[i]);
  const int row_u = nc - 2 * nu - 2 * n, row_x = nc - 2 * n;
  float xlo[n], xhi[n];
#pragma unroll
  for (int i = 0; i < n; ++i) {
    xlo[i] = relu(al_step(lam[(row_x + i) * P], mu, x[i] - sp[D::x_lo + i]));
    xhi[i] = relu(al_step(lam[(row_x + n + i) * P], mu, sp[D::x_hi + i] - x[i]));
    xlo[i] = gate ? xlo[i] : 0.f;
    xhi[i] = gate ? xhi[i] : 0.f;
  }
  // the diagonal base (the position block was zero-filled)
#pragma unroll
  for (int i = 0; i < n; ++i) {
    const float d = 2.f * sp[D::q + i] + mu * ((xlo[i] > 0.f ? 1.f : 0.f) + (xhi[i] > 0.f ? 1.f : 0.f));
    if (Q::pos(i) >= 0)
      H(i, i) = d;
    else
      o[(Q::hth + i / 3) * P] = d;
  }

  int row = 0;
  if (pairs) {
#pragma unroll
    for (int i = 0; i < NR; ++i) {
#pragma unroll
      for (int j = i + 1; j < NR; ++j) {
        const float dx = x[3 * i] - x[3 * j];
        const float dy = x[3 * i + 1] - x[3 * j + 1];
        float act = relu(al_step(lam[row * P], mu, pair_c(dx, dy, sp[D::dmin2])));
        act = gate ? act : 0.f;
        const float w = act > 0.f ? mu : 0.f;
        const float gx = 2.f * dx, gy = 2.f * dy;
        lx[3 * i] = lx[3 * i] - gx * act;
        lx[3 * i + 1] = lx[3 * i + 1] - gy * act;
        lx[3 * j] = lx[3 * j] + gx * act;
        lx[3 * j + 1] = lx[3 * j + 1] + gy * act;
        const float wxx = w * gx * gx, wyy = w * gy * gy, wxy = w * gx * gy;
        const int xi = 3 * i, yi = 3 * i + 1, xj = 3 * j, yj = 3 * j + 1;
        H(xi, xi) += wxx; H(yi, yi) += wyy;
        H(xj, xj) += wxx; H(yj, yj) += wyy;
        H(xi, yi) += wxy; H(yi, xi) += wxy;
        H(xj, yj) += wxy; H(yj, xj) += wxy;
        H(xi, xj) += -wxx; H(xj, xi) += -wxx;
        H(yi, yj) += -wyy; H(yj, yi) += -wyy;
        H(xi, yj) += -wxy; H(yj, xi) += -wxy;
        H(yi, xj) += -wxy; H(xj, yi) += -wxy;
        ++row;
      }
    }
  }
  const float* obs = sp + D::alphas;
#pragma unroll
  for (int i = 0; i < NR; ++i) {
    for (int ob = 0; ob < a.n_obs; ++ob) {
      const float dx = x[3 * i] - obs[3 * ob];
      const float dy = x[3 * i + 1] - obs[3 * ob + 1];
      float dist;
      const float c = obs_c(dx, dy, obs[3 * ob + 2], &dist);
      float act = relu(al_step(lam[row * P], mu, c));
      act = gate ? act : 0.f;
      const float w = act > 0.f ? mu : 0.f;
      const float ux = dx / dist, uy = dy / dist;
      lx[3 * i] = lx[3 * i] - ux * act;
      lx[3 * i + 1] = lx[3 * i + 1] - uy * act;
      const int xi = 3 * i, yi = 3 * i + 1;
      H(xi, xi) += w * ux * ux;
      H(yi, yi) += w * uy * uy;
      H(xi, yi) += w * ux * uy;
      H(yi, xi) += w * ux * uy;
      ++row;
    }
  }
  if (a.n_mov) {
    const float* mov = t + R.mov * P;
#pragma unroll
    for (int i = 0; i < NR; ++i) {
      for (int ob = 0; ob < a.n_mov; ++ob) {
        const float dx = x[3 * i] - mov[(2 * ob) * P];
        const float dy = x[3 * i + 1] - mov[(2 * ob + 1) * P];
        float act = relu(al_step(lam[row * P], mu, pair_c(dx, dy, sp[D::dmin2])));
        act = gate ? act : 0.f;
        const float w = act > 0.f ? mu : 0.f;
        const float gx = 2.f * dx, gy = 2.f * dy;
        lx[3 * i] = lx[3 * i] - gx * act;
        lx[3 * i + 1] = lx[3 * i + 1] - gy * act;
        const int xi = 3 * i, yi = 3 * i + 1;
        H(xi, xi) += w * gx * gx;
        H(yi, yi) += w * gy * gy;
        H(xi, yi) += w * gx * gy;
        H(yi, xi) += w * gx * gy;
        ++row;
      }
    }
  }

#pragma unroll
  for (int i = 0; i < nu; ++i) {
    const float alo = relu(al_step(lam[(row_u + i) * P], mu, u[i] - sp[D::u_lo + i]));
    const float ahi = relu(al_step(lam[(row_u + nu + i) * P], mu, sp[D::u_hi + i] - u[i]));
    lu[i] = lu[i] - alo + ahi;
    o[(Q::luu + i) * P] = 2.f * sp[D::r + i] + mu * ((alo > 0.f ? 1.f : 0.f) + (ahi > 0.f ? 1.f : 0.f));
  }
#pragma unroll
  for (int i = 0; i < n; ++i) o[(Q::lx + i) * P] = lx[i] - xlo[i] + xhi[i];
#pragma unroll
  for (int i = 0; i < nu; ++i) o[(Q::lu + i) * P] = lu[i];
}

// expansion_column past ten robots: the same arithmetic in the same order,
// with lx and lu summed in their rows of the output tile and the x-box
// activations computed again where they are read (the same values), so that
// a thread holds only x and u (at m=16 expansion_column's arrays alone would
// take 256 registers). Kept apart from expansion_column, whose machine code
// at m <= 10 stays as it was.
template <int NR, int P>
NMPC_DEV void expansion_column_wide(const ExpArgs& a, const K4Rows<NR>& R, const float* sp,
                                    const float* t, float* o, int k) {
  using D = Dims<NR>;
  using Q = K4Rows<NR>;
  constexpr int n = D::n, nu = D::nu, np = Q::np;
  const bool pairs = a.pairs != 0;
  const int nc = R.nc;
  const float dt = sp[D::dt];
  const float mu = t[R.mu * P];
  const bool gate = k > 0;
  const float* lam = t + R.lam * P;
  float* Hc = o + Q::Hc * P;
  auto H = [&](int i, int j) -> float& { return Hc[(Q::pos(i) * np + Q::pos(j)) * P]; };
  float x[n], u[nu];
#pragma unroll
  for (int i = 0; i < n; ++i) x[i] = t[(Q::X + i) * P];
#pragma unroll
  for (int i = 0; i < nu; ++i) u[i] = t[(Q::U + i) * P];

  // dynamics Jacobians (Euler unicycle, closed form): A's and B's entries
#pragma unroll
  for (int r = 0; r < NR; ++r) {
    float s, c;
    sincosf(x[3 * r + 2], &s, &c);
    const float v = u[2 * r];
    o[(Q::e1 + r) * P] = -dt * v * s;
    o[(Q::e2 + r) * P] = dt * v * c;
    o[(Q::bc + r) * P] = dt * c;
    o[(Q::bs + r) * P] = dt * s;
  }

  auto lx = [&](int i) -> float& { return o[(Q::lx + i) * P]; };
  auto lu = [&](int i) -> float& { return o[(Q::lu + i) * P]; };
#pragma unroll
  for (int i = 0; i < n; ++i) lx(i) = mul_rn(2.f * sp[D::q + i], x[i] - t[(Q::xref + i) * P]);
#pragma unroll
  for (int i = 0; i < nu; ++i) lu(i) = mul_rn(2.f * sp[D::r + i], u[i]);
  const int row_u = nc - 2 * nu - 2 * n, row_x = nc - 2 * n;
  auto box = [&](int i, bool hi) {
    const float c = hi ? sp[D::x_hi + i] - x[i] : x[i] - sp[D::x_lo + i];
    const float v = relu(al_step(lam[(row_x + (hi ? n : 0) + i) * P], mu, c));
    return gate ? v : 0.f;
  };
  auto xlo = [&](int i) { return box(i, false); };
  auto xhi = [&](int i) { return box(i, true); };
  // the diagonal base (the position block was zero-filled)
#pragma unroll
  for (int i = 0; i < n; ++i) {
    const float d = 2.f * sp[D::q + i] + mu * ((xlo(i) > 0.f ? 1.f : 0.f) + (xhi(i) > 0.f ? 1.f : 0.f));
    if (Q::pos(i) >= 0)
      H(i, i) = d;
    else
      o[(Q::hth + i / 3) * P] = d;
  }

  int row = 0;
  if (pairs) {
#pragma unroll
    for (int i = 0; i < NR; ++i) {
#pragma unroll
      for (int j = i + 1; j < NR; ++j) {
        const float dx = x[3 * i] - x[3 * j];
        const float dy = x[3 * i + 1] - x[3 * j + 1];
        float act = relu(al_step(lam[row * P], mu, pair_c(dx, dy, sp[D::dmin2])));
        act = gate ? act : 0.f;
        const float w = act > 0.f ? mu : 0.f;
        const float gx = 2.f * dx, gy = 2.f * dy;
        lx(3 * i) = lx(3 * i) - gx * act;
        lx(3 * i + 1) = lx(3 * i + 1) - gy * act;
        lx(3 * j) = lx(3 * j) + gx * act;
        lx(3 * j + 1) = lx(3 * j + 1) + gy * act;
        const float wxx = w * gx * gx, wyy = w * gy * gy, wxy = w * gx * gy;
        const int xi = 3 * i, yi = 3 * i + 1, xj = 3 * j, yj = 3 * j + 1;
        H(xi, xi) += wxx; H(yi, yi) += wyy;
        H(xj, xj) += wxx; H(yj, yj) += wyy;
        H(xi, yi) += wxy; H(yi, xi) += wxy;
        H(xj, yj) += wxy; H(yj, xj) += wxy;
        H(xi, xj) += -wxx; H(xj, xi) += -wxx;
        H(yi, yj) += -wyy; H(yj, yi) += -wyy;
        H(xi, yj) += -wxy; H(yj, xi) += -wxy;
        H(yi, xj) += -wxy; H(xj, yi) += -wxy;
        ++row;
      }
    }
  }
  const float* obs = sp + D::alphas;
#pragma unroll
  for (int i = 0; i < NR; ++i) {
    for (int ob = 0; ob < a.n_obs; ++ob) {
      const float dx = x[3 * i] - obs[3 * ob];
      const float dy = x[3 * i + 1] - obs[3 * ob + 1];
      float dist;
      const float c = obs_c(dx, dy, obs[3 * ob + 2], &dist);
      float act = relu(al_step(lam[row * P], mu, c));
      act = gate ? act : 0.f;
      const float w = act > 0.f ? mu : 0.f;
      const float ux = dx / dist, uy = dy / dist;
      lx(3 * i) = lx(3 * i) - ux * act;
      lx(3 * i + 1) = lx(3 * i + 1) - uy * act;
      const int xi = 3 * i, yi = 3 * i + 1;
      H(xi, xi) += w * ux * ux;
      H(yi, yi) += w * uy * uy;
      H(xi, yi) += w * ux * uy;
      H(yi, xi) += w * ux * uy;
      ++row;
    }
  }
  if (a.n_mov) {
    const float* mov = t + R.mov * P;
#pragma unroll
    for (int i = 0; i < NR; ++i) {
      for (int ob = 0; ob < a.n_mov; ++ob) {
        const float dx = x[3 * i] - mov[(2 * ob) * P];
        const float dy = x[3 * i + 1] - mov[(2 * ob + 1) * P];
        float act = relu(al_step(lam[row * P], mu, pair_c(dx, dy, sp[D::dmin2])));
        act = gate ? act : 0.f;
        const float w = act > 0.f ? mu : 0.f;
        const float gx = 2.f * dx, gy = 2.f * dy;
        lx(3 * i) = lx(3 * i) - gx * act;
        lx(3 * i + 1) = lx(3 * i + 1) - gy * act;
        const int xi = 3 * i, yi = 3 * i + 1;
        H(xi, xi) += w * gx * gx;
        H(yi, yi) += w * gy * gy;
        H(xi, yi) += w * gx * gy;
        H(yi, xi) += w * gx * gy;
        ++row;
      }
    }
  }

#pragma unroll
  for (int i = 0; i < nu; ++i) {
    const float alo = relu(al_step(lam[(row_u + i) * P], mu, u[i] - sp[D::u_lo + i]));
    const float ahi = relu(al_step(lam[(row_u + nu + i) * P], mu, sp[D::u_hi + i] - u[i]));
    lu(i) = lu(i) - alo + ahi;
    o[(Q::luu + i) * P] = 2.f * sp[D::r + i] + mu * ((alo > 0.f ? 1.f : 0.f) + (ahi > 0.f ? 1.f : 0.f));
  }
#pragma unroll
  for (int i = 0; i < n; ++i) o[(Q::lx + i) * P] = lx(i) - xlo(i) + xhi(i);
}

// K4 for stage k of the block's tile `blk`: sp, the parameter block in
// shared memory; tiles, the input and output tiles after it. With kDevice
// (the device-memory form) sp is the parameter block in device memory and
// tiles the block's slot of the scratch, filled by plain copies; the rest is
// the same code, so the outputs are the tile form's bit for bit.
template <int NR, class G, bool kDevice = false>
NMPC_DEV void expansion_tiles(const ExpArgs& a, const float* sp, float* tiles, int blk, int k,
                              bool vec, int tid) {
  using Q = K4Rows<NR>;
  constexpr int n = Q::n, nu = Q::nu, np = Q::np, S = G::S, nt = G::threads;
  const size_t B = a.B;
  const TileSpan span{blk * S, a.B - blk * S < S ? a.B - blk * S : S, vec};
  const K4Rows<NR> R(a.pairs != 0, a.n_obs, a.n_mov);
  float* tin = tiles;
  float* tout = tiles + al4(R.in * S);
  if constexpr (kDevice) {
    copy_rows_plain<S>(tin + Q::X * S, a.Xs, (size_t)k * n, n, B, span, tid, nt);
    copy_rows_plain<S>(tin + Q::U * S, a.U, (size_t)k * nu, nu, B, span, tid, nt);
    copy_rows_plain<S>(tin + Q::xref * S, a.xref, (size_t)k * n, n, B, span, tid, nt);
    copy_rows_plain<S>(tin + Q::lam * S, a.lam, (size_t)k * R.nc, R.nc, B, span, tid, nt);
    if (a.n_mov)
      copy_rows_plain<S>(tin + R.mov * S, a.mov, (size_t)k * 2 * a.n_mov, 2 * a.n_mov, B, span,
                         tid, nt);
    copy_rows_plain<S>(tin + R.mu * S, a.mu, 0, 1, B, span, tid, nt);
  } else {
    copy_rows<S, S>(tin + Q::X * S, a.Xs, (size_t)k * n, n, B, span, tid, nt);
    copy_rows<S, S>(tin + Q::U * S, a.U, (size_t)k * nu, nu, B, span, tid, nt);
    copy_rows<S, S>(tin + Q::xref * S, a.xref, (size_t)k * n, n, B, span, tid, nt);
    copy_rows<S, S>(tin + Q::lam * S, a.lam, (size_t)k * R.nc, R.nc, B, span, tid, nt);
    if (a.n_mov)
      copy_rows<S, S>(tin + R.mov * S, a.mov, (size_t)k * 2 * a.n_mov, 2 * a.n_mov, B, span, tid,
                      nt);
    copy_rows<S, S>(tin + R.mu * S, a.mu, 0, 1, B, span, tid, nt);
    cp_commit();
  }
  for (int i = tid; i < np * np * S; i += nt) tout[Q::Hc * S + i] = 0.f;
  if constexpr (!kDevice) cp_wait<0>();
  block_sync();
  for (int s = tid; s < S; s += nt) {
    if constexpr (NR > 10)
      expansion_column_wide<NR, S>(a, R, sp, tin + s, tout + s, k);
    else
      expansion_column<NR, S>(a, R, sp, tin + s, tout + s, k);
  }
  block_sync();

  const float dt = sp[Dims<NR>::dt];
  auto row_of = [&](int r) { return RowSrc{tout + r * S, 0.f}; };
  auto zero = [](int) { return RowSrc{nullptr, 0.f}; };
  emit_rows<S>(a.A, (size_t)k * n * n, n * n, B, span, [&](int r) {
    const int i = r / n, j = r % n, rb = i / 3, p = i % 3;
    if (j == 3 * rb + 2 && p < 2) return row_of((p == 0 ? Q::e1 : Q::e2) + rb);
    return RowSrc{nullptr, i == j ? 1.f : 0.f};
  }, tid, nt);
  emit_rows<S>(a.Bm, (size_t)k * n * nu, n * nu, B, span, [&](int r) {
    const int i = r / nu, j = r % nu, rb = i / 3, p = i % 3;
    if (p < 2 && j == 2 * rb) return row_of((p == 0 ? Q::bc : Q::bs) + rb);
    return RowSrc{nullptr, p == 2 && j == 2 * rb + 1 ? dt : 0.f};
  }, tid, nt);
  emit_rows<S>(a.lx, (size_t)k * n, n, B, span, [&](int r) { return row_of(Q::lx + r); }, tid,
               nt);
  emit_rows<S>(a.lu, (size_t)k * nu, nu, B, span, [&](int r) { return row_of(Q::lu + r); },
               tid, nt);
  emit_rows<S>(a.lxx, (size_t)k * n * n, n * n, B, span, [&](int r) {
    const int i = r / n, j = r % n, pi = Q::pos(i), pj = Q::pos(j);
    if (pi >= 0 && pj >= 0) return row_of(Q::Hc + pi * np + pj);
    if (i == j) return row_of(Q::hth + i / 3);
    return RowSrc{nullptr, 0.f};
  }, tid, nt);
  emit_rows<S>(a.luu, (size_t)k * nu * nu, nu * nu, B, span, [&](int r) {
    const int i = r / nu, j = r % nu;
    return i == j ? row_of(Q::luu + i) : RowSrc{nullptr, 0.f};
  }, tid, nt);
  emit_rows<S>(a.lux, (size_t)k * nu * n, nu * n, B, span, zero, tid, nt);
}

// ---------------------------------------------------------------------------
// K6: the accepted rollout
// ---------------------------------------------------------------------------

// Rows of K6's stage tile: Xs [n], U [nu], kff [nu], Kfb [nu, n]
template <int NR>
struct K6Rows {
  static constexpr int n = 3 * NR, nu = 2 * NR;
  static constexpr int Xs = 0, U = n, kff = n + nu, Kfb = n + 2 * nu, rows = Kfb + nu * n;
};

// K6's launch geometry: S scenarios a block (pitch S), D stage tiles in the
// ring, a team of T threads a scenario (T > 1: a shared slot [nu, S] in
// which the team swaps u); S T threads a block. D = 0 (teams, where a ring
// of two one-scenario tiles overflows the block: m >= 64) reads every stage
// row straight from device memory.
template <int NR, int S_, int D_, int T_>
struct K6Geom {
  static constexpr int S = S_, D = D_, T = T_, threads = S * T;
  static_assert(S >= 1 && (S & (S - 1)) == 0, "S: a power of two");
  static_assert(D >= 2 || (D == 0 && T > 1), "a ring of at least two stage tiles, or none");
  static_assert(T >= 1 && T <= 2 * NR && threads <= 1024, "T: 1 to nu lanes a scenario");
  static constexpr int tile = al4(K6Rows<NR>::rows * S);
  static constexpr int slot = T > 1 ? al4(2 * NR * S) : 0;
  static constexpr int smem_floats = D * tile + slot;
};

// K6 for the block of tile `blk`: thread tid is lane tid / S of scenario
// tid % S; smem: G::smem_floats of dynamic shared memory.
template <int NR, class G>
NMPC_DEV void rollout_tiles(const RolloutArgs& a, float dt, float* smem, int blk, bool vec,
                            int tid) {
  using Q = K6Rows<NR>;
  constexpr int n = Q::n, nu = Q::nu, S = G::S, T = G::T, nt = G::threads;
  const size_t B = a.B;
  const TileSpan span{blk * S, a.B - blk * S < S ? a.B - blk * S : S, vec};
  const int s = tid % S, lane = tid / S;
  const bool live = s < span.width;
  const size_t b = span.b0 + (live ? s : 0);
  const float alpha = a.alpha[b];
  float* us = smem + G::D * G::tile;  // the team's u (T > 1), entry i at us[i S + s]
  float x[n], xb[n], u[nu];
#pragma unroll
  for (int i = 0; i < n; ++i) x[i] = a.x0[(size_t)i * B + b];
  auto issue = [&](int k, float* t) {
    copy_rows<S, S>(t + Q::Xs * S, a.Xs, (size_t)k * n, n, B, span, tid, nt);
    copy_rows<S, S>(t + Q::U * S, a.U, (size_t)k * nu, nu, B, span, tid, nt);
    copy_rows<S, S>(t + Q::kff * S, a.kff, (size_t)k * nu, nu, B, span, tid, nt);
    copy_rows<S, S>(t + Q::Kfb * S, a.Kfb, (size_t)k * nu * n, nu * n, B, span, tid, nt);
  };
  if constexpr (G::D == 0) {
    // the stage rows straight from the lane-major arrays (stride B): the
    // team body below with its reads moved from the tile, a block barrier
    // after each stage as the ring's
    for (int k = 0; k < a.N; ++k) {
      const float* Xs = a.Xs + (size_t)k * n * B + b;
      const float* U = a.U + (size_t)k * nu * B + b;
      const float* kff = a.kff + (size_t)k * nu * B + b;
      const float* K = a.Kfb + (size_t)k * nu * n * B + b;
      float dx[n];
#pragma unroll
      for (int j = 0; j < n; ++j) dx[j] = x[j] - Xs[(size_t)j * B];
      for (int i = lane; i < nu; i += T) {
        float acc = U[(size_t)i * B] + alpha * kff[(size_t)i * B];
#pragma unroll
        for (int j = 0; j < n; ++j) acc = acc + K[(size_t)(i * n + j) * B] * dx[j];
        us[i * S + s] = acc;
      }
      block_sync();
#pragma unroll
      for (int i = 0; i < nu; ++i) u[i] = us[i * S + s];
#pragma unroll
      for (int i = 0; i < nu; ++i)
        if (live && i % T == lane) a.Uout[(size_t)(k * nu + i) * B + b] = u[i];
      euler_rows<NR>(x, u, dt, x);
#pragma unroll
      for (int i = 0; i < n; ++i)
        if (live && i % T == lane) a.Xout[(size_t)(k * n + i) * B + b] = x[i];
      block_sync();
    }
  } else {
    stream_stages<G::D>(a.N, false, smem, G::tile, issue, [&](int k, const float* t) {
      const float* ts = t + s;
#pragma unroll
      for (int i = 0; i < n; ++i) xb[i] = ts[(Q::Xs + i) * S];
      if constexpr (T == 1) {
        float ub[nu], kf[nu];
#pragma unroll
        for (int i = 0; i < nu; ++i) {
          ub[i] = ts[(Q::U + i) * S];
          kf[i] = ts[(Q::kff + i) * S];
        }
        feedback_u<NR>(x, xb, ub, kf, ts + Q::Kfb * S, S, alpha, u);
      } else {
        // feedback_u's entries, u_i on lane i % T, each summed in its order
        float dx[n];
#pragma unroll
        for (int j = 0; j < n; ++j) dx[j] = x[j] - xb[j];
        for (int i = lane; i < nu; i += T) {
          const float* K = ts + Q::Kfb * S;
          float acc = ts[(Q::U + i) * S] + alpha * ts[(Q::kff + i) * S];
#pragma unroll
          for (int j = 0; j < n; ++j) acc = acc + K[(i * n + j) * S] * dx[j];
          us[i * S + s] = acc;
        }
        block_sync();
#pragma unroll
        for (int i = 0; i < nu; ++i) u[i] = us[i * S + s];
      }
#pragma unroll
      for (int i = 0; i < nu; ++i)
        if (live && i % T == lane) a.Uout[(size_t)(k * nu + i) * B + b] = u[i];
      euler_rows<NR>(x, u, dt, x);
#pragma unroll
      for (int i = 0; i < n; ++i)
        if (live && i % T == lane) a.Xout[(size_t)(k * n + i) * B + b] = x[i];
    });
  }
}

}  // namespace nmpc
