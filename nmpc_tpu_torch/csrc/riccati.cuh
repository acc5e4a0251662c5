// Small dense factorizations of the backward Riccati sweep.
//
// Ported from nmpc_tpu/ops/riccati_pallas.py (_chol, _chol_solve, _mtm). The
// TPU versions factor 128 scenarios at once, one [rows, 128-lane] op per
// column; here each thread factors its own scenario's block.
#pragma once

#ifndef NMPC_DEV
#define NMPC_DEV __device__ __forceinline__
#endif

#include <math.h>

namespace nmpc {

// In-place left-looking Cholesky of the lower triangle of an SPD [M, M]
// row-major block, with `reg` added to the diagonal inside the square root
// (Quu + reg I). Entries above the diagonal are neither read nor written.
// inv receives the reciprocals of the diagonal, so the substitutions
// multiply instead of dividing.
template <int M>
NMPC_DEV void chol(float* A, float reg, float* inv) {
#pragma unroll 1
  for (int i = 0; i < M; ++i) {
    for (int j = i; j < M; ++j) {
      float v = A[j * M + i];
      for (int k = 0; k < i; ++k) v = v - A[j * M + k] * A[i * M + k];
      A[j * M + i] = v;
    }
    const float d = sqrtf(A[i * M + i] + reg);
    const float iv = 1.f / d;
    inv[i] = iv;
    A[i * M + i] = d;
    for (int j = i + 1; j < M; ++j) A[j * M + i] = A[j * M + i] * iv;
  }
}

// Solve (L L^T) y = rhs in place for one right-hand side, L from chol().
template <int M>
NMPC_DEV void chol_solve(const float* L, const float* inv, float* y) {
#pragma unroll 1
  for (int i = 0; i < M; ++i) {
    float s = y[i];
    for (int k = 0; k < i; ++k) s = s - L[i * M + k] * y[k];
    y[i] = s * inv[i];
  }
#pragma unroll 1
  for (int i = M - 1; i >= 0; --i) {
    float s = y[i];
    for (int k = i + 1; k < M; ++k) s = s - L[k * M + i] * y[k];
    y[i] = s * inv[i];
  }
}

// Explicit inverse of the lower factor from chol(): Linv [M, M] row-major,
// lower triangle written (port of riccati_pallas.py::_chol_solve_inv, the
// reference's recorded negative result). Only the phase ablation
// (Phase::inv_solve, csrc/tools.cu) calls it; no production kernel does.
template <int M>
NMPC_DEV void chol_inverse(const float* L, const float* inv, float* Linv) {
#pragma unroll 1
  for (int j = 0; j < M; ++j) {
    Linv[j * M + j] = inv[j];
    for (int i = j + 1; i < M; ++i) {
      float acc = L[i * M + j] * Linv[j * M + j];
      for (int k = j + 1; k < i; ++k) acc = acc + L[i * M + k] * Linv[k * M + j];
      Linv[i * M + j] = -inv[i] * acc;
    }
  }
}

// Solve (L L^T) y = rhs in place through Linv from chol_inverse():
// y = Linv^T (Linv rhs), each sum in the reference's order.
template <int M>
NMPC_DEV void inv_solve(const float* Linv, float* y) {
  float t[M];
#pragma unroll 1
  for (int i = 0; i < M; ++i) {
    float acc = Linv[i * M] * y[0];
    for (int k = 1; k <= i; ++k) acc = acc + Linv[i * M + k] * y[k];
    t[i] = acc;
  }
#pragma unroll 1
  for (int i = 0; i < M; ++i) {
    float acc = Linv[i * M + i] * t[i];
    for (int k = i + 1; k < M; ++k) acc = acc + Linv[k * M + i] * t[k];
    y[i] = acc;
  }
}

// out[a, c] += (X^T Y)[a, c] for X [R, A], Y [R, C], all row-major; the
// product is summed first and then added, as _mtm's callers do.
template <int R, int A, int C>
NMPC_DEV void mtm_add(const float* X, const float* Y, float* out) {
#pragma unroll 1
  for (int a = 0; a < A; ++a) {
    for (int c = 0; c < C; ++c) {
      float acc = X[a] * Y[c];
#pragma unroll
      for (int k = 1; k < R; ++k) acc = acc + X[k * A + a] * Y[k * C + c];
      out[a * C + c] = out[a * C + c] + acc;
    }
  }
}

}  // namespace nmpc
