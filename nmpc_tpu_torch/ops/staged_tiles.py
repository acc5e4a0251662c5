"""Launch geometry of the tile design of K3 (`riccati_lanes`) and K5
(`linesearch_costs_lanes`), csrc/staged_tiles.cuh: what the C++ constants
are, what a block takes of the card, and the nvcc flags that set them.

A block owns a tile of S consecutive scenarios and streams the horizon
through a ring of D stage tiles in shared memory.
  K3: T lanes per scenario (1: every block in registers), tile pitch P (S,
      or S + 1 where a team's lanes read down a column), and `spill`: the
      output tile and the per-team slots in a device-memory scratch of the
      wrapper's where they do not fit in shared memory beside the ring.
  K5: A x S threads a block (A candidates), at most K5_THREADS.
The picks per robot count come from `python -m
nmpc_tpu_torch.tools.staged_launch` (PERF.md); ops/cuda_build.py passes them
to nvcc, and the library reports them back (`nmpc_k3_geometry`,
`nmpc_k5_geometry`) for the wrappers to check. The sizes here mirror
K3Rows, K3Slot, K3Geom and K5Geom of the header.
"""

from __future__ import annotations

import dataclasses

# the H100's shared memory: at most 227 KB a block, 228 KB an SM, 1 KB of
# which each resident block reserves; 2,048 threads and 32 blocks an SM
SMEM_BLOCK_MAX = 232448
SMEM_SM = 233472
SMEM_RESERVED = 1024
THREADS_SM = 2048
BLOCKS_SM = 32
K5_THREADS = 512


@dataclasses.dataclass(frozen=True)
class K3Geometry:
    S: int
    D: int
    T: int
    P: int
    spill: bool = False


@dataclasses.dataclass(frozen=True)
class K5Geometry:
    S: int
    D: int


# the picks per robot count (tools/staged_launch.py, PERF.md)
K3_GEOMETRY = {
    1: K3Geometry(128, 2, 1, 128), 2: K3Geometry(128, 2, 1, 128), 3: K3Geometry(16, 2, 16, 17),
    4: K3Geometry(8, 2, 16, 9), 5: K3Geometry(8, 2, 16, 9), 6: K3Geometry(8, 2, 32, 9),
    8: K3Geometry(8, 2, 32, 8), 10: K3Geometry(8, 2, 32, 8, spill=True),
}
# the K3 blocks that reside per SM by shared memory and threads at those picks
K3_BLOCKS_PER_SM = {1: 5, 2: 1, 3: 3, 4: 3, 5: 2, 6: 1, 8: 1, 10: 1}
K5_GEOMETRY = {1: K5Geometry(32, 2), 2: K5Geometry(32, 2), 3: K5Geometry(32, 2),
               4: K5Geometry(16, 2), 5: K5Geometry(16, 2), 6: K5Geometry(32, 2),
               8: K5Geometry(16, 2), 10: K5Geometry(8, 2)}


def al4(v: int) -> int:
    return (v + 3) // 4 * 4


def k3_rows(m: int) -> int:
    """Rows of K3's stage tile per scenario: A, B, lx, lu, lxx, luu, lux."""
    n, nu = 3 * m, 2 * m
    return n * n + n * nu + n + nu + n * n + nu * nu + nu * n


def k3_slot_floats(m: int) -> int:
    """Floats of one team's slot (K3Slot): Vxx and (Vxx A)' [n, ld], (Vxx
    B)' [nu, ld] (later Kfb' [n, ldu]), Qux [nu, n], Quu, Vx [ld], Qx, Qu,
    kff [ldu], the factor's reciprocal diagonal."""
    n, nu = 3 * m, 2 * m
    ld, ldu = al4(n), al4(nu)
    at = al4(n * ld)                          # (Vxx A)'
    at = al4(at + n * ld)                     # (Vxx B)', Kfb'
    at = al4(at + max(nu * ld, n * ldu))      # Qux
    at = al4(at + nu * n)                     # Quu
    at = al4(at + nu * nu)                    # Vx
    for width in (ld, n, nu, ldu, nu):        # Vx, Qx, Qu, kff, inv
        at = al4(at + width)
    return at


def check_k3(m: int, g: K3Geometry) -> None:
    """Raise unless g is a geometry K3Geom takes."""
    if g.S < 8 or g.S & (g.S - 1):
        raise ValueError(f"K3 at m={m}: S={g.S} is not a power of two >= 8")
    if not (g.T == 1 or (g.T <= 32 and 32 % g.T == 0)):
        raise ValueError(f"K3 at m={m}: a team of T={g.T} lanes does not sit in one warp")
    if g.P not in (g.S, g.S + 1) or g.D < 2:
        raise ValueError(f"K3 at m={m}: pitch {g.P} or ring depth {g.D}")


def k3_layout(m: int, g: K3Geometry | None = None) -> dict:
    """What one K3 block takes: threads, floats of its stage tile, output
    tile and slots, its shared bytes, its device-memory scratch (floats, with
    spill), and the blocks and warps that reside per SM by shared memory and
    threads (registers not counted)."""
    g = K3_GEOMETRY[m] if g is None else g
    check_k3(m, g)
    n, nu = 3 * m, 2 * m
    tile = al4(k3_rows(m) * g.P)
    out = al4((nu + nu * n) * g.P)
    priv = out + (g.S * k3_slot_floats(m) if g.T > 1 else 0)
    smem = 4 * (g.D * tile + (0 if g.spill else priv))
    threads = g.S * g.T
    blocks = min(SMEM_SM // (smem + SMEM_RESERVED), THREADS_SM // threads, BLOCKS_SM)
    return {"threads": threads, "tile": tile, "out": out, "smem_bytes": smem,
            "scratch_floats": priv if g.spill else 0, "blocks_per_sm": blocks,
            "warps_per_sm": blocks * ((threads + 31) // 32)}


def k5_rows(m: int, pairs: bool, n_obs: int, n_mov: int) -> int:
    """Rows of K5's stage tile per scenario: Xs, U, kff, Kfb, xref, lam, mov."""
    n, nu = 3 * m, 2 * m
    nc = (m * (m - 1) // 2 if pairs else 0) + 2 * nu + 2 * n + m * (n_obs + n_mov)
    return 2 * n + 2 * nu + nu * n + nc + 2 * n_mov


def k5_max_alphas(m: int) -> int:
    """The most line-search candidates one K5 block takes."""
    return K5_THREADS // K5_GEOMETRY[m].S


def k5_layout(m: int, rows: int, prm_size: int, n_alphas: int,
              g: K5Geometry | None = None) -> dict:
    """What one K5 block takes at `rows` stage rows, a parameter block of
    prm_size floats and n_alphas candidates."""
    g = K5_GEOMETRY[m] if g is None else g
    if g.S < 8 or g.S & (g.S - 1) or g.D < 2:
        raise ValueError(f"K5 at m={m}: S={g.S}, D={g.D}")
    smem = 4 * (al4(prm_size) + g.D * al4(rows * g.S))
    threads = n_alphas * g.S
    blocks = min(SMEM_SM // (smem + SMEM_RESERVED), THREADS_SM // threads, BLOCKS_SM)
    return {"threads": threads, "smem_bytes": smem, "blocks_per_sm": blocks,
            "warps_per_sm": blocks * ((threads + 31) // 32)}


def nvcc_flags(m: int, k3: K3Geometry | None = None, k5: K5Geometry | None = None) -> list:
    """The -D flags that set K3's and K5's geometry in csrc/staged.cu."""
    k3 = K3_GEOMETRY[m] if k3 is None else k3
    k5 = K5_GEOMETRY[m] if k5 is None else k5
    check_k3(m, k3)
    return [f"-DNMPC_K3_S={k3.S}", f"-DNMPC_K3_D={k3.D}", f"-DNMPC_K3_T={k3.T}",
            f"-DNMPC_K3_P={k3.P}", f"-DNMPC_K3_SPILL={int(k3.spill)}",
            f"-DNMPC_K5_S={k5.S}", f"-DNMPC_K5_D={k5.D}"]
