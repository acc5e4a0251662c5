"""Launch geometry of the tile designs of the staged kernels: K3
(`riccati_lanes`) and K5 (`linesearch_costs_lanes`), csrc/staged_tiles.cuh,
K4 (`expansions_fused`) and K6 (`rollout_alpha_lanes`),
csrc/expansions_rollout_tiles.cuh: what the C++ constants are, what a block
takes of the card, and the nvcc flags that set them.

A block owns a tile of S consecutive scenarios; K3, K5 and K6 stream the
horizon through a ring of D stage tiles in shared memory.
  K3: T lanes per scenario (1: every block in registers), tile pitch P (S,
      or S + 1 where a team's lanes read down a column), and `spill`: the
      output tile and the per-team slots in a device-memory scratch of the
      wrapper's where they do not fit in shared memory beside the ring.
  K5: A x S threads a block (A candidates), at most K5_THREADS; more
      candidates go as several launches (rollout.linesearch_costs_lanes).
  K4: one stage of the tile a block, W warps a block.
  K6: a team of T threads per scenario, S T threads a block.
K3 also takes other stage shapes (n, nu) than the robot stacks' (3m, 2m),
any n <= K3_MAX_N and nu <= K3_MAX_NU (the range of the robot stacks): the
ray-augmented stage of family I and the user models of make_generic_ocp,
each built from csrc/riccati_shape.cu with `k3_shape_flags`. K3's geometry
at every shape, the robot stacks' included, is `k3_rule`'s, which gives the
picks `python -m nmpc_tpu_torch.tools.staged_launch` recorded per robot
count (K3_GEOMETRY, PERF.md). ops/cuda_build.py passes them to nvcc, and
the library reports them back (`nmpc_k3_geometry`, ...) for cuda_build to
check. The sizes here mirror K3Rows, K3Slot, K3Geom, K5Geom,
K4Rows, K4Geom, K6Rows and K6Geom of the headers.
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


@dataclasses.dataclass(frozen=True)
class K4Geometry:
    S: int
    W: int


@dataclasses.dataclass(frozen=True)
class K6Geometry:
    S: int
    D: int
    T: int


# K3's picks as the sweep recorded them per robot count (tools/staged_launch.py,
# PERF.md), and at the stage shape of one robot with 10 LiDAR rays (n = 13,
# nu = 2; the registry's family I), picked by its shared memory as m=4's
# (n = 12). Builds take `k3_geometry` (`k3_rule`); the tests hold the rule
# to these picks.
K3_GEOMETRY = {
    1: K3Geometry(128, 2, 1, 128), 2: K3Geometry(128, 2, 1, 128), 3: K3Geometry(16, 2, 16, 17),
    4: K3Geometry(8, 2, 16, 9), 5: K3Geometry(8, 2, 16, 9), 6: K3Geometry(8, 2, 32, 9),
    8: K3Geometry(8, 2, 32, 8), 10: K3Geometry(8, 2, 32, 8, spill=True),
    (13, 2): K3Geometry(8, 2, 16, 9),
}
# the stage shapes K3 takes: any (n, nu) up to the largest robot stack's
K3_MAX_N, K3_MAX_NU = 30, 20
# the stage shapes (n, nu) besides (3m, 2m) of the problems the repository
# ships, built ahead by cuda_build.load_all: family I's ray stage, and the
# reference's two user models, Van der Pol (2, 1) and the first-order
# process (1, 1) (tests/test_generic_dynamics.py)
K3_SHAPES = ((13, 2), (2, 1), (1, 1))
# stage shapes beyond the shipped problems' that take every branch of
# `k3_rule` and the cases the robot stacks never reach: registers with odd
# nu (5, 3); teams of 16 at tiles of 16 with nu = 1 and odd nu (7, 1),
# (9, 5); teams of 16 at tiles of 8 (10, 6), (12, 10), (14, 3), with nu > T
# (15, 20); teams of 32 at the odd pitch with nu = 1 (16, 1) and at pitch S
# (19, 7), (20, 3); the slots spilled to device memory at a shape no robot
# stack has (29, 20) and at m=10's (30, 20). With the robot stacks and
# K3_SHAPES they take every residue of n and nu mod 4 (the stage rows'
# 16-byte alignment). Held against the plain version by the host rehearsal
# (tests/test_torch_staged_tiles.py) and on the card (chip_smoke.py,
# tests/test_torch_cuda.py).
K3_SWEEP_SHAPES = ((5, 3), (7, 1), (9, 5), (10, 6), (12, 10), (14, 3), (15, 20), (16, 1),
                   (19, 7), (20, 3), (29, 20), (30, 20))
# the K3 blocks that reside per SM by shared memory and threads at the picks
K3_BLOCKS_PER_SM = {1: 5, 2: 1, 3: 3, 4: 3, 5: 2, 6: 1, 8: 1, 10: 1, (13, 2): 4, (2, 1): 12,
                    (1, 1): 16}
K5_GEOMETRY = {1: K5Geometry(32, 2), 2: K5Geometry(32, 2), 3: K5Geometry(32, 2),
               4: K5Geometry(16, 2), 5: K5Geometry(16, 2), 6: K5Geometry(32, 2),
               8: K5Geometry(16, 2), 10: K5Geometry(8, 2)}
K4_GEOMETRY = {1: K4Geometry(128, 4), 2: K4Geometry(64, 2), 3: K4Geometry(64, 4),
               4: K4Geometry(64, 8), 5: K4Geometry(64, 4), 6: K4Geometry(64, 4),
               8: K4Geometry(32, 2), 10: K4Geometry(32, 4)}
K6_GEOMETRY = {1: K6Geometry(32, 4, 1), 2: K6Geometry(32, 4, 1), 3: K6Geometry(32, 2, 2),
               4: K6Geometry(32, 2, 2), 5: K6Geometry(32, 2, 2), 6: K6Geometry(32, 2, 1),
               8: K6Geometry(16, 2, 4), 10: K6Geometry(8, 2, 4)}


def k3_rule(n: int, nu: int) -> K3Geometry:
    """K3's geometry at stage shape (n, nu) by the rule the sweep's picks
    follow: a thread a scenario with every block in registers up to m=2's
    (6, 4); else teams of 16 lanes up to n = 15 and 32 beyond, tiles of 16
    scenarios up to n = 9 and 8 beyond, the odd pitch S + 1 up to n = 18
    (bank conflicts of a team reading down a column) and S beyond (16-byte
    copies of the larger tiles), and the slots in device memory (spill)
    where the ring and the slots overflow a block's shared memory."""
    if not (1 <= n <= K3_MAX_N and 1 <= nu <= K3_MAX_NU):
        raise NotImplementedError(
            f"K3 takes stage shapes up to n={K3_MAX_N}, nu={K3_MAX_NU}, not n={n}, nu={nu}")
    if n <= 6 and nu <= 4:
        return K3Geometry(128, 2, 1, 128)
    S = 16 if n <= 9 else 8
    g = K3Geometry(S, 2, 16 if n <= 15 else 32, S + 1 if n <= 18 else S)
    if k3_layout((n, nu), g)["smem_bytes"] > SMEM_BLOCK_MAX:
        g = dataclasses.replace(g, spill=True)
    return g


def k3_geometry(key) -> K3Geometry:
    """K3's geometry at a key (a robot count m or a stage shape (n, nu)):
    `k3_rule` at its stage shape, the one source of every K3 build."""
    return k3_rule(*k3_dims(key))


def al4(v: int) -> int:
    return (v + 3) // 4 * 4


def k3_dims(key) -> tuple:
    """(n, nu) of a K3 key: a robot count m (3m, 2m) or a stage shape."""
    return key if isinstance(key, tuple) else (3 * key, 2 * key)


def k3_rows(key) -> int:
    """Rows of K3's stage tile per scenario: A, B, lx, lu, lxx, luu, lux
    (key: m or (n, nu), as every K3 helper here)."""
    n, nu = k3_dims(key)
    return n * n + n * nu + n + nu + n * n + nu * nu + nu * n


def k3_slot_floats(key) -> int:
    """Floats of one team's slot (K3Slot): Vxx and (Vxx A)' [n, ld], (Vxx
    B)' [nu, ld] (later Kfb' [n, ldu]), Qux [nu, n], Quu, Vx [ld], Qx, Qu,
    kff [ldu], the factor's reciprocal diagonal."""
    n, nu = k3_dims(key)
    ld, ldu = al4(n), al4(nu)
    at = al4(n * ld)                          # (Vxx A)'
    at = al4(at + n * ld)                     # (Vxx B)', Kfb'
    at = al4(at + max(nu * ld, n * ldu))      # Qux
    at = al4(at + nu * n)                     # Quu
    at = al4(at + nu * nu)                    # Vx
    for width in (ld, n, nu, ldu, nu):        # Vx, Qx, Qu, kff, inv
        at = al4(at + width)
    return at


def check_k3(m, g: K3Geometry) -> None:
    """Raise unless g is a geometry K3Geom takes (m: a K3 key)."""
    if g.S < 8 or g.S & (g.S - 1):
        raise ValueError(f"K3 at m={m}: S={g.S} is not a power of two >= 8")
    if not (g.T == 1 or (g.T <= 32 and 32 % g.T == 0)):
        raise ValueError(f"K3 at m={m}: a team of T={g.T} lanes does not sit in one warp")
    if g.P not in (g.S, g.S + 1) or g.D < 2:
        raise ValueError(f"K3 at m={m}: pitch {g.P} or ring depth {g.D}")


def k3_layout(m, g: K3Geometry | None = None) -> dict:
    """What one K3 block takes: threads, floats of its stage tile, output
    tile and slots, its shared bytes, its device-memory scratch (floats, with
    spill), and the blocks and warps that reside per SM by shared memory and
    threads (registers not counted). m: a K3 key."""
    g = k3_geometry(m) if g is None else g
    check_k3(m, g)
    n, nu = k3_dims(m)
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
    return 2 * n + 2 * nu + nu * n + nc_rows(m, pairs, n_obs, n_mov) + 2 * n_mov


def k5_max_alphas(m: int) -> int:
    """The most line-search candidates one K5 launch takes."""
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


def nc_rows(m: int, pairs: bool, n_obs: int, n_mov: int) -> int:
    """The c >= 0 rows of one stage (staged.cuh::staged_rows)."""
    return (m * (m - 1) // 2 if pairs else 0) + 10 * m + m * (n_obs + n_mov)


def k4_rows(m: int, pairs: bool, n_obs: int, n_mov: int) -> int:
    """Rows of K4's input tile per scenario: X, U, xref, lam, mov, mu."""
    return 8 * m + nc_rows(m, pairs, n_obs, n_mov) + 2 * n_mov + 1


def k4_out_rows(m: int) -> int:
    """Rows of K4's output tile per scenario: the Hessian's position block
    [(2m)^2], A's and B's structure entries and the headings' diagonal [5m],
    lx [3m], lu and luu's diagonal [2m each]."""
    return 4 * m * m + 12 * m


def check_k4(m: int, g: K4Geometry) -> None:
    """Raise unless g is a geometry K4Geom takes."""
    if g.S < 8 or g.S & (g.S - 1) or not 1 <= g.W <= 32:
        raise ValueError(f"K4 at m={m}: S={g.S}, W={g.W}")


def k4_layout(m: int, rows: int, prm_size: int, g: K4Geometry | None = None) -> dict:
    """What one K4 block takes at `rows` input rows and a parameter block of
    prm_size floats."""
    g = K4_GEOMETRY[m] if g is None else g
    check_k4(m, g)
    smem = 4 * (al4(prm_size) + al4(rows * g.S) + al4(k4_out_rows(m) * g.S))
    threads = 32 * g.W
    blocks = min(SMEM_SM // (smem + SMEM_RESERVED), THREADS_SM // threads, BLOCKS_SM)
    return {"threads": threads, "smem_bytes": smem, "blocks_per_sm": blocks,
            "warps_per_sm": blocks * g.W}


def k6_rows(m: int) -> int:
    """Rows of K6's stage tile per scenario: Xs, U, kff, Kfb."""
    return 3 * m + 4 * m + 6 * m * m


def check_k6(m: int, g: K6Geometry) -> None:
    """Raise unless g is a geometry K6Geom takes."""
    if g.S < 8 or g.S & (g.S - 1) or g.D < 2 or not 1 <= g.T <= 2 * m or g.S * g.T > 1024:
        raise ValueError(f"K6 at m={m}: S={g.S}, D={g.D}, T={g.T}")


def k6_layout(m: int, g: K6Geometry | None = None) -> dict:
    """What one K6 block takes: threads, floats of a stage tile, shared
    bytes (the ring and, for T > 1, the team's slot for u)."""
    g = K6_GEOMETRY[m] if g is None else g
    check_k6(m, g)
    tile = al4(k6_rows(m) * g.S)
    smem = 4 * (g.D * tile + (al4(2 * m * g.S) if g.T > 1 else 0))
    threads = g.S * g.T
    blocks = min(SMEM_SM // (smem + SMEM_RESERVED), THREADS_SM // threads, BLOCKS_SM)
    return {"threads": threads, "tile": tile, "smem_bytes": smem, "blocks_per_sm": blocks,
            "warps_per_sm": blocks * ((threads + 31) // 32)}


def k3_shape_flags(shape: tuple, g: K3Geometry | None = None) -> list:
    """The -D flags of csrc/riccati_shape.cu: the stage shape (n, nu) and
    K3's geometry there (`k3_geometry` where not given)."""
    g = k3_geometry(shape) if g is None else g
    check_k3(shape, g)
    return [f"-DNMPC_K3_N={shape[0]}", f"-DNMPC_K3_NU={shape[1]}", f"-DNMPC_K3_S={g.S}",
            f"-DNMPC_K3_D={g.D}", f"-DNMPC_K3_T={g.T}", f"-DNMPC_K3_P={g.P}",
            f"-DNMPC_K3_SPILL={int(g.spill)}"]


def nvcc_flags(m: int, k3: K3Geometry | None = None, k5: K5Geometry | None = None,
               k4: K4Geometry | None = None, k6: K6Geometry | None = None) -> list:
    """The -D flags that set the staged kernels' geometry in csrc/staged.cu
    (the solver's picks where not given)."""
    k3 = k3_geometry(m) if k3 is None else k3
    k5 = K5_GEOMETRY[m] if k5 is None else k5
    k4 = K4_GEOMETRY[m] if k4 is None else k4
    k6 = K6_GEOMETRY[m] if k6 is None else k6
    check_k3(m, k3)
    check_k4(m, k4)
    check_k6(m, k6)
    return [f"-DNMPC_K3_S={k3.S}", f"-DNMPC_K3_D={k3.D}", f"-DNMPC_K3_T={k3.T}",
            f"-DNMPC_K3_P={k3.P}", f"-DNMPC_K3_SPILL={int(k3.spill)}",
            f"-DNMPC_K5_S={k5.S}", f"-DNMPC_K5_D={k5.D}", f"-DNMPC_K4_S={k4.S}",
            f"-DNMPC_K4_W={k4.W}", f"-DNMPC_K6_S={k6.S}", f"-DNMPC_K6_D={k6.D}",
            f"-DNMPC_K6_T={k6.T}"]
