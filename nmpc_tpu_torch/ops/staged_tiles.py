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
      Past (K3_TILE_N, K3_TILE_NU) = (30, 20) the register-tile design
      (`rtile`): S consecutive scenarios a block of T threads (P = 1), a
      ring of D = 2 or 1 tiles of their stages' A | B beside their slots
      (K3RtSlot) in shared memory; where one scenario's do not fit, `spill`:
      S = 1, D = 0, 256 threads, the slot and A | B in the scratch and the
      products' staging buffers (RT_STAGE_FLOATS) in shared memory. Any
      stage shape, bounded by device memory.
  K5: A x S threads a block (A candidates), at most k5_threads(m); more
      candidates go as several launches (rollout.linesearch_costs_lanes).
  K4: one stage of the tile a block, W warps a block.
  K6: a team of T threads per scenario, S T threads a block.
K3 takes other stage shapes (n, nu) than the robot stacks' (3m, 2m) too:
the ray-augmented stage of family I and the user models of
make_generic_ocp, each built from csrc/riccati_shape.cu with
`k3_shape_flags`. K3's geometry at every shape, the robot stacks' included,
is `k3_rule`'s, which gives the picks `python -m
nmpc_tpu_torch.tools.staged_launch` recorded per robot count (K3_GEOMETRY,
PERF.md). K4's, K5's and K6's are `k4_geometry`, `k5_geometry` and
`k6_geometry`: the sweep's picks up to sixteen robots (K4_GEOMETRY, ...),
past them a rule of m, the largest tile that fits a block (`k4_rule`, ...).
ops/cuda_build.py passes them to nvcc, and the library reports them back
(`nmpc_k3_geometry`, ...) for cuda_build to check. The sizes here mirror
K3Rows, K3Slot, K3RtSlot, K3Geom, K5Geom, K4Rows, K4Geom, K6Rows and
K6Geom of the headers.

Beside its tile form every library holds K4's and K5's device-memory
forms (K4_DEVICE, K5_DEVICE), which keep nothing in shared memory: K4's
input and output tiles in a device-memory scratch of the wrapper's, K5's
stage rows (D = 0) and both kernels' parameter block read from device
memory. `k4_form` and `k5_form` pick one from the problem's own rows
(robot count, pair rows, static and moving obstacles, parameter floats,
candidates): the tile form wherever its block fits a block's shared memory,
else the device-memory form, so device memory is the only bound.
"""

from __future__ import annotations

import dataclasses
import functools

# the H100's shared memory: at most 227 KB a block, 228 KB an SM, 1 KB of
# which each resident block reserves; 2,048 threads and 32 blocks an SM
SMEM_BLOCK_MAX = 232448
SMEM_SM = 233472
SMEM_RESERVED = 1024
THREADS_SM = 2048
BLOCKS_SM = 32
# the most threads of a K5 block (K5Geom::kThreads): 512, and 256 past ten
# robots (k5_threads)
K5_THREADS = 512
# the team design's stage shapes (the robot stacks' up to m=10); past them
# K3's register-tile design, K3_RT_THREADS threads a block by default (the
# spilled form's products take exactly that many: 256, a 4 x 4 tile each of
# a 64 x 64 macro tile); the spilled form's shared memory, its staging
# buffers (csrc/staged_tiles.cuh::kRtStage: two of 16 rows of both operands'
# 64 columns)
K3_TILE_N, K3_TILE_NU = 30, 20
K3_RT_THREADS = 256
RT_STAGE_FLOATS = 2 * 16 * (64 + 64)
# the rows that the tiles the libraries past sixteen robots are built with
# (k4_rule, k5_rule) are sized for: pair rows, TILE_OBS static and TILE_MOV
# moving obstacles a robot, a parameter block of TILE_PRM floats (path
# (b)'s six obstacles, the registry's most moving ones, the alphas and
# obstacles many times over). Which form a launch takes is k4_form's and
# k5_form's, from the problem's own rows.
TILE_OBS, TILE_MOV, TILE_PRM = 6, 5, 1024


@dataclasses.dataclass(frozen=True)
class K3Geometry:
    S: int
    D: int
    T: int
    P: int
    spill: bool = False
    rtile: bool = False   # the register-tile design (shapes past (30, 20))


@dataclasses.dataclass(frozen=True)
class K5Geometry:
    S: int
    D: int    # 0: the device-memory form (K5_DEVICE)


@dataclasses.dataclass(frozen=True)
class K4Geometry:
    S: int
    W: int
    device: bool = False   # the device-memory form (K4_DEVICE)


@dataclasses.dataclass(frozen=True)
class K6Geometry:
    S: int
    D: int
    T: int


# K3's picks as the sweep recorded them per robot count (tools/staged_launch.py,
# PERF.md; at m = 7 and 9 the rule's, which the sweep kept; past ten robots
# the register-tile design, S scenarios a block of K3_RT_THREADS), and at the
# stage shape of one robot with 10 LiDAR rays (n = 13, nu = 2; the
# registry's family I), picked by its shared memory as m=4's (n = 12).
# Builds take `k3_geometry` (`k3_rule`); the tests hold the rule to these
# picks.
K3_GEOMETRY = {
    1: K3Geometry(128, 2, 1, 128), 2: K3Geometry(128, 2, 1, 128), 3: K3Geometry(16, 2, 16, 17),
    4: K3Geometry(8, 2, 16, 9), 5: K3Geometry(8, 2, 16, 9), 6: K3Geometry(8, 2, 32, 9),
    7: K3Geometry(8, 2, 32, 8), 8: K3Geometry(8, 2, 32, 8), 9: K3Geometry(8, 2, 32, 8, spill=True),
    10: K3Geometry(8, 2, 32, 8, spill=True), (13, 2): K3Geometry(8, 2, 16, 9),
    **{m: K3Geometry(2, 1, 256, 1, rtile=True) for m in (11, 12, 13)},
    **{m: K3Geometry(1, 1, 256, 1, rtile=True) for m in (14, 15, 16)},
}
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
K3_BLOCKS_PER_SM = {1: 5, 2: 1, 3: 3, 4: 3, 5: 2, 6: 1, 7: 1, 8: 1, 9: 1, 10: 1, 11: 4,
                    12: 3, 13: 3, 14: 5, 15: 4, 16: 4, (13, 2): 4, (2, 1): 12, (1, 1): 16}
# K5's, K4's and K6's picks per robot count (tools/staged_launch.py, PERF.md;
# past ten robots the smallest tiles, S = 8 (K5, K6) and 16 (K4), that fit
# the widest rows, and a K6 team of 16) up to sixteen robots; past them
# k5_rule, k4_rule and k6_rule
K5_GEOMETRY = {1: K5Geometry(32, 2), 2: K5Geometry(32, 2), 3: K5Geometry(32, 2),
               4: K5Geometry(16, 2), 5: K5Geometry(16, 2), 6: K5Geometry(32, 2),
               7: K5Geometry(16, 2), 8: K5Geometry(16, 2), 9: K5Geometry(16, 2),
               10: K5Geometry(8, 2), **{m: K5Geometry(8, 2) for m in range(11, 17)}}
K4_GEOMETRY = {1: K4Geometry(128, 4), 2: K4Geometry(64, 2), 3: K4Geometry(64, 4),
               4: K4Geometry(64, 8), 5: K4Geometry(64, 4), 6: K4Geometry(64, 4),
               7: K4Geometry(64, 4), 8: K4Geometry(32, 2), 9: K4Geometry(32, 4),
               10: K4Geometry(32, 4), **{m: K4Geometry(16, 4) for m in range(11, 17)}}
# the device-memory forms every library holds beside its tile form
# (csrc/expansions_rollout_tiles.cuh::K4Device, csrc/staged_tiles.cuh::
# K5Device): K4 on tiles of 16 scenarios, four warps, its input and output
# tiles in the wrapper's scratch; K5 on tiles of 8, its stage rows read
# from device memory (D = 0); both read the parameter block from device
# memory. K5's tile geometry past m = 63 (k5_rule) is this form.
K4_DEVICE = K4Geometry(16, 4, device=True)
K5_DEVICE = K5Geometry(8, 0)
K6_GEOMETRY = {1: K6Geometry(32, 4, 1), 2: K6Geometry(32, 4, 1), 3: K6Geometry(32, 2, 2),
               4: K6Geometry(32, 2, 2), 5: K6Geometry(32, 2, 2), 6: K6Geometry(32, 2, 1),
               7: K6Geometry(16, 2, 4), 8: K6Geometry(16, 2, 4), 9: K6Geometry(16, 2, 4),
               10: K6Geometry(8, 2, 4), **{m: K6Geometry(8, 2, 16) for m in range(11, 17)}}


@functools.lru_cache(maxsize=None)
def k3_rule(n: int, nu: int) -> K3Geometry:
    """K3's geometry at stage shape (n, nu) by the rule the sweep's picks
    follow: a thread a scenario with every block in registers up to m=2's
    (6, 4); else teams of 16 lanes up to n = 15 and 32 beyond, tiles of 16
    scenarios up to n = 9 and 8 beyond, the odd pitch S + 1 up to n = 18
    (bank conflicts of a team reading down a column) and S beyond (16-byte
    copies of the larger tiles), and the slots in device memory (spill)
    where the ring and the slots overflow a block's shared memory; past
    (K3_TILE_N, K3_TILE_NU) the register-tile design (`_k3_rtile_rule`)."""
    if n < 1 or nu < 1:
        raise NotImplementedError(f"K3 takes stage shapes with n >= 1 and nu >= 1, not n={n}, "
                                  f"nu={nu}")
    if n > K3_TILE_N or nu > K3_TILE_NU:
        return _k3_rtile_rule(n, nu)
    if n <= 6 and nu <= 4:
        return K3Geometry(128, 2, 1, 128)
    S = 16 if n <= 9 else 8
    g = K3Geometry(S, 2, 16 if n <= 15 else 32, S + 1 if n <= 18 else S)
    if not _fits((n, nu), g):
        g = dataclasses.replace(g, spill=True)
    return g


def _k3_rtile_rule(n: int, nu: int) -> K3Geometry:
    """The register-tile design at (n, nu): the most scenarios a block of
    K3_RT_THREADS (8, 4, 2; runs of consecutive scenarios) at a ring of one
    stage tile with which three blocks still reside on an SM (one block's
    barriers overlap the others' work); else one scenario a block where two
    reside; else one scenario in a block of twice the threads, the SM's one
    block, wherever it fits; else the slot spilled. The sweep
    (tools/staged_launch.py `k3`, PERF.md) picked these at m = 12-32: at 12
    two scenarios a block (three blocks an SM) before three (two) and one
    (seven), at 16 one (four) before two (two); a ring of two was slower
    wherever a ring of one kept as many blocks, and 512 threads faster where
    one block fills the SM."""
    shape = (n, nu)
    for S in (8, 4, 2, 1):
        g = K3Geometry(S, 1, K3_RT_THREADS, 1, rtile=True)
        lay = k3_layout(shape, g)
        if lay["smem_bytes"] <= SMEM_BLOCK_MAX and lay["blocks_per_sm"] >= (2 if S == 1 else 3):
            return g
    g = K3Geometry(1, 1, 2 * K3_RT_THREADS, 1, rtile=True)
    if _fits(shape, g):
        return g
    return K3Geometry(1, 0, K3_RT_THREADS, 1, spill=True, rtile=True)


def _fits(key, g: K3Geometry) -> bool:
    return k3_layout(key, g)["smem_bytes"] <= SMEM_BLOCK_MAX


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


def _rt_pitch(v: int) -> int:
    """v rounded up to 4 mod 32 (csrc/staged_tiles.cuh::rt_pitch): the
    stride between a block's scenarios, so that their float4 loads fall on
    other banks."""
    return v + (36 - v % 32) % 32


def k3_rt_slot(key) -> dict:
    """The register-tile design's slot of one scenario (K3RtSlot), in
    floats: V [n, al4(n + 1)] (Vxx transposed, Vx), W [n, al4(n + nu)] and
    its last row Wn (past the Qux copy [nu, al4(n)]), T [nu, al4(nu) +
    al4(n + 1)], the reciprocal diagonal; `tile`, a stage's A | B [n,
    al4(n + nu)]; `pitch` and `tile_pitch`, their strides in a block."""
    n, nu = k3_dims(key)
    ldv, ldw, ldq = al4(n + 1), al4(n + nu), al4(n)
    ldt = al4(nu) + al4(n + 1)
    wn = n * ldv + al4(max(n * ldw, nu * ldq))
    floats = wn + ldw + nu * ldt + al4(nu)
    tile = n * ldw
    return {"floats": floats, "tile": tile, "pitch": _rt_pitch(floats),
            "tile_pitch": _rt_pitch(tile)}


def check_k3(m, g: K3Geometry) -> None:
    """Raise unless g is a geometry K3Geom takes (m: a K3 key)."""
    if g.rtile:    # the register-tile design
        if (g.S < 1 or g.T % 32 or not 64 <= g.T <= 1024 or g.P != 1
                or not ((g.S, g.D, g.T) == (1, 0, 256) if g.spill else g.D in (1, 2))):
            raise ValueError(f"K3's register-tile design at m={m}: S={g.S}, D={g.D}, T={g.T}, "
                             f"P={g.P}, spill={g.spill}")
        return
    if g.S < 8 or g.S & (g.S - 1):
        raise ValueError(f"K3 at m={m}: S={g.S} is not a power of two >= 8")
    if not (g.T == 1 or (g.T <= 32 and 32 % g.T == 0)):
        raise ValueError(f"K3 at m={m}: a team of T={g.T} lanes does not sit in one warp")
    if g.P not in (g.S, g.S + 1) or g.D < 2:
        raise ValueError(f"K3 at m={m}: pitch {g.P} or ring depth {g.D}")


def k3_layout(m, g: K3Geometry | None = None) -> dict:
    """What one K3 block takes: threads, floats of its stage tile (a ring
    slot), output tile and slots, its shared bytes, its device-memory
    scratch (floats, with spill), and the blocks and warps that reside per
    SM by shared memory and threads (registers not counted). m: a K3 key."""
    g = k3_geometry(m) if g is None else g
    check_k3(m, g)
    n, nu = k3_dims(m)
    if g.rtile:
        sl = k3_rt_slot(m)
        tile, out = g.S * sl["tile_pitch"], 0
        priv = sl["floats"] + sl["tile"] if g.spill else g.S * sl["pitch"]
        smem = 4 * (RT_STAGE_FLOATS if g.spill else g.D * tile + priv)
        threads = g.T
    else:
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


def k5_threads(m: int) -> int:
    """The most threads of a K5 block at m robots (K5Geom::kThreads)."""
    return K5_THREADS if m <= 10 else K5_THREADS // 2


def k5_max_alphas(m: int, g: K5Geometry | None = None) -> int:
    """The most line-search candidates one K5 launch of geometry g (the
    library's tile, k5_geometry, where not given) takes."""
    return k5_threads(m) // (k5_geometry(m) if g is None else g).S


def _pow2(S: int) -> bool:
    return S >= 1 and S & (S - 1) == 0


def _rule(tiles, smem) -> object:
    """The first geometry of `tiles` whose block takes at most the card's
    shared bytes (smem(g)), else None."""
    return next((g for g in tiles if smem(g) <= SMEM_BLOCK_MAX), None)


@functools.lru_cache(maxsize=None)
def k5_rule(m: int) -> K5Geometry:
    """K5 past the sweep's robot counts: the largest tile of 8, 4, 2 or 1
    scenarios (a ring of two) whose block fits at the TILE_ rows, else (m >=
    64) the device-memory form, K5_DEVICE."""
    rows = k5_rows(m, True, TILE_OBS, TILE_MOV)
    return _rule([*(K5Geometry(S, 2) for S in (8, 4, 2, 1)), K5_DEVICE],
                 lambda g: k5_layout(m, rows, TILE_PRM, 1, g)["smem_bytes"])


def k5_geometry(m: int) -> K5Geometry:
    """K5's geometry at m robots: the sweep's pick (K5_GEOMETRY), else
    k5_rule's."""
    return K5_GEOMETRY[m] if m in K5_GEOMETRY else k5_rule(m)


def k5_layout(m: int, rows: int, prm_size: int, n_alphas: int,
              g: K5Geometry | None = None) -> dict:
    """What one K5 block takes at `rows` stage rows, a parameter block of
    prm_size floats and n_alphas candidates (the device-memory form, D = 0:
    no shared memory)."""
    g = k5_geometry(m) if g is None else g
    check_k5(m, g)
    smem = 4 * (al4(prm_size) + g.D * al4(rows * g.S)) if g.D else 0
    threads = n_alphas * g.S
    blocks = min(SMEM_SM // (smem + SMEM_RESERVED), THREADS_SM // threads, BLOCKS_SM)
    return {"threads": threads, "smem_bytes": smem, "blocks_per_sm": blocks,
            "warps_per_sm": blocks * ((threads + 31) // 32)}


def check_k5(m: int, g: K5Geometry) -> None:
    """Raise unless g is a geometry K5Geom takes: a ring of at least two
    stage tiles, or none (K5_DEVICE)."""
    if not _pow2(g.S) or not (g.D >= 2 or g == K5_DEVICE):
        raise ValueError(f"K5 at m={m}: S={g.S}, D={g.D}")


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
    """Raise unless g is a geometry K4Geom takes (its device-memory form:
    K4_DEVICE)."""
    if not _pow2(g.S) or not 1 <= g.W <= 32 or (g.device and g != K4_DEVICE):
        raise ValueError(f"K4 at m={m}: S={g.S}, W={g.W}, device={g.device}")


@functools.lru_cache(maxsize=None)
def k4_rule(m: int) -> K4Geometry | None:
    """K4's tile past the sweep's robot counts: the largest tile of 16, 8,
    4, 2 or 1 scenarios whose block fits at the TILE_ rows, four warps (the
    picks at m = 11-16); None where even one scenario's does not (m >=
    109: its Hessian's position block alone is 4 m^2 floats), whose library
    holds K4's device-memory form alone."""
    rows = k4_rows(m, True, TILE_OBS, TILE_MOV)
    return _rule([K4Geometry(S, 4) for S in (16, 8, 4, 2, 1)],
                 lambda g: k4_layout(m, rows, TILE_PRM, g)["smem_bytes"])


def k4_geometry(m: int) -> K4Geometry | None:
    """K4's tile geometry at m robots: the sweep's pick (K4_GEOMETRY), else
    k4_rule's (None: no tile form)."""
    return K4_GEOMETRY[m] if m in K4_GEOMETRY else k4_rule(m)


def k4_scratch_floats(m: int, rows: int, g: K4Geometry) -> int:
    """Floats of one block's slot of the device-memory form's scratch: its
    input tile of `rows` rows and its output tile."""
    return al4(rows * g.S) + al4(k4_out_rows(m) * g.S)


def k4_layout(m: int, rows: int, prm_size: int, g: K4Geometry | None = None) -> dict:
    """What one K4 block takes at `rows` input rows and a parameter block of
    prm_size floats: threads, shared bytes, and (the device-memory form) the
    floats of its slot of the scratch."""
    g = k4_geometry(m) if g is None else g
    check_k4(m, g)
    tiles = k4_scratch_floats(m, rows, g)
    smem = 0 if g.device else 4 * (al4(prm_size) + tiles)
    threads = 32 * g.W
    blocks = min(SMEM_SM // (smem + SMEM_RESERVED), THREADS_SM // threads, BLOCKS_SM)
    return {"threads": threads, "smem_bytes": smem, "blocks_per_sm": blocks,
            "warps_per_sm": blocks * g.W, "scratch_floats": tiles if g.device else 0}


def k4_form(m: int, pairs: bool, n_obs: int, n_mov: int, prm_size: int) -> K4Geometry:
    """The K4 form a problem launches, from its own rows (m robots, pair
    rows or not, n_obs static and n_mov moving obstacles, a parameter block
    of prm_size floats): the library's tile (k4_geometry) where its block
    fits the card's shared memory, else K4_DEVICE. The same on the CPU and
    the card."""
    g = k4_geometry(m)
    if g is not None and k4_layout(m, k4_rows(m, pairs, n_obs, n_mov), prm_size,
                                   g)["smem_bytes"] <= SMEM_BLOCK_MAX:
        return g
    return K4_DEVICE


def k4_device_slots(B: int, N: int, sms: int) -> int:
    """Blocks of K4's device-memory form, each with its slot of the
    scratch: the work items (tiles x stages), at most as many as `sms` SMs
    hold at once by threads; a block takes further work items in turn."""
    g = K4_DEVICE
    per_sm = min(THREADS_SM // (32 * g.W), BLOCKS_SM)
    return max(1, min(-(-B // g.S) * N, sms * per_sm))


def k5_form(m: int, pairs: bool, n_obs: int, n_mov: int, prm_size: int,
            n_alphas: int) -> K5Geometry:
    """The K5 form a problem launches, from its own rows (as k4_form;
    prm_size: the parameter block without the alphas) and its n_alphas
    candidates: the library's tile (k5_geometry) where its block, at the
    longest slice of candidates one launch takes, fits the card's shared
    memory, else K5_DEVICE (k5_geometry past m = 63)."""
    g = k5_geometry(m)
    if g.D:
        top = min(max(n_alphas, 1), k5_max_alphas(m, g))
        if k5_layout(m, k5_rows(m, pairs, n_obs, n_mov), prm_size + top, top,
                     g)["smem_bytes"] <= SMEM_BLOCK_MAX:
            return g
    return K5_DEVICE


def k6_rows(m: int) -> int:
    """Rows of K6's stage tile per scenario: Xs, U, kff, Kfb."""
    return 3 * m + 4 * m + 6 * m * m


def check_k6(m: int, g: K6Geometry) -> None:
    """Raise unless g is a geometry K6Geom takes."""
    if (not _pow2(g.S) or not (g.D >= 2 or (g.D == 0 and g.T > 1)) or not 1 <= g.T <= 2 * m
            or g.S * g.T > 1024):
        raise ValueError(f"K6 at m={m}: S={g.S}, D={g.D}, T={g.T}")


@functools.lru_cache(maxsize=None)
def k6_rule(m: int) -> K6Geometry:
    """K6 past the sweep's robot counts: the largest tile of 8, 4, 2 or 1
    scenarios (a ring of two) whose block fits, teams of 16 (the picks at
    m = 11-16), else (m >= 64) tiles of 8 that read their stage rows from
    device memory (D = 0)."""
    return _rule([*(K6Geometry(S, 2, 16) for S in (8, 4, 2, 1)), K6Geometry(8, 0, 16)],
                 lambda g: k6_layout(m, g)["smem_bytes"])


def k6_geometry(m: int) -> K6Geometry:
    """K6's geometry at m robots: the sweep's pick (K6_GEOMETRY), else
    k6_rule's."""
    return K6_GEOMETRY[m] if m in K6_GEOMETRY else k6_rule(m)


def k6_layout(m: int, g: K6Geometry | None = None) -> dict:
    """What one K6 block takes: threads, floats of a stage tile, shared
    bytes (the ring and, for T > 1, the team's slot for u)."""
    g = k6_geometry(m) if g is None else g
    check_k6(m, g)
    tile = al4(k6_rows(m) * g.S)
    smem = 4 * (g.D * tile + (al4(2 * m * g.S) if g.T > 1 else 0))
    threads = g.S * g.T
    blocks = min(SMEM_SM // (smem + SMEM_RESERVED), THREADS_SM // threads, BLOCKS_SM)
    return {"threads": threads, "tile": tile, "smem_bytes": smem, "blocks_per_sm": blocks,
            "warps_per_sm": blocks * ((threads + 31) // 32)}


def _k3_flags(g: K3Geometry) -> list:
    return [f"-DNMPC_K3_S={g.S}", f"-DNMPC_K3_D={g.D}", f"-DNMPC_K3_T={g.T}",
            f"-DNMPC_K3_P={g.P}", f"-DNMPC_K3_SPILL={int(g.spill)}",
            *(["-DNMPC_K3_RTILE=1"] if g.rtile else [])]


def k3_shape_flags(shape: tuple, g: K3Geometry | None = None) -> list:
    """The -D flags of csrc/riccati_shape.cu: the stage shape (n, nu) and
    K3's geometry there (`k3_geometry` where not given)."""
    g = k3_geometry(shape) if g is None else g
    check_k3(shape, g)
    return [f"-DNMPC_K3_N={shape[0]}", f"-DNMPC_K3_NU={shape[1]}", *_k3_flags(g)]


def nvcc_flags(m: int, k3: K3Geometry | None = None, k5: K5Geometry | None = None,
               k4: K4Geometry | None = None, k6: K6Geometry | None = None) -> list:
    """The -D flags that set the staged kernels' geometry in csrc/staged.cu
    (the solver's picks where not given)."""
    k3 = k3_geometry(m) if k3 is None else k3
    k5 = k5_geometry(m) if k5 is None else k5
    k4 = k4_geometry(m) if k4 is None else k4
    k6 = k6_geometry(m) if k6 is None else k6
    check_k3(m, k3)
    if k4 is not None:
        check_k4(m, k4)
        if k4.device:
            raise ValueError(f"K4 at m={m}: the device-memory form is built beside the tile")
    check_k5(m, k5)
    check_k6(m, k6)
    s4, w4 = (k4.S, k4.W) if k4 is not None else (0, 0)   # 0: no tile form
    return [*_k3_flags(k3), f"-DNMPC_K5_S={k5.S}", f"-DNMPC_K5_D={k5.D}",
            f"-DNMPC_K4_S={s4}", f"-DNMPC_K4_W={w4}", f"-DNMPC_K6_S={k6.S}",
            f"-DNMPC_K6_D={k6.D}", f"-DNMPC_K6_T={k6.T}"]
