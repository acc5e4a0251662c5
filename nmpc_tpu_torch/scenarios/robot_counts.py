"""Joint problems at robot counts the scenario registry lacks, as make_ocp
keyword arguments of plain Python numbers (so that the reference's make_ocp
takes the same ones):

  crossing(m)  the registry's ten_robot (N=20, T=0.1, dmin 0.3, a two-row
               crossing) widened to m robots (m even) by columns 1.0 m apart
               from x = -1.5: robot j < m/2 starts at (x_j, -1, 1.57), robot
               m/2 + j at (x_j, +1, -1.57), each bound for the other row's
               position in its column with its own heading. Where the row
               would leave make_ocp's arena (|x| <= ARENA = 10 m: past m =
               24) it is centred on x = 0 instead, so that no robot starts
               outside the state box; where even the centred row leaves it
               (m >= 44) the position bound is widened to the row's
               half-extent plus 1 m (every m <= 42 keeps make_ocp's).
  circle(m)    an antipodal swap of m robots on a circle of radius 1.5 (N=10,
               T=0.2, dmin 0.3): robot i at angle 2 pi i / m, heading for the
               centre, bound for its antipode.
  pillars(m, n_obs)
               the crossing among n_obs static discs of radius 0.1 m (a
               cluttered floor of pillars), see `pillars`.
  fleet_subproblem(n_mov)
               one robot's subproblem in a decentralized fleet of n_mov + 1
               on a circle, the others' plans as moving obstacles, see
               `fleet_subproblem`.

SLICE names the problem of each robot count past the registry's that the
card drives: the megakernel and staged routes at m = 7, 9, 12 and 16
(chip_smoke.py phase 38), the staged and hybrid routes past the megakernel's
sixteen robots at m = 20, 24 and 32 (phase 40) and 112 (phase 41), each of
those the crossing (ten_robot's, N = 20, T = 0.1, dmin 0.3, widened by
columns). Phase 41 also drives `pillars` at m = 16 and 20 and
`fleet_subproblem` at 150 moving obstacles. The launch
sweeps (tools/k1_launch.py, tools/staged_launch.py) take `make(m)` at any
other m too.
"""

from __future__ import annotations

import math

from nmpc_tpu_torch.device import DEVICE
from nmpc_tpu_torch.ocp.problem import OCP, make_ocp


# make_ocp's default position bound (pos_bound), the arena's half-width
ARENA = 10.0


def crossing(m: int, N: int = 20) -> dict:
    """make_ocp keyword arguments of ten_robot widened to m robots."""
    if m % 2 or m < 2:
        raise ValueError(f"the crossing takes an even robot count, not m={m}")
    cols = [-1.5 + j for j in range(m // 2)]
    if cols[-1] > ARENA:
        cols = [j - (m // 2 - 1) / 2 for j in range(m // 2)]
    x0 = [v for x in cols for v in (x, -1.0, 1.57)] + [v for x in cols for v in (x, 1.0, -1.57)]
    goal = [v for x in cols for v in (x, 1.0, 1.57)] + [v for x in cols for v in (x, -1.0, -1.57)]
    kw = dict(m=m, N=N, T=0.1, x0=x0, x_goal=goal, dmin=0.3, collision=True)
    if cols[-1] > ARENA:
        kw["pos_bound"] = cols[-1] + 1.0
    return kw


# pillars' lattice: its spacing, and the clearance every pillar keeps from
# each robot's straight start-to-goal segment
PILLAR_PITCH, PILLAR_CLEAR, PILLAR_RADIUS = 0.5, 0.5, 0.1


def _segment_dist(px, py, ax, ay, bx, by) -> float:
    """Distance of the point (px, py) from the segment (a, b)."""
    dx, dy = bx - ax, by - ay
    t = max(0.0, min(1.0, ((px - ax) * dx + (py - ay) * dy) / (dx * dx + dy * dy)))
    return math.hypot(px - ax - t * dx, py - ay - t * dy)


def pillars(m: int, n_obs: int, N: int = 20) -> dict:
    """make_ocp keyword arguments of the crossing of m robots among n_obs
    static discs of radius PILLAR_RADIUS (make_ocp's `obstacles`).

    The pillars stand on a square lattice of pitch PILLAR_PITCH over the
    arena (|x|, |y| <= ARENA - PILLAR_PITCH), centred on the crossing's
    centre so that the robots' columns fall midway between lattice columns.
    Every lattice point closer than PILLAR_CLEAR to a robot's straight
    start-to-goal segment is dropped, so that every start is feasible (the
    keep-out, pillar radius + robot radius + margin, is 0.25 m) and the
    crossing stays open; of the rest the n_obs nearest the crossing's
    centre are kept (ties in lattice order), so the robots cross among
    them. Raises ValueError where the lattice holds fewer."""
    kw = crossing(m, N=N)
    x0, goal = kw["x0"], kw["x_goal"]
    segs = [(x0[3 * i], x0[3 * i + 1], goal[3 * i], goal[3 * i + 1]) for i in range(m)]
    cx = sum(s[0] for s in segs) / m
    top = ARENA - PILLAR_PITCH
    k = int(top // PILLAR_PITCH)
    pts = []
    for i in range(-k - 1, k + 2):
        px = cx + PILLAR_PITCH * (i + 0.5)
        for j in range(-k, k + 1):
            py = PILLAR_PITCH * j
            if abs(px) > top or abs(py) > top:
                continue
            if min(_segment_dist(px, py, *s) for s in segs) >= PILLAR_CLEAR:
                pts.append(((px - cx) ** 2 + py * py, len(pts), px, py))
    if len(pts) < n_obs:
        raise ValueError(f"the lattice holds {len(pts)} pillars, fewer than n_obs={n_obs}")
    pts.sort()
    kw["obstacles"] = [[px, py, PILLAR_RADIUS] for _, _, px, py in pts[:n_obs]]
    return kw


def circle(m: int, N: int = 10, radius: float = 1.5) -> dict:
    """make_ocp keyword arguments of the antipodal swap of m robots."""
    x0, goal = [], []
    for i in range(m):
        a = 2 * math.pi * i / m
        c, s = radius * math.cos(a), radius * math.sin(a)
        x0 += [c, s, a + math.pi]
        goal += [-c, -s, a + math.pi]
    return dict(m=m, N=N, T=0.2, x0=x0, x_goal=goal, dmin=0.3, collision=True)


# the problem of each robot count past the registry's that the card drives
SLICE = {7: circle, 9: circle, 12: crossing, 16: crossing, 20: crossing, 24: crossing,
         32: crossing, 112: crossing}


def builder(m: int):
    """SLICE[m]'s builder; the circle at any other m."""
    return SLICE.get(m, circle)


def name(m: int) -> str:
    return f"{builder(m).__name__}{m}"


def make(m: int, device=DEVICE, **kw) -> OCP:
    """The OCP of builder(m) (keyword arguments of the builder, e.g. N, in kw)."""
    return make_ocp(**builder(m)(m, **kw), device=device)


# fleet_subproblem's circle: the arc between neighbours, their speed, the
# distance between a robot's waypoints
FLEET_SPACING, FLEET_SPEED, FLEET_STEP = 0.65, 0.2, 1.0


def fleet_subproblem(n_mov: int, N: int = 30) -> dict:
    """make_ocp keyword arguments of one robot's subproblem in a
    decentralized fleet of n_mov + 1 robots (the shape of the reference's
    parallel/decentralized.py robot template: one unicycle, N stages,
    T=0.1, dmin 0.3, the others' plans as moving obstacles).

    The fleet stands on a circle of radius R with FLEET_SPACING metres of
    arc between neighbours, each bound for its antipode through waypoints
    FLEET_STEP apart. The robot starts at angle 0, heading for the centre,
    its reference the next waypoint, (R - FLEET_STEP, 0); the other robots'
    plans ([N, n_mov, 2]) run straight at FLEET_SPEED toward the centre
    from their places, robot j at angle 2 pi j / (n_mov + 1). Where the
    circle leaves make_ocp's arena the position bound is widened to its
    radius plus 1 m."""
    R = (n_mov + 1) * FLEET_SPACING / (2 * math.pi)
    plans = []
    for k in range(1, N + 1):
        r = R - FLEET_SPEED * 0.1 * k
        plans.append([[r * math.cos(2 * math.pi * j / (n_mov + 1)),
                       r * math.sin(2 * math.pi * j / (n_mov + 1))] for j in range(1, n_mov + 1)])
    kw = dict(m=1, N=N, T=0.1, x0=[R, 0.0, math.pi], x_goal=[R - FLEET_STEP, 0.0, math.pi],
              dmin=0.3, mov_obs=plans)
    if R + 1.0 > ARENA:
        kw["pos_bound"] = R + 1.0
    return kw

