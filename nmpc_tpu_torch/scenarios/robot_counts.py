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
               outside the state box.
  circle(m)    an antipodal swap of m robots on a circle of radius 1.5 (N=10,
               T=0.2, dmin 0.3): robot i at angle 2 pi i / m, heading for the
               centre, bound for its antipode.

SLICE names the problem of each robot count past the registry's that the
card drives: the megakernel and staged routes at m = 7, 9, 12 and 16
(chip_smoke.py phase 38), the staged and hybrid routes past the megakernel's
sixteen robots at m = 20, 24 and 32 (phase 40), each of those the crossing
(ten_robot's, N = 20, T = 0.1, dmin 0.3, widened by columns). The launch
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
    return dict(m=m, N=N, T=0.1, x0=x0, x_goal=goal, dmin=0.3, collision=True)


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
         32: crossing}


def builder(m: int):
    """SLICE[m]'s builder; the circle at any other m."""
    return SLICE.get(m, circle)


def name(m: int) -> str:
    return f"{builder(m).__name__}{m}"


def make(m: int, device=DEVICE, **kw) -> OCP:
    """The OCP of builder(m) (keyword arguments of the builder, e.g. N, in kw)."""
    return make_ocp(**builder(m)(m, **kw), device=device)
