"""The rule that holds the staged CUDA kernels (K3-K6) against their plain
versions (nmpc_tpu_torch/ops/kernel_check.py), checked on the CPU: on
made-up outputs, that a unit's tolerance follows its own magnitude and f32
spread, and that only diverged units are left out; and the whole K4 -> K3 ->
K5 -> K6 chain at small shapes, where each wrapper runs its plain version so
the kernel and the plain version agree exactly."""

import dataclasses

import pytest
import torch

from nmpc_tpu_torch.ocp import problem as P
from nmpc_tpu_torch.ops.cuda_build import lane
from nmpc_tpu_torch.ops.kernel_check import (Verdict, diverged_rollouts, f32_spread, hold,
                                             staged_vs_plain)
from nmpc_tpu_torch.scenarios import get


def test_tolerance_follows_each_scenarios_own_magnitude():
    plain = torch.tensor([[1e6, 1.0], [2e6, 0.5]])   # [rows, B]: scenario 0 is large
    got = plain.clone()
    got[0, 0] += 1.0                                 # within 1e-5 * 2e6
    v = Verdict()
    hold(v, "x", got, plain, 1e-5)
    assert v.err == 1.0 and v.units == 2 and v.rel == pytest.approx(1e-6)
    got[0, 1] += 1e-3                                # scenario 1 is O(1): off by 100 tol
    with pytest.raises(AssertionError, match="1 units off"):
        hold(Verdict(), "x", got, plain, 1e-5)


def test_diverged_units_are_left_out_and_spread_widens_only_its_unit():
    plain = torch.ones((4, 3))
    got = plain.clone()
    got[:, 1:] += 5.0                                # far off in scenarios 1 and 2
    got[0, 0] += 2.0 ** -20
    spread = torch.tensor([0.0, 6.0, 0.0], dtype=torch.float64)   # f32 resolves scenario 1 to 6
    diverged = torch.tensor([False, False, True])
    v = Verdict()
    hold(v, "x", got, plain, 1e-5, spread=spread, diverged=diverged)
    assert (v.n_diverged, v.n_widened) == (1, 1)
    assert v.err == 5.0                              # scenarios 0 and 1
    with pytest.raises(AssertionError, match="1 units off"):
        hold(Verdict(), "x", got, plain, 1e-5, diverged=diverged)
    with pytest.raises(AssertionError, match="1 units off"):
        hold(Verdict(), "x", got, plain, 1e-5, spread=spread)


@pytest.mark.parametrize("where", [0, 1])
def test_kernel_must_stay_finite(where):
    """NaN on a held unit fails the tolerance; on a diverged one, it fails
    the finiteness check."""
    plain = torch.ones((2, 2))
    got = plain.clone()
    got[0, where] = float("nan")
    with pytest.raises(AssertionError, match="units off" if where == 0 else "not finite"):
        hold(Verdict(), "x", got, plain, 1e-5, diverged=torch.tensor([False, True]))


def test_spread_follows_the_conditioning():
    x = torch.ones((3, 5))
    calm = f32_spread(lambda e: (2.0 * e[0],), [x])[0]
    steep = f32_spread(lambda e: (1e6 * (e[0] - e[1]),), [x, x])[0]
    assert calm.shape == (5,) and bool((calm > 0).all()) and float(calm.max()) < 2e-5
    assert float(steep.min()) > 0.1


def test_merits_are_held_one_by_one_at_atol_plus_rtol():
    plain = torch.tensor([[10.0, 1e5], [20.0, 3.0]])  # [A, B]
    got = plain + torch.tensor([[3.9e-3, 15.0], [0.0, 0.0]])   # tol 4e-3 and 20.002
    v = Verdict()
    hold(v, "K5", got, plain, 2e-3, 2e-4, per_element=True)
    assert v.units == 4
    got[1, 1] += 3e-3
    with pytest.raises(AssertionError):
        hold(Verdict(), "K5", got, plain, 2e-3, 2e-4, per_element=True)


def _iterate(name, B, N, seed=0):
    """A mid-solve iterate in lane layout: controls U, their rollout X,
    duals |N(0, 0.5)| (zero on the masked rows), mu in {10, 100}."""
    g = torch.Generator().manual_seed(seed)
    if name == "moving":
        ocp = P.make_ocp(m=1, N=N, T=0.1, x0=[0.0, 0.0, 0.0], x_goal=[0.6, 0.0, 0.0], dmin=0.3,
                         mov_obs=torch.zeros((N, 2, 2)), device="cpu")
    else:
        ocp = get(name).make(N=N, device="cpu")
    x0 = ocp.x0[None] + 0.05 * torch.randn((B, ocp.nx), generator=g)
    ob = dataclasses.replace(ocp, x0=x0, xref=ocp.xref[None].expand(B, N, ocp.nx).contiguous())
    if ocp.n_mov:
        ob = dataclasses.replace(ob, mov_obs=0.3 + 0.1 * torch.randn((B, N, ocp.n_mov, 2), generator=g))
    U = 0.1 * torch.randn((B, N, ocp.nu), generator=g)
    X = P.rollout(ob, U)
    lam = 0.5 * torch.randn((B, N, ocp.n_con), generator=g).abs() * (P.constraint_mask(ocp) > 0)
    mu = torch.tensor([10.0, 100.0])[torch.randint(0, 2, (B,), generator=g)]
    mov_l = lane(ob.mov_obs.reshape(B, N, 2 * ocp.n_mov)) if ocp.n_mov else None
    return ob, lane(X[:, :-1]), lane(U), lane(ob.xref), lane(lam), mu, mov_l


@pytest.mark.parametrize("name", ["two_robot_swap", "obstacle_scenario_3", "moving"])
def test_chain_runs_on_the_cpu(name):
    B, alphas = 8, (0.0, 1.0, 0.5, 0.1)
    ob, X_l, U_l, xref_l, lam_l, mu, mov_l = _iterate(name, B, N=6)
    alpha = torch.tensor(alphas[1:]).repeat(3)[:B]
    verdicts, calls = staged_vs_plain(ob, X_l, U_l, xref_l, lam_l, mu, mov_l, alphas, alpha, 1e-6)
    assert set(calls) == {"K4", "K3", "K5", "K6"}
    for k, v in verdicts.items():
        assert v.err == 0.0 and v.n_diverged == 0 and v.n_widened == 0, k
        assert v.units == (len(alphas) * B if k == "K5" else B), k


def test_a_blown_up_rollout_is_flagged_as_diverged():
    ob, X_l, U_l, _, _, _, _ = _iterate("two_robot_swap", 4, N=6)
    kff = torch.zeros_like(U_l)
    kff[..., 0] = 1e3                     # scenario 0: controls of 1e3 at alpha 1
    Kfb = torch.zeros((*U_l.shape[:2], X_l.shape[1], 4))
    d = diverged_rollouts(ob, X_l[0], X_l, U_l, kff, Kfb, (0.0, 1.0, torch.full((4,), 1e-3)))
    assert d.tolist() == [[False] * 4, [True, False, False, False], [False] * 4]
