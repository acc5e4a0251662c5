"""The CUDA kernels on the card against their plain PyTorch versions, and the
wrappers' refusals. Needs a CUDA device; skipped without one. Run on a GPU
machine with

    python -m pytest tests/test_torch_cuda.py -m gpu --noconftest -q

(--noconftest: the suite's conftest.py configures JAX, which these tests
neither need nor import.)

Tolerances: K2 rtol/atol 1e-6 (the kernel rounds each row as the plain
version does); K1 at n_inner=4 cost rtol 1e-4, U atol 5e-3 and equal
iteration counts on 99% of scenarios (past the first iterations f32
rounding can flip near-tied alpha picks).
"""

import dataclasses

import pytest
import torch

from nmpc_tpu_torch.ocp import problem as P
from nmpc_tpu_torch.ops import megasolve
from nmpc_tpu_torch.parallel import batch_ocp
from nmpc_tpu_torch.scenarios import get
from nmpc_tpu_torch.solver import ALILQRConfig, solve_batched

pytestmark = pytest.mark.gpu


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


def _case(name, B, dev, seed=0):
    g = torch.Generator(device=dev).manual_seed(seed)
    base = get(name).make(N=10, device=dev)
    ob = batch_ocp(base, base.x0[None] + 0.1 * torch.randn((B, base.nx), generator=g, device=dev))
    U = 0.05 * torch.randn((B, base.N, base.nu), generator=g, device=dev)
    lam = 0.5 * torch.randn((B, base.N, base.n_con), generator=g, device=dev).abs()
    lam = lam * (P.constraint_mask(base) > 0)
    mu = torch.tensor([10.0, 100.0, 1e3, 1e4], device=dev)[
        torch.randint(0, 4, (B,), generator=g, device=dev)]
    return ob, U, lam, mu


@pytest.mark.parametrize("name", ["six_robot_antipodal", "two_robot_swap",
                                  "two_robot_centralized", "ten_robot"])
def test_al_update_kernel_matches_plain(dev, name):
    ob, U, lam, mu = _case(name, 300, dev)  # 300: a ragged last block
    Xs = ob.x0[:, None] + 0.3 * torch.randn((300, ob.N, ob.nx), device=dev)
    got = megasolve.al_update_lanes(ob, Xs, U, lam, mu, 1e6)
    want = megasolve.al_update_plain(ob, Xs, U, lam, mu, 1e6)
    torch.testing.assert_close(got[0], want[0], rtol=1e-6, atol=1e-6)
    torch.testing.assert_close(got[1], want[1], rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("ls", ["adaptive", "cascade"])
@pytest.mark.parametrize("name", ["slsqp_pose", "two_robot_swap", "five_robot",
                                  "six_robot_antipodal", "eight_robot", "ten_robot"])
def test_inner_solve_kernel_matches_plain(dev, name, ls):
    # one robot: slsqp_pose (T=0.5). At single_robot's T=0.01 the controls
    # barely move the 10-stage cost, and U at equal cost differs by ~1.5e-2
    # between any two of this kernel, its plain version and the reference
    B = 300
    ob, U, lam, mu = _case(name, B, dev, seed=1)
    cfg = ALILQRConfig(n_inner=4, ls=ls)
    before = megasolve.launch_counts["inner_solve_fused"]
    got = megasolve.inner_solve_fused(ob, ob.x0, ob.xref, lam, mu, U, cfg)
    assert megasolve.launch_counts["inner_solve_fused"] == before + 1
    want = megasolve.inner_solve_plain(ob, ob.x0, ob.xref, lam, mu, U, cfg)
    torch.testing.assert_close(got[2], want[2], rtol=1e-4, atol=0.0)
    torch.testing.assert_close(got[1], want[1], rtol=0.0, atol=5e-3)
    torch.testing.assert_close(got[0], want[0], rtol=0.0, atol=5e-3)
    assert int((got[3] == want[3]).sum()) >= 0.99 * B


def test_solve_batched_on_the_card(dev):
    ob, _, _, _ = _case("six_robot_antipodal", 512, dev)
    cfg = ALILQRConfig(n_outer=6, n_inner=12, tol_con=1e-3, ls="adaptive")
    megasolve.reset_launch_counts()
    res = solve_batched(ob, cfg=cfg)
    steps = int(res.outer_iters.max())
    assert megasolve.launch_counts == {"inner_solve_fused": steps, "al_update_lanes": steps}
    assert torch.isfinite(res.cost).all() and res.X.shape == (512, 11, 18)
    assert float(res.converged.float().mean()) >= 0.9


def test_wrappers_refuse_what_the_kernels_do_not_cover(dev):
    ob, U, lam, mu = _case("six_robot_antipodal", 64, dev)
    cfg = ALILQRConfig(n_inner=2)
    with pytest.raises(NotImplementedError, match="compact"):
        megasolve.inner_solve_fused(ob, ob.x0, ob.xref, lam, mu, U,
                                    dataclasses.replace(cfg, compact=True))
    with pytest.raises(TypeError):
        megasolve.inner_solve_fused(ob, ob.x0.double(), ob.xref, lam, mu, U, cfg)
    with pytest.raises(ValueError):
        megasolve.inner_solve_fused(ob, ob.x0, ob.xref, lam[:, :5], mu, U, cfg)
    obs = get("obstacle_scenario_1").make(N=10, device=dev)
    obs_b = batch_ocp(obs, obs.x0[None].repeat(4, 1))
    z = torch.zeros
    with pytest.raises(NotImplementedError, match="n_obs"):
        megasolve.inner_solve_fused(
            obs_b, obs_b.x0, obs_b.xref, z((4, 10, obs.n_con), device=dev),
            torch.full((4,), 10.0, device=dev), z((4, 10, 2), device=dev), cfg)
    with pytest.raises(NotImplementedError, match="n_obs"):
        megasolve.al_update_lanes(obs_b, z((4, 10, 3), device=dev), z((4, 10, 2), device=dev),
                                  z((4, 10, obs.n_con), device=dev),
                                  torch.full((4,), 10.0, device=dev), 1e6)
