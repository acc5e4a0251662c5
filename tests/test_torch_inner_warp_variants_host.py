"""The roofline tools' variants of K1's warp design (the template flags of
`inner_solve_warp` in csrc/inner_warp.cuh: the phase ablation K8 and K9's
dense expansion layout; tools/exp_mega_phases.py,
tools/exp_blocked_expansions.py), compiled as host C++ by
tests/inner_warp_host.cpp (tests/test_torch_inner_warp_host.py's harness and
helpers), against `phase_ablation_plain` at m = 2 and 6, B=16, 4 fixed
iterations, on the ablation's inputs (lam 0, mu 10, U 0) and the A/B's
(`ab_inputs`), at phase 3's tolerances with every iteration counted;
`full` with the early exit is K1 bit for bit, sweep_only leaves U as it
was, K9's dense layout gives the structured layout's bits, and the dense
slot is the structured one plus lxx and luu. Skipped where g++ is missing.
"""

import ctypes

import pytest
import torch

from nmpc_tpu_torch.ops import rollout
from nmpc_tpu_torch.parallel import batch_ocp
from nmpc_tpu_torch.scenarios import get
from nmpc_tpu_torch.solver import ALILQRConfig
from nmpc_tpu_torch.tools import exp_blocked_expansions as K9
from nmpc_tpu_torch.tools import exp_mega_phases as K8
from test_torch_inner_warp_host import B, HOST_ROBOTS, _p, host_k1, host_libs_at


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def host_libs():
    return host_libs_at(HOST_ROBOTS)


def host_variant(lib, ocp, x0, xref, lam, mu, U, cfg, mode, n_iter, early_exit=False,
                 dense=False):
    """A variant of K1's warp design on the host (tools.cu's warp parts),
    with the arguments of K8.phase_ablation."""
    nb, N, n, nu = x0.shape[0], ocp.N, ocp.nx, ocp.nu
    nan = lambda *s: torch.full(s, float("nan"))  # noqa: E731
    Xs, Uo, cost = nan(nb, N, n), nan(nb, N, nu), nan(nb)
    scratch = (nan(nb, N, nu), nan(nb, N, n, nu), nan(2, nb, N, n), nan(2, nb, N, nu))
    iters = torch.full((nb,), -1, dtype=torch.int32)
    prm = rollout.params(ocp, cfg.alphas, "cpu")
    args = [t.contiguous() for t in (x0, xref, lam, mu, U)]
    err = lib.host_phase_ablation(
        K8.MODES.index(mode), int(early_exit), int(dense), _p(prm), *map(_p, args), _p(Xs),
        _p(Uo), _p(cost), _p(iters), *map(_p, scratch), nb, N, n_iter,
        int(cfg.ls == "adaptive"), len(cfg.alphas), cfg.ls_rounds, int(ocp.n_pairs > 0), cfg.reg,
        cfg.armijo, cfg.tol_cost, cfg.ls_beta, cfg.ls_grow, cfg.ls_trial_min)
    assert err == 0
    return Xs, Uo, cost, iters


VARIANT_SCENARIOS = {2: "two_robot_swap", 6: "six_robot_antipodal"}


def _variant_inputs(m):
    """B=16 jittered starts of the m-robot scenario, and both input sets:
    the ablation's (lam 0, mu 10, U 0) and the A/B's (K9.ab_inputs)."""
    g = torch.Generator().manual_seed(11)
    base = get(VARIANT_SCENARIOS[m]).make(N=10, device="cpu")
    ob = batch_ocp(base, base.x0[None] + 0.1 * torch.randn((B, base.nx), generator=g))
    zero = (torch.zeros((B, ob.N, ob.n_con)), torch.full((B,), 10.0), torch.zeros((B, ob.N, ob.nu)))
    return ob, {"lam 0, mu 10, U 0": zero, "ab_inputs": K9.ab_inputs(ob)}


VARIANTS = [(mode, m, False) for m in VARIANT_SCENARIOS for mode in K8.MODES] + [("full", 6, True)]


@pytest.mark.parametrize("mode,m,dense", VARIANTS,
                         ids=[f"{mode}-m{m}" + ("-dense" if d else "") for mode, m, d in VARIANTS])
def test_host_variants_match_plain(host_libs, mode, m, dense):
    """Each K8 mode (and K9's dense layout) of the warp design against the
    plain ablation, 4 fixed iterations, at phase 3's tolerances."""
    lib = host_libs[m]
    ob, inputs = _variant_inputs(m)
    cfg = ALILQRConfig(ls="adaptive")
    for what, (lam, mu, U) in inputs.items():
        got = host_variant(lib, ob, ob.x0, ob.xref, lam, mu, U, cfg, mode, 4, dense=dense)
        want = K8.phase_ablation_plain(ob, ob.x0, ob.xref, lam, mu, U, cfg, mode, 4)
        torch.testing.assert_close(got[2], want[2], rtol=1e-4, atol=0.0, msg=what)
        torch.testing.assert_close(got[1], want[1], rtol=0.0, atol=5e-3, msg=what)
        torch.testing.assert_close(got[0], want[0], rtol=0.0, atol=5e-3, msg=what)
        assert (got[3] == 4).all(), what
        if mode == "sweep_only":   # no rollout: U as it was, no merit
            assert torch.equal(got[1], U) and (got[2] == 0).all(), what
        else:                      # the steps moved the controls
            assert (got[1] != U).any(), what
        if dense and what == "ab_inputs":   # the same sums as the structured layout
            structured = host_variant(lib, ob, ob.x0, ob.xref, lam, mu, U, cfg, mode, 4)
            assert all(torch.equal(a, b) for a, b in zip(got, structured)), what


@pytest.mark.parametrize("ls", ["adaptive", "cascade"])
def test_host_variant_full_with_early_exit_is_k1(host_libs, ls):
    """The tools' `full, early exit` part is K1's own code: bit for bit the
    solver's K1 (host_inner_solve), at m=2 over 8 iterations, where the stop
    rule takes scenarios out."""
    ob, inputs = _variant_inputs(2)
    lam, mu, U = inputs["ab_inputs"]
    lib = host_libs[2]
    cfg = ALILQRConfig(n_inner=8, ls=ls)
    got = host_variant(lib, ob, ob.x0, ob.xref, lam, mu, U, cfg, "full", 8, early_exit=True)
    want = host_k1(lib, ob, ob.x0, ob.xref, lam, mu, U, cfg)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    assert int(want[3].min()) < 7      # the early exit took some scenarios out


@pytest.mark.parametrize("m", HOST_ROBOTS)
def test_host_dense_slot_holds_lxx_and_luu(host_libs, m):
    """K9's dense slot: K1's pair-only slot plus lxx (n x n) and luu
    (nu x nu), 16-byte aligned; the variants refuse what no part takes."""
    lib = host_libs[m]
    n, nu = 3 * m, 2 * m
    structured, dense = lib.host_warp_slot_bytes(0), lib.host_warp_slot_bytes(1)
    assert structured == lib.host_k1_slot_bytes(0)
    assert dense % 16 == 0 and dense - structured - 4 * (n * n + nu * nu) in (0, 4, 8, 12)
    if m % 2 == 0:
        assert dense == structured + 4 * (n * n + nu * nu)
    if m == 6:
        assert (structured, dense) == (6608, 8480)
    z = ctypes.c_void_p(None)
    for mode, early, d in ((1, 1, 0), (0, 1, 1), (2, 0, 1), (6, 0, 0)):
        assert lib.host_phase_ablation(mode, early, d, *[z] * 14, 0, 1, 1, 1, 0, 1, 1,
                                       *[0.0] * 6) == -1
