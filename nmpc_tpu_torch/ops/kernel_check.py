"""The staged kernels (K3-K6) held against their plain PyTorch versions on
the same inputs: the one rule that chip_smoke.py (phase 10) and
tests/test_torch_cuda.py apply on the card.

Outputs are lane-major, the scenario last ([..., B]). A unit is one
scenario, or for K5 one merit ([A, B]: one alpha of one scenario). Element
e of a unit has the tolerance

    tol_e = atol * max(1, max over the unit of |plain|) + rtol * |plain_e| + spread

(K5: atol + rtol |plain_e|, as its CPU test). The atol of the CPU tests
(tests/test_torch_staged_ops.py, whose values are O(1)) thus becomes
relative where a unit's values are large, and no unit's magnitude loosens
another's. Every unit is held (each element within tol_e of the plain
version) except a diverged one.

spread (K3 and K6; 0 for K4 and K5) is what f32 can resolve in the unit:
the largest change of the plain version's result, run in f64, when every
input is perturbed by 16 units of f32 roundoff (4 draws; `f32_spread`). It
is decided without the kernel. K3's recursion amplifies rounding by Quu's
conditioning, K6's rollout by its feedback gains (u = U + alpha kff +
K (x - X)): both grow with mu. On the H100 at obstacle_scenario_3 N=100,
B=32768, with the solve's own mu = 1e4, K3's plain version's error against
f64 reached 0.54 of the spread where the spread is 1-3 CPU tolerances, and
the kernel's 0.78. `Verdict.widened` counts the units that pass by the
spread alone; chip_smoke.py allows them only at the solve's own
multipliers.

Diverged (K5, K6): the closed-loop rollout of the unit's scenario and alpha,
run in f64 on the same inputs, takes a robot's position or a control beyond
DIVERGED = 10 (m, m/s, rad/s; the arenas span a few metres and the control
boxes are below 1), a position beyond the problem's own position box where
that is wider (a fleet whose row spans more than 20 m); see
`diverged_rollouts`. Past that, f32 rollouts part
from f64 (on the H100, at obstacle_scenario_3 N=100, B=32768, the plain
version missed f64 on 9 to 83 of 294,912 merits, all of them beyond the
bound, and on none within it). Diverged units are not compared with the
plain version: the kernel must be finite wherever the plain version is, and
its merit must stay above its alpha-0 merit wherever the f64 one does, so
the line search rejects the step as it rejects the f64 one (K5). Callers
bound how many units may diverge.
"""

from __future__ import annotations

import dataclasses

import torch

from nmpc_tpu_torch.ops import rollout as R
from nmpc_tpu_torch.ops.expansions import expansions_fused, expansions_plain
from nmpc_tpu_torch.ops.riccati import riccati_lanes, riccati_plain

DIVERGED = 10.0
K4_ATOL = (1e-5, 1e-5, 1e-4, 1e-4, 1e-3, 1e-4, 1e-6)   # A, B, lx, lu, lxx, luu, lux
K3_ATOL = (5e-5, 5e-5, 5e-4)                           # kff, Kfb, dV1
K5_ATOL, K5_RTOL = 2e-3, 2e-4
K6_ATOL = 1e-5


@dataclasses.dataclass
class Verdict:
    """One kernel's outputs against its plain version."""

    units: int = 0        # units per output
    err: float = 0.0      # largest |kernel - plain| on the held units
    rel: float = 0.0      # largest |kernel - plain| / max(1, |plain|) there
    diverged: torch.Tensor | None = None     # unit masks, OR-ed over outputs
    widened: torch.Tensor | None = None      # units within tolerance by the spread alone

    @property
    def n_diverged(self) -> int:
        return 0 if self.diverged is None else int(self.diverged.sum())

    @property
    def n_widened(self) -> int:
        return 0 if self.widened is None else int(self.widened.sum())


def hold(v: Verdict, name: str, got, plain, atol: float, rtol: float = 0.0, spread=None,
         diverged=None, per_element: bool = False) -> None:
    """Hold one output (module docstring) and fold it into v. spread,
    diverged: per unit (None: 0, none)."""
    dims = () if per_element else tuple(range(got.dim() - 1))

    def per_unit(t, op):
        return getattr(t, op)(dim=dims) if dims else t

    err = (got - plain).abs()
    base = atol * (1.0 if per_element else torch.clamp(per_unit(plain.abs(), "amax"), min=1.0))
    unit_shape = err.shape[-1:] if dims else err.shape
    sp = torch.zeros(unit_shape, dtype=torch.float64, device=err.device) if spread is None else spread
    tol = base + rtol * plain.abs() + sp
    div = torch.zeros(unit_shape, dtype=torch.bool, device=err.device)
    if diverged is not None:
        div = div | diverged
    held = ~div
    bad = per_unit(~(err <= tol), "any") & held
    assert not bool(bad.any()), (
        f"{name}: {int(bad.sum())} units off the plain version, worst |err| "
        f"{float(torch.where(bad, per_unit(err, 'amax'), 0.0).max()):.3e}")
    lost = per_unit(torch.isfinite(plain) & ~torch.isfinite(got), "any")
    assert not bool(lost.any()), f"{name}: not finite where the plain version is ({int(lost.sum())} units)"
    worst = torch.where(held, per_unit(err, "amax"), 0.0)
    worst_rel = torch.where(held, per_unit(err / torch.clamp(plain.abs(), min=1.0), "amax"), 0.0)
    widened = per_unit(~(err <= base + rtol * plain.abs()), "any") & held
    v.units = held.numel()
    v.err = max(v.err, float(worst.max()) if worst.numel() else 0.0)
    v.rel = max(v.rel, float(worst_rel.max()) if worst_rel.numel() else 0.0)
    v.diverged = div if v.diverged is None else v.diverged | div
    v.widened = widened if v.widened is None else v.widened | widened


def k3_inputs(n: int, nu: int, B: int, N: int, gen: torch.Generator) -> tuple:
    """Stage blocks of shape (n, nu) for K3, lane-major on gen's device: A
    near identity and B dense with the off-diagonal scales divided by
    sqrt(n), lxx and luu the identity plus a random PSD part, so that the
    value function stays positive definite over the horizon at any shape
    (tests/test_torch_staged_tiles.py's kind)."""
    kw = dict(generator=gen, device=gen.device)
    r = n ** -0.5
    A = 0.2 * r * torch.randn((N, n, n, B), **kw) + torch.eye(n, device=gen.device)[..., None]
    Bm = 0.3 * r * torch.randn((N, n, nu, B), **kw)

    def psd(k):
        M = torch.randn((N, k, k, B), **kw)
        return (torch.einsum("zijb,zljb->zilb", M, M) * (0.3 / k)
                + torch.eye(k, device=gen.device)[..., None])

    lxx, luu = psd(n), psd(nu)
    return tuple(t.contiguous() for t in (
        A, Bm, torch.randn((N, n, B), **kw), torch.randn((N, nu, B), **kw), lxx, luu,
        0.2 * r * torch.randn((N, nu, n, B), **kw)))


# the most units f32_spread stacks into one call of a plain version
SPREAD_UNITS = 2048


def f32_spread(fn, inputs, draws: int = 4, seed: int = 0) -> list:
    """Per output of fn (a plain version), per unit (scenario): the largest
    change of fn's f64 result over `draws` runs with every input element
    scaled by (1 + 2^-20 z), z ~ N(0, 1): 16 units of f32 roundoff. Every
    input and output of fn has the units on its last dimension, and fn
    treats them apart, so the unmoved run and the draws go as few calls as
    SPREAD_UNITS allows on the inputs stacked along it: a plain version that
    is bound by its launches (K3's column recursions) pays them once at a
    small batch, and a large batch takes no more memory than one run."""
    x64 = [t.double() for t in inputs]
    g = torch.Generator(device=x64[0].device).manual_seed(seed)
    runs = [x64] + [[t * (1.0 + 2.0 ** -20 * torch.randn(t.shape, generator=g, device=t.device,
                                                          dtype=torch.float64)) for t in x64]
                    for _ in range(draws)]
    B = x64[0].shape[-1]
    per = max(1, SPREAD_UNITS // max(B, 1))
    results = []
    for i in range(0, len(runs), per):
        outs = fn([torch.cat(ts, dim=-1) for ts in zip(*runs[i:i + per])])
        results += list(zip(*(r.split(B, dim=-1) for r in outs)))
    ref, moved = results[0], results[1:]
    out = []
    for k, r in enumerate(ref):
        s = torch.zeros(B, dtype=torch.float64, device=r.device)
        for q in moved:
            d = (q[k] - r).abs()
            s = torch.maximum(s, d.amax(dim=tuple(range(d.dim() - 1))) if d.dim() > 1 else d)
        out.append(s)
    return out


def diverged_rollouts(ocp, x0_l, X_l, U_l, kff_l, Kfb_l, alphas) -> torch.Tensor:
    """[len(alphas), B]: whether the closed-loop rollout of each alpha (a
    float, or one per scenario [B]) from these inputs, the rollout of K5 and
    K6, run in f64, takes a position (x, y of any robot) beyond DIVERGED or
    the problem's position box, whichever is wider, or a control beyond
    DIVERGED at some stage."""
    args = [t.double() for t in (x0_l, X_l, U_l, kff_l, Kfb_l)]
    B = x0_l.shape[-1]
    box = torch.cat([ocp.x_lo[0:3 * ocp.m:3], ocp.x_lo[1:3 * ocp.m:3],
                     ocp.x_hi[0:3 * ocp.m:3], ocp.x_hi[1:3 * ocp.m:3]]).abs().max()
    far = max(DIVERGED, float(box))
    out = []
    for a in alphas:
        a = torch.as_tensor(a, dtype=torch.float64, device=x0_l.device).expand(B)
        Xt, Ut = R.rollout_alpha_plain(ocp, *args, a)
        pos = torch.cat([Xt[:, 0::3], Xt[:, 1::3]], dim=1)
        inside = (pos.abs().amax(dim=(0, 1)) <= far) & (Ut.abs().amax(dim=(0, 1)) <= DIVERGED)
        out.append(~inside)
    return torch.stack(out)


def _plain(key, fn, plain_ms):
    """fn(), timed into plain_ms[key] by CUDA events where plain_ms is a
    dict (the plain versions' times at the held inputs, for the callers'
    tables, without running them again)."""
    if plain_ms is None:
        return fn()
    t0, t1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    t0.record()
    out = fn()
    t1.record()
    t1.synchronize()
    plain_ms[key] = t0.elapsed_time(t1)
    return out


def staged_vs_plain(ocp_b, X_l, U_l, xref_l, lam_l, mu, mov_l, alphas, alpha, reg,
                    gains=None, plain_ms=None):
    """K4 at the state (X_l [N, n, B] stage states, U_l, xref_l, lam_l, mu,
    mov_l), K3 on K4's output, K5 (the merits of `alphas`) and K6 (the
    rollout of alpha [B]) on K3's gains, or on gains = (kff_l, Kfb_l) when
    given, each against its plain version by the module's rule; with a dict
    plain_ms (CUDA inputs), each plain version's ms of that one call. Returns
    ({'K4': Verdict, ...}, {'K4': (kernel call, plain call), ...} for
    timing)."""
    v = {k: Verdict() for k in ("K4", "K3", "K5", "K6")}
    f64 = lambda *ts: [None if t is None else t.double() for t in ts]  # noqa: E731
    calls = {"K4": (lambda: expansions_fused(ocp_b, X_l, U_l, xref_l, lam_l, mu, mov_l),
                    lambda: expansions_plain(ocp_b, X_l, U_l, xref_l, lam_l, mu, mov_l))}
    exp = calls["K4"][0]()
    for i, (g, w, a) in enumerate(zip(exp, _plain("K4", calls["K4"][1], plain_ms), K4_ATOL)):
        hold(v["K4"], f"K4 output {i}", g, w, a)
    calls["K3"] = (lambda: riccati_lanes(exp, reg), lambda: riccati_plain(exp, reg))
    got3 = calls["K3"][0]()
    spread3 = f32_spread(lambda e: riccati_plain(tuple(e), reg), exp)
    for i, (g, w, sp, a) in enumerate(zip(got3, _plain("K3", calls["K3"][1], plain_ms), spread3,
                                          K3_ATOL)):
        hold(v["K3"], f"K3 output {i}", g, w, a, spread=sp)
    kff_l, Kfb_l = gains if gains is not None else got3[:2]
    x0_l = X_l[0]
    args5 = (x0_l, X_l, U_l, kff_l, Kfb_l, xref_l, lam_l, mu)
    calls["K5"] = (lambda: R.linesearch_costs_lanes(ocp_b, *args5, alphas, mov_l),
                   lambda: R.linesearch_costs_plain(ocp_b, *args5, alphas, mov_l))
    got5, want5 = calls["K5"][0](), _plain("K5", calls["K5"][1], plain_ms)
    exact5 = R.linesearch_costs_plain(ocp_b, *f64(*args5), alphas, *f64(mov_l))
    div5 = diverged_rollouts(ocp_b, x0_l, X_l, U_l, kff_l, Kfb_l, alphas)
    hold(v["K5"], "K5", got5, want5, K5_ATOL, K5_RTOL, diverged=div5, per_element=True)
    rejected = div5 & ~div5[:1] & (exact5 > exact5[:1])
    assert not bool((rejected & (got5 <= got5[:1])).any()), \
        "K5: a diverged step's merit falls below the current merit"
    args6 = (x0_l, X_l, U_l, kff_l, Kfb_l, alpha)
    calls["K6"] = (lambda: R.rollout_alpha_lanes(ocp_b, *args6),
                   lambda: R.rollout_alpha_plain(ocp_b, *args6))
    got6 = calls["K6"][0]()
    div6 = diverged_rollouts(ocp_b, x0_l, X_l, U_l, kff_l, Kfb_l, [alpha])[0]
    spread6 = f32_spread(lambda a: R.rollout_alpha_plain(ocp_b, *a), args6)
    for i, (g, w, sp) in enumerate(zip(got6, _plain("K6", calls["K6"][1], plain_ms), spread6)):
        hold(v["K6"], f"K6 output {i}", g, w, K6_ATOL, spread=sp, diverged=div6)
    return v, calls
