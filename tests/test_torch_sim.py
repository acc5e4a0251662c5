"""The port's plant, SE(2) frames and LiDAR simulator (nmpc_tpu_torch.sim)
against nmpc_tpu.sim on the same numpy inputs.

Noise-free plant steps agree element by element (atol 1e-6); a
torch.Generator cannot reproduce JAX's key streams, so noisy steps are held
by the noise's mean and std over 4096 draws (within 5% of the std) and by
reproducibility under one seed. Frames and LiDAR ranges: atol 1e-5.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nmpc_tpu.sim import frames as JF
from nmpc_tpu.sim import lidar as JL
from nmpc_tpu.sim.plant import PlantConfig as JaxPlant
from nmpc_tpu.sim.plant import plant_step as jax_plant_step
from nmpc_tpu_torch.sim import frames as TF
from nmpc_tpu_torch.sim import lidar as TL
from nmpc_tpu_torch.sim import plant_from_numpy, plant_step


def _states(rng, B, m):
    x = rng.uniform(-2.0, 2.0, (B, 3 * m)).astype(np.float32)
    u = np.stack([rng.uniform(-0.4, 0.4, (B, m)), rng.uniform(-4.0, 4.0, (B, m))], -1)
    return x, u.reshape(B, 2 * m).astype(np.float32)


@pytest.mark.parametrize("substeps,integrator,sat", [
    (1, "euler", False), (4, "euler", True), (3, "rk4", True), (1, "rk4", False)])
def test_plant_step_matches_reference(substeps, integrator, sat):
    rng = np.random.default_rng(substeps)
    m, B = 3, 64
    x, u = _states(rng, B, m)
    u_sat = np.tile(np.array([0.22, 2.84], np.float32), m) if sat else None
    jcfg = JaxPlant(substeps=substeps, integrator=integrator,
                    u_sat=None if u_sat is None else jnp.asarray(u_sat))
    tcfg = plant_from_numpy(substeps, integrator, u_sat=u_sat, device="cpu")
    jx, jodom = jax.vmap(lambda a, b: jax_plant_step(a, b, 0.2, jcfg))(jnp.asarray(x), jnp.asarray(u))
    tx, todom = plant_step(torch.tensor(x), torch.tensor(u), 0.2, tcfg)
    np.testing.assert_allclose(tx.numpy(), np.asarray(jx), atol=1e-6)
    assert torch.equal(tx, todom)
    # unbatched, as the closed loop calls it
    tx1, _ = plant_step(torch.tensor(x[0]), torch.tensor(u[0]), 0.2, tcfg)
    np.testing.assert_allclose(tx1.numpy(), np.asarray(jx[0]), atol=1e-6)


def test_plant_noise_distribution_and_seed():
    nx, B = 6, 4096
    proc = np.array([0.01, 0.02, 0.005, 0.03, 0.01, 0.02], np.float32)
    odom = np.array([0.002, 0.004, 0.001, 0.006, 0.002, 0.004], np.float32)
    cfg = plant_from_numpy(process_noise=proc, odom_noise=odom, device="cpu")
    x = torch.zeros((B, nx))
    u = torch.zeros((B, 4))
    xn, od = plant_step(x, u, 0.1, cfg, torch.Generator().manual_seed(3))
    for got, std in ((xn, proc), (od - xn, odom)):
        assert (np.abs(got.mean(0).numpy()) <= 0.05 * std).all()
        np.testing.assert_allclose(got.std(0).numpy(), std, rtol=0.05)
    again = plant_step(x, u, 0.1, cfg, torch.Generator().manual_seed(3))
    assert torch.equal(again[0], xn) and torch.equal(again[1], od)
    other = plant_step(x, u, 0.1, cfg, torch.Generator().manual_seed(4))
    assert not torch.equal(other[0], xn)
    # no generator: no noise, as the reference without a key
    clean, clean_odom = plant_step(x, u, 0.1, cfg)
    assert torch.equal(clean, x) and torch.equal(clean_odom, x)
    # the JAX plant's noise has the same law (std within 5%)
    jcfg = JaxPlant(process_noise=jnp.asarray(proc), odom_noise=jnp.asarray(odom))
    keys = jax.random.split(jax.random.PRNGKey(0), B)
    jx, jod = jax.vmap(lambda k: jax_plant_step(jnp.zeros(nx), jnp.zeros(4), 0.1, jcfg, k))(keys)
    np.testing.assert_allclose(np.asarray(jx).std(0), proc, rtol=0.05)
    np.testing.assert_allclose(np.asarray(jod - jx).std(0), odom, rtol=0.05)


def test_frames_match_reference():
    rng = np.random.default_rng(11)
    pose = rng.uniform(-3.0, 3.0, (128, 3)).astype(np.float32)
    origin = rng.uniform(-3.0, 3.0, (128, 3)).astype(np.float32)
    for jf, tf in ((JF.se2_local_to_global, TF.se2_local_to_global),
                   (JF.se2_global_to_local, TF.se2_global_to_local)):
        np.testing.assert_allclose(tf(torch.tensor(pose), torch.tensor(origin)).numpy(),
                                   np.asarray(jf(jnp.asarray(pose), jnp.asarray(origin))), atol=1e-5)
    back = TF.se2_global_to_local(TF.se2_local_to_global(torch.tensor(pose), torch.tensor(origin)),
                                  torch.tensor(origin))
    np.testing.assert_allclose(back.numpy(), pose, atol=1e-5)
    qz = rng.uniform(-0.99, 0.99, 64).astype(np.float32)
    np.testing.assert_allclose(TF.yaw_from_quat_z(torch.tensor(qz)).numpy(),
                               np.asarray(JF.yaw_from_quat_z(jnp.asarray(qz))), atol=1e-5)
    th = rng.uniform(-20.0, 20.0, 256).astype(np.float32)
    np.testing.assert_allclose(TF.wrap_to_2pi(torch.tensor(th)).numpy(),
                               np.asarray(JF.wrap_to_2pi(jnp.asarray(th))), atol=1e-5)


@pytest.mark.parametrize("n_obs", [0, 1, 5])
def test_lidar_matches_reference(n_obs):
    rng = np.random.default_rng(n_obs)
    R = 36
    obs = np.concatenate([rng.uniform(-2.0, 2.0, (n_obs, 2)), rng.uniform(0.1, 0.4, (n_obs, 1))],
                         1).astype(np.float32)
    poses = rng.uniform(-2.5, 2.5, (16, 3)).astype(np.float32)
    ja, ta = JL.ray_angles(R), TL.ray_angles(R)
    np.testing.assert_allclose(ta.numpy(), np.asarray(ja), atol=1e-6)
    tscan = TL.raycast(torch.tensor(poses), torch.tensor(obs), ta)   # batched poses
    for i, p in enumerate(poses):
        jscan = JL.raycast(jnp.asarray(p), jnp.asarray(obs), ja)
        np.testing.assert_allclose(tscan[i].numpy(), np.asarray(jscan), atol=1e-5)
        one = TL.raycast(torch.tensor(p), torch.tensor(obs), ta)
        np.testing.assert_allclose(one.numpy(), np.asarray(jscan), atol=1e-5)
        jpts = JL.obstacle_points(jnp.asarray(p), jscan, ja)
        np.testing.assert_allclose(TL.obstacle_points(torch.tensor(p), one, ta).numpy(),
                                   np.asarray(jpts), atol=1e-5)
    assert (tscan <= 3.5).all() and (tscan > 0).all()
    if n_obs == 0:
        assert (tscan == 3.5).all()
