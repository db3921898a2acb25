"""Compiled fused kernels on the card vs the jnp path.

The interpret-mode tests (test_pallas_forces.py, test_env_pallas.py) pin
the kernels' arithmetic on the CPU; these run the same kernels compiled
through Triton, which only the card can do.  They skip elsewhere (the
``gpu`` fixture) and chip_smoke.py runs them on the card.
"""
import dataclasses

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from carla_social_force_model_tpu.models.params import (
    MoussaidParams, PedRepulsiveParams, PowerLawParams)
from carla_social_force_model_tpu.ops import forces
from carla_social_force_model_tpu.ops.pallas_forces import (
    pedestrian_force_pallas, pedestrian_force_pallas_sorted)

pytestmark = pytest.mark.gpu


def _crowd(n, extent, seed=3):
    rng = np.random.default_rng(seed)
    pos = jnp.asarray(rng.uniform(-extent, extent, (n, 2)), jnp.float32)
    vel = jnp.asarray(rng.uniform(-1.5, 1.5, (n, 2)), jnp.float32)
    rad = jnp.asarray(rng.uniform(0.2, 0.4, n), jnp.float32)
    alive = jnp.asarray(rng.uniform(size=n) < 0.9)
    return pos, vel, rad, alive


# power-law rows sum near-collision terms of 1e2-1e3 that cancel, so its
# tolerance is the one tests/test_powerlaw.py uses
@pytest.mark.parametrize("law,p,rtol", [
    ("moussaid", MoussaidParams(), 2e-5),
    ("powerlaw", PowerLawParams(), 3e-4),
    ("helbing", PedRepulsiveParams(), 2e-5)])
def test_compiled_pair_kernel_matches_jnp(gpu, law, p, rtol):
    n = 3000
    pos, vel, rad, alive = _crowd(n, 55.0)
    e = vel / (jnp.linalg.norm(vel, axis=1, keepdims=True) + 1e-6)
    ref = {"moussaid": lambda: forces.pedestrian_force(pos, vel, rad, alive,
                                                       p),
           "powerlaw": lambda: forces.powerlaw_force(pos, vel, rad, alive, p),
           "helbing": lambda: forces.ped_repulsive_force(pos, vel, e, alive,
                                                         p)}[law]
    want = np.asarray(jax.jit(ref)())
    got = np.asarray(jax.jit(lambda: pedestrian_force_pallas(
        pos, vel, rad, alive, p, law=law,
        desired=(e[:, 0], e[:, 1]) if law == "helbing" else None))())
    np.testing.assert_allclose(got, want, rtol=rtol, atol=2e-5)
    assert np.all(got[~np.asarray(alive)] == 0.0)


def test_compiled_cutoff_f32_exact_threshold(gpu):
    """At the f32-exact threshold the cutoff kernel equals the all-pairs
    kernel bitwise; the sorted launch equals it up to summation order."""
    n, v_max = 6000, 1.5
    pos, vel, rad, alive = _crowd(n, 400.0)
    p = MoussaidParams()
    thresh = float(np.ceil(110.0 * p.gamma * (2.0 * p.lambda_ * v_max + 1.0)))
    exact = np.asarray(jax.jit(lambda: pedestrian_force_pallas(
        pos, vel, rad, alive, p))())
    cut = np.asarray(jax.jit(lambda: pedestrian_force_pallas(
        pos, vel, rad, alive, p, cutoff=thresh))())
    np.testing.assert_array_equal(cut, exact)
    srt = np.asarray(jax.jit(lambda: pedestrian_force_pallas_sorted(
        pos, vel, rad, alive, p, cutoff=thresh))())
    np.testing.assert_allclose(srt, exact, rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize("analytic", [False, True])
def test_compiled_env_kernel_matches_jnp(gpu, analytic):
    from carla_social_force_model_tpu.api.synthetic import benchmark_bundle
    from carla_social_force_model_tpu.models.spawn import apply_spawn
    from carla_social_force_model_tpu.models.state import PedState
    from carla_social_force_model_tpu.models.stepper import (force_terms,
                                                             prepare_scene)
    from carla_social_force_model_tpu.models.vehicles import (
        vehicle_snapshot_at)
    n = 2000
    scene, params, cfg, _ = benchmark_bundle(n, with_borders=True,
                                             with_obstacles=True)
    scene = prepare_scene(scene, analytic=analytic)
    params = dataclasses.replace(params, enable_pedestrian=False,
                                 enable_space_repulsive=True)
    state = apply_spawn(PedState.empty(n), scene.spawn, jnp.asarray(0))
    snap = vehicle_snapshot_at(scene.vehicles, jnp.asarray(7))
    base = dataclasses.replace(cfg, env_analytic=analytic)
    want = jax.jit(lambda s: force_terms(
        s, scene, params, dataclasses.replace(base, use_pallas=False),
        snap))(state)
    got = jax.jit(lambda s: force_terms(
        s, scene, params, dataclasses.replace(base, use_pallas=True),
        snap))(state)
    for name in want:
        g = np.stack([np.asarray(a) for a in got[name]], axis=-1)
        w = np.stack([np.asarray(a) for a in want[name]], axis=-1)
        # per-agent vector tolerance: wall-hugging agents' unit vectors
        # carry the f32 coordinate rounding of the closest point
        err = np.linalg.norm(g - w, axis=1)
        assert np.all(err <= 3e-4 * np.linalg.norm(w, axis=1) + 3e-5), name


def test_compiled_rollout_matches_jnp(gpu):
    from carla_social_force_model_tpu.api.synthetic import benchmark_bundle
    from carla_social_force_model_tpu.models.stepper import make_rollout_fn
    scene, params, cfg, state = benchmark_bundle(2000, with_borders=True)
    finals = [make_rollout_fn(scene, params,
                              dataclasses.replace(cfg, use_pallas=k), 20,
                              record=False)(state)[0] for k in (True, False)]
    np.testing.assert_array_equal(np.asarray(finals[0].alive),
                                  np.asarray(finals[1].alive))
    np.testing.assert_allclose(np.asarray(finals[0].pos),
                               np.asarray(finals[1].pos), atol=1e-3)
