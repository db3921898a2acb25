"""Karamouzas et al. (2014) power-law model family: f64 oracle parity,
Pallas == jnp across launch modes, sharding, config wiring, and physics
sanity.  A second pedestrian-model family beyond the reference's Moussaid
force (models/params.PowerLawParams, ops/forces.powerlaw_force,
ops/pallas_forces law="powerlaw")."""
import dataclasses

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from carla_social_force_model_tpu.models.params import (PowerLawParams,
                                                        SfmParams)
from carla_social_force_model_tpu.models.state import PedState
from carla_social_force_model_tpu.models.stepper import (Scene, StepConfig,
                                                         force_terms,
                                                         make_rollout_fn)
from carla_social_force_model_tpu.ops import forces
from carla_social_force_model_tpu.ops.pallas_forces import (
    pedestrian_force_pallas, pedestrian_force_pallas_sorted)

RNG = np.random.default_rng(23)


def powerlaw_oracle(pos, vel, rad, alive, p: PowerLawParams):
    """Loop-based float64 oracle of the time-to-collision power law."""
    pos = np.asarray(pos, np.float64)
    vel = np.asarray(vel, np.float64)
    rad = np.asarray(rad, np.float64)
    n = pos.shape[0]
    f = np.zeros((n, 2))
    for i in range(n):
        if not alive[i]:
            continue
        for j in range(n):
            if j == i or not alive[j]:
                continue
            x = pos[i] - pos[j]
            v = vel[i] - vel[j]
            r = rad[i] + rad[j]
            a = v @ v
            b = x @ v
            c = x @ x - r * r
            disc = b * b - a * c
            if c <= 0.0 or disc <= 0.0 or a <= 1e-8:
                continue
            s = np.sqrt(disc)
            tau = (-b - s) / a
            if tau <= 0.0 or tau >= p.tau_max:
                continue
            t = min(max(tau, p.tau_min), p.tau_max)
            mag = p.k * np.exp(-t / p.tau0) * (2.0 / t + 1.0 / p.tau0) / t**2
            f[i] += mag * (a * x - (s + b) * v) / (a * s)
    return f


def _crowd(n=72, extent=12.0, dead_frac=0.1):
    pos = jnp.asarray(RNG.uniform(-extent, extent, (n, 2)), jnp.float32)
    vel = jnp.asarray(RNG.uniform(-2, 2, (n, 2)), jnp.float32)
    rad = jnp.asarray(RNG.uniform(0.2, 0.4, (n,)), jnp.float32)
    alive = jnp.asarray(RNG.uniform(size=n) > dead_frac)
    return pos, vel, rad, alive


def test_jnp_matches_f64_oracle():
    pos, vel, rad, alive = _crowd()
    p = PowerLawParams()
    got = forces.powerlaw_force(pos, vel, rad, alive, p)
    want = powerlaw_oracle(pos, vel, rad, np.asarray(alive), p)
    np.testing.assert_allclose(np.asarray(got), want, rtol=1e-3, atol=5e-5)
    assert np.all(np.asarray(got)[~np.asarray(alive)] == 0.0)
    # Newton's third law: the alive-pair force sum vanishes
    np.testing.assert_allclose(np.asarray(got).sum(axis=0),
                               np.zeros(2), atol=2e-4)


def test_jnp_row_blocked_matches():
    pos, vel, rad, alive = _crowd(n=70)
    p = PowerLawParams()
    full = forces.powerlaw_force(pos, vel, rad, alive, p)
    blocked = forces.powerlaw_force(pos, vel, rad, alive, p, row_block=16)
    # the power law's tau^-3 sensitivity amplifies f32 rounding for pairs
    # near tau_min (d(mag)/mag ~ 3*d(tau)/tau), so two XLA evaluations of
    # the same math agree only to ~1e-3 relative, not summation-order 1e-6
    np.testing.assert_allclose(np.asarray(blocked), np.asarray(full),
                               rtol=2e-3, atol=2e-5)


@pytest.mark.parametrize("tiles", [(8, 16), (32, 64)])
def test_pallas_matches_jnp(tiles):
    pos, vel, rad, alive = _crowd(n=90)
    p = PowerLawParams()
    want = forces.powerlaw_force(pos, vel, rad, alive, p)
    got = pedestrian_force_pallas(pos, vel, rad, alive, p, law="powerlaw",
                                  row_tile=tiles[0], col_tile=tiles[1],
                                  interpret=True)
    np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                               rtol=3e-4, atol=2e-5)


def test_pallas_sorted_cutoff():
    """Cutoff + Hilbert sort compose with the power law; a cutoff >=
    tau_max * v_rel_max + R keeps it exact."""
    pos, vel, rad, alive = _crowd(n=128, extent=40.0)
    p = PowerLawParams(tau_max=5.0)
    want = forces.powerlaw_force(pos, vel, rad, alive, p)
    # v_rel <= 4 m/s, tau_max 5 s -> any colliding pair is within ~21 m
    got = pedestrian_force_pallas_sorted(
        pos, vel, rad, alive, p, cutoff=25.0, law="powerlaw",
        row_tile=8, col_tile=16, interpret=True)
    np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                               rtol=3e-4, atol=2e-5)


def test_ring_sharded_matches_single():
    from jax.sharding import PartitionSpec as P
    from carla_social_force_model_tpu.parallel.mesh import make_mesh
    pos, vel, rad, alive = _crowd(n=24 * 8)
    p = PowerLawParams()
    kw = dict(law="powerlaw", row_tile=8, col_tile=16, interpret=True)
    want = pedestrian_force_pallas(pos, vel, rad, alive, p, **kw)
    mesh = make_mesh(n_agent_shards=8)
    fn = jax.shard_map(
        lambda *a: pedestrian_force_pallas(
            *a, p, axis_name="agents", axis_comm="ring", **kw),
        mesh=mesh, in_specs=(P("agents"),) * 4, out_specs=P("agents"),
        check_vma=False)
    got = jax.jit(fn)(pos, vel, rad, alive)
    np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                               rtol=3e-4, atol=2e-5)


def test_config_wiring_and_strict_parity():
    cfg = {"forces": {"acceleration_force": True, "powerlaw_force": True},
           "powerlaw_force": {"k": 2.0, "tau0": 2.5}}
    p = SfmParams.from_dict(cfg)
    assert p.enable_powerlaw and p.powerlaw.k == 2.0 and p.powerlaw.tau0 == 2.5
    with pytest.raises(ValueError, match="powerlaw_force"):
        SfmParams.from_dict(cfg, strict_parity=True)


def test_force_terms_dispatch_and_collision_course_physics():
    """force_terms carries the term on both paths, and the law behaves:
    two head-on walkers on a collision course repel along the line of
    approach; diverging walkers feel nothing."""
    n = 2
    st = PedState.empty(n)
    st = st.replace_coords(
        pos=jnp.asarray([[-3.0, 0.0], [3.0, 0.0]], jnp.float32),
        vel=jnp.asarray([[1.3, 0.0], [-1.3, 0.0]], jnp.float32),
        radius=jnp.full((n,), 0.3, jnp.float32),
        alive=jnp.ones((n,), bool))
    params = SfmParams(enable_acceleration=False, enable_pedestrian=False,
                       enable_powerlaw=True)
    scene = Scene(spawn=None)
    jnp_terms = force_terms(st, scene, params, StepConfig(), None)
    f = np.stack([np.asarray(a) for a in jnp_terms["powerlaw_force"]],
                 axis=-1)
    assert f[0, 0] < 0.0 and f[1, 0] > 0.0          # pushed apart
    np.testing.assert_allclose(f[0], -f[1], rtol=1e-6)

    cfg_p = StepConfig(use_pallas=True, pallas_interpret=True,
                       pallas_row_tile=8, pallas_col_tile=128)
    pal_terms = force_terms(st, scene, params, cfg_p, None)
    fp = np.stack([np.asarray(a) for a in pal_terms["powerlaw_force"]],
                  axis=-1)
    np.testing.assert_allclose(fp, f, rtol=3e-4, atol=1e-6)

    # diverging: same setup with velocities reversed -> zero force
    st2 = st.replace_coords(vel=-st.vel)
    f2 = force_terms(st2, scene, params, StepConfig(), None)["powerlaw_force"]
    assert float(jnp.abs(jnp.stack(f2)).max()) == 0.0


def test_powerlaw_rollout_headless():
    """A counterflow crowd under the power law stays finite and everyone
    keeps moving toward their waypoint (no NaN, no frozen crowd)."""
    from carla_social_force_model_tpu.api.synthetic import benchmark_bundle
    scene, _, cfg, state = benchmark_bundle(64, extent=15.0,
                                            use_pallas=False)
    params = SfmParams(enable_acceleration=True, enable_pedestrian=False,
                       enable_powerlaw=True)
    run = make_rollout_fn(scene, params, cfg, 200, record=False)
    final, _ = run(state)
    final = final[0] if isinstance(final, tuple) else final
    assert bool(jnp.isfinite(final.pos_x).all())
    assert bool(jnp.isfinite(final.pos_y).all())
    moved = jnp.abs(final.pos_x - state.pos_x) + jnp.abs(final.pos_y
                                                         - state.pos_y)
    assert float(jnp.where(final.alive, moved, 1.0).min()) > 0.0


def test_powerlaw_scenario_end_to_end():
    """The corridor scenario runs under the power-law sfm config through
    the full scenario API (configs/sfm_powerlaw.toml) with finite motion."""
    import os
    from carla_social_force_model_tpu.api.simulation import Simulation
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    sim = Simulation.from_config(
        os.path.join(root, "configs/scenarios/corridor_counterflow.toml"),
        os.path.join(root, "configs/sfm_powerlaw.toml"), duration=6.0)
    assert sim.bundle.params.enable_powerlaw
    assert not sim.bundle.params.enable_pedestrian
    final, _ = sim.run()
    final = final[0] if isinstance(final, tuple) else final
    assert bool(jnp.isfinite(final.pos_x).all())
