"""Helbing-1995 extension forces (the reference's dead config paths, made
to work) vs the oracle."""
import numpy as np
import jax.numpy as jnp
import pytest

import oracle
from carla_social_force_model_tpu.env.pointsets import build_chunked_pointset
from carla_social_force_model_tpu.models.params import (
    PedRepulsiveParams, SfmParams, SpaceRepulsiveParams)
from carla_social_force_model_tpu.ops import forces

RNG = np.random.default_rng(19)


def test_ped_repulsive_matches_oracle():
    n = 30
    pos = RNG.uniform(-8, 8, (n, 2))
    vel = RNG.uniform(-2, 2, (n, 2))
    desired = RNG.uniform(-1, 1, (n, 2))
    desired /= np.linalg.norm(desired, axis=-1, keepdims=True)
    alive = RNG.uniform(size=n) < 0.85
    p = PedRepulsiveParams()
    got = forces.ped_repulsive_force(
        jnp.asarray(pos, jnp.float32), jnp.asarray(vel, jnp.float32),
        jnp.asarray(desired, jnp.float32), jnp.asarray(alive), p)
    want = oracle.ped_repulsive_force(pos, vel, desired, alive, p.v0, p.sigma,
                                      p.fov_phi, p.fov_factor, p.step_width)
    np.testing.assert_allclose(np.asarray(got), want, rtol=2e-3, atol=2e-4)


def test_ped_repulsive_pushes_apart_and_fov_weakens_behind():
    # two peds close together, i facing +x, j directly behind i
    pos = jnp.asarray([[0.0, 0.0], [-0.8, 0.0]], jnp.float32)
    vel = jnp.zeros((2, 2), jnp.float32)
    desired = jnp.asarray([[1.0, 0.0], [1.0, 0.0]], jnp.float32)
    p = PedRepulsiveParams()
    f = np.asarray(forces.ped_repulsive_force(
        pos, vel, desired, jnp.ones((2,), bool), p))
    assert f[0, 0] > 0 and f[1, 0] < 0   # pushed apart along x
    # source behind pedestrian 0 -> weighted by fov_factor; pedestrian 1
    # sees 0 in front -> full weight
    assert abs(f[0, 0]) == pytest.approx(abs(f[1, 0]) * p.fov_factor, rel=1e-3)


def test_space_repulsive_matches_oracle():
    n = 25
    pos = RNG.uniform(-9, 9, (n, 2)) * np.array([1.0, 0.12])
    alive = np.ones(n, bool)
    mode = RNG.integers(0, 5, n)
    walls = [np.column_stack([np.linspace(-10, 10, 201), np.full(201, 1.2)]),
             np.column_stack([np.linspace(-10, 10, 201), np.full(201, -1.2)])]
    centers = [w[len(w) // 2] for w in walls]
    lengths = [len(w) * 0.1 for w in walls]
    pset = build_chunked_pointset(walls, np.asarray(centers),
                                  np.asarray(lengths), chunk_size=64)
    p = SpaceRepulsiveParams()
    got = forces.space_repulsive_force(
        jnp.asarray(pos, jnp.float32), jnp.asarray(mode, jnp.int32),
        jnp.asarray(alive), pset, p)
    want = oracle.space_repulsive_force(pos, mode, alive, walls, centers,
                                        lengths, p.u0, p.r)
    np.testing.assert_allclose(np.asarray(got), want, rtol=2e-3, atol=2e-3)


def test_config_enables_helbing_forces():
    cfg = {"forces": {"acceleration_force": True, "ped_repulsive_force": True,
                      "space_repulsive_force": True},
           "ped_repulsive_force": {"v0": 3.0, "sigma": 0.2},
           "space_repulsive_force": {"u0": 8.0, "r": 0.4}}
    params = SfmParams.from_dict(cfg)
    assert params.enable_ped_repulsive and params.enable_space_repulsive
    assert params.ped_repulsive.v0 == 3.0
    assert params.space_repulsive.r == 0.4
    with pytest.raises(ValueError):
        SfmParams.from_dict(cfg, strict_parity=True)


def test_helbing_forces_run_in_stepper():
    from carla_social_force_model_tpu.api.simulation import Simulation
    scenario = {
        "step_length": 0.05,
        "walker": {"despawn_on_arrival": True, "waypoint_threshold": 1,
                   "ped_spawner": [
                       {"spawn_location": [-5.0, 0.2, 1.0],
                        "destination": [5.0, 0.2, 0.0], "speed": 1.3,
                        "quantity": 2, "spawn_interval": 1.0},
                       {"spawn_location": [5.0, -0.2, 1.0],
                        "destination": [-5.0, -0.2, 0.0], "speed": 1.3,
                        "quantity": 2, "spawn_interval": 1.0}]},
        "obstacles": {"resolution": 0.1, "borders": [
            {"start_point": [-7.0, 1.0], "end_point": [7.0, 1.0]},
            {"start_point": [-7.0, -1.0], "end_point": [7.0, -1.0]}]},
    }
    sfm = {"forces": {"acceleration_force": True, "ped_repulsive_force": True,
                      "space_repulsive_force": True}}
    sim = Simulation.from_config(scenario, sfm, duration=15.0)
    final, recs = sim.run()
    assert np.all(np.isfinite(np.asarray(recs.pos)))
    assert int(np.asarray(final.alive).sum()) == 0  # everyone arrived


# --------------------------------------------------------------------------
# law="helbing" on the fused Pallas kernel (ops/pallas_forces.
# _pair_tile_helbing): the third pair-force model family on the shared
# launch machinery.  The row velocity planes carry the desired direction
# (the law never reads v_i), staged via the kernel's desired=(ex, ey).

def _helbing_state(n=70, seed=3, extent=8.0):
    rng = np.random.default_rng(seed)
    pos = rng.uniform(-extent, extent, (n, 2)).astype(np.float32)
    vel = rng.uniform(-2, 2, (n, 2)).astype(np.float32)
    desired = rng.normal(size=(n, 2))
    desired /= np.linalg.norm(desired, axis=-1, keepdims=True)
    desired = desired.astype(np.float32)
    rad = rng.uniform(0.25, 0.4, n).astype(np.float32)
    alive = rng.uniform(size=n) < 0.85
    return (jnp.asarray(pos), jnp.asarray(vel), jnp.asarray(desired),
            jnp.asarray(rad), jnp.asarray(alive))


def test_helbing_pallas_matches_jnp_and_oracle():
    from carla_social_force_model_tpu.ops.pallas_forces import (
        pedestrian_force_pallas)
    pos, vel, desired, rad, alive = _helbing_state()
    p = PedRepulsiveParams()
    ex, ey = desired[:, 0], desired[:, 1]
    got = pedestrian_force_pallas(
        pos, vel, rad, alive, p, law="helbing", desired=(ex, ey),
        row_tile=16, col_tile=128, interpret=True)
    want_jnp = forces.ped_repulsive_force(pos, vel, desired, alive, p)
    np.testing.assert_allclose(np.asarray(got), np.asarray(want_jnp),
                               rtol=2e-4, atol=2e-5)
    want = oracle.ped_repulsive_force(
        np.asarray(pos, np.float64), np.asarray(vel, np.float64),
        np.asarray(desired, np.float64), np.asarray(alive), p.v0, p.sigma,
        p.fov_phi, p.fov_factor, p.step_width)
    np.testing.assert_allclose(np.asarray(got), want, rtol=2e-3, atol=2e-4)


def test_helbing_pallas_cutoff_sorted():
    from carla_social_force_model_tpu.ops.pallas_forces import (
        pedestrian_force_pallas, pedestrian_force_pallas_sorted)
    pos, vel, desired, rad, alive = _helbing_state(n=90, seed=11, extent=12.0)
    p = PedRepulsiveParams()
    dxy = (desired[:, 0], desired[:, 1])
    exact = pedestrian_force_pallas(
        pos, vel, rad, alive, p, law="helbing", desired=dxy,
        row_tile=16, col_tile=128, interpret=True)
    # a cutoff beyond the f32 underflow range (b >= ~88.7*sigma needs
    # d >= 2b + step_width*v_max ~ 56 m at defaults) is exact
    sorted_exact = pedestrian_force_pallas_sorted(
        pos, vel, rad, alive, p, cutoff=80.0, law="helbing", desired=dxy,
        row_tile=16, col_tile=128, interpret=True)
    np.testing.assert_allclose(np.asarray(sorted_exact), np.asarray(exact),
                               rtol=1e-5, atol=1e-6)
    # the 30 m production cutoff truncates only exp(-d/2sigma)-scale terms
    sorted_30 = pedestrian_force_pallas_sorted(
        pos, vel, rad, alive, p, cutoff=30.0, law="helbing", desired=dxy,
        row_tile=16, col_tile=128, interpret=True)
    np.testing.assert_allclose(np.asarray(sorted_30), np.asarray(exact),
                               rtol=1e-4, atol=1e-5)


def test_helbing_pallas_desired_validation():
    from carla_social_force_model_tpu.ops.pallas_forces import (
        pedestrian_force_pallas)
    from carla_social_force_model_tpu.models.params import MoussaidParams
    pos, vel, desired, rad, alive = _helbing_state(n=8)
    with pytest.raises(ValueError, match="desired"):
        pedestrian_force_pallas(pos, vel, rad, alive, PedRepulsiveParams(),
                                law="helbing", interpret=True)
    with pytest.raises(ValueError, match="helbing"):
        pedestrian_force_pallas(pos, vel, rad, alive, MoussaidParams(),
                                desired=(desired[:, 0], desired[:, 1]),
                                interpret=True)


def test_helbing_sharded_matches_single_device():
    """jnp gather == jnp ring == single-device == sharded Pallas on the
    8-device mesh (shard_map over the agents axis)."""
    import jax
    from jax.sharding import Mesh, PartitionSpec as P
    from carla_social_force_model_tpu.ops.pallas_forces import (
        pedestrian_force_pallas)
    pos, vel, desired, rad, alive = _helbing_state(n=64, seed=7)
    p = PedRepulsiveParams()
    want = forces.ped_repulsive_force(pos, vel, desired, alive, p)

    mesh = Mesh(np.asarray(jax.devices()[:8]), ("agents",))
    specs = (P("agents"),) * 4
    for comm in ("gather", "ring"):
        fn = jax.jit(jax.shard_map(
            lambda po, ve, de, al: forces.ped_repulsive_force(
                po, ve, de, al, p, axis_name="agents", axis_comm=comm),
            mesh=mesh, in_specs=specs, out_specs=P("agents"),
            check_vma=False))
        got = fn(pos, vel, desired, alive)
        np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                                   rtol=2e-4, atol=2e-5, err_msg=comm)

    for comm in ("gather", "ring"):
        fn_p = jax.jit(jax.shard_map(
            lambda po, ve, ra, al, ex, ey: pedestrian_force_pallas(
                po, ve, ra, al, p, law="helbing", desired=(ex, ey),
                axis_name="agents", axis_comm=comm, row_tile=8, col_tile=128,
                interpret=True),
            mesh=mesh, in_specs=(P("agents"),) * 6, out_specs=P("agents"),
            check_vma=False))
        got_p = fn_p(pos, vel, rad, alive, desired[:, 0], desired[:, 1])
        np.testing.assert_allclose(np.asarray(got_p), np.asarray(want),
                                   rtol=2e-4, atol=2e-5,
                                   err_msg=f"pallas-{comm}")


def test_helbing_stepper_pallas_matches_jnp_rollout():
    import dataclasses
    from carla_social_force_model_tpu.api.synthetic import benchmark_bundle
    from carla_social_force_model_tpu.models.stepper import make_rollout_fn
    scene, params, cfg, state = benchmark_bundle(24, extent=8.0,
                                                 use_pallas=False)
    params = dataclasses.replace(params, enable_pedestrian=False,
                                 enable_ped_repulsive=True)
    steps = 30
    _, rec_j = make_rollout_fn(scene, params, cfg, steps)(state)
    cfg_p = dataclasses.replace(cfg, use_pallas=True, pallas_interpret=True,
                                pallas_row_tile=8, pallas_col_tile=128)
    _, rec_p = make_rollout_fn(scene, params, cfg_p, steps)(state)
    np.testing.assert_allclose(np.asarray(rec_p.pos), np.asarray(rec_j.pos),
                               atol=2e-4)
    np.testing.assert_array_equal(np.asarray(rec_p.alive),
                                  np.asarray(rec_j.alive))


def test_helbing_b_singularity_regularized():
    """The equal-speed-follower geometry cancels b = 0.5*sqrt(s^2 - |y|^2)
    to ZERO (s == |y| exactly), where the raw s/(4b) magnitude is unbounded
    and f32 rounding decides between 'masked' and a huge kick -- observed
    as a 4 N spurious force on one path and 3e-6 on the other before the
    b_min clamp.  Exact-degenerate and near-degenerate pairs must now give
    small, bounded, path-consistent forces."""
    from carla_social_force_model_tpu.ops.pallas_forces import (
        pedestrian_force_pallas)
    p = PedRepulsiveParams()
    for dy in (0.0, 1e-6, 1e-4):
        # leader at origin, follower 0.65 m behind, both moving +x at the
        # same speed: s^2 - |y|^2 == 0 up to rounding
        pos = jnp.asarray([[0.0, 0.0], [-0.65, dy]], jnp.float32)
        vel = jnp.asarray([[1.3, 0.0], [1.3, 0.0]], jnp.float32)
        desired = jnp.asarray([[1.0, 0.0], [1.0, 0.0]], jnp.float32)
        alive = jnp.ones((2,), bool)
        f_jnp = np.asarray(forces.ped_repulsive_force(pos, vel, desired,
                                                      alive, p))
        f_pl = np.asarray(pedestrian_force_pallas(
            pos, vel, jnp.full((2,), 0.3, jnp.float32), alive, p,
            law="helbing", desired=(desired[:, 0], desired[:, 1]),
            row_tile=8, col_tile=128, interpret=True))
        assert np.all(np.abs(f_jnp) < 1.0), (dy, f_jnp)
        assert np.all(np.abs(f_pl) < 1.0), (dy, f_pl)
        # with the clamp the force is CONTINUOUS through b == 0, so even
        # when f32 rounding makes one path mask (b2 == 0) a pair the other
        # computes (b2 == eps), both stay within the near-boundary force
        # scale of the f64 truth
        want = oracle.ped_repulsive_force(
            np.asarray(pos, np.float64), np.asarray(vel, np.float64),
            np.asarray(desired, np.float64), np.asarray(alive), p.v0,
            p.sigma, p.fov_phi, p.fov_factor, p.step_width, p.b_min)
        np.testing.assert_allclose(f_pl, want, atol=1e-2, err_msg=str(dy))
        np.testing.assert_allclose(f_jnp, want, atol=1e-2, err_msg=str(dy))
