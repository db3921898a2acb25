"""Multi-device tests on the virtual 8-device CPU mesh."""
import numpy as np
import jax
import jax.numpy as jnp
import pytest

from carla_social_force_model_tpu.api.synthetic import benchmark_bundle
from carla_social_force_model_tpu.models.state import PedState
from carla_social_force_model_tpu.models.stepper import make_rollout_fn
from carla_social_force_model_tpu.parallel.mesh import make_mesh
from carla_social_force_model_tpu.parallel.sharding import (
    make_sharded_rollout, prepare_sharded_scene)
from carla_social_force_model_tpu.parallel.sweeps import (
    batch_params, make_sweep_rollout)


def test_eight_virtual_devices_present():
    assert len(jax.devices()) == 8


def test_sharded_rollout_matches_single_device():
    n, steps = 48, 20
    scene, params, cfg, state = benchmark_bundle(n, extent=15.0)

    run_single = make_rollout_fn(scene, params, cfg, steps, record=True)
    final_s, recs_s = run_single(state)

    mesh = make_mesh(n_agent_shards=8)
    scene_p, cap = prepare_sharded_scene(scene, 8)
    run_sharded = make_sharded_rollout(mesh, scene_p, params, cfg, steps,
                                       record=True)
    final_p, recs_p = run_sharded(PedState.empty(cap))

    np.testing.assert_array_equal(np.asarray(recs_s.alive),
                                  np.asarray(recs_p.alive)[:, :n])
    assert not np.asarray(final_p.alive)[n:].any()  # padding slots stay dead
    np.testing.assert_allclose(np.asarray(recs_s.pos),
                               np.asarray(recs_p.pos)[:, :n], atol=2e-5)
    np.testing.assert_allclose(np.asarray(final_s.pos),
                               np.asarray(final_p.pos)[:n], atol=2e-5)


def test_sharded_autopilot_rollout_matches_single_device():
    """Reactive-fleet rollouts compose with agent-sharding: the hazard
    check gathers the global walker set over the mesh axis while the fleet
    state stays replicated (ROADMAP round-2 item)."""
    import os
    from carla_social_force_model_tpu.api.simulation import Simulation
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    b = Simulation.from_config(
        os.path.join(repo, "configs/scenarios/jaywalking_reactive.toml"),
        os.path.join(repo, "configs/sfm.toml"), duration=8.0).bundle
    assert b.scene.autopilot is not None
    n, steps = b.capacity, b.num_steps

    run_single = make_rollout_fn(b.scene, b.params, b.cfg, steps, record=True)
    final_s, (recs_s, veh_s) = run_single(b.initial_state)

    mesh = make_mesh(n_agent_shards=8)
    scene_p, cap = prepare_sharded_scene(b.scene, 8)
    run_sharded = make_sharded_rollout(mesh, scene_p, b.params, b.cfg, steps,
                                       record=True)
    final_p, (recs_p, veh_p) = run_sharded(PedState.empty(cap))

    np.testing.assert_array_equal(np.asarray(recs_s.alive),
                                  np.asarray(recs_p.alive)[:, :n])
    np.testing.assert_allclose(np.asarray(recs_s.pos),
                               np.asarray(recs_p.pos)[:, :n], atol=2e-5)
    # the replicated fleet trajectory matches (vehicles brake identically
    # for the same walkers)
    np.testing.assert_array_equal(np.asarray(veh_s.active),
                                  np.asarray(veh_p.active))
    np.testing.assert_allclose(np.asarray(veh_s.pos),
                               np.asarray(veh_p.pos), atol=2e-5)


def test_ring_comm_matches_gather():
    import dataclasses
    n, steps = 48, 15
    scene, params, cfg, state = benchmark_bundle(n, extent=15.0)
    mesh = make_mesh(n_agent_shards=8)
    scene_p, cap = prepare_sharded_scene(scene, 8)

    run_gather = make_sharded_rollout(mesh, scene_p, params, cfg, steps,
                                      record=True)
    cfg_ring = dataclasses.replace(cfg, axis_comm="ring")
    run_ring = make_sharded_rollout(mesh, scene_p, params, cfg_ring, steps,
                                    record=True)
    _, recs_g = run_gather(PedState.empty(cap))
    _, recs_r = run_ring(PedState.empty(cap))
    np.testing.assert_allclose(np.asarray(recs_g.pos), np.asarray(recs_r.pos),
                               atol=3e-5)
    np.testing.assert_array_equal(np.asarray(recs_g.mode),
                                  np.asarray(recs_r.mode))


def test_sweep_rollout_varies_with_params():
    n, steps, b = 16, 15, 4
    scene, params, cfg, _ = benchmark_bundle(n, extent=10.0)
    swept = batch_params(params, pedestrian_A=jnp.asarray([0.5, 2.0, 4.5, 12.0]))
    run = make_sweep_rollout(scene, cfg, steps)
    finals, _ = run(swept)
    pos = np.asarray(finals.pos)  # (B, N, 2)
    assert pos.shape == (b, n, 2)
    # different interaction amplitudes must yield different trajectories
    assert np.abs(pos[0] - pos[3]).max() > 1e-3


def test_ensemble_rollout_matches_unbatched():
    """Batched crowds (BASELINE config #5 shape): each row must equal an
    independent unbatched rollout of the same crowd."""
    import dataclasses
    from carla_social_force_model_tpu.api.synthetic import (
        batched_crowds, synthetic_crowd)
    from carla_social_force_model_tpu.models.params import SfmParams
    from carla_social_force_model_tpu.models.stepper import Scene, StepConfig
    from carla_social_force_model_tpu.parallel.sweeps import make_ensemble_rollout

    b, n, steps = 3, 12, 12
    scene = Scene(spawn=batched_crowds(b, n, extent=8.0))
    params = SfmParams(enable_acceleration=True, enable_pedestrian=True)
    cfg = StepConfig(despawn_on_arrival=False)
    finals, _ = make_ensemble_rollout(scene, params, cfg, steps)(scene)

    for row in range(b):
        s_row = Scene(spawn=synthetic_crowd(n, extent=8.0, seed=row))
        f_row, _ = make_rollout_fn(s_row, params, cfg, steps)(PedState.empty(n))
        np.testing.assert_array_equal(np.asarray(finals.pos)[row],
                                      np.asarray(f_row.pos))


def test_ensemble_rollout_with_borders():
    """Ensemble over a scene WITH geometry (round-2 advisor find): the
    returned runner used to vmap the *caller's* unprepared scene against
    in_axes computed from the prepared one (borders_seg mismatch).  Each
    batched row must equal an independent unbatched rollout."""
    import dataclasses
    from carla_social_force_model_tpu.api.synthetic import (
        batched_crowds, synthetic_crowd)
    from carla_social_force_model_tpu.parallel.sweeps import make_ensemble_rollout

    b, n, steps = 2, 10, 10
    scene1, params, cfg, _ = benchmark_bundle(n, with_borders=True)
    extent = 25.0  # benchmark_bundle's floor for small n
    scene = dataclasses.replace(scene1, spawn=batched_crowds(b, n, extent=extent))
    finals, _ = make_ensemble_rollout(scene, params, cfg, steps)(scene)

    for row in range(b):
        s_row = dataclasses.replace(
            scene1, spawn=synthetic_crowd(n, extent=extent, seed=row))
        f_row, _ = make_rollout_fn(s_row, params, cfg, steps)(PedState.empty(n))
        np.testing.assert_allclose(np.asarray(finals.pos)[row],
                                   np.asarray(f_row.pos), atol=1e-6)


def test_sweep_sharded_over_batch_axis():
    n, steps, b = 12, 10, 8
    scene, params, cfg, _ = benchmark_bundle(n, extent=10.0)
    swept = batch_params(params, pedestrian_gamma=jnp.linspace(0.2, 0.6, b))
    mesh = make_mesh(n_agent_shards=1, n_batch_shards=8)
    run = make_sweep_rollout(scene, cfg, steps, mesh=mesh)
    finals, _ = run(swept)
    assert np.asarray(finals.pos).shape == (b, n, 2)
    assert np.all(np.isfinite(np.asarray(finals.pos)))


def test_parameter_sweep_example_runs():
    import os
    import sys
    sys.path.insert(0, os.path.join(
        os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "examples"))
    import parameter_sweep
    assert parameter_sweep.main(["--points", "3", "--steps", "60"]) == 0


def test_sharded_pallas_cutoff_ring_rollout():
    """Whole sharded rollout on the fused Pallas path with the Morton-sorted
    cutoff and ring column comm == single-device Pallas rollout (the
    multi-chip composition VERDICT round-1 asked for)."""
    import dataclasses
    n, steps = 48, 12
    scene, params, cfg, state = benchmark_bundle(n, extent=15.0)
    cfg_p = dataclasses.replace(
        cfg, use_pallas=True, interaction_cutoff=500.0, axis_comm="ring",
        pallas_row_tile=8, pallas_col_tile=128, pallas_interpret=True)

    run_single = make_rollout_fn(scene, params, cfg_p, steps, record=True)
    _, recs_s = run_single(state)

    mesh = make_mesh(n_agent_shards=8)
    scene_p, cap = prepare_sharded_scene(scene, 8)
    run_sharded = make_sharded_rollout(mesh, scene_p, params, cfg_p,
                                       steps, record=True)
    _, recs_p = run_sharded(PedState.empty(cap))

    np.testing.assert_array_equal(np.asarray(recs_s.alive),
                                  np.asarray(recs_p.alive)[:, :n])
    np.testing.assert_allclose(np.asarray(recs_s.pos),
                               np.asarray(recs_p.pos)[:, :n], atol=5e-5)


def test_sharded_env_rollout_matches_single_device():
    """The environment kernel composes with agent-sharding: each shard
    sorts and tiles its local pedestrians (row-local force, no
    collectives)."""
    import dataclasses
    from carla_social_force_model_tpu.env.borders import build_border_set
    n, steps = 48, 12
    scene, params, cfg, state = benchmark_bundle(n, extent=15.0,
                                                 with_borders=True)
    # many short wall sections, most skipped per ped tile; rows at
    # y=+-12 sit inside the crowd
    lines, centers, lengths = [], [], []
    for y in (-12.0, 12.0, 40.0):
        for k in range(30):
            x0 = -150.0 + k * 10.0
            xs = np.arange(x0, x0 + 10.0, 0.5)
            lines.append(np.column_stack([xs, np.full(len(xs), y)]))
            centers.append(lines[-1][len(xs) // 2])
            lengths.append(12.0)
    scene = dataclasses.replace(scene,
                                borders=build_border_set(lines, centers,
                                                         lengths))
    cfg_p = dataclasses.replace(
        cfg, use_pallas=True, pallas_row_tile=8, pallas_col_tile=128,
        pallas_interpret=True, env_ped_tile=32)

    run_single = make_rollout_fn(scene, params, cfg_p, steps, record=True)
    _, recs_s = run_single(state)

    mesh = make_mesh(n_agent_shards=8)
    scene_p, cap = prepare_sharded_scene(scene, 8)
    run_sharded = make_sharded_rollout(mesh, scene_p, params, cfg_p,
                                       steps, record=True)
    _, recs_p = run_sharded(PedState.empty(cap))

    np.testing.assert_array_equal(np.asarray(recs_s.alive),
                                  np.asarray(recs_p.alive)[:, :n])
    np.testing.assert_allclose(np.asarray(recs_s.pos),
                               np.asarray(recs_p.pos)[:, :n], atol=5e-5)


def test_sharded_ensemble_2d_mesh_matches_unbatched():
    """Composed dp x tp: rollouts sharded over ``batch`` AND each rollout's
    slots sharded over ``agents`` in one program; every row must equal an
    independent single-device rollout of the same crowd."""
    import dataclasses
    from carla_social_force_model_tpu.api.synthetic import (
        batched_crowds, synthetic_crowd)
    from carla_social_force_model_tpu.parallel.sweeps import (
        make_sharded_ensemble_rollout)

    b, n, steps = 4, 24, 10
    scene1, params, cfg, _ = benchmark_bundle(n, extent=12.0)
    scene = dataclasses.replace(scene1, spawn=batched_crowds(b, n, extent=12.0))

    mesh = make_mesh(n_agent_shards=4, n_batch_shards=2)
    finals, recs = make_sharded_ensemble_rollout(
        mesh, scene, params, cfg, steps, record=True)()
    assert np.asarray(finals.pos).shape == (b, n, 2)

    for row in range(b):
        s_row = dataclasses.replace(
            scene1, spawn=synthetic_crowd(n, extent=12.0, seed=row))
        f_row, r_row = make_rollout_fn(s_row, params, cfg, steps,
                                       record=True)(PedState.empty(n))
        np.testing.assert_array_equal(np.asarray(recs.alive)[row],
                                      np.asarray(r_row.alive))
        np.testing.assert_allclose(np.asarray(finals.pos)[row],
                                   np.asarray(f_row.pos), atol=2e-5)
        np.testing.assert_allclose(np.asarray(recs.pos)[row],
                                   np.asarray(r_row.pos), atol=2e-5)


def test_sharded_ensemble_2d_mesh_pallas_cutoff_ring():
    """The FUSED PALLAS kernel on the composed dp x tp mesh: rollouts
    sharded over ``batch`` AND slots sharded over ``agents`` with the
    Morton-sorted cutoff and ppermute-ring column comm, every row equal to
    a single-device Pallas rollout of the same crowd.  Closes the round-4
    gap where the 2D-mesh tests resolved ``use_pallas=None`` to the jnp
    path on CPU (api/synthetic.py benchmark_bundle) and the production
    claim had no test behind it."""
    import dataclasses
    from carla_social_force_model_tpu.api.synthetic import (
        batched_crowds, synthetic_crowd)
    from carla_social_force_model_tpu.parallel.sweeps import (
        make_sharded_ensemble_rollout)

    b, n, steps = 2, 48, 10
    scene1, params, cfg, _ = benchmark_bundle(n, extent=15.0)
    cfg_p = dataclasses.replace(
        cfg, use_pallas=True, interaction_cutoff=500.0, axis_comm="ring",
        pallas_row_tile=8, pallas_col_tile=128, pallas_interpret=True)
    scene = dataclasses.replace(scene1, spawn=batched_crowds(b, n, extent=15.0))

    mesh = make_mesh(n_agent_shards=4, n_batch_shards=2)
    finals, recs = make_sharded_ensemble_rollout(
        mesh, scene, params, cfg_p, steps, record=True)()
    assert np.asarray(finals.pos).shape == (b, n, 2)

    for row in range(b):
        s_row = dataclasses.replace(
            scene1, spawn=synthetic_crowd(n, extent=15.0, seed=row))
        f_row, r_row = make_rollout_fn(s_row, params, cfg_p, steps,
                                       record=True)(PedState.empty(n))
        np.testing.assert_array_equal(np.asarray(recs.alive)[row],
                                      np.asarray(r_row.alive))
        np.testing.assert_allclose(np.asarray(finals.pos)[row],
                                   np.asarray(f_row.pos), atol=5e-5)
        np.testing.assert_allclose(np.asarray(recs.pos)[row],
                                   np.asarray(r_row.pos), atol=5e-5)


def test_sharded_ensemble_ring_comm_and_padding():
    """The 2D ensemble with ppermute-ring column comm (collectives scoped to
    the agents axis never cross batch rows) and a capacity that needs
    padding to the agents axis."""
    import dataclasses
    from carla_social_force_model_tpu.api.synthetic import (
        batched_crowds, synthetic_crowd)
    from carla_social_force_model_tpu.parallel.sweeps import (
        make_sharded_ensemble_rollout)

    b, n, steps = 2, 22, 8  # capacity 22 pads to 24 over the 4 agent shards
    scene1, params, cfg, _ = benchmark_bundle(n, extent=12.0)
    cfg = dataclasses.replace(cfg, axis_comm="ring")
    scene = dataclasses.replace(scene1, spawn=batched_crowds(b, n, extent=12.0))

    mesh = make_mesh(n_agent_shards=4, n_batch_shards=2)
    finals, _ = make_sharded_ensemble_rollout(
        mesh, scene, params, cfg, steps)()
    pos = np.asarray(finals.pos)
    alive = np.asarray(finals.alive)
    assert pos.shape == (b, 24, 2) and not alive[:, n:].any()

    for row in range(b):
        s_row = dataclasses.replace(
            scene1, spawn=synthetic_crowd(n, extent=12.0, seed=row))
        f_row, _ = make_rollout_fn(s_row, params, cfg, steps)(PedState.empty(n))
        np.testing.assert_allclose(pos[row, :n], np.asarray(f_row.pos),
                                   atol=3e-5)


def test_multichip_scaling_example_runs():
    """Run in a clean subprocess (real CLI usage; in-process reuse after
    mixed-mesh tests trips a jax-internal sharding-cache assert)."""
    import os
    import subprocess
    import sys
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ,
               JAX_PLATFORMS="cpu",
               XLA_FLAGS=(os.environ.get("XLA_FLAGS", "")
                          + " --xla_force_host_platform_device_count=8"))
    r = subprocess.run(
        [sys.executable, os.path.join(repo, "examples", "multichip_scaling.py"),
         "--n", "256", "--steps", "6", "--interpret"],
        capture_output=True, text=True, timeout=420, env=env, cwd=repo)
    assert r.returncode == 0, r.stderr[-800:]
    assert "agent-steps/s" in r.stdout
