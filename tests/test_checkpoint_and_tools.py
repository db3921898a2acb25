"""Checkpoint/resume exactness, segmented rollouts, visualization smoke."""
import os

import numpy as np
import pytest

from carla_social_force_model_tpu.api.synthetic import benchmark_bundle
from carla_social_force_model_tpu.models.state import PedState
from carla_social_force_model_tpu.models.stepper import make_rollout_fn
from carla_social_force_model_tpu.utils.checkpoint import (
    latest_checkpoint, load_state, run_segmented, save_state)


def test_segmented_rollout_bit_equal_and_resumable(tmp_path):
    n, steps = 24, 60
    scene, params, cfg, state = benchmark_bundle(n, extent=12.0)

    run = make_rollout_fn(scene, params, cfg, steps, record=True)
    final_full, recs_full = run(state)

    ckpt_dir = str(tmp_path / "ckpts")
    final_seg, recs_seg = run_segmented(
        state, scene, params, cfg, steps, segment_steps=17,
        checkpoint_dir=ckpt_dir)

    np.testing.assert_array_equal(np.asarray(final_full.pos),
                                  np.asarray(final_seg.pos))
    np.testing.assert_array_equal(np.asarray(recs_full.pos),
                                  np.asarray(recs_seg.pos))
    np.testing.assert_array_equal(np.asarray(recs_full.mode),
                                  np.asarray(recs_seg.mode))

    # resume from the checkpoint at step 34 and finish: identical final state
    ckpt = os.path.join(ckpt_dir, "ckpt_00000034.npz")
    assert os.path.exists(ckpt)
    mid_state, step = load_state(ckpt)
    assert step == 34
    final_resumed, _ = run_segmented(mid_state, scene, params, cfg,
                                     steps - step, segment_steps=100,
                                     start_step=step, record=False)
    np.testing.assert_array_equal(np.asarray(final_full.pos),
                                  np.asarray(final_resumed.pos))
    assert latest_checkpoint(ckpt_dir).endswith("ckpt_00000060.npz")


def test_segmented_autopilot_fleet_resume(tmp_path):
    """Reactive-fleet rollouts checkpoint/resume bit-exactly: the
    AutopilotState rides in the snapshot, so resumed vehicles continue
    mid-route instead of restarting from their origins."""
    from carla_social_force_model_tpu.api.simulation import Simulation
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    b = Simulation.from_config(
        os.path.join(repo, "configs/scenarios/jaywalking_reactive.toml"),
        os.path.join(repo, "configs/sfm.toml"), duration=8.0).bundle
    assert b.scene.autopilot is not None
    steps = b.num_steps

    final_full, (recs_full, veh_full) = run_segmented(
        b.initial_state, b.scene, b.params, b.cfg, steps,
        segment_steps=steps)

    ckpt_dir = str(tmp_path / "ckpts")
    final_seg, (recs_seg, veh_seg) = run_segmented(
        b.initial_state, b.scene, b.params, b.cfg, steps,
        segment_steps=45, checkpoint_dir=ckpt_dir)
    np.testing.assert_array_equal(np.asarray(final_full.pos),
                                  np.asarray(final_seg.pos))
    np.testing.assert_array_equal(np.asarray(recs_full.pos),
                                  np.asarray(recs_seg.pos))
    np.testing.assert_array_equal(np.asarray(veh_full.pos),
                                  np.asarray(veh_seg.pos))

    ckpt = os.path.join(ckpt_dir, "ckpt_00000090.npz")
    assert os.path.exists(ckpt)
    mid_state, step, ap = load_state(ckpt, with_autopilot=True)
    assert step == 90 and ap is not None
    final_resumed, _ = run_segmented(
        mid_state, b.scene, b.params, b.cfg, steps - step,
        segment_steps=1000, start_step=step, record=False,
        autopilot_state=ap)
    np.testing.assert_array_equal(np.asarray(final_full.pos),
                                  np.asarray(final_resumed.pos))

    # resuming without the fleet state is refused, not silently wrong
    import pytest
    with pytest.raises(ValueError, match="autopilot_state"):
        run_segmented(mid_state, b.scene, b.params, b.cfg, 10,
                      segment_steps=10, start_step=step, record=False)


def test_save_load_roundtrip(tmp_path):
    state = PedState.empty(7)
    p = save_state(str(tmp_path / "s.npz"), state, 123)
    loaded, step = load_state(p)
    assert step == 123
    np.testing.assert_array_equal(np.asarray(loaded.pos), np.asarray(state.pos))


def test_orbax_backend_roundtrip_and_resume(tmp_path):
    """The orbax backend saves/loads the same payload as npz, and a
    resumed run reads a mixed npz/orbax checkpoint directory."""
    pytest.importorskip("orbax.checkpoint")
    n, steps = 16, 30
    scene, params, cfg, state = benchmark_bundle(n, extent=10.0)
    run = make_rollout_fn(scene, params, cfg, steps, record=False)
    final_full, _ = run(state)

    ckpt_dir = str(tmp_path / "ckpts")
    final_seg, _ = run_segmented(state, scene, params, cfg, steps,
                                 segment_steps=10, checkpoint_dir=ckpt_dir,
                                 record=False, backend="orbax")
    np.testing.assert_array_equal(np.asarray(final_full.pos),
                                  np.asarray(final_seg.pos))

    ckpt = latest_checkpoint(ckpt_dir)
    assert ckpt.endswith("ckpt_00000030.orbax") and os.path.isdir(ckpt)
    loaded, step = load_state(ckpt)
    assert step == 30
    np.testing.assert_array_equal(np.asarray(loaded.pos),
                                  np.asarray(final_seg.pos))

    # mixed-format directory: newest snapshot wins regardless of format
    mid = os.path.join(ckpt_dir, "ckpt_00000020.orbax")
    mid_state, mid_step = load_state(mid)
    final_resumed, _ = run_segmented(mid_state, scene, params, cfg,
                                     steps - mid_step, segment_steps=100,
                                     start_step=mid_step, record=False)
    np.testing.assert_array_equal(np.asarray(final_full.pos),
                                  np.asarray(final_resumed.pos))

    save_state(os.path.join(ckpt_dir, "ckpt_00000031.npz"), final_seg, 31)
    assert latest_checkpoint(ckpt_dir).endswith("ckpt_00000031.npz")


def test_orbax_backend_missing_names_the_package(tmp_path, monkeypatch):
    """Without orbax installed the orbax backend fails with a message that
    names the package and the npz alternative."""
    import sys
    monkeypatch.setitem(sys.modules, "orbax", None)
    monkeypatch.setitem(sys.modules, "orbax.checkpoint", None)
    scene, params, cfg, state = benchmark_bundle(8, extent=8.0)
    with pytest.raises(ImportError, match="orbax-checkpoint.*npz"):
        save_state(str(tmp_path / "ckpt_00000001.orbax"), state, 1)


def test_animate_trajectories(tmp_path):
    """The headless animation viewer renders a GIF from records (and from
    a run's CSV output via the viz CLI)."""
    from carla_social_force_model_tpu.utils.visualize import (
        animate_trajectories)
    n, steps = 8, 24
    scene, params, cfg, state = benchmark_bundle(n, extent=8.0)
    run = make_rollout_fn(scene, params, cfg, steps, record=True)
    _, recs = run(state)
    out = animate_trajectories(recs, str(tmp_path / "run.gif"),
                               stride=4, fps=10, dt=cfg.dt)
    assert os.path.getsize(out) > 2000


def test_viz_cli_animate_from_csv(tmp_path):
    """CSV -> dense records reconstruction -> GIF, incl. the vehicle
    fleet rectangles, on a reactive-fleet scenario run."""
    from carla_social_force_model_tpu.api.cli import main as cli_main
    from carla_social_force_model_tpu.utils.viz_cli import main as viz_main
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    outdir = str(tmp_path / "out")
    assert cli_main([
        "--scenario-config",
        os.path.join(repo, "configs/scenarios/jaywalking_reactive.toml"),
        "--duration", "4", "--csv", "--output", outdir]) == 0
    run_dir = os.path.join(outdir, os.listdir(outdir)[0])
    gif = tmp_path / "run.gif"
    assert viz_main(["animate", "--csv-dir", run_dir, "--out", str(gif),
                     "--stride", "8", "--fps", "10"]) == 0
    assert os.path.getsize(gif) > 2000


def test_viz_cli_metrics_report(tmp_path, capsys):
    """`viz_cli metrics` emits one JSON crowd-analysis report from a run's
    pedestrian.csv (utils/metrics.py definitions): population/speed
    summaries plus gate flow and window density when asked."""
    import json
    from carla_social_force_model_tpu.utils.csvout import write_pedestrian_csv
    from carla_social_force_model_tpu.utils.viz_cli import main as viz_main
    n, steps = 16, 220
    scene, params, cfg, state = benchmark_bundle(n, extent=8.0)
    run = make_rollout_fn(scene, params, cfg, steps, record=True)
    _, recs = run(state)
    csv_dir = tmp_path / "run"
    csv_dir.mkdir()
    write_pedestrian_csv(str(csv_dir / "pedestrian.csv"), recs, cfg.dt)
    assert viz_main(["metrics", "--csv-dir", str(csv_dir),
                     "--gate", "0,-12,0,12",
                     "--region=-8,8,-8,8"]) == 0
    report = json.loads(capsys.readouterr().out)
    assert report["pedestrians"] == n
    assert report["frames"] == steps
    assert abs(report["dt"] - cfg.dt) < 1e-6
    assert 0.0 < report["mean_speed"] <= report["peak_speed"] < 4.0
    # the antipodal benchmark crowd converges on the center: the full
    # population crosses the x=0 gate at least once
    assert report["gate"]["total"] >= n // 2
    assert report["gate"]["rate"] > 0
    assert report["region"]["mean_density"] > 0
    assert report["region"]["fundamental_diagram"]


def test_plot_outputs(tmp_path):
    from carla_social_force_model_tpu.utils.visualize import (
        plot_nav_graph, plot_trajectories)
    from test_routing import city_block_graph
    g = city_block_graph()
    out1 = plot_nav_graph(g, str(tmp_path / "graph.png"))
    assert os.path.getsize(out1) > 1000

    n, steps = 8, 30
    scene, params, cfg, state = benchmark_bundle(n, extent=8.0)
    run = make_rollout_fn(scene, params, cfg, steps, record=True)
    _, recs = run(state)
    out2 = plot_trajectories(recs, str(tmp_path / "traj.png"))
    assert os.path.getsize(out2) > 1000


def test_random_pedestrians_build():
    from carla_social_force_model_tpu.api.scenario import build_scenario
    from carla_social_force_model_tpu.routing.planner import PedPathPlanner
    from test_routing import city_block_graph
    planner = PedPathPlanner(city_block_graph())
    scenario = {
        "step_length": 0.05,
        "walker": {"random_pedestrians": 5, "pedestrian_seed": 7},
    }
    sfm = {"forces": {"acceleration_force": True, "pedestrian_force": True}}
    bundle = build_scenario(scenario, sfm, num_steps=20, planner=planner)
    assert bundle.capacity == 5
    assert int(np.asarray(bundle.scene.spawn.routes.count).min()) >= 1


def test_viz_cli_graph_from_npz(tmp_path):
    from carla_social_force_model_tpu.utils.viz_cli import main
    from test_routing import city_block_graph
    g = city_block_graph()
    npz = tmp_path / "g.npz"
    g.save_npz(npz)
    out = tmp_path / "g.png"
    assert main(["graph", "--npz", str(npz), "--out", str(out)]) == 0
    assert os.path.getsize(out) > 1000


def test_load_pre_planar_checkpoint(tmp_path):
    """Snapshots written before the planar-state layout (state__pos (N,2)
    etc.) load transparently: coordinates migrate into the x/y planes."""
    rng = np.random.default_rng(3)
    n = 9
    payload = {
        "state__pos": rng.uniform(-5, 5, (n, 2)).astype(np.float32),
        "state__vel": rng.uniform(-1, 1, (n, 2)).astype(np.float32),
        "state__waypoint": rng.uniform(-5, 5, (n, 2)).astype(np.float32),
        "state__radius": np.full((n,), 0.3, np.float32),
        "state__base_speed": np.full((n,), 1.2, np.float32),
        "state__crossing_speed": np.full((n,), 1.8, np.float32),
        "state__safety_margin": np.full((n,), 1.5, np.float32),
        "state__fsm_target": np.full((n,), 1.2, np.float32),
        "state__applied_target": np.full((n,), 1.2, np.float32),
        "state__mode": np.ones((n,), np.int32),
        "state__next_mode_time": np.full((n,), -1.0, np.float32),
        "state__waypoint_idx": np.zeros((n,), np.int32),
        "state__alive": np.ones((n,), bool),
        "state__spawned": np.ones((n,), bool),
        "step": np.asarray(77, np.int64),
    }
    p = str(tmp_path / "old.npz")
    np.savez_compressed(p, **payload)
    state, step = load_state(p)
    assert step == 77
    np.testing.assert_array_equal(np.asarray(state.pos),
                                  payload["state__pos"])
    np.testing.assert_array_equal(np.asarray(state.waypoint),
                                  payload["state__waypoint"])
    np.testing.assert_array_equal(np.asarray(state.vel_y),
                                  payload["state__vel"][:, 1])


def test_load_pre_overtaking_fleet_checkpoint(tmp_path):
    """Fleet snapshots written before the overtaking fields (round 4:
    lane_off / overtaking) restore with both at their rest values."""
    import jax.numpy as jnp
    from carla_social_force_model_tpu.models.autopilot import AutopilotState

    scene, params, cfg, state = benchmark_bundle(6, extent=8.0)[0:4]
    ap = AutopilotState(
        pos=jnp.zeros((2, 2)), heading=jnp.zeros((2,)),
        speed=jnp.asarray([3.0, 0.0]), wp_idx=jnp.ones((2,), jnp.int32),
        active=jnp.asarray([True, False]),
        lane_off=jnp.zeros((2,)), overtaking=jnp.zeros((2,), bool))
    p = save_state(str(tmp_path / "ck.npz"), state, 12, autopilot=ap)
    data = dict(np.load(p))
    del data["ap__lane_off"], data["ap__overtaking"]   # pre-round-4 layout
    np.savez_compressed(p, **data)

    _, step, ap2 = load_state(p, with_autopilot=True)
    assert step == 12
    np.testing.assert_array_equal(np.asarray(ap2.speed), [3.0, 0.0])
    assert np.asarray(ap2.lane_off).shape == (2,)
    assert (np.asarray(ap2.lane_off) == 0.0).all()
    assert np.asarray(ap2.overtaking).dtype == bool
    assert not np.asarray(ap2.overtaking).any()
