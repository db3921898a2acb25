"""Per-agent pair-interaction sensitivity (SpawnSchedule.pair_scale).

Beyond-reference crowd heterogeneity: F_i = s_i * sum_j g_ij scales the
interaction force each agent FEELS (row-wise, after the pairwise sum), so
it is exact on every kernel path (the kernels return the full unscaled
per-row sum first).
"""
import dataclasses

import jax.numpy as jnp
import numpy as np

from carla_social_force_model_tpu.api.synthetic import benchmark_bundle
from carla_social_force_model_tpu.models.spawn import apply_spawn
from carla_social_force_model_tpu.models.state import PedState
from carla_social_force_model_tpu.models.stepper import (force_terms,
                                                         make_rollout_fn)


def _bundle(n=24, **kw):
    scene, params, cfg, state = benchmark_bundle(n, extent=8.0,
                                                 use_pallas=False, **kw)
    return scene, params, cfg, state


def _live_state(scene):
    return apply_spawn(PedState.empty(scene.spawn.capacity), scene.spawn, 0)


def _with_scale(scene, scale):
    spawn = dataclasses.replace(scene.spawn,
                                pair_scale=jnp.asarray(scale, jnp.float32))
    return dataclasses.replace(scene, spawn=spawn)


def test_scale_is_exact_rowwise_multiplier():
    scene, params, cfg, _ = _bundle()
    st = _live_state(scene)
    base = force_terms(st, scene, params, cfg, None)["pedestrian_force"]
    scale = np.linspace(0.0, 2.0, scene.spawn.capacity).astype(np.float32)
    scaled = force_terms(st, _with_scale(scene, scale), params, cfg,
                         None)["pedestrian_force"]
    np.testing.assert_array_equal(np.asarray(scaled[0]),
                                  np.asarray(base[0]) * scale)
    np.testing.assert_array_equal(np.asarray(scaled[1]),
                                  np.asarray(base[1]) * scale)
    # the acceleration term is untouched
    acc0 = force_terms(st, scene, params, cfg, None)["acceleration_force"]
    acc1 = force_terms(st, _with_scale(scene, scale), params, cfg,
                       None)["acceleration_force"]
    np.testing.assert_array_equal(np.asarray(acc0[0]), np.asarray(acc1[0]))


def test_oblivious_agent_is_still_avoided():
    """scale = 0: the agent ignores the crowd, the crowd still avoids it
    (heterogeneity is one-sided by construction)."""
    scene, params, cfg, _ = _bundle()
    st = _live_state(scene)
    scale = np.ones(scene.spawn.capacity, np.float32)
    scale[0] = 0.0
    t = force_terms(st, _with_scale(scene, scale), params, cfg,
                    None)["pedestrian_force"]
    base = force_terms(st, scene, params, cfg, None)["pedestrian_force"]
    assert float(t[0][0]) == 0.0 and float(t[1][0]) == 0.0
    np.testing.assert_array_equal(np.asarray(t[0])[1:],
                                  np.asarray(base[0])[1:])


def test_scale_composes_with_pallas_cutoff():
    scene, params, cfg, state = _bundle()
    scale = np.linspace(0.2, 1.8, scene.spawn.capacity).astype(np.float32)
    scene_s = _with_scale(scene, scale)
    cfg_p = dataclasses.replace(cfg, use_pallas=True, pallas_interpret=True,
                                pallas_row_tile=8, pallas_col_tile=128,
                                interaction_cutoff=30.0)
    run_j = make_rollout_fn(scene_s, params, cfg, 20)
    run_p = make_rollout_fn(scene_s, params, cfg_p, 20)
    _, rec_j = run_j(state)
    _, rec_p = run_p(state)
    np.testing.assert_allclose(np.asarray(rec_p.pos), np.asarray(rec_j.pos),
                               atol=5e-5)
    # and the scaled rollout actually differs from the homogeneous one
    _, rec_0 = make_rollout_fn(scene, params, cfg, 20)(state)
    assert np.abs(np.asarray(rec_j.pos) - np.asarray(rec_0.pos)).max() > 1e-4


def test_scale_applies_to_other_families():
    scene, params, cfg, _ = _bundle()
    st = _live_state(scene)
    scale = np.full(scene.spawn.capacity, 0.5, np.float32)
    for flag, term in (("enable_powerlaw", "powerlaw_force"),
                       ("enable_ped_repulsive", "ped_repulsive_force")):
        p = dataclasses.replace(params, enable_pedestrian=False, **{flag: True})
        base = force_terms(st, scene, p, cfg, None)[term]
        scaled = force_terms(st, _with_scale(scene, scale), p, cfg, None)[term]
        np.testing.assert_allclose(np.asarray(scaled[0]),
                                   np.asarray(base[0]) * 0.5, rtol=1e-6)


def test_toml_surface_and_draw_parity():
    """interaction_scale / variate_interaction parse from a spawner; the
    jitter rides a dedicated stream, so enabling it does NOT shift the
    reference-parity speed draws."""
    from carla_social_force_model_tpu.api.scenario import build_scenario

    def scenario(**extra):
        return {
            "scenario_name": "het", "step_length": 0.05,
            "walker": {"variate_speed": 0.2, "pedestrian_seed": 7,
                       "ped_spawner": [
                           {"spawn_location": [0.0, 0.0, 1.0],
                            "destination": [20.0, 0.0, 0.0],
                            "speed": 1.3, "quantity": 6,
                            "spawn_interval": 0.3, **extra}]},
        }

    sfm = {"forces": {"acceleration_force": True, "pedestrian_force": True}}
    plain = build_scenario(scenario(), sfm, 50)
    het = build_scenario(scenario(interaction_scale=0.6,
                                  variate_interaction=0.3), sfm, 50)
    assert plain.scene.spawn.pair_scale is None
    ps = np.asarray(het.scene.spawn.pair_scale)
    assert ((ps >= 0.3 - 1e-6) & (ps <= 0.9 + 1e-6)).all()
    assert np.unique(ps).size > 1       # jitter actually drew
    # parity: the reference-seeded speed jitter is identical
    np.testing.assert_array_equal(np.asarray(plain.scene.spawn.speed),
                                  np.asarray(het.scene.spawn.speed))
    # and the rollout runs end to end with the scale active
    from carla_social_force_model_tpu.api.simulation import Simulation
    _, rec = Simulation(het).run()
    assert np.isfinite(np.asarray(rec.pos)).all()


def test_mixed_model_crowd_matches_row_masked_families():
    """law_id: a half-Moussaid / half-powerlaw crowd equals the two
    single-family runs row-masked together."""
    scene, params, cfg, _ = _bundle()
    st = _live_state(scene)
    cap = scene.spawn.capacity
    law = np.full(cap, -1, np.int32)
    law[: cap // 2] = 0                      # Moussaid rows
    law[cap // 2:] = 1                       # power-law rows
    spawn = dataclasses.replace(scene.spawn, law_id=jnp.asarray(law))
    scene_m = dataclasses.replace(scene, spawn=spawn)
    p_both = dataclasses.replace(params, enable_powerlaw=True)

    mixed = force_terms(st, scene_m, p_both, cfg, None)
    mou = force_terms(st, scene, params, cfg, None)["pedestrian_force"]
    pl_only = dataclasses.replace(params, enable_pedestrian=False,
                                  enable_powerlaw=True)
    pwr = force_terms(st, scene, pl_only, cfg, None)["powerlaw_force"]

    m0 = (law == 0).astype(np.float32)
    m1 = (law == 1).astype(np.float32)
    np.testing.assert_array_equal(np.asarray(mixed["pedestrian_force"][0]),
                                  np.asarray(mou[0]) * m0)
    np.testing.assert_array_equal(np.asarray(mixed["powerlaw_force"][0]),
                                  np.asarray(pwr[0]) * m1)
    # -1 rows (none here) would feel both; each agent sums over ALL
    # partners through its own law, so the Moussaid rows' force is the
    # full-crowd Moussaid row sum, not a within-family one
    assert np.abs(np.asarray(mou[0]) * m0).max() > 0


def test_mixed_model_toml_and_validation():
    from carla_social_force_model_tpu.api.scenario import build_scenario
    import pytest

    def scenario(pair_force=None):
        extra = {"pair_force": pair_force} if pair_force else {}
        return {
            "scenario_name": "mixed", "step_length": 0.05,
            "walker": {"ped_spawner": [
                {"spawn_location": [0.0, 0.0, 1.0],
                 "destination": [20.0, 0.0, 0.0], "speed": 1.3,
                 "quantity": 3, "spawn_interval": 0.3},
                {"spawn_location": [20.0, 1.0, 1.0],
                 "destination": [-20.0, 1.0, 0.0], "speed": 1.3,
                 "quantity": 3, "spawn_interval": 0.3, **extra}]},
        }

    sfm = {"forces": {"acceleration_force": True, "pedestrian_force": True,
                      "powerlaw_force": True}}
    b = build_scenario(scenario("powerlaw"), sfm, 60)
    law = np.asarray(b.scene.spawn.law_id)
    assert set(np.unique(law)) == {-1, 1}
    from carla_social_force_model_tpu.api.simulation import Simulation
    _, rec = Simulation(b).run()
    assert np.isfinite(np.asarray(rec.pos)).all()

    # requesting a disabled family fails at build time with the flag name
    sfm_no = {"forces": {"acceleration_force": True,
                         "pedestrian_force": True}}
    with pytest.raises(ValueError, match="powerlaw_force"):
        build_scenario(scenario("powerlaw"), sfm_no, 60)
    # unknown family name fails in the schedule builder ("orca" used to be
    # the example here until it became a real family, ops/orca.py)
    with pytest.raises(ValueError, match="pair_force must be one of"):
        build_scenario(scenario("boids"), sfm, 60)
    # a real but disabled velocity-law family also names its flag
    with pytest.raises(ValueError, match="orca_law"):
        build_scenario(scenario("orca"), sfm, 60)
