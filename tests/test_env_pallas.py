"""Fused environment-force kernel (ops/pallas_env.py) vs the jnp path.

The fused kernel computes per-section closest points and force
accumulation in one pass over a section-major layout; these tests pin its
equivalence to the reference-parity jnp formulation (ops/forces.py) in the
Pallas interpreter, including dead pedestrians, crossing-mode masking,
filter circles, inactive vehicles, and ragged section sizes
(tests/test_gpu_kernels.py runs it compiled on the card).
"""
import dataclasses

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from carla_social_force_model_tpu.env.borders import build_border_set
from carla_social_force_model_tpu.env.obstacles_gen import build_obstacle_set
from carla_social_force_model_tpu.env.pointsets import segment_major
from carla_social_force_model_tpu.models import modes
from carla_social_force_model_tpu.models.params import SfmParams
from carla_social_force_model_tpu.models.state import PedState
from carla_social_force_model_tpu.models.stepper import (
    Scene, StepConfig, force_terms, prepare_scene)
from carla_social_force_model_tpu.models.vehicles import (
    VehicleSpec, build_vehicle_states, vehicle_snapshot_at)
from carla_social_force_model_tpu.ops import forces
from carla_social_force_model_tpu.ops.pallas_env import (
    fused_environment_terms)

RNG = np.random.default_rng(17)


def _ragged_borders():
    """Borders with ragged lengths (1 chunk to several), varying filters."""
    lines = [
        np.column_stack([np.linspace(-20, 20, 401), np.full(401, 6.0)]),
        np.column_stack([np.linspace(-20, 5, 120), np.full(120, -6.0)]),
        np.column_stack([np.full(30, 0.0), np.linspace(-5, 5, 30)]),
    ]
    centers = [l[len(l) // 2] for l in lines]
    lengths = [25.0, 14.0, 6.0]
    return build_border_set(lines, centers, lengths)


def _obstacles():
    from carla_social_force_model_tpu.models.vehicles import ellipse_template
    outlines, centers = [], []
    for cx, cy in [(-8.0, 2.0), (3.0, -3.0), (12.0, 4.0)]:
        outlines.append(ellipse_template(2.4, 1.1, 0.1) + np.array([cx, cy]))
        centers.append(np.array([cx, cy]))
    return build_obstacle_set(outlines, centers, perception_threshold=10.0)


def _state(n=97, dead_frac=0.15, crossing_frac=0.2):
    pos = jnp.asarray(RNG.uniform(-22, 22, (n, 2)), jnp.float32)
    vel = jnp.asarray(RNG.uniform(-2, 2, (n, 2)), jnp.float32)
    radius = jnp.asarray(RNG.uniform(0.2, 0.4, (n,)), jnp.float32)
    alive = jnp.asarray(RNG.uniform(size=n) > dead_frac)
    mode = jnp.where(jnp.asarray(RNG.uniform(size=n) < crossing_frac),
                     modes.CROSSING_ROAD, modes.WALKING_SIDEWALK)
    st = PedState.empty(n)
    return st.replace_coords(pos=pos, vel=vel, radius=radius,
                             alive=alive, mode=mode)


def _scene(with_vehicles=True):
    borders = _ragged_borders()
    statics = _obstacles()
    vehicles = None
    if with_vehicles:
        traj = np.column_stack([np.linspace(-15, 15, 40),
                                np.full(40, -1.0)])
        specs = [VehicleSpec(trajectory=traj, headings=np.zeros(40),
                             speeds=np.full(40, 6.0)),
                 VehicleSpec(trajectory=traj[::-1].copy(),
                             headings=np.full(40, np.pi),
                             speeds=np.full(40, 4.0), spawn_time=0.5)]
        vehicles = build_vehicle_states(specs, 0.05, num_steps=30)
    scene = Scene(spawn=None, borders=borders, static_obstacles=statics,
                  static_obstacle_vel=jnp.zeros((statics.num_segments, 2),
                                                jnp.float32),
                  vehicles=vehicles)
    return prepare_scene(scene)


@pytest.mark.parametrize("use_radius", [False, True])
def test_fused_terms_match_jnp(use_radius):
    scene = _scene()
    state = _state()
    params = SfmParams(enable_border=True, enable_static_obstacle=True,
                       enable_dynamic_obstacle=True,
                       enable_space_repulsive=True,
                       use_ped_radius=use_radius)
    snap = vehicle_snapshot_at(scene.vehicles, jnp.asarray(12))

    got = fused_environment_terms(state, scene, params, snap,
                                  ped_tile=128, interpret=True)
    assert set(got) == {"border_force", "space_repulsive_force",
                        "static_obstacle_force", "dynamic_obstacle_force"}

    want = {
        "border_force": forces.border_force(
            state.pos, state.mode, state.radius, state.alive, scene.borders,
            params.border, use_ped_radius=use_radius),
        "space_repulsive_force": forces.space_repulsive_force(
            state.pos, state.mode, state.alive, scene.borders,
            params.space_repulsive),
    }
    from carla_social_force_model_tpu.models.vehicles import snapshot_pointset
    vset, vvel, vact = snapshot_pointset(
        snap, params.dynamic_obstacle.perception_threshold)
    want["static_obstacle_force"] = forces.obstacle_force(
        state.pos, state.vel, state.radius, state.alive,
        scene.static_obstacles, scene.static_obstacle_vel,
        params.static_obstacle, use_ped_radius=use_radius)
    want["dynamic_obstacle_force"] = forces.obstacle_force(
        state.pos, state.vel, state.radius, state.alive, vset, vvel,
        params.dynamic_obstacle, use_ped_radius=use_radius,
        obstacle_active=vact)

    for name in want:
        got_f = np.stack([np.asarray(a) for a in got[name]], axis=-1)
        np.testing.assert_allclose(
            got_f, np.asarray(want[name]),
            rtol=3e-5, atol=3e-5, err_msg=name)
        # dead pedestrians feel nothing (staged at the far sentinel)
        assert np.all(got_f[~np.asarray(state.alive)] == 0.0)


def test_fused_terms_via_stepper_dispatch():
    """force_terms uses the fused kernels when cfg.use_pallas is set and
    falls back identically when the seg layout is absent."""
    scene = _scene(with_vehicles=False)
    state = _state(n=64)
    params = SfmParams(enable_acceleration=True, enable_pedestrian=True,
                       enable_border=True, enable_static_obstacle=True)
    cfg_ref = StepConfig(use_pallas=False)
    cfg_fused = StepConfig(use_pallas=True, pallas_interpret=True,
                           pallas_row_tile=8, pallas_col_tile=128)

    ref = force_terms(state, scene, params, cfg_ref, None)
    fused = force_terms(state, scene, params, cfg_fused, None)
    assert set(ref) == set(fused)
    for name in ("border_force", "static_obstacle_force"):
        np.testing.assert_allclose(np.asarray(fused[name]),
                                   np.asarray(ref[name]),
                                   rtol=3e-5, atol=3e-5, err_msg=name)

    # without the seg layout the dispatch falls back to the jnp path
    bare = dataclasses.replace(scene, borders_seg=None,
                               static_obstacles_seg=None)
    fb = force_terms(state, bare, params, cfg_fused, None)
    for name in ("border_force", "static_obstacle_force"):
        np.testing.assert_allclose(np.asarray(fb[name]),
                                   np.asarray(ref[name]),
                                   rtol=1e-6, atol=1e-6, err_msg=name)


def test_far_pedestrians_feel_nothing():
    """Tile skipping: pedestrians far outside every filter circle get an
    exactly-zero force (the skip is not an approximation)."""
    scene = _scene(with_vehicles=False)
    n = 32
    st = PedState.empty(n)
    pos = jnp.asarray(RNG.uniform(4000.0, 4100.0, (n, 2)), jnp.float32)
    st = st.replace_coords(
        pos=pos, vel=jnp.zeros((n, 2), jnp.float32),
        radius=jnp.full((n,), 0.3, jnp.float32),
        alive=jnp.ones((n,), bool),
        mode=jnp.full((n,), modes.WALKING_SIDEWALK, jnp.int32))
    params = SfmParams(enable_border=True, enable_static_obstacle=True)
    got = fused_environment_terms(st, scene, params, None,
                                  ped_tile=128, interpret=True)
    assert np.all(np.stack(got["border_force"]) == 0.0)
    assert np.all(np.stack(got["static_obstacle_force"]) == 0.0)


def test_segment_major_roundtrip():
    pset = _ragged_borders()
    seg = segment_major(pset)
    assert seg is not None
    assert seg.num_segments == pset.num_segments
    assert seg.points_per_segment % 128 == 0
    pts = np.asarray(pset.points)
    valid = np.asarray(pset.valid)
    cseg = np.asarray(pset.chunk_segment)
    out = np.asarray(seg.points)
    for s in range(pset.num_segments):
        ref_pts = np.concatenate(
            [pts[c][valid[c]] for c in range(pts.shape[0]) if cseg[c] == s],
            axis=0) if (cseg == s).any() else np.zeros((0, 2))
        np.testing.assert_array_equal(out[s, : len(ref_pts)], ref_pts)
        assert np.all(out[s, len(ref_pts):] >= 1e7)  # padding sentinel

    # over-long segments refuse (fallback to the chunked path)
    assert segment_major(pset, max_points_per_segment=64) is None
    assert segment_major(None) is None


def test_fused_rollout_matches_jnp_rollout():
    """Whole-rollout equivalence through simulation_step (spawn pipeline,
    scripted vehicles, waypoints) between the fused and jnp env paths."""
    import os
    from carla_social_force_model_tpu.api.simulation import Simulation
    from carla_social_force_model_tpu.models.stepper import rollout
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    bundle = Simulation.from_config(
        os.path.join(root, "configs/scenarios/obstacle_evasion.toml"),
        os.path.join(root, "configs/sfm.toml"), duration=2.0).bundle

    scene = prepare_scene(bundle.scene)
    assert scene.static_obstacles_seg is not None
    cfg_ref = bundle.cfg
    cfg_fused = dataclasses.replace(bundle.cfg, use_pallas=True,
                                    pallas_interpret=True,
                                    pallas_row_tile=8, pallas_col_tile=128)
    steps = 40
    f_ref, rec_ref = jax.jit(
        lambda s: rollout(s, scene, bundle.params, cfg_ref, steps))(
            bundle.initial_state)
    f_fused, rec_fused = jax.jit(
        lambda s: rollout(s, scene, bundle.params, cfg_fused, steps))(
            bundle.initial_state)
    np.testing.assert_allclose(np.asarray(f_fused.pos),
                               np.asarray(f_ref.pos), rtol=2e-4, atol=2e-4)
    np.testing.assert_array_equal(np.asarray(rec_fused.alive),
                                  np.asarray(rec_ref.alive))


def _grid_borders(n_rows=3, n_sections=40, section_m=10.0):
    """Many short wall sections in rows far apart: most (section, ped
    tile) pairs are skipped by the filter-circle test."""
    lines, centers, lengths = [], [], []
    for y in np.linspace(-200.0, 200.0, n_rows):
        for k in range(n_sections):
            x0 = -200.0 + k * section_m
            xs = np.arange(x0, x0 + section_m, 0.1)
            lines.append(np.column_stack([xs, np.full(len(xs), y)]))
            centers.append(lines[-1][len(xs) // 2])
            lengths.append(12.0)
    return build_border_set(lines, centers, lengths)


def _clustered_state(n=97):
    """Pedestrians clustered near the middle wall row, so each ped tile
    touches only a few sections."""
    rng = np.random.default_rng(5)
    pos = jnp.asarray(np.column_stack([rng.uniform(-30, 30, n),
                                       rng.uniform(-6, 6, n)]), jnp.float32)
    st = PedState.empty(n)
    return st.replace_coords(
        pos=pos, vel=jnp.asarray(rng.uniform(-2, 2, (n, 2)), jnp.float32),
        radius=jnp.full((n,), 0.3, jnp.float32),
        alive=jnp.asarray(rng.uniform(size=n) > 0.1),
        mode=jnp.full((n,), modes.WALKING_SIDEWALK, jnp.int32))


def test_sparse_grid_skip_matches_jnp():
    """The section skip is exact on a sparse grid: the kernel (most
    section/tile pairs skipped) equals the jnp path (no skip)."""
    scene = prepare_scene(Scene(spawn=None, borders=_grid_borders()))
    state = _clustered_state()
    params = SfmParams(enable_border=True)
    got = fused_environment_terms(state, scene, params, None, ped_tile=32,
                                  interpret=True)
    want = forces.border_force(state.pos, state.mode, state.radius,
                               state.alive, scene.borders, params.border)
    got_f = np.stack([np.asarray(a) for a in got["border_force"]], axis=-1)
    np.testing.assert_allclose(got_f, np.asarray(want), rtol=3e-5, atol=3e-5)
    assert np.abs(got_f).max() > 0.0


def test_env_kernel_padding_and_dead_agents():
    """N not a multiple of the ped tile, dead agents, crossing modes: the
    kernel's staging pads with far sentinels that feel nothing."""
    scene = _scene(with_vehicles=False)
    state = _state(n=45, dead_frac=0.3)
    params = SfmParams(enable_border=True, enable_static_obstacle=True)
    got = fused_environment_terms(state, scene, params, None, ped_tile=32,
                                  point_tile=64, interpret=True)
    want = {"border_force": forces.border_force(
                state.pos, state.mode, state.radius, state.alive,
                scene.borders, params.border),
            "static_obstacle_force": forces.obstacle_force(
                state.pos, state.vel, state.radius, state.alive,
                scene.static_obstacles, scene.static_obstacle_vel,
                params.static_obstacle)}
    for name, w in want.items():
        g = np.stack([np.asarray(a) for a in got[name]], axis=-1)
        np.testing.assert_allclose(g, np.asarray(w), rtol=3e-5, atol=3e-5,
                                   err_msg=name)
        assert np.all(g[~np.asarray(state.alive)] == 0.0)


def test_section_closest_point_matches_chunked():
    """The jnp section-major closest point (the kernel's plain twin) picks
    the same first-occurrence point as the chunked segmented-min path."""
    from carla_social_force_model_tpu.ops.geometry import (
        closest_point_per_segment, section_closest_point)
    pset = _ragged_borders()
    state = _state(n=50)
    d2, cx, cy = section_closest_point(state.pos_x, state.pos_y,
                                       segment_major(pset))
    dist, point, has = closest_point_per_segment(state.pos, pset)
    has = np.asarray(has)
    np.testing.assert_allclose(np.sqrt(np.asarray(d2))[has],
                               np.asarray(dist)[has], rtol=1e-6)
    np.testing.assert_array_equal(np.asarray(cx)[has],
                                  np.asarray(point)[..., 0][has])
    np.testing.assert_array_equal(np.asarray(cy)[has],
                                  np.asarray(point)[..., 1][has])


# ---------------------------------------------------------------------------
# analytic border geometry (env_analytic tier)
# ---------------------------------------------------------------------------

def _analytic_lines():
    """Straight (incl. slanted) walls + one ellipse that will NOT simplify:
    the walls go to the SegmentGeomSet, the ellipse to the sampled rest."""
    from carla_social_force_model_tpu.models.vehicles import ellipse_template
    lines = [
        np.column_stack([np.linspace(-20, 20, 401), np.full(401, 6.0)]),
        np.column_stack([np.linspace(-18, 4, 221),
                         np.linspace(-7, -2, 221)]),      # slanted
        np.column_stack([np.full(80, 2.0), np.linspace(-4, 4, 80)]),
        np.array([[9.0, 9.0]]),                           # single point
        ellipse_template(2.4, 1.1, 0.1) + np.array([-6.0, -9.0]),
    ]
    centers = [l[len(l) // 2] for l in lines]
    lengths = [25.0, 18.0, 9.0, 5.0, 8.0]
    return lines, centers, lengths


def _poly_closest_f64(pts, q):
    """f64 closest point on the piecewise-linear chain through ``pts``."""
    pts = np.asarray(pts, np.float64)
    if pts.shape[0] == 1:
        d = q - pts[0]
        return float(d @ d), pts[0]
    a, b = pts[:-1], pts[1:]
    u = b - a
    l2 = np.einsum("ij,ij->i", u, u)
    t = np.clip(np.einsum("ij,ij->i", q[None, :] - a, u)
                / np.where(l2 > 0, l2, 1.0), 0.0, 1.0)
    c = a + t[:, None] * u
    d2 = np.sum((q[None, :] - c) ** 2, axis=1)
    k = int(np.argmin(d2))
    return float(d2[k]), c[k]


def _sampled_closest_f64(pts, q):
    d2 = np.sum((np.asarray(pts, np.float64) - q) ** 2, axis=1)
    k = int(np.argmin(d2))
    return float(d2[k]), np.asarray(pts[k], np.float64)


def _border_oracle_f64(lines, centers, lengths, state, p, use_radius,
                       analytic_idx):
    """f64 border force: analytic chain distance for ``analytic_idx``
    sections, sampled argmin for the rest (forces.py:138-179 semantics:
    filter circle on the section center, magnitude a*exp(-d/b), direction
    away from the closest point, crossing modes zeroed)."""
    pos = np.asarray(state.pos, np.float64)
    alive = np.asarray(state.alive)
    radius = np.asarray(state.radius, np.float64)
    mode = np.asarray(state.mode)
    n = pos.shape[0]
    f = np.zeros((n, 2))
    # f32 sampling: the kernels see f32 points
    lines32 = [np.asarray(l, np.float32).astype(np.float64) for l in lines]
    pos32 = np.asarray(state.pos, np.float32)
    for si, (line, c, L) in enumerate(zip(lines32, centers, lengths)):
        c32 = np.asarray(c, np.float32)
        r2_32 = np.float32(np.float32(L) * np.float32(L))
        for i in range(n):
            if not alive[i]:
                continue
            # the kernel evaluates the filter circle in f32; replicate it
            # exactly so boundary pedestrians do not flip sides
            fdx = np.float32(c32[0] - pos32[i, 0])
            fdy = np.float32(c32[1] - pos32[i, 1])
            if not np.float32(fdx * fdx + fdy * fdy) < r2_32:
                continue
            if si in analytic_idx:
                d2, cp = _poly_closest_f64(line, pos[i])
            else:
                d2, cp = _sampled_closest_f64(line, pos[i])
            if d2 <= 0.0:
                continue
            d = np.sqrt(d2)
            de = d - (radius[i] if use_radius else 0.0)
            mag = p.a * np.exp(-de / p.b) / d
            f[i] += mag * (pos[i] - cp)
    crossing = (mode == modes.CROSSING_ROAD) | (mode == modes.ROAD_TO_SIDEWALK)
    f[crossing] = 0.0
    return f


def test_analytic_split_geometry():
    """Straight walls simplify to 1 segment, the slanted wall too, the
    single point becomes a degenerate segment, the ellipse stays sampled."""
    from carla_social_force_model_tpu.env.pointsets import analytic_split
    lines, centers, lengths = _analytic_lines()
    pset = build_border_set(lines, centers, lengths)
    gset, rest = analytic_split(pset)
    assert gset is not None and rest is not None
    assert gset.num_segments == 4          # 3 walls + 1 point
    assert rest.num_segments == 1          # the ellipse
    il2 = np.asarray(gset.inv_len2)
    seg_counts = (il2 > 0).sum(axis=1)
    # walls -> exactly 1 live segment; the single point -> 0 (degenerate)
    assert sorted(seg_counts.tolist()) == [0, 1, 1, 1]
    # degenerate row still projects to the point itself
    ax = np.asarray(gset.ax)
    row = int(np.argmin(seg_counts))
    assert ax[row, 0] == np.float32(9.0)
    # filter metadata follows the split
    np.testing.assert_allclose(np.asarray(rest.filter_radius), [8.0])


@pytest.mark.parametrize("use_radius", [False, True])
def test_analytic_border_force_matches_f64_oracle(use_radius):
    """env_analytic=True: fused analytic + sampled-rest terms equal the f64
    oracle (analytic chain distance on simplifiable sections, sampled
    argmin on the rest), incl. filter circles, radii, crossing, dead."""
    lines, centers, lengths = _analytic_lines()
    scene = prepare_scene(Scene(spawn=None,
                                borders=build_border_set(lines, centers,
                                                         lengths)),
                          analytic=True)
    assert scene.borders_geom is not None
    assert scene.borders_seg_rest is not None
    state = _state(n=83)
    params = SfmParams(enable_border=True, use_ped_radius=use_radius)

    got = fused_environment_terms(state, scene, params, None,
                                  ped_tile=128, interpret=True,
                                  analytic=True)
    got_f = np.stack([np.asarray(a) for a in got["border_force"]], axis=-1)
    want = _border_oracle_f64(lines, centers, lengths, state,
                              params.border, use_radius,
                              analytic_idx={0, 1, 2, 3})
    # compare force VECTORS against the per-ped magnitude: the f32 segment
    # projection (cx = ax + t*ux) rounds at the wall-length scale, so the
    # near-zero perpendicular component of a wall-hugging ped carries
    # ~|F| * 1e-6 absolute error (a ~1e-6 rad direction error) that a
    # componentwise atol would flag while the vector is spot on
    err = np.linalg.norm(got_f - want, axis=1)
    lim = 3e-4 * np.linalg.norm(want, axis=1) + 3e-5
    assert np.all(err <= lim), (err / np.maximum(lim, 1e-30)).max()
    assert np.all(got_f[~np.asarray(state.alive)] == 0.0)


@pytest.mark.parametrize("use_radius", [False, True])
def test_jnp_analytic_border_force_matches_f64_oracle(use_radius):
    """env_analytic on the jnp path (use_pallas=False): the clamped
    projection onto the Douglas-Peucker segments plus the sampled rest
    equals the f64 oracle, like the kernel path."""
    lines, centers, lengths = _analytic_lines()
    scene = prepare_scene(Scene(spawn=None,
                                borders=build_border_set(lines, centers,
                                                         lengths)),
                          analytic=True)
    state = _state(n=83)
    params = SfmParams(enable_border=True, use_ped_radius=use_radius)
    cfg = StepConfig(use_pallas=False, env_analytic=True)
    got = force_terms(state, scene, params, cfg, None)
    got_f = np.stack([np.asarray(a) for a in got["border_force"]], axis=-1)
    want = _border_oracle_f64(lines, centers, lengths, state,
                              params.border, use_radius,
                              analytic_idx={0, 1, 2, 3})
    err = np.linalg.norm(got_f - want, axis=1)
    lim = 3e-4 * np.linalg.norm(want, axis=1) + 3e-5
    assert np.all(err <= lim), (err / np.maximum(lim, 1e-30)).max()
    # and the sampled default differs (the tier is not silently ignored)
    sampled = force_terms(state, scene, params,
                          StepConfig(use_pallas=False), None)
    assert not np.allclose(np.asarray(sampled["border_force"][0]),
                           np.asarray(got["border_force"][0]))


def test_analytic_stepper_dispatch():
    """StepConfig.env_analytic routes border terms through the geometry
    path; the default (off) stays on the reference's sampled argmin."""
    lines, centers, lengths = _analytic_lines()
    scene = prepare_scene(Scene(spawn=None,
                                borders=build_border_set(lines, centers,
                                                         lengths)),
                          analytic=True)
    state = _state(n=64)
    params = SfmParams(enable_acceleration=True, enable_border=True)
    cfg = dataclasses.replace(
        StepConfig(use_pallas=True, pallas_interpret=True,
                   pallas_row_tile=8, pallas_col_tile=128),
        env_ped_tile=128, env_analytic=True)
    t_on = force_terms(state, scene, params, cfg, None)
    direct = fused_environment_terms(state, scene, params, None,
                                     ped_tile=128,
                                     point_tile=cfg.env_point_tile,
                                     analytic=True, interpret=True)
    for plane in (0, 1):
        np.testing.assert_array_equal(
            np.asarray(t_on["border_force"][plane]),
            np.asarray(direct["border_force"][plane]))

    cfg_off = dataclasses.replace(cfg, env_analytic=False)
    t_off = force_terms(state, scene, params, cfg_off, None)
    sampled = fused_environment_terms(state, scene, params, None,
                                      ped_tile=128,
                                      point_tile=cfg.env_point_tile,
                                      interpret=True)
    for plane in (0, 1):
        np.testing.assert_array_equal(
            np.asarray(t_off["border_force"][plane]),
            np.asarray(sampled["border_force"][plane]))


def test_analytic_split_rejects_unsafe_sections():
    """Sections violating the polyline assumption go to the sampled rest:
    a side-jump point cloud (DP would fabricate a phantom wall across the
    jump) and a collinear out-and-back chain (DP's chord-LINE distance is
    zero everywhere but the simplified chain does not cover the far
    points)."""
    from carla_social_force_model_tpu.env.pointsets import analytic_split
    # side-jump: left wall points then right wall points in one section
    jump = np.concatenate([
        np.column_stack([np.linspace(0, 10, 101), np.full(101, -3.0)]),
        np.column_stack([np.linspace(0, 10, 101), np.full(101, 3.0)])])
    # out-and-back: 0..10 then back to 5 along the same line
    outback = np.concatenate([
        np.column_stack([np.linspace(0, 10, 101), np.zeros(101)]),
        np.column_stack([np.linspace(9.9, 5, 50), np.zeros(50)])])
    straight = np.column_stack([np.linspace(0, 10, 101), np.full(101, 8.0)])
    pset = build_border_set([jump, outback, straight],
                            [jump[50], outback[50], straight[50]],
                            [12.0, 12.0, 12.0])
    gset, rest = analytic_split(pset)
    assert gset is not None and gset.num_segments == 1   # only the wall
    assert rest is not None and rest.num_segments == 2
    # and the split still sums to the full sampled force through the terms
    scene = prepare_scene(Scene(spawn=None, borders=pset), analytic=True)
    state = _state(n=48)
    params = SfmParams(enable_border=True)
    got = fused_environment_terms(state, scene, params, None, ped_tile=128,
                                  point_tile=512, interpret=True,
                                  analytic=True)
    want = forces.border_force(state.pos, state.mode, state.radius,
                               state.alive, pset, params.border)
    got_f = np.stack([np.asarray(a) for a in got["border_force"]], axis=-1)
    np.testing.assert_allclose(got_f, np.asarray(want), rtol=3e-4,
                               atol=3e-5)


def test_prepare_scene_analytic_is_lazy_and_idempotent():
    lines, centers, lengths = _analytic_lines()
    borders = build_border_set(lines, centers, lengths)
    off = prepare_scene(Scene(spawn=None, borders=borders))
    assert off.borders_seg is not None and off.borders_geom is None
    # a scene prepared WITHOUT the tier gains the geometry on re-prepare
    # (the geom branch must not hide behind the borders_seg-is-None check)
    on = prepare_scene(off, analytic=True)
    assert on.borders_geom is not None and on.borders_seg_rest is not None


def test_static_constraints_select_k_nearest_chunks():
    """_static_constraints picks the true k nearest distinct wall chunks
    per agent and builds the exact v.n >= -gap/tau half-planes."""
    from carla_social_force_model_tpu.models.params import OrcaParams
    from carla_social_force_model_tpu.ops.orca import _static_constraints
    pset = _ragged_borders()
    p = OrcaParams()
    n = 40
    pos = RNG.uniform(-18, 8, (n, 2)).astype(np.float32)
    px, py = jnp.asarray(pos[:, 0]), jnp.asarray(pos[:, 1])
    r = jnp.full((n,), 0.3, jnp.float32)
    exempt = jnp.zeros((n,), bool).at[3].set(True)
    dt = 0.05

    ptx, pty, nx, ny, valid = _static_constraints(
        px, py, r, exempt, pset, p.max_statics, p.tau_static, dt,
        p.neighbor_dist)
    assert ptx.shape == (n, p.max_statics)
    assert not np.asarray(valid)[3].any()          # exempt row: no planes

    pts = np.asarray(pset.points)
    val = np.asarray(pset.valid)
    d2_all = np.where(
        val[:, :, None],
        ((pts[:, :, None, :] - pos[None, None, :, :]) ** 2).sum(-1),
        np.inf).min(1)                              # (C, N) brute force
    d2_all = np.where(d2_all <= p.neighbor_dist ** 2, d2_all, np.inf)
    for i in (0, 7, 21):
        dexp = np.sort(d2_all[:, i])[: p.max_statics]
        dexp = dexp[np.isfinite(dexp)]
        got = np.sort((np.asarray(ptx)[i] ** 2 + np.asarray(pty)[i] ** 2)
                      [np.asarray(valid)[i]])
        assert np.asarray(valid)[i].sum() == dexp.size
        # reconstruct the selected gaps from the planes: |pt| = |rhs| and
        # rhs = -(d - r)/tau for non-penetrating rows
        dsel = np.sqrt(dexp) - 0.3
        exp_rhs = np.sort((dsel / np.where(dsel >= 0, p.tau_static, dt))
                          ** 2)
        np.testing.assert_allclose(got, exp_rhs, rtol=1e-4, atol=1e-5)
