"""Synthetic large-N crowd scenarios (benchmarks, scaling studies).

Builds SpawnSchedules directly as arrays (no per-ped Python loop) for
populations far beyond the reference's tens-of-agents scenarios.
"""
from __future__ import annotations

import numpy as np
import jax.numpy as jnp

from ..models import modes
from ..models.routes import RouteBuffer
from ..models.spawn import SpawnSchedule
from ..models.state import PedState
from ..models.stepper import Scene, StepConfig
from ..ops.backend import kernels_available


def synthetic_crowd(n: int, extent: float = 100.0, speed: float = 1.3,
                    seed: int = 0, radius: float = 0.3,
                    dtype=np.float32) -> SpawnSchedule:
    """N pedestrians spawning at step 0, uniformly placed in a square of
    half-size ``extent``, each walking to the antipodal point (sustained
    counterflow through the center -- a dense interaction workload)."""
    rng = np.random.default_rng(seed)
    pos = rng.uniform(-extent, extent, (n, 2)).astype(dtype)
    dest = (-pos).astype(dtype)
    direction = dest - pos
    nrm = np.linalg.norm(direction, axis=-1, keepdims=True)
    direction = direction / np.where(nrm == 0, 1, nrm)
    speeds = np.full((n,), speed, dtype) + rng.uniform(-0.2, 0.2, n).astype(dtype)

    vel = direction * speeds[:, None]
    routes = RouteBuffer(
        wp_x=jnp.asarray(dest[:, None, 0]),
        wp_y=jnp.asarray(dest[:, None, 1]),
        crossing=jnp.zeros((n, 1), bool),
        count=jnp.ones((n,), jnp.int32),
    )
    return SpawnSchedule(
        step=jnp.zeros((n,), jnp.int32),
        pos_x=jnp.asarray(pos[:, 0]), pos_y=jnp.asarray(pos[:, 1]),
        vel_x=jnp.asarray(vel[:, 0]), vel_y=jnp.asarray(vel[:, 1]),
        speed=jnp.asarray(speeds),
        crossing_speed=jnp.asarray(speeds * 1.5),
        margin=jnp.full((n,), 1.5, dtype),
        radius=jnp.full((n,), radius, dtype),
        initial_mode=jnp.full((n,), modes.WALKING_SIDEWALK, jnp.int32),
        fwp_x=jnp.asarray(dest[:, 0]), fwp_y=jnp.asarray(dest[:, 1]),
        routes=routes,
    )


def batched_crowds(batch: int, n: int, extent: float = 35.0, speed: float = 1.3,
                   seed: int = 0, radius: float = 0.3) -> SpawnSchedule:
    """A batch of independent synthetic crowds (leading batch dim on every
    spawn-schedule leaf) for ensemble rollouts."""
    import jax
    schedules = [synthetic_crowd(n, extent=extent, speed=speed,
                                 seed=seed + b, radius=radius)
                 for b in range(batch)]
    return jax.tree_util.tree_map(lambda *xs: jnp.stack(xs), *schedules)


def synthetic_borders(extent: float, spacing: float = 20.0,
                      section_length: float = 30.0, resolution: float = 0.1):
    """Street-grid walls across the arena, sampled at the reference's 0.1 m
    border resolution and split into <=30 m sections (the reference's
    section-center/length coarse filter granularity, forces.py:149-151).
    BASELINE config #2's workload shape."""
    from ..env.borders import build_border_set
    lines, centers, lengths = [], [], []
    coords = np.arange(-extent, extent + 1e-6, spacing)
    for c in coords:
        _wall_sections(lines, centers, lengths, (-extent, c), (extent, c),
                       section_length, resolution)   # horizontal street wall
        _wall_sections(lines, centers, lengths, (c, -extent), (c, extent),
                       section_length, resolution)   # vertical street wall
    return build_border_set(lines, centers, lengths)


def synthetic_obstacles(extent: float, spacing: float = 15.0,
                        resolution: float = 0.1,
                        perception_threshold: float = 20.0):
    """A grid of parked-car-sized static obstacles (ellipse outlines at the
    reference's sampling, obstacles.py:269-281).  BASELINE config #3's
    static workload shape."""
    from ..env.obstacles_gen import build_obstacle_set
    from ..models.vehicles import ellipse_template
    outlines, centers = [], []
    coords = np.arange(-extent + spacing / 2, extent, spacing)
    tmpl = ellipse_template(2.4, 1.1, resolution)
    for cx in coords:
        for cy in coords:
            outlines.append(tmpl + np.array([cx, cy]))
            centers.append(np.array([cx, cy]))
    return build_obstacle_set(outlines, centers, perception_threshold)


def synthetic_vehicles(extent: float, count: int, dt: float, num_steps: int):
    """Moving vehicles sweeping the arena (dynamic-obstacle workload)."""
    from ..models.vehicles import VehicleSpec, build_vehicle_states
    specs = []
    speed = 8.0
    length = num_steps + 2
    for v in range(count):
        y = -extent + (v + 0.5) * (2 * extent / count)
        xs = -extent + speed * dt * np.arange(length)
        specs.append(VehicleSpec(
            trajectory=np.column_stack([xs, np.full(length, y)]),
            headings=np.zeros(length), speeds=np.full(length, speed)))
    return build_vehicle_states(specs, dt, num_steps)


def urban_bundle(n: int, seed: int = 0, use_pallas: bool | None = None,
                 num_steps_hint: int = 512, n_routes: int = 256,
                 n_roads: int = 8, width: float = 600.0,
                 road_spacing: float = 60.0, sidewalk_offset: float = 6.0,
                 curb_offset: float = 4.5, cross_spacing: float = 100.0,
                 wp_spacing: float = 20.0, vehicles_per_road: int = 2):
    """(scene, params, cfg, state) for BASELINE.json config #4: urban
    navigation at scale -- nav-graph-routed pedestrians on a synthetic
    Manhattan-style street grid with curb borders, crosswalk mode
    transitions, gap-acceptance road crossing, and a reactive autopilot
    vehicle fleet looping the roads.  The full per-step pipeline
    (run_simulation.py:47-132's tick) in one measurable workload.

    Geometry: ``n_roads`` horizontal roads (y = i*road_spacing) spanning
    x in [0, width], sidewalks at +-sidewalk_offset, curb walls at
    +-curb_offset sampled at the reference's 0.1 m, crosswalks + block
    connectors every ``cross_spacing``.  ``n_routes`` A* routes are planned
    host-side between random far-apart sidewalk nodes (every route crosses
    roads); pedestrians round-robin over them with jittered spawn points.
    """
    from ..env.borders import build_border_set
    from ..models.autopilot import AutopilotSpec, build_autopilot_fleet
    from ..models.params import SfmParams
    from ..routing.graph import EdgeType, GraphType, NavGraphBuilder
    from ..routing.planner import PedPathPlanner

    if use_pallas is None:
        use_pallas = kernels_available()
    rng = np.random.default_rng(seed)

    # --- nav graph ------------------------------------------------------
    b = NavGraphBuilder()
    xs = np.arange(0.0, width + 1e-6, wp_spacing)
    cross_xs = np.arange(cross_spacing, width - 1e-6, cross_spacing)
    road_ys = np.arange(n_roads, dtype=np.float64) * road_spacing
    for y in road_ys:
        for off in (-sidewalk_offset, sidewalk_offset):
            b.add_polyline([np.array([x, y + off, 0.0]) for x in xs],
                           EdgeType.SIDEWALK)
        for x in cross_xs:
            b.add_edge([x, y - sidewalk_offset, 0.0],
                       [x, y + sidewalk_offset, 0.0], EdgeType.CROSSWALK)
    for y0, y1 in zip(road_ys[:-1], road_ys[1:]):
        lo, hi = y0 + sidewalk_offset, y1 - sidewalk_offset
        ys = np.arange(lo, hi + 1e-6, wp_spacing)
        if ys[-1] < hi - 1e-6:
            ys = np.append(ys, hi)
        for x in cross_xs:
            b.add_polyline([np.array([x, yy, 0.0]) for yy in ys],
                           EdgeType.SIDEWALK)
    planner = PedPathPlanner(b.build())

    # --- curb borders (reference 0.1 m sampling, <=30 m sections) --------
    lines, centers, lengths = [], [], []
    for y in road_ys:
        for off in (-curb_offset, curb_offset):
            _wall_sections(lines, centers, lengths,
                           (0.0, y + off), (width, y + off))
    borders = build_border_set(lines, centers, lengths)

    # --- reactive vehicle fleet: a looping two-lane ring per road --------
    ap_specs = []
    for y in road_ys:
        ring = np.array([[5.0, y - 2.0], [width - 5.0, y - 2.0],
                         [width - 5.0, y + 2.0], [5.0, y + 2.0]])
        ap_specs.append(AutopilotSpec(
            waypoints=ring, speed_limit=8.33, speed_reduction_factor=0.0,
            quantity=vehicles_per_road,
            spawn_interval=0.4 * width / 8.33, loop=True))
    fleet = build_autopilot_fleet(ap_specs, 0.05, num_steps_hint)

    # --- host-side A* routes over the grid ------------------------------
    side_nodes = []  # (road_i, node_xyz) on horizontal sidewalks
    for i, y in enumerate(road_ys):
        for off in (-sidewalk_offset, sidewalk_offset):
            for x in xs:
                side_nodes.append((i, np.array([x, y + off, 0.0])))
    route_xy, route_cross = [], []
    w_max = 1
    while len(route_xy) < n_routes:
        oi = rng.integers(len(side_nodes))
        di = rng.integers(len(side_nodes))
        if side_nodes[oi][0] == side_nodes[di][0]:
            continue  # same road: force routes that cross roads
        route = planner.generate_route(side_nodes[oi][1], side_nodes[di][1],
                                       GraphType.NO_JAYWALKING)
        route_xy.append(np.asarray([wp[:2] for wp, _ in route], np.float32))
        route_cross.append(np.asarray([c for _, c in route], bool))
        w_max = max(w_max, len(route))
    rk_x = np.zeros((n_routes, w_max), np.float32)
    rk_y = np.zeros((n_routes, w_max), np.float32)
    rk_c = np.zeros((n_routes, w_max), bool)
    rk_n = np.zeros((n_routes,), np.int32)
    for k, (xy, cr) in enumerate(zip(route_xy, route_cross)):
        rk_x[k, : len(xy)] = xy[:, 0]
        rk_y[k, : len(xy)] = xy[:, 1]
        rk_c[k, : len(xy)] = cr
        rk_n[k] = len(xy)

    # --- spawn schedule: round-robin routes, jittered spawn points -------
    ridx = np.arange(n) % n_routes
    ox = rk_x[ridx, 0] + rng.uniform(-18.0, 18.0, n).astype(np.float32)
    oy = rk_y[ridx, 0] + rng.uniform(-1.2, 1.2, n).astype(np.float32)
    ox = np.clip(ox, 0.0, width).astype(np.float32)
    speeds = (1.3 + rng.uniform(-0.2, 0.2, n)).astype(np.float32)
    dx = rk_x[ridx, 0] - ox
    dy = rk_y[ridx, 0] - oy
    nrm = np.maximum(np.hypot(dx, dy), 1e-6)
    routes = RouteBuffer(
        wp_x=jnp.asarray(rk_x[ridx]), wp_y=jnp.asarray(rk_y[ridx]),
        crossing=jnp.asarray(rk_c[ridx]), count=jnp.asarray(rk_n[ridx]))
    schedule = SpawnSchedule(
        step=jnp.zeros((n,), jnp.int32),
        pos_x=jnp.asarray(ox), pos_y=jnp.asarray(oy),
        vel_x=jnp.asarray(speeds * dx / nrm),
        vel_y=jnp.asarray(speeds * dy / nrm),
        speed=jnp.asarray(speeds),
        crossing_speed=jnp.asarray(speeds * 1.5),
        margin=jnp.full((n,), 1.5, np.float32),
        radius=jnp.full((n,), 0.3, np.float32),
        initial_mode=jnp.where(jnp.asarray(rk_c[ridx, 0]),
                               modes.CROSSING_ROAD, modes.WALKING_SIDEWALK),
        fwp_x=jnp.asarray(rk_x[ridx, 0]), fwp_y=jnp.asarray(rk_y[ridx, 0]),
        routes=routes,
    )

    scene = Scene(spawn=schedule, borders=borders, autopilot=fleet)
    params = SfmParams(enable_acceleration=True, enable_pedestrian=True,
                       enable_border=True, enable_dynamic_obstacle=True)
    cfg = StepConfig(dt=0.05, waypoint_threshold=2.0,
                     despawn_on_arrival=True, use_pallas=use_pallas)
    return scene, params, cfg, PedState.empty(n)


def _wall_sections(lines, centers, lengths, a, b,
                   section_length: float = 30.0, resolution: float = 0.1):
    """Append one sampled wall split into <=section_length sections (the
    reference's section-center/length coarse-filter granularity,
    forces.py:149-151)."""
    from ..env.borders import sample_borderline
    a, b = np.asarray(a, float), np.asarray(b, float)
    total = float(np.linalg.norm(b - a))
    n_sec = max(1, int(np.ceil(total / section_length)))
    for k in range(n_sec):
        s = a + (b - a) * (k / n_sec)
        e = a + (b - a) * ((k + 1) / n_sec)
        lines.append(sample_borderline(s, e, resolution))
        centers.append((s + e) / 2.0)
        lengths.append(float(np.linalg.norm(e - s)))


def benchmark_bundle(n: int, extent: float | None = None, seed: int = 0,
                     use_pallas: bool | None = None,
                     with_borders: bool = False,
                     with_obstacles: bool = False,
                     num_steps_hint: int = 512):
    """(scene, params, cfg, state) for the BASELINE.json benchmarks:

    * default: config #1 -- acceleration + pedestrian forces, headless.
    * ``with_borders``: config #2 -- + border force over a street-grid wall
      point cloud at 0.1 m resolution.
    * ``with_obstacles``: config #3 -- + static (parked-car grid) and
      dynamic (moving vehicles) obstacle forces.

    ``use_pallas=None`` follows ops/backend.kernels_available (the fused
    kernels on the GPU, jnp elsewhere).
    """
    from ..models.params import SfmParams
    if extent is None:
        # keep density roughly constant (~1 ped / 4 m^2)
        extent = max(25.0, float(np.sqrt(n) * 1.0))
    if use_pallas is None:
        use_pallas = kernels_available()
    schedule = synthetic_crowd(n, extent=extent, seed=seed)

    borders = synthetic_borders(extent) if with_borders else None
    static_obstacles = synthetic_obstacles(extent) if with_obstacles else None
    static_vel = (jnp.zeros((static_obstacles.num_segments, 2), jnp.float32)
                  if static_obstacles is not None else None)
    vehicles = (synthetic_vehicles(extent, count=8, dt=0.05,
                                   num_steps=num_steps_hint)
                if with_obstacles else None)

    scene = Scene(spawn=schedule, borders=borders,
                  static_obstacles=static_obstacles,
                  static_obstacle_vel=static_vel, vehicles=vehicles)
    params = SfmParams(enable_acceleration=True, enable_pedestrian=True,
                       enable_border=with_borders,
                       enable_static_obstacle=with_obstacles,
                       enable_dynamic_obstacle=with_obstacles)
    cfg = StepConfig(dt=0.05, waypoint_threshold=2.0, despawn_on_arrival=False,
                     use_pallas=use_pallas)
    return scene, params, cfg, PedState.empty(n)
