"""Headless reactive vehicle autopilot (kinematic waypoint follower).

The reference's autopilot vehicles are driven by CARLA's TrafficManager (or a
BehaviorAgent) with per-vehicle knobs: percentage speed difference below the
limit, ignore-walkers percentage, ignore-lights percentage
(/root/reference/vehicle_spawner.py:125-138).  Headless there is no UE4
traffic stack, so this module provides the on-device equivalent: a
branchless, fully vectorized kinematic controller that runs *inside* the
jitted ``lax.scan`` as part of the rollout carry --

* follows a waypoint polyline at a per-vehicle target speed
  (= ``speed_limit * (1 - speed_reduction_factor/100)``, mirroring
  ``traffic_manager.vehicle_percentage_speed_difference``),
* brakes for alive pedestrians inside its braking corridor unless the
  vehicle's seeded ``ignore_walkers_percentage`` draw says to ignore them
  (mirroring ``traffic_manager.ignore_walkers_percentage``),
* brakes for red scenario-declared traffic lights ahead on its lane unless
  its seeded ``ignore_lights_percentage`` draw says to ignore them
  (mirroring ``traffic_manager.ignore_lights_percentage``,
  vehicle_spawner.py:125-130; headless lights are timed red/green
  stop-points -- see TrafficLightSpec and PARITY.md),
* brakes for other fleet vehicles ahead in its lane (car following -- the
  TM/BehaviorAgent collision-avoidance equivalent; CARLA vehicles never
  rear-end each other regardless of the ignore-walkers knob),
* optionally overtakes a slower leader through the adjacent (left) lane
  when ``overtake = true``: blocked behind a leader slower than its own
  target speed, it waits for the passing lane to be clear (including a
  closing-speed-extended window against oncoming traffic), side-steps by
  ``lane_width`` at ``lane_change_rate``, passes, and merges back once the
  original lane is clear -- the BehaviorAgent overtake maneuver
  (/root/reference/vehicle_spawner.py:131-138) as branchless (V, V)
  vector math in the rollout carry.  Walkers in the passing lane defer
  the commit exactly like vehicles do.  Overtake *legality* is
  per-waypoint (``AutopilotFleet.overtake_ok``): destination-routed
  vehicles derive it from driving-lane-graph adjacency
  (routing/driving.DrivingGraph.lane_adjacency -- the headless stand-in
  for the OpenDRIVE lane markings CARLA's local planner consults), while
  waypoints-authored scenarios declare it with the
  ``overtake``/``lane_width`` keys -- see PARITY.md,
* optionally loops its route (TrafficManager vehicles drive indefinitely).

Unlike the scripted teleport timelines (models/vehicles.py, the reference's
``auto_pilot = false`` mode), the trajectory is *state-dependent*: a vehicle
that braked for a jaywalker is permanently behind where it would have been,
so the whole fleet state must be scanned, not precomputed.

Spawn-time seeding replicates the reference's vehicle spawner call order
(vehicle_spawner.py:100-118): ``random.seed(vehicle_seed)``; blueprint
``random.choice`` (entropy only, library size configurable); cumulative
``speed_reduction_factor`` jitter; ``vehicle_seed += 1``.  The
ignore-walkers draw has no deterministic reference counterpart (CARLA's TM
re-rolls internally per decision), so it uses an independent derived stream.
"""
from __future__ import annotations

import random
from dataclasses import dataclass
from typing import NamedTuple, Sequence

import numpy as np
import jax.numpy as jnp

from ..utils.pytree import pytree_dataclass, static_field
from .spawn import realized_spawn_steps
from .vehicles import VehicleSnapshot, VehicleStates, ellipse_template

# Size of CARLA 0.9.13's vehicle blueprint library (the reference pins
# carla==0.9.13, requirements.txt:1; counts from that release's blueprint
# catalogue).  ``filter('vehicle')`` yields 38 blueprints; the reference's
# ``no_bikes`` filter (vehicle_spawner.py:27-31, number_of_wheels == 4)
# drops the 7 two-wheelers (bh.crossbike, diamondback.century,
# gazelle.omafiets, harley-davidson.low_rider, kawasaki.ninja,
# vespa.zx125, yamaha.yzf), leaving 31.  Like the walker count
# (spawn.WALKER_BLUEPRINT_COUNT), the seeded per-vehicle
# ``random.choice`` consumes RNG entropy that depends only on the library
# size, so emulating the draw with the right count makes the subsequent
# speed-jitter draw match the reference bit-for-bit.  Override with the
# ``vehicle.blueprint_count`` scenario key for other CARLA versions.
VEHICLE_BLUEPRINT_COUNT = 38
VEHICLE_BLUEPRINT_COUNT_NO_BIKES = 31

# Seconds of travel an oncoming vehicle is projected forward when judging
# whether the passing lane is clear (BehaviorAgent uses a comparable
# time-headway test before lane changes).
_PASS_HORIZON = 5.0


@dataclass
class AutopilotSpec:
    """Host-side description of one reactive ``[[vehicle.vehicle_spawner]]``
    (``auto_pilot = true`` + a headless ``waypoints`` route)."""

    waypoints: np.ndarray               # (W, 2) route polyline
    speed_limit: float = 8.33           # m/s (30 km/h urban default)
    speed_reduction_factor: float = 30.0  # TM percentage below the limit
    ignore_walkers_percentage: float = 0.0
    ignore_lights_percentage: float = 0.0
    extent: tuple[float, float] = (2.4, 1.1)
    spawn_time: float = 0.0
    spawn_interval: float = 5.0
    quantity: int = 1
    loop: bool = False                  # wrap the route (TM-style endless)
    blueprint: str | None = None
    acceleration: float = 2.0           # m/s^2 throttle
    deceleration: float = 4.5           # m/s^2 braking
    brake_margin: float = 4.0           # m kept clear ahead of the bumper
    lateral_margin: float = 1.0         # m beyond the half-width
    # -- overtaking (BehaviorAgent-style maneuver; legality is declared
    #    here, not derived from map lane markings) --
    overtake: bool = False              # may pass through the left lane
    lane_width: float = 3.5             # lateral offset of the passing lane
    # per-waypoint legality ((W,) bool aligned with ``waypoints``): where
    # the maneuver may START.  None = the whole route (when ``overtake``).
    # Destination-routed vehicles get this derived from driving-lane-graph
    # adjacency (api/scenario.extract_autopilot_specs).
    overtake_ok: np.ndarray | None = None
    overtake_speed_gain: float = 0.5    # m/s the leader must be slower by
    overtake_clear_ahead: float = 40.0  # m of clear passing lane required
    overtake_clear_behind: float = 8.0  # m of clear lane behind required
    lane_change_rate: float = 1.75      # m/s lateral side-step speed


@dataclass
class TrafficLightSpec:
    """A headless traffic light: a timed red/green stop-point on the road
    (``[[vehicle.traffic_lights]]`` scenario table).  The reference's lights
    are CARLA world actors the TM obeys (vehicle_spawner.py:125-130);
    headless, a light exists only where the scenario declares one."""

    position: np.ndarray        # (2,) stop-point on the lane
    red: float = 5.0            # seconds of red per cycle
    green: float = 5.0          # seconds of green per cycle
    offset: float = 0.0         # phase offset [s]; t=offset starts a red


@pytree_dataclass
class AutopilotState:
    """Per-vehicle dynamic state (lives in the rollout carry)."""

    pos: jnp.ndarray       # (V, 2)
    heading: jnp.ndarray   # (V,) radians
    speed: jnp.ndarray     # (V,)
    wp_idx: jnp.ndarray    # (V,) int32 current route target
    active: jnp.ndarray    # (V,) bool
    lane_off: jnp.ndarray  # (V,) current lateral offset off the route [m]
    overtaking: jnp.ndarray  # (V,) bool: committed to the passing lane


@pytree_dataclass
class AutopilotFleet:
    """Static fleet description + initial state (device arrays)."""

    route: jnp.ndarray          # (V, W, 2) padded polylines
    route_count: jnp.ndarray    # (V,) int32 valid waypoints per vehicle
    spawn_step: jnp.ndarray     # (V,) int32
    target_speed: jnp.ndarray   # (V,) speed_limit*(1 - reduction/100)
    ignore_walkers: jnp.ndarray  # (V,) bool (seeded percentage draw)
    loop: jnp.ndarray           # (V,) bool
    accel: jnp.ndarray          # (V,)
    decel: jnp.ndarray          # (V,)
    brake_margin: jnp.ndarray   # (V,)
    lateral_margin: jnp.ndarray  # (V,)
    overtake: jnp.ndarray       # (V,) bool: may use the passing lane
    overtake_ok: jnp.ndarray    # (V, W) bool: may START the pass here
    lane_width: jnp.ndarray     # (V,)
    ot_speed_gain: jnp.ndarray  # (V,)
    ot_clear_ahead: jnp.ndarray  # (V,)
    ot_clear_behind: jnp.ndarray  # (V,)
    lane_rate: jnp.ndarray      # (V,) lateral m/s
    extent: jnp.ndarray         # (V, 2)
    template: jnp.ndarray       # (V, P, 2) local ellipse outline
    template_valid: jnp.ndarray  # (V, P)
    # scenario-declared traffic lights (None = no lights; pytree-safe
    # default since None is an empty subtree): stop-point planes + red
    # duration / full cycle / phase offset, plus the per-vehicle seeded
    # ignore-lights draw (the TM ignore_lights_percentage equivalent)
    light_x: jnp.ndarray | None = None        # (L,)
    light_y: jnp.ndarray | None = None        # (L,)
    light_red: jnp.ndarray | None = None      # (L,) red duration [s]
    light_cycle: jnp.ndarray | None = None    # (L,) red+green [s]
    light_offset: jnp.ndarray | None = None   # (L,)
    ignore_lights: jnp.ndarray | None = None  # (V,) bool
    points_per_chunk: int = static_field(default=64)

    @property
    def num_vehicles(self) -> int:
        return self.extent.shape[0]

    def initial_state(self) -> AutopilotState:
        v = self.num_vehicles
        return AutopilotState(
            pos=self.route[:, 0, :],
            heading=jnp.zeros((v,), self.route.dtype),
            speed=jnp.zeros((v,), self.route.dtype),
            wp_idx=jnp.ones((v,), jnp.int32),   # index 0 is the spawn point
            active=jnp.zeros((v,), bool),
            lane_off=jnp.zeros((v,), self.route.dtype),
            overtaking=jnp.zeros((v,), bool),
        )


class AutopilotRecord(NamedTuple):
    """Per-step fleet snapshot (vehicle.csv source for reactive runs)."""

    pos: jnp.ndarray       # (V, 2)
    heading: jnp.ndarray   # (V,)
    speed: jnp.ndarray     # (V,)
    active: jnp.ndarray    # (V,)


def build_autopilot_fleet(
    specs: Sequence[AutopilotSpec],
    dt: float,
    num_steps: int,
    vehicle_seed: int = 2000,
    variate_speed_factor: float = 0.0,
    blueprint_count: int = 0,
    resolution: float = 0.1,
    points_per_chunk: int = 64,
    traffic_lights: Sequence[TrafficLightSpec] | None = None,
    dtype=np.float32,
) -> AutopilotFleet | None:
    """Expand specs into a device fleet, replicating the reference's seeded
    per-vehicle draw order (vehicle_spawner.py:100-118).

    Spawn order is ticks-ascending, spec order within a tick (the reference's
    one-spawn-per-spawner-per-tick greedy loop, vehicle_spawner.py:45-58).
    """
    per_spec = [realized_spawn_steps(s.spawn_time, s.spawn_interval,
                                     s.quantity, dt, num_steps)
                for s in specs]
    events: list[tuple[int, int]] = []
    cursor = [0] * len(specs)
    for step in range(num_steps):
        for si, steps in enumerate(per_spec):
            if cursor[si] < len(steps) and steps[cursor[si]] == step:
                events.append((step, si))
                cursor[si] += 1
    if not events:
        return None

    v = len(events)
    w_max = max(len(np.atleast_2d(s.waypoints)) for s in specs)
    route = np.zeros((v, w_max, 2), dtype)
    route_count = np.zeros((v,), np.int32)
    spawn_step = np.zeros((v,), np.int32)
    target_speed = np.zeros((v,), dtype)
    ignore_walkers = np.zeros((v,), bool)
    ignore_lights = np.zeros((v,), bool)
    loop = np.zeros((v,), bool)
    accel = np.zeros((v,), dtype)
    decel = np.zeros((v,), dtype)
    brake_margin = np.zeros((v,), dtype)
    lateral_margin = np.zeros((v,), dtype)
    overtake = np.zeros((v,), bool)
    overtake_ok = np.zeros((v, w_max), bool)
    lane_width = np.zeros((v,), dtype)
    ot_speed_gain = np.zeros((v,), dtype)
    ot_clear_ahead = np.zeros((v,), dtype)
    ot_clear_behind = np.zeros((v,), dtype)
    lane_rate = np.zeros((v,), dtype)
    extent = np.zeros((v, 2), dtype)
    templates = []

    seed = vehicle_seed
    reduction = [float(s.speed_reduction_factor) for s in specs]  # cumulative
    for vi, (step, si) in enumerate(events):
        s = specs[si]
        rng = random.Random()
        rng.seed(seed)
        if not s.blueprint and blueprint_count > 0:
            rng.choice(range(blueprint_count))   # entropy-only blueprint draw
        if variate_speed_factor != 0.0:
            reduction[si] += rng.uniform(-variate_speed_factor,
                                         variate_speed_factor)
        # ignore-walkers / ignore-lights: TM re-rolls internally; headless
        # uses one seeded per-vehicle draw each from derived streams (does
        # not perturb the reference-parity stream above)
        ign = random.Random(seed * 7919 + 13).uniform(0.0, 100.0)
        ign_l = random.Random(seed * 6047 + 29).uniform(0.0, 100.0)
        seed += 1

        wps = np.atleast_2d(np.asarray(s.waypoints, dtype))[:, :2]
        route[vi, : len(wps)] = wps
        # padding repeats the last waypoint so a clamped gather is harmless
        route[vi, len(wps):] = wps[-1]
        route_count[vi] = len(wps)
        spawn_step[vi] = step
        target_speed[vi] = s.speed_limit * (1.0 - reduction[si] / 100.0)
        ignore_walkers[vi] = ign < s.ignore_walkers_percentage
        ignore_lights[vi] = ign_l < s.ignore_lights_percentage
        loop[vi] = s.loop
        accel[vi] = s.acceleration
        decel[vi] = s.deceleration
        brake_margin[vi] = s.brake_margin
        lateral_margin[vi] = s.lateral_margin
        overtake[vi] = s.overtake
        if s.overtake_ok is not None:
            ok = np.asarray(s.overtake_ok, bool).reshape(-1)
            if len(ok) != len(wps):
                raise ValueError(
                    f"overtake_ok length {len(ok)} != route length "
                    f"{len(wps)} for spawner {si}")
            overtake_ok[vi, : len(wps)] = ok
            # padding repeats the last value (clamped wp gather, like route)
            overtake_ok[vi, len(wps):] = bool(ok[-1]) if len(ok) else False
        else:
            overtake_ok[vi, :] = True    # whole-route; gated by `overtake`
        lane_width[vi] = s.lane_width
        ot_speed_gain[vi] = s.overtake_speed_gain
        ot_clear_ahead[vi] = s.overtake_clear_ahead
        ot_clear_behind[vi] = s.overtake_clear_behind
        lane_rate[vi] = s.lane_change_rate
        extent[vi] = s.extent
        templates.append(ellipse_template(s.extent[0], s.extent[1], resolution))

    from ..env.pointsets import PAD_COORD
    p_raw = max(len(t) for t in templates)
    p = -(-p_raw // points_per_chunk) * points_per_chunk
    template = np.full((v, p, 2), PAD_COORD, dtype)
    template_valid = np.zeros((v, p), bool)
    for vi, t in enumerate(templates):
        template[vi, : len(t)] = t
        template_valid[vi, : len(t)] = True

    lights = {}
    if traffic_lights:
        lights = dict(
            light_x=jnp.asarray([float(np.asarray(tl.position)[0])
                                 for tl in traffic_lights], dtype),
            light_y=jnp.asarray([float(np.asarray(tl.position)[1])
                                 for tl in traffic_lights], dtype),
            light_red=jnp.asarray([tl.red for tl in traffic_lights], dtype),
            light_cycle=jnp.asarray([tl.red + tl.green
                                     for tl in traffic_lights], dtype),
            light_offset=jnp.asarray([tl.offset for tl in traffic_lights],
                                     dtype),
            ignore_lights=jnp.asarray(ignore_lights),
        )

    return AutopilotFleet(
        route=jnp.asarray(route), route_count=jnp.asarray(route_count),
        spawn_step=jnp.asarray(spawn_step),
        target_speed=jnp.asarray(target_speed),
        ignore_walkers=jnp.asarray(ignore_walkers), loop=jnp.asarray(loop),
        accel=jnp.asarray(accel), decel=jnp.asarray(decel),
        brake_margin=jnp.asarray(brake_margin),
        lateral_margin=jnp.asarray(lateral_margin),
        overtake=jnp.asarray(overtake),
        overtake_ok=jnp.asarray(overtake_ok),
        lane_width=jnp.asarray(lane_width),
        ot_speed_gain=jnp.asarray(ot_speed_gain),
        ot_clear_ahead=jnp.asarray(ot_clear_ahead),
        ot_clear_behind=jnp.asarray(ot_clear_behind),
        lane_rate=jnp.asarray(lane_rate),
        extent=jnp.asarray(extent), template=jnp.asarray(template),
        template_valid=jnp.asarray(template_valid),
        points_per_chunk=points_per_chunk,
        **lights,
    )


def autopilot_step(fleet: AutopilotFleet, st: AutopilotState,
                   ped_pos, ped_vel,
                   ped_alive: jnp.ndarray, t_idx, dt) -> AutopilotState:
    """Advance the fleet one tick (branchless, (V,) and (V,N) vector math).

    ``ped_pos``/``ped_vel``: (N, 2) arrays or (x, y) plane tuples -- the
    (V, N)-shaped hazard work is planar (x/y planes, models/state.py).

    Runs *before* the pedestrian core each tick, matching the reference's
    order (vehicles move inside ``world.tick()`` and are then read back as
    dynamic obstacles, run_simulation.py:70-95).
    """
    from ..ops.vecmath import split_xy
    ppx, ppy = split_xy(ped_pos)
    pvx, pvy = split_xy(ped_vel)
    dt = jnp.asarray(dt, st.pos.dtype)
    active = st.active | (fleet.spawn_step == t_idx)

    # current target waypoint (clamped gather; padding repeats the last wp),
    # side-stepped by the current lane offset along the route segment's left
    # normal (lane_off == 0 keeps the math bit-identical to the offset-free
    # follower, so non-overtaking fleets reproduce their golden fixtures)
    v_idx = jnp.arange(fleet.num_vehicles)
    wp_i = jnp.minimum(st.wp_idx, fleet.route_count - 1)
    wp = fleet.route[v_idx, wp_i]
    prev = fleet.route[v_idx, jnp.maximum(wp_i - 1, 0)]
    seg = wp - prev
    seg_n = jnp.linalg.norm(seg, axis=-1)
    has_seg = seg_n > 1e-6
    segx = jnp.where(has_seg, seg[:, 0] / jnp.maximum(seg_n, 1e-6),
                     jnp.cos(st.heading))
    segy = jnp.where(has_seg, seg[:, 1] / jnp.maximum(seg_n, 1e-6),
                     jnp.sin(st.heading))
    target = wp + st.lane_off[:, None] * jnp.stack([-segy, segx], axis=-1)
    to_wp = target - st.pos
    dist = jnp.linalg.norm(to_wp, axis=-1)
    has_dir = dist > 1e-6
    dirx = jnp.where(has_dir, to_wp[:, 0] / jnp.maximum(dist, 1e-6),
                     jnp.cos(st.heading))
    diry = jnp.where(has_dir, to_wp[:, 1] / jnp.maximum(dist, 1e-6),
                     jnp.sin(st.heading))
    heading = jnp.where(has_dir, jnp.arctan2(diry, dirx), st.heading)

    # pedestrian hazard: any alive walker inside (or predicted to enter) the
    # braking corridor -- ahead of the bumper within stopping distance +
    # margin, laterally within half-width + margin either now or at the
    # vehicle's arrival time (a walker stepping toward the lane is a hazard
    # before it enters it; CARLA's TM predicts the same way, coarsely)
    rel_x = ppx[None, :] - st.pos[:, 0][:, None]             # (V, N) planes
    rel_y = ppy[None, :] - st.pos[:, 1][:, None]
    fwd = rel_x * dirx[:, None] + rel_y * diry[:, None]
    lat = -rel_x * diry[:, None] + rel_y * dirx[:, None]
    lat_vel = (-pvx[None, :] * diry[:, None]
               + pvy[None, :] * dirx[:, None])
    t_arrive = jnp.clip(fwd / jnp.maximum(st.speed, 0.5)[:, None], 0.0, 3.0)
    lat_pred = lat + lat_vel * t_arrive
    stop_dist = (st.speed ** 2) / (2.0 * fleet.decel) + fleet.brake_margin
    band = (fleet.extent[:, 1] + fleet.lateral_margin)[:, None]
    near = ((fwd > -fleet.extent[:, 0, None])
            & (fwd < stop_dist[:, None] + fleet.extent[:, 0, None])
            & ((jnp.abs(lat) < band) | (jnp.abs(lat_pred) < band)))
    hazard = jnp.any(near & ped_alive[None, :], axis=1) & ~fleet.ignore_walkers

    if fleet.light_x is not None and fleet.light_x.shape[0] > 0:
        # red-light hazard: a currently-red stop-point ahead on the lane
        # within braking range (same stopping-corridor geometry as walkers;
        # the light is a point so only the lateral band gates lane
        # membership).  Phase: t in [offset, offset+red) mod cycle is red.
        sim_t = t_idx * dt
        phase = jnp.mod(sim_t - fleet.light_offset[None, :],
                        fleet.light_cycle[None, :])
        is_red = phase < fleet.light_red[None, :]              # (1, L)
        lrel_x = fleet.light_x[None, :] - st.pos[:, 0][:, None]  # (V, L)
        lrel_y = fleet.light_y[None, :] - st.pos[:, 1][:, None]
        lfwd = lrel_x * dirx[:, None] + lrel_y * diry[:, None]
        llat = -lrel_x * diry[:, None] + lrel_y * dirx[:, None]
        at_light = ((lfwd > 0.0)
                    & (lfwd < stop_dist[:, None] + fleet.extent[:, 0, None])
                    & (jnp.abs(llat) < band))
        red_hazard = (jnp.any(at_light & is_red, axis=1)
                      & ~fleet.ignore_lights)
        hazard = hazard | red_hazard

    # -- vehicle-vehicle car following + BehaviorAgent-style overtaking ----
    # (V, V) pairwise geometry in each vehicle's frame.  V is the fleet
    # size (tens at most), so this is noise next to the (V, N) walker scan.
    vrel_x = st.pos[None, :, 0] - st.pos[:, None, 0]
    vrel_y = st.pos[None, :, 1] - st.pos[:, None, 1]
    vfwd = vrel_x * dirx[:, None] + vrel_y * diry[:, None]
    vlat = -vrel_x * diry[:, None] + vrel_y * dirx[:, None]
    other = (active[None, :] & active[:, None]
             & ~jnp.eye(fleet.num_vehicles, dtype=bool))
    gap_len = fleet.extent[:, 0][:, None] + fleet.extent[None, :, 0]
    veh_band = fleet.extent[:, 1][:, None] + fleet.extent[None, :, 1] + 0.3
    follow_window = stop_dist[:, None] + gap_len
    leader = (other & (vfwd > 0.0) & (vfwd < follow_window)
              & (jnp.abs(vlat) < veh_band))
    # a leader ahead brakes me exactly like a walker hazard (the TM never
    # rear-ends regardless of the ignore-walkers knob)
    hazard = hazard | jnp.any(leader, axis=1)

    # overtake trigger: blocked behind a leader slower than my own target
    # speed, the passing lane (left by lane_width) clear fore and aft --
    # with the fore window extended by closing speed against oncoming
    # traffic (an approaching car _PASS_HORIZON seconds out is not clear)
    blocked = jnp.any(
        leader & (st.speed[None, :]
                  < fleet.target_speed[:, None] - fleet.ot_speed_gain[:, None]),
        axis=1)
    j_fwd_speed = st.speed[None, :] * (jnp.cos(st.heading)[None, :]
                                       * dirx[:, None]
                                       + jnp.sin(st.heading)[None, :]
                                       * diry[:, None])
    fore_window = (fleet.ot_clear_ahead[:, None]
                   + jnp.maximum(0.0, -j_fwd_speed) * _PASS_HORIZON)
    pass_busy = jnp.any(
        other & (vfwd > -fleet.ot_clear_behind[:, None])
        & (vfwd < fore_window)
        & (jnp.abs(vlat - fleet.lane_width[:, None]) < veh_band), axis=1)
    # a walker in the passing lane defers the commit too (BehaviorAgent
    # does not lane-change into a pedestrian); once committed, the normal
    # braking corridor -- which rides the vehicle's own lane -- covers them
    ped_pass = jnp.any(
        ped_alive[None, :] & (fwd > -fleet.ot_clear_behind[:, None])
        & (fwd < fleet.ot_clear_ahead[:, None])
        & (jnp.abs(lat - fleet.lane_width[:, None]) < band), axis=1)
    pass_busy = pass_busy | (ped_pass & ~fleet.ignore_walkers)
    # merge-back check: the ORIGINAL lane (at -lane_off in my frame) clear
    # behind me and for a braking distance ahead
    merge_ahead = follow_window + fleet.brake_margin[:, None]
    orig_busy = jnp.any(
        other & (vfwd > -fleet.ot_clear_behind[:, None])
        & (vfwd < merge_ahead)
        & (jnp.abs(vlat + st.lane_off[:, None]) < veh_band), axis=1)
    # legality gate: the pass may only START where the vehicle's current
    # route waypoint allows it (per-waypoint overtake_ok -- derived from
    # lane adjacency for destination-routed vehicles); an in-flight pass
    # is never cut short mid-maneuver
    ok_here = fleet.overtake_ok[v_idx, wp_i]
    start = (blocked & ~pass_busy & fleet.overtake & ok_here & active
             & ~st.overtaking)
    overtaking = (st.overtaking | start) & ~(st.overtaking & ~orig_busy)
    target_off = jnp.where(overtaking, fleet.lane_width, 0.0)
    lane_step = fleet.lane_rate * dt
    lane_off = st.lane_off + jnp.clip(target_off - st.lane_off,
                                      -lane_step, lane_step)
    lane_off = jnp.where(active, lane_off, 0.0)

    speed = jnp.where(
        hazard,
        jnp.maximum(0.0, st.speed - fleet.decel * dt),
        jnp.minimum(fleet.target_speed, st.speed + fleet.accel * dt))
    speed = jnp.where(active, speed, 0.0)

    step_len = speed * dt
    # the lane change is an explicit lateral translation along the route
    # normal at lane_change_rate (steering toward the offset waypoint alone
    # would converge with time constant dist/speed -- far too slow); with
    # lane_off pinned at 0 the delta is exactly 0.0 and the update is
    # bit-identical to the offset-free follower
    d_off = (lane_off - st.lane_off)[:, None] * jnp.stack([-segy, segx],
                                                          axis=-1)
    pos = st.pos + jnp.where(active[:, None], step_len[:, None]
                             * jnp.stack([dirx, diry], axis=-1) + d_off,
                             0.0)

    # waypoint advance (don't overshoot bookkeeping: within one step + 0.5 m)
    arrived = active & (dist <= step_len + 0.5)
    nxt = st.wp_idx + 1
    exhausted = nxt >= fleet.route_count
    wp_idx = jnp.where(arrived,
                       jnp.where(exhausted & fleet.loop,
                                 jnp.zeros_like(nxt), nxt),
                       st.wp_idx)
    # route done (and not looping): park the vehicle (inactive, like the
    # reference's scripted despawn on list exhaustion)
    done = arrived & exhausted & ~fleet.loop
    active = active & ~done

    return AutopilotState(pos=pos, heading=heading, speed=speed,
                          wp_idx=wp_idx, active=active,
                          lane_off=lane_off, overtaking=overtaking)


def autopilot_snapshot(fleet: AutopilotFleet,
                       st: AutopilotState) -> VehicleSnapshot:
    """Fleet state as the VehicleSnapshot consumed by gap acceptance and the
    dynamic-obstacle force (obstacles.py:297-329 readback equivalent)."""
    vel = st.speed[:, None] * jnp.stack(
        [jnp.cos(st.heading), jnp.sin(st.heading)], axis=-1)
    return VehicleSnapshot(
        center=st.pos, vel=vel, heading=st.heading, extent=fleet.extent,
        active=st.active, template=fleet.template,
        template_valid=fleet.template_valid,
        points_per_chunk=fleet.points_per_chunk)


def records_to_vehicle_states(fleet: AutopilotFleet,
                              rec: AutopilotRecord) -> VehicleStates:
    """Stacked per-step AutopilotRecords -> a VehicleStates timeline (so the
    reference-schema vehicle.csv writer works unchanged on reactive runs)."""
    heading = jnp.asarray(rec.heading)
    vel = jnp.asarray(rec.speed)[..., None] * jnp.stack(
        [jnp.cos(heading), jnp.sin(heading)], axis=-1)
    return VehicleStates(
        pos=jnp.asarray(rec.pos), heading=heading, vel=vel,
        active=jnp.asarray(rec.active), extent=fleet.extent,
        template=fleet.template, template_valid=fleet.template_valid,
        points_per_chunk=fleet.points_per_chunk)
