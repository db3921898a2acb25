"""The simulation tick as a pure function, and rollouts as ``lax.scan``.

One step reproduces the reference's per-tick pipeline (SURVEY.md section 3.2/
3.3) in the exact order that matters for parity:

1. spawn due pedestrians (run_simulation.py:53)
2. capture applied target speeds (pedestrian_state.py:94-95 -- *before* any
   transition this tick, so a mode change takes force effect one tick later)
3. IDLE promotion (ped_mode_manager.py:30-35)
4. gap acceptance for CHECKING_TRAFFIC peds (pedestrian_simulation.py:67-73)
5. state snapshot (pedestrian_simulation.py:76-79)
6. force sum (pedestrian_simulation.py:81)
7. v' = cap(v + dt*F, applied_target * factor) (pedestrian_simulation.py:117-124)
8. waypoint arrival -> advance/mode change or despawn (run_simulation.py:118-132)
9. x' = x + dt*v' -- the headless equivalent of CARLA applying the commanded
   WalkerControl velocity for one fixed step (SURVEY.md section 1, layer note)

Steps 2-8 live in :func:`tick_core`, which the CARLA bridge reuses directly
(there, CARLA owns spawning and position integration and the bridge pushes
``v_new`` as WalkerControl); headless scenarios run :func:`simulation_step`
under ``lax.scan`` entirely on device.
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple

import jax
import jax.numpy as jnp

from ..utils.pytree import pytree_dataclass, static_field
from ..env.pointsets import ChunkedPointSet
from ..ops import forces, vecmath
from . import modes
from .gap import gap_ready
from .params import SfmParams
from .routes import RouteBuffer
from .spawn import SpawnSchedule, apply_spawn
from .state import PedState
from .vehicles import (VehicleSnapshot, VehicleStates, snapshot_pointset,
                       vehicle_snapshot_at)


@pytree_dataclass
class Scene:
    """Everything the stepper needs besides the pedestrian state."""

    spawn: SpawnSchedule
    borders: ChunkedPointSet | None = None
    static_obstacles: ChunkedPointSet | None = None
    static_obstacle_vel: jnp.ndarray | None = None  # (S, 2), zeros
    vehicles: VehicleStates | None = None
    # reactive waypoint-follower fleet (models/autopilot.py); its dynamic
    # state rides in the rollout carry, so rollouts with a fleet scan a
    # (PedState, AutopilotState) carry
    autopilot: object | None = None
    # segment-major relayouts of borders/static_obstacles for the fused
    # environment-force kernels (ops/pallas_env.py); populated host-side by
    # :func:`prepare_scene` (None -> the jnp closest-point path is used)
    borders_seg: object | None = None
    static_obstacles_seg: object | None = None
    # analytic border geometry for StepConfig.env_analytic: the
    # Douglas-Peucker line-segment form of the simplifiable border
    # sections plus the sampled remainder (env/pointsets.analytic_split);
    # populated by prepare_scene
    borders_geom: object | None = None
    borders_seg_rest: object | None = None
    # ORCA static-constraint feature splits (env/pointsets.StaticFeatures:
    # analytic Douglas-Peucker wall segments + chunked remainder), built by
    # prepare_scene when the ORCA law is enabled; None -> the ORCA statics
    # fall back to the chunk-feature feed over borders/static_obstacles
    borders_feat: object | None = None
    obstacles_feat: object | None = None
    # Moussaid-2010 social groups (models/groups.GroupSet): the global
    # member-slot table consumed by the group force when
    # params.enable_group; replicated under sharding (global slot ids --
    # the force all-gathers the planes it needs, like the autopilot's
    # hazard check).  Built by the scenario builder from spawner
    # group_size chunks (spawn.SpawnSchedule.group_id)
    groups: object | None = None


def prepare_scene(scene: Scene, analytic: bool = False,
                  orca: bool = False) -> Scene:
    """Populate the segment-major point layouts consumed by the fused
    environment-force kernels.  Host-side (concrete arrays; call outside
    jit) and idempotent; rollout/sharding/sweep builders call it (passing
    ``cfg.env_analytic`` as ``analytic`` and ``params.enable_orca`` as
    ``orca``) so every entry point gets the fast path automatically.

    ``analytic``: also build the Douglas-Peucker border geometry for the
    ``env_analytic`` tier (skipped by default -- the DP pass over every
    border section is pure host-side overhead when the opt-in tier is
    off).

    ``orca``: also build the ORCA static-constraint feature splits
    (env/pointsets.build_static_features) for borders and static
    obstacles -- analytic wall-segment features where sections simplify
    safely, chunked sampling elsewhere (ops/orca._static_constraints)."""
    from ..env.pointsets import (analytic_split, build_static_features,
                                 segment_major)
    upd = {}
    if scene.borders is not None and scene.borders_seg is None:
        upd["borders_seg"] = segment_major(scene.borders)
    if (analytic and scene.borders is not None
            and scene.borders_geom is None):
        gset, rest = analytic_split(scene.borders)
        upd["borders_geom"] = gset
        upd["borders_seg_rest"] = (segment_major(rest)
                                   if rest is not None else None)
    if orca and scene.borders is not None and scene.borders_feat is None:
        upd["borders_feat"] = build_static_features(scene.borders)
    if (orca and scene.static_obstacles is not None
            and scene.obstacles_feat is None):
        upd["obstacles_feat"] = build_static_features(scene.static_obstacles)
    if (scene.static_obstacles is not None
            and scene.static_obstacles_seg is None):
        upd["static_obstacles_seg"] = segment_major(scene.static_obstacles)
    return dataclasses.replace(scene, **upd) if upd else scene


@pytree_dataclass
class StepConfig:
    """Static per-rollout configuration (scenario surface of the reference)."""

    dt: float = static_field(default=0.05)
    waypoint_threshold: float = static_field(default=2.0)
    despawn_on_arrival: bool = static_field(default=True)
    row_block: int = static_field(default=1024)
    # fused pair-force and environment kernels (Pallas through Triton,
    # ops/pallas_forces.py and ops/pallas_env.py; the environment kernel
    # covers the terms whose section-major layouts prepare_scene built);
    # compiled for the GPU only -- ops/backend.check_kernels raises
    # elsewhere unless pallas_interpret asks for the Pallas interpreter
    # (CPU tests).  Force params ride as a kernel input, so vmapped
    # parameter sweeps keep it
    use_pallas: bool = static_field(default=False)
    # pair-kernel tiles (powers of two): rows per program, columns per
    # in-kernel loop step; chosen on the H100 (PERF.md)
    pallas_row_tile: int = static_field(default=32)
    pallas_col_tile: int = static_field(default=32)
    pallas_interpret: bool = static_field(default=False)  # CPU testing
    # column-state communication under agent-sharding: "gather" or "ring"
    axis_comm: str = static_field(default="gather")
    # env-kernel tiles (powers of two): pedestrians per program, sampled
    # points per inner chunk; chosen on the H100 (PERF.md)
    env_ped_tile: int = static_field(default=32)
    env_point_tile: int = static_field(default=128)
    # analytic border geometry (env/pointsets.analytic_split): border-family
    # forces compute the closest point ON Douglas-Peucker-simplified line
    # segments of each section instead of argmin over the reference's
    # 0.1 m point sampling.  Sections that do not simplify stay on the
    # sampled path and their term is summed, so enabling this changes only
    # the sampling-quantization error (the analytic distance is the true
    # polyline distance).  OPT-IN because the sampled argmin IS the
    # reference's semantic (PARITY.md); the quantization study lives in
    # BENCH.md.  Both paths (kernel and jnp); requires prepare_scene.
    env_analytic: bool = static_field(default=False)
    # optional interaction cutoff [m] for the kernel path: agents are
    # locality-sorted and column tiles beyond the cutoff are skipped.
    # None = all pairs (reference semantics).  A cutoff >= 110*gamma*
    # (2*lambda*v_max+1) is f32-exact; smaller values truncate the
    # (exponentially decaying) interaction range.  Composes with
    # agent-sharding: each device sorts its local shard and the per-pair
    # cutoff keeps the sum exact.  Requires use_pallas.
    interaction_cutoff: float | None = static_field(default=None)
    # space-filling curve for the cutoff sort: "hilbert" (no Z-jumps, so
    # tighter tile bounding boxes and more skipped tiles) or "morton"
    spatial_order: str = static_field(default="hilbert")


class StepRecord(NamedTuple):
    """Per-step snapshot (the reference's ``all_states`` recording).

    The public record type: ``pos``/``vel`` are (T, N, 2).  In-scan the
    stepper records :class:`RecordXY` planes (the planar layout of
    models/state.py) and
    :func:`rollout` assembles this once after the scan.
    """

    pos: jnp.ndarray
    vel: jnp.ndarray
    mode: jnp.ndarray
    alive: jnp.ndarray


class RecordXY(NamedTuple):
    """Planar in-scan snapshot (see StepRecord)."""

    pos_x: jnp.ndarray
    pos_y: jnp.ndarray
    vel_x: jnp.ndarray
    vel_y: jnp.ndarray
    mode: jnp.ndarray
    alive: jnp.ndarray

    def assemble(self) -> StepRecord:
        return StepRecord(
            pos=vecmath.stack_xy(self.pos_x, self.pos_y),
            vel=vecmath.stack_xy(self.vel_x, self.vel_y),
            mode=self.mode, alive=self.alive)


def force_terms(state: PedState, scene: Scene, params: SfmParams,
                cfg: StepConfig, veh_snap: VehicleSnapshot | None,
                axis_name: str | None = None) -> dict:
    """Enabled force terms by name (the reference's per-force debug dump,
    forces.py:28-32, as data instead of log lines).

    Every term is an ``(fx, fy)`` plane pair -- coordinate planes, never
    ``(N, 2)`` (the planar layout, models/state.py).

    ``axis_name``: when the pedestrian slots are sharded over a mesh axis
    (shard_map agent-sharding), the N x N force gathers its column state over
    that axis; all other forces are row-local.
    """
    from ..ops.vecmath import split_xy

    if cfg.use_pallas:
        from ..ops.backend import check_kernels
        check_kernels(cfg.use_pallas, cfg.pallas_interpret)
    elif cfg.interaction_cutoff is not None:
        raise ValueError(
            "interaction_cutoff runs on the fused kernels only: set "
            "use_pallas=True (GPU, or pallas_interpret=True)")

    fused_env: dict = {}
    if cfg.use_pallas:
        from ..ops.pallas_env import fused_environment_terms
        fused_env = fused_environment_terms(
            state, scene, params, veh_snap, ped_tile=cfg.env_ped_tile,
            point_tile=cfg.env_point_tile, interpret=cfg.pallas_interpret,
            spatial_order=cfg.spatial_order, analytic=cfg.env_analytic)

    # (N, 2) assembly for the jnp force paths; the kernel paths consume
    # the planes directly
    pos2 = vel2 = None

    def _pos2():
        nonlocal pos2
        if pos2 is None:
            pos2 = state.pos
        return pos2

    def _vel2():
        nonlocal vel2
        if vel2 is None:
            vel2 = state.vel
        return vel2

    def analytic_wall_force(a, inv_b, use_radius):
        """jnp path of the analytic border tier: Douglas-Peucker segments
        plus the sampled remainder (mirrors ops/pallas_env's jobs)."""
        fx, fy = forces.section_wall_force(
            state.pos_x, state.pos_y, state.mode, state.radius, state.alive,
            scene.borders_geom, a, inv_b, use_ped_radius=use_radius)
        if scene.borders_seg_rest is not None:
            rx, ry = forces.section_wall_force(
                state.pos_x, state.pos_y, state.mode, state.radius,
                state.alive, scene.borders_seg_rest, a, inv_b,
                use_ped_radius=use_radius)
            fx, fy = fx + rx, fy + ry
        return fx, fy

    analytic = cfg.env_analytic and scene.borders_geom is not None

    def pair_kernel(law, p, desired=None):
        """One pair-force family through the fused kernel (sorted cutoff
        launch when interaction_cutoff is set)."""
        from ..ops.pallas_forces import (pedestrian_force_pallas,
                                         pedestrian_force_pallas_sorted)
        args = ((state.pos_x, state.pos_y), (state.vel_x, state.vel_y),
                state.radius, state.alive, p)
        kw = dict(law=law, desired=desired, axis_name=axis_name,
                  axis_comm=cfg.axis_comm, row_tile=cfg.pallas_row_tile,
                  col_tile=cfg.pallas_col_tile,
                  interpret=cfg.pallas_interpret, planar_out=True,
                  use_ped_radius=params.use_ped_radius)
        if cfg.interaction_cutoff is not None:
            return pedestrian_force_pallas_sorted(
                *args, cutoff=cfg.interaction_cutoff,
                spatial_order=cfg.spatial_order, **kw)
        return pedestrian_force_pallas(*args, **kw)

    terms: dict = {}
    if params.enable_acceleration:
        terms["acceleration_force"] = forces.acceleration_force_xy(
            state.pos_x, state.pos_y, state.vel_x, state.vel_y,
            state.wp_x, state.wp_y, state.applied_target,
            params.acceleration)
    if params.enable_pedestrian:
        if cfg.use_pallas:
            terms["pedestrian_force"] = pair_kernel("moussaid",
                                                    params.pedestrian)
        else:
            terms["pedestrian_force"] = split_xy(forces.pedestrian_force(
                _pos2(), _vel2(), state.radius, state.alive,
                params.pedestrian, use_ped_radius=params.use_ped_radius,
                row_block=cfg.row_block, axis_name=axis_name,
                axis_comm=cfg.axis_comm))
    if params.enable_border and scene.borders is not None:
        if "border_force" in fused_env:
            terms["border_force"] = fused_env["border_force"]
        elif analytic:
            terms["border_force"] = analytic_wall_force(
                params.border.a, 1.0 / params.border.b,
                params.use_ped_radius)
        else:
            terms["border_force"] = split_xy(forces.border_force(
                _pos2(), state.mode, state.radius, state.alive,
                scene.borders, params.border,
                use_ped_radius=params.use_ped_radius))
    if params.enable_static_obstacle and scene.static_obstacles is not None:
        if "static_obstacle_force" in fused_env:
            terms["static_obstacle_force"] = fused_env["static_obstacle_force"]
        else:
            obs_vel = scene.static_obstacle_vel
            if obs_vel is None:
                obs_vel = jnp.zeros((scene.static_obstacles.num_segments, 2),
                                    state.pos_x.dtype)
            terms["static_obstacle_force"] = split_xy(forces.obstacle_force(
                _pos2(), _vel2(), state.radius, state.alive,
                scene.static_obstacles, obs_vel, params.static_obstacle,
                use_ped_radius=params.use_ped_radius))
    if params.enable_powerlaw:
        if cfg.use_pallas:
            terms["powerlaw_force"] = pair_kernel("powerlaw",
                                                  params.powerlaw)
        else:
            terms["powerlaw_force"] = split_xy(forces.powerlaw_force(
                _pos2(), _vel2(), state.radius, state.alive, params.powerlaw,
                row_block=cfg.row_block, axis_name=axis_name,
                axis_comm=cfg.axis_comm))
    if params.enable_ped_repulsive:
        ex, ey, _ = vecmath.normalize_xy(state.wp_x - state.pos_x,
                                         state.wp_y - state.pos_y)
        if cfg.use_pallas:
            terms["ped_repulsive_force"] = pair_kernel(
                "helbing", params.ped_repulsive, desired=(ex, ey))
        else:
            terms["ped_repulsive_force"] = split_xy(
                forces.ped_repulsive_force(
                    _pos2(), _vel2(), vecmath.stack_xy(ex, ey), state.alive,
                    params.ped_repulsive, row_block=cfg.row_block,
                    axis_name=axis_name, axis_comm=cfg.axis_comm))
    if params.enable_group and scene.groups is not None:
        from .groups import group_force
        gex, gey, _ = vecmath.normalize_xy(state.wp_x - state.pos_x,
                                           state.wp_y - state.pos_y)
        terms["group_force"] = group_force(
            state.pos_x, state.pos_y, state.vel_x, state.vel_y, gex, gey,
            state.alive, scene.groups, params.group, axis_name=axis_name)
    if params.enable_space_repulsive and scene.borders is not None:
        if "space_repulsive_force" in fused_env:
            terms["space_repulsive_force"] = fused_env["space_repulsive_force"]
        elif analytic:
            sp = params.space_repulsive
            terms["space_repulsive_force"] = analytic_wall_force(
                sp.u0 / sp.r, 1.0 / sp.r, False)
        else:
            terms["space_repulsive_force"] = split_xy(
                forces.space_repulsive_force(
                    _pos2(), state.mode, state.alive, scene.borders,
                    params.space_repulsive))
    if params.enable_dynamic_obstacle and veh_snap is not None:
        if "dynamic_obstacle_force" in fused_env:
            terms["dynamic_obstacle_force"] = fused_env["dynamic_obstacle_force"]
        else:
            vset, vvel, vact = snapshot_pointset(
                veh_snap, params.dynamic_obstacle.perception_threshold)
            terms["dynamic_obstacle_force"] = split_xy(forces.obstacle_force(
                _pos2(), _vel2(), state.radius, state.alive, vset, vvel,
                params.dynamic_obstacle,
                use_ped_radius=params.use_ped_radius, obstacle_active=vact))
    # per-agent pair-interaction heterogeneity (SpawnSchedule.pair_scale /
    # law_id, beyond-reference): F_i = s_i * sum_j g_ij is exact as a
    # row-wise post-scale of the summed term, so both compose with every
    # kernel path.
    # law_id row-masks each family to the agents that perceive the crowd
    # through it (mixed-model crowds; -1 = every enabled family); an agent
    # i's force always sums over ALL partners j through i's own law.
    # Scales the agent-to-agent families only (not borders/obstacles/group).
    _FAMILY_ID = {"pedestrian_force": 0, "powerlaw_force": 1,
                  "ped_repulsive_force": 2}
    ps = getattr(scene.spawn, "pair_scale", None) if scene.spawn is not None \
        else None
    law = getattr(scene.spawn, "law_id", None) if scene.spawn is not None \
        else None
    if ps is not None or law is not None:
        for k, fid in _FAMILY_ID.items():
            if k not in terms:
                continue
            fx_k, fy_k = terms[k]
            if law is not None:
                m = ((law < 0) | (law == fid)).astype(fx_k.dtype)
                fx_k, fy_k = fx_k * m, fy_k * m
            if ps is not None:
                fx_k, fy_k = fx_k * ps, fy_k * ps
            terms[k] = (fx_k, fy_k)
    return terms


def compute_forces(state: PedState, scene: Scene, params: SfmParams,
                   cfg: StepConfig, veh_snap: VehicleSnapshot | None,
                   axis_name: str | None = None):
    """Sum of enabled forces, masked to alive pedestrians.

    Returns ``(fx, fy)`` planes."""
    terms = force_terms(state, scene, params, cfg, veh_snap,
                        axis_name=axis_name)
    fx = jnp.zeros_like(state.pos_x)
    fy = jnp.zeros_like(state.pos_y)
    for tx, ty in terms.values():
        fx = fx + tx
        fy = fy + ty
    zero = jnp.zeros((), fx.dtype)
    return jnp.where(state.alive, fx, zero), jnp.where(state.alive, fy, zero)


def tick_core(state: PedState, scene: Scene, params: SfmParams,
              cfg: StepConfig, sim_time, veh_snap: VehicleSnapshot | None,
              axis_name: str | None = None):
    """Steps 2-8 of the tick (everything except spawn + integration).

    Returns ``(state', v_new, finished, record)`` where ``v_new`` is the
    commanded velocity (what the reference pushes to CARLA as WalkerControl)
    and ``finished`` marks pedestrians that arrived at their final waypoint
    this tick.
    """
    alive = state.alive

    # 2. applied target speed = FSM target at tick start
    applied = jnp.where(alive, state.fsm_target, state.applied_target)

    # 3. IDLE promotion
    mode, fsm_t, nmt = modes.tick_idle(
        state.mode, state.fsm_target, state.next_mode_time,
        state.base_speed, state.crossing_speed, alive, sim_time)

    # 4. gap acceptance
    checking = alive & (mode == modes.CHECKING_TRAFFIC)
    if veh_snap is not None:
        ready = gap_ready(
            (state.pos_x, state.pos_y), (state.wp_x, state.wp_y),
            state.crossing_speed,
            state.safety_margin, veh_snap.center, veh_snap.vel,
            veh_snap.extent, veh_snap.active,
            strict_parity=params.strict_parity)
    else:
        ready = jnp.ones_like(checking)
    mode, fsm_t, nmt = modes.set_mode(
        mode, fsm_t, nmt, state.base_speed, state.crossing_speed,
        modes.CROSSING_ROAD, checking & ready, sim_time)

    state = dataclasses.replace(
        state, fsm_target=fsm_t, applied_target=applied, mode=mode,
        next_mode_time=nmt)

    # 5. snapshot (reference records after transitions, before forces)
    record = RecordXY(pos_x=state.pos_x, pos_y=state.pos_y,
                      vel_x=state.vel_x, vel_y=state.vel_y,
                      mode=state.mode, alive=state.alive)

    # 6-7. forces and commanded velocity
    fx, fy = compute_forces(state, scene, params, cfg, veh_snap,
                            axis_name=axis_name)
    vx, vy = vecmath.cap_velocity_xy(state.vel_x + cfg.dt * fx,
                                     state.vel_y + cfg.dt * fy,
                                     state.max_speed(params.max_speed_factor))
    zero = jnp.zeros((), vx.dtype)
    vx = jnp.where(alive, vx, zero)
    vy = jnp.where(alive, vy, zero)

    # ORCA velocity projection (beyond-reference law, ops/orca.py): the
    # force-integrated capped velocity above is the *preferred* velocity
    # (goal seeking + walls already shaped it; pair-force families are
    # row-masked off for ORCA agents by the law_id machinery in
    # force_terms), and ORCA replaces it with the closest velocity that
    # provably avoids every neighbor for params.orca.tau seconds.  Applies
    # to agents whose spawner set pair_force = "orca", or to the whole
    # crowd when no law_id column exists (homogeneous ORCA).
    if params.enable_orca:
        from ..ops.orca import orca_velocities
        # road-crossing modes are exempt from the static wall constraints
        # (they must step over curb borders -- the border force's own
        # crossing-mode deactivation rule, reference forces.py:176-177)
        crossing_now = ((state.mode == modes.CROSSING_ROAD)
                        | (state.mode == modes.ROAD_TO_SIDEWALK))
        ovx, ovy = orca_velocities(
            (state.pos_x, state.pos_y), (state.vel_x, state.vel_y),
            state.radius, alive, (vx, vy),
            state.max_speed(params.max_speed_factor), params.orca, cfg.dt,
            veh_snap=veh_snap, axis_name=axis_name,
            spatial_order=cfg.spatial_order,
            borders=(scene.borders_feat if scene.borders_feat is not None
                     else scene.borders),
            obstacles=(scene.obstacles_feat
                       if scene.obstacles_feat is not None
                       else scene.static_obstacles),
            static_exempt=crossing_now)
        law = getattr(scene.spawn, "law_id", None) \
            if scene.spawn is not None else None
        from .spawn import LAW_IDS
        om = alive if law is None else alive & (law == LAW_IDS["orca"])
        vx = jnp.where(om, ovx, vx)
        vy = jnp.where(om, ovy, vy)

    # 8. waypoint arrival (2-D distance, run_simulation.py:118 +
    #    pedestrian_simulation.py:88-97)
    dist_wp = vecmath.norm_xy(state.wp_x - state.pos_x,
                              state.wp_y - state.pos_y)
    arrived = alive & (dist_wp < cfg.waypoint_threshold)
    routes: RouteBuffer = scene.spawn.routes
    if routes.max_waypoints == 1:
        # single-waypoint routes can never advance: arrival is always
        # route exhaustion, no waypoint/mode update (static fast path --
        # the per-step route lookup disappears from the compiled step)
        return state, (vx, vy), arrived, record
    has_next = (state.waypoint_idx + 1) < routes.count
    advance = arrived & has_next
    new_idx = jnp.where(advance, state.waypoint_idx + 1, state.waypoint_idx)
    # one-hot masked reduction over the (small) W axis instead of a gather:
    # a row-indexed gather compiles to a ~10 ns/row loop (measured 2.7 ms
    # per gather at 256k rows); the select+reduce is a single vector pass
    onehot = (jnp.arange(routes.max_waypoints, dtype=new_idx.dtype)
              == new_idx[..., None])                       # (..., N, W)
    next_crossing = jnp.any(onehot & routes.crossing, axis=-1)
    zero = jnp.zeros((), state.wp_x.dtype)
    next_wp_x = jnp.sum(jnp.where(onehot, routes.wp_x, zero), axis=-1)
    next_wp_y = jnp.sum(jnp.where(onehot, routes.wp_y, zero), axis=-1)
    wp_x = jnp.where(advance, next_wp_x, state.wp_x)
    wp_y = jnp.where(advance, next_wp_y, state.wp_y)
    desired_mode = jnp.where(next_crossing, modes.CROSSING_ROAD,
                             modes.WALKING_SIDEWALK)
    mode, fsm_t, nmt = modes.set_mode(
        state.mode, state.fsm_target, state.next_mode_time,
        state.base_speed, state.crossing_speed, desired_mode, advance, sim_time)
    finished = arrived & ~has_next

    state = dataclasses.replace(
        state, fsm_target=fsm_t, mode=mode, next_mode_time=nmt,
        wp_x=wp_x, wp_y=wp_y, waypoint_idx=new_idx)
    return state, (vx, vy), finished, record


def simulation_step(state: PedState, scene: Scene, params: SfmParams,
                    cfg: StepConfig, t_idx, axis_name: str | None = None,
                    veh_snap: VehicleSnapshot | None = None):
    """One headless tick (spawn + core + Euler). Returns
    ``(new_state, StepRecord)``.

    Under agent-sharding (shard_map), ``state``/``scene.spawn`` hold the
    local slot shard and ``axis_name`` names the mesh axis; everything except
    the N x N pedestrian force is slot-local.

    ``veh_snap`` overrides the scene's scripted timeline (the autopilot
    rollout passes the reactive fleet's snapshot here).
    """
    sim_time = t_idx * cfg.dt

    # 1. spawn
    state = apply_spawn(state, scene.spawn, t_idx)

    if veh_snap is None and scene.vehicles is not None:
        veh_snap = vehicle_snapshot_at(scene.vehicles, t_idx)
    state, (vx, vy), finished, record = tick_core(
        state, scene, params, cfg, sim_time, veh_snap, axis_name=axis_name)

    alive = state.alive
    if cfg.despawn_on_arrival:
        alive = alive & ~finished

    # 9. integrate (headless CARLA-equivalent position update)
    zero = jnp.zeros((), vx.dtype)
    pos_x = jnp.where(alive, state.pos_x + cfg.dt * vx, state.pos_x)
    pos_y = jnp.where(alive, state.pos_y + cfg.dt * vy, state.pos_y)
    vel_x = jnp.where(alive, vx, zero)
    vel_y = jnp.where(alive, vy, zero)

    return dataclasses.replace(state, pos_x=pos_x, pos_y=pos_y,
                               vel_x=vel_x, vel_y=vel_y, alive=alive), record


def rollout(state: PedState, scene: Scene, params: SfmParams, cfg: StepConfig,
            num_steps: int, record: bool = True, start_step: int = 0,
            axis_name: str | None = None, record_stride: int = 1,
            autopilot_state=None, return_autopilot_state: bool = False,
            remat: bool = False, grad_horizon: int | None = None):
    """Run ``num_steps`` ticks under ``lax.scan``.

    ``remat=True`` wraps each tick in :func:`jax.checkpoint` so reverse-mode
    AD through the rollout (api/calibrate.py) stores only the per-step
    carries and recomputes the step internals on the backward pass -- O(T)
    activation memory in the carry size instead of in the step's pairwise
    intermediates.  Forward-only rollouts should leave it off (it forbids
    XLA from eliding recomputation it would not otherwise do).

    ``grad_horizon=K`` truncates reverse-mode AD to K-step windows: the
    scan carry is passed through :func:`jax.lax.stop_gradient` whenever
    ``step % K == 0``, so the forward rollout is BITWISE unchanged but
    each parameter gradient only backpropagates through at most K
    consecutive ticks (every tick still contributes its direct parameter
    dependence).  This is truncated BPTT -- the standard estimator for
    stiff/chaotic dynamics whose full-rollout Jacobian products overflow
    f32 (measured: the Karamouzas power law's hard collision-course gates
    amplify gradients ~1e7 per 10 ticks; beyond ~40 ticks reverse-mode AD
    returns inf/nan while the loss itself stays well-behaved).  Unused in
    forward-only rollouts.

    Returns ``(final_state, StepRecord-of-(T, ...))`` when ``record`` else
    ``(final_state, None)``.  ``record_stride=k`` keeps only every k-th
    tick's snapshot (first of each stride) -- recorded history is the memory
    ceiling for long rollouts, (T, N) x ~20 bytes.

    With a reactive vehicle fleet (``scene.autopilot``), the scan carry is
    ``(PedState, AutopilotState)`` and the recorded output is a
    ``(StepRecord, AutopilotRecord)`` pair.  Segmented/resumed rollouts pass
    the fleet state in via ``autopilot_state`` and read it back by setting
    ``return_autopilot_state`` (the first element then becomes the
    ``(PedState, AutopilotState)`` pair).
    """
    # (start_step may be traced -- segmented/resumed rollouts pass it jitted)
    steps = jnp.asarray(start_step) + jnp.arange(num_steps)
    fleet = scene.autopilot
    if (fleet is not None and autopilot_state is None
            and not (isinstance(start_step, int) and start_step == 0)):
        raise NotImplementedError(
            "rollouts with a reactive autopilot fleet cannot resume from "
            "start_step != 0 without the saved fleet state: a fresh "
            "AutopilotState restarts vehicles from their route origins "
            "(pass autopilot_state from the checkpoint)")

    def body(carry, t_idx, want_rec):
        if fleet is None:
            new_state, rec = simulation_step(carry, scene, params, cfg, t_idx,
                                             axis_name=axis_name)
            return new_state, (rec if want_rec else None)
        from .autopilot import (AutopilotRecord, autopilot_snapshot,
                                autopilot_step)
        st, ap = carry
        # reference tick order: walkers spawn, then vehicles move inside
        # world.tick(), then the SFM core reads them back
        # (run_simulation.py:53-95); apply_spawn is idempotent, so
        # simulation_step re-applying it is a no-op.
        st = apply_spawn(st, scene.spawn, t_idx)
        if axis_name is not None:
            # the braking hazard check needs the GLOBAL walker set; the
            # fleet state itself is replicated (identical deterministic
            # update on every device).  Planes gather separately (the
            # planar layout of models/state.py).
            g = lambda a: jax.lax.all_gather(a, axis_name, tiled=True)  # noqa: E731
            w_pos = (g(st.pos_x), g(st.pos_y))
            w_vel = (g(st.vel_x), g(st.vel_y))
            w_alive = g(st.alive)
        else:
            w_pos = (st.pos_x, st.pos_y)
            w_vel = (st.vel_x, st.vel_y)
            w_alive = st.alive
        ap = autopilot_step(fleet, ap, w_pos, w_vel, w_alive, t_idx,
                            cfg.dt)
        snap = autopilot_snapshot(fleet, ap)
        new_state, rec = simulation_step(st, scene, params, cfg, t_idx,
                                         axis_name=axis_name, veh_snap=snap)
        out = ((rec, AutopilotRecord(pos=ap.pos, heading=ap.heading,
                                     speed=ap.speed, active=ap.active))
               if want_rec else None)
        return (new_state, ap), out

    if grad_horizon:
        horizon = int(grad_horizon)
        if horizon <= 0:
            raise ValueError(f"grad_horizon must be positive, got {horizon}")
        step_body = body

        def body(carry, t_idx, want_rec):
            carry = jax.lax.cond(
                (t_idx % horizon) == 0,
                lambda c: jax.tree_util.tree_map(jax.lax.stop_gradient, c),
                lambda c: c, carry)
            return step_body(carry, t_idx, want_rec)

    if remat:
        body = jax.checkpoint(body, static_argnums=(2,))

    if fleet is None:
        carry0 = state
    else:
        carry0 = (state, autopilot_state if autopilot_state is not None
                  else fleet.initial_state())

    if record and record_stride > 1:
        if num_steps % record_stride != 0:
            raise ValueError("num_steps must be a multiple of record_stride")
        chunks = steps.reshape(num_steps // record_stride, record_stride)

        def outer(carry, ts):
            carry, rec = body(carry, ts[0], True)
            carry, _ = jax.lax.scan(
                lambda c, t: body(c, t, False), carry, ts[1:])
            return carry, rec

        final, recs = jax.lax.scan(outer, carry0, chunks)
    else:
        final, recs = jax.lax.scan(
            lambda c, t: body(c, t, record), carry0, steps)
    if fleet is not None and not return_autopilot_state:
        final = final[0]
    # assemble the public (T, N, 2) record from the planar scan output
    # (one stack per rollout instead of a padded write per step)
    if record:
        if fleet is None:
            recs = recs.assemble()
        else:
            recs = (recs[0].assemble(), recs[1])
    return final, recs


def make_rollout_fn(scene: Scene, params: SfmParams, cfg: StepConfig,
                    num_steps: int, record: bool = True,
                    record_stride: int = 1):
    """Jitted rollout closure.

    (The state is deliberately NOT donated: callers -- bench, sweeps --
    commonly reuse the same initial state across invocations, and the carry
    is tiny compared to the recorded trajectory output.)
    """
    scene = prepare_scene(scene, analytic=cfg.env_analytic,
                          orca=params.enable_orca)

    @jax.jit
    def run(state: PedState):
        return rollout(state, scene, params, cfg, num_steps, record=record,
                       record_stride=record_stride)

    return run
