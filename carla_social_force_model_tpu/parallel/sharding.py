"""Agent-sharding: pedestrian slots distributed over a device mesh.

The rollout runs under ``shard_map`` with every per-slot array (state, spawn
schedule, route buffer) sharded along the ``agents`` mesh axis and the scene
geometry replicated.  Only the N x N pedestrian force communicates: it
all-gathers the (pos, vel, radius, alive) column tile over the interconnect
(ops/forces.py ``axis_name``); every other stage is slot-local, so one tick
costs exactly one all-gather of ~17 bytes/agent (or the ppermute ring,
``axis_comm="ring"``).  Exception: a reactive autopilot fleet
(``scene.autopilot``) adds a second all-gather of (pos, vel, alive) per
tick for its hazard check -- fleets are small-scenario features, so the
extra collective is accepted rather than threading the gathered copy
through the force path.
"""
from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
from jax.sharding import PartitionSpec as P

from ..models.spawn import SpawnSchedule
from ..models.state import PedState
from ..models.stepper import Scene, StepConfig, rollout
from ..models.params import SfmParams
from .mesh import AGENT_AXIS, round_up


def _pad_axis0(leaf, new_n):
    pad = new_n - leaf.shape[0]
    if pad == 0:
        return leaf
    widths = [(0, pad)] + [(0, 0)] * (leaf.ndim - 1)
    return jnp.pad(leaf, widths)


def pad_spawn_schedule(schedule: SpawnSchedule, new_capacity: int) -> SpawnSchedule:
    """Grow the slot dimension; padding slots never spawn (step = -1)."""
    if new_capacity == schedule.capacity:
        return schedule
    padded = jax.tree_util.tree_map(
        lambda leaf: _pad_axis0(leaf, new_capacity), schedule)
    step = padded.step.at[schedule.capacity:].set(-1)
    return dataclasses.replace(padded, step=step)


def prepare_sharded_scene(scene: Scene, n_shards: int):
    """Pad slot arrays to a multiple of ``n_shards``; returns (scene, capacity)."""
    cap = round_up(scene.spawn.capacity, n_shards)
    schedule = pad_spawn_schedule(scene.spawn, cap)
    return dataclasses.replace(scene, spawn=schedule), cap


def make_sharded_rollout(mesh, scene: Scene, params: SfmParams, cfg: StepConfig,
                         num_steps: int, record: bool = False,
                         start_step: int = 0):
    """Jitted rollout with pedestrian slots sharded over ``mesh``'s agents axis.

    Usage::

        mesh = make_mesh(n_agent_shards=8)
        scene, cap = prepare_sharded_scene(scene, 8)
        run = make_sharded_rollout(mesh, scene, params, cfg, steps)
        final, recs = run(PedState.empty(cap))

    ``start_step`` offsets the tick index (spawn timing, FSM clocks) --
    the sharded analogue of utils/checkpoint.run_segmented's resume: save
    the final state of one segment (utils/checkpoint.save_state handles
    sharded pytrees through np.asarray), reload, and continue with the
    next segment's ``start_step``.
    """
    from ..models.stepper import prepare_scene
    scene = prepare_scene(scene, analytic=cfg.env_analytic,
                          orca=params.enable_orca)
    state_spec = jax.tree_util.tree_map(lambda _: P(AGENT_AXIS),
                                        PedState.empty(1))
    # Scene-of-specs: same pytree structure, slot arrays sharded, geometry
    # replicated (tree_map preserves the dataclass structure).
    scene_spec = dataclasses.replace(
        jax.tree_util.tree_map(lambda _: P(), scene),
        spawn=jax.tree_util.tree_map(lambda _: P(AGENT_AXIS), scene.spawn))

    def body(state, scn):
        return rollout(state, scn, params, cfg, num_steps, record=record,
                       start_step=start_step, axis_name=AGENT_AXIS)

    if record:
        # StepRecord is a 4-tuple of (T, N, ...) arrays; a reactive fleet's
        # AutopilotRecord (T, V, ...) is replicated (identical on all devices)
        from ..models.stepper import StepRecord
        rec_spec = StepRecord(pos=P(None, AGENT_AXIS), vel=P(None, AGENT_AXIS),
                              mode=P(None, AGENT_AXIS), alive=P(None, AGENT_AXIS))
        if scene.autopilot is not None:
            from ..models.autopilot import AutopilotRecord
            rec_spec = (rec_spec, AutopilotRecord(pos=P(), heading=P(),
                                                  speed=P(), active=P()))
        out_specs = (state_spec, rec_spec)
    else:
        out_specs = (state_spec, None)

    shard_fn = jax.shard_map(body, mesh=mesh,
                             in_specs=(state_spec, scene_spec),
                             out_specs=out_specs, check_vma=False)

    @jax.jit
    def run(state: PedState):
        return shard_fn(state, scene)

    return run
